// Flash-attention forward (prefill) for Hopper, written by hand in CUDA C++.
//
// Replaces the TPU kernel `flash_attention_fwd` (`_flash_fwd_kernel`) in
// src/repro/kernels/flash_attention.py: forward online-softmax attention of
// every query over the keys it may see, with the masks `causal`
// (kpos <= qpos), `swa` (also kpos > qpos - window) and `bidir` (none), and a
// static `q_offset` that shifts query positions (chunked prefill).
//
// Layouts are the port's public ones, read in place:
//   q, o (b, sq, h, hd)   k, v (b, sk, kv, hd)   contiguous, f32 or bf16.
// One block per (batch * query head, tile of BQ queries).  K and V are read
// by kv-head index `head / (h / kv)`; they are never repeated per group (the
// TPU wrapper repeats them).  Any sq and sk: the ragged edge is masked (the
// TPU wrapper asserts divisibility).  Key tiles that the mask hides entirely
// (past the causal diagonal, before the sliding window) are skipped, which is
// exact: a fully masked tile adds exp(-1e30 - m) = 0 once a row has seen a
// valid key.  NEG_INF stays finite (-1e30) and the output divides by
// max(l, 1e-30), as in the TPU kernel.  Padding rows past sk score -inf so
// they add exactly nothing.
//
// What bounds it on an H100: at the serving shapes (qwen2-0.5b, b=8, h=14,
// kv=2, hd=64, causal prompt 128, f32) the unmasked work is ~0.24 GFLOP
// against ~8.4 MB of q/k/v/o: ~3.5 us at the f32 CUDA-core peak (67 TFLOP/s)
// against ~2.5 us at 3.35 TB/s, so operations bound it.  This first version
// runs them as f32 FMAs on the CUDA cores, fed from shared memory, not on
// the tensor cores.  Its design keeps the score tile (BQ x BK) and the
// running (m, l, acc) on chip, so device memory sees q, k, v and o once per
// query tile, and pads shared-memory rows by one float so the score and PV
// loops run free of bank conflicts.  wgmma on bf16 tiles, TMA loads and a
// pipelined K/V ring are later work.
#include <math.h>

#include "common.cuh"

namespace {

enum Kind { CAUSAL = 0, SWA = 1, BIDIR = 2 };

// BQ queries per block, BK keys per tile, TPR threads per query row (they sit
// on consecutive lanes of one warp, so row reductions are warp shuffles).
template <int HD> struct Tiles;
template <> struct Tiles<32> {
  static constexpr int BQ = 64, BK = 64, TPR = 2, NT = BQ * TPR;
};
template <> struct Tiles<64> {
  static constexpr int BQ = 64, BK = 64, TPR = 2, NT = BQ * TPR;
};
template <> struct Tiles<128> {
  static constexpr int BQ = 64, BK = 64, TPR = 4, NT = BQ * TPR;
};
template <> struct Tiles<256> {
  static constexpr int BQ = 64, BK = 32, TPR = 8, NT = BQ * TPR;
};

template <int HD> constexpr size_t smem_bytes() {
  using t = Tiles<HD>;
  return sizeof(float) *
         ((size_t)t::BQ * (HD + 1) + 2 * (size_t)t::BK * (HD + 1) +
          (size_t)t::BQ * (t::BK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(Tiles<HD>::NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
                 int h, int kvh, int kind, int window, int q_offset,
                 float scale) {
  constexpr int BQ = Tiles<HD>::BQ, BK = Tiles<HD>::BK, TPR = Tiles<HD>::TPR;
  constexpr int NT = Tiles<HD>::NT;
  constexpr int LD = HD + 1;   // padded row stride of Q/K/V tiles (floats)
  constexpr int LDP = BK + 1;  // padded row stride of the P tile
  constexpr int NS = BK / TPR; // scores per thread per tile
  constexpr int NA = HD / TPR; // output dims per thread

  extern __shared__ float smem[];
  float* Qs = smem;           // BQ x LD
  float* Ks = Qs + BQ * LD;   // BK x LD
  float* Vs = Ks + BK * LD;   // BK x LD
  float* Ps = Vs + BK * LD;   // BQ x LDP

  const int bi = blockIdx.x / h;
  const int head = blockIdx.x % h;
  const int kh = head / (h / kvh);
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int row = tid / TPR, sub = tid % TPR;

  const long q_stride = (long)h * HD;    // between query positions
  const long k_stride = (long)kvh * HD;  // between key positions
  const T* qb = q + ((long)bi * sq * h + head) * HD;
  const T* kb = k + ((long)bi * sk * kvh + kh) * HD;
  const T* vb = v + ((long)bi * sk * kvh + kh) * HD;
  T* ob = o + ((long)bi * sq * h + head) * HD;

  // tile loads: unrolled so each thread has 8 global loads in flight
  // (a load per iteration would wait one memory latency per element)
#pragma unroll 8
  for (int i = 0; i < BQ * HD / NT; ++i) {
    const int e = tid + i * NT, r = e / HD, d = e % HD;
    Qs[r * LD + d] = (q0 + r < sq) ? to_f(qb[(q0 + r) * q_stride + d]) : 0.f;
  }

  // keys this query tile can see: [k_lo, k_hi)
  const int qpos_first = q_offset + q0;
  const int qpos_last = q_offset + min(q0 + BQ, sq) - 1;
  int k_lo = 0, k_hi = sk;
  if (kind != BIDIR) {
    k_hi = min(sk, qpos_last + 1);
    if (kind == SWA && window > 0) k_lo = max(0, qpos_first - window + 1);
  }
  k_lo = (k_lo / BK) * BK;

  const int qpos = q_offset + q0 + row;
  float m = NEG_INF, l = 0.f;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  for (int kt = k_lo; kt < k_hi; kt += BK) {
    __syncthreads();  // Q loaded; previous K/V/P tile consumed
#pragma unroll 8
    for (int i = 0; i < BK * HD / NT; ++i) {
      const int e = tid + i * NT, r = e / HD, d = e % HD;
      const bool in = kt + r < sk;
      Ks[r * LD + d] = in ? to_f(kb[(kt + r) * k_stride + d]) : 0.f;
      Vs[r * LD + d] = in ? to_f(vb[(kt + r) * k_stride + d]) : 0.f;
    }
    __syncthreads();

    // scores of this row against keys sub, sub + TPR, ...
    float s[NS];
#pragma unroll
    for (int n = 0; n < NS; ++n) s[n] = 0.f;
    const float* qr = Qs + row * LD;
    for (int d = 0; d < HD; ++d) {
      const float qd = qr[d];
#pragma unroll
      for (int n = 0; n < NS; ++n)
        s[n] = fmaf(qd, Ks[(sub + n * TPR) * LD + d], s[n]);
    }
    float mt = NEG_INF;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int kpos = kt + sub + n * TPR;
      bool ok = true;
      if (kind != BIDIR) {
        ok = kpos <= qpos;
        if (kind == SWA && window > 0) ok = ok && kpos > qpos - window;
      }
      s[n] = kpos >= sk ? -INFINITY : (ok ? s[n] * scale : NEG_INF);
      mt = fmaxf(mt, s[n]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
    float* pr = Ps + row * LDP;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float p = expf(s[n] - m_new);
      ls += p;
      pr[sub + n * TPR] = p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      ls += __shfl_xor_sync(0xffffffffu, ls, off);
    l = l * alpha + ls;
    m = m_new;
    __syncwarp();  // the row's P entries come from lanes of this warp

#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = pr[j];
#pragma unroll
      for (int i = 0; i < NA; ++i)
        acc[i] = fmaf(p, Vs[j * LD + sub + i * TPR], acc[i]);
    }
  }

  if (q0 + row < sq) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = ob + (q0 + row) * q_stride;
#pragma unroll
    for (int i = 0; i < NA; ++i) orow[sub + i * TPR] = from_f<T>(acc[i] / den);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int sq, int sk, int h, int kvh, int kind, int window,
                   int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // raised once per instance: the attribute holds for every later launch
  // (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(b * h, (sq + Tiles<HD>::BQ - 1) / Tiles<HD>::BQ);
  flash_fwd_kernel<T, HD><<<grid, Tiles<HD>::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, kvh, kind,
      window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kind: 0 causal, 1 swa, 2 bidir.
// scale: the softmax scale, hd ** -0.5 rounded to float by the caller.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int b, int sq, int sk, int h,
                                   int kvh, int hd, int dtype, int kind,
                                   int window, int q_offset, float scale,
                                   void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, hd, [&](auto* tag, auto hd_c) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch<T, decltype(hd_c)::value>(q, k, v, o, b, sq, sk, h, kvh,
                                            kind, window, q_offset, scale, s);
  });
}
