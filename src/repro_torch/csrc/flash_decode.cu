// Flash-decode for Hopper, written by hand in CUDA C++: contiguous and paged.
//
// Replaces two TPU kernels of src/repro/kernels/flash_decode.py, both
// one-token grouped-query decode attention, each slot masked by its own
// valid length kv_len[slot]:
//   * `flash_decode` (`_decode_kernel`) over contiguous fixed-slot caches or
//     sliding-window rings (a ring's storage order does not matter once
//     RoPE is applied at write time);
//   * `flash_decode_paged` (`_paged_decode_kernel`) over paged pools, the
//     slot's logical key j read from pool row bt[slot, j / pg], offset
//     j % pg.
// One kernel body serves both, templated on the K/V row address (`Slots`,
// `Pages`): the two read the same values in the same order, so a paged
// cache and a fixed one with the same contents give bit-identical outputs.
// A tile's BK row offsets are computed once, into shared memory, before its
// loads, so a tile may straddle pages and a page may span tiles: any page
// size works (1, 5, 128, ...).  Offsets are 64-bit.
//
// Layouts are the port's public ones, read in place:
//   q, o (b, 1, h, hd)   contiguous: k, v caches (b, S, kv, hd)
//   paged: k, v pools (rows, pg, kv, hd), bt (b, ncols) int32, S = ncols * pg
//   kv_len (b,) int32
// contiguous, f32 or bf16.  The kernel writes only o: pool rows that two
// slots share are read-only here.  One block per (slot, kv head); the g = h / kv
// query heads of that group share every K/V tile the block streams (g = 7
// for qwen2-0.5b, not a power of two: g is a runtime value up to GMAX).  The
// block streams only the slot's first kv_len keys, in tiles of BK, and masks
// the ragged end, so any S works (the TPU wrapper snaps its tile to a
// divisor of S).  Scores and the online softmax (m, l, acc) stay in f32 on
// chip; masked keys score the finite NEG_INF = -1e30 and the output divides
// by max(l, 1e-30), as in the TPU kernel.  A slot with kv_len <= 0 has every
// key masked and gets the uniform average over all S keys, as the reference
// does; padding rows past the stream score -inf and add nothing.
//
// What bounds it on an H100: decode reads each valid K/V row once and does
// 4 * hd operations per (query head, key), so it is bound by bytes: at the
// serving shapes (qwen2-0.5b, b=8, kv=2, hd=64, kv_len 160, f32) it moves
// ~1.4 MB, ~0.4 us at 3.35 TB/s.  At that size a launch costs more than the
// traffic.  The grid is b * kv = 16 blocks, which leaves most of the 132 SMs
// idle; splitting S across blocks with a combine pass (split-K flash-decode)
// is later work, as are cp.async/TMA loads of the K/V tiles.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int NT = 128;   // threads per block
constexpr int NW = NT / 32;
constexpr int BK = 64;    // keys per tile
constexpr int GMAX = 16;  // most query heads per kv head
constexpr int LU = 8;     // K and V loads each thread keeps in flight

template <int HD> constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)GMAX * HD + (size_t)BK * (HD + 1) +
                          (size_t)BK * HD + (size_t)GMAX * BK + 3 * GMAX);
}

// Row of key `key` of slot `slot`, counted in (kv, hd) rows of the cache.
struct Slots {  // contiguous (b, S, kv, hd) caches
  int S;
  __device__ long row(int slot, int key) const { return (long)slot * S + key; }
};
struct Pages {  // (rows, pg, kv, hd) pools behind a (b, ncols) block table
  const int* bt;
  int ncols, pg;
  __device__ long row(int slot, int key) const {
    return (long)bt[(long)slot * ncols + key / pg] * pg + key % pg;
  }
};

template <typename T, int HD, typename Rows>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ o, Rows rows, int S, int h, int kvh,
                    float scale) {
  constexpr int LD = HD + 1;             // padded K row (floats)
  constexpr int NSP = GMAX * BK / NT;    // (head, key) score pairs per thread
  constexpr int NAP = GMAX * HD / NT;    // (head, dim) outputs per thread
  static_assert(BK * HD / NT % LU == 0, "tile loads come in groups of LU");

  extern __shared__ float smem[];
  float* Qs = smem;                // GMAX x HD
  float* Ks = Qs + GMAX * HD;      // BK x LD
  float* Vs = Ks + BK * LD;        // BK x HD
  float* Ps = Vs + BK * HD;        // GMAX x BK: scores, then probabilities
  float* m_s = Ps + GMAX * BK;     // running max per query head
  float* l_s = m_s + GMAX;         // running denominator per query head
  float* a_s = l_s + GMAX;         // this tile's rescale factor per head
  __shared__ long off_s[BK];       // element offset of each key of the tile

  const int slot = blockIdx.x, kh = blockIdx.y;
  const int g = h / kvh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qb = q + ((long)slot * h + (long)kh * g) * HD;
  T* ob = o + ((long)slot * h + (long)kh * g) * HD;

  for (int e = tid; e < g * HD; e += NT) Qs[e] = to_f(qb[e]);
  if (tid < GMAX) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }
  const int n_valid = max(0, min(kv_len[slot], S));
  const int n_stream = n_valid > 0 ? n_valid : S;

  float acc[NAP];
#pragma unroll
  for (int i = 0; i < NAP; ++i) acc[i] = 0.f;

  for (int kt = 0; kt < n_stream; kt += BK) {
    // the previous tile's loads finished before its score pass began
    // (0 past the stream: never read, but a valid address all the same)
    if (tid < BK)
      off_s[tid] = kt + tid < n_stream
                       ? (rows.row(slot, kt + tid) * kvh + kh) * HD : 0;
    __syncthreads();  // Q, stats and offsets ready; previous tile consumed
    // each thread issues LU K and LU V loads into registers before it
    // stores any: the stores to Ks/Vs may alias off_s as far as the
    // compiler knows, so a load-store loop would wait one memory latency
    // per element
#pragma unroll 1
    for (int i0 = 0; i0 < BK * HD / NT; i0 += LU) {
      float kr[LU], vr[LU];
#pragma unroll
      for (int u = 0; u < LU; ++u) {
        const int e = tid + (i0 + u) * NT, r = e / HD, d = e % HD;
        const bool in = kt + r < n_stream;
        const long off = off_s[r] + d;
        kr[u] = in ? to_f(k[off]) : 0.f;
        vr[u] = in ? to_f(v[off]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LU; ++u) {
        const int e = tid + (i0 + u) * NT, r = e / HD, d = e % HD;
        Ks[r * LD + d] = kr[u];
        Vs[r * HD + d] = vr[u];
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < NSP; ++i) {
      const int pair = tid + NT * i;
      const int gi = pair / BK, j = pair % BK;
      if (gi < g) {
        const float* qr = Qs + gi * HD;
        const float* kr = Ks + j * LD;
        float s = 0.f;
        for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
        const int kpos = kt + j;
        Ps[gi * BK + j] = kpos >= n_stream ? -INFINITY
                          : (kpos < n_valid ? s * scale : NEG_INF);
      }
    }
    __syncthreads();

    // online-softmax update, one warp per query head
    for (int gi = warp; gi < g; gi += NW) {
      float* pr = Ps + gi * BK;
      float mt = NEG_INF;
      for (int j = lane; j < BK; j += 32) mt = fmaxf(mt, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = m_s[gi];
      const float m_new = fmaxf(m_old, mt);
      float ls = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        ls += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ls += __shfl_xor_sync(0xffffffffu, ls, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[gi] = alpha;
        l_s[gi] = l_s[gi] * alpha + ls;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < NAP; ++i) {
      const int pair = tid + NT * i;
      const int gi = pair / HD, d = pair % HD;
      if (gi < g) {
        const float* pr = Ps + gi * BK;
        float a = acc[i] * a_s[gi];
        for (int j = 0; j < BK; ++j) a = fmaf(pr[j], Vs[j * HD + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < NAP; ++i) {
    const int pair = tid + NT * i;
    const int gi = pair / HD, d = pair % HD;
    if (gi < g) ob[gi * HD + d] = from_f<T>(acc[i] / fmaxf(l_s[gi], 1e-30f));
  }
}

template <typename T, int HD, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* o, Rows rows, int b, int S,
                   int h, int kvh, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // raised once per instance: the attribute holds for every later launch
  // (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_kernel<T, HD, Rows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  flash_decode_kernel<T, HD, Rows><<<dim3(b, kvh), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(o), rows, S, h, kvh, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kv_len: (b,) int32 on the device.
// scale: the softmax scale, hd ** -0.5 rounded to float by the caller.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* kv_len, void* o, int b, int S, int h,
                            int kvh, int hd, int dtype, float scale,
                            void* stream) {
  if (b <= 0 || S <= 0 || kvh <= 0 || h % kvh != 0 || h / kvh > GMAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, hd, [&](auto* tag, auto hd_c) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch<T, decltype(hd_c)::value>(q, k, v, kv_len, o, Slots{S}, b,
                                            S, h, kvh, scale, s);
  });
}

// Paged pools: k, v (rows, pg, kv, hd); bt (b, ncols) int32 pool rows, each
// in [0, rows) (not checked here: the caller's page tables guarantee it).
// Otherwise as flash_decode, with S = ncols * pg.
extern "C" int flash_decode_paged(const void* q, const void* k, const void* v,
                                  const void* bt, const void* kv_len, void* o,
                                  int b, int rows, int pg, int ncols, int h,
                                  int kvh, int hd, int dtype, float scale,
                                  void* stream) {
  if (b <= 0 || rows <= 0 || pg <= 0 || ncols <= 0 || kvh <= 0 ||
      h % kvh != 0 || h / kvh > GMAX || (long)ncols * pg > (1L << 30))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pages pages{static_cast<const int*>(bt), ncols, pg};
  return dispatch(dtype, hd, [&](auto* tag, auto hd_c) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch<T, decltype(hd_c)::value>(q, k, v, kv_len, o, pages, b,
                                            ncols * pg, h, kvh, scale, s);
  });
}
