// Flash-attention forward (prefill) for Hopper, written by hand in CUDA C++.
//
// Replaces the TPU kernel `flash_attention_fwd` (`_flash_fwd_kernel`) in
// src/repro/kernels/flash_attention.py: forward online-softmax attention of
// every query over the keys it may see, with the masks `causal`
// (kpos <= qpos), `swa` (also kpos > qpos - window) and `bidir` (none), and a
// static `q_offset` that shifts query positions (chunked prefill).
//
// Layouts are the port's public ones, read in place:
//   q, o (b, sq, h, hd)   k, v (b, sk, kv, hd)   contiguous, 16-byte aligned,
//   f32 or bf16.
// K and V are read by kv-head index `head / (h / kv)`, never repeated per
// group.  Any sq and sk: the ragged edge is masked.  NEG_INF stays finite
// (-1e30), keys past sk score -inf, and the output divides by max(l, 1e-30),
// as in the TPU kernel.  Key tiles that the mask hides from every query of
// a block (past the causal diagonal, before the sliding window) are not
// loaded; that is exact, since a fully masked tile adds exp2(-1e30 - m) = 0
// once a row has seen a valid key, and is wiped by alpha = 0 before that.
//
// What bounds it on an H100.  Attention does 4 * hd operations per unmasked
// (query, key) pair against q, k, v and o read or written once, so the
// operations bound it at every shape the port runs.  At the serving shape
// (qwen2-0.5b: b 8, sq = sk = 128, h 14, kv 2, hd 64, causal, f32) that is
// 0.24 GFLOP, a few microseconds even on the CUDA cores: the launch and one
// pass of load latency set the time.  At an 8 192-token prompt it is 120
// GFLOP per layer, and only the tensor cores reach it in time.  Measured
// (PERF.md): there the f32 kernel runs at about half the 3xTF32 rate; its
// products alone (softmax deleted) take three quarters of its time, and
// what is left is the softmax's latency between a warpgroup's two
// products, which the consumers' turn-taking hides only in part.  In bf16
// the products are 3x shorter and that latency sets the time.
//
// The design (kernel `flash_fwd_wgmma`):
//   * Tensor cores through wgmma.  S = Q K^T and O += P V are m64nN
//     wgmma.mma_async products with f32 accumulators in registers, one
//     64-query-row tile per consumer warpgroup.  bf16 inputs run k16 bf16
//     products; P is packed to bf16 in registers as the A operand of PV.
//     f32 inputs, which the serving model runs, run 3xTF32: every operand x
//     splits into hi = tf32(x) and lo = tf32(x - hi), both rounded to
//     nearest (so lo is measured against the value the tensor core
//     reads), and each product sums lo*hi + hi*lo + hi*hi in k8 tf32
//     products.  The dropped
//     lo*lo term is ~2^-22 of the product: f32-level error, at up to 495/3
//     TFLOP/s against 67 on the CUDA cores.
//   * A K/V ring fed by TMA.  Thread 0 of a producer warpgroup issues one
//     cp.async.bulk.tensor load of a BK-key K tile and one of V into a
//     2-stage ring of raw tiles (4-D tensor maps over (hd, kv, sk, b), built
//     on the host through cudaGetDriverEntryPoint, so the library needs no
//     -lcuda; passed as __grid_constant__ params), completing on an mbarrier.
//     TMA zero-fills rows past sk; the mask still scores them -inf, since a
//     zero key scores 0.
//   * A conversion stage between the ring and the MMAs, run by the
//     producer warpgroup's 128 threads (which is why the producer is a
//     warpgroup: it has work besides the loads).  tf32 wgmma takes only
//     K-major operands, and S = Q K^T is K-major as the layouts stand, but
//     P V is not: V is written transposed (hd x keys).  The stage reads the
//     raw tile and writes K (hi, lo) and V^T (hi, lo) (bf16: K and V^T) as
//     8-row x 16-byte core matrices without swizzle, the layout the wgmma
//     descriptors declare.  The raw tiles stay unswizzled, so an f32 row of
//     any width lands as TMA writes it; the converted tiles carry the
//     operand layout.  Their core-matrix strides are padded by 16 bytes
//     (K: between K-direction columns; V^T: between 8-row groups) so the
//     stage's 16-byte stores are free of bank conflicts.  Converted tiles
//     sit in a ring of NBUF buffers with full/empty mbarriers, so the
//     producer converts tile t + 1 while consumers multiply tile t.
//   * The tf32 accumulator fragment of S is not the A fragment of P V (a
//     thread holds keys {2c, 2c+1} of each 8-key group, the A operand wants
//     {c, c+4}).  The stage permutes the keys of each 8-key group of V^T to
//     match (position c holds key 2c, position c + 4 key 2c + 1); P V sums
//     over keys, so P's columns and V^T's rows moving together leave it
//     unchanged.  bf16's k16 fragment matches S's as it is.
//   * Online softmax on the accumulator fragments: scores scaled by
//     scale * log2(e) in one multiply, ex2.approx, row max and sum over four
//     lanes of a quad (shuffles); O is rescaled only when some row max of
//     the warp moved.  Tiles wholly inside the mask skip the mask test.
//   * With two consumer warpgroups, they take turns at S = Q K^T (named
//     barriers): one scores while the other runs its softmax, so the
//     tensor cores do not wait while both compute exponentials.
//   * Q: in registers as the A fragment (f32 hi and lo at hd <= 64, bf16 at
//     hd <= 128), else in shared memory as a descriptor operand (f32 hd 128,
//     bf16 hd 256), where hd registers a thread would not fit beside O.
//   * Query tiles of 64 * NWG rows, NWG consumer warpgroups (1 or 2, chosen
//     per call by the wrapper from sq: a 64-query chunk gets one, so no
//     warpgroup idles).  With two, setmaxnreg moves registers from the
//     producer (56) to the consumers (224).  Blocks walk query tiles
//     heaviest first (last causal tile first), so long causal tiles do not
//     end the grid alone.  Blocks are independent, with no atomics: a call
//     is bit-identical to its repeat.
//
// Instances (dtype, hd: key tile BK, NWG): f32 32/64: BK 64, NWG 1 or 2;
// f32 128: BK 32, NWG 1 (Q hi and lo in shared memory, one converted
// buffer: 199 KB); bf16 32/64/128: BK 64, NWG 1 or 2; bf16 256: BK 32, NWG
// 1 or 2.  **f32 hd 256 keeps the FMA body** (`flash_fwd_fma`, f32 FMAs
// on the CUDA cores, query tiles of 64): Q hi and lo alone would take 128 KB
// of shared memory at hd 256, beside a ring and a converted buffer.  Only
// tests reach it.  This is a fixed dispatch by shape, never a fallback.
#include <math.h>
#include <stdint.h>

#include <cuda.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

enum Kind { CAUSAL = 0, SWA = 1, BIDIR = 2 };

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// The key tiles a block of queries [qpos_first, qpos_last] visits: tiles of
// bk keys from `lo` (a multiple of bk), n of them.  tests/test_torch_flash_
// tiles.py models this rule and checks that it covers every unmasked pair.

struct Range {
  int lo, n;
};

__host__ __device__ __forceinline__ Range key_tiles(int qpos_first,
                                                    int qpos_last, int sk,
                                                    int kind, int window,
                                                    int bk) {
  int k_lo = 0, k_hi = sk;
  if (kind != BIDIR) {
    k_hi = min(sk, qpos_last + 1);
    if (kind == SWA && window > 0) k_lo = max(0, qpos_first - window + 1);
  }
  k_lo = (k_lo / bk) * bk;
  return {k_lo, k_hi > k_lo ? (k_hi - k_lo + bk - 1) / bk : 0};
}

// ---------------------------------------------------------------------------
// PTX helpers: shared addresses, mbarriers, TMA, proxy fences, tf32

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          saddr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(saddr(bar))
      : "memory");
}
// generic-proxy stores to shared memory, made visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
template <int R> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// tf32(x), rounded to nearest with ties away from zero, as an f32 bit
// pattern: what cvt.rna.tf32.f32 gives for finite x, in two integer
// instructions (half an ulp of tf32 added to the magnitude, 13 bits
// cleared); in place of the conversion instruction it took 8 % off the
// long-prompt f32 time (PERF.md)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = hi + lo + O(2^-22 |x|)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// 2^x on the SFU; subnormal results flush to 0
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// wgmma shared-memory descriptor, no swizzle: start address, leading byte
// offset (between core matrices along K), stride byte offset (between
// 8-row groups), all in 16-byte units
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, int lbo,
                                              int sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// ---------------------------------------------------------------------------
// the wgmma design

template <typename T, int HD, int NWG> struct Cfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int ES = sizeof(T);
  static constexpr int KC = 16 / ES;      // elements in a core-matrix row
  static constexpr int PL = F32 ? 2 : 1;  // operand planes: hi, lo
  static constexpr int KSTEP = F32 ? 8 : 16;
  static constexpr int BK = (HD >= 256 || (F32 && HD >= 128)) ? 32 : 64;
  static constexpr bool QREG = F32 ? HD <= 64 : HD <= 128;
  static constexpr int STAGES = 2;
  static constexpr int NBUF = (F32 && HD >= 128) ? 1 : 2;
  static constexpr int NW = NWG;
  static constexpr int NT = 128 * (NWG + 1);
  static constexpr int RAW = BK * HD * ES;  // one raw [BK][HD] tile
  // K (BK x HD, K-major): element (r, c) at (c / KC) * LBO_K +
  // (r / 8) * SBO + (r % 8) * 16 + (c % KC) * ES
  static constexpr int SBO = 128, LBO_K = BK * 16 + SBO / 8;
  static constexpr int KPLANE = (HD / KC) * LBO_K;
  // V^T (HD x BK, K-major in keys): element (d, pos) at (pos / KC) * LBO_V
  // + (d / 8) * SBO_V + (d % 8) * 16 + (pos % KC) * ES
  static constexpr int SBO_V = 144, LBO_V = (HD / 8) * SBO_V;
  static constexpr int VPLANE = (BK / KC) * LBO_V;
  static constexpr int OFF_V = PL * KPLANE;  // K hi, [K lo,] V^T hi, [lo]
  static constexpr int BUF = (PL * (KPLANE + VPLANE) + 1023) / 1024 * 1024;
  // Q (64 x HD per consumer) when not in registers, laid out as K
  static constexpr int LBO_Q = 64 * 16 + SBO / 8;
  static constexpr int QPLANE = QREG ? 0 : (HD / KC) * LBO_Q;
  static constexpr int OFF_BUF = STAGES * 2 * RAW;
  static constexpr int OFF_Q = OFF_BUF + NBUF * BUF;
  static constexpr int OFF_BAR = OFF_Q + NWG * PL * QPLANE;
  // barriers: full_raw[STAGES], full_cv[NBUF], empty_cv[NBUF]; + alignment
  static constexpr int SMEM = OFF_BAR + 8 * (STAGES + 2 * NBUF) + 1024;
  static_assert(SMEM <= 232448, "tiles exceed 227 KB of shared memory");
  static_assert(HD % 32 == 0 && BK % 16 == 0, "tile shapes");
};

// raw K [BK][HD] -> K planes (16-byte chunks; 8 consecutive threads read
// one row's 128 contiguous bytes and write 8 conflict-free core rows)
template <class C>
__device__ __forceinline__ void convert_k(const unsigned char* raw,
                                          unsigned char* dst, int tid) {
  constexpr int CPR = C::RAW / C::BK / 16;  // chunks in a raw row
#pragma unroll 4
  for (int ch = tid; ch < C::BK * CPR; ch += 128) {
    const int row = ch / CPR, cc = ch % CPR;
    const uint4 x = *reinterpret_cast<const uint4*>(raw + ch * 16);
    const int off = cc * C::LBO_K + (row / 8) * C::SBO + (row % 8) * 16;
    if constexpr (C::F32) {
      uint4 hi, lo;
      split_tf32(__uint_as_float(x.x), hi.x, lo.x);
      split_tf32(__uint_as_float(x.y), hi.y, lo.y);
      split_tf32(__uint_as_float(x.z), hi.z, lo.z);
      split_tf32(__uint_as_float(x.w), hi.w, lo.w);
      *reinterpret_cast<uint4*>(dst + off) = hi;
      *reinterpret_cast<uint4*>(dst + C::KPLANE + off) = lo;
    } else {
      *reinterpret_cast<uint4*>(dst + off) = x;
    }
  }
}

// raw V [BK][HD] -> V^T planes.  An item is 8 keys (group g) x 4 dims
// (quad dq).  f32: position 8g + 4 * par + m of row d holds key
// 8g + 2m + par (the key permutation above).  bf16: position = key.
template <class C>
__device__ __forceinline__ void convert_v(const unsigned char* raw,
                                          unsigned char* dst, int tid) {
  constexpr int NQ = C::RAW / C::BK / (4 * C::ES);  // dim quads: HD / 4
#pragma unroll 2
  for (int it = tid; it < (C::BK / 8) * NQ; it += 128) {
    const int g = it / NQ, dq = it % NQ;
    if constexpr (C::F32) {
      const float* v = reinterpret_cast<const float*>(raw);
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        float4 r[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          r[m] = *reinterpret_cast<const float4*>(
              v + (8 * g + 2 * m + par) * (4 * NQ) + 4 * dq);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = 4 * dq + i;
          const int off =
              (2 * g + par) * C::LBO_V + (d / 8) * C::SBO_V + (d % 8) * 16;
          const float x[4] = {(&r[0].x)[i], (&r[1].x)[i], (&r[2].x)[i],
                              (&r[3].x)[i]};
          uint4 hi, lo;
          split_tf32(x[0], hi.x, lo.x);
          split_tf32(x[1], hi.y, lo.y);
          split_tf32(x[2], hi.z, lo.z);
          split_tf32(x[3], hi.w, lo.w);
          *reinterpret_cast<uint4*>(dst + C::OFF_V + off) = hi;
          *reinterpret_cast<uint4*>(dst + C::OFF_V + C::VPLANE + off) = lo;
        }
      }
    } else {
      const unsigned char* v = raw;
      uint2 r[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        r[u] = *reinterpret_cast<const uint2*>(
            v + ((8 * g + u) * (4 * NQ) + 4 * dq) * 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * dq + i;
        const uint32_t sel = (i & 1) ? 0x7632 : 0x5410;
        uint4 w;
        w.x = __byte_perm(i < 2 ? r[0].x : r[0].y, i < 2 ? r[1].x : r[1].y,
                          sel);
        w.y = __byte_perm(i < 2 ? r[2].x : r[2].y, i < 2 ? r[3].x : r[3].y,
                          sel);
        w.z = __byte_perm(i < 2 ? r[4].x : r[4].y, i < 2 ? r[5].x : r[5].y,
                          sel);
        w.w = __byte_perm(i < 2 ? r[6].x : r[6].y, i < 2 ? r[7].x : r[7].y,
                          sel);
        const int off = g * C::LBO_V + (d / 8) * C::SBO_V + (d % 8) * 16;
        *reinterpret_cast<uint4*>(dst + C::OFF_V + off) = w;
      }
    }
  }
}


struct Geo {  // what the producer and the consumers share about a block
  int bi, head, kh, q0;
  Range r;
};

// The producer warpgroup: thread 0 keeps STAGES TMA loads of raw K/V tiles
// in flight; all 128 threads convert each raw tile into a free converted
// buffer, then hand it to the consumers.
template <class C>
__device__ __forceinline__ void producer(const CUtensorMap* tk,
                                         const CUtensorMap* tv,
                                         unsigned char* smem, uint64_t* bars,
                                         const Geo& geo) {
  if constexpr (C::NW == 2) setmaxnreg_dec<56>();
  const int tid = threadIdx.x;
  uint64_t* full_raw = bars;
  uint64_t* full_cv = bars + C::STAGES;
  uint64_t* empty_cv = full_cv + C::NBUF;
  auto issue = [&](int t) {
    const int s = t % C::STAGES;
    unsigned char* dst = smem + s * 2 * C::RAW;
    const int kt = geo.r.lo + t * C::BK;
    mbar_expect_tx(&full_raw[s], 2 * C::RAW);
    tma_load_4d(dst, tk, 0, geo.kh, kt, geo.bi, &full_raw[s]);
    tma_load_4d(dst + C::RAW, tv, 0, geo.kh, kt, geo.bi, &full_raw[s]);
  };
  if (tid == 0)
    for (int t = 0; t < min(C::STAGES, geo.r.n); ++t) issue(t);
  for (int t = 0; t < geo.r.n; ++t) {
    const int s = t % C::STAGES, b = t % C::NBUF;
    const unsigned char* raw = smem + s * 2 * C::RAW;
    unsigned char* buf = smem + C::OFF_BUF + b * C::BUF;
    mbar_wait(&full_raw[s], (t / C::STAGES) & 1);
    mbar_wait(&empty_cv[b], ((t / C::NBUF) & 1) ^ 1);
    convert_k<C>(raw, buf, tid);
    convert_v<C>(raw + C::RAW, buf, tid);
    fence_proxy_async();
    mbar_arrive(&full_cv[b]);
    named_sync(1, 128);  // every thread has read raw stage s
    if (tid == 0 && t + C::STAGES < geo.r.n) issue(t + C::STAGES);
  }
}

// S = Q K^T for one consumer warpgroup: 3xTF32 for f32, Q from registers
// (qa[kk][plane][4]) or from shared memory (qaddr)
template <class C, int NQA>
__device__ __forceinline__ void score(float (&s)[C::BK / 2],
                                      const uint32_t (&qa)[NQA][C::PL][4],
                                      uint32_t qaddr, uint32_t kaddr) {
  constexpr int NK = C::RAW / C::BK / C::ES / C::KSTEP;  // HD / KSTEP
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint64_t kh = gmma_desc(kaddr + 2 * kk * C::LBO_K, C::LBO_K, C::SBO);
    if constexpr (C::F32) {
      const uint64_t kl = kh + (C::KPLANE >> 4);
      if constexpr (C::QREG) {
        Wgmma_tf32_rs<C::BK>::run(s, qa[kk][1], kh, kk > 0);
        Wgmma_tf32_rs<C::BK>::run(s, qa[kk][0], kl, 1);
        Wgmma_tf32_rs<C::BK>::run(s, qa[kk][0], kh, 1);
      } else {
        const uint64_t qh =
            gmma_desc(qaddr + 2 * kk * C::LBO_Q, C::LBO_Q, C::SBO);
        const uint64_t ql = qh + (C::QPLANE >> 4);
        Wgmma_tf32_ss<C::BK>::run(s, ql, kh, kk > 0);
        Wgmma_tf32_ss<C::BK>::run(s, qh, kl, 1);
        Wgmma_tf32_ss<C::BK>::run(s, qh, kh, 1);
      }
    } else if constexpr (C::QREG) {
      Wgmma_bf16_rs<C::BK>::run(s, qa[kk][0], kh, kk > 0);
    } else {
      const uint64_t qd =
          gmma_desc(qaddr + 2 * kk * C::LBO_Q, C::LBO_Q, C::SBO);
      Wgmma_bf16_ss<C::BK>::run(s, qd, kh, kk > 0);
    }
  }
}

template <class C, typename T>
__device__ __forceinline__ void consumer(const T* __restrict__ q,
                                         T* __restrict__ o,
                                         unsigned char* smem, uint64_t* bars,
                                         const Geo& geo, int sq, int sk,
                                         int h, int kind, int window,
                                         int q_offset, float scale) {
  if constexpr (C::NW == 2) setmaxnreg_inc<224>();
  constexpr int HD = C::RAW / C::BK / C::ES;
  constexpr int BK = C::BK;
  uint64_t* full_cv = bars + C::STAGES;
  uint64_t* empty_cv = full_cv + C::NBUF;
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int c = lane % 4;
  const int row0 = geo.q0 + 64 * cw;          // first query of this group
  const int rows = min(64, sq - row0);        // its valid rows (may be <= 0)
  const int rr = 16 * warp + lane / 4;        // this thread's rows rr, rr + 8
  const int qpos0 = q_offset + row0 + rr, qpos1 = qpos0 + 8;
  const int qpos_first = q_offset + row0;
  const int qpos_last = q_offset + row0 + rows - 1;
  const long q_stride = (long)h * HD;
  const T* qb = q + ((long)geo.bi * sq * h + geo.head) * HD;

  // Q as the A operand
  constexpr int NQA = C::QREG ? HD / C::KSTEP : 1;
  uint32_t qa[NQA][C::PL][4];
  uint32_t qaddr = 0;
  if constexpr (C::QREG) {
#pragma unroll
    for (int kk = 0; kk < NQA; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rr + 8 * (i % 2);
        const bool in = r < rows;
        if constexpr (C::F32) {
          const int col = 8 * kk + c + 4 * (i / 2);
          const float x = in ? qb[(row0 + r) * q_stride + col] : 0.f;
          split_tf32(x, qa[kk][0][i], qa[kk][1][i]);
        } else {
          const int col = 16 * kk + 2 * c + 8 * (i / 2);
          qa[kk][0][i] = in ? *reinterpret_cast<const uint32_t*>(
                                  qb + (row0 + r) * q_stride + col)
                            : 0u;
        }
      }
  } else {
    unsigned char* qs = smem + C::OFF_Q + cw * C::PL * C::QPLANE;
    constexpr int CPR = HD / C::KC;
#pragma unroll 4
    for (int ch = t; ch < 64 * CPR; ch += 128) {
      const int r = ch / CPR, cc = ch % CPR;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (r < rows)
        x = *reinterpret_cast<const uint4*>(qb + (row0 + r) * q_stride +
                                            cc * C::KC);
      const int off = cc * C::LBO_Q + (r / 8) * C::SBO + (r % 8) * 16;
      if constexpr (C::F32) {
        uint4 hi, lo;
        split_tf32(__uint_as_float(x.x), hi.x, lo.x);
        split_tf32(__uint_as_float(x.y), hi.y, lo.y);
        split_tf32(__uint_as_float(x.z), hi.z, lo.z);
        split_tf32(__uint_as_float(x.w), hi.w, lo.w);
        *reinterpret_cast<uint4*>(qs + off) = hi;
        *reinterpret_cast<uint4*>(qs + C::QPLANE + off) = lo;
      } else {
        *reinterpret_cast<uint4*>(qs + off) = x;
      }
    }
    fence_proxy_async();
    named_sync(2 + cw, 128);
    qaddr = saddr(qs);
  }

  const float sl2 = scale * LOG2E;
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // Two consumer groups take turns at S = Q K^T (named barriers 4 + cw):
  // group 1 scores while group 0 runs its softmax, so the tensor cores
  // are not left idle while both groups compute exponentials.  Every turn
  // is taken and passed on, skipped tiles included; group 1 gives group 0
  // the first turn and group 0 takes the last one back.
  constexpr bool PINGPONG = C::NW == 2;
  if (PINGPONG && cw == 1) named_arrive(4, 256);

  for (int it = 0; it < geo.r.n; ++it) {
    const int b = it % C::NBUF;
    const int kt = geo.r.lo + it * BK;
    mbar_wait(&full_cv[b], (it / C::NBUF) & 1);
    if (PINGPONG) named_sync(4 + cw, 256);
    if (rows <= 0 || (kind != BIDIR && kt > qpos_last)) {
      if (PINGPONG) named_arrive(5 - cw, 256);
      mbar_arrive(&empty_cv[b]);  // past this group's diagonal: adds 0
      continue;
    }
    const uint32_t buf = saddr(smem + C::OFF_BUF + b * C::BUF);

    float s[BK / 2];
    wgmma_fence();
    score<C>(s, qa, qaddr, buf);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    if (PINGPONG) named_arrive(5 - cw, 256);

    // mask, scale into base 2, row max over the quad
    const bool inside =
        kt + BK <= sk &&
        (kind == BIDIR ||
         (kt + BK - 1 <= qpos_first &&
          (kind != SWA || window <= 0 || kt > qpos_last - window)));
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hh + e];
          if (inside) {
            x *= sl2;
          } else {
            const int kpos = kt + 8 * j + 2 * c + e;
            const int qpos = hh ? qpos1 : qpos0;
            bool ok = true;
            if (kind != BIDIR) {
              ok = kpos <= qpos;
              if (kind == SWA && window > 0) ok = ok && kpos > qpos - window;
            }
            x = kpos >= sk ? -INFINITY : (ok ? x * sl2 : NEG_INF);
          }
          mt[hh] = fmaxf(mt[hh], x);
        }
    float alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
      mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
      const float m_new = fmaxf(m[hh], mt[hh]);
      alpha[hh] = ex2(m[hh] - m_new);
      m[hh] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hh + e];
          x = ex2(x - m[hh]);
          ls[hh] += x;
        }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];
    }

    // O += P V
    const uint32_t vaddr = buf + C::OFF_V;
    if constexpr (C::F32) {
      uint32_t pa[BK / 8][2][4];  // [key group][hi, lo][A word]
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        // A word i is row rr + 8 (i % 2), position c + 4 (i / 2), which
        // holds key 2c + i / 2 of the group (the V^T permutation)
        split_tf32(s[4 * j + 0], pa[j][0][0], pa[j][1][0]);
        split_tf32(s[4 * j + 2], pa[j][0][1], pa[j][1][1]);
        split_tf32(s[4 * j + 1], pa[j][0][2], pa[j][1][2]);
        split_tf32(s[4 * j + 3], pa[j][0][3], pa[j][1][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const uint64_t vh =
            gmma_desc(vaddr + 2 * j * C::LBO_V, C::LBO_V, C::SBO_V);
        const uint64_t vl = vh + (C::VPLANE >> 4);
        Wgmma_tf32_rs<HD>::run(acc, pa[j][1], vh, 1);
        Wgmma_tf32_rs<HD>::run(acc, pa[j][0], vl, 1);
        Wgmma_tf32_rs<HD>::run(acc, pa[j][0], vh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        fence_regs(pa[j][0]);
        fence_regs(pa[j][1]);
      }
    } else {
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma_bf16_rs<HD>::run(
            acc, pa[kk],
            gmma_desc(vaddr + 2 * kk * C::LBO_V, C::LBO_V, C::SBO_V), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
    }
    fence_regs(acc);
    mbar_arrive(&empty_cv[b]);
  }
  if (PINGPONG && cw == 0) named_sync(4, 256);

  // epilogue: the quad's partial sums, one division, 8-byte stores
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  T* ob = o + ((long)geo.bi * sq * h + geo.head) * HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rr + 8 * hh;
    if (r >= rows) continue;
    const float den = fmaxf(l[hh], 1e-30f);
    T* orow = ob + (row0 + r) * q_stride + 2 * c;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float x0 = acc[4 * j + 2 * hh] / den;
      const float x1 = acc[4 * j + 2 * hh + 1] / den;
      if constexpr (C::F32)
        *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(x0, x1);
      else
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <typename T, int HD, int NWG>
__global__ void __launch_bounds__(Cfg<T, HD, NWG>::NT, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const T* __restrict__ q, T* __restrict__ o, int sq,
                    int sk, int h, int kvh, int kind, int window,
                    int q_offset, float scale) {
  using C = Cfg<T, HD, NWG>;
  extern __shared__ unsigned char smem_dyn[];
  // TMA destinations and descriptors want an aligned base
  unsigned char* smem =
      smem_dyn + ((1024 - (saddr(smem_dyn) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);

  // heaviest query tile first: late causal tiles see the most keys
  const int qt = kind == BIDIR ? blockIdx.y : gridDim.y - 1 - blockIdx.y;
  Geo geo;
  geo.bi = blockIdx.x / h;
  geo.head = blockIdx.x % h;
  geo.kh = geo.head / (h / kvh);
  geo.q0 = qt * 64 * NWG;
  geo.r = key_tiles(q_offset + geo.q0,
                    q_offset + min(geo.q0 + 64 * NWG, sq) - 1, sk, kind,
                    window, C::BK);

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) mbar_init(&bars[s], 1);
    for (int b = 0; b < C::NBUF; ++b) {
      mbar_init(&bars[C::STAGES + b], 128);
      mbar_init(&bars[C::STAGES + C::NBUF + b], 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128)
    producer<C>(&tk, &tv, smem, bars, geo);
  else
    consumer<C>(q, o, smem, bars, geo, sq, sk, h, kind, window, q_offset,
                scale);
}

// ---------------------------------------------------------------------------
// The FMA body (the first CUDA design), kept for f32 hd 256 only: f32
// FMAs on the CUDA cores, fed from shared memory padded by one float a
// row; one block per (batch * head, 64 queries).

template <int HD> struct Tiles;
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
flash_fwd_fma(const T* __restrict__ q, const T* __restrict__ k,
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

#pragma unroll 8
  for (int i = 0; i < BQ * HD / NT; ++i) {
    const int e = tid + i * NT, r = e / HD, d = e % HD;
    Qs[r * LD + d] = (q0 + r < sq) ? to_f(qb[(q0 + r) * q_stride + d]) : 0.f;
  }

  const Range rg = key_tiles(q_offset + q0, q_offset + min(q0 + BQ, sq) - 1,
                             sk, kind, window, BK);
  const int qpos = q_offset + q0 + row;
  float m = NEG_INF, l = 0.f;
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;

  for (int kt = rg.lo; kt < rg.lo + rg.n * BK; kt += BK) {
    __syncthreads();  // Q loaded; previous K/V/P tile consumed
#pragma unroll 8
    for (int i = 0; i < BK * HD / NT; ++i) {
      const int e = tid + i * NT, r = e / HD, d = e % HD;
      const bool in = kt + r < sk;
      Ks[r * LD + d] = in ? to_f(kb[(kt + r) * k_stride + d]) : 0.f;
      Vs[r * LD + d] = in ? to_f(vb[(kt + r) * k_stride + d]) : 0.f;
    }
    __syncthreads();

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

// ---------------------------------------------------------------------------
// host side

struct Args {
  const void *q, *k, *v;
  void* o;
  int b, sq, sk, h, kvh, kind, window, q_offset;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
cudaError_t launch_fma(const Args& a) {
  constexpr size_t smem = smem_bytes<HD>();
  // raised once per instance: the attribute holds for every later launch
  // (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_fma<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(a.b * a.h, (a.sq + Tiles<HD>::BQ - 1) / Tiles<HD>::BQ);
  flash_fwd_fma<T, HD><<<grid, Tiles<HD>::NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.sq, a.sk, a.h,
      a.kvh, a.kind, a.window, a.q_offset, a.scale);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a (b, sk, kv, hd) K or V tensor as a 4-D map (hd, kv, sk, b); boxes of
// one head's bk keys, unswizzled, rows past sk zero-filled
template <typename T>
cudaError_t kv_map(CUtensorMap* map, const void* base, const Args& a, int hd,
                   int bk) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)a.kvh,
                              (cuuint64_t)a.sk, (cuuint64_t)a.b};
  const cuuint64_t strides[3] = {hd * es, a.kvh * hd * es,
                                 (cuuint64_t)a.sk * a.kvh * hd * es};
  const cuuint32_t box[4] = {(cuuint32_t)hd, 1, (cuuint32_t)bk, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int HD, int NWG>
cudaError_t launch_wgmma(const Args& a) {
  using C = Cfg<T, HD, NWG>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma<T, HD, NWG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tk, tv;
  cudaError_t err = kv_map<T>(&tk, a.k, a, HD, C::BK);
  if (err == cudaSuccess) err = kv_map<T>(&tv, a.v, a, HD, C::BK);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.b * a.h, (a.sq + 64 * NWG - 1) / (64 * NWG));
  flash_fwd_wgmma<T, HD, NWG><<<grid, C::NT, C::SMEM, a.stream>>>(
      tk, tv, static_cast<const T*>(a.q), static_cast<T*>(a.o), a.sq, a.sk,
      a.h, a.kvh, a.kind, a.window, a.q_offset, a.scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kind: 0 causal, 1 swa, 2 bidir.
// scale: the softmax scale, hd ** -0.5 rounded to float by the caller.
// bq: the query tile, 64 or 128 (kernels/flash_attention.py::query_tile);
// f32 hd 128 and 256 take 64 only.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int b, int sq, int sk, int h,
                                   int kvh, int hd, int dtype, int kind,
                                   int window, int q_offset, float scale,
                                   int bq, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kvh <= 0 || h % kvh != 0 ||
      (bq != 64 && bq != 128))
    return cudaErrorInvalidValue;
  const Args a{q,    k,    v,      o,        b,     sq,
               sk,   h,    kvh,    kind,     window, q_offset,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch(dtype, hd, [&](auto* tag, auto hd_c) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int HD = decltype(hd_c)::value;
    constexpr bool F32 = std::is_same<T, float>::value;
    if constexpr (F32 && HD == 256) {
      return bq == 64 ? launch_fma<T, HD>(a) : cudaErrorInvalidValue;
    } else if constexpr (F32 && HD == 128) {
      return bq == 64 ? launch_wgmma<T, HD, 1>(a) : cudaErrorInvalidValue;
    } else {
      return bq == 128 ? launch_wgmma<T, HD, 2>(a)
                       : launch_wgmma<T, HD, 1>(a);
    }
  });
}
