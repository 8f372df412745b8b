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
// buffer: 199 KB); f32 256: the f32 128 tiles on each half of the head dim,
// a cluster of two blocks (below); bf16 32/64/128: BK 64, NWG 1 or 2; bf16
// 256: BK 32, NWG 1 or 2.  This is a fixed dispatch by shape, never a
// fallback.
//
// f32 at hd 256 (recurrentgemma-2b's local attention: h 10, kv 1, window
// 2 048, on the serving path) splits the head dim over a cluster of two
// blocks.  One block cannot hold it: Q hi and lo alone take 128 KB of
// shared memory at hd 256 and one converted K/V buffer of 32 keys another
// 128 KB, and in registers Q hi and lo would take 256 a thread beside 128
// of O.  So each 64-query tile of a head goes to a cluster (2, 1, 1), and
// block rank r holds dimensions [128 r, 128 r + 128) of Q, K, V and O: it
// runs the f32 hd-128 tiles on its half (TMA boxes of 128 columns at
// column 128 r) and computes its partial S_r = Q_r K_r^T.
//   * The handoff.  Each consumer thread stores its 16 accumulator values
//     of S_r into the peer's shared memory with st.async, which completes
//     bytes of the peer's mbarrier (two 8 KB slots, each with its barrier,
//     used by turns); one thread of each block sets the 8 KB it expects.
//     A thread then waits on its own barrier and adds the peer's values:
//     f32 addition commutes, so both blocks hold S bit for bit alike, run
//     the same softmax to the same P, m and l, and each runs O_r += P V_r
//     and writes its half of O.  No atomics: a call is bit-identical to its
//     repeat.  A block rewrites a slot two tiles after its last write, once
//     it has received the peer's partial of the tile between, which the
//     peer sent after reading that slot: no "empty" barrier is needed.  No
//     block-wide barrier either (a cluster.sync() per tile would stop all
//     four warpgroups of the pair), and no release fence per thread (a
//     release-arrive on the peer's barrier from each of 128 threads was
//     slower on the H100: PERF.md, tools/prefill_ablation.py).
//   * The pipeline.  K and V convert in stages of their own (raw rings and
//     barriers apart), and the consumer runs tile t's P V while it waits
//     for the peer's partial of tile t + 1, so the handoff's latency and
//     the conversions hide behind products.
//   * Q hi also sits in registers (64 a thread) as the A fragment, so two
//     of S's three products read only K from shared memory, whose
//     bandwidth bounds the ss product at N = 32.
// Shared memory: the 199 KB of hd-128 tiles plus the two slots, 215 KB, one
// block an SM; twice as many blocks as query tiles (660 for a 2 112-token
// prompt).  What bounds it: the 3xTF32 products (22.8 GFLOP of f32 work
// at a 2 112-token prompt, 0.138 ms at 495/3 TFLOP/s).  It runs at 40 % of
// that (PERF.md): one consumer warpgroup a block runs S, the softmax and
// P V in series, and S's ss products at N = 32 run well below the tensor
// cores' rate.
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

// the cluster of the f32 hd-256 instance: this block's rank, the peer's
// shared::cluster address of a local object, stores into the peer, the
// cluster barrier
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(saddr(p)), "r"(rank));
  return r;
}
// a 16-byte store into the peer's shared memory that, once written,
// completes 16 bytes of the transaction count of an mbarrier there
__device__ __forceinline__ void st_async_v4(uint32_t addr, float a, float b,
                                            float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
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
  // blocks a head's dims are split over (a cluster), and the dims W each
  // holds; the tiles below are a block's, W wide
  static constexpr int SPLIT = (F32 && HD == 256) ? 2 : 1;
  static constexpr int W = HD / SPLIT;
  static constexpr int BK = (W >= 256 || (F32 && W >= 128)) ? 32 : 64;
  static constexpr bool QREG = F32 ? W <= 64 : W <= 128;
  // a split block also keeps Q hi in registers, so two of S's three
  // products read only K from shared memory (its bandwidth bounds them)
  static constexpr bool QHI = SPLIT == 2;
  static constexpr int STAGES = 2;
  static constexpr int NBUF = (F32 && W >= 128) ? 1 : 2;
  static constexpr int NW = NWG;
  static constexpr int NT = 128 * (NWG + 1);
  static constexpr int RAW = BK * W * ES;  // one raw [BK][W] tile
  // K (BK x W, K-major): element (r, c) at (c / KC) * LBO_K +
  // (r / 8) * SBO + (r % 8) * 16 + (c % KC) * ES
  static constexpr int SBO = 128, LBO_K = BK * 16 + SBO / 8;
  static constexpr int KPLANE = (W / KC) * LBO_K;
  // V^T (W x BK, K-major in keys): element (d, pos) at (pos / KC) * LBO_V
  // + (d / 8) * SBO_V + (d % 8) * 16 + (pos % KC) * ES
  static constexpr int SBO_V = 144, LBO_V = (W / 8) * SBO_V;
  static constexpr int VPLANE = (BK / KC) * LBO_V;
  static constexpr int OFF_V = PL * KPLANE;  // K hi, [K lo,] V^T hi, [lo]
  static constexpr int BUF = (PL * (KPLANE + VPLANE) + 1023) / 1024 * 1024;
  // Q (64 x W per consumer) when not in registers, laid out as K
  static constexpr int LBO_Q = 64 * 16 + SBO / 8;
  static constexpr int QPLANE = QREG ? 0 : (W / KC) * LBO_Q;
  static constexpr int OFF_BUF = STAGES * 2 * RAW;
  static constexpr int OFF_Q = OFF_BUF + NBUF * BUF;
  // with a split, two slots of a 64 x BK f32 partial S written by the peer:
  // float4 j of consumer thread t at (128 j + t) * 16 bytes
  static constexpr int XSLOT = 64 * BK * 4;
  static constexpr int OFF_X = OFF_Q + NWG * PL * QPLANE;
  static constexpr int OFF_BAR = OFF_X + (SPLIT == 2 ? 2 * XSLOT : 0);
  // barriers: full_raw[STAGES], full_cv[NBUF], empty_cv[NBUF]; with a
  // split raw_k[STAGES], raw_v[STAGES], full_k, empty_k, full_v, empty_v,
  // xfull[2] (the peer's partial S is in slot b); + alignment
  static constexpr int NBAR =
      SPLIT == 2 ? 2 * STAGES + 6 : STAGES + 2 * NBUF;
  static constexpr int SMEM = OFF_BAR + 8 * NBAR + 1024;
  static_assert(SMEM <= 232448, "tiles exceed 227 KB of shared memory");
  static_assert(W % 32 == 0 && BK % 16 == 0, "tile shapes");
  static_assert(SPLIT == 1 || NWG == 1, "a split block has one consumer");
};

// raw K [BK][W] -> K planes (16-byte chunks; 8 consecutive threads read
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

// raw V [BK][W] -> V^T planes.  An item is 8 keys (group g) x 4 dims
// (quad dq).  f32: position 8g + 4 * par + m of row d holds key
// 8g + 2m + par (the key permutation above).  bf16: position = key.
template <class C>
__device__ __forceinline__ void convert_v(const unsigned char* raw,
                                          unsigned char* dst, int tid) {
  constexpr int NQ = C::RAW / C::BK / (4 * C::ES);  // dim quads: W / 4
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
  int rank, col;  // rank in the cluster; first head dim the block holds
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

// The producer of a split block (one converted buffer): K and V convert
// in stages of their own, each with its raw ring and its full/empty
// barriers, in the order K(0), then K(t + 1), V(t) for each tile t.  The
// consumer runs tile t's P V one tile late (after scoring tile t + 1), so
// K(t + 1) converts while it finishes tile t, and V(t) while it scores
// tile t + 1: no conversion waits on the consumer, nor it on one.
template <class C>
__device__ __forceinline__ void producer_split(const CUtensorMap* tk,
                                               const CUtensorMap* tv,
                                               unsigned char* smem,
                                               uint64_t* bars,
                                               const Geo& geo) {
  const int tid = threadIdx.x, n = geo.r.n;
  uint64_t* raw = bars;                     // raw_k[STAGES], raw_v[STAGES]
  uint64_t* kv = bars + 2 * C::STAGES;      // full_k, empty_k, full_v, ...
  unsigned char* buf = smem + C::OFF_BUF;
  // part 0: K, 1: V; slot s of the raw ring holds K at 2 s, V at 2 s + 1
  auto issue = [&](int t, int part) {
    const int s = t % C::STAGES;
    uint64_t* bar = raw + part * C::STAGES + s;
    mbar_expect_tx(bar, C::RAW);
    tma_load_4d(smem + (2 * s + part) * C::RAW, part ? tv : tk, geo.col,
                geo.kh, geo.r.lo + t * C::BK, geo.bi, bar);
  };
  auto stage = [&](int t, int part) {
    const int s = t % C::STAGES;
    const unsigned char* src = smem + (2 * s + part) * C::RAW;
    mbar_wait(raw + part * C::STAGES + s, (t / C::STAGES) & 1);
    mbar_wait(kv + 2 * part + 1, (t & 1) ^ 1);  // the consumers are done
    if (part)
      convert_v<C>(src, buf, tid);
    else
      convert_k<C>(src, buf, tid);
    fence_proxy_async();
    mbar_arrive(kv + 2 * part);
    named_sync(1, 128);  // every thread has read this raw tile
    if (tid == 0 && t + C::STAGES < n) issue(t + C::STAGES, part);
  };
  if (tid == 0)
    for (int t = 0; t < min(C::STAGES, n); ++t) issue(t, 0), issue(t, 1);
  if (n > 0) stage(0, 0);
  for (int t = 0; t < n; ++t) {
    if (t + 1 < n) stage(t + 1, 0);
    stage(t, 1);
  }
}

// S = Q K^T for one consumer warpgroup: 3xTF32 for f32, Q from registers
// (qa[kk][plane][4]), from shared memory (qaddr), or (QHI) hi from
// registers and lo from shared memory
template <class C, int NQA, int NP>
__device__ __forceinline__ void score(float (&s)[C::BK / 2],
                                      const uint32_t (&qa)[NQA][NP][4],
                                      uint32_t qaddr, uint32_t kaddr) {
  constexpr int NK = C::W / C::KSTEP;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const uint64_t kh = gmma_desc(kaddr + 2 * kk * C::LBO_K, C::LBO_K, C::SBO);
    if constexpr (C::F32) {
      const uint64_t kl = kh + (C::KPLANE >> 4);
      if constexpr (C::QREG) {
        Wgmma_tf32_rs<C::BK>::run(s, qa[kk][1], kh, kk > 0);
        Wgmma_tf32_rs<C::BK>::run(s, qa[kk][0], kl, 1);
        Wgmma_tf32_rs<C::BK>::run(s, qa[kk][0], kh, 1);
      } else if constexpr (C::QHI) {
        const uint64_t ql =
            gmma_desc(qaddr + 2 * kk * C::LBO_Q, C::LBO_Q, C::SBO) +
            (C::QPLANE >> 4);
        Wgmma_tf32_ss<C::BK>::run(s, ql, kh, kk > 0);
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

// P, in S's accumulator fragment, as the 3xTF32 A fragments of P V:
// [key group][hi, lo][A word]
template <class C>
__device__ __forceinline__ void p_fragments(const float (&s)[C::BK / 2],
                                            uint32_t (&pa)[C::BK / 8][2][4]) {
#pragma unroll
  for (int j = 0; j < C::BK / 8; ++j) {
    // A word i is row rr + 8 (i % 2), position c + 4 (i / 2), which holds
    // key 2c + i / 2 of the group (the V^T permutation)
    split_tf32(s[4 * j + 0], pa[j][0][0], pa[j][1][0]);
    split_tf32(s[4 * j + 2], pa[j][0][1], pa[j][1][1]);
    split_tf32(s[4 * j + 1], pa[j][0][2], pa[j][1][2]);
    split_tf32(s[4 * j + 3], pa[j][0][3], pa[j][1][3]);
  }
}

// O += P V in f32, V^T at vaddr: three tf32 products a key group, issued
// and committed; the caller waits
template <class C>
__device__ __forceinline__ void issue_pv_f32(
    float (&acc)[C::W / 2], const uint32_t (&pa)[C::BK / 8][2][4],
    uint32_t vaddr) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < C::BK / 8; ++j) {
    const uint64_t vh = gmma_desc(vaddr + 2 * j * C::LBO_V, C::LBO_V, C::SBO_V);
    const uint64_t vl = vh + (C::VPLANE >> 4);
    Wgmma_tf32_rs<C::W>::run(acc, pa[j][1], vh, 1);
    Wgmma_tf32_rs<C::W>::run(acc, pa[j][0], vl, 1);
    Wgmma_tf32_rs<C::W>::run(acc, pa[j][0], vh, 1);
  }
  wgmma_commit();
}

template <int J>
__device__ __forceinline__ void fence_frags(uint32_t (&pa)[J][2][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    fence_regs(pa[j][0]);
    fence_regs(pa[j][1]);
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
  constexpr int W = C::W;
  constexpr int BK = C::BK;
  uint64_t* full_cv = bars + C::STAGES;
  uint64_t* empty_cv = full_cv + C::NBUF;
  uint64_t* kv = bars + 2 * C::STAGES;  // split: full_k, empty_k, full_v, ..
  uint64_t* xfull = kv + 4;
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int c = lane % 4;
  const int row0 = geo.q0 + 64 * cw;          // first query of this group
  const int rows = min(64, sq - row0);        // its valid rows (may be <= 0)
  const int rr = 16 * warp + lane / 4;        // this thread's rows rr, rr + 8
  const int qpos0 = q_offset + row0 + rr, qpos1 = qpos0 + 8;
  const int qpos_first = q_offset + row0;
  const int qpos_last = q_offset + row0 + rows - 1;
  const long q_stride = (long)h * C::SPLIT * W;
  const T* qb = q + ((long)geo.bi * sq * h + geo.head) * C::SPLIT * W +
                geo.col;

  // Q as the A operand
  constexpr int NQA = C::QREG || C::QHI ? W / C::KSTEP : 1;
  uint32_t qa[NQA][C::QREG ? C::PL : 1][4];
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
    constexpr int CPR = W / C::KC;
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
    if constexpr (C::QHI) {  // the A fragments of the hi plane
#pragma unroll
      for (int kk = 0; kk < NQA; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rr + 8 * (i % 2), col = 8 * kk + c + 4 * (i / 2);
          qa[kk][0][i] = *reinterpret_cast<const uint32_t*>(
              qs + (col / C::KC) * C::LBO_Q + (r / 8) * C::SBO +
              (r % 8) * 16 + (col % C::KC) * 4);
        }
    }
  }

  const float sl2 = scale * LOG2E;
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  // The online softmax of tile kt: mask, scale into base 2, row max over
  // the quad, m and l updated; s becomes P (unnormalised), and alpha the
  // factor by which O must shrink.
  auto softmax = [&](float (&s)[BK / 2], int kt, float (&alpha)[2]) {
    const bool inside =
        kt + BK <= sk &&
        (kind == BIDIR ||
         (kt + BK - 1 <= qpos_first &&
          (kind != SWA || window <= 0 || kt > qpos_last - window)));
    // (the test is hoisted out of the loops: left inside them, it made the
    // f32 hd-256 instance 27 % slower on an H100, PERF.md)
    float mt[2] = {-INFINITY, -INFINITY};
    if (inside) {  // no key of the tile is masked for any row
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * hh + e];
            x *= sl2;
            mt[hh] = fmaxf(mt[hh], x);
          }
    } else {
      const bool windowed = kind == SWA && window > 0;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[4 * j + 2 * hh + e];
            const int kpos = kt + 8 * j + 2 * c + e;
            const int qpos = hh ? qpos1 : qpos0;
            const bool ok =
                kind == BIDIR ||
                (kpos <= qpos && (!windowed || kpos > qpos - window));
            x = kpos >= sk ? -INFINITY : (ok ? x * sl2 : NEG_INF);
            mt[hh] = fmaxf(mt[hh], x);
          }
    }
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
  };
  // O *= alpha, skipped when no row max of the warp moved
  auto rescale = [&](const float (&alpha)[2]) {
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e / 2];
    }
  };

  if constexpr (C::SPLIT == 2) {
    // One consumer warpgroup; the P V of tile it - 1 runs on the tensor
    // cores while the warpgroup waits for the peer's partial S of tile it.
    // The producer converts K(it + 1) once S(it) is done and V(it) once
    // P V(it - 1) is.  Each wgmma is issued and waited for in one branch,
    // and no register of a wgmma in flight is written: else ptxas
    // serialises every wgmma of the kernel.
    const int n = geo.r.n;
    const uint32_t buf = saddr(smem + C::OFF_BUF);
    const uint32_t peer_x = peer_addr(smem + C::OFF_X, geo.rank ^ 1) + 16 * t;
    const uint32_t peer_bar = peer_addr(xfull, geo.rank ^ 1);
    // hand this block's partial S of tile x to the peer: slot x % 2, which
    // the peer read two tiles ago, before it sent the partial of tile x - 1
    // that this block has received.  The peer's bytes may land before this
    // block's expect_tx; the phase completes when both have.
    auto push = [&](const float (&s)[BK / 2], int x) {
      const int xb = x & 1;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        st_async_v4(peer_x + xb * C::XSLOT + j * 128 * 16, s[4 * j],
                    s[4 * j + 1], s[4 * j + 2], s[4 * j + 3],
                    peer_bar + 8 * xb);
      if (t == 0) mbar_expect_tx(&xfull[xb], C::XSLOT);
    };
    // S(x) = S_0 + S_1: add the peer's partial (f32 addition commutes, so
    // both blocks get the same bits); its wait passes at once when the
    // caller has already waited
    auto pull = [&](float (&s)[BK / 2], int x) {
      const int xb = x & 1;
      mbar_wait(&xfull[xb], (x >> 1) & 1);
      const float4* mine =
          reinterpret_cast<const float4*>(smem + C::OFF_X + xb * C::XSLOT) +
          t;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float4 x4 = mine[j * 128];
        s[4 * j] += x4.x;
        s[4 * j + 1] += x4.y;
        s[4 * j + 2] += x4.z;
        s[4 * j + 3] += x4.w;
      }
    };
    uint32_t pa[BK / 8][2][4];  // P of the tile before, for its P V
    for (int it = 0; it < n; ++it) {
      float s[BK / 2];
      mbar_wait(kv, it & 1);  // full_k: K(it)
      wgmma_fence();
      score<C>(s, qa, qaddr, buf);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(kv + 1);  // empty_k: K(it) read
      push(s, it);
      if (it > 0) {
        mbar_wait(kv + 2, (it - 1) & 1);  // full_v: V(it - 1)
        issue_pv_f32<C>(acc, pa, buf + C::OFF_V);
        mbar_wait(&xfull[it & 1], (it >> 1) & 1);  // the peer's S(it)
        wgmma_wait<0>();
        fence_regs(acc);
        fence_frags(pa);
        mbar_arrive(kv + 3);  // empty_v: V(it - 1) read
      }
      pull(s, it);
      float alpha[2];
      softmax(s, geo.r.lo + it * BK, alpha);
      rescale(alpha);
      p_fragments<C>(s, pa);
    }
    if (n > 0) {  // the last tile's P V
      mbar_wait(kv + 2, (n - 1) & 1);
      issue_pv_f32<C>(acc, pa, buf + C::OFF_V);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_frags(pa);
    }
  } else {
    // Two consumer groups take turns at S = Q K^T (named barriers 4 + cw):
    // group 1 scores while group 0 runs its softmax, so the tensor cores
    // are not left idle while both groups compute exponentials.  Every
    // turn is taken and passed on, skipped tiles included; group 1 gives
    // group 0 the first turn and group 0 takes the last one back.
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

      float alpha[2];
      softmax(s, kt, alpha);
      rescale(alpha);

      // O += P V
      const uint32_t vaddr = buf + C::OFF_V;
      if constexpr (C::F32) {
        uint32_t pa[BK / 8][2][4];
        p_fragments<C>(s, pa);
        issue_pv_f32<C>(acc, pa, vaddr);
        wgmma_wait<0>();
        fence_frags(pa);
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
          Wgmma_bf16_rs<W>::run(
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
  }

  // epilogue: the quad's partial sums, one division, 8-byte stores
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  T* ob = o + ((long)geo.bi * sq * h + geo.head) * C::SPLIT * W + geo.col;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = rr + 8 * hh;
    if (r >= rows) continue;
    const float den = fmaxf(l[hh], 1e-30f);
    T* orow = ob + (row0 + r) * q_stride + 2 * c;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
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
  const int bh = blockIdx.x / C::SPLIT;  // a cluster's blocks share a head
  geo.bi = bh / h;
  geo.head = bh % h;
  geo.kh = geo.head / (h / kvh);
  geo.rank = C::SPLIT == 2 ? cluster_rank() : 0;
  geo.col = geo.rank * C::W;
  geo.q0 = qt * 64 * NWG;
  geo.r = key_tiles(q_offset + geo.q0,
                    q_offset + min(geo.q0 + 64 * NWG, sq) - 1, sk, kind,
                    window, C::BK);

  if (threadIdx.x == 0) {
    if constexpr (C::SPLIT == 2) {
      // raw_k, raw_v: one TMA each; full_k/v: the producer's threads;
      // empty_k/v: the consumer's; xfull: this block's expect_tx, and the
      // peer's bytes
      for (int i = 0; i < 2 * C::STAGES; ++i) mbar_init(&bars[i], 1);
      for (int i = 2 * C::STAGES; i < C::NBAR - 2; ++i)
        mbar_init(&bars[i], 128);
      for (int i = C::NBAR - 2; i < C::NBAR; ++i) mbar_init(&bars[i], 1);
    } else {
      for (int s = 0; s < C::STAGES; ++s) mbar_init(&bars[s], 1);
      for (int b = 0; b < C::NBUF; ++b) {
        mbar_init(&bars[C::STAGES + b], 128);
        mbar_init(&bars[C::STAGES + C::NBUF + b], 128 * NWG);
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (C::SPLIT == 2) {
    // the peer's barriers are initialised before either block arrives on
    // them
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  if (threadIdx.x >= 128)
    consumer<C>(q, o, smem, bars, geo, sq, sk, h, kind, window, q_offset,
                scale);
  else if constexpr (C::SPLIT == 2)
    producer_split<C>(&tk, &tv, smem, bars, geo);
  else
    producer<C>(&tk, &tv, smem, bars, geo);
  if constexpr (C::SPLIT == 2) {
    // neither block leaves while the peer may still address its memory
    cluster_arrive();
    cluster_wait();
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
// w dims of one head's bk keys, unswizzled, rows past sk zero-filled
template <typename T>
cudaError_t kv_map(CUtensorMap* map, const void* base, const Args& a, int hd,
                   int w, int bk) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t es = sizeof(T);
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)a.kvh,
                              (cuuint64_t)a.sk, (cuuint64_t)a.b};
  const cuuint64_t strides[3] = {hd * es, a.kvh * hd * es,
                                 (cuuint64_t)a.sk * a.kvh * hd * es};
  const cuuint32_t box[4] = {(cuuint32_t)w, 1, (cuuint32_t)bk, 1};
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
  cudaError_t err = kv_map<T>(&tk, a.k, a, HD, C::W, C::BK);
  if (err == cudaSuccess) err = kv_map<T>(&tv, a.v, a, HD, C::W, C::BK);
  if (err != cudaSuccess) return err;
  // a split head's blocks are neighbours in x, one cluster
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C::SPLIT;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(a.b * a.h * C::SPLIT, (a.sq + 64 * NWG - 1) / (64 * NWG));
  cfg.blockDim = dim3(C::NT);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = a.stream;
  cfg.attrs = cluster;
  cfg.numAttrs = C::SPLIT > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, flash_fwd_wgmma<T, HD, NWG>, tk, tv,
                           static_cast<const T*>(a.q), static_cast<T*>(a.o),
                           a.sq, a.sk, a.h, a.kvh, a.kind, a.window,
                           a.q_offset, a.scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, NWG>{}) for the instance that takes
// a query tile of bq (64 or 128) for element type T and head size HD, or
// returns cudaErrorInvalidValue: f32 at hd 128 and 256 take 64 only (their
// Q planes fill shared memory).
template <typename T, int HD, typename F>
cudaError_t with_instance(int bq, F&& f) {
  if constexpr (std::is_same<T, float>::value && HD >= 128) {
    if (bq == 64) return f(std::integral_constant<int, 1>{});
  } else {
    if (bq == 64) return f(std::integral_constant<int, 1>{});
    if (bq == 128) return f(std::integral_constant<int, 2>{});
  }
  return cudaErrorInvalidValue;
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
    return with_instance<T, HD>(bq, [&](auto nwg) -> cudaError_t {
      return launch_wgmma<T, HD, decltype(nwg)::value>(a);
    });
  });
}

// The dynamic shared memory, in bytes, of the instance that
// flash_attention_fwd launches for (hd, dtype, bq), or -1 if none does:
// for the build's logs.
extern "C" int flash_attention_smem(int hd, int dtype, int bq) {
  int bytes = -1;
  dispatch(dtype, hd, [&](auto* tag, auto hd_c) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int HD = decltype(hd_c)::value;
    return with_instance<T, HD>(bq, [&](auto nwg) -> cudaError_t {
      bytes = Cfg<T, HD, decltype(nwg)::value>::SMEM;
      return cudaSuccess;
    });
  });
  return bytes;
}
