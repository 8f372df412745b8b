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
// `Pages`): the two read the same values into the same places and reduce
// them in the same order, so a paged cache and a fixed one with the same
// contents give bit-identical outputs.
//
// Layouts are the port's public ones, read in place:
//   q, o (b, 1, h, hd)   contiguous: k, v caches (b, S, kv, hd)
//   paged: k, v pools (rows, pg, kv, hd), bt (b, ncols) int32, S = ncols * pg
//   kv_len (b,) int32
// contiguous and 16-byte aligned, f32 or bf16.  The kernel writes o and,
// where the caller passes it (contiguous entry only), lse (b, h) f32.
// The g = h / kv query heads of a kv head share every K/V row read (g = 7
// for qwen2-0.5b; a runtime value up to GMAX).
//
// Semantics (the reference's jax path): a slot streams its first
// n = min(kv_len, S) keys; keys at or past n score the finite
// NEG_INF = -1e30, so kv_len <= 0 streams all S keys and gives their
// uniform average; keys past the stream score -inf and add nothing.
// Scores, p and the online softmax (m, l, acc) stay in f32 (in base 2:
// s * scale * log2 e and exp2); the output divides by max(l, 1e-30) once,
// after the splits are combined.  The optional lse is the log-sum-exp of
// the slot's scaled scores in natural units, m * ln 2 + ln l, from the
// combined (m, l) of the same launch: what merges decode over chunks of
// the sequence held by different ranks (models/attention.py).  A slot with
// no valid key gets NEG_INF + ln l, which is NEG_INF in f32, as the plain
// version's log-sum-exp of NEG_INF scores.
//
// What bounds it on an H100.  Decode reads each streamed K/V row once and
// does 4 * hd operations per (query head, key): bound by bytes.  At the
// serving shape (qwen2-0.5b, b 8, kv 2, hd 64, S 160, f32) it moves ~1.4 MB,
// 0.41 us at 3.35 TB/s; the cache sits in the 50 MB L2 between steps, so
// what bounds a call there is the launch, one round of load latency and
// the combine, not bandwidth.  At a long context (S 16 384) K+V is 134 MB,
// past L2: 0.040 ms at 3.35 TB/s, and only many SMs with many bytes in
// flight each draw that bandwidth.
//
// What the design does about it.
//   * Split-K over a thread-block cluster, in one launch: grid (b, kv,
//     nsplit), cluster (1, 1, nsplit), nsplit <= 8 (the portable cluster
//     size).  Block `split` runs the online softmax over its own key range;
//     after a cluster barrier every rank reads the ranks' (m, l) per head
//     through distributed shared memory, and rank r combines, in rank order,
//     the acc of outputs r * NT + i, (r + nsplit) * NT + i, ... and writes
//     them.  No global scratch, no atomics, no second launch.  Every rank
//     computes the combined (m, l) of each head; rank 0 alone writes the
//     lse, so each (slot, head) is stored once.
//   * Loads that overlap compute: each K/V row is one contiguous run of hd
//     elements, copied in 16-byte cp.async pieces into a ring of STAGES
//     stages of KT keys (16 KB of K and of V each); AHEAD stages are in
//     flight past the ones being read.  A stage's row offsets are computed
//     ahead into shared memory (for `Pages` a block-table read whose latency
//     hides behind a stage of work), so stages may straddle pages and pages
//     may span stages: any page size works (1, 5, 16, 128).
//   * Two roles, one barrier a stage: scorer warps score stage i (one warp
//     per head, KPL keys a lane, q from shared memory, K read 16 bytes at a
//     time, one redux for the max, the denominator kept per lane) while PV
//     warps fold stage i - 1 into acc (4 dims of every head a thread, p and
//     the rescale factors read four heads at a time, double-buffered).  The
//     work follows the runtime g: heads g..GB-1 of the bound GB (8 or 16)
//     are never scored.
//
// The split rule (kernels/flash_decode.py::split_geometry, its one copy):
// a function of (b, kv, S) only, S the logical length.  units =
// ceil(S / 64); nsplit = clamp(ceil(96 / (b * kv)), 1, min(8, units));
// each split takes ceil(units / nsplit) units of 64 keys (so boundaries
// are multiples of every stage size), and trailing splits that would start
// at or past S are dropped.  The wrapper passes (nsplit, keys per split) to
// both entries, which check that they cover [0, S) on 64-key boundaries.
// The aim is 96 blocks, not one per SM: 128 blocks in clusters of 8 did
// not land on 128 SMs (some SMs ran two, and they set the time); PERF.md
// has the measurements.  Serving shape: 3 splits of 64 keys, 48 blocks.
// S 16 384 at b 8: 6 splits of 2752 keys, 96 blocks.
#include <math.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int GMAX = 16;           // most query heads per kv head
constexpr int STAGES = 4;          // K/V stages in the cp.async ring
constexpr int AHEAD = STAGES - 2;  // stages in flight past the current one
constexpr int SPLIT_UNIT = 64;     // keys; split boundaries are multiples
constexpr int MAX_SPLIT = 8;       // portable cluster size
constexpr int DV = 4;              // dims per thread in the PV pass

// Tile geometry and shared-memory layout of one (T, HD, GB) instance; GB
// (8 or 16) bounds the group g, so per-head arrays hold GB entries.
template <typename T, int HD, int GB> struct Geo {
  // threads of each role (scores, PV): 256 where 128 registers a thread
  // hold the work without spilling (hd * sizeof(T) <= 256 bytes, g <= 8),
  // else 128, which leaves a thread up to 255 registers
  static constexpr int NR = GB == 8 && HD * sizeof(T) <= 256 ? 256 : 128;
  static constexpr int NT = 2 * NR;     // threads per block
  static constexpr int NWR = NR / 32;   // warps of each role
  static constexpr int VE = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int CH = HD / VE;              // 16-byte pieces per row
  // keys per stage: 16 KB of K (and of V) a stage, at most SPLIT_UNIT
  static constexpr int KT_RAW = 16384 / (HD * (int)sizeof(T));
  static constexpr int KT = KT_RAW < SPLIT_UNIT ? KT_RAW : SPLIT_UNIT;
  static constexpr int KPL = KT > 32 ? KT / 32 : 1;  // keys per lane
  static constexpr int ROW = HD + VE;   // padded K/V row: rows 16 B apart
  static constexpr int QROW = HD + 4;   // padded f32 q row
  static constexpr int PROW = GB + 4;   // p of one key, every head
  static constexpr int DC = HD / DV;    // dim chunks of the PV pass
  static constexpr int KG = NR / DC;    // key groups of the PV pass
  static constexpr size_t RING = (size_t)STAGES * 2 * KT * ROW * sizeof(T);
  static constexpr size_t RED = (size_t)KG * GB * HD * sizeof(float);
  static constexpr size_t Q_OFF = RING > RED ? RING : RED;  // red aliases
  static constexpr size_t P_OFF = Q_OFF + (size_t)GB * QROW * 4;
  static constexpr size_t OFFS_OFF = P_OFF + (size_t)2 * KT * PROW * 4;
  static constexpr size_t STAT_OFF = OFFS_OFF + (size_t)STAGES * KT * 8;
  // m, l, alpha (two stages), L per head, combine weights w[MAX_SPLIT][GB]
  static constexpr size_t BYTES =
      STAT_OFF + (size_t)(5 * GB + MAX_SPLIT * GB) * 4;
  static_assert(KT >= 16 && SPLIT_UNIT % KT == 0 && KT % 16 == 0,
                "a stage divides the split unit");
  static_assert(NR % DC == 0 && GB % 4 == 0 && GB % NWR == 0,
                "even work per thread");
  static_assert(RING % 16 == 0 && RED % 16 == 0, "16-byte aligned regions");
};

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory as floats
__device__ __forceinline__ void piece(const float* p, float (&x)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  x[0] = u.x, x[1] = u.y, x[2] = u.z, x[3] = u.w;
}
__device__ __forceinline__ void bf2(unsigned w, float& a, float& b) {
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void piece(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  bf2(u.x, x[0], x[1]), bf2(u.y, x[2], x[3]);
  bf2(u.z, x[4], x[5]), bf2(u.w, x[6], x[7]);
}
// DV = 4 elements of shared memory as floats
__device__ __forceinline__ void four(const float* p, float (&x)[4]) {
  piece(p, x);
}
__device__ __forceinline__ void four(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  bf2(u.x, x[0], x[1]), bf2(u.y, x[2], x[3]);
}

// Largest of a warp's floats (-inf included), in one reduction: floats
// mapped to ints in the same order.
__device__ __forceinline__ int ordered(int i) {
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float warp_max(float x) {
  return __int_as_float(ordered(
      __reduce_max_sync(0xffffffffu, ordered(__float_as_int(x)))));
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Scores, m and the combine run in base 2: s * scale * log2(e) and exp2,
// so p = exp2(s2 - m2) = exp(s - m).  Masked keys score NEG_INF either way.
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <typename T, int HD, int GB, typename Rows>
__global__ void __launch_bounds__((Geo<T, HD, GB>::NT), 1)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ o, float* __restrict__ lse, Rows rows,
                    int S, int h, int kvh, int keys_per_split, float scale) {
  using G = Geo<T, HD, GB>;
  constexpr int KT = G::KT, VE = G::VE, CH = G::CH, ROW = G::ROW;
  constexpr int QROW = G::QROW, PROW = G::PROW, DC = G::DC, KG = G::KG;
  constexpr int NR = G::NR, NT = G::NT, NWR = G::NWR;
  constexpr int KPL = G::KPL, HPW = GB / NWR;  // keys per lane, heads per warp

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);           // STAGES x {K, V} x KT x ROW
  float* red = reinterpret_cast<float*>(smem);    // KG x GB x HD, at the end
  float* Qs = reinterpret_cast<float*>(smem + G::Q_OFF);     // GB x QROW
  float* Ps = reinterpret_cast<float*>(smem + G::P_OFF);     // 2 x KT x PROW
  long* off_s = reinterpret_cast<long*>(smem + G::OFFS_OFF); // STAGES x KT
  float* m_s = reinterpret_cast<float*>(smem + G::STAT_OFF);  // at the end
  float* l_s = m_s + GB;      // at the end
  float* a_s = l_s + GB;      // 2 x GB: a stage's rescale factor per head
  float* L_s = a_s + 2 * GB;  // combined denominator per head
  float* w_s = L_s + GB;      // combine weight per (rank, head)

  cg::cluster_group cluster = cg::this_cluster();
  const int slot = blockIdx.x, kh = blockIdx.y, split = blockIdx.z;
  const int nsplit = gridDim.z;  // the cluster spans the grid's z
  const int g = h / kvh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // warps 0 .. NWR - 1 score; the others run PV, thread `pt` of NR
  const bool scorer = warp < NWR;
  const int pt = tid - NR;

  const int n_valid = max(0, min(kv_len[slot], S));
  const int n_stream = n_valid > 0 ? n_valid : S;
  const int k_lo = split * keys_per_split;
  const int k_end = min(k_lo + keys_per_split, n_stream);
  const int n_st = k_end > k_lo ? (k_end - k_lo + KT - 1) / KT : 0;

  // element offset of stage st's row `row` in the caches, -1 past k_end
  auto offset = [&](int st, int row) -> long {
    const int key = k_lo + st * KT + row;
    return key < k_end ? (rows.row(slot, key) * kvh + kh) * HD : -1L;
  };
  auto issue = [&](int st) {
    if (st < n_st) {
      T* kd = ring + (size_t)(st % STAGES) * 2 * KT * ROW;
      T* vd = kd + KT * ROW;
      const long* offs = off_s + (st % STAGES) * KT;
#pragma unroll
      for (int i = 0; i < (KT * CH + NT - 1) / NT; ++i) {
        const int e = tid + i * NT, r = e / CH, c = e % CH;
        if (e < KT * CH) {
          const long off = offs[r];
          if (off >= 0) {
            cp_async16(kd + r * ROW + c * VE, k + off + c * VE);
            cp_async16(vd + r * ROW + c * VE, v + off + c * VE);
          }
        }
      }
    }
    cp_async_commit();  // empty groups keep the count uniform
  };

  if (tid < KT)
    for (int st = 0; st <= AHEAD && st < n_st; ++st)
      off_s[st * KT + tid] = offset(st, tid);
  const T* qb = q + ((long)slot * h + (long)kh * g) * HD;
  for (int e = tid; e < g * HD; e += NT)
    Qs[(e / HD) * QROW + e % HD] = to_f(qb[e]);
  __syncthreads();
#pragma unroll
  for (int st = 0; st < AHEAD; ++st) issue(st);

  const float scale2 = scale * LOG2E;
  // scorers: the running max (warp-uniform) and this lane's share of the
  // denominator, for the heads warp, warp + NWR, ...
  float m_w[HPW], l_w[HPW];
#pragma unroll
  for (int hh = 0; hh < HPW; ++hh) m_w[hh] = -INFINITY, l_w[hh] = 0.f;
  // PV threads: DV dims of every head over their keys
  const int dc = pt % DC, kg = pt / DC;
  float acc[GB][DV];
#pragma unroll
  for (int gi = 0; gi < GB; ++gi)
#pragma unroll
    for (int u = 0; u < DV; ++u) acc[gi][u] = 0.f;

  // Iteration it scores stage it (scorers) while the PV threads take stage
  // it - 1, whose p the scorers wrote in the previous iteration: one
  // barrier an iteration, p and alpha double-buffered.  A stage's slot of
  // the ring lives two iterations (K read at it, V at it + 1), so AHEAD =
  // STAGES - 2 stages are in flight past the current one.
  const int n_it = n_st > 0 ? n_st + 1 : 0;
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<AHEAD - 1>();
    __syncthreads();  // stage it landed; stages it - 2 and before consumed
    issue(it + AHEAD);
    // the block-table read for stage it + AHEAD + 1 goes out now and lands
    // in shared memory after this iteration's work
    const bool ahead = !scorer && pt < KT && it + AHEAD + 1 < n_st;
    const long nxt = ahead ? offset(it + AHEAD + 1, pt) : 0;

    if (scorer && it < n_st) {
      // scores and the online-softmax update of stage it: one warp per
      // head, KPL keys a lane, q from shared memory (read once for the
      // lane's keys), K read 16 bytes at a time; the denominator stays per
      // lane until the end
      const int kb = k_lo + it * KT;
      const int nk = min(KT, k_end - kb);  // keys of this stage in range
      const T* kt = ring + (size_t)(it % STAGES) * 2 * KT * ROW;
      float* pb = Ps + (it & 1) * KT * PROW;
#pragma unroll
      for (int hh = 0; hh < HPW; ++hh) {
        const int gi = warp + hh * NWR;
        if (gi >= g) break;
        const float* qr = Qs + gi * QROW;
        float part[KPL][VE];
#pragma unroll
        for (int jj = 0; jj < KPL; ++jj)
#pragma unroll
          for (int u = 0; u < VE; ++u) part[jj][u] = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          float qx[VE];
#pragma unroll
          for (int u = 0; u < VE; u += 4) {
            float q4[4];
            piece(qr + c * VE + u, q4);
            qx[u] = q4[0], qx[u + 1] = q4[1], qx[u + 2] = q4[2],
            qx[u + 3] = q4[3];
          }
#pragma unroll
          for (int jj = 0; jj < KPL; ++jj) {
            const int j = lane + 32 * jj;
            if (j < nk) {
              float kx[VE];
              piece(kt + j * ROW + c * VE, kx);
#pragma unroll
              for (int u = 0; u < VE; ++u)
                part[jj][u] = fmaf(qx[u], kx[u], part[jj][u]);
            }
          }
        }
        float sc[KPL], mt = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < KPL; ++jj) {
          const int j = lane + 32 * jj;
          float dot = 0.f;
#pragma unroll
          for (int u = 0; u < VE; ++u) dot += part[jj][u];
          sc[jj] = j >= nk ? -INFINITY
                           : (kb + j < n_valid ? dot * scale2 : NEG_INF);
          mt = fmaxf(mt, sc[jj]);
        }
        const float m_new = fmaxf(m_w[hh], warp_max(mt));  // finite
        const float alpha = exp2f(m_w[hh] - m_new);
        float ls = 0.f;
#pragma unroll
        for (int jj = 0; jj < KPL; ++jj) {
          const int j = lane + 32 * jj;
          const float p = exp2f(sc[jj] - m_new);  // 0 past the range
          if (j < KT) pb[j * PROW + gi] = p;
          ls += p;
        }
        l_w[hh] = l_w[hh] * alpha + ls;
        m_w[hh] = m_new;
        if (lane == 0) a_s[(it & 1) * GB + gi] = alpha;
      }
    } else if (!scorer && it > 0) {
      // PV of stage it - 1, p and the rescale factors read four heads at a
      // time
      const int st = it - 1;
      const int nk = min(KT, k_end - (k_lo + st * KT));
      const T* vt = ring + (size_t)(st % STAGES) * 2 * KT * ROW + KT * ROW;
      const float* pb = Ps + (st & 1) * KT * PROW;
      const float* ab = a_s + (st & 1) * GB;
#pragma unroll
      for (int g4 = 0; g4 < GB; g4 += 4) {
        float a4[4];
        piece(ab + g4, a4);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (a4[i] != 1.f)  // the max held: nothing to rescale
#pragma unroll
            for (int u = 0; u < DV; ++u) acc[g4 + i][u] *= a4[i];
      }
      for (int j = kg; j < nk; j += KG) {
        float vx[DV];
        four(vt + j * ROW + dc * DV, vx);
#pragma unroll
        for (int g4 = 0; g4 < GB; g4 += 4) {
          float p4[4];
          piece(pb + j * PROW + g4, p4);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int u = 0; u < DV; ++u)
              acc[g4 + i][u] = fmaf(p4[i], vx[u], acc[g4 + i][u]);
        }
      }
    }
    if (ahead) off_s[((it + AHEAD + 1) % STAGES) * KT + pt] = nxt;
  }
  cp_async_wait<0>();
  if (scorer) {
#pragma unroll
    for (int hh = 0; hh < HPW; ++hh) {
      const int gi = warp + hh * NWR;
      const float l = warp_sum(l_w[hh]);
      if (gi < g && lane == 0) m_s[gi] = m_w[hh], l_s[gi] = l;
    }
  }
  __syncthreads();  // the ring is free: red aliases it

  // this block's acc: the key groups' partials summed in group order
  if (!scorer) {
#pragma unroll
    for (int gi = 0; gi < GB; ++gi)
      if (gi < g)
        *reinterpret_cast<float4*>(red + (kg * GB + gi) * HD + dc * DV) =
            make_float4(acc[gi][0], acc[gi][1], acc[gi][2], acc[gi][3]);
  }
  __syncthreads();
  for (int e = tid; e < g * HD; e += NT) {
    float sum = red[e];
#pragma unroll
    for (int r = 1; r < KG; ++r) sum += red[r * GB * HD + e];
    red[e] = sum;
  }
  cluster.sync();  // every rank's (m, l, acc) is in its shared memory

  // the combine, in rank order; rank r writes outputs r, r + nsplit, ...
  // of every NT, reading the other ranks' partials in place
  if (tid < g) {
    float mr[MAX_SPLIT], M = -INFINITY;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r) {
      mr[r] = r < nsplit ? *cluster.map_shared_rank(m_s + tid, r) : -INFINITY;
      M = fmaxf(M, mr[r]);
    }
    float L = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < nsplit) {
        // a split wholly past the stream has m = -inf, l = 0, acc = 0
        const float w = exp2f(mr[r] - M);
        w_s[r * GB + tid] = w;
        L = fmaf(*cluster.map_shared_rank(l_s + tid, r), w, L);
      }
    L_s[tid] = fmaxf(L, 1e-30f);
    if (lse != nullptr && split == 0)
      lse[(long)slot * h + (long)kh * g + tid] =
          n_valid > 0 ? fmaf(M, LN2, logf(L)) : NEG_INF + logf(L);
  }
  __syncthreads();
  T* ob = o + ((long)slot * h + (long)kh * g) * HD;
  for (int e = split * NT + tid; e < g * HD; e += nsplit * NT) {
    const int gi = e / HD;
    float part[MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      part[r] = r < nsplit ? *cluster.map_shared_rank(red + e, r) : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_SPLIT; ++r)
      if (r < nsplit) sum = fmaf(part[r], w_s[r * GB + gi], sum);
    ob[e] = from_f<T>(sum / L_s[gi]);
  }
  cluster.sync();  // no block leaves while another still reads its memory
}

template <typename T, int HD, int GB, typename Rows>
cudaError_t launch_gb(const void* q, const void* k, const void* v,
                      const void* kv_len, void* o, float* lse, Rows rows,
                      int b, int S, int h, int kvh, int nsplit, int keys,
                      float scale, cudaStream_t stream) {
  constexpr size_t smem = Geo<T, HD, GB>::BYTES;
  // raised once per instance: the attribute holds for every later launch
  // (one card per process)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_kernel<T, HD, GB, Rows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = nsplit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b, kvh, nsplit);
  cfg.blockDim = dim3(Geo<T, HD, GB>::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, flash_decode_kernel<T, HD, GB, Rows>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(o), lse, rows, S, h,
      kvh, keys, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instance whose head bound GB (8 or 16) holds the group g = h / kvh.
template <typename T, int HD, typename Rows>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* kv_len, void* o, float* lse, Rows rows, int b,
                   int S, int h, int kvh, int nsplit, int keys, float scale,
                   cudaStream_t stream) {
  if (h / kvh <= 8)
    return launch_gb<T, HD, 8>(q, k, v, kv_len, o, lse, rows, b, S, h, kvh,
                               nsplit, keys, scale, stream);
  return launch_gb<T, HD, 16>(q, k, v, kv_len, o, lse, rows, b, S, h, kvh,
                              nsplit, keys, scale, stream);
}

// Splits that the kernel can run: 1..MAX_SPLIT of `keys` keys each, a
// multiple of SPLIT_UNIT, covering [0, S) with none starting at or past S.
bool split_ok(int S, int nsplit, int keys) {
  return nsplit >= 1 && nsplit <= MAX_SPLIT && keys > 0 &&
         keys % SPLIT_UNIT == 0 && (long)(nsplit - 1) * keys < S &&
         S <= (long)nsplit * keys;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  kv_len: (b,) int32 on the device.
// lse: (b, h) f32 on the device, or null for o alone.
// scale: the softmax scale, hd ** -0.5 rounded to float by the caller.
// nsplit, keys: the split of the caller's split_geometry(b, kvh, S).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* kv_len, void* o, void* lse, int b,
                            int S, int h, int kvh, int hd, int dtype,
                            int nsplit, int keys, float scale, void* stream) {
  if (b <= 0 || S <= 0 || kvh <= 0 || h % kvh != 0 || h / kvh > GMAX ||
      !split_ok(S, nsplit, keys))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(dtype, hd, [&](auto* tag, auto hd_c) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch<T, decltype(hd_c)::value>(
        q, k, v, kv_len, o, static_cast<float*>(lse), Slots{S}, b, S, h, kvh,
        nsplit, keys, scale, s);
  });
}

// Paged pools: k, v (rows, pg, kv, hd); bt (b, ncols) int32 pool rows, each
// in [0, rows) (not checked here: the caller's page tables guarantee it).
// Otherwise as flash_decode, with S = ncols * pg.
extern "C" int flash_decode_paged(const void* q, const void* k, const void* v,
                                  const void* bt, const void* kv_len, void* o,
                                  int b, int rows, int pg, int ncols, int h,
                                  int kvh, int hd, int dtype, int nsplit,
                                  int keys, float scale, void* stream) {
  if (b <= 0 || rows <= 0 || pg <= 0 || ncols <= 0 || kvh <= 0 ||
      h % kvh != 0 || h / kvh > GMAX || (long)ncols * pg > (1L << 30) ||
      !split_ok(ncols * pg, nsplit, keys))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pages pages{static_cast<const int*>(bt), ncols, pg};
  return dispatch(dtype, hd, [&](auto* tag, auto hd_c) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch<T, decltype(hd_c)::value>(q, k, v, kv_len, o, nullptr,
                                            pages, b, ncols * pg, h, kvh,
                                            nsplit, keys, scale, s);
  });
}
