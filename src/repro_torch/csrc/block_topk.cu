// Block-local top-k sparsification: one warp per row of the blocked
// gradient, the row held in registers through a 20-step threshold bisection.
//
// Replaces repro/kernels/block_topk.py::_block_topk_call (the TPU kernel
// _block_topk_kernel with _bisect_threshold).  Per row of bs elements:
//     hi = max|g|, lo = 0;  20 times: mid = 0.5 * (lo + hi);
//     count(|g| >= mid) > k ? lo = mid : hi = mid;     tau = hi
//     keep = |g| >= tau && |g| > 0;  out = keep ? g : 0;  cnt = #keep
// on the f32 magnitude, for f32 or bf16 g; out keeps g's type.
//
// Bound: bytes (read g once, write out once and one int32 per row).  The
// TPU kernel keeps an (8, bs) tile in VMEM and reruns its compares there.
// Here a warp owns a row and each lane holds bs/32 elements in registers,
// so the 20 passes read device memory once, and each pass's count is one
// __reduce_add_sync: no shared memory, no block barrier.  Loads and stores
// are 4 elements a lane, neighbouring lanes on neighbouring addresses.
// Eight warps (rows) per block of 256 threads.
//
// Bit-exact with the plain version: mid is rounded as the reference rounds
// it (__fadd_rn, then __fmul_rn by 0.5, never contracted), compares are
// exact, and a NaN in a row makes hi NaN as jnp.max / torch.amax do.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int N_BISECT = 20;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T v[4];
};

template <typename T, int EPL>  // EPL: elements per lane = bs / 32
__global__ void __launch_bounds__(WARPS * 32)
block_topk_kernel(const T* __restrict__ g, T* __restrict__ out,
                  int* __restrict__ cnt, long long rows, int k) {
  constexpr int Q = EPL / 4;  // quads per lane
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  // lane's quad j holds elements 128 j + 4 lane .. 128 j + 4 lane + 3
  const Quad<T>* src = reinterpret_cast<const Quad<T>*>(g + row * EPL * 32);
  Quad<T> val[Q];
  float mag[EPL];
  float mx = 0.f;
  bool nan = false;
#pragma unroll
  for (int j = 0; j < Q; ++j) val[j] = src[j * 32 + lane];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float a = fabsf(to_f(val[j].v[t]));
      mag[4 * j + t] = a;
      mx = fmaxf(mx, a);
      nan |= a != a;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
  if (__any_sync(FULL, nan)) mx = __int_as_float(0x7fc00000);

  float lo = 0.f, hi = mx;
  for (int it = 0; it < N_BISECT; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    int c = 0;
#pragma unroll
    for (int e = 0; e < EPL; ++e) c += mag[e] >= mid;
    c = __reduce_add_sync(FULL, c);
    if (c > k) lo = mid;
    else hi = mid;
  }

  const float tau = hi;
  int kept = 0;
  Quad<T>* dst = reinterpret_cast<Quad<T>*>(out + row * EPL * 32);
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    Quad<T> o;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float a = mag[4 * j + t];
      const bool keep = a >= tau && a > 0.f;
      o.v[t] = keep ? val[j].v[t] : from_f<T>(0.f);
      kept += keep;
    }
    dst[j * 32 + lane] = o;
  }
  kept = __reduce_add_sync(FULL, kept);
  if (lane == 0) cnt[row] = kept;
}

template <typename T>
cudaError_t launch(const void* g, void* out, void* cnt, long long rows,
                   int bs, int k, cudaStream_t stream) {
  const dim3 grid((unsigned)((rows + WARPS - 1) / WARPS)), block(WARPS * 32);
  const T* gp = static_cast<const T*>(g);
  T* op = static_cast<T*>(out);
  int* cp = static_cast<int*>(cnt);
  switch (bs) {
    case 128: block_topk_kernel<T, 4><<<grid, block, 0, stream>>>(gp, op, cp, rows, k); break;
    case 256: block_topk_kernel<T, 8><<<grid, block, 0, stream>>>(gp, op, cp, rows, k); break;
    case 512: block_topk_kernel<T, 16><<<grid, block, 0, stream>>>(gp, op, cp, rows, k); break;
    case 1024: block_topk_kernel<T, 32><<<grid, block, 0, stream>>>(gp, op, cp, rows, k); break;
    case 2048: block_topk_kernel<T, 64><<<grid, block, 0, stream>>>(gp, op, cp, rows, k); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// g, out: (rows, bs) contiguous, dtype 0 = float32, 1 = bfloat16;
// cnt: (rows,) int32; bs in {128, 256, 512, 1024, 2048}; rows >= 1.
extern "C" int block_topk(const void* g, void* out, void* cnt, long long rows,
                          int bs, int k, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(g, out, cnt, rows, bs, k, s);
  if (dtype == 1) return launch<__nv_bfloat16>(g, out, cnt, rows, bs, k, s);
  return cudaErrorInvalidValue;
}
