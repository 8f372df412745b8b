// Compressed-DDP aggregation: the flat sum of D top-k packets.
//
// Replaces repro/kernels/scatter_agg.py::scatter_aggregate (the TPU kernel
// _scatter_agg_kernel, which walks the packets on a sequential grid and
// read-modify-writes one entry at a time).  out (n,) = 0, then for each
// packet d = 0 .. D-1 in order, out[idx[d, j]] += vals[d, j] for all j.
//
// Bound: bytes: n floats written, 8 bytes read per packet entry (plus the
// read-modify-write of the entries it touches).  A zero-fill pass of
// 16-byte stores, then one launch per packet on the stream.  Indices are
// unique within a packet, so a packet's threads never touch the same entry
// and need no atomics; the stream runs the packets one after another, so
// an entry that several packets share is summed in packet order, as the
// reference's flat scatter-add sums it.  Each value is added onto the
// running entry (+0.0 at first), never stored, so -0.0 and every rounding
// match the reference bit for bit.  An index outside [0, n) is skipped.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;

unsigned blocks_for(long long work) {
  long long b = (work + THREADS - 1) / THREADS;
  return (unsigned)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

__global__ void __launch_bounds__(THREADS)
zero_fill(float* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long n4 = n / 4;
  float4* out4 = reinterpret_cast<float4*>(out);
  for (long long i = tid; i < n4; i += stride)
    out4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = 4 * n4 + tid; i < n; i += stride) out[i] = 0.f;
}

__global__ void __launch_bounds__(THREADS)
add_packet(const float* __restrict__ vals, const int* __restrict__ idx,
           float* __restrict__ out, long long k, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = blockIdx.x * (long long)blockDim.x + threadIdx.x; j < k;
       j += stride) {
    const int i = idx[j];
    if (i >= 0 && i < n) out[i] = __fadd_rn(out[i], vals[j]);
  }
}

}  // namespace

// vals (D, k) float32, idx (D, k) int32, out (n,) float32 (16-byte aligned).
extern "C" int scatter_aggregate(const void* vals, const void* idx, void* out,
                                 long long n, int D, long long k,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  zero_fill<<<blocks_for(n / 4 + 1), THREADS, 0, s>>>(o, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || k == 0) return err;
  for (int d = 0; d < D; ++d) {
    add_packet<<<blocks_for(k), THREADS, 0, s>>>(
        static_cast<const float*>(vals) + d * k,
        static_cast<const int*>(idx) + d * k, o, k, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
