// Fused momentum-SGD update: one pass over p, m and g.
//
// Replaces repro/kernels/block_topk.py::fused_sgdm (the TPU kernel
// _fused_sgdm_kernel over (rows, 1024) tiles).  Per element, in f32:
//     g' = g + wd * p;   m' = mu * m + g';   p' = p - lr * m'
// m stays f32, p' is cast back to p's type (f32 or bf16), and lr is read
// from a device pointer, so a schedule kept on the card costs no host sync.
//
// Bound: bytes.  An f32 element reads p, m, g and writes p', m' (20 bytes)
// for 5 flops, far below the card's ridge, so the kernel is one streaming
// pass: a grid-stride loop over 16-byte vectors (4 elements a thread a
// step) and a scalar loop for the tail of fewer than 4.  Any n; no padding.
// A bf16 or unaligned tensor takes the scalar loop throughout.
//
// Each product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn), so nvcc cannot contract them into FMAs and the result
// matches the plain PyTorch version op for op.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 132 * 16;

__device__ __forceinline__ void sgdm(float p, float m, float g, float lr,
                                     float mu, float wd, float& p_out,
                                     float& m_out) {
  const float gw = __fadd_rn(g, __fmul_rn(wd, p));
  m_out = __fadd_rn(__fmul_rn(mu, m), gw);
  p_out = __fsub_rn(p, __fmul_rn(lr, m_out));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sgdm_scalar(const T* __restrict__ p, const float* __restrict__ m,
            const T* __restrict__ g, const float* __restrict__ lr_ptr,
            T* __restrict__ p_out, float* __restrict__ m_out, long long begin,
            long long n, float mu, float wd) {
  const float lr = *lr_ptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = begin + blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += stride) {
    float pn, mn;
    sgdm(to_f(p[i]), m[i], to_f(g[i]), lr, mu, wd, pn, mn);
    p_out[i] = from_f<T>(pn);
    m_out[i] = mn;
  }
}

__global__ void __launch_bounds__(THREADS)
sgdm_vec4(const float4* __restrict__ p, const float4* __restrict__ m,
          const float4* __restrict__ g, const float* __restrict__ lr_ptr,
          float4* __restrict__ p_out, float4* __restrict__ m_out,
          long long n4, float mu, float wd) {
  const float lr = *lr_ptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 pv = p[i], mv = m[i], gv = g[i];
    float4 pn, mn;
    sgdm(pv.x, mv.x, gv.x, lr, mu, wd, pn.x, mn.x);
    sgdm(pv.y, mv.y, gv.y, lr, mu, wd, pn.y, mn.y);
    sgdm(pv.z, mv.z, gv.z, lr, mu, wd, pn.z, mn.z);
    sgdm(pv.w, mv.w, gv.w, lr, mu, wd, pn.w, mn.w);
    p_out[i] = pn;
    m_out[i] = mn;
  }
}

unsigned blocks_for(long long work) {
  long long b = (work + THREADS - 1) / THREADS;
  return (unsigned)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

bool aligned16(const void* a) {
  return reinterpret_cast<std::uintptr_t>(a) % 16 == 0;
}

}  // namespace

// p, g, p_out: n elements, dtype 0 = float32, 1 = bfloat16; m, m_out: n
// float32; lr: one float32 on the card.  Outputs must not alias inputs.
extern "C" int fused_sgdm(const void* p, const void* m, const void* g,
                          const void* lr, void* p_out, void* m_out,
                          long long n, float mu, float wd, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lr_f = static_cast<const float*>(lr);
  const float* m_f = static_cast<const float*>(m);
  float* mo_f = static_cast<float*>(m_out);
  if (dtype == 0) {
    const float* p_f = static_cast<const float*>(p);
    const float* g_f = static_cast<const float*>(g);
    float* po_f = static_cast<float*>(p_out);
    long long body = 0;
    if (aligned16(p) && aligned16(m) && aligned16(g) && aligned16(p_out) &&
        aligned16(m_out)) {
      const long long n4 = n / 4;
      body = 4 * n4;
      if (n4 > 0)
        sgdm_vec4<<<blocks_for(n4), THREADS, 0, s>>>(
            reinterpret_cast<const float4*>(p_f),
            reinterpret_cast<const float4*>(m_f),
            reinterpret_cast<const float4*>(g_f), lr_f,
            reinterpret_cast<float4*>(po_f), reinterpret_cast<float4*>(mo_f),
            n4, mu, wd);
    }
    if (body < n)
      sgdm_scalar<float><<<blocks_for(n - body), THREADS, 0, s>>>(
          p_f, m_f, g_f, lr_f, po_f, mo_f, body, n, mu, wd);
    return cudaGetLastError();
  }
  if (dtype == 1) {
    sgdm_scalar<__nv_bfloat16><<<blocks_for(n), THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p), m_f,
        static_cast<const __nv_bfloat16*>(g), lr_f,
        static_cast<__nv_bfloat16*>(p_out), mo_f, 0, n, mu, wd);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}
