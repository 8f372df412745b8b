// What the attention kernels of the port share: element conversions, the
// dtype x head-size dispatch of their C entry points, and errstr.
//
// dtype codes and head sizes match repro_torch/kernels/_common.py (DTYPES,
// HEAD_DIMS): 0 = float32, 1 = bfloat16; head_dim 32, 64, 128 or 256.
#pragma once

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;  // finite, so a fully masked tile adds 0

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// Calls f(static_cast<T*>(nullptr), std::integral_constant<int, HD>{}) for
// the element type T named by `dtype` and the head size HD = `hd`; any
// other code or size returns cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch(int dtype, int hd, F&& f) {
  auto with_hd = [&](auto* tag) -> cudaError_t {
    switch (hd) {
      case 32: return f(tag, std::integral_constant<int, 32>{});
      case 64: return f(tag, std::integral_constant<int, 64>{});
      case 128: return f(tag, std::integral_constant<int, 128>{});
      case 256: return f(tag, std::integral_constant<int, 256>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return with_hd(static_cast<float*>(nullptr));
  if (dtype == 1) return with_hd(static_cast<__nv_bfloat16*>(nullptr));
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* errstr(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
