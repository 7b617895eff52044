// Helpers that every kernel source of the package includes: the float
// conversions of the two element types the wrappers pass (float32 and
// bfloat16), the one rounding rule for a value kept in float at T's
// precision, the 4-byte cp.async that stages a float32 row off 16-byte
// alignment, and the error-string export that kernels/_build.py:call reads
// when a launch fails.  Each source is built into a library of its own, so
// each carries one copy of the export.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T's precision, kept as a float (.astype(dtype) in Pallas)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// 4 bytes from global to shared memory (dst a shared-window address, as
// __cvta_generic_to_shared gives it); src_bytes 0 writes a zero and does
// not read src
__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

}  // namespace

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
