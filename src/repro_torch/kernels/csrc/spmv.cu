// ELL SpMV of the CUTHERMO paper's SpMV case study (section VI-E) for
// Hopper (sm_90a).
//
// spmv_ell_kernel computes y[r] = sum_k vals[r, k] * xg[r, k] for row-major
// float32 vals and xg (R, K), with float32 accumulation and y (R,) in
// float32: the padded ELL rows times x already gathered at their column
// indices (the gather stays outside the kernel, as XLA does it outside the
// Pallas kernel).  It launches on the caller's stream, allocates nothing and
// does not synchronise; the entry point returns cudaGetLastError() right
// after its launch.
//
// Bound on an H100 SXM: the work reads vals and xg once and writes y once,
// 4 * (2 * R * K + R) bytes over 3.35 TB/s (R = 1,048,576, K = 32: 273 MB,
// 81 us); 2 * R * K FLOPs are negligible.  So the kernel must stream vals
// and xg at full width: one warp per row, its lanes on consecutive k, so
// every load instruction of a warp reads 128 contiguous bytes.  A thread per
// row would read each row at a stride of 4 * K bytes instead, a pattern the
// Pallas kernel does not have.

#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps, 8 rows per block
constexpr int kRowsPerBlock = kThreads / 32;

// ---------------------------------------------------------------------------
// spmv_ell -- replaces repro/kernels/spmv.py:_spmv_kernel.
//
// Warp -> row, lanes stride over K by 32 with a float32 partial each, then a
// shuffle reduction; lane 0 stores y[r].  A warp past R returns as a whole,
// so the full-mask shuffle always has all 32 lanes.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const float* __restrict__ vals, const float* __restrict__ xg,
                float* __restrict__ y, int r, int k) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= r) return;
  const float* v = vals + static_cast<size_t>(row) * k;
  const float* x = xg + static_cast<size_t>(row) * k;
  float acc = 0.f;
  for (int c = lane; c < k; c += 32) acc += v[c] * x[c];
  for (int off = 16; off > 0; off /= 2) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[row] = acc;
}

}  // namespace

// Plain C entry points for ctypes.
extern "C" {

int repro_spmv_ell(const void* vals, const void* xg, void* y, int r, int k,
                   void* stream) {
  const int blocks = static_cast<int>(
      (static_cast<long long>(r) + kRowsPerBlock - 1) / kRowsPerBlock);
  spmv_ell_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const float*>(xg),
      static_cast<float*>(y), r, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
