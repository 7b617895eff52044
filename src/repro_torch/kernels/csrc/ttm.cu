// Sparse TTM of the CUTHERMO paper (section VI-B, PASTA's
// spt_TTMRankRBNnzKernelSM: the shared-memory abuse case study) for Hopper
// (sm_90a).
//
// Both kernels compute Y[f, c] = sum_n vals[f, n] * urows[f, n, c] for
// row-major float32 vals (F, NF) and pre-gathered U rows urows (F, NF, R),
// with float32 accumulation and Y (F, R) in float32.  Blocks are (32, 8)
// threads: the 32 lanes of a warp lie on the rank axis c (striding by 32
// when R > 32) and the 8 warps of a block on 8 fibers, so warp w of block b
// owns fiber f = 8 * b + w.  Warps past F return before touching memory.  The
// kernels launch on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError() right after its
// launch.
//
// Bound on an H100 SXM: the work reads vals and urows once and writes Y once,
// 4 * (F * NF + F * NF * R + F * R) bytes; its 2 * F * NF * R FLOPs are
// negligible, so device-memory bytes over 3.35 TB/s bound it (F = 512, NF = 8,
// R = 32: 0.60 MB, 0.18 us; F = 262144: 310 MB, 93 us).  A warp reads
// urows[f, n, 0..31] as one 128 B line per n and writes Y[f] as one line, so
// both kernels stream coalesced and F / 8 blocks fill the card.  What the
// design does about the bound is to keep every device-memory access whole
// lines; the scratch variant adds on-chip shared-memory traffic on top, which
// is the inefficiency the profiler is there to show.

#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 8;

// ---------------------------------------------------------------------------
// scratch -- replaces repro/kernels/ttm.py:_ttm_scratch_kernel.
//
// PASTA's shape: each thread accumulates y_shr[w][c] += vals * urows in a
// slice of shared memory (8 x R floats per block, dynamic) that no other
// thread ever reads, then copies the slice to Y.  Nothing is shared, so the
// shared memory buys nothing: that is the abuse.  The slice is accessed
// through a volatile pointer so that each += is a real shared-memory load and
// store, as in PASTA's code, and the compiler cannot quietly turn the buffer
// into the register accumulator of the fused kernel.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kLanes * kWarps)
ttm_scratch_kernel(const float* __restrict__ vals, const float* __restrict__ urows,
                   float* __restrict__ y, int f, int nf, int r) {
  extern __shared__ float y_shr_raw[];  // [kWarps][r]
  const int lane = threadIdx.x;
  const int w = threadIdx.y;
  const int fib = blockIdx.x * kWarps + w;
  if (fib >= f) return;
  volatile float* y_shr = y_shr_raw + (size_t)w * r;
  const float* v = vals + (size_t)fib * nf;
  const float* u = urows + (size_t)fib * nf * r;
  for (int c = lane; c < r; c += kLanes) {
    y_shr[c] = 0.f;
    for (int n = 0; n < nf; ++n) {
      y_shr[c] += v[n] * u[(size_t)n * r + c];
    }
  }
  float* out = y + (size_t)fib * r;
  for (int c = lane; c < r; c += kLanes) out[c] = y_shr[c];
}

// ---------------------------------------------------------------------------
// fused -- replaces repro/kernels/ttm.py:_ttm_fused_kernel (the paper's fix).
//
// The same mapping; each thread accumulates its Y[f, c] in a register and
// stores it once.  No shared memory.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kLanes * kWarps)
ttm_fused_kernel(const float* __restrict__ vals, const float* __restrict__ urows,
                 float* __restrict__ y, int f, int nf, int r) {
  const int lane = threadIdx.x;
  const int fib = blockIdx.x * kWarps + threadIdx.y;
  if (fib >= f) return;
  const float* v = vals + (size_t)fib * nf;
  const float* u = urows + (size_t)fib * nf * r;
  float* out = y + (size_t)fib * r;
  for (int c = lane; c < r; c += kLanes) {
    float acc = 0.f;
    for (int n = 0; n < nf; ++n) {
      acc += v[n] * u[(size_t)n * r + c];
    }
    out[c] = acc;
  }
}

}  // namespace

// Plain C entry points for ctypes.  The scratch kernel takes 8 * R floats of
// dynamic shared memory; the wrapper keeps that within the 48 KB a block gets
// without opting in (R <= 1536).
extern "C" {

int repro_ttm_scratch(const void* vals, const void* urows, void* y, int f,
                      int nf, int r, void* stream) {
  const int blocks = (f + kWarps - 1) / kWarps;
  const size_t smem = sizeof(float) * kWarps * (size_t)r;
  ttm_scratch_kernel<<<blocks, dim3(kLanes, kWarps), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const float*>(urows),
      static_cast<float*>(y), f, nf, r);
  return static_cast<int>(cudaGetLastError());
}

int repro_ttm_fused(const void* vals, const void* urows, void* y, int f,
                    int nf, int r, void* stream) {
  const int blocks = (f + kWarps - 1) / kWarps;
  ttm_fused_kernel<<<blocks, dim3(kLanes, kWarps), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const float*>(urows),
      static_cast<float*>(y), f, nf, r);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
