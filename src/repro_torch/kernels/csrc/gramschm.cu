// GRAMSCHM kernel3 of the CUTHERMO paper (section VI-B, the strided case
// study) for Hopper (sm_90a).
//
// Both kernels compute r[j] = sum_i q[i, k] * a[i, j] for row-major float32
// q (NI, NK) -- or its transpose qt (NK, NI) -- and a (NI, NJ), with float32
// accumulation and r (NJ,) in float32.  They follow PolyBench/GPU's
// gramschmidt_kernel3 mapping: one thread per column j in 1-D blocks of 256,
// a sequential loop over i, and r[j] stored once.  Only r is computed, as in
// the Pallas kernels: the PolyBench update of a and its j > k guard are not
// part of them.  Threads past NJ return before touching memory.  The kernels
// launch on the caller's stream, allocate nothing and do not synchronise;
// each entry point returns cudaGetLastError() right after its launch.
//
// Bound on an H100 SXM: the work reads a once (NI * NJ words), one column of
// q (NI words) and writes r (NJ words); 2 * NI * NJ FLOPs are negligible, so
// device-memory bytes over 3.35 TB/s bound it (512^3: 1.06 MB, 0.32 us;
// 4096^3: 67 MB, 20 us).  A warp's 32 lanes read 32 neighbouring words of a
// row of a (one 128 B line per i), so a streams coalesced; but there are
// only NJ threads, so NJ / 256 blocks: at NJ = 4096 that is 16 blocks on
// 132 SMs, and the kernels are latency-bound, far from the bound.  They are
// the paper's rungs, kept literal for the profiler; a split-i reduction that
// fills the card is later work.

#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// naive -- replaces repro/kernels/gramschm.py:_k3_naive_kernel.
//
// Every lane of a warp reads the same q[i * NK + k] at step i: one broadcast
// word per row of q, so one 32 B sector per i of which 4 B are used, at a
// stride of NK words -- the strided walk the profiler flags on q.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
gramschm_k3_naive_kernel(const float* __restrict__ q, const float* __restrict__ a,
                         float* __restrict__ r, int ni, int nj, int nk, int k) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= nj) return;
  float acc = 0.f;
  for (int i = 0; i < ni; ++i) {
    acc += q[(size_t)i * nk + k] * a[(size_t)i * nj + j];
  }
  r[j] = acc;
}

// ---------------------------------------------------------------------------
// opt -- replaces repro/kernels/gramschm.py:_k3_opt_kernel (the transpose fix).
//
// The same mapping, reading row k of qt = q^T: consecutive i are consecutive
// words, so one 32 B sector serves eight steps of the loop.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
gramschm_k3_opt_kernel(const float* __restrict__ qt, const float* __restrict__ a,
                       float* __restrict__ r, int ni, int nj, int k) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= nj) return;
  const float* qrow = qt + (size_t)k * ni;
  float acc = 0.f;
  for (int i = 0; i < ni; ++i) {
    acc += qrow[i] * a[(size_t)i * nj + j];
  }
  r[j] = acc;
}

}  // namespace

// Plain C entry points for ctypes.
extern "C" {

int repro_gramschm_k3_naive(const void* q, const void* a, void* r, int ni,
                            int nj, int nk, int k, void* stream) {
  const int blocks = (nj + kThreads - 1) / kThreads;
  gramschm_k3_naive_kernel<<<blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(a),
      static_cast<float*>(r), ni, nj, nk, k);
  return static_cast<int>(cudaGetLastError());
}

int repro_gramschm_k3_opt(const void* qt, const void* a, void* r, int ni,
                          int nj, int k, void* stream) {
  const int blocks = (nj + kThreads - 1) / kThreads;
  gramschm_k3_opt_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(qt), static_cast<const float*>(a),
      static_cast<float*>(r), ni, nj, k);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
