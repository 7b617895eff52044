// GRAMSCHM kernel3 of the CUTHERMO paper (section VI-B, the strided case
// study) for Hopper (sm_90a).
//
// Both routes compute r[j] = sum_i q[i, k] * a[i, j] for row-major float32
// q (NI, NK) -- or its transpose qt (NK, NI) -- and a (NI, NJ), with float32
// accumulation and r (NJ,) in float32.  Only r is computed, as in the Pallas
// kernels: the PolyBench update of a and its j > k guard are not part of
// them.  The kernels launch on the caller's stream, allocate nothing and do
// not synchronise; each entry point returns cudaGetLastError() right after
// its launches.
//
// Bound on an H100 SXM: the work reads a once (NI * NJ words), one column of
// q (NI words) and writes r (NJ words); 2 * NI * NJ FLOPs are negligible, so
// device-memory bytes over 3.35 TB/s bound it (512^3: 1.06 MB, 0.32 us;
// 4096^3: 67 MB, 20 us).
//
// naive keeps PolyBench/GPU's gramschmidt_kernel3 mapping, the paper's
// rung: one thread per column j in 1-D blocks of 256, a sequential loop
// over i, r[j] stored once.  At NJ = 4096 that is 16 blocks on 132 SMs,
// each thread a chain of 4096 dependent loads: latency-bound, far from the
// bound, and kept literal for the profiler.
//
// opt reads row k of qt (the transpose fix) and spreads the i loop over the
// card: a split-i reduction in two kernels.
//   1. gramschm_k3_opt_kernel: (column strips of 128) x (i-slices of 8 *
//      RPW rows) blocks of 8 warps, on a 1-D grid with the strips fastest
//      (grid x takes 2^31 - 1 blocks, so no shape runs out of grid).  Lane l of a warp owns columns
//      4l .. 4l+3 of its strip and warp w rows w*RPW .. (w+1)*RPW - 1 of its
//      slice: each step is one 16-byte load a lane (a 512-byte row segment a
//      warp), eight rows in flight at a time.  Lane l loads word row0 + l of
//      row k of qt once (the warp's RPW contiguous words), and each step
//      takes its word by __shfl_sync.  The warps' float4 sums meet in shared
//      memory (8 x 32 float4, 4 KB); warp 0 adds them in warp order and
//      stores the block's 128 partial sums to row `slice` of partials
//      (slices, NJ), float32 scratch that the caller allocates.
//   2. gramschm_k3_sum_kernel: one thread per column adds its column of
//      partials in slice order and stores r[j].
// RPW (8, 16, 24 or 32), and so the slices, depend only on (NI, NJ)
// (kernels/gramschm.py:opt_split): at 4096^3 32 strips x 32 slices = 1024
// blocks, ~8 on each SM; at 512^3 4 x 8.  Both sums run in a fixed order,
// so a repeated call gives the same bits.  Rows that are not 16-byte
// aligned (NJ % 4 != 0, or a base off 16 bytes) and the columns past NJ go
// through scalar loads and stores by the same threads.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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
// opt -- replaces repro/kernels/gramschm.py:_k3_opt_kernel (the transpose
// fix), split over i-slices.
// ---------------------------------------------------------------------------
constexpr int kOptWarps = 8;
constexpr int kOptThreads = 32 * kOptWarps;
constexpr int kOptStrip = 128;   // columns a block covers: a float4 a lane
constexpr int kOptInFlight = 8;  // rows whose loads a warp issues at once

__device__ __forceinline__ void fma4(float4& acc, float q, const float4& x) {
  acc.x = fmaf(q, x.x, acc.x);
  acc.y = fmaf(q, x.y, acc.y);
  acc.z = fmaf(q, x.z, acc.z);
  acc.w = fmaf(q, x.w, acc.w);
}

__global__ void __launch_bounds__(kOptThreads)
gramschm_k3_opt_kernel(const float* __restrict__ qt, const float* __restrict__ a,
                       float* __restrict__ partials, int ni, int nj, int k, int rpw,
                       int vec) {
  __shared__ float4 red[kOptWarps][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // a 1-D grid, strips fastest: block (strip, slice) is strip + strips * slice
  const int strips = (nj + kOptStrip - 1) / kOptStrip;
  const int slice = blockIdx.x / strips;
  const int col = (blockIdx.x % strips) * kOptStrip + 4 * lane;
  const long long row0 = ((long long)slice * kOptWarps + warp) * rpw;
  const int nrows = static_cast<int>(max(0LL, min((long long)rpw, ni - row0)));
  // this warp's words of row k of qt, one a lane
  const float qv = lane < nrows ? qt[(size_t)k * ni + row0 + lane] : 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float* arow = a + (size_t)row0 * nj + col;
  if (vec && col < nj) {
    const float4* ap = reinterpret_cast<const float4*>(arow);
    const size_t step = nj / 4;
    int r = 0;
    for (; r + kOptInFlight <= nrows; r += kOptInFlight) {
      float4 x[kOptInFlight];
#pragma unroll
      for (int u = 0; u < kOptInFlight; ++u) x[u] = __ldcs(ap + (r + u) * step);
#pragma unroll
      for (int u = 0; u < kOptInFlight; ++u) {
        fma4(acc, __shfl_sync(0xffffffffu, qv, r + u), x[u]);
      }
    }
    for (; r < nrows; ++r) {
      fma4(acc, __shfl_sync(0xffffffffu, qv, r), __ldcs(ap + r * step));
    }
  } else {
    float e[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < nrows; ++r) {
      const float qq = __shfl_sync(0xffffffffu, qv, r);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (col + c < nj) e[c] = fmaf(qq, arow[(size_t)r * nj + c], e[c]);
      }
    }
    acc = make_float4(e[0], e[1], e[2], e[3]);
  }
  red[warp][lane] = acc;
  __syncthreads();
  if (warp != 0) return;
  float4 s = red[0][lane];
#pragma unroll
  for (int w = 1; w < kOptWarps; ++w) {
    const float4 t = red[w][lane];
    s.x += t.x;
    s.y += t.y;
    s.z += t.z;
    s.w += t.w;
  }
  float* prow = partials + (size_t)slice * nj + col;
  if (vec && col < nj) {
    *reinterpret_cast<float4*>(prow) = s;
  } else {
    const float e[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (col + c < nj) prow[c] = e[c];
    }
  }
}

// r[j] = the sum of column j of partials, in slice order
__global__ void __launch_bounds__(kThreads)
gramschm_k3_sum_kernel(const float* __restrict__ partials, float* __restrict__ r,
                       int nj, int slices) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= nj) return;
  float acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < slices; ++s) acc += partials[(size_t)s * nj + j];
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

// partials: (slices, NJ) float32 scratch from the caller, slices =
// ceil(NI / (8 * rpw)); rpw is 8, 16, 24 or 32 (the wrapper checks both).
int repro_gramschm_k3_opt(const void* qt, const void* a, void* partials, void* r,
                          int ni, int nj, int k, int rpw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int slices = static_cast<int>(((long long)ni + kOptWarps * rpw - 1) / (kOptWarps * rpw));
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(partials);
  const int vec = nj % 4 == 0 && bits % 16 == 0;
  const long long blocks = (long long)((nj + kOptStrip - 1) / kOptStrip) * slices;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  gramschm_k3_opt_kernel<<<static_cast<unsigned>(blocks), kOptThreads, 0, st>>>(
      static_cast<const float*>(qt), static_cast<const float*>(a),
      static_cast<float*>(partials), ni, nj, k, rpw, vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gramschm_k3_sum_kernel<<<(nj + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(r), nj, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
