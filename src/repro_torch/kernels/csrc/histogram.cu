// The GPUMD cell-count histogram of the CUTHERMO paper (section V, Table I:
// find_cell_counts, the false-sharing and contention case study) for Hopper
// (sm_90a).
//
// All three kernels count int32 cell ids into float32 bins: bin c receives
// one for every id equal to c.  Ids outside [0, n_bins) are dropped, as the
// Pallas kernels' one-hot compare drops them (it finds no bin for them); the
// guard also keeps an id from writing outside the histogram.  Counts are
// integers below 2^24, so float32 holds them exactly and every order of the
// atomic additions gives the same result, bit for bit.  The kernels launch
// on the caller's stream, allocate nothing and do not synchronise; the
// wrapper allocates and zeroes the histogram (and hist_opt's partial rows).
// Each entry point returns cudaGetLastError() right after its launch.
//
// Bound on an H100 SXM: the work reads the N ids once and writes n_bins
// counts once, 4 * (N + n_bins) bytes over 3.35 TB/s (N = 16,777,216 ids,
// 2048 bins: 67 MB, 20 us); one compare and one add per id are negligible.
// What keeps a kernel from that bound is the atomics (naive and opt send
// every id to an atomic in L2, opt2 keeps them in shared memory) and, for
// opt2, how many bytes of ids each SM keeps in flight.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;  // one block per 1024 cells (the Pallas block)

// hist_opt2's grid is at most this many blocks: 2 blocks of 1024 threads on
// each of the 132 SMs, the most threads an SM holds.  The blocks stride over
// the cells, so one flush of the shared histogram serves many cells.
// kernels/histogram.py:OPT2_MAX_BLOCKS is the same number.
constexpr int kOpt2MaxBlocks = 264;
// ids one opt2 thread counts at least (one int4); the grid is
// ceil(N / (kThreads * kOpt2MinIds)) blocks below the cap
constexpr int kOpt2MinIds = 4;

__device__ __forceinline__ bool in_range(int c, int n_bins) {
  return static_cast<unsigned>(c) < static_cast<unsigned>(n_bins);
}

// ---------------------------------------------------------------------------
// naive -- replaces repro/kernels/histogram.py:_hist_naive_kernel.
//
// GPUMD's find_cell_counts: one thread per cell, each adds one straight into
// the single global histogram.  Every warp of the grid scatters into the same
// n_bins words: the contended read-modify-write of the Pallas kernel's shared
// output block, and the false sharing of the paper's story.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
hist_naive_kernel(const int* __restrict__ cells, float* __restrict__ cell_count,
                  int n, int n_bins) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int c = cells[i];
  if (in_range(c, n_bins)) atomicAdd(&cell_count[c], 1.f);
}

// ---------------------------------------------------------------------------
// opt -- replaces repro/kernels/histogram.py:_hist_opt_kernel.
//
// The same mapping, but block b adds into its own row b of partials
// (n_blocks, n_bins): no two blocks share a bin.  The rows are summed
// afterwards by the wrapper (partials.sum(0)), as XLA sums them outside the
// Pallas kernel.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
hist_opt_kernel(const int* __restrict__ cells, float* __restrict__ partials,
                int n, int n_bins) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  const int c = cells[i];
  if (in_range(c, n_bins)) {
    atomicAdd(&partials[static_cast<size_t>(blockIdx.x) * n_bins + c], 1.f);
  }
}

// ---------------------------------------------------------------------------
// opt2 -- replaces repro/kernels/histogram.py:_hist_opt2_kernel.
//
// The Pallas kernel carries one on-chip accumulator across its sequential
// grid and stores it once.  GPU blocks run in parallel, so each block keeps
// a privatized histogram acc[n_bins] of unsigned counters in (dynamic)
// shared memory instead: the block zeroes it, counts its cells into it with
// shared-memory atomics, and flushes it into the global histogram with one
// float atomicAdd per bin (each count converted once; counts below 2^24 are
// exact in float32, so every order of the flushes gives the same bits).
// The ids are read as int4: the vector body is the int4s from the first
// 16-byte-aligned id, thread g of the grid (g = block * 1024 + thread)
// loading int4s g, g + S, g + 2S, ... (S the grid's threads), two at a time
// so that 32 bytes a thread, 64 KB an SM, are in flight.  The up to three
// ids before that boundary (an unaligned slice) and the up to three after
// the last whole int4 are counted one by one, by threads g = 0 .. 5.  Warp w
// zeroes and flushes the contiguous bins [w * chunk, (w + 1) * chunk), chunk
// a multiple of 32, its lanes on consecutive bins, so each flush step is one
// coalesced line.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void count_id(unsigned* acc, int c, int n_bins) {
  if (in_range(c, n_bins)) atomicAdd(&acc[c], 1u);
}

__device__ __forceinline__ void count_int4(unsigned* acc, int4 v, int n_bins) {
  count_id(acc, v.x, n_bins);
  count_id(acc, v.y, n_bins);
  count_id(acc, v.z, n_bins);
  count_id(acc, v.w, n_bins);
}

__global__ void __launch_bounds__(kThreads, 2)
hist_opt2_kernel(const int* __restrict__ cells, float* __restrict__ cell_count,
                 int n, int n_bins, int head) {
  extern __shared__ unsigned acc[];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int chunk = 32 * ((n_bins + kThreads - 1) / kThreads);
  const int lo = warp * chunk;
  const int hi = min(lo + chunk, n_bins);
  for (int b = lo + lane; b < hi; b += 32) acc[b] = 0u;
  __syncthreads();
  const long long nvec = (n - head) / 4;
  const long long tail = head + 4 * nvec;  // first id after the vector body
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const int4* vec = reinterpret_cast<const int4*>(cells + head);
  long long v = g;
  for (; v + stride < nvec; v += 2 * stride) {
    const int4 a = vec[v];
    const int4 b = vec[v + stride];
    count_int4(acc, a, n_bins);
    count_int4(acc, b, n_bins);
  }
  if (v < nvec) count_int4(acc, vec[v], n_bins);
  if (g < head) count_id(acc, cells[g], n_bins);
  if (g >= head && g < head + (n - tail)) count_id(acc, cells[tail + g - head], n_bins);
  __syncthreads();
  for (int b = lo + lane; b < hi; b += 32) {
    atomicAdd(&cell_count[b], static_cast<float>(acc[b]));
  }
}

int blocks_for(int n) {
  return static_cast<int>((static_cast<long long>(n) + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entry points for ctypes.
extern "C" {

int repro_hist_naive(const void* cells, void* cell_count, int n, int n_bins,
                     void* stream) {
  hist_naive_kernel<<<blocks_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cells), static_cast<float*>(cell_count), n, n_bins);
  return static_cast<int>(cudaGetLastError());
}

int repro_hist_opt(const void* cells, void* partials, int n, int n_bins,
                   void* stream) {
  hist_opt_kernel<<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cells), static_cast<float*>(partials), n, n_bins);
  return static_cast<int>(cudaGetLastError());
}

// n_bins * 4 bytes of dynamic shared memory: the wrapper keeps it within the
// 48 KB a block gets without opting in (n_bins <= 12288).
int repro_hist_opt2(const void* cells, void* cell_count, int n, int n_bins,
                    void* stream) {
  const long long want = (static_cast<long long>(n) + kThreads * kOpt2MinIds - 1) /
                         (kThreads * kOpt2MinIds);
  const int blocks = static_cast<int>(want < kOpt2MaxBlocks ? want : kOpt2MaxBlocks);
  // ids before the first 16-byte boundary (int32 ids are 4-byte aligned)
  const int skew = static_cast<int>((16 - reinterpret_cast<uintptr_t>(cells) % 16) % 16) / 4;
  const int head = skew < n ? skew : n;
  hist_opt2_kernel<<<blocks, kThreads, sizeof(unsigned) * n_bins,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cells), static_cast<float*>(cell_count), n, n_bins, head);
  return static_cast<int>(cudaGetLastError());
}

int repro_hist_opt2_max_blocks() { return kOpt2MaxBlocks; }

}  // extern "C"
