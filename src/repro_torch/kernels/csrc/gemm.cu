// GEMM ladder of the CUTHERMO paper (section VI-A) for Hopper (sm_90a).
//
// Every kernel computes C = A * B for row-major A (M, K) and B (K, N), with
// float32 or bfloat16 inputs, float32 accumulation, and C in the input type.
// Shapes need not be multiples of the tile sizes: every kernel masks the
// ragged edge itself.  The kernels launch on the caller's stream, allocate
// nothing and do not synchronise; each entry point returns
// cudaGetLastError() right after its launch, so a refused launch surfaces in
// the Python wrapper.
//
// Bound on an H100 SXM (1024^3): 2*M*N*K = 2.15 GFLOP on the CUDA cores'
// float32 FMA rate (67 TFLOP/s) is about 32 us, against 12.6 MB of device
// memory traffic (about 3.8 us at 3.35 TB/s), so the float32 arithmetic is
// the bound.  None of these kernels uses the tensor cores: v00 and v01 are
// the paper's deliberately naive rungs, v02 the first tiled one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// v00 -- replaces repro/kernels/gemm.py:_gemm_v00_kernel (row per program).
//
// The paper's naive kernel: one thread per element of C, and a warp's 32
// lanes sit on 32 consecutive ROWS of one column (threadIdx.x -> row).  So
// each load of A is 32 different rows (32 sectors per request), B is a
// broadcast of one word, and every 32 B sector of C is written by 8
// different warps (the 8 columns of the sector live in 8 warps): the false
// sharing on C the profiler shows.  Bound: the uncoalesced A traffic, far
// above the arithmetic bound; this rung exists to be diagnosed, not tuned.
// Block (32, 8): warp w of block (bx, by) owns rows 32*bx .. 32*bx+31 of
// column 8*by + w.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
gemm_v00_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ c, int m, int n, int k) {
  const int row = blockIdx.x * 32 + threadIdx.x;
  const int col = blockIdx.y * 8 + threadIdx.y;
  if (row >= m || col >= n) return;
  float acc = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    acc += to_float(a[(size_t)row * k + kk]) * to_float(b[(size_t)kk * n + col]);
  }
  c[(size_t)row * n + col] = from_float<T>(acc);
}

// ---------------------------------------------------------------------------
// v01 -- replaces repro/kernels/gemm.py:_gemm_v01_kernel (the re-tile fix).
//
// The paper's coalescing fix: swap the thread indices, so a warp's lanes
// cover 32 consecutive COLUMNS of one row (threadIdx.x -> column).  B and C
// accesses are now whole sectors per warp, A is a broadcast, and each C
// sector is written by one warp.  Bound: still every warp re-reads all of
// its B column strip from L2 / device memory (no on-chip reuse), so it sits
// well above the arithmetic bound.  Block (32, 8): warp w of block (bx, by)
// owns columns 32*bx .. 32*bx+31 of row 8*by + w.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
gemm_v01_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ c, int m, int n, int k) {
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int row = blockIdx.y * 8 + threadIdx.y;
  if (row >= m || col >= n) return;
  float acc = 0.f;
  for (int kk = 0; kk < k; ++kk) {
    acc += to_float(a[(size_t)row * k + kk]) * to_float(b[(size_t)kk * n + col]);
  }
  c[(size_t)row * n + col] = from_float<T>(acc);
}

// ---------------------------------------------------------------------------
// v02 -- replaces repro/kernels/gemm.py:_gemm_v02_kernel (blocked, VMEM acc).
//
// Shared-memory tiled GEMM.  A block of 256 threads (8 warps) owns a 64x64
// tile of C.  For each step of BK = 16 along K it stages the (64, 16) tile of
// A and the (16, 64) tile of B in shared memory, then every thread updates a
// 4x4 micro-tile of C held in registers.  The loop over K inside the block
// replaces the TPU kernel's sequential K grid axis, and the registers
// replace its VMEM accumulator: blocks run in parallel and in no order on
// the 132 SMs, so nothing may carry over between them.
//
// Who touches what (the profiler spec gemm_v02_spec mirrors this): warp w
// loads rows 8w .. 8w+7 of every A tile and columns 8w .. 8w+7 of every B
// tile; for the product the warps form a 2 x 4 grid, warp w = 4*wr + wc
// reading A rows 32*wr .. +31 and B columns 16*wc .. +15 from shared memory
// and owning that 32x16 piece of C.  Bound: the float32 FMA rate; each
// element staged in shared memory is reused 64 times per block, which takes
// the device-memory traffic far below the arithmetic bound.  wgmma and TMA
// are later work.
// ---------------------------------------------------------------------------
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;

template <typename T>
__global__ void __launch_bounds__(256)
gemm_v02_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ c, int m, int n, int k) {
  __shared__ float as[kBM][kBK + 1];  // +1: no bank conflicts on column reads
  __shared__ float bs[kBK][kBN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  // this thread's 4x4 micro-tile inside the block tile
  const int tr = 32 * (warp / 4) + 4 * (lane / 4);
  const int tc = 16 * (warp % 4) + 4 * (lane % 4);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int r = 8 * warp + 2 * s + lane / 16;
      const int cc = lane % 16;
      const int gr = row0 + r;
      const int gc = k0 + cc;
      as[r][cc] = (gr < m && gc < k) ? to_float(a[(size_t)gr * k + gc]) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int r = 4 * s + lane / 8;
      const int cc = 8 * warp + lane % 8;
      const int gr = k0 + r;
      const int gc = col0 + cc;
      bs[r][cc] = (gr < k && gc < n) ? to_float(b[(size_t)gr * n + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[tr + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tc + j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + tr + i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tc + j;
      if (gc < n) c[(size_t)gr * n + gc] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch(int variant, const void* a, const void* b, void* c, int m, int n,
           int k, cudaStream_t stream) {
  const T* pa = static_cast<const T*>(a);
  const T* pb = static_cast<const T*>(b);
  T* pc = static_cast<T*>(c);
  if (variant == 0) {
    dim3 grid((m + 31) / 32, (n + 7) / 8);
    gemm_v00_kernel<T><<<grid, dim3(32, 8), 0, stream>>>(pa, pb, pc, m, n, k);
  } else if (variant == 1) {
    dim3 grid((n + 31) / 32, (m + 7) / 8);
    gemm_v01_kernel<T><<<grid, dim3(32, 8), 0, stream>>>(pa, pb, pc, m, n, k);
  } else {
    dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
    gemm_v02_kernel<T><<<grid, 256, 0, stream>>>(pa, pb, pc, m, n, k);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(int variant, const void* a, const void* b, void* c, int m, int n,
             int k, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(variant, a, b, c, m, n, k, s);
  return launch<__nv_bfloat16>(variant, a, b, c, m, n, k, s);
}

}  // namespace

// Plain C entry points for ctypes.  dtype: 0 = float32, 1 = bfloat16.
extern "C" {

int repro_gemm_v00(const void* a, const void* b, void* c, int m, int n, int k,
                   int dtype, void* stream) {
  return dispatch(0, a, b, c, m, n, k, dtype, stream);
}

int repro_gemm_v01(const void* a, const void* b, void* c, int m, int n, int k,
                   int dtype, void* stream) {
  return dispatch(1, a, b, c, m, n, k, dtype, stream);
}

int repro_gemm_v02(const void* a, const void* b, void* c, int m, int n, int k,
                   int dtype, void* stream) {
  return dispatch(2, a, b, c, m, n, k, dtype, stream);
}

}  // extern "C"
