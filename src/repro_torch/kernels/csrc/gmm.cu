// Grouped matmul (the MoE expert FFN) for Hopper (sm_90a).
//
// Replaces repro/kernels/gmm.py:_gmm_kernel (gmm).  The rows of x (M, K)
// are grouped by expert and each group is padded to a multiple of bm rows
// (kernels/gmm.py:plan_groups); tile_expert_ids[i] names the expert whose
// weights w[e] (K, N) multiply the bm-row tile i:
//     O[i*bm : (i+1)*bm] = X[i*bm : (i+1)*bm] . W[tile_expert_ids[i]]
// with float32 or bfloat16 inputs, float32 accumulation and O in the input
// type.  M is a multiple of bm, and bm of 32 (the wrapper checks both).  An
// id outside [0, E) reads no weights: its rows of O are zero.  The kernel
// launches on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns cudaGetLastError() right after its
// launch.
//
// Design.  The Pallas kernel prefetches the ids as scalars so that the W
// BlockSpec's index map can pick the expert of each tile.  Here each block
// reads its own id: a block owns a BM x 64 tile of O, with BM = 64 rows (8
// warps) when bm is a multiple of 64 and BM = 32 (4 warps) otherwise, so
// its rows lie in one bm-row tile and belong to one expert.  It walks K in
// steps of 16, staging the (BM, 16) tile of X and the (16, 64) tile of
// W[e] in shared memory, and every thread updates a 4 x 4 micro-tile of O
// held in registers.  A 64-row block reads W[e] once for 64 rows, so wider
// expert tiles halve the weight traffic, as they do on the TPU.  Who reads
// what: warp w stages rows 8w .. 8w+7 of every X tile and columns
// 64/W*w .. 64/W*(w+1) - 1 (W warps) of every W tile, and stores rows
// 8w .. 8w+7 of the O tile (kernels/gmm.py:gmm_spec).
//
// Bound on an H100 SXM at M = 4096, K = 4096, N = 14336 over 16 experts:
// 2 M K N = 481 GFLOP take 7.2 ms at the CUDA cores' float32 rate (67
// TFLOP/s) and 0.49 ms at the tensor cores' bf16 rate (989 TFLOP/s), while
// the experts' weights alone are 3.76 GB in float32 (1.12 ms at 3.35 TB/s):
// the float32 arithmetic bounds it.  This first kernel runs both types on
// the CUDA cores; each staged element of W is reused by the block's 32 or
// 64 rows and each of X by its 64 columns.  wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kBN = 64;
constexpr int kBK = 16;

template <typename T, int BM>
__global__ void __launch_bounds__(BM * 4)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           const int* __restrict__ ids, T* __restrict__ o, int k, int n,
           int e, int bm) {
  constexpr int kWarps = BM / 8;        // each warp: 8 rows of the tile
  constexpr int kWCols = kBN / kWarps;  // W tile columns each warp stages
  constexpr int kWRows = 32 / kWCols;   // W tile rows per staging step
  __shared__ float xs[BM][kBK + 1];  // +1: no bank conflicts on column reads
  __shared__ float ws[kBK][kBN];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * kBN;
  const int expert = ids[row0 / bm];
  // this thread's 4x4 micro-tile: rows 4*ty .., columns 4*tx ..
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  if (expert >= 0 && expert < e) {
    const T* we = w + (size_t)expert * k * n;
    for (int k0 = 0; k0 < k; k0 += kBK) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int r = 8 * warp + 2 * s + lane / 16;
        const int cc = lane % 16;
        const int gc = k0 + cc;
        xs[r][cc] = gc < k ? to_float(x[(size_t)(row0 + r) * k + gc]) : 0.f;
      }
#pragma unroll
      for (int s = 0; s < kBK / kWRows; ++s) {
        const int r = kWRows * s + lane / kWCols;
        const int cc = kWCols * warp + lane % kWCols;
        const int gr = k0 + r;
        const int gc = col0 + cc;
        ws[r][cc] = (gr < k && gc < n) ? to_float(we[(size_t)gr * n + gc]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = xs[4 * ty + i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = ws[kk][4 * tx + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const size_t gr = row0 + 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + 4 * tx + j;
      if (gc < n) o[gr * n + gc] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM>
int launch(const void* x, const void* w, const void* ids, void* o, int m,
           int k, int n, int e, int bm, cudaStream_t stream) {
  dim3 grid((n + kBN - 1) / kBN, m / BM);
  gmm_kernel<T, BM><<<grid, BM * 4, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(ids), static_cast<T*>(o), k, n, e, bm);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, const void* ids, void* o, int m,
             int k, int n, int e, int bm, cudaStream_t s) {
  if (bm % 64 == 0) return launch<T, 64>(x, w, ids, o, m, k, n, e, bm, s);
  return launch<T, 32>(x, w, ids, o, m, k, n, e, bm, s);
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16; ids
// are int32 on the device, one per bm-row tile.
extern "C" {

int repro_gmm(const void* x, const void* w, const void* ids, void* o, int m,
              int k, int n, int e, int bm, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(x, w, ids, o, m, k, n, e, bm, s);
  return dispatch<__nv_bfloat16>(x, w, ids, o, m, k, n, e, bm, s);
}

}  // extern "C"
