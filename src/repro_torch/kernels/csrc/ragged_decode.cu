// Ragged MQA decode attention for Hopper (sm_90a), split over the KV axis
// (flash-decoding).
//
// Replaces repro/kernels/ragged_flash.py:_ragged_decode_kernel
// (ragged_decode_attention).  For q (B, H, D), one query per sequence, and
// one KV head k, v (B, S, D) shared by all H query heads, it computes
//   O[b, h] = softmax(scale * q[b, h] . K[b, p]) . V[b, p]
// over the positions p in [starts[b], ends[b]) (clamped to [0, S)), with
// scale = 1/sqrt(D), float32 scores and sums, and O in the input type
// (float32 or bfloat16).  A sequence with no live position gets O = 0 (the
// Pallas kernel's answer there depends on its tile width; see
// kernels/ragged_flash.py).  The kernels launch on the caller's stream,
// allocate nothing and do not synchronise; the entry point returns
// cudaGetLastError() right after its launches.
//
// Design (the block step and the combine are in split_decode.cuh, which
// says who reads what): each sequence's positions are cut into splits of L
// positions (L a multiple of the tile width BKV that depends only on S and
// BKV, at most 32 splits a sequence: kernels/ragged_flash.py:split_len), and
// (splits, B) blocks, on a 1-D grid with the splits fastest (grid x takes
// 2^31 - 1 blocks, so any B fits), each walk one split with all H heads, so
// each staged K and V row is read from device memory once for all heads
// (the point of MQA).  Gated (the Pallas kernel's pl.when gate): a split
// with no position in [start, end) exits, and a block stages only the live
// rows.  With dense = 1 every block reads every row of its split, which
// gives the same bits; it is the registry's baseline rung.  Each block
// stores its softmax state to a record of the caller's float32 workspace
// (B, splits, H (D + 2)); then split_combine_kernel, (ceil(H D / 4T), B)
// blocks of the route's T threads (1-D as well), merges the live records of each
// sequence in split order and writes O.  Two device kernels a call.
// float32 runs on the CUDA cores (SplitF32<ceil(H/8)>: 8 warps, chunks of 32 rows),
// bfloat16 on the tensor cores (SplitTc: 4 warps, the heads as the M of
// mma.sync m16n8k16, chunks of 64 rows); both stage K and V in their own
// type with 16-byte cp.async through a two-stage ring.
//
// Bound on an H100 SXM at Granite-20B's decode widths (B, H, D) = (64, 48,
// 128) with ~2,600 live positions a sequence: bfloat16 moves ~85 MB of live
// K and V (25 us at 3.35 TB/s) for 4.3 GFLOP, so the bytes bound it;
// float32 moves twice the bytes and its 4.3 GFLOP on the CUDA cores (67
// TFLOP/s) take 61 us, so the arithmetic bounds it.  At S = 8192 and BKV =
// 128, L = 256: the longest walk is 4 chunks of 64 (or 8 of 32), not 32
// tiles, and 707 live blocks share the 132 SMs.
//
// Shared memory: float32 (8 ceil(H/8) ld + 128 ld + 2048) floats with ld =
// 4 (ceil(D/4) | 1), 109 KB at H = 64, D = 128; bfloat16 (16 ceil(H/16) + 256)
// DP bf16, 76 KB at H = 48, D = 128.  Above the 48 KB a block gets by
// default, so the launch opts in with cudaFuncSetAttribute first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "split_decode.cuh"

namespace {

template <int NHW>
__global__ void __launch_bounds__(kSplitF32Threads)
ragged_split_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ starts,
                        const int* __restrict__ ends, float* __restrict__ ws, int h, int s,
                        int d, int len, int dense, float scale_log2, int vec) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  // a 1-D grid, splits fastest: block (g, b) is g + n_splits b
  const int n_splits = (s + len - 1) / len;
  const int g = blockIdx.x % n_splits;
  const int b = blockIdx.x / n_splits;
  const SplitWalk walk(starts[b], ends[b], s, g, len, SplitF32<NHW>::kChunk, dense != 0);
  if (!dense && !walk.live) return;
  SplitF32<NHW> step(f32_smem, h, d, scale_log2);
  const int rec_len = h * (d + 2);
  const ContiguousRows<float> rows{k + (size_t)b * s * d, v + (size_t)b * s * d, d};
  run_split(step, walk, q + (size_t)b * h * d, rows, dense != 0, vec != 0,
            ws + (size_t)blockIdx.x * rec_len, rec_len);
}

template <int DP>
__global__ void __launch_bounds__(kSplitTcThreads)
ragged_split_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ starts,
                       const int* __restrict__ ends, float* __restrict__ ws, int h, int s,
                       int d, int len, int dense, float scale_log2, int vec) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // a 1-D grid, splits fastest: block (g, b) is g + n_splits b
  const int n_splits = (s + len - 1) / len;
  const int g = blockIdx.x % n_splits;
  const int b = blockIdx.x / n_splits;
  const SplitWalk walk(starts[b], ends[b], s, g, len, SplitTc<DP>::kChunk, dense != 0);
  if (!dense && !walk.live) return;
  SplitTc<DP> step(tc_smem, h, d, scale_log2);
  const int rec_len = h * (d + 2);
  const ContiguousRows<__nv_bfloat16> rows{k + (size_t)b * s * d, v + (size_t)b * s * d, d};
  run_split(step, walk, q + (size_t)b * h * d, rows, dense != 0, vec != 0,
            ws + (size_t)blockIdx.x * rec_len, rec_len);
}

template <typename K>
int opt_in(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, int THREADS>
int combine(const void* ws, const int* starts, const int* ends, void* o, int b, int h, int s,
            int d, int len, int n_splits, cudaStream_t st) {
  const long long blocks = (long long)((h * d + 4 * THREADS - 1) / (4 * THREADS)) * b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  split_combine_kernel<T, THREADS><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      static_cast<const float*>(ws), starts, ends, static_cast<T*>(o), h, s, d, len, n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <int NHW>
int launch_f32(const void* q, const void* k, const void* v, const int* starts, const int* ends,
               void* ws, int h, int s, int d, int len, int dense, float scale_log2, int vec,
               const dim3& grid, cudaStream_t st) {
  const size_t smem = split_f32_smem_bytes(h, d);
  const int err = opt_in(ragged_split_f32_kernel<NHW>, smem);
  if (err != 0) return err;
  ragged_split_f32_kernel<NHW><<<grid, kSplitF32Threads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      starts, ends, static_cast<float*>(ws), h, s, d, len, dense, scale_log2, vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, const int* starts,
                 const int* ends, void* ws, int h, int s, int d, int len, int dense,
                 float scale_log2, int vec, const dim3& grid, cudaStream_t st) {
  switch ((h + kSplitF32Warps - 1) / kSplitF32Warps) {
    case 1: return launch_f32<1>(q, k, v, starts, ends, ws, h, s, d, len, dense, scale_log2, vec, grid, st);
    case 2: return launch_f32<2>(q, k, v, starts, ends, ws, h, s, d, len, dense, scale_log2, vec, grid, st);
    case 3: return launch_f32<3>(q, k, v, starts, ends, ws, h, s, d, len, dense, scale_log2, vec, grid, st);
    case 4: return launch_f32<4>(q, k, v, starts, ends, ws, h, s, d, len, dense, scale_log2, vec, grid, st);
    case 5: return launch_f32<5>(q, k, v, starts, ends, ws, h, s, d, len, dense, scale_log2, vec, grid, st);
    case 6: return launch_f32<6>(q, k, v, starts, ends, ws, h, s, d, len, dense, scale_log2, vec, grid, st);
    case 7: return launch_f32<7>(q, k, v, starts, ends, ws, h, s, d, len, dense, scale_log2, vec, grid, st);
    case 8: return launch_f32<8>(q, k, v, starts, ends, ws, h, s, d, len, dense, scale_log2, vec, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, const int* starts, const int* ends,
              void* ws, int b, int h, int s, int d, int len, int dense, float scale_log2,
              int vec, const dim3& grid, cudaStream_t st) {
  const size_t smem = split_tc_smem_bytes(h, DP);
  const int err = opt_in(ragged_split_tc_kernel<DP>, smem);
  if (err != 0) return err;
  ragged_split_tc_kernel<DP><<<grid, kSplitTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), starts, ends, static_cast<float*>(ws), h, s, d,
      len, dense, scale_log2, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16; ws is
// (B, ceil(S / len), H (D + 2)) float32 from the caller, with at most 32
// splits a sequence; h at most 64 and d at most 128 (the wrapper checks all).
extern "C" {

int repro_ragged_decode(const void* q, const void* k, const void* v, const void* starts,
                        const void* ends, void* ws, void* o, int b, int h, int s, int d,
                        int len, int dense, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(starts);
  const int* ep = static_cast<const int*>(ends);
  const int n_splits = (s + len - 1) / len;
  if (n_splits > kSplitMaxSplits || h > kSplitMaxHeads || d > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (long long)n_splits * b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(blocks));
  const float scale_log2 = kSplitLog2e / sqrtf(static_cast<float>(d));
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  int err = 0;
  if (dtype == 0) {
    const int vec = d % 4 == 0 && bits % 16 == 0;
    err = dispatch_f32(q, k, v, sp, ep, ws, h, s, d, len, dense, scale_log2, vec, grid, st);
    if (err != 0) return err;
    return combine<float, kSplitF32Threads>(ws, sp, ep, o, b, h, s, d, len, n_splits, st);
  }
  const int vec = d % 8 == 0 && bits % 16 == 0;
  if (d <= 16) {
    err = launch_tc<16>(q, k, v, sp, ep, ws, b, h, s, d, len, dense, scale_log2, vec, grid, st);
  } else if (d <= 32) {
    err = launch_tc<32>(q, k, v, sp, ep, ws, b, h, s, d, len, dense, scale_log2, vec, grid, st);
  } else if (d <= 64) {
    err = launch_tc<64>(q, k, v, sp, ep, ws, b, h, s, d, len, dense, scale_log2, vec, grid, st);
  } else {
    err = launch_tc<128>(q, k, v, sp, ep, ws, b, h, s, d, len, dense, scale_log2, vec, grid, st);
  }
  if (err != 0) return err;
  return combine<__nv_bfloat16, kSplitTcThreads>(ws, sp, ep, o, b, h, s, d, len, n_splits, st);
}

}  // extern "C"
