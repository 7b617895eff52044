// Paged-KV MQA decode attention for Hopper (sm_90a), split over the KV axis
// (flash-decoding).
//
// Replaces repro/kernels/paged_attn.py:_paged_decode_kernel
// (paged_decode_attention).  The KV cache is a pool of pages, k_pages and
// v_pages (1, P, page, D), one KV head shared by all H query heads;
// sequence b's logical slot j lives in physical page block_tables[b, j],
// and its first context_lens[b] positions (clamped to [0, slots * page])
// are live.  For q (B, H, D) it computes
//   O[b, h] = softmax(scale * q[b, h] . K[b, p]) . V[b, p], p < context_lens[b]
// with scale = 1/sqrt(D), float32 scores and sums, the probabilities
// rounded to the input type before P V, and O in the input type (float32 or
// bfloat16).  A sequence with no live position gets O = 0, as the Pallas
// kernel gives; a slot whose page id lies outside [0, P) adds nothing.  The
// kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the entry point returns cudaGetLastError() right after its
// launches.
//
// Design: the split step of split_decode.cuh, as ragged_decode.cu uses it,
// with the rows read through the block table (PagedRows).  Sequence b's
// logical positions [0, slots * page) are cut into splits of L positions at
// absolute places, L a multiple of the page with at most 32 splits a
// sequence (kernels/ragged_flash.py:split_len(slots * page, page)), and
// (splits, B) blocks on a 1-D grid, splits fastest, each walk one split with
// all H heads, so each staged K and V row is read once for all heads (the
// point of MQA).  A block walks its split in chunks of CH rows (32 in
// float32, 64 in bfloat16) at absolute places, whatever the page: a chunk
// may span pages, or lie inside one, and each row finds its page in the
// table (pages of 1 to 128 rows all work).  A row whose page id is outside
// [0, P) is not staged and its key is masked (p = 0), so it adds nothing;
// a split whose rows are all in such pages stores m = -1e30, l = 0, acc = 0
// and weighs nothing in the combine.  Gated (the Pallas kernel's
// pl.when(j * page < ctx)): a split with no position below
// context_lens[b] exits after reading the length, and a block stages only
// the live rows.  With dense = 1 every block stages every row of its split,
// which gives the same bits; it is the registry's baseline rung, run on a
// contiguous per-row cache viewed as pages under the identity table b *
// slots + j.  Each block stores its softmax state to a record of the
// caller's float32 workspace (B, splits, H (D + 2)); then
// split_combine_kernel (a null `starts`: the live range is [0, ctx)) merges
// the live records of each sequence in split order and writes O.  Two
// device kernels a call.  float32 runs on the CUDA cores (SplitF32), bfloat16
// on the tensor cores (SplitTc: the heads as the M of mma.sync m16n8k16);
// both stage K and V with 16-byte cp.async through a two-stage ring.
//
// Bound on an H100 SXM at Granite-20B's decode widths (B, H, D) = (64, 48,
// 128), pages of 64 in 128 slots, 124,638 live positions: bfloat16 moves
// 64 MB of live K and V (19.5 us at 3.35 TB/s) for 3.1 GFLOP, so the bytes
// bound it; float32 moves twice the bytes, and its 3.1 GFLOP on the CUDA
// cores (67 TFLOP/s) take 46 us, so the arithmetic bounds it.  L = 256
// there: 32 splits a sequence, 4 chunks of 64 (or 8 of 32) a split.
//
// Shared memory: as ragged_decode.cu, (8 ceil(H/8) ld + 128 ld + 2048)
// floats with ld = 4 (ceil(D/4) | 1) in float32, (16 ceil(H/16) + 256) DP
// bf16 in bfloat16; above the 48 KB a block gets by default, so the launch
// opts in with cudaFuncSetAttribute first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"
#include "split_decode.cuh"

namespace {

template <int NHW>
__global__ void __launch_bounds__(kSplitF32Threads)
paged_split_f32_kernel(const float* __restrict__ q, const float* __restrict__ kp,
                       const float* __restrict__ vp, const int* __restrict__ tables,
                       const int* __restrict__ lens, float* __restrict__ ws, int h, int d,
                       int n_pages, int page, int slots, int len, int dense, float scale_log2,
                       int vec) {
  extern __shared__ __align__(16) unsigned char f32_smem[];
  // a 1-D grid, splits fastest: block (g, b) is g + n_splits b
  const int s = slots * page;
  const int n_splits = (s + len - 1) / len;
  const int g = blockIdx.x % n_splits;
  const int b = blockIdx.x / n_splits;
  const SplitWalk walk(0, lens[b], s, g, len, SplitF32<NHW>::kChunk, dense != 0);
  if (!dense && !walk.live) return;
  SplitF32<NHW> step(f32_smem, h, d, scale_log2);
  const PagedRows<float> rows{kp, vp, tables + (size_t)b * slots, d, page, n_pages};
  const int rec_len = h * (d + 2);
  run_split(step, walk, q + (size_t)b * h * d, rows, dense != 0, vec != 0,
            ws + (size_t)blockIdx.x * rec_len, rec_len);
}

template <int DP>
__global__ void __launch_bounds__(kSplitTcThreads)
paged_split_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
                      const __nv_bfloat16* __restrict__ vp, const int* __restrict__ tables,
                      const int* __restrict__ lens, float* __restrict__ ws, int h, int d,
                      int n_pages, int page, int slots, int len, int dense, float scale_log2,
                      int vec) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  // a 1-D grid, splits fastest: block (g, b) is g + n_splits b
  const int s = slots * page;
  const int n_splits = (s + len - 1) / len;
  const int g = blockIdx.x % n_splits;
  const int b = blockIdx.x / n_splits;
  const SplitWalk walk(0, lens[b], s, g, len, SplitTc<DP>::kChunk, dense != 0);
  if (!dense && !walk.live) return;
  SplitTc<DP> step(tc_smem, h, d, scale_log2);
  const PagedRows<__nv_bfloat16> rows{kp, vp, tables + (size_t)b * slots, d, page, n_pages};
  const int rec_len = h * (d + 2);
  run_split(step, walk, q + (size_t)b * h * d, rows, dense != 0, vec != 0,
            ws + (size_t)blockIdx.x * rec_len, rec_len);
}

template <typename K>
int opt_in(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// the arguments both split kernels take after q, k, v
struct Args {
  const int* tables;
  const int* lens;
  float* ws;
  int h, d, n_pages, page, slots, len, dense;
  float scale_log2;
  int vec;
};

template <int NHW>
int launch_f32(const void* q, const void* k, const void* v, const Args& a, unsigned blocks,
               cudaStream_t st) {
  const size_t smem = split_f32_smem_bytes(a.h, a.d);
  const int err = opt_in(paged_split_f32_kernel<NHW>, smem);
  if (err != 0) return err;
  paged_split_f32_kernel<NHW><<<blocks, kSplitF32Threads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      a.tables, a.lens, a.ws, a.h, a.d, a.n_pages, a.page, a.slots, a.len, a.dense,
      a.scale_log2, a.vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_f32(const void* q, const void* k, const void* v, const Args& a, unsigned blocks,
                 cudaStream_t st) {
  switch ((a.h + kSplitF32Warps - 1) / kSplitF32Warps) {
    case 1: return launch_f32<1>(q, k, v, a, blocks, st);
    case 2: return launch_f32<2>(q, k, v, a, blocks, st);
    case 3: return launch_f32<3>(q, k, v, a, blocks, st);
    case 4: return launch_f32<4>(q, k, v, a, blocks, st);
    case 5: return launch_f32<5>(q, k, v, a, blocks, st);
    case 6: return launch_f32<6>(q, k, v, a, blocks, st);
    case 7: return launch_f32<7>(q, k, v, a, blocks, st);
    case 8: return launch_f32<8>(q, k, v, a, blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, const Args& a, unsigned blocks,
              cudaStream_t st) {
  const size_t smem = split_tc_smem_bytes(a.h, DP);
  const int err = opt_in(paged_split_tc_kernel<DP>, smem);
  if (err != 0) return err;
  paged_split_tc_kernel<DP><<<blocks, kSplitTcThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), a.tables, a.lens, a.ws, a.h, a.d, a.n_pages, a.page,
      a.slots, a.len, a.dense, a.scale_log2, a.vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int THREADS>
int combine(const float* ws, const int* lens, void* o, int b, int h, int s, int d, int len,
            int n_splits, cudaStream_t st) {
  const long long blocks = (long long)((h * d + 4 * THREADS - 1) / (4 * THREADS)) * b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  split_combine_kernel<T, THREADS><<<static_cast<unsigned>(blocks), THREADS, 0, st>>>(
      ws, nullptr, lens, static_cast<T*>(o), h, s, d, len, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16; ws is
// (B, ceil(slots * page / len), H (D + 2)) float32 from the caller, with at
// most 32 splits a sequence; page at most 128, h at most 64 and d at most
// 128 (the wrapper checks all).
extern "C" {

int repro_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                       const void* block_tables, const void* context_lens, void* ws, void* o,
                       int b, int h, int d, int n_pages, int page, int slots, int len,
                       int dense, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long s = (long long)slots * page;
  if (s > 0x7fffffffLL || len < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int n_splits = static_cast<int>((s + len - 1) / len);
  if (n_splits > kSplitMaxSplits || h > kSplitMaxHeads || d > 128 || page > 128) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (long long)n_splits * b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pages) |
                         reinterpret_cast<uintptr_t>(v_pages);
  Args a{static_cast<const int*>(block_tables), static_cast<const int*>(context_lens),
         static_cast<float*>(ws), h, d, n_pages, page, slots, len, dense,
         kSplitLog2e / sqrtf(static_cast<float>(d)), 0};
  const unsigned grid = static_cast<unsigned>(blocks);
  int err = 0;
  if (dtype == 0) {
    a.vec = d % 4 == 0 && bits % 16 == 0;
    err = dispatch_f32(q, k_pages, v_pages, a, grid, st);
    if (err != 0) return err;
    return combine<float, kSplitF32Threads>(a.ws, a.lens, o, b, h, static_cast<int>(s), d, len,
                                            n_splits, st);
  }
  a.vec = d % 8 == 0 && bits % 16 == 0;
  if (d <= 16) {
    err = launch_tc<16>(q, k_pages, v_pages, a, grid, st);
  } else if (d <= 32) {
    err = launch_tc<32>(q, k_pages, v_pages, a, grid, st);
  } else if (d <= 64) {
    err = launch_tc<64>(q, k_pages, v_pages, a, grid, st);
  } else {
    err = launch_tc<128>(q, k_pages, v_pages, a, grid, st);
  }
  if (err != 0) return err;
  return combine<__nv_bfloat16, kSplitTcThreads>(a.ws, a.lens, o, b, h, static_cast<int>(s), d,
                                                 len, n_splits, st);
}

}  // extern "C"
