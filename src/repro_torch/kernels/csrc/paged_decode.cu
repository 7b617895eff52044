// Paged-KV MQA decode attention for Hopper (sm_90a).
//
// Replaces repro/kernels/paged_attn.py:_paged_decode_kernel
// (paged_decode_attention).  The KV cache is a pool of pages, k_pages and
// v_pages (1, P, page, D), one KV head shared by all H query heads;
// sequence b's logical slot j lives in physical page block_tables[b, j],
// and its first context_lens[b] positions (clamped to [0, slots * page])
// are live.  For q (B, H, D) it computes
//   O[b, h] = softmax(scale * q[b, h] . K[b, p]) . V[b, p], p < context_lens[b]
// with scale = 1/sqrt(D), float32 scores and sums, and O in the input type
// (float32 or bfloat16).  A sequence with no live position gets O = 0, as
// the Pallas kernel gives; a slot whose page id lies outside [0, P) adds
// nothing.  The kernel launches on the caller's stream, allocates nothing
// and does not synchronise; the entry point returns cudaGetLastError()
// right after its launch.
//
// Design: one block of 8 warps per sequence (the block step is Decoder, in
// decode.cuh).  For each slot j < ceil(ctx / page) the block reads
// block_tables[b, j] and stages the live rows of that physical page of K
// and V in shared memory, which all H heads then use; positions at or past
// context_lens[b] are masked.  With dense = 1 it walks every slot and
// stages every row of each page, still masked: the registry's baseline
// rung, run on a contiguous per-row cache viewed as pages under the
// identity table b * slots + j.
//
// Bound on an H100 SXM at Granite-20B's decode widths (B, H, D) = (64, 48,
// 128), page 64: the live K and V rows in bfloat16 set it (bytes over
// 3.35 TB/s); float32's operations on the CUDA cores come close.  One
// block per sequence and synchronous page loads keep this first kernel far
// from it; see ragged_decode.cu.
//
// Shared memory: (H D + 2 CH (D|1) + 8 ceil(H/8) CH) floats, with CH the
// page rounded up to 32, 64 or 128: 115 KB at H = 48, D = 128, page 64, so
// the launch opts in with cudaFuncSetAttribute first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "decode.cuh"

namespace {

template <typename T, int CH>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ o, int h,
                    int d, int n_pages, int page, int slots, int dense,
                    float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int ctx = min(max(lens[b], 0), slots * page);
  Decoder<T, CH> dec(smem, q + (size_t)b * h * d, h, d, scale);
  const int n_walk = dense ? slots : (ctx + page - 1) / page;
  for (int j = 0; j < n_walk; ++j) {
    const int phys = tables[(size_t)b * slots + j];
    if (phys < 0 || phys >= n_pages) continue;  // uniform across the block
    const size_t base = (size_t)phys * page * d;
    const int live = min(page, ctx - j * page);
    dec.chunk(kp + base, vp + base, page, 0, dense ? page : live, 0, live);
  }
  dec.finish(o + (size_t)b * h * d);
}

template <typename T, int CH>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lens, void* o, int b, int h, int d, int n_pages,
           int page, int slots, int dense, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<CH>(h, d);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_decode_kernel<T, CH><<<b, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lens, static_cast<T*>(o), h, d,
      n_pages, page, slots, dense, 1.0f / sqrtf(static_cast<float>(d)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* kp, const void* vp, const int* tables,
             const int* lens, void* o, int b, int h, int d, int n_pages,
             int page, int slots, int dense, cudaStream_t st) {
  if (page <= 32) return launch<T, 32>(q, kp, vp, tables, lens, o, b, h, d, n_pages, page, slots, dense, st);
  if (page <= 64) return launch<T, 64>(q, kp, vp, tables, lens, o, b, h, d, n_pages, page, slots, dense, st);
  if (page <= 128) return launch<T, 128>(q, kp, vp, tables, lens, o, b, h, d, n_pages, page, slots, dense, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16; page
// at most 128, h at most 64 and d at most 128 (the wrapper checks all).
extern "C" {

int repro_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                       const void* block_tables, const void* context_lens,
                       void* o, int b, int h, int d, int n_pages, int page,
                       int slots, int dense, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(block_tables);
  const int* cl = static_cast<const int*>(context_lens);
  if (dtype == 0) {
    return dispatch<float>(q, k_pages, v_pages, tb, cl, o, b, h, d, n_pages, page, slots, dense, st);
  }
  return dispatch<__nv_bfloat16>(q, k_pages, v_pages, tb, cl, o, b, h, d, n_pages, page, slots, dense, st);
}

}  // extern "C"
