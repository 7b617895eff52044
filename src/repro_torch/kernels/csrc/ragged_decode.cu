// Ragged MQA decode attention for Hopper (sm_90a).
//
// Replaces repro/kernels/ragged_flash.py:_ragged_decode_kernel
// (ragged_decode_attention).  For q (B, H, D), one query per sequence, and
// one KV head k, v (B, S, D) shared by all H query heads, it computes
//   O[b, h] = softmax(scale * q[b, h] . K[b, p]) . V[b, p]
// over the positions p in [starts[b], ends[b]) (clamped to [0, S)), with
// scale = 1/sqrt(D), float32 scores and sums, and O in the input type
// (float32 or bfloat16).  A sequence with no live position gets O = 0 (the
// Pallas kernel's answer there depends on its tile width; see
// kernels/ragged_flash.py).  The kernel launches on the caller's stream,
// allocates nothing and does not synchronise; the entry point returns
// cudaGetLastError() right after its launch.
//
// Design: one block of 8 warps per sequence (the block step is Decoder, in
// decode.cuh).  The block walks the tiles of BKV rows (32, 64 or 128, a
// template parameter) that overlap [start, end), which is the Pallas
// kernel's pl.when gate, and stages only the live rows of each: a tile
// wholly outside the range is never read.  Each staged K and V row is read
// from device memory once and used by all H heads.  With dense = 1 the gate
// is off: the block walks every tile and stages every row below S, masked
// as before, which gives the same output; it is the registry's baseline
// rung, the dense sweep.
//
// Bound on an H100 SXM at Granite-20B's decode widths (B, H, D) = (64, 48,
// 128) with ~2,560 live positions a sequence: bfloat16 moves ~84 MB of live
// K and V (25 us at 3.35 TB/s) for 4.0 GFLOP; float32 moves twice the bytes
// and its 4.0 GFLOP on the CUDA cores (67 TFLOP/s) take 60 us, so the
// arithmetic bounds it.  One block per sequence puts 64 blocks on 132 SMs
// and each block loads its tiles synchronously, so this first kernel sits
// far from both; splitting the KV walk over blocks (flash-decoding) and
// asynchronous tile loads are later work.
//
// Shared memory: (H D + 2 BKV (D|1) + 8 ceil(H/8) BKV) floats, 180 KB at
// H = 48, D = 128, BKV = 128: above the 48 KB a block gets by default, so
// the launch opts in with cudaFuncSetAttribute first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"
#include "decode.cuh"

namespace {

template <typename T, int BKV>
__global__ void __launch_bounds__(kDecThreads)
ragged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ starts,
                     const int* __restrict__ ends, T* __restrict__ o, int h,
                     int s, int d, int dense, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lo = max(starts[b], 0);
  const int hi = min(ends[b], s);
  Decoder<T, BKV> dec(smem, q + (size_t)b * h * d, h, d, scale);
  const T* kb = k + (size_t)b * s * d;
  const T* vb = v + (size_t)b * s * d;
  int t0 = 0;
  int t1 = 0;
  if (dense) {
    t1 = (s + BKV - 1) / BKV;
  } else if (lo < hi) {
    t0 = lo / BKV;
    t1 = (hi - 1) / BKV + 1;
  }
  for (int t = t0; t < t1; ++t) {
    const int k0 = t * BKV;
    const int l_lo = max(lo - k0, 0);
    const int l_hi = min(hi - k0, BKV);
    const int s_hi = dense ? min(BKV, s - k0) : l_hi;
    dec.chunk(kb + (size_t)k0 * d, vb + (size_t)k0 * d, BKV, dense ? 0 : l_lo,
              s_hi, l_lo, l_hi);
  }
  dec.finish(o + (size_t)b * h * d);
}

template <typename T, int BKV>
int launch(const void* q, const void* k, const void* v, const int* starts,
           const int* ends, void* o, int b, int h, int s, int d, int dense,
           cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<BKV>(h, d);
  cudaError_t err = cudaFuncSetAttribute(
      ragged_decode_kernel<T, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ragged_decode_kernel<T, BKV><<<b, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), starts, ends, static_cast<T*>(o), h, s, d,
      dense, 1.0f / sqrtf(static_cast<float>(d)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const int* starts,
             const int* ends, void* o, int b, int h, int s, int d, int bkv,
             int dense, cudaStream_t st) {
  if (bkv == 32) return launch<T, 32>(q, k, v, starts, ends, o, b, h, s, d, dense, st);
  if (bkv == 64) return launch<T, 64>(q, k, v, starts, ends, o, b, h, s, d, dense, st);
  if (bkv == 128) return launch<T, 128>(q, k, v, starts, ends, o, b, h, s, d, dense, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16; bkv is
// 32, 64 or 128, h at most 64 and d at most 128 (the wrapper checks all).
extern "C" {

int repro_ragged_decode(const void* q, const void* k, const void* v,
                        const void* starts, const void* ends, void* o, int b,
                        int h, int s, int d, int bkv, int dense, int dtype,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(starts);
  const int* ep = static_cast<const int*>(ends);
  if (dtype == 0) return dispatch<float>(q, k, v, sp, ep, o, b, h, s, d, bkv, dense, st);
  return dispatch<__nv_bfloat16>(q, k, v, sp, ep, o, b, h, s, d, bkv, dense, st);
}

}  // extern "C"
