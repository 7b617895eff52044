// Flash attention forward for Hopper (sm_90a): online softmax over KV tiles.
//
// Replaces repro/kernels/flash.py:_flash_kernel (flash_attention).  For
// q (BH, Sq, D) and k, v (BH, Skv, D), KV heads already broadcast to the
// query heads, it computes O = softmax(scale * Q K^T) V with
// scale = 1/sqrt(D), float32 scores and sums, and O in the input type
// (float32 or bfloat16).  The causal mask is aligned top-left as the Pallas
// kernel's: query row i sees keys j <= i, whatever Skv is.  Masked scores
// are -1e30 (the Pallas NEG_INF), not -inf: exp(-inf - (-inf)) is NaN.  As
// in the Pallas kernel, the probabilities are rounded to the input type
// before the product with V, the row sums are not, and the output is
// acc / max(l, 1e-30).  The kernels launch on the caller's stream, allocate
// nothing and do not synchronise; the entry point returns cudaGetLastError()
// right after its launch.
//
// Design.  One block of 256 threads (8 warps) per (64-query tile, bh).  The
// block stages its Q tile in shared memory once, then walks the KV tiles of
// BKV rows (32, 64 or 128, a template parameter): it stages K and V, forms
// the (64, BKV) score tile S = scale * Q K^T in registers (a 4 x BKV/16
// micro-tile per thread) and parks it in shared memory, updates the running
// row max m and row sum l (4 threads per row, kept in their registers) and
// rescales the (64, D) accumulator, which each thread keeps in registers as
// a 4 x D/16 micro-tile, before adding P V.  With causal masking the block
// stops at the last KV tile that holds a key <= its last query row: the
// tiles above the diagonal are never read.  Who reads what: warp w stages
// rows 8w .. 8w+7 of the Q tile and rows w*BKV/8 .. (w+1)*BKV/8 - 1 of every
// K and V tile, and stores rows 8w .. 8w+7 of the O tile
// (kernels/flash.py:flash_spec describes exactly this).
//
// Bound on an H100 SXM at (BH, S, D) = (32, 4096, 4096, 128), causal: the
// 4 * BH * D * S(S+1)/2 = 137 GFLOP of the two products take 2.05 ms at the
// CUDA cores' float32 rate (67 TFLOP/s) and 0.139 ms at the tensor cores'
// bf16 rate (989 TFLOP/s), against 268 MB (f32) of Q, K, V and O, 0.08 ms at
// 3.35 TB/s: the arithmetic bounds it.  This first kernel does its products
// on the CUDA cores in float32 (for bf16 too); each staged K and V element is
// reused by all 64 queries of the block.  wgmma on the tensor cores, TMA and
// a pipeline of KV tiles are later work.
//
// Shared memory: (64 + 2 BKV) (D + 1) + 64 (BKV + 1) + 128 floats, 116 KB at
// BKV = 64, D = 128, and 199 KB at BKV = 128: above the 48 KB a block gets
// by default, so the launch opts in with cudaFuncSetAttribute first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 128;              // head dims up to 128
constexpr float kNegInf = -1e30f;       // the Pallas kernel's NEG_INF

template <typename T, int BKV>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
             int d, int causal, float scale) {
  constexpr int kSJ = BKV / 16;  // score columns per thread
  extern __shared__ float smem[];
  const int ld = d + 1;  // padded row stride: conflict-free column reads
  float* qs = smem;                    // [kBQ][ld]
  float* ks = qs + kBQ * ld;           // [BKV][ld]
  float* vs = ks + BKV * ld;           // [BKV][ld]
  float* ps = vs + BKV * ld;           // [kBQ][BKV + 1]: S, then P
  float* corr = ps + kBQ * (BKV + 1);  // [kBQ]: this tile's rescale per row
  float* lsum = corr + kBQ;            // [kBQ]: final row sums

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const size_t qbase = (size_t)blockIdx.y * sq * d;
  const size_t kbase = (size_t)blockIdx.y * skv * d;

  // Q tile: warp w stages rows 8w .. 8w+7, zero past the last query
  for (int r = 0; r < kBQ / kWarps; ++r) {
    const int row = warp * (kBQ / kWarps) + r;
    const int gq = q0 + row;
    for (int c = lane; c < d; c += 32) {
      qs[row * ld + c] = gq < sq ? to_float(q[qbase + (size_t)gq * d + c]) : 0.f;
    }
  }

  // products: rows r0 .. r0+3 of the tile, score columns c0 + 16j and
  // output columns c0 + 16j; softmax: 4 threads (srow, spart) per row
  const int r0 = 4 * (tid / 16);
  const int c0 = tid % 16;
  const int srow = tid / 4;
  const int spart = tid % 4;
  const int ncol = (d + 15) / 16;
  float m_run = kNegInf;
  float l_run = 0.f;
  float acc[4][kMaxD / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) acc[i][j] = 0.f;
  }

  const int last_q = min(q0 + kBQ, sq) - 1;
  int n_tiles = (skv + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, last_q / BKV + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    __syncthreads();  // the previous tile's readers are done (and Q is staged)
    for (int r = 0; r < BKV / kWarps; ++r) {
      const int row = warp * (BKV / kWarps) + r;
      const int gk = k0 + row;
      for (int c = lane; c < d; c += 32) {
        const bool in = gk < skv;
        ks[row * ld + c] = in ? to_float(k[kbase + (size_t)gk * d + c]) : 0.f;
        vs[row * ld + c] = in ? to_float(v[kbase + (size_t)gk * d + c]) : 0.f;
      }
    }
    __syncthreads();

    // S = scale * Q K^T, masked
    float s[4][kSJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < kSJ; ++j) s[i][j] = 0.f;
    }
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[kSJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(r0 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < kSJ; ++j) kv[j] = ks[(c0 + 16 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kSJ; ++j) s[i][j] += qv[i] * kv[j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + r0 + i;
#pragma unroll
      for (int j = 0; j < kSJ; ++j) {
        const int kpos = k0 + c0 + 16 * j;
        const bool masked = kpos >= skv || (causal && kpos > qpos);
        ps[(r0 + i) * (BKV + 1) + c0 + 16 * j] = masked ? kNegInf : s[i][j] * scale;
      }
    }
    __syncthreads();

    // online softmax: the row's 4 threads are 4 neighbouring lanes
    {
      float* prow = ps + srow * (BKV + 1);
      float mx = kNegInf;
      for (int j = spart; j < BKV; j += 4) mx = fmaxf(mx, prow[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      for (int j = spart; j < BKV; j += 4) {
        const float p = expf(prow[j] - m_new);
        sum += p;
        prow[j] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float cr = expf(m_run - m_new);
      l_run = l_run * cr + sum;
      m_run = m_new;
      if (spart == 0) corr[srow] = cr;
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float cr = corr[r0 + i];
#pragma unroll
      for (int j = 0; j < kMaxD / 16; ++j) acc[i][j] *= cr;
    }
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(r0 + i) * (BKV + 1) + kk];
#pragma unroll
      for (int j = 0; j < kMaxD / 16; ++j) {
        const int c = c0 + 16 * j;
        if (j < ncol && c < d) {
          const float vv = vs[kk * ld + c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
        }
      }
    }
  }

  if (spart == 0) lsum[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gq = q0 + r0 + i;
    if (gq >= sq) continue;
    const float l = fmaxf(lsum[r0 + i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kMaxD / 16; ++j) {
      const int c = c0 + 16 * j;
      if (j < ncol && c < d) {
        o[qbase + (size_t)gq * d + c] = from_float<T>(acc[i][j] / l);
      }
    }
  }
}

template <typename T, int BKV>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int skv, int d, int causal, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + 2 * BKV) * (d + 1) +
                       (size_t)kBQ * (BKV + 1) + 2 * kBQ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, BKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sq + kBQ - 1) / kBQ, bh);
  flash_kernel<T, BKV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, d, causal,
      1.0f / sqrtf(static_cast<float>(d)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int sq, int skv, int d, int bkv, int causal, cudaStream_t s) {
  if (bkv == 32) return launch<T, 32>(q, k, v, o, bh, sq, skv, d, causal, s);
  if (bkv == 64) return launch<T, 64>(q, k, v, o, bh, sq, skv, d, causal, s);
  if (bkv == 128) return launch<T, 128>(q, k, v, o, bh, sq, skv, d, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16; bkv is
// 32, 64 or 128 and d at most 128 (the wrapper checks both).
extern "C" {

int repro_flash(const void* q, const void* k, const void* v, void* o, int bh,
                int sq, int skv, int d, int bkv, int causal, int dtype,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(q, k, v, o, bh, sq, skv, d, bkv, causal, s);
  return dispatch<__nv_bfloat16>(q, k, v, o, bh, sq, skv, d, bkv, causal, s);
}

}  // extern "C"
