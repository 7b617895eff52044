// The Mamba-2 SSD intra-chunk term for Hopper (sm_90a).
//
// Replaces repro/kernels/ssd.py:_ssd_chunk_kernel (ssd_chunk).  For every
// (batch*head, chunk) cell, with x (L, P), log-decays a (L,), B and C
// (L, N) of that chunk and cum = cumsum(a):
//     y[i] = sum_{j <= i} (C[i] . B[j]) exp(cum[i] - cum[j]) x[j]     (L, P)
//     s[p, n] = sum_t exp(cum[L-1] - cum[t]) x[t, p] B[t, n]         (P, N)
// Inputs are float32 or bfloat16, sums float32, and both outputs float32.
// As in the Pallas kernel the scores (C B^T with the decay) and the decayed
// x are rounded to the input type before their products (a no-op in
// float32).  The decay is masked BEFORE the exponential: for j > i,
// cum[i] - cum[j] > 0 and over a long chunk exp overflows, and inf * 0 would
// be NaN.  The kernel launches on the caller's stream, allocates nothing and
// does not synchronise; the entry point returns cudaGetLastError() right
// after its launch.
//
// Design.  One block of 256 threads (8 warps) per (chunk, bh).  The block
// stages x and B of its chunk in shared memory (element e of each by
// thread e mod 256), and warp 0 takes the cumulative sum of a (each lane a
// run of ceil(L/32) steps, then a shuffle scan of the runs) and the
// end-state decays exp(cum[L-1] - cum[t]).  For y, warp w takes the row
// groups g = w, w + 8, ... of 4 rows.  C is read by that warp alone, so it
// is not staged for the whole chunk: when the warp starts a group, its
// lanes bring the group's 4 rows of C (element e of the 4 x N by lane
// e mod 32) into a slice of shared memory of the warp's own.  Then, for
// each 32-column tile of j up to the group's last row, its lanes form the
// masked 4 x 32 score tile (lane = 8 * row + j mod 8) in another
// warp-private slice, and accumulate it times x into the 4 x P rows, held
// in registers (lane: row lane / 8, columns lane % 8 + 8q).  Tiles above
// the diagonal are skipped.
// For s, thread e of the block sums element e (mod 256) of the P x N state
// over the L steps.  kernels/ssd.py:ssd_chunk_spec describes these loads
// and stores warp by warp.
//
// Bound on an H100 SXM at Jamba's widths, (BH, C, L, P, N) =
// (128, 16, 256, 64, 16), float32: the causal half of the two products,
// L(L+1)/2 * 2(N + P) per cell, and the 2 L P N of the state are 11.9 GFLOP,
// 0.18 ms at the CUDA cores' float32 rate (67 TFLOP/s), against 346 MB of
// inputs and outputs, 0.10 ms at 3.35 TB/s: the arithmetic bounds it.  Each
// staged element of B and x is reused by up to L rows; shared-memory reads
// (about one per multiply-add) are what this first kernel spends its time
// on.
//
// Shared memory: L P + L (N + 1) + 2 L + 8 * 4 * 33 + 8 * 4 * (N + 1)
// floats (kernels/ssd.py:smem_bytes), 91 KB for Jamba's chunk and 215 KB
// for Mamba2-2.7b's (L 256, P 64, N 128): above the 48 KB a block gets by
// default, so the launch opts in with cudaFuncSetAttribute first.  The
// wrapper refuses shapes above the 227 KB a block can have.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;      // rows of y per warp group
constexpr int kTJ = 32;       // columns j per score tile
constexpr int kMaxCols = 16;  // P up to 128: lane % 8 + 8q for q < 16

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const T* __restrict__ a,
                 const T* __restrict__ bmat, const T* __restrict__ cmat,
                 float* __restrict__ y, float* __restrict__ s, int l, int p,
                 int n) {
  extern __shared__ float smem[];
  const int ldn = n + 1;  // padded: 8 rows of B at one column hit 8 banks
  float* xs = smem;                 // [l][p]
  float* bs = xs + l * p;           // [l][ldn]
  float* cum = bs + l * ldn;        // [l]
  float* wdec = cum + l;            // [l]: exp(cum[l-1] - cum[t])
  float* sw = wdec + l;             // [kWarps][kRows][kTJ + 1]
  float* cw = sw + kWarps * kRows * (kTJ + 1);  // [kWarps][kRows][ldn]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t cell = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  const T* xg = x + cell * l * p;
  const T* bg = bmat + cell * l * n;
  const T* cg = cmat + cell * l * n;
  float* yg = y + cell * l * p;
  float* sg = s + cell * p * n;

  for (int e = tid; e < l * p; e += kThreads) xs[e] = to_float(xg[e]);
  for (int e = tid; e < l * n; e += kThreads) {
    bs[(e / n) * ldn + e % n] = to_float(bg[e]);
  }
  if (warp == 0) {
    const T* ag = a + cell * l;
    const int per = (l + 31) / 32;
    const int lo = min(lane * per, l);
    const int hi = min(lo + per, l);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {
      run += to_float(ag[i]);
      cum[i] = run;
    }
    float incl = run;  // inclusive scan of the lanes' run totals
    for (int off = 1; off < 32; off *= 2) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    const float base = incl - run;
    for (int i = lo; i < hi; ++i) cum[i] += base;
    __syncwarp();
    const float clast = cum[l - 1];
    for (int i = lo; i < hi; ++i) wdec[i] = expf(clast - cum[i]);
  }
  __syncthreads();

  // y: warp w takes the row groups g = w, w + 8, ...
  float* tile = sw + warp * kRows * (kTJ + 1);
  float* crow = cw + warp * kRows * ldn;  // the group's rows of C
  const int ii = lane / 8;
  const int jl = lane % 8;
  const int ncol = (p + 7) / 8;
  for (int g = warp; g * kRows < l; g += kWarps) {
    const int i = g * kRows + ii;
    const int ilast = min(g * kRows + kRows, l) - 1;
    __syncwarp();  // the previous group's reads of crow are done
    for (int e = lane; e < (ilast + 1 - g * kRows) * n; e += 32) {
      crow[(e / n) * ldn + e % n] = to_float(cg[(size_t)g * kRows * n + e]);
    }
    __syncwarp();
    float acc[kMaxCols];
#pragma unroll
    for (int q = 0; q < kMaxCols; ++q) acc[q] = 0.f;
    for (int j0 = 0; j0 <= ilast; j0 += kTJ) {
#pragma unroll
      for (int q = 0; q < kTJ / 8; ++q) {
        const int j = j0 + jl + 8 * q;
        float sc = 0.f;
        if (i < l && j <= i) {  // mask before the exponential
          float dot = 0.f;
          for (int c = 0; c < n; ++c) dot += crow[ii * ldn + c] * bs[j * ldn + c];
          sc = round_to<T>(dot * expf(cum[i] - cum[j]));
        }
        tile[ii * (kTJ + 1) + jl + 8 * q] = sc;
      }
      __syncwarp();
      const int jn = min(kTJ, l - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float sv = tile[ii * (kTJ + 1) + jj];
        const float* xr = xs + (j0 + jj) * p;
#pragma unroll
        for (int q = 0; q < kMaxCols; ++q) {
          const int c = jl + 8 * q;
          if (q < ncol && c < p) acc[q] += sv * xr[c];
        }
      }
      __syncwarp();
    }
    if (i < l) {
#pragma unroll
      for (int q = 0; q < kMaxCols; ++q) {
        const int c = jl + 8 * q;
        if (q < ncol && c < p) yg[(size_t)i * p + c] = acc[q];
      }
    }
  }

  // s: thread e (mod 256) of the P x N state
  for (int e = tid; e < p * n; e += kThreads) {
    const int pp = e / n;
    const int nn = e % n;
    float acc = 0.f;
    for (int t = 0; t < l; ++t) {
      acc += round_to<T>(xs[t * p + pp] * wdec[t]) * bs[t * ldn + nn];
    }
    sg[e] = acc;
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* c,
           void* y, void* s, int bh, int chunks, int l, int p, int n,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)l * p + (size_t)l * (n + 1) + 2 * (size_t)l +
                                       kWarps * kRows * (kTJ + 1) +
                                       (size_t)kWarps * kRows * (n + 1));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(chunks, bh);
  ssd_chunk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const T*>(c),
      static_cast<float*>(y), static_cast<float*>(s), l, p, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16 (x, a,
// B and C share it); y and s are float32.  P is at most 128 (the wrapper
// checks it, and the shared-memory size).
extern "C" {

int repro_ssd_chunk(const void* x, const void* a, const void* b,
                    const void* c, void* y, void* s, int bh, int chunks,
                    int l, int p, int n, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, a, b, c, y, s, bh, chunks, l, p, n, st);
  return launch<__nv_bfloat16>(x, a, b, c, y, s, bh, chunks, l, p, n, st);
}

}  // extern "C"
