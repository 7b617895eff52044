// ELL SpMV of the CUTHERMO paper's SpMV case study (section VI-E) for
// Hopper (sm_90a).
//
// spmv_ell_kernel computes y[r] = sum_k vals[r, k] * xg[r, k] for row-major
// float32 vals and xg (R, K), with float32 accumulation and y (R,) in
// float32: the padded ELL rows times x already gathered at their column
// indices.  The gather stays outside the kernel, as XLA does it outside the
// Pallas kernel (repro/kernels/spmv.py): x is indexed by data, so a gather
// inside would read x at random 4-byte words, while here the kernel streams
// two dense arrays and its cost is their bytes alone.  Each row is read by
// its own lanes only and y[r] written once: no atomics, so a second call on
// the same inputs gives the same bits.  It launches on the caller's stream,
// allocates nothing and does not synchronise; the entry point returns
// cudaGetLastError() right after its launch.
//
// Bound on an H100 SXM: the work reads vals and xg once and writes y once,
// 4 * (2 * R * K + R) bytes over 3.35 TB/s (R = 1,048,576, K = 32: 273 MB,
// 81 us; R = 65,536, K = 16: 8.65 MB, 2.6 us); 2 * R * K FLOPs are
// negligible.  So the kernel only has to keep enough bytes in flight:
//   - a row gets G lanes, the smallest power of two >= ceil(K / 4), at most
//     32 (kernels/spmv.py:lanes_per_row, passed in), so at K = 16 a warp
//     takes 8 rows of 4 lanes and at K = 32 4 rows of 8, and no lane idles;
//   - each lane reads float4s of vals and xg (ld.global.cs: both are read
//     once, so they are streamed past L1 and marked first out of L2) and
//     a warp loads kRowGroups row groups before its first FMA: 8 16-byte
//     loads a lane in flight at K <= 4 G, 128 KB an SM at 4 blocks an SM;
//   - the grid strides over the rows from at most kMinBlocks blocks on each
//     SM, so the 1,048,576-row shape runs 528 blocks, not 131,072;
//   - the G lanes of a row sum by __shfl_xor_sync, offsets G/2 down to 1,
//     and the row's lane 0 stores y with st.global.cs.
// K % 4 != 0, or a vals or xg pointer off 16-byte alignment (a contiguous
// view at an element offset), takes the scalar instantiation of the same
// kernel: the same lanes, one float a load.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroups = 4;  // row groups a warp loads before its first FMA
constexpr int kMinBlocks = 4;  // blocks an SM holds (<= 64 registers a thread)
constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------------------
// spmv_ell -- replaces repro/kernels/spmv.py:_spmv_kernel.
//
// Lane l of a warp is lane l % G of row group l / G.  A warp step covers
// kRowGroups * (32 / G) consecutive rows: row group u's rows are
// base + u * (32 / G) + l / G.  Lane l % G reads chunks c = l % G, + G, ...
// of its row (a chunk is 4 floats on the vector path, 1 on the scalar one)
// and accumulates them in order with fmaf (x, y, z, w within a chunk).  The
// step is warp-uniform, so every lane reaches the full-mask shuffles; a row
// past R loads nothing and stores nothing.
// ---------------------------------------------------------------------------
template <int G, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spmv_ell_kernel(const float* __restrict__ vals, const float* __restrict__ xg,
                float* __restrict__ y, int r, int k) {
  constexpr int kRowsPerWarp = 32 / G;
  constexpr int kStepRows = kRowGroups * kRowsPerWarp;
  const int lane = threadIdx.x % 32;
  const int sub = lane % G;
  const int group = lane / G;
  const int n = kVec ? k / 4 : k;  // chunks a row
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  for (long long base = warp * kStepRows; base < r; base += warps * kStepRows) {
    long long row[kRowGroups];
    bool live[kRowGroups];
    float acc[kRowGroups];
#pragma unroll
    for (int u = 0; u < kRowGroups; ++u) {
      row[u] = base + u * kRowsPerWarp + group;
      live[u] = row[u] < r;
      acc[u] = 0.f;
    }
    for (int c = sub; c < n; c += G) {
      if constexpr (kVec) {
        const float4* v4 = reinterpret_cast<const float4*>(vals);
        const float4* x4 = reinterpret_cast<const float4*>(xg);
        float4 v[kRowGroups], x[kRowGroups];
#pragma unroll
        for (int u = 0; u < kRowGroups; ++u) {
          const size_t at = static_cast<size_t>(row[u]) * n + c;
          v[u] = live[u] ? __ldcs(v4 + at) : make_float4(0.f, 0.f, 0.f, 0.f);
          x[u] = live[u] ? __ldcs(x4 + at) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kRowGroups; ++u) {
          acc[u] = fmaf(v[u].x, x[u].x, acc[u]);
          acc[u] = fmaf(v[u].y, x[u].y, acc[u]);
          acc[u] = fmaf(v[u].z, x[u].z, acc[u]);
          acc[u] = fmaf(v[u].w, x[u].w, acc[u]);
        }
      } else {
        float v[kRowGroups], x[kRowGroups];
#pragma unroll
        for (int u = 0; u < kRowGroups; ++u) {
          const size_t at = static_cast<size_t>(row[u]) * n + c;
          v[u] = live[u] ? __ldcs(vals + at) : 0.f;
          x[u] = live[u] ? __ldcs(xg + at) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kRowGroups; ++u) acc[u] = fmaf(v[u], x[u], acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowGroups; ++u) {
#pragma unroll
      for (int off = G / 2; off > 0; off /= 2)
        acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], off);
      if (sub == 0 && live[u]) __stcs(y + row[u], acc[u]);
    }
  }
}

// blocks of the grid-stride cap: kMinBlocks on each SM of the current
// device (read once a device)
int max_blocks() {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < kMaxDevices ? sms[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (dev < kMaxDevices) sms[dev] = n;
  }
  return n * kMinBlocks;
}

template <int G>
void launch(const float* vals, const float* xg, float* y, int r, int k, bool vec,
            cudaStream_t stream) {
  constexpr long long kBlockRows = static_cast<long long>(kWarps) * kRowGroups * (32 / G);
  long long blocks = (static_cast<long long>(r) + kBlockRows - 1) / kBlockRows;
  const long long cap = max_blocks();
  if (cap > 0 && blocks > cap) blocks = cap;
  if (vec)
    spmv_ell_kernel<G, true><<<static_cast<int>(blocks), kThreads, 0, stream>>>(vals, xg, y, r, k);
  else
    spmv_ell_kernel<G, false><<<static_cast<int>(blocks), kThreads, 0, stream>>>(vals, xg, y, r, k);
}

}  // namespace

// Plain C entry points for ctypes.
extern "C" {

// rows one block covers in one step at ``lanes`` lanes a row
// (kernels/spmv.py:rows_per_block computes the same)
long long repro_spmv_ell_rows_per_block(int lanes) {
  return static_cast<long long>(kWarps) * kRowGroups * (32 / lanes);
}

int repro_spmv_ell(const void* vals, const void* xg, void* y, int r, int k, int lanes,
                   void* stream) {
  const auto* v = static_cast<const float*>(vals);
  const auto* x = static_cast<const float*>(xg);
  auto* out = static_cast<float*>(y);
  const bool vec = k % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(vals) | reinterpret_cast<uintptr_t>(xg)) % 16) == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
    case 1: launch<1>(v, x, out, r, k, vec, s); break;
    case 2: launch<2>(v, x, out, r, k, vec, s); break;
    case 4: launch<4>(v, x, out, r, k, vec, s); break;
    case 8: launch<8>(v, x, out, r, k, vec, s); break;
    case 16: launch<16>(v, x, out, r, k, vec, s); break;
    case 32: launch<32>(v, x, out, r, k, vec, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
