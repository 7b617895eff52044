// GEMM ladder of the CUTHERMO paper (section VI-A) for Hopper (sm_90a).
//
// Every kernel computes C = A * B for row-major A (M, K) and B (K, N), with
// float32 or bfloat16 inputs, float32 accumulation, and C in the input type,
// on any M, N, K >= 1.  Shapes need not be multiples of the tile sizes:
// every kernel masks the ragged edge itself.  The kernels launch on the
// caller's stream, allocate nothing and do not synchronise; each entry point
// returns cudaGetLastError() right after its launch, so a refused launch
// surfaces in the Python wrapper.
//
// Bound on an H100 SXM: 2 M N K operations over the type's peak, against
// (M K + K N + M N) elements moved once over 3.35 TB/s.  At 1024^3, 2.15
// GFLOP take 32 us at the CUDA cores' float32 rate (67 TFLOP/s) and 2.2 us
// at the tensor cores' bfloat16 rate (989 TFLOP/s), against 12.6 / 6.3 MB
// (3.8 / 1.9 us): the operations bound both types.  At Jamba-v0.1-52B's MLP
// up-projection (M 4096, K 4096, N 14336; 481 GFLOP) the bounds are 7.18 ms
// in float32 and 0.486 ms in bfloat16.  v00 and v01 are the paper's
// deliberately naive rungs, on the CUDA cores in both types; v02 is the
// tiled rung, redesigned for Hopper: bfloat16 on the tensor cores, float32
// on the CUDA cores with a larger register tile (see below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

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
// The Pallas kernel walks a (bm, bn, bk) grid with K innermost and carries
// the C block in a VMEM accumulator from one K step to the next.  Here a
// block owns a BM x 128 tile of C, loops over K itself and keeps its sums in
// registers: blocks run in parallel and in no order on the 132 SMs, so
// nothing may carry over between them.  BM comes from the wrapper
// (kernels/gemm.py:block_rows).  bfloat16: 128 when the 128 x 128 grid has at
// least one block for each of the card's 132 SMs, else 64 (at 1024^3 that is
// 128 blocks of 64 x 128 against 64 of 128 x 128; at M 4096, N 14336 it is
// 3584 blocks of 128 x 128).  float32: 64 (see below).  The blocks
// run on a 1-D grid in a grouped raster: the blocks of a group of 8
// consecutive row tiles sweep the column tiles, the group's row tiles of one
// column tile next to each other, so 8 blocks read each B tile at about the
// same time and the group's rows of A stay in L2 while the columns pass.
//
// bfloat16 (gemm_v02_tc_kernel<BM>): the products on the tensor cores
// (mma.sync m16n8k16, float32 accumulators; helpers in mma.cuh), the layout
// of gmm.cu's gmm_tc_kernel.  128 threads (4 warps); warp w owns rows
// (BM/2)(w/2) .. and columns 64 (w%2) .. of the tile, BM/32 x 8 m16n8
// accumulators.  K is walked in steps of 64 through a three-stage cp.async
// ring of (BM, 64) A tiles and (64, 128) B tiles (96 KB at BM 128, 72 KB at
// 64: two blocks an SM), swizzled for ldmatrix (mma.cuh:swz); B is (K, N)
// row-major, so its fragments come by the transposed ldmatrix.  Thread t
// copies 16-byte chunks t, t + 128, ... of each staged tile; a tile wholly
// inside A or B takes stage_tile_full (no per-chunk index arithmetic).
// Rows that are not 16-byte aligned (K or N not a multiple of 8, or a base
// off 16 bytes) are staged with 2-byte loads by the same threads and stored
// 16 bytes at a time (mma.cuh:stage_tile).  Past M, N or K a chunk is zero,
// never stale, so a zero-filled chunk of A meeting a live chunk of B adds 0.
// C goes out as bf16 through shared memory with 16-byte stores: warp w
// stores rows (BM/4) w .. (BM/4)(w+1) - 1 of the tile.  Bound: the
// operations; what is left to the card's peak is wgmma, TMA and a
// persistent, warp-specialised schedule.
//
// float32 (gemm_v02_kernel): on the CUDA cores (TF32 keeps too few digits
// for float32's tolerance), the standard SGEMM shape on 64 x 128 tiles.  128
// threads, each an 8 x 8 micro-tile of C in registers (about 150 registers,
// three blocks an SM): thread (ty, tx) = (t / 16, t % 16) owns rows 8 ty ..
// 8 ty + 7 and columns 4 tx .. 4 tx + 3 and 64 + 4 tx .. 64 + 4 tx + 3.  A
// 128-row tile (256 threads, one block an SM) was no faster at M 4096, N
// 14336 and slower at 1024^3, so float32 has the one height.  K is walked in steps of 8; the A tile is stored k-major
// in shared memory (rows of BM + 4 floats, so the transposing stores are
// free of bank conflicts), so both operands are read with float4: four
// 16-byte shared loads feed 64 multiply-adds.  Two buffers: the next step's
// tiles are loaded into registers before this step's products and stored to
// the other buffer after them, one barrier a step.  Thread t loads the
// float4 at row t / 2, columns 4 (t % 2) of each A tile, and float4 items t
// and t + 128 (row i / 32, columns 4 (i % 32)) of each (8, 128) B tile, so
// warp w reads A rows 16 w .. 16 w + 15 of the tile and the B rows k with
// k % 4 == w; it stores C rows 16 w .. 16 w + 15 of the tile
// (kernels/gemm.py:gemm_v02_spec).  Rows that are not 16-byte aligned (K or
// N not a multiple of 4) take scalar loads and stores.  Bound: the float32
// FMA rate.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kGroup = 8;  // row tiles a raster group
constexpr int kBN = 128;   // columns of C a block (both routes)

// the (row tile, column tile) of 1-D block `bid` in the grouped raster
__device__ __forceinline__ void raster(int bid, int row_blocks, int col_blocks, int& rt,
                                       int& ct) {
  const int per_group = kGroup * col_blocks;
  const int group = bid / per_group;
  const int first = group * kGroup;
  const int size = min(kGroup, row_blocks - first);
  const int local = bid - group * per_group;
  rt = first + local % size;
  ct = local / size;
}

// ---- bfloat16 on the tensor cores ------------------------------------------

constexpr int kTcBK = 64;        // depth of a staged step
constexpr int kTcStages = 3;     // the cp.async ring
constexpr int kTcThreads = 128;  // 4 warps
constexpr int kCA = kTcBK / 8;   // 16-byte chunks of an A tile row
constexpr int kCB = kBN / 8;     // ... of a B tile row

template <int BM>
__host__ __device__ constexpr size_t tc_smem_bytes() {
  return sizeof(bf16) * kTcStages * (BM * kTcBK + kTcBK * kBN);
}

template <int BM>
__global__ void __launch_bounds__(kTcThreads)
gemm_v02_tc_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, bf16* __restrict__ c,
                   int m, int n, int k, int vec_a, int vec_b, int vec_c) {
  constexpr int kMT = BM / 32;  // m16 tiles a warp (it owns BM / 2 rows)
  static_assert(tc_smem_bytes<BM>() >= sizeof(bf16) * BM * kBN, "the C tile reuses the ring");
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* as = reinterpret_cast<bf16*>(tc_smem);  // [stages][BM][BK]
  bf16* bs = as + kTcStages * BM * kTcBK;       // [stages][BK][BN]

  const int row_blocks = (m + BM - 1) / BM;
  const int col_blocks = (n + kBN - 1) / kBN;
  int rt, ct;
  raster(blockIdx.x, row_blocks, col_blocks, rt, ct);
  const int row0 = rt * BM;
  const int col0 = ct * kBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wr = (BM / 2) * (warp / 2);  // this warp's rows and columns in the tile
  const int wc = 64 * (warp % 2);
  const int nk = (k + kTcBK - 1) / kTcBK;
  const int rows = min(BM, m - row0);
  const bool a_inside = vec_a && rows == BM;
  const bool b_inside = vec_b && col0 + kBN <= n;
  const bf16* ab = a + (size_t)row0 * k;
  const bf16* bb = b + col0;

  float acc[kMT][8][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  auto stage = [&](int slot, int kt) {
    const int k0 = kt * kTcBK;
    bf16* at = as + slot * BM * kTcBK;
    bf16* bt = bs + slot * kTcBK * kBN;
    if (a_inside && k0 + kTcBK <= k) {
      stage_tile_full<kCA, BM, kTcThreads>(at, ab + k0, k, tid);
    } else {
      stage_tile<kCA>(at, ab + k0, BM, k, rows, k - k0, vec_a != 0, tid, kTcThreads);
    }
    if (b_inside && k0 + kTcBK <= k) {
      stage_tile_full<kCB, kTcBK, kTcThreads>(bt, bb + (size_t)k0 * n, n, tid);
    } else {
      stage_tile<kCB>(bt, bb + (size_t)k0 * n, kTcBK, n, k - k0, n - col0, vec_b != 0, tid,
                      kTcThreads);
    }
  };
#pragma unroll
  for (int st = 0; st < kTcStages - 1; ++st) {
    if (st < nk) stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTcStages - 2>();  // step kt has landed
    __syncthreads();                 // ... for every thread; step kt - 1 is done
    if (kt + kTcStages - 1 < nk) stage((kt + kTcStages - 1) % kTcStages, kt + kTcStages - 1);
    cp_async_commit();
    const int slot = kt % kTcStages;
    const uint32_t abase = smem_u32(as + slot * BM * kTcBK);
    const uint32_t bbase = smem_u32(bs + slot * kTcBK * kBN);
#pragma unroll
    for (int ks = 0; ks < kTcBK / 16; ++ks) {
      uint32_t af[kMT][4];
      uint32_t bfr[8][2];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
        const int r = wr + 16 * i + lane % 16;
        ldmatrix_x4(af[i], abase + swz_offset<kCA>(r, ks * 16 + (lane / 16) * 8));
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t q[4];
        const int kr = ks * 16 + ((lane / 8) & 1) * 8 + lane % 8;
        ldmatrix_x4_trans(q, bbase + swz_offset<kCB>(kr, wc + jj * 16 + (lane / 16) * 8));
        bfr[2 * jj][0] = q[0];
        bfr[2 * jj][1] = q[1];
        bfr[2 * jj + 1][0] = q[2];
        bfr[2 * jj + 1][1] = q[3];
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_bf16_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for C

  // C as bf16 into shared memory (the ring), then warp w stores rows
  // (BM/4) w .. (BM/4)(w+1) - 1 of the tile with 16-byte stores
  unsigned char* cb = tc_smem;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = wr + 16 * i + lane / 4;
      const int col = wc + 8 * j + 2 * (lane % 4);
      *reinterpret_cast<uint32_t*>(cb + swz_offset<kCB>(r, col)) =
          pack_bf16(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<uint32_t*>(cb + swz_offset<kCB>(r + 8, col)) =
          pack_bf16(acc[i][j][2], acc[i][j][3]);
    }
  }
  __syncthreads();
  constexpr int kRowsPerWarp = BM / 4;
  for (int i = lane; i < kRowsPerWarp * kCB; i += 32) {
    const int r = kRowsPerWarp * warp + i / kCB;
    const int ch = i % kCB;
    const int gc = col0 + 8 * ch;
    if (r >= rows || gc >= n) continue;
    const unsigned char* src = cb + (r * kCB + swz<kCB>(r, ch)) * 16;
    bf16* dst = c + (size_t)(row0 + r) * n + gc;
    if (vec_c) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const bf16* vals = reinterpret_cast<const bf16*>(src);
      for (int e = 0; e < 8 && gc + e < n; ++e) dst[e] = vals[e];
    }
  }
}

// ---- float32 on the CUDA cores ---------------------------------------------

constexpr int kBK = 8;         // depth of a staged step
constexpr int kF32BM = 64;     // rows of C a block
constexpr int kF32Threads = 128;  // an 8 x 8 micro-tile each

__global__ void __launch_bounds__(kF32Threads)
gemm_v02_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
                int m, int n, int k, int vec_a, int vec_b, int vec_c) {
  constexpr int BM = kF32BM;
  constexpr int kThreads = kF32Threads;
  constexpr int kLda = BM + 4;                   // k-major A rows, padded
  constexpr int kBLoads = kBK * kBN / 4 / kThreads;  // float4 of a B tile a thread
  __shared__ __align__(16) float as[2][kBK][kLda];
  __shared__ __align__(16) float bs[2][kBK][kBN];

  const int row_blocks = (m + BM - 1) / BM;
  const int col_blocks = (n + kBN - 1) / kBN;
  int rt, ct;
  raster(blockIdx.x, row_blocks, col_blocks, rt, ct);
  const int row0 = rt * BM;
  const int col0 = ct * kBN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int a_r = tid / 2;        // the A tile row this thread loads
  const int a_k = (tid % 2) * 4;  // ... and its four columns

  float4 ra;
  float4 rb[kBLoads];
  // the tiles of the step at k0 into registers, zero past M, N and K
  auto load = [&](int k0) {
    const int gr = row0 + a_r;
    const int gk = k0 + a_k;
    ra = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < m) {
      const float* p = a + (size_t)gr * k + gk;
      if (vec_a) {
        if (gk < k) ra = *reinterpret_cast<const float4*>(p);
      } else {
        ra.x = gk < k ? p[0] : 0.f;
        ra.y = gk + 1 < k ? p[1] : 0.f;
        ra.z = gk + 2 < k ? p[2] : 0.f;
        ra.w = gk + 3 < k ? p[3] : 0.f;
      }
    }
#pragma unroll
    for (int s = 0; s < kBLoads; ++s) {
      const int i = tid + kThreads * s;
      const int gkr = k0 + i / 32;
      const int gc = col0 + (i % 32) * 4;
      rb[s] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gkr < k) {
        const float* p = b + (size_t)gkr * n + gc;
        if (vec_b) {
          if (gc < n) rb[s] = *reinterpret_cast<const float4*>(p);
        } else {
          rb[s].x = gc < n ? p[0] : 0.f;
          rb[s].y = gc + 1 < n ? p[1] : 0.f;
          rb[s].z = gc + 2 < n ? p[2] : 0.f;
          rb[s].w = gc + 3 < n ? p[3] : 0.f;
        }
      }
    }
  };
  auto store = [&](int buf) {
    as[buf][a_k + 0][a_r] = ra.x;
    as[buf][a_k + 1][a_r] = ra.y;
    as[buf][a_k + 2][a_r] = ra.z;
    as[buf][a_k + 3][a_r] = ra.w;
#pragma unroll
    for (int s = 0; s < kBLoads; ++s) {
      const int i = tid + kThreads * s;
      *reinterpret_cast<float4*>(&bs[buf][i / 32][(i % 32) * 4]) = rb[s];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }

  const int nk = (k + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * kBK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[cur][kk][8 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[cur][kk][8 * ty + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[cur][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[cur][kk][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();  // the stores are seen; every thread is done with cur
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gr = row0 + 8 * ty + i;
    if (gr >= m) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int gc = col0 + 64 * half + 4 * tx;
      float* p = c + (size_t)gr * n + gc;
      const float4 v = make_float4(acc[i][4 * half], acc[i][4 * half + 1],
                                   acc[i][4 * half + 2], acc[i][4 * half + 3]);
      if (vec_c) {
        if (gc < n) *reinterpret_cast<float4*>(p) = v;
      } else {
        if (gc < n) p[0] = v.x;
        if (gc + 1 < n) p[1] = v.y;
        if (gc + 2 < n) p[2] = v.z;
        if (gc + 3 < n) p[3] = v.w;
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <int BM>
int launch_v02_tc(const void* a, const void* b, void* c, int m, int n, int k,
                  long long blocks, cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<BM>();
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_v02_tc_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_v02_tc_kernel<BM><<<static_cast<unsigned>(blocks), kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c), m, n, k,
      k % 8 == 0 && aligned16(a), n % 8 == 0 && aligned16(b), n % 8 == 0 && aligned16(c));
  return static_cast<int>(cudaGetLastError());
}

int launch_v02_f32(const void* a, const void* b, void* c, int m, int n, int k,
                   long long blocks, cudaStream_t stream) {
  gemm_v02_kernel<<<static_cast<unsigned>(blocks), kF32Threads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(c), m, n,
      k, k % 4 == 0 && aligned16(a), n % 4 == 0 && aligned16(b), n % 4 == 0 && aligned16(c));
  return static_cast<int>(cudaGetLastError());
}

int launch_v02(const void* a, const void* b, void* c, int m, int n, int k, int dtype, int bm,
               cudaStream_t stream) {
  const long long blocks = (long long)((m + bm - 1) / bm) * ((n + kBN - 1) / kBN);
  const bool height = dtype == 0 ? bm == kF32BM : bm == 64 || bm == 128;
  if (!height || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_v02_f32(a, b, c, m, n, k, blocks, stream);
  return bm == 128 ? launch_v02_tc<128>(a, b, c, m, n, k, blocks, stream)
                   : launch_v02_tc<64>(a, b, c, m, n, k, blocks, stream);
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
  } else {
    dim3 grid((n + 31) / 32, (m + 7) / 8);
    gemm_v01_kernel<T><<<grid, dim3(32, 8), 0, stream>>>(pa, pb, pc, m, n, k);
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

// Plain C entry points for ctypes.  dtype: 0 = float32, 1 = bfloat16; bm
// (v02): rows of C a block, 64 in float32, 64 or 128 in bfloat16.
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
                   int dtype, int bm, void* stream) {
  return launch_v02(a, b, c, m, n, k, dtype, bm, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
