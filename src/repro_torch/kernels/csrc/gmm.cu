// Grouped matmul (the MoE expert FFN) for Hopper (sm_90a).
//
// Replaces repro/kernels/gmm.py:_gmm_kernel (gmm).  The rows of x (M, K)
// are grouped by expert and each group is padded to a multiple of bm rows
// (kernels/gmm.py:plan_groups); tile_expert_ids[i] names the expert whose
// weights w[e] (K, N) multiply the bm-row tile i:
//     O[i*bm : (i+1)*bm] = X[i*bm : (i+1)*bm] . W[tile_expert_ids[i]]
// with float32 or bfloat16 inputs, float32 accumulation and O in the input
// type.  M is a multiple of bm, and bm of 32 (the wrapper checks both).  An
// id outside [0, E) reads no weights: its rows of O are zero.  The kernels
// launch on the caller's stream, allocate nothing and do not synchronise;
// the entry point returns cudaGetLastError() right after its launch.  Each
// type has a kernel of its own.
//
// Bound on an H100 SXM at M = 4096, K = 4096, N = 14336 over 16 experts:
// 2 M K N = 481 GFLOP take 7.2 ms at the CUDA cores' float32 rate (67
// TFLOP/s) and 0.49 ms at the tensor cores' bf16 rate (989 TFLOP/s), while
// the experts' weights alone are 3.76 GB in float32 (1.12 ms at 3.35 TB/s)
// and 1.88 GB in bf16 (0.56 ms): float32 is bound by its arithmetic, bf16 by
// reading W.
//
// float32: gmm_kernel, on the CUDA cores (TF32 would keep too few digits for
// the float32 tolerance).  The Pallas kernel prefetches the ids as scalars
// so that the W BlockSpec's index map can pick the expert of each tile.
// Here each block reads its own id: a block owns a BM x BN tile of O, with
// BM = 64 rows when bm is a multiple of 64 and BM = 32 otherwise, so its
// rows lie in one bm-row tile and belong to one expert: a 64-row block
// reads W[e] once for 64 rows, so wider expert tiles halve the weight
// traffic, as they do on the TPU.  BN is 128 columns, or 64 where a grid of
// 128-column blocks would have fewer blocks than the card's 132 SMs
// (kernels/gmm.py:block_cols; the wrapper passes it).  A block has BM BN /
// 1024 warps; warp w computes the 32 x 32 sub-tile at rows 32 (w / (BN /
// 32)), columns 32 (w % (BN / 32)), and lane (r, c) = (lane / 8, lane % 8)
// holds rows r + 4i (i < 8) and columns 4c .. 4c+3 of it in registers.  K
// is walked in steps of 16 through a three-stage cp.async ring of (BM, 16)
// X tiles, row-major with a padded row of 20 floats, and (16, BN) W tiles:
// per 4 steps of K a lane reads 8 rows of X and 4 rows of W, 16 bytes each,
// for 128 FMAs, and the 4 rows or 8 column chunks one load instruction
// reads fill 32 different banks.  Raster: the blocks of a group of 8
// consecutive row blocks sweep the column slices, the group's row blocks
// of one slice next to each other, so the row blocks of one expert read
// each W slice at about the same time and all but the first find it in L2
// (W is read from memory about once), while the group's rows of X stay in
// L2 across the slices.  Who reads what (lane l of warp w copies the
// 16-byte chunks of the warp's part of each staged tile): warp w stages
// rows BM/W*w .. BM/W*(w+1) - 1 of every X tile and columns BN/W*w ..
// BN/W*(w+1) - 1 of every W tile (W warps), and stores its 32 x 32
// sub-tile of O (kernels/gmm.py:gmm_spec describes exactly this).  Rows
// that are not 16-byte aligned (K or N not a multiple of 4, or a base
// pointer off 16 bytes) are staged with 4-byte copies and stored with
// 4-byte stores by the same lanes; edges in K and N are zero-filled.  A
// block whose id is out of [0, E) reads no weights and stores zeros.  What
// is left to the card's float32 peak: the 12 shared loads per 128 FMAs
// take issue slots, and at bm 32 a block's 32 rows bound the reuse of each
// staged W row.
//
// bfloat16: gmm_tc_kernel, on the tensor cores (mma.sync m16n8k16, float32
// accumulators; helpers in mma.cuh).  First gmm_plan_kernel cuts every run
// of consecutive bm-row tiles with one id into chunks of up to 128 rows
// from the run's first row (plan_groups makes each expert's tiles one
// run), so that no chunk mixes experts.  Then a block of 128 threads (4
// warps) owns a chunk and 128 columns of O; warp w a 64 x 64 sub-tile
// (rows 64 (w / 2), columns 64 (w % 2)) of 4 x 8 m16n8 accumulators.  K is
// walked in steps of 64 through a three-stage cp.async ring of (128, 64) X
// tiles and (64, 128) W tiles (96 KB: two blocks an SM), swizzled for
// ldmatrix (mma.cuh:swz); W is (K, N) row-major, so its B fragments come
// by the transposed ldmatrix.  A tile wholly inside X or W is copied by
// stage_tile_full, without per-chunk index arithmetic.  The m-tiles of a
// warp past the chunk's last row neither load nor multiply (a warp whose
// four m-tiles are all in the chunk takes a path without branches).  A
// chunk whose id is out of [0, E) writes zeros.  Raster: the blocks of a
// group of 8 consecutive chunks sweep the 128-column slices, the group's
// chunks of one slice next to each other, so the chunks of one expert read
// the same W tiles at about the same time and all but the first find them
// in L2, while the group's rows of X stay in L2 across the slices.  O goes
// out as bf16 through shared memory with 16-byte stores.  Who reads what
// (thread t copies 16-byte chunks t, t + 128, ... of each staged tile; warp
// w stores rows 32w .. 32w+31 of the chunk): kernels/gmm.py:gmm_spec with
// dtype bfloat16 describes exactly this.  Rows
// that are not 16-byte aligned (K or N not a multiple of 8) are staged and
// stored with 2-byte accesses by the same threads; edges in M, K and N are
// zero-filled.  What is left to the card's peak: wgmma, TMA and a
// persistent, warp-specialised schedule.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBK = 16;       // depth of a staged step
constexpr int kStages = 3;    // the cp.async ring
constexpr int kXLd = kBK + 4; // padded row of a staged X tile
constexpr int kRaster = 8;    // row blocks a raster group

template <int BM, int BN>
__global__ void __launch_bounds__(BM * BN / 32, 16384 / (BM * BN))
gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const int* __restrict__ ids, float* __restrict__ o, int m, int k, int n,
           int e, int bm, int vec_x, int vec_w, int vec_o) {
  constexpr int kWN = BN / 32;            // warps across the block's columns
  constexpr int kWarps = BM / 32 * kWN;   // each: 32 x 32 of O
  constexpr int kXRows = BM / kWarps;     // X tile rows each warp stages
  constexpr int kXPer = kXRows * 4 / 32;  // ... 16-byte chunks a lane
  constexpr int kWCols = BN / kWarps;     // W tile columns each warp stages
  constexpr int kWC = kWCols / 4;         // ... in 16-byte chunks
  constexpr int kWRows = 32 / kWC;        // W tile rows a warp copies at once
  __shared__ __align__(16) float xs[kStages][BM][kXLd];
  __shared__ __align__(16) float ws[kStages][kBK][BN];

  // raster: groups of kRaster row blocks, each group sweeping the column
  // slices with its row blocks of one slice next to each other
  const int row_blocks = m / BM;
  const int col_blocks = (n + BN - 1) / BN;
  const int first = blockIdx.x / (kRaster * col_blocks) * kRaster;
  const int size = min(kRaster, row_blocks - first);
  const int in_group = blockIdx.x - first * col_blocks;
  const int row0 = (first + in_group % size) * BM;
  const int col0 = in_group / size * BN;
  const int expert = ids[row0 / bm];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wr = 32 * (warp / kWN);  // the warp's sub-tile of O
  const int wc = 32 * (warp % kWN);
  const int rg = lane / 8;           // rows wr + rg + 4i, columns wc + 4cg ..
  const int cg = lane % 8;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  if (expert >= 0 && expert < e) {
    const float* xb = x + (size_t)row0 * k;
    const float* wb = w + (size_t)expert * k * n;
    const int nk = (k + kBK - 1) / kBK;
    auto stage = [&](int slot, int kt) {
      const int k0 = kt * kBK;
#pragma unroll
      for (int s = 0; s < kXPer; ++s) {  // X: rows kXRows w + lane / 4 + 8s, chunk lane % 4
        const int r = kXRows * warp + lane / 4 + 8 * s;
        const int c = 4 * (lane % 4);
        const float* src = xb + (size_t)r * k + k0 + c;
        if (vec_x) {
          const bool in = k0 + c < k;
          cp_async16(smem_u32(&xs[slot][r][c]), in ? src : xb, in ? 16 : 0);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = k0 + c + j < k;
            cp_async4(smem_u32(&xs[slot][r][c + j]), in ? src + j : xb, in ? 4 : 0);
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kBK / kWRows; ++s) {  // W: rows lane / kWC + kWRows s
        const int r = lane / kWC + kWRows * s;
        const int c = kWCols * warp + 4 * (lane % kWC);
        const bool row_in = k0 + r < k;
        const float* src = wb + (size_t)(k0 + r) * n + col0 + c;
        if (vec_w) {
          const bool in = row_in && col0 + c < n;
          cp_async16(smem_u32(&ws[slot][r][c]), in ? src : wb, in ? 16 : 0);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = row_in && col0 + c + j < n;
            cp_async4(smem_u32(&ws[slot][r][c + j]), in ? src + j : wb, in ? 4 : 0);
          }
        }
      }
    };
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nk) stage(st, st);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<kStages - 2>();  // step kt has landed
      __syncthreads();               // ... for every thread; step kt - 1 is done
      if (kt + kStages - 1 < nk) stage((kt + kStages - 1) % kStages, kt + kStages - 1);
      cp_async_commit();
      const int slot = kt % kStages;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 4) {
        float a[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float4 a4 = *reinterpret_cast<const float4*>(&xs[slot][wr + rg + 4 * i][kk]);
          a[i][0] = a4.x;
          a[i][1] = a4.y;
          a[i][2] = a4.z;
          a[i][3] = a4.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 b = *reinterpret_cast<const float4*>(&ws[slot][kk + q][wc + 4 * cg]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            acc[i][0] = fmaf(a[i][q], b.x, acc[i][0]);
            acc[i][1] = fmaf(a[i][q], b.y, acc[i][1]);
            acc[i][2] = fmaf(a[i][q], b.z, acc[i][2]);
            acc[i][3] = fmaf(a[i][q], b.w, acc[i][3]);
          }
        }
      }
    }
    cp_async_wait<0>();
  }

  const int gc = col0 + wc + 4 * cg;
  if (gc >= n) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float* dst = o + (size_t)(row0 + wr + rg + 4 * i) * n + gc;
    if (vec_o) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
      dst[0] = acc[i][0];
      if (gc + 1 < n) dst[1] = acc[i][1];
      if (gc + 2 < n) dst[2] = acc[i][2];
      if (gc + 3 < n) dst[3] = acc[i][3];
    }
  }
}

template <int BM, int BN>
int launch(const void* x, const void* w, const void* ids, void* o, int m,
           int k, int n, int e, int bm, cudaStream_t stream) {
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int blocks = m / BM * ((n + BN - 1) / BN);
  gmm_kernel<BM, BN><<<blocks, BM * BN / 32, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(ids), static_cast<float*>(o), m, k, n, e, bm,
      k % 4 == 0 && al(x), n % 4 == 0 && al(w), n % 4 == 0 && al(o));
  return static_cast<int>(cudaGetLastError());
}

// bn: 128, or 64 where the 128-column grid leaves SMs idle
// (kernels/gmm.py:block_cols)
int dispatch(const void* x, const void* w, const void* ids, void* o, int m,
             int k, int n, int e, int bm, int bn, cudaStream_t s) {
  if (bn != 64 && bn != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (bm % 64 == 0) {
    if (bn == 128) return launch<64, 128>(x, w, ids, o, m, k, n, e, bm, s);
    return launch<64, 64>(x, w, ids, o, m, k, n, e, bm, s);
  }
  if (bn == 128) return launch<32, 128>(x, w, ids, o, m, k, n, e, bm, s);
  return launch<32, 64>(x, w, ids, o, m, k, n, e, bm, s);
}

// ---------------------------------------------------------------------------
// bfloat16: the products on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcBM = 128;       // rows of O a block
constexpr int kTcBN = 128;       // columns of O a block
constexpr int kTcBK = 64;        // depth of a staged step
constexpr int kTcStages = 3;     // the cp.async ring
constexpr int kTcThreads = 128;  // 4 warps, each 64 x 64 of O
constexpr int kCX = kTcBK / 8;   // 16-byte chunks of an X tile row
constexpr int kCW = kTcBN / 8;   // ... of a W tile row
constexpr size_t kTcSmem = sizeof(bf16) * kTcStages * (kTcBM * kTcBK + kTcBK * kTcBN);
static_assert(kTcSmem >= sizeof(bf16) * kTcBM * kTcBN, "the O tile reuses the ring");

constexpr int kPlanThreads = 1024;
constexpr int kGroup = 8;  // chunks a raster group (their X rows: 8 x 1 MB at K 4096)

// inclusive scan of v over the block's kPlanThreads threads with op;
// tmp holds 32 ints of shared memory
template <typename Op>
__device__ int block_scan(int v, Op op, int* tmp) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int u = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v = op(v, u);
  }
  if (lane == 31) tmp[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int t = tmp[lane];
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const int u = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t = op(t, u);
    }
    tmp[lane] = t;
  }
  __syncthreads();
  if (warp > 0) v = op(v, tmp[warp - 1]);
  __syncthreads();  // tmp is free again
  return v;
}

// The chunks of the product: every run of consecutive bm-row tiles with
// one id is cut into pieces of up to kTcBM rows from its first row, and
// chunk c is (first row, id) at plan[1 + 2c], plan[2 + 2c], in row order;
// plan[0] is their count.  One block of kPlanThreads threads, tile i of each
// segment of kPlanThreads tiles to thread i % kPlanThreads: a max-scan finds
// the first tile of i's run, a sum-scan places the chunks that start in i.
__global__ void __launch_bounds__(kPlanThreads)
gmm_plan_kernel(const int* __restrict__ ids, int n_tiles, int bm, int* __restrict__ plan) {
  __shared__ int tmp[32];
  __shared__ int carry[2];
  int carry_start = 0;  // the first tile of the run the last segment ended in
  int carry_count = 0;  // chunks placed so far
  const auto max_op = [](int a, int b) { return a > b ? a : b; };
  const auto sum_op = [](int a, int b) { return a + b; };
  for (int base = 0; base < n_tiles; base += kPlanThreads) {
    const int i = base + threadIdx.x;
    const bool in = i < n_tiles;
    const int ex = in ? ids[i] : 0;
    const bool first = in && (i == 0 || ids[i - 1] != ex);
    const int run_start = block_scan(first ? i : carry_start, max_op, tmp);
    const int run_row = run_start * bm;
    // chunk starts run_row + kTcBM j inside this tile's rows [i bm, (i+1) bm)
    const int j0 = (i * bm - run_row + kTcBM - 1) / kTcBM;
    const int j1 = ((i + 1) * bm - run_row + kTcBM - 1) / kTcBM;
    const int cnt = in ? j1 - j0 : 0;
    const int incl = block_scan(cnt, sum_op, tmp);
    int pos = carry_count + incl - cnt;
    for (int j = j0; j < j0 + cnt; ++j, ++pos) {
      plan[1 + 2 * pos] = run_row + kTcBM * j;
      plan[2 + 2 * pos] = ex;
    }
    if (threadIdx.x == kPlanThreads - 1) {
      carry[0] = run_start;
      carry[1] = carry_count + incl;
    }
    __syncthreads();
    carry_start = carry[0];
    carry_count = carry[1];
    __syncthreads();
  }
  if (threadIdx.x == 0) plan[0] = carry_count;
}

__global__ void __launch_bounds__(kTcThreads)
gmm_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
              const int* __restrict__ ids, const int* __restrict__ plan,
              bf16* __restrict__ o, int m, int k, int n, int e, int bm, int slots,
              int vec_x, int vec_w, int vec_o) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* xs = reinterpret_cast<bf16*>(tc_smem);  // [stages][BM][BK]
  bf16* ws = xs + kTcStages * kTcBM * kTcBK;    // [stages][BK][BN]

  // raster: the blocks of a group of kGroup consecutive chunks sweep the
  // column slices, the group's chunks of one slice next to each other: the
  // chunks of one expert read each W tile at about the same time, and the
  // group's rows of X stay in L2 while the slices pass
  const int col_blocks = (n + kTcBN - 1) / kTcBN;
  const int in_group = blockIdx.x % (kGroup * col_blocks);
  const int slot = blockIdx.x / (kGroup * col_blocks) * kGroup + in_group % kGroup;
  const int col0 = in_group / kGroup * kTcBN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wr = 64 * (warp / 2);  // this warp's rows and columns in the tile
  const int wc = 64 * (warp % 2);
  const int nk = (k + kTcBK - 1) / kTcBK;
  const bool w_inside = vec_w && col0 + kTcBN <= n;
  const int count = plan[0];

  for (int chunk = slot; chunk < count; chunk += slots) {
    const int row0 = plan[1 + 2 * chunk];
    const int ex = plan[2 + 2 * chunk];
    // the chunk's rows: up to kTcBM, while the run of its id lasts
    int row_end = min(row0 + kTcBM, m);
    for (int t = row0 / bm + 1; t * bm < row_end; ++t) {
      if (ids[t] != ex) row_end = t * bm;
    }
    const int rows = row_end - row0;
    const bf16* xb = x + (size_t)row0 * k;
    const bool x_inside = vec_x && rows == kTcBM;  // else rows past the chunk are zero

    float acc[4][8][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
      }
    }

    if (ex >= 0 && ex < e) {  // else no weights: the rows are zero
      bool mine[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) mine[i] = wr + 16 * i < rows;
      const bool all_rows = mine[0] && mine[1] && mine[2] && mine[3];
      const bf16* wb = w + (size_t)ex * k * n + col0;
      auto stage = [&](int ring_slot, int kt) {
        const int k0 = kt * kTcBK;
        bf16* xt = xs + ring_slot * kTcBM * kTcBK;
        bf16* wt = ws + ring_slot * kTcBK * kTcBN;
        if (x_inside && k0 + kTcBK <= k) {
          stage_tile_full<kCX, kTcBM, kTcThreads>(xt, xb + k0, k, tid);
        } else {
          stage_tile<kCX>(xt, xb + k0, kTcBM, k, rows, k - k0, vec_x != 0, tid, kTcThreads);
        }
        if (w_inside && k0 + kTcBK <= k) {
          stage_tile_full<kCW, kTcBK, kTcThreads>(wt, wb + (size_t)k0 * n, n, tid);
        } else {
          stage_tile<kCW>(wt, wb + (size_t)k0 * n, kTcBK, n, k - k0, n - col0, vec_w != 0, tid,
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
        const int ring_slot = kt % kTcStages;
        const uint32_t xbase = smem_u32(xs + ring_slot * kTcBM * kTcBK);
        const uint32_t wbase = smem_u32(ws + ring_slot * kTcBK * kTcBN);
        // all four m-tiles of the warp in the chunk: a loop without
        // branches; else only the chunk's m-tiles load A and multiply
        auto products = [&](auto tag) {
          constexpr bool kAll = decltype(tag)::value;
#pragma unroll
          for (int ks = 0; ks < kTcBK / 16; ++ks) {
            uint32_t af[4][4];
            uint32_t bfr[8][2];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (!kAll && !mine[i]) continue;
              const int r = wr + 16 * i + lane % 16;
              ldmatrix_x4(af[i], xbase + swz_offset<kCX>(r, ks * 16 + (lane / 16) * 8));
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              uint32_t b[4];
              const int kr = ks * 16 + ((lane / 8) & 1) * 8 + lane % 8;
              ldmatrix_x4_trans(b, wbase + swz_offset<kCW>(kr, wc + jj * 16 + (lane / 16) * 8));
              bfr[2 * jj][0] = b[0];
              bfr[2 * jj][1] = b[1];
              bfr[2 * jj + 1][0] = b[2];
              bfr[2 * jj + 1][1] = b[3];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (!kAll && !mine[i]) continue;
#pragma unroll
              for (int j = 0; j < 8; ++j) mma_bf16_16816(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
            }
          }
        };
        if (all_rows) {
          products(std::true_type{});
        } else {
          products(std::false_type{});
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // the ring is free for O
    }

    // O as bf16 into shared memory (the ring), then warp w stores rows
    // 32w .. 32w+31 of the chunk with 16-byte stores
    unsigned char* ob = tc_smem;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = wr + 16 * i + lane / 4;
        const int col = wc + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<uint32_t*>(ob + swz_offset<kCW>(r, col)) =
            pack_bf16(acc[i][j][0], acc[i][j][1]);
        *reinterpret_cast<uint32_t*>(ob + swz_offset<kCW>(r + 8, col)) =
            pack_bf16(acc[i][j][2], acc[i][j][3]);
      }
    }
    __syncthreads();
    for (int i = lane; i < 32 * kCW; i += 32) {
      const int r = 32 * warp + i / kCW;
      const int c = i % kCW;
      const int gc = col0 + 8 * c;
      if (r >= rows || gc >= n) continue;
      const unsigned char* src = ob + (r * kCW + swz<kCW>(r, c)) * 16;
      bf16* dst = o + (size_t)(row0 + r) * n + gc;
      if (vec_o) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        const bf16* vals = reinterpret_cast<const bf16*>(src);
        for (int c2 = 0; c2 < 8 && gc + c2 < n; ++c2) dst[c2] = vals[c2];
      }
    }
    __syncthreads();  // O is out of the ring before the next chunk fills it
  }
}

int launch_tc(const void* x, const void* w, const void* ids, void* plan, void* o,
              int m, int k, int n, int e, int bm, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gmm_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTcSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = m / bm;
  gmm_plan_kernel<<<1, kPlanThreads, 0, stream>>>(static_cast<const int*>(ids), n_tiles, bm,
                                                  static_cast<int*>(plan));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // a block slot for every chunk when the ids come from plan_groups (one
  // run an expert, one more of ids out of range), in whole raster groups;
  // more chunks loop
  int slots = (m + kTcBM - 1) / kTcBM + min(n_tiles, e + 1);
  slots = (slots + kGroup - 1) / kGroup * kGroup;
  const int col_blocks = (n + kTcBN - 1) / kTcBN;
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  gmm_tc_kernel<<<slots * col_blocks, kTcThreads, kTcSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const int*>(ids), static_cast<const int*>(plan), static_cast<bf16*>(o),
      m, k, n, e, bm, slots, k % 8 == 0 && al(x), n % 8 == 0 && al(w), n % 8 == 0 && al(o));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32, 1 = bfloat16; ids
// are int32 on the device, one per bm-row tile.  plan is int32 scratch on
// the device for the bfloat16 route, 1 + 2 (ceil(m / 128) + m / bm) ints
// (kernels/gmm.py:plan_ints), and unused in float32; bn is the float32
// route's block width, 64 or 128 (kernels/gmm.py:block_cols), and unused in
// bfloat16.
extern "C" {

int repro_gmm(const void* x, const void* w, const void* ids, void* plan, void* o,
              int m, int k, int n, int e, int bm, int bn, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch(x, w, ids, o, m, k, n, e, bm, bn, s);
  return launch_tc(x, w, ids, plan, o, m, k, n, e, bm, s);
}

}  // extern "C"
