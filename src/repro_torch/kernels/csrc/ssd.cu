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
// be NaN.  The kernels launch on the caller's stream, allocate nothing and
// do not synchronise; the entry point returns cudaGetLastError() right
// after its launch.
//
// Blocks.  A cell is cut into ceil(L/64) row tiles of 64 rows of y and
// ceil(P/64) x ceil(N/64) state units of 64 x 64 elements of s, one block
// each, all in one 1-D launch: block b serves cell b / (units + tiles) and,
// within it, role b % (units + tiles): the state units first, then the row
// tiles last-first (a cell's longest walks start first, and its blocks sit
// side by side, so its x and B are re-read from L2).  Every block takes the
// cumulative sum of a itself (warp 0: each lane a run of ceil(L/32) steps,
// then a shuffle scan of the runs), the same float32 sums in the same order
// in every block; a state block also forms the end-state decays
// w[t] = exp(cum[L-1] - cum[t]).  The row tile of rows i0 .. i0+63 stages
// those rows of C once and walks the 64-row tiles of B and x up to the
// diagonal through a ring of two stages: the next tile's cp.async copies
// are in flight while this tile's products run (float32 takes one stage
// where two would keep a second block off the SM, as at Mamba2-2.7b's
// chunk: then the SM's other block computes while this one copies).  A
// state block walks every tile of x and B through the same ring.  Rows,
// keys and steps past L are staged as zeros, their cum and w are 0, and
// they are masked.  Element
// (r, c) of a staged tile is copied by the thread that owns its 16-byte
// chunk: chunk k of a tile of W/E chunks a row (E = 4 floats or 8 bf16) is
// row k / (W/E), and thread t of the block copies chunks t, t + threads, ...
// (kernels/ssd.py:ssd_chunk_spec describes these loads and the stores warp
// by warp).  There are no atomics: a second call gives the same bits.
//
// float32: ssd_chunk_kernel<PC>, on the CUDA cores (TF32 keeps about three
// digits, and the tolerance is 3e-5 of max|y|).  256 threads, (ty, tx) =
// (tid / 16, tid % 16).  Per tile, thread (ty, tx) forms the 4 x 4 score
// micro-tile of rows 4ty .. 4ty+3 and keys tx, tx+16, tx+32, tx+48 from
// float4 reads of C and B (8 shared loads for 64 multiply-adds), applies
// the masked decay and parks it transposed, key-major, in shared memory;
// then it accumulates its 4 x PC micro-tile of y (columns 4tx .. 4tx+3 of
// each 64, or 2tx, 2tx+1, or tx where P <= 32) from a float4 of scores and
// PC/4 float4 of x per key (2 loads for 16 multiply-adds at P 64).  Row
// strides are padded so that these loads are free of bank conflicts.  A
// state unit's threads take 4 x 4 micro-tiles of s, and when the unit has
// fewer than 256 of them the steps t are split over G = 256 / T groups of
// T threads whose sums are added in a fixed order at the end.
//
// bfloat16: ssd_tc_kernel<PP, NH>, on the tensor cores (mma.sync m16n8k16,
// float32 accumulators; helpers in mma.cuh).  128 threads, 4 warps; warp w
// owns rows 16w .. 16w+15 of its row tile.  N is zero-filled up to a
// multiple of 16 and P up to PP (16, 32, 64 or 128); rows are padded by 8
// elements (16 bytes), which keeps ldmatrix free of bank conflicts for any
// width.  The warp holds C's A fragments in registers, as many k-steps as N
// needs (a template parameter: 1, 2, 4 or 8; past N = 128 it reloads them
// per group of 8), and takes each staged tile in chunks of 16 keys,
// skipping the chunks above its diagonal: S = C B^T on the tensor cores (B
// through ldmatrix, as flash's K), the masked decay applied to the
// accumulator fragment in registers (exp2f of the difference times log2 e:
// a few ulp of float32, far inside the bf16 round that follows), S rounded
// to bf16 straight into the A fragments of S x (the Pallas kernel's round),
// and x through the transposed ldmatrix (as flash's V).  A state unit's warp w owns rows
// 16w .. 16w+15 of the unit's 64 p: (x w)^T comes through the transposed
// ldmatrix of x, each pair scaled by w in float32 and rounded to bf16 in
// registers (the Pallas kernel's round), times B through the transposed
// ldmatrix.
//
// Bound on an H100 SXM at Jamba's widths, (BH, C, L, P, N) =
// (128, 16, 256, 64, 16): the causal half of the two products,
// L(L+1)/2 * 2(N + P) per cell, and the 2 L P N of the state are 11.9 GFLOP,
// 0.18 ms at the CUDA cores' float32 rate (67 TFLOP/s) and 0.012 ms at the
// tensor cores' bf16 rate (989 TFLOP/s), against 346 MB of inputs and
// outputs in float32 (0.10 ms at 3.35 TB/s) and 244 MB in bf16 (0.073 ms,
// the float32 y and s dominate): the arithmetic bounds float32, the bytes
// bf16.
//
// Shared memory (kernels/ssd.py:smem_bytes): float32, the ring's B and x
// (stages x 64 x (ldn + 16 PC) floats, ldn = N rounded up to 4, plus 4
// where that is a multiple of 8), C's rows (64 x ldn), the key-major scores
// (64 x 68) and cum and w (2 x 64 ceil(L/64)): 66 KB for Jamba's chunk (two
// stages) and 101 KB for Mamba2-2.7b's (L 256, P 64, N 128; one stage).
// bf16: the ring's B and x (2 x 64 x (np + 8 + PP + 8) bf16, np = N rounded
// up to 16), C's rows (64 x (np + 8)) and cum and w: 29 KB and 71 KB.  Above the 48 KB a block
// gets by default the launch opts in with cudaFuncSetAttribute first; the
// wrapper refuses shapes above the 227 KB a block can have.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;         // rows of a row tile; keys or steps of a staged tile
constexpr int kUnit = 64;         // a state unit's extent in p and in n
constexpr int kF32Threads = 256;  // float32: 16 x 16 threads
constexpr int kTcThreads = 128;   // bfloat16: 4 warps of 16 rows
constexpr int kLdS = kTile + 4;   // the float32 scores' row stride (17 chunks)
constexpr float kLog2e = 1.4426950408889634f;
// the most shared memory a block may take for two to share an SM: 2 x
// (bytes + the 1 KB the runtime reserves a block) <= the SM's 228 KB
constexpr size_t kTwoBlocksSmem = 115712;

// float32 row stride of B and C: N rounded up to 4, with an odd count of
// 16-byte chunks (consecutive rows fall on distinct banks)
__host__ __device__ inline int f32_ldn(int n) {
  const int n4 = (n + 3) & ~3;
  return (n4 & 7) ? n4 : n4 + 4;
}

__host__ __device__ inline int tiles_of(int l) { return (l + kTile - 1) / kTile; }

__host__ __device__ inline int units_of(int p, int n) {
  return ((p + kUnit - 1) / kUnit) * ((n + kUnit - 1) / kUnit);
}

// Stage `rows` x `width` elements of a row-major source (ld_src a row) into a
// shared tile of row stride `ld`: thread t of `threads` copies the 16-byte
// chunks t, t + threads, ... (chunk k is row k / (width / E)).  Row r is
// read when r < valid_rows, and its elements c < valid_cols; the rest is
// zero.  With `vec` (valid_cols a multiple of E, rows 16-byte aligned) a
// chunk is one cp.async, else E scalar loads stored at once.
template <typename T>
__device__ __forceinline__ void stage_rows(T* tile, int ld, const T* src, long long ld_src,
                                           int rows, int width, int valid_rows,
                                           int valid_cols, bool vec, int tid, int threads) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = width / E;
  for (int k = tid; k < rows * cpr; k += threads) {
    const int r = k / cpr;
    const int col = (k - r * cpr) * E;
    const bool live = r < valid_rows && col < valid_cols;
    T* dst = tile + r * ld + col;
    if (vec) {
      cp_async16(smem_u32(dst), live ? src + r * ld_src + col : src, live ? 16 : 0);
    } else {
      __align__(16) T v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[e] = (live && col + e < valid_cols) ? src[r * ld_src + col + e] : from_float<T>(0.f);
      }
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// Warp 0's cumulative sum of the cell's a into cum[0, L), zero up to lpad;
// with `wdec`, also w[t] = exp(cum[L-1] - cum[t]) (zero past L).
template <typename T>
__device__ void chunk_cumsum(const T* ag, float* cum, float* wdec, int l, int lpad, int lane) {
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
  for (int i = l + lane; i < lpad; i += 32) cum[i] = 0.f;
  if (wdec != nullptr) {
    __syncwarp();
    const float clast = cum[l - 1];
    for (int i = lo; i < hi; ++i) wdec[i] = expf(clast - cum[i]);
    for (int i = l + lane; i < lpad; i += 32) wdec[i] = 0.f;
  }
}

// What one block of a launch serves.
struct Role {
  size_t cell;
  bool state;
  int index;  // the state unit, or the row tile
};

__device__ __forceinline__ Role role_of(int l, int p, int n) {
  const int tiles = tiles_of(l);
  const int units = units_of(p, n);
  const int nb = units + tiles;
  const int r = static_cast<int>(blockIdx.x % nb);
  Role role;
  role.cell = blockIdx.x / nb;
  role.state = r < units;
  role.index = role.state ? r : tiles - 1 - (r - units);
  return role;
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

template <int PC>  // y columns a thread: P <= 16 PC
__global__ void __launch_bounds__(kF32Threads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ a,
                 const float* __restrict__ bmat, const float* __restrict__ cmat,
                 float* __restrict__ y, float* __restrict__ s, int l, int p, int n,
                 int vec_x, int vec_bc, int stages) {
  constexpr int PW = 16 * PC;  // staged x columns
  extern __shared__ __align__(16) float smem[];
  const int ldn = f32_ldn(n);
  const int n4 = (n + 3) & ~3;
  const int tiles = tiles_of(l);
  const int lpad = tiles * kTile;
  const int ring = stages - 1;           // stage of tile t: t & ring
  float* bs0 = smem;                     // [stages][kTile][ldn]
  float* xs0 = bs0 + stages * kTile * ldn;  // [stages][kTile][PW]
  float* cs = xs0 + stages * kTile * PW;    // [kTile][ldn]: the row tile's C
  float* ss = cs + kTile * ldn;          // [kTile][kLdS]: scores, key-major
  float* cum = ss + kTile * kLdS;        // [lpad]
  float* wdec = cum + lpad;              // [lpad]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const Role role = role_of(l, p, n);
  const float* xg = x + role.cell * l * p;
  const float* bg = bmat + role.cell * l * n;
  const bool vx = vec_x != 0;
  const bool vbc = vec_bc != 0;

  auto stage = [&](int t) {
    const int rows = l - t * kTile;
    stage_rows<float>(bs0 + (t & ring) * kTile * ldn, ldn, bg + (size_t)t * kTile * n, n,
                      kTile, n4, rows, n, vbc, tid, kF32Threads);
    stage_rows<float>(xs0 + (t & ring) * kTile * PW, PW, xg + (size_t)t * kTile * p, p,
                      kTile, PW, rows, p, vx, tid, kF32Threads);
  };

  if (role.state) {
    // s over the unit (p0 .. p0+63, n0 .. n0+63): T threads of 4 x 4, G groups
    const int units_n = (n + kUnit - 1) / kUnit;
    const int p0 = (role.index / units_n) * kUnit;
    const int n0 = (role.index % units_n) * kUnit;
    const int tn = (min(kUnit, n - n0) + 3) / 4;
    const int tp = (min(kUnit, p - p0) + 3) / 4;
    const int T = tp * tn;
    const int G = kF32Threads / T;
    const int g = tid / T;
    const int e = tid % T;
    const int pa = p0 + 4 * (e / tn);
    const int nb = n0 + 4 * (e % tn);
    stage(0);
    cp_async_commit();
    if (tid < 32) chunk_cumsum(a + role.cell * l, cum, wdec, l, lpad, lane);
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[q][r] = 0.f;
    }
    for (int t = 0; t < tiles; ++t) {
      if (ring && t + 1 < tiles) stage(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const float* bs = bs0 + (t & ring) * kTile * ldn;
      const float* xs = xs0 + (t & ring) * kTile * PW;
      const int steps = min(kTile, l - t * kTile);
      if (g < G) {
        for (int tt = g; tt < steps; tt += G) {
          const float w = wdec[t * kTile + tt];
          const float4 xv = *reinterpret_cast<const float4*>(xs + tt * PW + pa);
          const float4 bv = *reinterpret_cast<const float4*>(bs + tt * ldn + nb);
          const float xw[4] = {round_to<float>(xv.x * w), round_to<float>(xv.y * w),
                               round_to<float>(xv.z * w), round_to<float>(xv.w * w)};
          const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[q][r] += xw[q] * bb[r];
          }
        }
      }
      __syncthreads();
      if (!ring && t + 1 < tiles) {  // one stage: the next tile once this one is done
        stage(t + 1);
        cp_async_commit();
      }
    }
    // the groups' partial sums, added in group order
    float* red = ss;  // [G][T][16], at most 4096 floats
    if (g < G) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int r = 0; r < 4; ++r) red[(g * T + e) * 16 + q * 4 + r] = acc[q][r];
      }
    }
    __syncthreads();
    if (tid < T) {
      float* sg = s + role.cell * p * n;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float v = 0.f;
          for (int gg = 0; gg < G; ++gg) v += red[(gg * T + tid) * 16 + q * 4 + r];
          if (pa + q < p && nb + r < n) sg[(size_t)(pa + q) * n + nb + r] = v;
        }
      }
    }
    return;
  }

  // a row tile: rows i0 .. i0+63 of y
  const int i0 = role.index * kTile;
  const int ty = tid / 16;
  const int tx = tid % 16;
  stage_rows<float>(cs, ldn, cmat + role.cell * l * n + (size_t)i0 * n, n, kTile, n4, l - i0,
                    n, vbc, tid, kF32Threads);
  stage(0);
  cp_async_commit();
  if (tid < 32) chunk_cumsum(a + role.cell * l, cum, nullptr, l, lpad, lane);
  float acc[4][PC];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < PC; ++q) acc[r][q] = 0.f;
  }
  const int row_last = i0 + 4 * ty + 3;  // this thread's last row
  const int n_tiles = role.index + 1;
  for (int t = 0; t < n_tiles; ++t) {
    if (ring && t + 1 < n_tiles) stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* bs = bs0 + (t & ring) * kTile * ldn;
    const float* xs = xs0 + (t & ring) * kTile * PW;
    const int j0 = t * kTile;
    // scores: rows 4ty + r, keys tx + 16c
    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
    }
    for (int k = 0; k < n4; k += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        cv[r] = *reinterpret_cast<const float4*>(cs + (4 * ty + r) * ldn + k);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bv[c] = *reinterpret_cast<const float4*>(bs + (tx + 16 * c) * ldn + k);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float v = sc[r][c];
          v += cv[r].x * bv[c].x;
          v += cv[r].y * bv[c].y;
          v += cv[r].z * bv[c].z;
          v += cv[r].w * bv[c].w;
          sc[r][c] = v;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      const float cj = cum[j];
      float v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * ty + r;
        const bool keep = j <= i && i < l;  // masked before the exponential
        const float d = keep ? cum[i] - cj : 0.f;
        v[r] = keep ? round_to<float>(sc[r][c] * expf(d)) : 0.f;
      }
      *reinterpret_cast<float4*>(ss + (tx + 16 * c) * kLdS + 4 * ty) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    // y += scores x over the keys this thread's rows can see
    const int jn = min(min(kTile, l - j0), row_last - j0 + 1);
    for (int jj = 0; jj < jn; ++jj) {
      const float4 sv = *reinterpret_cast<const float4*>(ss + jj * kLdS + 4 * ty);
      float xv[PC];
      if constexpr (PC >= 4) {
#pragma unroll
        for (int gq = 0; gq < PC / 4; ++gq) {
          const float4 v4 = *reinterpret_cast<const float4*>(xs + jj * PW + 4 * tx + 64 * gq);
          xv[4 * gq] = v4.x;
          xv[4 * gq + 1] = v4.y;
          xv[4 * gq + 2] = v4.z;
          xv[4 * gq + 3] = v4.w;
        }
      } else if constexpr (PC == 2) {
        const float2 v2 = *reinterpret_cast<const float2*>(xs + jj * PW + 2 * tx);
        xv[0] = v2.x;
        xv[1] = v2.y;
      } else {
        xv[0] = xs[jj * PW + tx];
      }
      const float svr[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < PC; ++q) acc[r][q] += svr[r] * xv[q];
      }
    }
    __syncthreads();  // every thread is done with this stage and the scores
    if (!ring && t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_commit();
    }
  }
  float* yg = y + role.cell * l * p;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    if (i >= l) continue;
#pragma unroll
    for (int q = 0; q < PC; ++q) {
      const int col = PC >= 4 ? 4 * tx + 64 * (q / 4) + q % 4 : PC * tx + q;
      if (col < p) yg[(size_t)i * p + col] = acc[r][q];
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

// a pair of bf16 (t, t + 1 of one p) times (w0, w1) in float32, rounded back
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float w0, float w1) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&v);
  return pack_bf16(__low2float(h) * w0, __high2float(h) * w1);
}

// C's A fragments of k-steps k0 .. k0 + H - 1 (those below nk); `base` is
// this lane's ldmatrix row address at k-step 0
template <int H>
__device__ __forceinline__ void load_c_frags(uint32_t (&cf)[H][4], uint32_t base, int k0, int nk) {
#pragma unroll
  for (int kk = 0; kk < H; ++kk) {
    if (k0 + kk < nk) ldmatrix_x4(cf[kk], base + (k0 + kk) * 32);
  }
}

// PP: P zero-filled up to 16, 32, 64 or 128.  NH: k-steps of C's A
// fragments a warp holds in registers, the least of 1, 2, 4 and 8 that
// holds N / 16 (past 8 steps it reloads them per group of 8).
template <int PP, int NH>
__global__ void __launch_bounds__(kTcThreads)
ssd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ a,
              const bf16* __restrict__ bmat, const bf16* __restrict__ cmat,
              float* __restrict__ y, float* __restrict__ s, int l, int p, int n,
              int vec_x, int vec_bc) {
  constexpr int LDX = PP + 8;   // x row stride, bf16
  constexpr int kNT = PP / 8;   // n-tiles of y
  constexpr int kHold = NH;     // k-steps of C held in registers
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const int np = (n + 15) & ~15;
  const int ldn = np + 8;       // B and C row stride, bf16
  const int nk = np / 16;       // k-steps of S = C B^T
  const int tiles = tiles_of(l);
  const int lpad = tiles * kTile;
  bf16* bs0 = reinterpret_cast<bf16*>(tc_smem);  // [2][kTile][ldn]
  bf16* xs0 = bs0 + 2 * kTile * ldn;             // [2][kTile][LDX]
  bf16* cs = xs0 + 2 * kTile * LDX;              // [kTile][ldn]
  float* cum = reinterpret_cast<float*>(cs + kTile * ldn);  // [lpad]
  float* wdec = cum + lpad;                                 // [lpad]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q2 = 2 * (lane % 4);
  const Role role = role_of(l, p, n);
  const bf16* xg = x + role.cell * l * p;
  const bf16* bg = bmat + role.cell * l * n;
  const bool vx = vec_x != 0;
  const bool vbc = vec_bc != 0;

  auto stage = [&](int t) {
    const int rows = l - t * kTile;
    stage_rows<bf16>(bs0 + (t & 1) * kTile * ldn, ldn, bg + (size_t)t * kTile * n, n, kTile,
                     np, rows, n, vbc, tid, kTcThreads);
    stage_rows<bf16>(xs0 + (t & 1) * kTile * LDX, LDX, xg + (size_t)t * kTile * p, p, kTile,
                     PP, rows, p, vx, tid, kTcThreads);
  };

  if (role.state) {
    // s over the unit: warp w's rows p0 + 16w .. +15, n0 .. n0 + 8 ntn - 1
    const int units_n = (n + kUnit - 1) / kUnit;
    const int p0 = (role.index / units_n) * kUnit;
    const int n0 = (role.index % units_n) * kUnit;
    const int ntn = min(kUnit, np - n0) / 8;
    const int pw = p0 + 16 * warp;  // the warp's first row of s
    stage(0);
    cp_async_commit();
    if (warp == 0) chunk_cumsum(a + role.cell * l, cum, wdec, l, lpad, lane);
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    }
    for (int t = 0; t < tiles; ++t) {
      if (t + 1 < tiles) stage(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const uint32_t bbase = smem_u32(bs0 + (t & 1) * kTile * ldn);
      const uint32_t xbase = smem_u32(xs0 + (t & 1) * kTile * LDX);
      if (pw < p) {  // warp-uniform
#pragma unroll 1
        for (int ks = 0; ks < kTile / 16; ++ks) {
          const int tb = t * kTile + ks * 16;
          if (tb >= l) break;
          uint32_t af[4];  // (x w)^T: rows p, columns t
          ldmatrix_x4_trans(
              af, xbase + ((ks * 16 + lane % 8 + 8 * (lane / 16)) * LDX + pw +
                           8 * ((lane / 8) & 1)) * 2);
          const float2 w01 = *reinterpret_cast<const float2*>(wdec + tb + q2);
          const float2 w23 = *reinterpret_cast<const float2*>(wdec + tb + 8 + q2);
          af[0] = scale_pair(af[0], w01.x, w01.y);
          af[1] = scale_pair(af[1], w01.x, w01.y);
          af[2] = scale_pair(af[2], w23.x, w23.y);
          af[3] = scale_pair(af[3], w23.x, w23.y);
#pragma unroll
          for (int dn = 0; dn < 4; ++dn) {
            if (2 * dn < ntn) {
              uint32_t b[4];
              const int step = ks * 16 + ((lane / 8) & 1) * 8 + lane % 8;
              ldmatrix_x4_trans(b, bbase + (step * ldn + n0 + dn * 16 + (lane / 16) * 8) * 2);
              mma_bf16_16816(acc[2 * dn], af, b[0], b[1]);
              mma_bf16_16816(acc[2 * dn + 1], af, b[2], b[3]);
            }
          }
        }
      }
      __syncthreads();
    }
    if (pw < p) {
      float* sg = s + role.cell * p * n;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= ntn) continue;
        const int col = n0 + 8 * j + q2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = pw + g + 8 * h;
          if (row >= p) continue;
          if (col < n) sg[(size_t)row * n + col] = acc[j][2 * h];
          if (col + 1 < n) sg[(size_t)row * n + col + 1] = acc[j][2 * h + 1];
        }
      }
    }
    return;
  }

  // a row tile: rows i0 .. i0+63 of y, warp w's rows i0 + 16w .. +15
  const int i0 = role.index * kTile;
  stage_rows<bf16>(cs, ldn, cmat + role.cell * l * n + (size_t)i0 * n, n, kTile, np, l - i0, n,
                   vbc, tid, kTcThreads);
  stage(0);
  cp_async_commit();
  if (warp == 0) chunk_cumsum(a + role.cell * l, cum, nullptr, l, lpad, lane);
  const int row_a = i0 + 16 * warp + g;  // this lane's rows of the m16n8 layout
  const int row_b = row_a + 8;
  const int warp_first = i0 + 16 * warp;
  const int warp_last = warp_first + 15;
  const bool hold = nk <= kHold;
  const uint32_t cbase = smem_u32(cs) + ((16 * warp + lane % 16) * ldn + (lane / 16) * 8) * 2;
  uint32_t cf[kHold][4];
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }
  float cum_a = 0.f, cum_b = 0.f;
  const int n_tiles = role.index + 1;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) stage(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (t == 0) {
      cum_a = cum[row_a];
      cum_b = cum[row_b];
      if (hold) load_c_frags<kHold>(cf, cbase, 0, nk);
    }
    const uint32_t bbase = smem_u32(bs0 + (t & 1) * kTile * ldn);
    const uint32_t xbase = smem_u32(xs0 + (t & 1) * kTile * LDX);
#pragma unroll 1
    for (int kc = 0; kc < kTile / 16; ++kc) {
      const int kb = t * kTile + kc * 16;  // first key of the chunk
      if (kb > warp_last || kb >= l || warp_first >= l) continue;  // warp-uniform
      float sa[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[j][e] = 0.f;
      }
      for (int k0 = 0; k0 < nk; k0 += kHold) {
        if (!hold) load_c_frags<kHold>(cf, cbase, k0, nk);
#pragma unroll
        for (int kk = 0; kk < kHold; ++kk) {
          if (k0 + kk < nk) {
            uint32_t b[4];
            const int key = kc * 16 + (lane / 16) * 8 + lane % 8;
            ldmatrix_x4(b, bbase + (key * ldn + (k0 + kk) * 16 + ((lane / 8) & 1) * 8) * 2);
            mma_bf16_16816(sa[0], cf[kk], b[0], b[1]);
            mma_bf16_16816(sa[1], cf[kk], b[2], b[3]);
          }
        }
      }
      // the masked decay on the fragment, then S in bf16 as the A fragments
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 cj = *reinterpret_cast<const float2*>(cum + kb + 8 * j + q2);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = kb + 8 * j + q2 + e;
          const float ck = e ? cj.y : cj.x;
          const bool keep_a = key <= row_a && row_a < l;
          const bool keep_b = key <= row_b && row_b < l;
          const float da = keep_a ? cum_a - ck : 0.f;
          const float db = keep_b ? cum_b - ck : 0.f;
          sa[j][e] = keep_a ? sa[j][e] * exp2f(da * kLog2e) : 0.f;
          sa[j][2 + e] = keep_b ? sa[j][2 + e] * exp2f(db * kLog2e) : 0.f;
        }
      }
      uint32_t pf[4];
      pf[0] = pack_bf16(sa[0][0], sa[0][1]);
      pf[1] = pack_bf16(sa[0][2], sa[0][3]);
      pf[2] = pack_bf16(sa[1][0], sa[1][1]);
      pf[3] = pack_bf16(sa[1][2], sa[1][3]);
#pragma unroll
      for (int dn = 0; dn < kNT / 2; ++dn) {
        uint32_t b[4];
        const int key = kc * 16 + ((lane / 8) & 1) * 8 + lane % 8;
        ldmatrix_x4_trans(b, xbase + (key * LDX + dn * 16 + (lane / 16) * 8) * 2);
        mma_bf16_16816(acc[2 * dn], pf, b[0], b[1]);
        mma_bf16_16816(acc[2 * dn + 1], pf, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  float* yg = y + role.cell * l * p;
  const bool pair = (p & 1) == 0;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int col = 8 * j + q2;
    if (col >= p) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = h ? row_b : row_a;
      if (row >= l) continue;
      float* dst = yg + (size_t)row * p + col;
      if (pair) {
        *reinterpret_cast<float2*>(dst) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        dst[0] = acc[j][2 * h];
        if (col + 1 < p) dst[1] = acc[j][2 * h + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

size_t f32_smem_bytes(int l, int n, int pc, int stages) {
  const size_t ldn = f32_ldn(n);
  const size_t lpad = (size_t)tiles_of(l) * kTile;
  return sizeof(float) * ((stages + 1) * kTile * ldn + stages * kTile * 16 * (size_t)pc +
                          kTile * kLdS + 2 * lpad);
}

// float32's ring: two stages where two blocks an SM still fit beside them,
// else one (kernels/ssd.py:f32_stages)
int f32_stages(int l, int n, int pc) {
  return f32_smem_bytes(l, n, pc, 2) <= kTwoBlocksSmem ? 2 : 1;
}

size_t tc_smem_bytes(int l, int n, int pp) {
  const size_t ldn = ((n + 15) & ~15) + 8;
  const size_t lpad = (size_t)tiles_of(l) * kTile;
  return sizeof(bf16) * (3 * kTile * ldn + 2 * kTile * (size_t)(pp + 8)) +
         sizeof(float) * 2 * lpad;
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename K, typename T, typename... Extra>
int launch(K kernel, size_t smem, const void* x, const void* a, const void* b, const void* c,
           void* y, void* s, long long cells, int l, int p, int n, int threads, int per_chunk,
           cudaStream_t stream, Extra... extra) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = cells * (units_of(p, n) + tiles_of(l));
  const int vec_x = p % per_chunk == 0 && aligned16(x);
  const int vec_bc = n % per_chunk == 0 && aligned16(b) && aligned16(c);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<float*>(y), static_cast<float*>(s), l, p, n,
      vec_x, vec_bc, extra...);
  return static_cast<int>(cudaGetLastError());
}

template <int PC>
int launch_f32(const void* x, const void* a, const void* b, const void* c, void* y, void* s,
               long long cells, int l, int p, int n, cudaStream_t st) {
  const int stages = f32_stages(l, n, PC);
  return launch<decltype(&ssd_chunk_kernel<PC>), float>(
      ssd_chunk_kernel<PC>, f32_smem_bytes(l, n, PC, stages), x, a, b, c, y, s, cells, l, p, n,
      kF32Threads, 4, st, stages);
}

template <int PP, int NH>
int launch_tc(const void* x, const void* a, const void* b, const void* c, void* y, void* s,
              long long cells, int l, int p, int n, cudaStream_t st) {
  return launch<decltype(&ssd_tc_kernel<PP, NH>), bf16>(
      ssd_tc_kernel<PP, NH>, tc_smem_bytes(l, n, PP), x, a, b, c, y, s, cells, l, p, n,
      kTcThreads, 8, st);
}

template <int PP>
int launch_tc_hold(const void* x, const void* a, const void* b, const void* c, void* y,
                   void* s, long long cells, int l, int p, int n, cudaStream_t st) {
  const int nk = (n + 15) / 16;
  if (nk <= 1) return launch_tc<PP, 1>(x, a, b, c, y, s, cells, l, p, n, st);
  if (nk <= 2) return launch_tc<PP, 2>(x, a, b, c, y, s, cells, l, p, n, st);
  if (nk <= 4) return launch_tc<PP, 4>(x, a, b, c, y, s, cells, l, p, n, st);
  return launch_tc<PP, 8>(x, a, b, c, y, s, cells, l, p, n, st);
}

}  // namespace

// Plain C entry point for ctypes.  dtype: 0 = float32 (ssd_chunk_kernel),
// 1 = bfloat16 (ssd_tc_kernel); x, a, B and C share it, y and s are float32.
// P is at most 128; the wrapper checks it, the shared-memory size and that
// the 1-D grid of BH * chunks * (units + tiles) blocks fits.
extern "C" {

int repro_ssd_chunk(const void* x, const void* a, const void* b, const void* c, void* y,
                    void* s, int bh, int chunks, int l, int p, int n, int dtype,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(bh) * chunks;
  if (dtype == 0) {
    if (p <= 16) return launch_f32<1>(x, a, b, c, y, s, cells, l, p, n, st);
    if (p <= 32) return launch_f32<2>(x, a, b, c, y, s, cells, l, p, n, st);
    if (p <= 64) return launch_f32<4>(x, a, b, c, y, s, cells, l, p, n, st);
    return launch_f32<8>(x, a, b, c, y, s, cells, l, p, n, st);
  }
  if (p <= 16) return launch_tc_hold<16>(x, a, b, c, y, s, cells, l, p, n, st);
  if (p <= 32) return launch_tc_hold<32>(x, a, b, c, y, s, cells, l, p, n, st);
  if (p <= 64) return launch_tc_hold<64>(x, a, b, c, y, s, cells, l, p, n, st);
  return launch_tc_hold<128>(x, a, b, c, y, s, cells, l, p, n, st);
}

}  // extern "C"
