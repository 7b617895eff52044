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
// right after its launch.  Each type has a kernel of its own.
//
// Bound on an H100 SXM at (BH, S, D) = (32, 4096, 4096, 128), causal: the
// 4 * BH * D * S(S+1)/2 = 137 GFLOP of the two products take 2.05 ms at the
// CUDA cores' float32 rate (67 TFLOP/s) and 0.139 ms at the tensor cores'
// bf16 rate (989 TFLOP/s), against 268 MB (f32) of Q, K, V and O, 0.08 ms at
// 3.35 TB/s: the arithmetic bounds both routes.
//
// float32: flash_kernel, on the CUDA cores (the tensor cores' float32 path,
// TF32, keeps too few digits for the float32 tolerance).  One block of 128
// threads (4 warps) per (64-query tile, bh), two blocks an SM; the query
// tiles are launched last first (grid (bh, tiles), the heads of one tile
// next to each other), so the longest causal walks start first.  D is
// zero-filled up to DP = 64 or 128.  Warp w owns query rows 16w .. 16w+15
// of the tile from the first product to the store, so a KV stage needs one
// __syncthreads and the softmax none.  The block walks the KV tiles of bkv
// rows (32, 64 or 128) as stages of 32 keys through a ring of two: the next
// stage's cp.async copies are in flight while this stage's products run.
// Per stage a warp forms its 16 x 32 scores S = Q K^T in registers (lane
// (r, j) = (lane / 8, lane % 8) holds rows r + 4i and keys j + 8c for i, c
// < 4), reading 16 bytes at a time: the Q and K tiles are row-major with a
// padded row of DP + 4 floats, so the 4 rows and the 8 keys one load
// instruction reads fill 32 different banks, and each lane does 64 FMAs per
// 8 loads.  The 8 lanes of a row take its max with three __shfl_xor_syncs;
// p = exp2(S log2e / sqrt(D) - m) (a masked key gives p = 0) goes to the
// warp's own P^T buffer in shared memory [32 keys][16 rows + 4] with the
// rows' rescale exp2(m_old - m_new), and each lane keeps its share of the
// row sums.  P V then runs on lane (r, c) = (lane / 16, lane % 16): rows 8r
// .. 8r+7, columns 4c + 64h (h < DP/64), 8 P values in two 16-byte loads
// and 4 V values in one per 32 FMAs.  A warp skips a stage whose first key
// lies above its last query row, and masks only the stages that cross its
// diagonal or the end of the keys.  With causal masking the block stops at
// the last bkv tile that holds a key <= its last query row: the tiles above
// the diagonal are never read.  Who reads what (lane l of warp w copies
// 16-byte chunks l, l + 32, ... of the warp's rows): warp w stages rows 16w
// .. 16w+15 of the Q tile and rows 8w .. 8w+7 of every 32-row K and V
// stage, and stores rows 16w .. 16w+15 of the O tile
// (kernels/flash.py:flash_spec describes exactly this).  A row that is not
// 16-byte aligned (D not a multiple of 4, or a base pointer off 16 bytes)
// is staged with 4-byte copies and stored with 4-byte stores by the same
// lanes.  Shared memory: (64 + 64) (DP + 4) + 64 DP + 4 (32 x 20 + 16)
// floats, 108 KB at DP = 128; registers: at most 255 a thread, none
// spilled.  What is left to the card's float32 peak: 128 threads a block
// and two blocks an SM keep 8 warps in flight, and the products read 12 of
// every 140 instructions from shared memory.
//
// bfloat16: flash_tc_kernel, both products on the tensor cores
// (mma.sync m16n8k16, float32 accumulators; helpers in mma.cuh), laid out
// as FlashAttention-2.  One block of 128 threads (4 warps) per (64-query
// tile, bh); the query tiles are launched last first, so the longest causal
// walks start first.  D is zero-filled up to DP = 16, 32, 64 or 128 (the
// least that holds it).  The block stages its Q tile as bf16 and warp w
// keeps the A fragments of its 16 query rows (16w .. 16w+15) in registers
// for the whole walk.  K and V tiles of BKV rows are staged as bf16 in a
// ring of two stages: the next tile's cp.async copies are in flight while
// this tile's products run.  The shared tiles are not padded but swizzled
// (16-byte chunk c of row r at c ^ f(r), mma.cuh:swz), so ldmatrix of K and
// the transposed ldmatrix of V are free of bank conflicts.  A warp takes a
// tile in sub-tiles of up to 64 keys and skips a sub-tile that lies wholly
// above the diagonal of its rows: S = Q K^T accumulates in float32
// registers; the quad of lanes that holds a row (rows lane/4 and lane/4 + 8
// of the m16n8 layout) takes its max with two __shfl_xor_syncs; P = exp(S -
// m) is rounded to bf16 in registers straight into the A fragments of P V,
// while the row sums add the float32 p; a masked key gets p = 0, so a
// sub-tile that masks all of a row's keys leaves m, l and O as they were.
// O (16 x DP per warp) stays in float32 registers, rescaled by exp(m_old -
// m_new) per sub-tile, and is written once, as bf16, through the Q tile's
// shared memory with 16-byte stores.  Who reads what (thread t of the 128
// copies 16-byte chunks t, t + 128, ... of each staged tile, chunk i being
// row i / (DP/8), columns 8 (i mod DP/8) ..; warp w stores rows 16w ..
// 16w+15 of the O tile): kernels/flash.py:flash_spec with dtype bfloat16
// describes exactly this.  A row that is not 16-byte aligned (D not a
// multiple of 8, or a base pointer off 16 bytes) is staged and stored with
// 2-byte loads and stores instead, by the same threads.  Shared memory:
// (64 + 4 BKV) DP bf16, 80 KB at BKV = 64, DP = 128: two blocks an SM.
// What is left to the card's peak: wgmma on warpgroups, TMA copies and warp
// specialisation (a producer warp feeding consumer warpgroups).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kThreads = 128;           // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowsW = kBQ / kWarps;    // query rows a warp owns: 16
constexpr int kKS = 32;                 // keys a ring stage
constexpr int kStageRowsW = kKS / kWarps;  // K and V rows a warp stages: 8
constexpr int kPLd = kRowsW + 4;        // padded key row of a warp's P^T
constexpr int kPBuf = kKS * kPLd + kRowsW;  // a warp's P^T and row factors
constexpr float kNegInf = -1e30f;       // the Pallas kernel's NEG_INF

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int sq, int skv,
             int d, int bkv, int causal, float scale_log2, int vec) {
  constexpr int LD = DP + 4;   // padded row of the Q and K tiles
  constexpr int C = DP / 4;    // 16-byte chunks a staged row
  constexpr int NH = DP / 64;  // 4-column groups of O a lane, 64 apart
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // [kBQ][LD]
  float* ks = qs + kBQ * LD;        // [2][kKS][LD]
  float* vs = ks + 2 * kKS * LD;    // [2][kKS][DP]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* pw = vs + 2 * kKS * DP + warp * kPBuf;  // P^T [kKS][kPLd], then kRowsW factors
  float* fw = pw + kKS * kPLd;
  const size_t head = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // last tiles first
  const float* kg = k + head * skv * d;
  const float* vg = v + head * skv * d;
  const bool vec16 = vec != 0;

  // the walk: the bkv tiles up to the diagonal, in stages of kKS rows
  const int last_q = min(q0 + kBQ, sq) - 1;
  int n_tiles = (skv + bkv - 1) / bkv;
  if (causal) n_tiles = min(n_tiles, last_q / bkv + 1);
  const int kv_end = min(skv, n_tiles * bkv);
  const int n_stages = (kv_end + kKS - 1) / kKS;

  // rows r0 .. r0+nrows-1 of a tile (row r of src at src + r d; rows >= live
  // and columns >= d zero) into dst, row stride ld: lane l copies chunks l,
  // l + 32, ... of those rows
  auto stage_rows = [&](float* dst, int ld, const float* src, int r0, int nrows, int live) {
    if (vec16) {
      for (int i = lane; i < nrows * C; i += 32) {
        const int r = r0 + i / C;
        const int c = 4 * (i % C);
        const bool in = r < live && c < d;
        cp_async16(smem_u32(dst + r * ld + c), in ? src + (size_t)r * d + c : src, in ? 16 : 0);
      }
    } else {
      for (int i = lane; i < nrows * DP; i += 32) {
        const int r = r0 + i / DP;
        const int c = i % DP;
        const bool in = r < live && c < d;
        cp_async4(smem_u32(dst + r * ld + c), in ? src + (size_t)r * d + c : src, in ? 4 : 0);
      }
    }
  };
  auto stage_kv = [&](int buf, int st) {
    const int k0 = st * kKS;
    stage_rows(ks + buf * kKS * LD, LD, kg + (size_t)k0 * d, kStageRowsW * warp, kStageRowsW,
               kv_end - k0);
    stage_rows(vs + buf * kKS * DP, DP, vg + (size_t)k0 * d, kStageRowsW * warp, kStageRowsW,
               kv_end - k0);
  };
  stage_rows(qs, LD, q + (head * sq + q0) * d, kRowsW * warp, kRowsW, sq - q0);
  stage_kv(0, 0);
  cp_async_commit();

  const int row0 = q0 + kRowsW * warp;  // the warp's first query row
  const int sr = lane / 8;              // S: rows sr + 4i, keys sk + 8c (i, c < 4)
  const int sk = lane % 8;
  const int pr = lane / 16;             // P V: rows 8pr .. 8pr+7, columns 4pc + 64h
  const int pc = lane % 16;
  const float* q_rows = qs + (kRowsW * warp + sr) * LD;
  float m_run[4], l_run[4];             // running max (log2 units); this lane's share of the sums
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
  }
  float acc[8][NH][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int h = 0; h < NH; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][h][e] = 0.f;
    }
  }

  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<0>();
    __syncthreads();  // stage st (and Q) has landed; every warp is done with st - 1
    if (st + 1 < n_stages) stage_kv((st + 1) & 1, st + 1);
    cp_async_commit();
    const int kb = st * kKS;  // first key of the stage
    if (causal && kb > row0 + kRowsW - 1) continue;  // all above the warp's rows
    const float* kt = ks + (st & 1) * kKS * LD;
    const float* vt = vs + (st & 1) * kKS * DP;

    // S = Q K^T: rows sr + 4i, keys sk + 8c
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    }
#pragma unroll 4
    for (int dd = 0; dd < DP; dd += 4) {
      float4 qa[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(q_rows + 4 * i * LD + dd);
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = *reinterpret_cast<const float4*>(kt + (sk + 8 * c) * LD + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[i][c] = fmaf(qa[i].x, kv[c].x, s[i][c]);
          s[i][c] = fmaf(qa[i].y, kv[c].y, s[i][c]);
          s[i][c] = fmaf(qa[i].z, kv[c].z, s[i][c]);
          s[i][c] = fmaf(qa[i].w, kv[c].w, s[i][c]);
        }
      }
    }
    // scale to log2 units; mask where the stage crosses the warp's diagonal
    // or the end of the keys
    const bool edge = kb + kKS > skv || (causal && kb + kKS - 1 > row0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = kb + sk + 8 * c;
        const bool masked = edge && (key >= skv || (causal && key > row0 + sr + 4 * i));
        s[i][c] = masked ? kNegInf : s[i][c] * scale_log2;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float mn = fmaxf(m_run[i], mx);
      const float cr = exp2f(m_run[i] - mn);
      m_run[i] = mn;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = s[i][c] == kNegInf ? 0.f : exp2f(s[i][c] - mn);
        sum += p;
        pw[(sk + 8 * c) * kPLd + sr + 4 * i] = p;
      }
      l_run[i] = l_run[i] * cr + sum;
      if (sk == 0) fw[sr + 4 * i] = cr;
    }
    __syncwarp();

    // acc = acc * cr + P V
    float f[8];
    *reinterpret_cast<float4*>(f) = *reinterpret_cast<const float4*>(fw + 8 * pr);
    *reinterpret_cast<float4*>(f + 4) = *reinterpret_cast<const float4*>(fw + 8 * pr + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int h = 0; h < NH; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][h][e] *= f[i];
      }
    }
#pragma unroll 8
    for (int j = 0; j < kKS; ++j) {
      float p[8];
      *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(pw + j * kPLd + 8 * pr);
      *reinterpret_cast<float4*>(p + 4) =
          *reinterpret_cast<const float4*>(pw + j * kPLd + 8 * pr + 4);
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        const float4 v4 = *reinterpret_cast<const float4*>(vt + j * DP + 64 * h + 4 * pc);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][h][0] = fmaf(p[i], v4.x, acc[i][h][0]);
          acc[i][h][1] = fmaf(p[i], v4.y, acc[i][h][1]);
          acc[i][h][2] = fmaf(p[i], v4.z, acc[i][h][2]);
          acc[i][h][3] = fmaf(p[i], v4.w, acc[i][h][3]);
        }
      }
    }
    __syncwarp();  // the warp's P V reads are done before the next stage's P
  }

  // the row sums: the 8 lanes of a row add their shares, then reach the
  // lanes that hold the row's O through the warp's buffer
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 4);
    if (sk == 0) fw[sr + 4 * i] = l_run[i];
  }
  __syncwarp();
  float ls[8];
  *reinterpret_cast<float4*>(ls) = *reinterpret_cast<const float4*>(fw + 8 * pr);
  *reinterpret_cast<float4*>(ls + 4) = *reinterpret_cast<const float4*>(fw + 8 * pr + 4);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gq = row0 + 8 * pr + i;
    if (gq >= sq) continue;
    const float den = fmaxf(ls[i], 1e-30f);
    float* orow = o + (head * sq + gq) * d;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int c = 64 * h + 4 * pc;
      if (c >= d) continue;
      const float4 out = make_float4(acc[i][h][0] / den, acc[i][h][1] / den,
                                     acc[i][h][2] / den, acc[i][h][3] / den);
      if (vec16) {
        *reinterpret_cast<float4*>(orow + c) = out;
      } else {
        orow[c] = out.x;
        if (c + 1 < d) orow[c + 1] = out.y;
        if (c + 2 < d) orow[c + 2] = out.z;
        if (c + 3 < d) orow[c + 3] = out.w;
      }
    }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int sq, int skv, int d, int bkv, int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * ((size_t)(kBQ + 2 * kKS) * (DP + 4) +
                                           2 * kKS * DP + kWarps * kPBuf);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const int vec = d % 4 == 0 && bits % 16 == 0;
  constexpr float log2e = 1.4426950408889634f;
  dim3 grid(bh, (sq + kBQ - 1) / kBQ);
  flash_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, skv, d, bkv, causal,
      log2e / sqrtf(static_cast<float>(d)), vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int sq, int skv, int d, int bkv, int causal, cudaStream_t s) {
  if (bkv != 32 && bkv != 64 && bkv != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 64) return launch<64>(q, k, v, o, bh, sq, skv, d, bkv, causal, s);
  return launch<128>(q, k, v, o, bh, sq, skv, d, bkv, causal, s);
}

// ---------------------------------------------------------------------------
// bfloat16: both products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kTcBQ = 64;       // query rows per block: 16 a warp
constexpr int kTcThreads = 128; // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

template <int BKV, int DP>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int sq,
                int skv, int d, int causal, float scale_log2, int vec) {
  constexpr int C = DP / 8;                   // 16-byte chunks a staged row
  constexpr int kSub = BKV < 64 ? BKV : 64;   // keys a warp scores at once
  constexpr int kNT = kSub / 8;               // n-tiles of S
  constexpr int kKD = DP / 16;                // k-steps of Q K^T
  constexpr int kND = DP / 8;                 // n-tiles of O
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tc_smem);  // [kTcBQ][DP], then O
  bf16* ks = qs + kTcBQ * DP;                   // [2][BKV][DP]
  bf16* vs = ks + 2 * BKV * DP;                 // [2][BKV][DP]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;  // last tiles first
  const size_t head = blockIdx.y;
  const bf16* kg = k + head * skv * d;
  const bf16* vg = v + head * skv * d;
  const bool vec16 = vec != 0;

  const int last_q = min(q0 + kTcBQ, sq) - 1;
  int n_tiles = (skv + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, last_q / BKV + 1);

  // a K and V tile wholly inside its head (and D = DP) takes the copy
  // without index arithmetic
  const bool full_rows = vec16 && d == DP;
  auto stage_kv = [&](int st, int k1) {
    if (full_rows && k1 + BKV <= skv) {
      stage_tile_full<C, BKV, kTcThreads>(ks + st * BKV * DP, kg + (size_t)k1 * d, d, tid);
      stage_tile_full<C, BKV, kTcThreads>(vs + st * BKV * DP, vg + (size_t)k1 * d, d, tid);
    } else {
      stage_tile<C>(ks + st * BKV * DP, kg + (size_t)k1 * d, BKV, d, skv - k1, d, vec16, tid,
                    kTcThreads);
      stage_tile<C>(vs + st * BKV * DP, vg + (size_t)k1 * d, BKV, d, skv - k1, d, vec16, tid,
                    kTcThreads);
    }
  };
  stage_tile<C>(qs, q + (head * sq + q0) * d, kTcBQ, d, sq - q0, d, vec16, tid,
                kTcThreads);
  stage_kv(0, 0);
  cp_async_commit();

  // this lane's rows of the warp's 16 (g and g + 8 of the m16n8 layout)
  const int row_a = q0 + 16 * warp + lane / 4;
  const int row_b = row_a + 8;
  const int warp_last = q0 + 16 * warp + 15;
  uint32_t qf[kKD][4];
  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  float m_a = kNegInf, m_b = kNegInf;  // running max, in log2 units
  float l_a = 0.f, l_b = 0.f;          // this lane's share of the row sums

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {  // the next tile's copies overlap this tile's products
      stage_kv((t + 1) & 1, (t + 1) * BKV);
    }
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: tile t (and Q) are here
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) {
        const int r = 16 * warp + lane % 16;
        ldmatrix_x4(qf[kk], smem_u32(qs) + swz_offset<C>(r, kk * 16 + (lane / 16) * 8));
      }
    }
    const uint32_t kbase = smem_u32(ks + (t & 1) * BKV * DP);
    const uint32_t vbase = smem_u32(vs + (t & 1) * BKV * DP);
#pragma unroll 1  // one sub-tile's fragments live at a time: no spills at BKV 128
    for (int sb = 0; sb < BKV / kSub; ++sb) {
      const int kb = t * BKV + sb * kSub;  // first key of the sub-tile
      if (kb >= skv || (causal && kb > warp_last)) continue;  // warp-uniform
      float s[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
        for (int jj = 0; jj < kNT / 2; ++jj) {
          uint32_t b[4];
          const int key = sb * kSub + jj * 16 + (lane / 16) * 8 + lane % 8;
          ldmatrix_x4(b, kbase + swz_offset<C>(key, kk * 16 + ((lane / 8) & 1) * 8));
          mma_bf16_16816(s[2 * jj], qf[kk], b[0], b[1]);
          mma_bf16_16816(s[2 * jj + 1], qf[kk], b[2], b[3]);
        }
      }
      // scale, and mask where the sub-tile crosses the diagonal of the
      // warp's rows or the end of the keys; the quad's max of each row
      const bool edge = kb + kSub > skv || (causal && kb + kSub - 1 > q0 + 16 * warp);
      if (edge) {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = kb + 8 * j + 2 * (lane % 4) + e;
            const bool out = key >= skv;
            s[j][e] = (out || (causal && key > row_a)) ? kNegInf : s[j][e] * scale_log2;
            s[j][2 + e] = (out || (causal && key > row_b)) ? kNegInf : s[j][2 + e] * scale_log2;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
        }
      }
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a);
      const float mn_b = fmaxf(m_b, mx_b);
      const float cr_a = exp2f(m_a - mn_a);
      const float cr_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      // P in bf16, straight into the A fragments of P V; the sums add the
      // float32 p (a masked key: p = 0)
      uint32_t pf[kSub / 16][4];
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const float p0 = s[j][0] == kNegInf ? 0.f : exp2f(s[j][0] - mn_a);
        const float p1 = s[j][1] == kNegInf ? 0.f : exp2f(s[j][1] - mn_a);
        const float p2 = s[j][2] == kNegInf ? 0.f : exp2f(s[j][2] - mn_b);
        const float p3 = s[j][3] == kNegInf ? 0.f : exp2f(s[j][3] - mn_b);
        ps_a += p0 + p1;
        ps_b += p2 + p3;
        pf[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
        pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
      l_a = l_a * cr_a + ps_a;
      l_b = l_b * cr_b + ps_b;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        acc[n][0] *= cr_a;
        acc[n][1] *= cr_a;
        acc[n][2] *= cr_b;
        acc[n][3] *= cr_b;
      }
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {
#pragma unroll
        for (int dn = 0; dn < kND / 2; ++dn) {
          uint32_t b[4];
          const int key = sb * kSub + kk * 16 + ((lane / 8) & 1) * 8 + lane % 8;
          ldmatrix_x4_trans(b, vbase + swz_offset<C>(key, dn * 16 + (lane / 16) * 8));
          mma_bf16_16816(acc[2 * dn], pf[kk], b[0], b[1]);
          mma_bf16_16816(acc[2 * dn + 1], pf[kk], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // O = acc / l, as bf16 into this warp's rows of the Q tile, then 16-byte
  // stores of the rows below sq
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  const float den_a = fmaxf(l_a, 1e-30f);
  const float den_b = fmaxf(l_b, 1e-30f);
  unsigned char* qbytes = reinterpret_cast<unsigned char*>(qs);
#pragma unroll
  for (int n = 0; n < kND; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    const int r = 16 * warp + lane / 4;
    *reinterpret_cast<uint32_t*>(qbytes + swz_offset<C>(r, col)) =
        pack_bf16(acc[n][0] / den_a, acc[n][1] / den_a);
    *reinterpret_cast<uint32_t*>(qbytes + swz_offset<C>(r + 8, col)) =
        pack_bf16(acc[n][2] / den_b, acc[n][3] / den_b);
  }
  __syncwarp();
  for (int i = lane; i < 16 * C; i += 32) {
    const int r = 16 * warp + i / C;
    const int col = (i % C) * 8;
    const int gq = q0 + r;
    if (gq >= sq || col >= d) continue;
    const unsigned char* chunk = qbytes + (r * C + swz<C>(r, i % C)) * 16;
    bf16* dst = o + (head * sq + gq) * d + col;
    if (vec16) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(chunk);
    } else {
      const bf16* vals = reinterpret_cast<const bf16*>(chunk);
      for (int e = 0; e < 8 && col + e < d; ++e) dst[e] = vals[e];
    }
  }
}

template <int BKV, int DP>
int launch_tc(const void* q, const void* k, const void* v, void* o, int bh,
              int sq, int skv, int d, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(bf16) * (size_t)(kTcBQ + 4 * BKV) * DP;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<BKV, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const int vec = d % 8 == 0 && bits % 16 == 0;
  dim3 grid((sq + kTcBQ - 1) / kTcBQ, bh);
  flash_tc_kernel<BKV, DP><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), sq, skv, d, causal,
      kLog2e / sqrtf(static_cast<float>(d)), vec);
  return static_cast<int>(cudaGetLastError());
}

template <int BKV>
int dispatch_tc_d(const void* q, const void* k, const void* v, void* o, int bh,
                  int sq, int skv, int d, int causal, cudaStream_t s) {
  if (d <= 16) return launch_tc<BKV, 16>(q, k, v, o, bh, sq, skv, d, causal, s);
  if (d <= 32) return launch_tc<BKV, 32>(q, k, v, o, bh, sq, skv, d, causal, s);
  if (d <= 64) return launch_tc<BKV, 64>(q, k, v, o, bh, sq, skv, d, causal, s);
  return launch_tc<BKV, 128>(q, k, v, o, bh, sq, skv, d, causal, s);
}

int dispatch_tc(const void* q, const void* k, const void* v, void* o, int bh,
                int sq, int skv, int d, int bkv, int causal, cudaStream_t s) {
  if (bkv == 32) return dispatch_tc_d<32>(q, k, v, o, bh, sq, skv, d, causal, s);
  if (bkv == 64) return dispatch_tc_d<64>(q, k, v, o, bh, sq, skv, d, causal, s);
  if (bkv == 128) return dispatch_tc_d<128>(q, k, v, o, bh, sq, skv, d, causal, s);
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
  if (dtype == 0) return dispatch(q, k, v, o, bh, sq, skv, d, bkv, causal, s);
  return dispatch_tc(q, k, v, o, bh, sq, skv, d, bkv, causal, s);
}

}  // extern "C"
