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
// TF32, keeps too few digits for the float32 tolerance).  One block of 256
// threads (8 warps) per (64-query tile, bh).  The block stages its Q tile in
// shared memory once, then walks the KV tiles of BKV rows (32, 64 or 128, a
// template parameter): it stages K and V, forms the (64, BKV) score tile
// S = scale * Q K^T in registers (a 4 x BKV/16 micro-tile per thread) and
// parks it in shared memory, updates the running row max m and row sum l (4
// threads per row, kept in their registers) and rescales the (64, D)
// accumulator, which each thread keeps in registers as a 4 x D/16
// micro-tile, before adding P V.  With causal masking the block stops at the
// last KV tile that holds a key <= its last query row: the tiles above the
// diagonal are never read.  Who reads what: warp w stages rows 8w .. 8w+7 of
// the Q tile and rows w*BKV/8 .. (w+1)*BKV/8 - 1 of every K and V tile, and
// stores rows 8w .. 8w+7 of the O tile (kernels/flash.py:flash_spec
// describes exactly this).  Shared memory: (64 + 2 BKV) (D + 1) + 64 (BKV +
// 1) + 128 floats, 116 KB at BKV = 64, D = 128, and 199 KB at BKV = 128:
// above the 48 KB a block gets by default, so the launch opts in with
// cudaFuncSetAttribute first.
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
  if (dtype == 0) return dispatch<float>(q, k, v, o, bh, sq, skv, d, bkv, causal, s);
  return dispatch_tc(q, k, v, o, bh, sq, skv, d, bkv, causal, s);
}

}  // extern "C"
