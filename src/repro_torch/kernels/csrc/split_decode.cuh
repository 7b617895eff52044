// Split-KV MQA decode (flash-decoding): the block step and the combine
// that the two decode kernels build on, ragged_decode.cu over a contiguous
// cache and paged_decode.cu over a paged one.  One query per sequence, H
// query heads (H <= 64) over one KV head of D <= 128.
//
// A sequence's KV positions are cut into splits of `len` positions at
// absolute places: split g covers [g len, (g+1) len) below S.  One block
// walks one split in chunks of CH rows at absolute places too (chunk j of
// split g starts at g len + j CH), keeps the online-softmax state of all H
// heads (running max m and row sum l in log2 units, and the unnormalised
// (D,) accumulator), and stores it to a record of the caller's float32
// workspace: [acc (H, D)][m (H)][l (H)], H (D + 2) floats.  The combine
// kernel merges the records of the splits that hold a live key, in split
// order, and writes O in the input type.
//
// Gated and dense.  Gated: a split with no live key stores nothing and
// exits after reading the bounds; a block walks only the chunks that hold a
// live key and stages only the live rows of each.  Dense (the baseline):
// every block stages every row of every chunk of its split below S and
// stores its record.  In both, a chunk with no live key is not computed, and
// a chunk's rows that are not staged are zero in shared memory (never stale:
// on the tensor cores every row of a chunk enters P V, and 0 x NaN is NaN).
// A masked key scores -1e30 and gets p = 0.  So a live split sees the same
// chunks with the same live keys in both modes, and the combine reads the
// same records: dense and gated give the same bits.
//
// Rows.  A row source (ContiguousRows, PagedRows, below run_split) says
// where each of a chunk's rows lives and which rows are there: a paged row
// whose page id lies outside the pool is not staged (zero) and its key is
// masked like a dead one, so it adds nothing, in both modes.  A split whose
// rows are all missing stores m = -1e30, l = 0, acc = 0, and the combine
// gives it weight 0 beside a split with a live key (O = 0 if none has one).
//
// Staging.  A chunk's K and V rows go to a two-stage ring in shared memory
// with 16-byte cp.async copies (zero-filled where not staged), so the next
// chunk's copies are in flight while this chunk is computed; thread t of
// the block copies 16-byte chunks t, t + T, ... (chunk i is row i / C,
// columns E (i mod C) ..; E elements a chunk, C chunks a row).  Rows that
// are not 16-byte aligned (D not a multiple of E, or a base off 16 bytes)
// go through narrow loads stored 16 bytes at a time, by the same threads.
// A whole bfloat16 chunk of aligned rows (D = DP) takes the same copies
// without per-copy index arithmetic (mma.cuh:stage_tile_full).  Q is staged
// the same way, once a block.  At the end the block puts its
// record in the K/V ring's shared memory and thread t stores its floats t,
// t + T, ... to the workspace.
//
// float32 (SplitF32<NHW>, T = 256, 8 warps, CH = 32; E = 4): on the CUDA
// cores, since TF32 keeps too few digits for float32's tolerance.  K and V
// stay float32 in rows of ld = 4 (ceil(D/4) | 1) floats (an odd count of
// float4, so 16-byte reads down a column are free of bank conflicts).  Warp
// w owns heads w, w + 8, ... and computes NHW = ceil(H/8) of them without a
// branch (a head past H on Q's zero rows).  S: lane l scores key l of the
// chunk for the warp's heads, float4 by float4 over D; the warp's max and
// sum are xor-shuffles, all heads at once; p goes to the warp's rows of P in
// shared memory.  P V: lane l owns columns 4l .. 4l+3 and reads V rows and
// P four keys at a time.  Shared memory: (8 NHW ld + 4 CH ld + 8 * 8 * CH)
// floats, 109 KB at H = 64, D = 128: two blocks an SM.
//
// bfloat16 (SplitTc<DP>, T = 128, 4 warps, CH = 64; E = 8): both products
// on the tensor cores (mma.sync m16n8k16, float32 accumulators; mma.cuh),
// with the query heads as the M dimension: warp w owns heads 16w .. 16w+15
// (H <= 64: four m16 tiles; a warp past H only stages).  K, V and Q stay
// bf16 in swizzled tiles of DP = 16, 32, 64 or 128 columns (the rest zero);
// S = Q K^T and acc += P V as in flash.cu's flash_tc_kernel, P rounded to
// bf16 into the A fragments (the Pallas kernel's p.astype(v.dtype)) while
// the row sums add the float32 p.  Shared memory: (16 ceil(H/16) + 4 CH) DP
// bf16, 76 KB at H = 48, D = 128: two blocks an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "common.cuh"
#include "mma.cuh"

namespace {

constexpr float kSplitNegInf = -1e30f;  // the Pallas kernels' NEG_INF
constexpr float kSplitLog2e = 1.4426950408889634f;
constexpr int kSplitMaxHeads = 64;
constexpr int kSplitMaxSplits = 32;  // splits a sequence (the wrapper's rule)

// Which chunks of split g a block walks, and the sequence's live range.
struct SplitWalk {
  int lo, hi;  // live positions, clamped to [0, S)
  int g0, g1;  // the split's positions [g0, g1)
  int j0, j1;  // chunks walked
  int ch;
  bool live;  // the split holds a live key

  __device__ SplitWalk(int start, int end, int s, int g, int len, int ch_, bool dense)
      : ch(ch_) {
    lo = max(start, 0);
    hi = min(end, s);
    g0 = g * len;
    g1 = min(g0 + len, s);
    const int a = max(lo, g0);
    const int z = min(hi, g1);
    live = a < z;
    j0 = j1 = 0;
    if (dense) {
      j1 = (g1 - g0 + ch - 1) / ch;
    } else if (live) {
      j0 = (a - g0) / ch;
      j1 = (z - 1 - g0) / ch + 1;
    }
  }
  __device__ int first(int j) const { return g0 + j * ch; }
  __device__ int rows(int j) const { return min(ch, g1 - first(j)); }
  __device__ int live_lo(int j) const { return max(lo - first(j), 0); }
  __device__ int live_hi(int j) const { return min(hi - first(j), rows(j)); }
};

// ---------------------------------------------------------------------------
// float32 on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kSplitF32Threads = 256;
constexpr int kSplitF32Warps = kSplitF32Threads / 32;
constexpr int kSplitF32Chunk = 32;
constexpr int kSplitF32HeadsPerWarp = kSplitMaxHeads / kSplitF32Warps;

__host__ __device__ inline int split_f32_chunks(int d) { return (d + 3) / 4; }
__host__ __device__ inline int split_f32_ld(int d) { return 4 * (split_f32_chunks(d) | 1); }

// Q is staged in 8 NHW rows (zero past H), NHW = ceil(H / 8) heads a warp
inline size_t split_f32_smem_bytes(int h, int d) {
  const size_t ld = split_f32_ld(d);
  const size_t rows = kSplitF32Warps * ((h + kSplitF32Warps - 1) / kSplitF32Warps);
  return sizeof(float) * (rows * ld + 4 * kSplitF32Chunk * ld +
                          kSplitF32Warps * kSplitF32HeadsPerWarp * kSplitF32Chunk);
}

// rows [r_lo, r_hi) of a `rows`-row block of d floats a row (row r at
// src + r d) into a tile of stride ld; every other row and column zero
__device__ __forceinline__ void stage_f32(float* tile, const float* __restrict__ src,
                                          int rows, int d, int ld, int r_lo, int r_hi,
                                          bool vec) {
  const int c_row = split_f32_chunks(d);
  const uint32_t base = smem_u32(tile);
  for (int i = threadIdx.x; i < rows * c_row; i += blockDim.x) {
    const int r = i / c_row;
    const int col = (i % c_row) * 4;
    const bool live = r >= r_lo && r < r_hi;
    if (vec) {
      const float* p = live ? src + (size_t)r * d + col : src;
      cp_async16(base + (r * ld + col) * 4, p, live ? 16 : 0);
    } else {
      float4 x;
      x.x = live && col < d ? src[(size_t)r * d + col] : 0.f;
      x.y = live && col + 1 < d ? src[(size_t)r * d + col + 1] : 0.f;
      x.z = live && col + 2 < d ? src[(size_t)r * d + col + 2] : 0.f;
      x.w = live && col + 3 < d ? src[(size_t)r * d + col + 3] : 0.f;
      *reinterpret_cast<float4*>(tile + r * ld + col) = x;
    }
  }
}

// rows [r_lo, r_hi) of a `rows`-row chunk of K and V whose row r lives at
// element rs.row(first + r) of the pools (-1: not there) into tiles of
// stride ld; every other row and column zero.  The same threads and copies
// as stage_f32, K and V of a row from one lookup.
template <class Rows>
__device__ __forceinline__ void stage_f32_rows(float* kt, float* vt, const Rows& rs, int first,
                                               int rows, int d, int ld, int r_lo, int r_hi,
                                               bool vec) {
  const int c_row = split_f32_chunks(d);
  const uint32_t kb = smem_u32(kt);
  const uint32_t vb = smem_u32(vt);
  for (int i = threadIdx.x; i < rows * c_row; i += blockDim.x) {
    const int r = i / c_row;
    const int col = (i % c_row) * 4;
    const long long off = r >= r_lo && r < r_hi ? rs.row(first + r) : -1;
    const bool live = off >= 0;
    if (vec) {
      cp_async16(kb + (r * ld + col) * 4, live ? rs.k + off + col : rs.k, live ? 16 : 0);
      cp_async16(vb + (r * ld + col) * 4, live ? rs.v + off + col : rs.v, live ? 16 : 0);
    } else {
      float4 x, y;
      const float* kp = rs.k + (live ? off : 0);
      const float* vp = rs.v + (live ? off : 0);
      x.x = live && col < d ? kp[col] : 0.f;
      x.y = live && col + 1 < d ? kp[col + 1] : 0.f;
      x.z = live && col + 2 < d ? kp[col + 2] : 0.f;
      x.w = live && col + 3 < d ? kp[col + 3] : 0.f;
      y.x = live && col < d ? vp[col] : 0.f;
      y.y = live && col + 1 < d ? vp[col + 1] : 0.f;
      y.z = live && col + 2 < d ? vp[col + 2] : 0.f;
      y.w = live && col + 3 < d ? vp[col + 3] : 0.f;
      *reinterpret_cast<float4*>(kt + r * ld + col) = x;
      *reinterpret_cast<float4*>(vt + r * ld + col) = y;
    }
  }
}

// NHW heads a warp (H <= 8 NHW): warp w owns heads w, w + 8, ..., and
// computes all NHW of them, a head past H on Q's zero rows, so that no
// branch splits the products and the compiler can interleave the heads'
// loads and multiply-adds.
template <int NHW>
struct SplitF32 {
  static constexpr int kChunk = kSplitF32Chunk;
  using T = float;

  float* qs;  // [8 NHW][ld]
  float* ks;  // [2][CH][ld]
  float* vs;  // [2][CH][ld]
  float* pw;  // this warp's P, [NHW][CH]
  int h, d, ld, warp, lane;
  float scale;
  float m[NHW];
  float l[NHW];
  float4 acc[NHW];

  __device__ SplitF32(unsigned char* smem, int h_, int d_, float scale_log2)
      : h(h_), d(d_), ld(split_f32_ld(d_)), scale(scale_log2) {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    qs = reinterpret_cast<float*>(smem);
    ks = qs + kSplitF32Warps * NHW * ld;
    vs = ks + 2 * kChunk * ld;
    pw = vs + 2 * kChunk * ld + warp * kSplitF32HeadsPerWarp * kChunk;
#pragma unroll
    for (int i = 0; i < NHW; ++i) {
      m[i] = kSplitNegInf;
      l[i] = 0.f;
      acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  // the K/V ring, where finish() puts the record
  __device__ float* record() const { return ks; }

  __device__ void stage_q(const float* __restrict__ q, bool vec) {
    stage_f32(qs, q, kSplitF32Warps * NHW, d, ld, 0, h, vec);
  }

  __device__ void stage(int st, const float* __restrict__ kc, const float* __restrict__ vc,
                        int r_lo, int r_hi, bool vec) {
    stage_f32(ks + st * kChunk * ld, kc, kChunk, d, ld, r_lo, r_hi, vec);
    stage_f32(vs + st * kChunk * ld, vc, kChunk, d, ld, r_lo, r_hi, vec);
  }

  template <class Rows>
  __device__ void stage_rows(int st, const Rows& rs, int first, int r_lo, int r_hi, bool vec) {
    stage_f32_rows(ks + st * kChunk * ld, vs + st * kChunk * ld, rs, first, kChunk, d, ld, r_lo,
                   r_hi, vec);
  }

  __device__ void load_q() {}

  // keys [l_lo, l_hi) of the chunk in stage st are live (at least one);
  // with kMasked, a key whose bit in `present` is clear is masked as well
  template <bool kMasked>
  __device__ void compute(int st, int l_lo, int l_hi, uint64_t present) {
    const float* kt = ks + st * kChunk * ld;
    const float* vt = vs + st * kChunk * ld;
    const int c_row = split_f32_chunks(d);
    float sc[NHW];
#pragma unroll
    for (int i = 0; i < NHW; ++i) sc[i] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(kt + lane * ld);
    const float4* qrow = reinterpret_cast<const float4*>(qs + warp * ld);
    const int qstep = kSplitF32Warps * ld / 4;  // float4 from head w + 8i to w + 8(i+1)
#pragma unroll 4
    for (int c = 0; c < c_row; ++c) {
      const float4 kv = krow[c];
#pragma unroll
      for (int i = 0; i < NHW; ++i) {
        const float4 qv = qrow[i * qstep + c];
        sc[i] = fmaf(qv.x, kv.x, sc[i]);
        sc[i] = fmaf(qv.y, kv.y, sc[i]);
        sc[i] = fmaf(qv.z, kv.z, sc[i]);
        sc[i] = fmaf(qv.w, kv.w, sc[i]);
      }
    }
    const bool key_live =
        lane >= l_lo && lane < l_hi && (!kMasked || ((present >> lane) & 1));
    float mx[NHW];
#pragma unroll
    for (int i = 0; i < NHW; ++i) {
      sc[i] = key_live ? sc[i] * scale : kSplitNegInf;
      mx[i] = sc[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
#pragma unroll
      for (int i = 0; i < NHW; ++i) mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
    }
    float sum[NHW];
#pragma unroll
    for (int i = 0; i < NHW; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      const float p = key_live ? exp2f(sc[i] - m_new) : 0.f;
      sum[i] = p;
      const float corr = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= corr;
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
      pw[i * kChunk + lane] = p;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
#pragma unroll
      for (int i = 0; i < NHW; ++i) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], off);
    }
#pragma unroll
    for (int i = 0; i < NHW; ++i) l[i] += sum[i];
    __syncwarp();
    if (4 * lane < d) {
#pragma unroll 2
      for (int j = 0; j < kChunk; j += 4) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = reinterpret_cast<const float4*>(vt + (j + u) * ld)[lane];
#pragma unroll
        for (int i = 0; i < NHW; ++i) {
          const float4 p4 = reinterpret_cast<const float4*>(pw + i * kChunk)[j / 4];
          const float pu[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[i].x = fmaf(pu[u], v[u].x, acc[i].x);
            acc[i].y = fmaf(pu[u], v[u].y, acc[i].y);
            acc[i].z = fmaf(pu[u], v[u].z, acc[i].z);
            acc[i].w = fmaf(pu[u], v[u].w, acc[i].w);
          }
        }
      }
    }
    __syncwarp();  // the warp's P is rewritten by the next chunk
  }

  // the state as a record [acc (H, D)][m (H)][l (H)] at rec (shared memory)
  __device__ void finish(float* rec) const {
#pragma unroll
    for (int i = 0; i < NHW; ++i) {
      const int head = warp + kSplitF32Warps * i;
      if (head >= h) continue;
      const float e[4] = {acc[i].x, acc[i].y, acc[i].z, acc[i].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (4 * lane + u < d) rec[head * d + 4 * lane + u] = e[u];
      }
      if (lane == 0) {
        rec[h * d + head] = m[i];
        rec[h * d + h + head] = l[i];
      }
    }
  }
};

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kSplitTcThreads = 128;
constexpr int kSplitTcChunk = 64;

inline size_t split_tc_smem_bytes(int h, int dp) {
  const size_t mp = 16 * ((h + 15) / 16);
  return sizeof(__nv_bfloat16) * (mp + 4 * kSplitTcChunk) * dp;
}

template <int DP>
struct SplitTc {
  static constexpr int kChunk = kSplitTcChunk;
  static constexpr int C = DP / 8;     // 16-byte chunks a staged row
  static constexpr int kKD = DP / 16;  // k-steps of Q K^T
  static constexpr int kND = DP / 8;   // n-tiles of the accumulator
  static constexpr int kNT = kChunk / 8;  // n-tiles of S
  using T = __nv_bfloat16;

  T* qs;  // [MP][DP]
  T* ks;  // [2][CH][DP]
  T* vs;  // [2][CH][DP]
  int h, d, mp, warp, lane;
  bool active;  // the warp owns a head
  float scale;
  uint32_t qf[kKD][4];
  float acc[kND][4];
  float m_a, m_b, l_a, l_b;  // rows lane/4 and lane/4 + 8 of the warp's 16

  __device__ SplitTc(unsigned char* smem, int h_, int d_, float scale_log2)
      : h(h_), d(d_), scale(scale_log2) {
    mp = 16 * ((h + 15) / 16);
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    active = 16 * warp < h;
    qs = reinterpret_cast<T*>(smem);
    ks = qs + mp * DP;
    vs = ks + 2 * kChunk * DP;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    }
    m_a = m_b = kSplitNegInf;
    l_a = l_b = 0.f;
  }

  __device__ float* record() const { return reinterpret_cast<float*>(ks); }

  __device__ void stage_q(const T* __restrict__ q, bool vec) {
    stage_tile<C>(qs, q, mp, d, h, d, vec, threadIdx.x, kSplitTcThreads);
  }

  __device__ void stage(int st, const T* __restrict__ kc, const T* __restrict__ vc, int r_lo,
                        int r_hi, bool vec) {
    if (vec && d == DP && r_lo == 0 && r_hi == kChunk) {
      // a whole chunk: the same copies without per-copy index arithmetic
      stage_tile_full<C, kChunk, kSplitTcThreads>(ks + st * kChunk * DP, kc, d, threadIdx.x);
      stage_tile_full<C, kChunk, kSplitTcThreads>(vs + st * kChunk * DP, vc, d, threadIdx.x);
      return;
    }
    stage_tile<C>(ks + st * kChunk * DP, kc, kChunk, d, r_hi, d, vec, threadIdx.x,
                  kSplitTcThreads, r_lo);
    stage_tile<C>(vs + st * kChunk * DP, vc, kChunk, d, r_hi, d, vec, threadIdx.x,
                  kSplitTcThreads, r_lo);
  }

  // the chunk's rows [r_lo, r_hi) through rs.row (-1: not there, zero):
  // thread t copies 16-byte chunks t, t + 128, ... of the K and the V tile,
  // as stage_tile does, K and V of a row from one lookup
  template <class Rows>
  __device__ void stage_rows(int st, const Rows& rs, int first, int r_lo, int r_hi, bool vec) {
    T* kt = ks + st * kChunk * DP;
    T* vt = vs + st * kChunk * DP;
    const uint32_t kb = smem_u32(kt);
    const uint32_t vb = smem_u32(vt);
    static_assert(kChunk * C % kSplitTcThreads == 0, "whole passes of the threads");
#pragma unroll
    for (int pass = 0; pass < kChunk * C / kSplitTcThreads; ++pass) {
      const int i = threadIdx.x + pass * kSplitTcThreads;
      const int r = i / C;
      const int c = i % C;
      const int col = c * 8;
      const uint32_t dst = (r * C + swz<C>(r, c)) * 16;
      const long long off = r >= r_lo && r < r_hi ? rs.row(first + r) : -1;
      const bool live = off >= 0 && col < d;
      if (vec) {
        cp_async16(kb + dst, live ? rs.k + off + col : rs.k, live ? 16 : 0);
        cp_async16(vb + dst, live ? rs.v + off + col : rs.v, live ? 16 : 0);
      } else {
        __align__(16) T x[8];
        __align__(16) T y[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const bool in = live && col + e < d;
          x[e] = in ? rs.k[off + col + e] : __float2bfloat16(0.f);
          y[e] = in ? rs.v[off + col + e] : __float2bfloat16(0.f);
        }
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(kt) + dst) =
            *reinterpret_cast<const uint4*>(x);
        *reinterpret_cast<uint4*>(reinterpret_cast<char*>(vt) + dst) =
            *reinterpret_cast<const uint4*>(y);
      }
    }
  }

  // the A fragments of the warp's 16 heads, once Q is in shared memory
  __device__ void load_q() {
    if (!active) return;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      const int r = 16 * warp + lane % 16;
      ldmatrix_x4(qf[kk], smem_u32(qs) + swz_offset<C>(r, kk * 16 + (lane / 16) * 8));
    }
  }

  template <bool kMasked>
  __device__ void compute(int st, int l_lo, int l_hi, uint64_t present) {
    if (!active) return;
    const uint32_t kbase = smem_u32(ks + st * kChunk * DP);
    const uint32_t vbase = smem_u32(vs + st * kChunk * DP);
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
        const int key = jj * 16 + (lane / 16) * 8 + lane % 8;
        ldmatrix_x4(b, kbase + swz_offset<C>(key, kk * 16 + ((lane / 8) & 1) * 8));
        mma_bf16_16816(s[2 * jj], qf[kk], b[0], b[1]);
        mma_bf16_16816(s[2 * jj + 1], qf[kk], b[2], b[3]);
      }
    }
    // scale and mask (the same keys for both rows); the quad's max of each row
    float mx_a = kSplitNegInf, mx_b = kSplitNegInf;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = 8 * j + 2 * (lane % 4) + e;
        const bool live = key >= l_lo && key < l_hi && (!kMasked || ((present >> key) & 1));
        s[j][e] = live ? s[j][e] * scale : kSplitNegInf;
        s[j][2 + e] = live ? s[j][2 + e] * scale : kSplitNegInf;
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][2 + e]);
      }
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
    // P in bf16 straight into the A fragments of P V; the sums add the
    // float32 p (a masked key: p = 0)
    uint32_t pf[kChunk / 16][4];
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float p0 = s[j][0] == kSplitNegInf ? 0.f : exp2f(s[j][0] - mn_a);
      const float p1 = s[j][1] == kSplitNegInf ? 0.f : exp2f(s[j][1] - mn_a);
      const float p2 = s[j][2] == kSplitNegInf ? 0.f : exp2f(s[j][2] - mn_b);
      const float p3 = s[j][3] == kSplitNegInf ? 0.f : exp2f(s[j][3] - mn_b);
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
    for (int kk = 0; kk < kChunk / 16; ++kk) {
#pragma unroll
      for (int dn = 0; dn < kND / 2; ++dn) {
        uint32_t b[4];
        const int key = kk * 16 + ((lane / 8) & 1) * 8 + lane % 8;
        ldmatrix_x4_trans(b, vbase + swz_offset<C>(key, dn * 16 + (lane / 16) * 8));
        mma_bf16_16816(acc[2 * dn], pf[kk], b[0], b[1]);
        mma_bf16_16816(acc[2 * dn + 1], pf[kk], b[2], b[3]);
      }
    }
  }

  __device__ void finish(float* rec) {
    if (!active) return;
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const int ra = 16 * warp + lane / 4;
    const int rb = ra + 8;
#pragma unroll
    for (int n = 0; n < kND; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * (lane % 4) + e;
        if (col >= d) continue;
        if (ra < h) rec[ra * d + col] = acc[n][e];
        if (rb < h) rec[rb * d + col] = acc[n][2 + e];
      }
    }
    if (lane % 4 == 0) {
      if (ra < h) {
        rec[h * d + ra] = m_a;
        rec[h * d + h + ra] = l_a;
      }
      if (rb < h) {
        rec[h * d + rb] = m_b;
        rec[h * d + h + rb] = l_b;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Where a split's K and V rows come from.  A row source stages the rows
// [r_lo, r_hi) of the chunk at absolute position `first` into stage st of
// the step's ring, and says which rows of the chunk are there (`present`:
// bit r of the chunk; the keys whose bit is clear are masked).
//
// ContiguousRows: the ragged cache, position p of the sequence at k + p d;
// every row is there, so its keys take no mask (kMasked false: the step
// compiles as if there were none).
// ---------------------------------------------------------------------------
template <typename T>
struct ContiguousRows {
  static constexpr bool kMasked = false;
  const T* __restrict__ k;
  const T* __restrict__ v;
  int d;

  template <class Step>
  __device__ void stage(Step& step, int st, int first, int r_lo, int r_hi, bool vec) const {
    step.stage(st, k + (size_t)first * d, v + (size_t)first * d, r_lo, r_hi, vec);
  }
  template <int CH>
  __device__ uint64_t present(int, int, int) const {
    return ~0ull;
  }
};

// PagedRows: the paged cache.  Position p of the sequence lives in slot
// p / page of its table, at row p % page of that physical page of the pools
// k and v (P, page, D); a page id outside [0, P) holds no row.  A chunk may
// span pages (any page from 1 to 128 rows): each row finds its own page.
// Staging threads read the table entry of each row they stage; for the
// mask, lane l of every warp reads the entries of the chunk's rows l (and
// l + 32) that lie in [l_lo, l_hi) and the warp ballots them.
template <typename T>
struct PagedRows {
  static constexpr bool kMasked = true;
  const T* __restrict__ k;
  const T* __restrict__ v;
  const int* __restrict__ table;  // this sequence's slots
  int d, page, n_pages;

  // element offset of position p's row in the pools, or -1
  __device__ __forceinline__ long long row(int p) const {
    const int slot = p / page;
    const int phys = table[slot];
    if (phys < 0 || phys >= n_pages) return -1;
    return ((long long)phys * page + (p - slot * page)) * d;
  }
  template <class Step>
  __device__ void stage(Step& step, int st, int first, int r_lo, int r_hi, bool vec) const {
    step.stage_rows(st, *this, first, r_lo, r_hi, vec);
  }
  template <int CH>
  __device__ uint64_t present(int first, int l_lo, int l_hi) const {
    const int lane = threadIdx.x % 32;
    uint64_t bits = 0;
#pragma unroll
    for (int half = 0; half < CH / 32; ++half) {
      const int r = 32 * half + lane;
      const bool there = r >= l_lo && r < l_hi && row(first + r) >= 0;
      bits |= (uint64_t)__ballot_sync(0xffffffffu, there) << (32 * half);
    }
    return bits;
  }
};

// ---------------------------------------------------------------------------
// one split: stage Q, walk the chunks through the two-stage ring, store the
// record.  `rows` says where each chunk's K and V rows are.
// ---------------------------------------------------------------------------
template <class Step, class Rows>
__device__ void run_split(Step& step, const SplitWalk& walk,
                          const typename Step::T* __restrict__ q, const Rows& rows, bool dense,
                          bool vec, float* __restrict__ ws_rec, int rec_len) {
  auto stage = [&](int st, int j) {
    rows.stage(step, st, walk.first(j), dense ? 0 : walk.live_lo(j),
               dense ? walk.rows(j) : walk.live_hi(j), vec);
  };
  step.stage_q(q, vec);
  if (walk.j0 < walk.j1) stage(0, walk.j0);
  cp_async_commit();
  for (int j = walk.j0; j < walk.j1; ++j) {
    if (j + 1 < walk.j1) stage((j + 1 - walk.j0) & 1, j + 1);  // overlaps this chunk
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: chunk j (and Q) are here
    __syncthreads();
    if (j == walk.j0) step.load_q();
    const int lo = walk.live_lo(j);
    const int hi = walk.live_hi(j);
    if (lo < hi) {
      const uint64_t there = rows.template present<Step::kChunk>(walk.first(j), lo, hi);
      step.template compute<Rows::kMasked>((j - walk.j0) & 1, lo, hi, there);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();
  float* rec = step.record();
  step.finish(rec);
  __syncthreads();
  for (int e = threadIdx.x; e < rec_len; e += blockDim.x) ws_rec[e] = rec[e];
}

// ---------------------------------------------------------------------------
// the combine: block (y, b) of THREADS threads, y + Y b on a 1-D grid with
// Y = ceil(H D / 4 THREADS), writes elements (4 y + u) THREADS + t (u < 4)
// of sequence b's (H, D) output.  Sequence b's live positions are
// [starts[b], ends[b]) clamped to [0, S); a null `starts` means 0 (the
// paged kernel's prefix [0, context_lens[b]))
// ---------------------------------------------------------------------------
template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
split_combine_kernel(const float* __restrict__ ws, const int* __restrict__ starts,
                     const int* __restrict__ ends, T* __restrict__ o, int h, int s, int d,
                     int len, int n_splits) {
  __shared__ float ml[kSplitMaxSplits * 2 * kSplitMaxHeads];
  __shared__ float wts[kSplitMaxSplits * kSplitMaxHeads];
  __shared__ float den[kSplitMaxHeads];
  const int hd = h * d;
  const int ys = (hd + 4 * THREADS - 1) / (4 * THREADS);
  const int y = blockIdx.x % ys;
  const int b = blockIdx.x / ys;
  const int lo = starts ? max(starts[b], 0) : 0;
  const int hi = min(ends[b], s);
  const int first = lo < hi ? lo / len : 0;
  const int nlive = lo < hi ? (hi - 1) / len - first + 1 : 0;
  const size_t rec_len = (size_t)h * (d + 2);
  const float* recs = ws + ((size_t)b * n_splits + first) * rec_len;
  // every live split's m and l, read once
  for (int f = threadIdx.x; f < nlive * 2 * h; f += THREADS) {
    ml[f] = recs[(f / (2 * h)) * rec_len + hd + f % (2 * h)];
  }
  __syncthreads();
  if (threadIdx.x < h) {
    const int head = threadIdx.x;
    float mx = kSplitNegInf;
    for (int g = 0; g < nlive; ++g) mx = fmaxf(mx, ml[g * 2 * h + head]);
    float sum = 0.f;
    for (int g = 0; g < nlive; ++g) {
      const float w = exp2f(ml[g * 2 * h + head] - mx);
      wts[g * h + head] = w;
      sum += w * ml[g * 2 * h + h + head];
    }
    den[head] = fmaxf(sum, 1e-30f);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int e = (4 * y + u) * THREADS + threadIdx.x;
    if (e >= hd) continue;
    const int head = e / d;
    float acc = 0.f;
#pragma unroll 4
    for (int g = 0; g < nlive; ++g) acc = fmaf(wts[g * h + head], recs[g * rec_len + e], acc);
    o[(size_t)b * hd + e] = from_float<T>(acc / den[head]);
  }
}

}  // namespace
