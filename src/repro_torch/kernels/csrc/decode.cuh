// The block-level step that the two MQA decode kernels share
// (ragged_decode.cu and paged_decode.cu): one block of 8 warps holds one
// sequence's H query heads and walks chunks of its KV cache with the online
// softmax.  A chunk is up to CH rows of K and V (CH = 32, 64 or 128, a
// template parameter): a tile of the contiguous cache for the ragged kernel,
// one physical page for the paged one.
//
// Who does what.  Warp w owns the query heads h = w, w + 8, w + 16, ...
// (at most 8 of them, so H <= 64): it stages their rows of Q in shared
// memory, keeps their running max m, row sum l and (D,) accumulator in
// registers (lane owns output columns lane + 32u), and stores their rows
// of O at the end.  For each chunk, warp w stages rows
// w*ceil(n/8) .. (w+1)*ceil(n/8) - 1 of the chunk's K and V (only those in
// the staged range the caller gives), so every staged row is read from
// device memory once and used by all H heads: that reuse is the point of
// MQA.  Scores: lane owns the chunk's keys lane + 32t and sums q . k over D
// from shared memory (padded rows, conflict-free).  Keys outside the live
// range score -1e30 (the Pallas NEG_INF) and get probability 0; the
// probabilities are rounded to the input type before the product with V,
// as p.astype(v_ref.dtype) does in the Pallas kernels, and the row sums are
// not.  A chunk with no live key changes nothing (m stays, corr = 1), and a
// sequence with no live key ends with l = 0 and O = 0 / max(l, 1e-30) = 0.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

#include "common.cuh"

namespace {

constexpr int kDecThreads = 256;              // 8 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecMaxD = 128;                 // head dims up to 128
constexpr int kDecMaxHeadsPerWarp = 8;        // H <= 64
constexpr float kDecNegInf = -1e30f;          // the Pallas kernels' NEG_INF

// row stride of the staged K and V: odd, so that 32 lanes reading one
// column of 32 rows hit 32 banks
__host__ __device__ inline int dec_ld(int d) { return d | 1; }

// shared memory of a block: Q (H, D), K and V (CH, ld), P (8, ceil(H/8), CH)
template <int CH>
size_t decode_smem_bytes(int h, int d) {
  const int hpw = (h + kDecWarps - 1) / kDecWarps;
  return sizeof(float) * ((size_t)h * d + 2 * (size_t)CH * dec_ld(d) +
                          (size_t)kDecWarps * hpw * CH);
}

template <typename T, int CH>
struct Decoder {
  static_assert(CH % 32 == 0 && CH <= 128, "CH is 32, 64 or 128");
  static constexpr int kT = CH / 32;  // keys per lane
  static constexpr int kU = kDecMaxD / 32;  // output columns per lane

  float* qs;
  float* ks;
  float* vs;
  float* pw;  // this warp's probabilities, [heads][CH]
  int d, ld, nh, warp, lane;
  float scale;
  float m[kDecMaxHeadsPerWarp];
  float l[kDecMaxHeadsPerWarp];
  float acc[kDecMaxHeadsPerWarp][kU];

  // q points at this sequence's (H, D) rows of Q
  __device__ Decoder(float* smem, const T* __restrict__ q, int h, int d_,
                     float scale_)
      : d(d_), ld(dec_ld(d_)), scale(scale_) {
    warp = threadIdx.x / 32;
    lane = threadIdx.x % 32;
    const int hpw = (h + kDecWarps - 1) / kDecWarps;
    nh = warp < h ? (h - warp + kDecWarps - 1) / kDecWarps : 0;
    qs = smem;
    ks = qs + h * d;
    vs = ks + CH * ld;
    pw = vs + CH * ld + warp * hpw * CH;
#pragma unroll
    for (int i = 0; i < kDecMaxHeadsPerWarp; ++i) {
      m[i] = kDecNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int u = 0; u < kU; ++u) acc[i][u] = 0.f;
      if (i < nh) {
        const int row = warp + kDecWarps * i;
        for (int c = lane; c < d; c += 32) {
          qs[row * d + c] = to_float(q[(size_t)row * d + c]);
        }
      }
    }
  }

  // One chunk of n <= CH rows at kc, vc (row r at kc + r * d).  Rows
  // [s_lo, s_hi) are staged and enter the products; keys [l_lo, l_hi) are
  // live (a subset of the staged rows, or empty).
  __device__ void chunk(const T* __restrict__ kc, const T* __restrict__ vc,
                        int n, int s_lo, int s_hi, int l_lo, int l_hi) {
    const int rpw = (n + kDecWarps - 1) / kDecWarps;
    __syncthreads();  // the previous chunk's readers are done
    const int r_lo = max(warp * rpw, s_lo);
    const int r_hi = min((warp + 1) * rpw, s_hi);
    for (int r = r_lo; r < r_hi; ++r) {
      for (int c = lane; c < d; c += 32) {
        ks[r * ld + c] = to_float(kc[(size_t)r * d + c]);
        vs[r * ld + c] = to_float(vc[(size_t)r * d + c]);
      }
    }
    __syncthreads();

    // S = Q K^T for this warp's heads and this lane's keys
    float s[kDecMaxHeadsPerWarp][kT];
#pragma unroll
    for (int i = 0; i < kDecMaxHeadsPerWarp; ++i) {
#pragma unroll
      for (int t = 0; t < kT; ++t) s[i][t] = 0.f;
    }
    for (int c = 0; c < d; ++c) {
      float kv[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) kv[t] = ks[(lane + 32 * t) * ld + c];
#pragma unroll
      for (int i = 0; i < kDecMaxHeadsPerWarp; ++i) {
        if (i < nh) {
          const float qv = qs[(warp + kDecWarps * i) * d + c];
#pragma unroll
          for (int t = 0; t < kT; ++t) s[i][t] += qv * kv[t];
        }
      }
    }

    // online softmax, one head at a time, across the warp's lanes
#pragma unroll
    for (int i = 0; i < kDecMaxHeadsPerWarp; ++i) {
      if (i >= nh) continue;
      float mx = kDecNegInf;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int j = lane + 32 * t;
        s[i][t] = (j >= l_lo && j < l_hi) ? s[i][t] * scale : kDecNegInf;
        mx = fmaxf(mx, s[i][t]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int j = lane + 32 * t;
        const float p = (j >= l_lo && j < l_hi) ? expf(s[i][t] - m_new) : 0.f;
        sum += p;
        pw[i * CH + j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int u = 0; u < kU; ++u) acc[i][u] *= corr;
    }
    __syncwarp();

    // acc += P V over the staged rows
    for (int j = s_lo; j < s_hi; ++j) {
      float vv[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = lane + 32 * u;
        vv[u] = c < d ? vs[j * ld + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kDecMaxHeadsPerWarp; ++i) {
        if (i < nh) {
          const float p = pw[i * CH + j];
#pragma unroll
          for (int u = 0; u < kU; ++u) acc[i][u] += p * vv[u];
        }
      }
    }
  }

  // o points at this sequence's (H, D) rows of O
  __device__ void finish(T* __restrict__ o) const {
#pragma unroll
    for (int i = 0; i < kDecMaxHeadsPerWarp; ++i) {
      if (i >= nh) continue;
      const int row = warp + kDecWarps * i;
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int c = lane + 32 * u;
        if (c < d) o[(size_t)row * d + c] = from_float<T>(acc[i][u] / den);
      }
    }
  }
};

}  // namespace
