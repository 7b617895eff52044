// Tensor-core building blocks for the bfloat16 routes (sm_80 and later,
// built here for sm_90a): mma.sync m16n8k16 with float32 accumulators,
// ldmatrix (plain and transposed), 16-byte cp.async with zero fill, and the
// XOR swizzle of 16-byte chunks that keeps ldmatrix free of bank conflicts.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col (g = lane / 4,
// q = lane % 4; each A and B register holds two bf16, lower column or row
// first):
//   A (16 x 16, row-major): a0 (g, 2q..2q+1), a1 (g+8, 2q..), a2 (g, 8+2q..),
//                           a3 (g+8, 8+2q..)
//   B (16 x 8, k x n):      b0 (k 2q..2q+1, n g), b1 (k 8+2q.., n g)
//   C (16 x 8, float32):    c0 c1 (g, 2q..2q+1), c2 c3 (g+8, 2q..2q+1)
// ldmatrix.x4 loads four 8 x 8 matrices of bf16: lanes 8i .. 8i+7 give the
// row addresses of matrix i, and register i of lane t receives row t/4,
// columns 2(t%4)..+1 of matrix i (with .trans: column t/4, rows 2(t%4)..+1).
//
// A tile staged for ldmatrix is `rows` x C chunks of 8 bf16 (16 bytes),
// C a power of two.  Chunk c of row r lives at chunk swz<C>(r, c) of that
// row: eight consecutive rows at one logical chunk then fill all 32 banks,
// which an unpadded row of 128 bytes or more would put in one.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// the physical 16-byte chunk of logical chunk c in row r of a tile of C
// chunks a row
template <int C>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(C >= 2 && (C & (C - 1)) == 0, "chunks a row: a power of two >= 2");
  constexpr int kShift = C >= 8 ? 0 : (C == 4 ? 1 : 2);
  constexpr int kMask = (C >= 8 ? 8 : C) - 1;
  return c ^ ((r >> kShift) & kMask);
}

// byte offset of (row r, element col) in a swizzled tile of C chunks a row
template <int C>
__device__ __forceinline__ int swz_offset(int r, int col) {
  return (r * C + swz<C>(r, col >> 3)) * 16 + (col & 7) * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, bypassing L1; src_bytes < 16 zero-fills the
// rest (0: the whole chunk is zero and src is not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b on the tensor cores: bf16 inputs, float32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage a tile of `rows` x C chunks (row-major, `ld` elements a row in
// global memory) into a swizzled shared tile: thread t of `threads` copies
// chunks t, t + threads, ... (chunk i is row i / C, chunk i % C).  Row r is
// read when first_row <= r < valid_rows, and its elements col < valid_cols;
// everything else is zero.  With `vec` (ld a multiple of 8 and a 16-byte-aligned base)
// each chunk is one 16-byte cp.async, else eight 2-byte loads stored at
// once: a row that is not 16-byte aligned cannot go through cp.async.
template <int C>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                           int rows, long long ld, int valid_rows,
                                           int valid_cols, bool vec, int tid,
                                           int threads, int first_row = 0) {
  const uint32_t base = smem_u32(tile);
  for (int i = tid; i < rows * C; i += threads) {
    const int r = i / C;
    const int c = i % C;
    const int col = c * 8;
    const uint32_t dst = base + (r * C + swz<C>(r, c)) * 16;
    const bool live = r >= first_row && r < valid_rows && col < valid_cols;
    if (vec) {
      const __nv_bfloat16* p = live ? src + r * ld + col : src;
      cp_async16(dst, p, live ? 16 : 0);
    } else {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        v[e] = (live && col + e < valid_cols) ? src[r * ld + col + e]
                                              : __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(reinterpret_cast<char*>(tile) + (dst - base)) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

// The same copy of a tile that lies wholly inside its array (ROWS rows,
// all C chunks, 16-byte aligned rows): thread t's chunks are rows
// t / C + j * (threads / C) at chunk t % C, and their swizzled place in a
// row does not change with j, so one source pointer and one shared address
// stepped by constants replace the per-chunk index arithmetic.
template <int C, int ROWS, int THREADS>
__device__ __forceinline__ void stage_tile_full(__nv_bfloat16* tile,
                                                const __nv_bfloat16* src,
                                                long long ld, int tid) {
  constexpr int kStep = THREADS / C;  // rows one pass of the threads covers
  static_assert(THREADS % C == 0, "whole rows a pass");
  static_assert(kStep % 8 == 0, "swz<C> repeats every 8 rows, so every kStep rows");
  const int r0 = tid / C;
  const int c = tid % C;
  const uint32_t dst = smem_u32(tile) + (r0 * C + swz<C>(r0, c)) * 16;
  const __nv_bfloat16* p = src + r0 * ld + c * 8;
#pragma unroll
  for (int j = 0; j < (ROWS + kStep - 1) / kStep; ++j) {
    if (ROWS % kStep == 0 || r0 + j * kStep < ROWS) {
      cp_async16(dst + j * kStep * C * 16, p + j * kStep * ld, 16);
    }
  }
}

}  // namespace
