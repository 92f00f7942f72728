// Pieces shared by the flash-attention kernels (flash_fwd.cu, flash_bwd.cu):
// the tile geometry, the bf16 tensor-core product, the hi/lo split that
// carries fp32 through bf16 products, the fragment loads, and the exp2 and
// the order of work items of the warp-specialised kernels.
//
// Fragments are those of mma.sync.m16n8k16 (row.col, bf16 in, fp32 out).
// A lane is g = lane / 4 (row of an 8-row group) and t = lane % 4:
// - A (16 x 16): a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..),
//   a3 = (g+8, 2t+8..);
// - B (16 x 8): b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g);
// - C (16 x 8): c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// Shared tiles hold rows of D bf16 values as 32-bit words (pairs), padded by
// 8 values a row so that the fragment loads of a warp fall in distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kBlockQ = 64;   // query rows per tile (16 per warp)
constexpr int kBlockK = 64;   // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// words per shared row of a tile of head_dim D
template <int D>
__host__ __device__ constexpr int lds() { return (D + 8) / 2; }

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b, and for SPLIT operands (hi + lo parts) c += a b as
// hi*hi + hi*lo + lo*hi: about 16 mantissa bits of each fp32 operand.
template <bool SPLIT>
__device__ __forceinline__ void mma_split(float* c, const uint32_t* a,
                                          const uint32_t* al, uint32_t b0,
                                          uint32_t b1, uint32_t bl0,
                                          uint32_t bl1) {
  mma_bf16(c, a, b0, b1);
  if constexpr (SPLIT) {
    mma_bf16(c, a, bl0, bl1);
    mma_bf16(c, al, b0, b1);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// Split a pair of floats into bf16 hi and bf16 lo = x - hi (packed pairs).
__device__ __forceinline__ void split_pair(float x, float y, uint32_t* hi,
                                           uint32_t* lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  *hi = *reinterpret_cast<uint32_t*>(&h);
  *lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

// A pair of fp32 values as packed bf16: rounded, or split into hi and lo.
template <bool SPLIT>
__device__ __forceinline__ void to_bf16_pair(float x, float y, uint32_t* hi,
                                             uint32_t* lo) {
  if constexpr (SPLIT) {
    split_pair(x, y, hi, lo);
  } else {
    *hi = pack_bf16(x, y);
  }
}

// The C fragments of n-tiles 2j and 2j+1 (a 16 x 16 block) as the A
// fragment of one k-step of the next product.
template <bool SPLIT>
__device__ __forceinline__ void c_to_a(const float* c0, const float* c1,
                                       uint32_t* a, uint32_t* al) {
  to_bf16_pair<SPLIT>(c0[0], c0[1], &a[0], &al[0]);
  to_bf16_pair<SPLIT>(c0[2], c0[3], &a[1], &al[1]);
  to_bf16_pair<SPLIT>(c1[0], c1[1], &a[2], &al[2]);
  to_bf16_pair<SPLIT>(c1[2], c1[3], &a[3], &al[3]);
}

// Copy rows [row0, row0 + rows) of one head into shared memory as bf16 pairs
// (hi, and lo when the input is fp32); rows >= S are zero.
template <typename T, int D, bool SPLIT>
__device__ __forceinline__ void load_tile(const T* base, long long row_stride,
                                          int row0, int S, int rows,
                                          uint32_t* hi, uint32_t* lo) {
  constexpr int kPairs = D / 2;
  constexpr int kLds = lds<D>();
  for (int idx = threadIdx.x; idx < rows * kPairs; idx += kThreads) {
    const int r = idx / kPairs;
    const int c = idx % kPairs;
    const int row = row0 + r;
    uint32_t h = 0u, l = 0u;
    if (row < S) {
      const T* src = base + (long long)row * row_stride + 2 * c;
      if constexpr (SPLIT) {
        const float2 x = *reinterpret_cast<const float2*>(src);
        split_pair(x.x, x.y, &h, &l);
      } else {
        h = *reinterpret_cast<const uint32_t*>(src);
      }
    }
    hi[r * kLds + c] = h;
    if constexpr (SPLIT) lo[r * kLds + c] = l;
  }
}

// A fragment of k-step ks over rows r0 .. r0 + 15 of a shared tile X:
// A[m][k] = X[r0 + m][16 ks + k].
template <int D>
__device__ __forceinline__ void load_a(const uint32_t* s, int r0, int ks,
                                       int g, int t, uint32_t* a) {
  constexpr int kLds = lds<D>();
  const int w = ks * 8 + t;
  a[0] = s[(r0 + g) * kLds + w];
  a[1] = s[(r0 + g + 8) * kLds + w];
  a[2] = s[(r0 + g) * kLds + w + 4];
  a[3] = s[(r0 + g + 8) * kLds + w + 4];
}

// B fragment of k-step ks for the 8 columns n0 .. n0 + 7 where
// B[k][n] = X[n0 + n][16 ks + k]: a product with X transposed (Q K^T).
template <int D>
__device__ __forceinline__ void load_b_rows(const uint32_t* s, int n0, int ks,
                                            int g, int t, uint32_t* b0,
                                            uint32_t* b1) {
  constexpr int kLds = lds<D>();
  const int w = (n0 + g) * kLds + ks * 8 + t;
  *b0 = s[w];
  *b1 = s[w + 4];
}

// B fragment for the rows k0 .. k0 + 15 and the 8 columns n0 .. n0 + 7 where
// B[k][n] = X[k0 + k][n0 + n]: a product with X as it lies (P V). The two
// values of a register come from two rows, so they are gathered 16 bits at a
// time.
template <int D>
__device__ __forceinline__ void load_b_cols(const uint32_t* s, int k0, int n0,
                                            int g, int t, uint32_t* b0,
                                            uint32_t* b1) {
  constexpr int kRow = 2 * lds<D>();  // 16-bit elements per shared row
  const unsigned short* s16 = reinterpret_cast<const unsigned short*>(s);
  const int e0 = (k0 + 2 * t) * kRow + n0 + g;
  const int e8 = e0 + 8 * kRow;
  *b0 = (uint32_t)s16[e0] | ((uint32_t)s16[e0 + kRow] << 16);
  *b1 = (uint32_t)s16[e8] | ((uint32_t)s16[e8 + kRow] << 16);
}

// 2^x in one ex2.approx instruction (about 2 ulp), without exp2f's extra
// handling of denormal results, which round to 0 in bf16 P anyway.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The work item of round `round` for this block of a persistent grid: item
// i of even rounds and item gridDim.x - 1 - i of odd ones, so that a block
// that drew a long item (items are numbered longest first) in one round
// draws a short one in the next.
__device__ __forceinline__ int work_index(int round) {
  const int grid = gridDim.x, block = blockIdx.x;
  return round * grid + (round % 2 ? grid - 1 - block : block);
}

// Store one C fragment's pair (row, cols col, col + 1) as T.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float x, float y) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
  }
}

}  // namespace flash
