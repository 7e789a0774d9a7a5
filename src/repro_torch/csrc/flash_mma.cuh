// Tensor-core building blocks of the attention kernels' bf16 routes (K3
// forward, K4/K5 backward): ldmatrix fragments, the mma.sync m16n8k16 bf16
// product with f32 accumulation, bf16 packing of an accumulator as the A
// fragment of the next product, and tiles staged as bf16 rows padded by 16
// bytes (8 rows of an ldmatrix then hit 8 distinct bank groups).
//
// Fragment layout of m16n8k16 (g = lane / 4, tg = lane % 4): the f32
// accumulator holds (row g, cols 2tg, 2tg+1) in elements 0, 1 and (row
// g + 8, the same cols) in 2, 3, so two n-tiles' accumulators pack into one
// 16 x 16 A fragment.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {

typedef __nv_bfloat16 bf16;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// This lane's ldmatrix address for the 16 x 16 block at (r0, c0) of a tile
// with rows of sr elements. frag_a: as an A fragment (ldsm_x4), or, with
// ldsm_x4_trans, as the B fragments of two n-tiles (c0, c0 + 8) of a
// product whose k runs down the rows. frag_b: as the B fragments of two
// n-tiles (rows r0, r0 + 8) of a product whose k runs along the rows
// (ldsm_x4; registers 0, 1 are the first n-tile, 2, 3 the second).
__device__ __forceinline__ const bf16* frag_a(const bf16* t, int sr, int r0, int c0, int lane) {
  return t + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * sr + c0 + (lane >> 4) * 8;
}
__device__ __forceinline__ const bf16* frag_b(const bf16* t, int sr, int r0, int c0, int lane) {
  return t + (r0 + (lane & 7) + (lane >> 4) * 8) * sr + c0 + ((lane >> 3) & 1) * 8;
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as one bf16x2 register, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-step kk made of the accumulators of n-tiles 2kk and
// 2kk + 1 (a 16 x 16 block of a product's result), rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_as_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// ROWS x DHP tile of a (B, L, N, dh) tensor from local row l0 into shared
// memory rows of DHP + 8 elements, zero past L and past dh, by the NT
// threads of the block. With ``vec`` (dh % 8 == 0 and 16-byte aligned rows)
// as cp.async 16-byte chunks, else element by element.
template <int NT, int ROWS, int DHP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long sl, int l0, int L,
                                          int dh, bool vec) {
  constexpr int SR = DHP + 8;
  constexpr int CH = DHP / 8;
  for (int i = threadIdx.x; i < ROWS * CH; i += NT) {
    const int r = i / CH, d = (i % CH) * 8, l = l0 + r;
    bf16* to = dst + r * SR + d;
    if (vec) {
      const bool in = l < L && d < dh;
      cp_async16(to, in ? src + (long long)l * sl + d : src, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        to[e] = (l < L && d + e < dh) ? src[(long long)l * sl + d + e] : __float2bfloat16(0.f);
    }
  }
}

}  // namespace flash
