// Warp-wide tile products on the tensor cores (`mma.sync`), shared by the
// attention kernels and conv_frontend.cu: fragments held by the caller, f32
// as three TF32 products and bf16 with ldmatrix.
//
// The accumulator is the C fragment of `mma.sync.m16n8k16`: lane
// (g = lane / 4, t = lane % 4) holds c[0], c[1] = C[g][2t], C[g][2t + 1] and
// c[2], c[3] = C[g + 8][2t], C[g + 8][2t + 1].
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace svt {

template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
};

template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16(v);
  }
};

// ---------------------------------------------------------------------------
// Register-level pieces (the attention kernels, the conv frontend):
// fragments held by the caller, products on the tensor cores in both dtypes.
//
// f32 as three TF32 products (CUTLASS's OpMultiplyAddFastF32): x = big +
// small with big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big); then
// a.b ~ small_a.big_b + big_a.small_b + big_a.big_b, accumulated in f32 by
// `mma.sync.m16n8k8` (tf32 in, f32 out). Only small_a.small_b (2^-22 of the
// product) is dropped: about 21 of f32's 24 mantissa bits per operand.
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8): a0 = A[g][t], a1 = A[g + 8][t], a2 = A[g][t + 4],
//               a3 = A[g + 8][t + 4];
//   B (8 x 8):  b0 = B[t][g], b1 = B[t + 4][g];
//   C (16 x 8): as m16n8k16's (top of this file).
// A C fragment is an A fragment of the next product when that product's k
// index is permuted: C's column 2t is k = t and 2t + 1 is k = t + 4, so C's
// c0, c1, c2, c3 are A's a0, a2, a1, a3 (the B operand reads its k rows in
// the same order).
// ---------------------------------------------------------------------------

// cvt.rna.tf32.f32 as two integer operations: the magnitude rounded to 10
// explicit mantissa bits, ties away from zero. Bit for bit the instruction's
// result for every finite x (and for infinities and quiet NaNs); ptxas
// expands the instruction into about twice as many operations, which guard
// the other NaNs, and the f32 kernels split a value for every operand
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// N fragment registers, each split into its big and small TF32 parts
template <int N>
struct Tf32x3 {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void split(int i, float x) {
    big[i] = tf32_rna(x);
    small[i] = tf32_rna(x - __uint_as_float(big[i]));
  }
};

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b in about f32: the two small cross terms first, then big.big.
// The tensor cores truncate the f32 sums they form, so a long chain
// accumulated inside them drifts toward zero: a caller keeps chains short
// and adds their sums with f32 adds (flash_attention_bwd.cu).
__device__ __forceinline__ void mma_tf32x3(float (&c)[4], const Tf32x3<4>& a,
                                           const Tf32x3<2>& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// bf16 on `mma.sync.m16n8k16` (fragments as at the top of this file), with
// A and B loaded by `ldmatrix` (four 8 x 8 b16 matrices, rows of 16 bytes at
// 16-byte aligned addresses; `.trans` delivers the transposed matrices)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// two 8 x 8 b16 matrices: lanes 0-7 address the first's rows, 8-15 the
// second's (the other lanes' addresses are not read)
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// two neighbouring outputs of a C fragment row
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// two f32 values rounded to bf16 in one register, `lo` in the low half (the
// lower k index of a fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace svt
