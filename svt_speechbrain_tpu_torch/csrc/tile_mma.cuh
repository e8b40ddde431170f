// One warp-wide 16x8x16 tile product, shared by the port's kernels.
//
// The accumulator is the C fragment of `mma.sync.m16n8k16`: lane
// (g = lane / 4, t = lane % 4) holds c[0], c[1] = C[g][2t], C[g][2t + 1] and
// c[2], c[3] = C[g + 8][2t], C[g + 8][2t + 1].
//   A: 16 rows x 16 k, row-major, row stride lda (elements), in shared memory.
//   B: 8 columns x 16 k, column n at B + n * ldb with k contiguous.
// bf16 runs on the tensor cores (f32 accumulate). f32 runs the same product
// in full f32 FMAs on the CUDA cores (no TF32), computing the same fragment.
//
// int8 is a 16x8x32 product (`mma.sync.m16n8k32`, s8 x s8 -> s32, exact):
// the same C fragment with int accumulators, A 16 rows x 32 k and B 8
// columns x 32 k, both with k contiguous (one byte per element), lda and ldb
// in bytes and multiples of 4. Lane (g, t) reads the 4 consecutive k at
// 4t (and at 16 + 4t) of rows g and g + 8 of A and of column g of B.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace svt {

template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float to_f32(float v) { return v; }
  static __device__ __forceinline__ float from_f32(float v) { return v; }
  // row padding (elements) that keeps the fragment reads bank-conflict free
  static constexpr int kPad = 1;
};

template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16(v);
  }
  static constexpr int kPad = 8;
};

template <typename T> struct Tile;

template <> struct Tile<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float c[4],
                                             const __nv_bfloat16* A, int lda,
                                             const __nv_bfloat16* B, int ldb,
                                             int lane) {
    const int g = lane >> 2, t = lane & 3;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(A + g * lda + 2 * t);
    const uint32_t a1 =
        *reinterpret_cast<const uint32_t*>(A + (g + 8) * lda + 2 * t);
    const uint32_t a2 =
        *reinterpret_cast<const uint32_t*>(A + g * lda + 2 * t + 8);
    const uint32_t a3 =
        *reinterpret_cast<const uint32_t*>(A + (g + 8) * lda + 2 * t + 8);
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(B + g * ldb + 2 * t);
    const uint32_t b1 =
        *reinterpret_cast<const uint32_t*>(B + g * ldb + 2 * t + 8);
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
};

template <> struct Tile<float> {
  static __device__ __forceinline__ void mma(float c[4], const float* A,
                                             int lda, const float* B, int ldb,
                                             int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* a_lo = A + g * lda;
    const float* a_hi = A + (g + 8) * lda;
    const float* b_0 = B + (2 * t) * ldb;
    const float* b_1 = B + (2 * t + 1) * ldb;
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      const float x0 = a_lo[kk], x1 = a_hi[kk];
      const float y0 = b_0[kk], y1 = b_1[kk];
      c[0] = fmaf(x0, y0, c[0]);
      c[1] = fmaf(x0, y1, c[1]);
      c[2] = fmaf(x1, y0, c[2]);
      c[3] = fmaf(x1, y1, c[3]);
    }
  }
};

template <> struct Tile<int8_t> {
  static __device__ __forceinline__ void mma(int c[4], const int8_t* A,
                                             int lda, const int8_t* B, int ldb,
                                             int lane) {
    const int g = lane >> 2, t = lane & 3;
    const uint32_t a0 = *reinterpret_cast<const uint32_t*>(A + g * lda + 4 * t);
    const uint32_t a1 =
        *reinterpret_cast<const uint32_t*>(A + (g + 8) * lda + 4 * t);
    const uint32_t a2 =
        *reinterpret_cast<const uint32_t*>(A + g * lda + 4 * t + 16);
    const uint32_t a3 =
        *reinterpret_cast<const uint32_t*>(A + (g + 8) * lda + 4 * t + 16);
    const uint32_t b0 = *reinterpret_cast<const uint32_t*>(B + g * ldb + 4 * t);
    const uint32_t b1 =
        *reinterpret_cast<const uint32_t*>(B + g * ldb + 4 * t + 16);
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  }
};

}  // namespace svt
