// The warp-level products of the attention kernels (flash_attention.cu:
// forward; flash_attention_bwd.cu: the two backward programs), by dtype.
//
// A warp owns 16 rows of its block's tile. Operands lie row-major in shared
// memory with row width `ld` = row_width<T, D>(), or are fragments the warp
// holds in registers:
//   load_rows:  the A fragments of the warp's 16 rows over all of D, loaded
//               once and held for a whole panel loop (the forward's Q);
//   scores:     c[nt] += A . B^T over D, for the panel's rows nt*8 .. +7,
//               A read from shared memory at each call or held;
//   accumulate: acc[dt] += P . B over NT*8 panel rows, P the C fragments of
//               `scores` (16 x NT*8), B's columns dt*8 .. +7 of D; kHiLo
//               keeps P in f32 (bf16: hi + lo parts; f32 always does).
// bf16 runs on m16n8k16 with ldmatrix (.trans where B lies keyed by the
// contraction index); f32 as three TF32 m16n8k8 products per product
// (tile_mma.cuh). The tensor cores truncate the f32 sums they form: each k
// step of a score and each panel's share of an accumulation is summed in a
// fresh fragment and added in f32 (round to nearest). P never leaves
// registers: the C fragment of `scores` is the A fragment of `accumulate`
// (bf16: two n8 C tiles pack into one k16 A tile; tf32: the k index is
// permuted instead, tile_mma.cuh). Rows are padded to D + 4 floats (rows 4
// banks apart: the A-style reads [g][t] and, 2 x (D + 4) = 8 mod 32, the
// permuted reads [2t][g] hit 32 distinct banks) or D + 8 bf16 (ldmatrix's
// eight 16-byte rows in distinct bank groups).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tile_mma.cuh"

namespace svt {

// a compiler barrier between the n-tiles of an unrolled score loop: left
// alone, ptxas may load every step's fragments up front and spill (as it did
// for the backward's score loop unrolled over D)
__device__ __forceinline__ void compiler_fence() {
  asm volatile("" ::: "memory");
}

template <typename T>
struct Warp;

template <>
struct Warp<float> {
  static constexpr int kPad = 4;

  // the warp's rows over D, split once: k step ks holds A[g][8 ks + t],
  // A[g + 8][8 ks + t], A[g][8 ks + t + 4], A[g + 8][8 ks + t + 4]
  template <int D>
  struct Held {
    Tf32x3<4> ks[D / 8];
  };

  static __device__ __forceinline__ void load_a(Tf32x3<4>& fa, const float* a,
                                                int ld, int ks, int lane) {
    const float* a0 = a + (lane >> 2) * ld + ks * 8 + (lane & 3);
    fa.split(0, a0[0]);
    fa.split(1, a0[8 * ld]);
    fa.split(2, a0[4]);
    fa.split(3, a0[8 * ld + 4]);
  }

  template <int D>
  static __device__ __forceinline__ void load_rows(Held<D>& h, const float* a,
                                                   int ld, int lane) {
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) load_a(h.ks[ks], a, ld, ks, lane);
  }

  // one k step of the scores of panel rows nt*8 .. +7, summed in a fresh
  // fragment and added in f32: a chain over D inside the tensor cores would
  // bias S toward zero, and P = exp(S - m) with it
  static __device__ __forceinline__ void score_step(float (&c)[4],
                                                    const Tf32x3<4>& fa,
                                                    const float* b, int ld,
                                                    int nt, int ks, int lane) {
    const float* b0 = b + (nt * 8 + (lane >> 2)) * ld + ks * 8 + (lane & 3);
    Tf32x3<2> fb;
    fb.split(0, b0[0]);
    fb.split(1, b0[4]);
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_tf32x3(part, fa, fb);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += part[i];
  }

  template <int D, int NT>
  static __device__ __forceinline__ void scores(float (&c)[NT][4],
                                                const float* a, const float* b,
                                                int ld, int lane) {
    // rolled over D: unrolled, ptxas loads every step's fragments up front
#pragma unroll 1
    for (int ks = 0; ks < D / 8; ++ks) {
      Tf32x3<4> fa;
      load_a(fa, a, ld, ks, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        score_step(c[nt], fa, b, ld, nt, ks, lane);
    }
  }

  // the same sums (each c[nt] over ks in the same order), A held
  template <int D, int NT>
  static __device__ __forceinline__ void scores(float (&c)[NT][4],
                                                const Held<D>& h,
                                                const float* b, int ld,
                                                int lane) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int ks = 0; ks < D / 8; ++ks)
        score_step(c[nt], h.ks[ks], b, ld, nt, ks, lane);
      compiler_fence();
    }
  }

  template <int D, int NT, bool kHiLo>
  static __device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                                    const float (&p)[NT][4],
                                                    const float* b, int ld,
                                                    int lane) {
    const int g = lane >> 2, t = lane & 3;
    // C's (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1) as A's a0, a2,
    // a1, a3: panel row 2t is k = t, row 2t + 1 is k = t + 4
    Tf32x3<4> fa[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      fa[nt].split(0, p[nt][0]);
      fa[nt].split(1, p[nt][2]);
      fa[nt].split(2, p[nt][1]);
      fa[nt].split(3, p[nt][3]);
    }
    const float* b0 = b + 2 * t * ld + g;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      // this panel's share, summed in the tensor cores (3 NT products), then
      // added to the running sum in f32 (tile_mma.cuh: truncation)
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        Tf32x3<2> fb;
        fb.split(0, b0[nt * 8 * ld + dt * 8]);
        fb.split(1, b0[(nt * 8 + 1) * ld + dt * 8]);
        mma_tf32x3(part, fa[nt], fb);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[dt][i] += part[i];
    }
  }
};

template <>
struct Warp<__nv_bfloat16> {
  static constexpr int kPad = 8;
  using T = __nv_bfloat16;

  // the warp's rows over D: k step ks is one m16n8k16 A fragment
  template <int D>
  struct Held {
    uint32_t ks[D / 16][4];
  };

  static __device__ __forceinline__ void load_a(uint32_t (&fa)[4], const T* a,
                                                int ld, int ks, int lane) {
    ldmatrix_x4(fa, a + (lane & 15) * ld + ks * 16 + (lane >> 4) * 8);
  }

  template <int D>
  static __device__ __forceinline__ void load_rows(Held<D>& h, const T* a,
                                                   int ld, int lane) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) load_a(h.ks[ks], a, ld, ks, lane);
  }

  template <int NT>
  static __device__ __forceinline__ void score_step(float (&c)[NT][4],
                                                    const uint32_t (&fa)[4],
                                                    const T* b, int ld, int ks,
                                                    int lane) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // rows np*16 + 0..7 then + 8..15, k halves 0..7 and 8..15 of each
      uint32_t fb[4];
      ldmatrix_x4(fb, b + (np * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                          ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(c[2 * np], fa, fb[0], fb[1]);
      mma_bf16(c[2 * np + 1], fa, fb[2], fb[3]);
    }
  }

  template <int D, int NT>
  static __device__ __forceinline__ void scores(float (&c)[NT][4],
                                                const T* a, const T* b, int ld,
                                                int lane) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t fa[4];
      load_a(fa, a, ld, ks, lane);
      score_step<NT>(c, fa, b, ld, ks, lane);
    }
  }

  template <int D, int NT>
  static __device__ __forceinline__ void scores(float (&c)[NT][4],
                                                const Held<D>& h, const T* b,
                                                int ld, int lane) {
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      score_step<NT>(c, h.ks[ks], b, ld, ks, lane);
  }

  static __device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }

  template <int D, int NT, bool kHiLo>
  static __device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                                    const float (&p)[NT][4],
                                                    const T* b, int ld,
                                                    int lane) {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      // C tiles 2kk and 2kk + 1 (k 0..7 and 8..15) as one k16 A tile:
      // a0, a1 from tile 2kk's rows g and g + 8, a2, a3 from tile 2kk + 1's
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x0 = p[2 * kk + (r >> 1)][2 * (r & 1)];
        const float x1 = p[2 * kk + (r >> 1)][2 * (r & 1) + 1];
        hi[r] = pack_bf16(x0, x1);
        if constexpr (kHiLo)
          lo[r] = pack_bf16(x0 - bf16_round(x0), x1 - bf16_round(x1));
      }
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        // k rows kk*16 + 0..15, columns dp*16 + 0..7 then + 8..15
        uint32_t fb[4];
        ldmatrix_x4_trans(
            fb, b + (kk * 16 + (lane & 15)) * ld + dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], hi, fb[0], fb[1]);
        mma_bf16(acc[2 * dp + 1], hi, fb[2], fb[3]);
        if constexpr (kHiLo) {
          mma_bf16(acc[2 * dp], lo, fb[0], fb[1]);
          mma_bf16(acc[2 * dp + 1], lo, fb[2], fb[3]);
        }
      }
    }
  }
};

template <typename T, int D>
__host__ __device__ constexpr int row_width() {
  return D + Warp<T>::kPad;
}

}  // namespace svt
