// wav2vec2 conv frontend, one layer per launch: strided conv + bias +
// per-frame LayerNorm over channels + GELU.
//
// Replaces the TPU kernel svt_speechbrain_tpu/ops/conv_frontend.py
// `fused_conv_frontend` (`_frontend_kernel`, `pallas_call` at `:239`),
// which ran all seven layers of a 32-frame tile inside VMEM. On Hopper the
// deepest intermediate of one tile (the first conv's 2063 x 512 output) is
// about 2 MB in bf16 against 227 KB of shared memory, so each of the seven
// layers is one launch and intermediates go to device memory.
//
// Channel-last input makes the conv a GEMM with strided rows and no im2col:
// output frame t reads the k * C_in contiguous elements of input rows
// [s*t, s*t + k), so A[t] = x + t * s * C_in with K = k * C_in. The packed
// weight is W^T (C, K) with K index = tap * C_in + c_in. Each output row is
// then LayerNorm'd over its C channels in f32 (two passes: the mean, then
// the mean of squared deviations, eps inside the rsqrt), GELU'd (tanh form
// in f32 for bf16, as the TPU kernel's `_ln_gelu`; erff for f32, within a
// few ulp of the exact erf the plain version uses) and cast once.
//
// What bounds it on the H100, at wav (8, 80000) in bf16: layers 1-6
// (C_in = C = 512, K 1536 or 1024) by their products, 194.97 of the call's
// 196.3 GFLOP (0.198 ms at 989 TFLOP/s; in f32 by three TF32 products each
// at 495 TFLOP/s, 1.19 ms); layer 0 (C_in = 1, K = 10) by its bytes, the
// 131 MB of its output (0.040 ms at 3.35 TB/s).
//
// Layers 1-6: a 2-block cluster owns BM frames; each block computes half
// of the C columns, and the two exchange the LayerNorm's per-row partial
// sums through distributed shared memory, so the reductions stay on the
// chip. Against the limits of the first version (PERF.md, section 6):
//   * weights streamed from L2 once for every 32 frames: a weight slab now
//     serves BM = 128 frames (bf16; 64 in f32), so W^T crosses L2 1.5 GB a
//     call at (8, 80000) instead of 6.1 (A, read by both blocks of a
//     cluster, adds 0.8 GB). BM 64 x all C in one block (3.1 GB) and BM 128
//     in two column halves in one block (the first half parked in shared
//     memory) were slower on the card (PERF.md, the variant table);
//   * staging by scalar loads with two barriers a 16-wide slab: A and W^T
//     slabs come by 16-byte cp.async (every A row is one contiguous span at
//     a 16-byte aligned stride, since the kernel wrote the previous layer
//     itself; rows past T_out are zero-filled by the copy) into a ring of
//     stages, one barrier a slab, later slabs in flight while one is
//     multiplied;
//   * fragments re-read from shared memory for every product: bf16 at
//     C = 512 (the main path) runs on wgmma (`conv_ln_gelu_wgmma_kernel`):
//     two warpgroups each own 64 frames x 256 columns (m64n256k16, 128 f32
//     accumulators a thread) and the tensor cores read A and W^T from the
//     ring, laid out in 128-byte swizzled rows, while the next slabs land.
//     f32 and the narrower C run `conv_ln_gelu_kernel` on mma.sync: a warp
//     owns a 64 x 64 tile (or smaller), loads its A fragments of a k step
//     once (ldmatrix for bf16) and holds them across its n-tiles, and each
//     B fragment across its m-tiles; rows are padded so that the fragment
//     reads are free of bank conflicts;
//   * scattered 2-byte stores: the epilogue (bias, the two LayerNorm passes
//     and GELU in f32 registers) writes each warp's 16-row band through a
//     small staging tile in the drained ring, then to device memory as
//     16-byte stores, full 128-byte lines (512-byte rows on wgmma);
//   * f32 on FMAs (67 TFLOP/s, 2.93 ms bound): f32 takes the mma.sync body
//     with each product as three TF32 mma.sync.m16n8k8 (big/small split,
//     tile_mma.cuh). The tensor cores truncate the f32 sums they form, so
//     each k step of 8 is summed in a fresh fragment and added to the
//     accumulator in f32: no chain over K = 1536 runs inside them.
// Layer 0 (`conv_ln_gelu_first_kernel`): rows 5 samples apart (10 or 20
// bytes), at any alignment (an odd-length wav or a sliced view), so no
// 16-byte row copy applies: a block loads its contiguous span of
// 5 (BM - 1) + 10 samples with coalesced loads, W^T (C x 10) transposed
// into shared memory, and forms its 10-tap products on f32 FMAs into the
// same fragment layout, then the same epilogue.
//
// Each block owns its output columns of its rows, so every run gives the
// same bits. Requirements: C in {64, 128, 256, 512} for every layer; x, W^T
// and out contiguous, and for layers 1-6 16-byte aligned (the C entry
// refuses others); bias, gamma, beta f32. chip_smoke.py phase 1 holds every
// instantiation to no spills.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "tile_mma.cuh"
#include "wgmma.cuh"

// Tiles (chosen on an H100 with tools/tune_conv_frontend.py, PERF.md):
// the f32 mma.sync body's BM and BK, the mma.sync ring's stages and layer
// 0's BM. bf16 at C = 512 always runs on wgmma (conv_ln_gelu_wgmma_kernel);
// the bf16 mma.sync body serves C 64-256 at BM 128, BK 32.
#ifndef SVT_CONV_F32_BM
#define SVT_CONV_F32_BM 64
#endif
#ifndef SVT_CONV_F32_BK
#define SVT_CONV_F32_BK 32
#endif
#ifndef SVT_CONV_STAGES
#define SVT_CONV_STAGES 3
#endif
#ifndef SVT_CONV_L0_BM
#define SVT_CONV_L0_BM 32
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = SVT_CONV_STAGES;
constexpr int kTaps0 = 10, kStride0 = 5;   // layer 0
static_assert(kStages >= 2, "stages");

template <typename T>
struct Prec;

template <>
struct Prec<float> {
  static constexpr int kBM = SVT_CONV_F32_BM;
  static constexpr int kBK = SVT_CONV_F32_BK;
  static constexpr int kPad = 4;  // rows 4 banks apart: [g][t] reads distinct
};

template <>
struct Prec<__nv_bfloat16> {
  static constexpr int kBM = 128;
  static constexpr int kBK = 32;
  static constexpr int kPad = 8;  // ldmatrix's 8 rows in distinct bank groups
};

// A block of BM frames x CN columns a pass (C / SPLIT), 8 warps: WM warps
// over the rows, WN over the columns; a warp owns MT m-tiles of 16 rows and
// NT n-tiles of 8 columns. By default a warp's tile is at most 64 rows and
// at least 8 columns.
constexpr int warp_rows(int bm, int cn) {
  return (bm >= 128 ? 2 : 1) > 64 / cn ? (bm >= 128 ? 2 : 1) : 64 / cn;
}

template <typename T, int C_, int BM_, int SPLIT,
          int WM_ = warp_rows(BM_, C_ / SPLIT)>
struct Geo {
  static constexpr int C = C_, BM = BM_, CN = C_ / SPLIT;
  static constexpr int WM = WM_;
  static constexpr int WN = kWarps / WM;
  static constexpr int MT = BM / WM / 16;
  static constexpr int WCOLS = CN / WN;
  static constexpr int NT = WCOLS / 8;
  static constexpr int R = 2 * MT;  // rows a thread holds
  static constexpr int BK = Prec<T>::kBK;
  static constexpr int LDK = BK + Prec<T>::kPad;  // ring row width
  static constexpr int SLD = WCOLS + 8;           // staging row width
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int kSlab = (BM + CN) * LDK;   // A rows, then W^T rows
  static constexpr size_t kRing = sizeof(T) * (size_t)kStages * kSlab;
  static constexpr size_t kStaging = sizeof(T) * (size_t)kWarps * 16 * SLD;
  static_assert(kWarps % WM == 0 && MT >= 1 && NT >= 1 && MT * NT * 4 <= 128,
                "accumulators");
  static_assert(BK % 16 == 0 && WCOLS * sizeof(T) % 16 == 0, "tiles");
};

template <typename T, int C>
using MainGeo = Geo<T, C, Prec<T>::kBM, 2>;
template <typename T, int C>
using FirstGeo = Geo<T, C, SVT_CONV_L0_BM, 1>;

struct Lane {
  int lane, g, tq, wm, wn;
};

template <class G>
__device__ __forceinline__ Lane lane_of() {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return Lane{lane, lane >> 2, lane & 3, warp / G::WN, warp % G::WN};
}

// the block row of this thread's row ri: m-tile ri / 2, rows g and g + 8
template <class G>
__device__ __forceinline__ int frag_row(int ri, const Lane& l) {
  return l.wm * G::MT * 16 + (ri >> 1) * 16 + (ri & 1) * 8 + l.g;
}

template <typename T>
__device__ __forceinline__ float gelu(float y) {
  if constexpr (std::is_same<T, float>::value) {
    return 0.5f * y * (1.0f + erff(y * 0.7071067811865476f));
  } else {
    return 0.5f * y *
           (1.0f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
  }
}

template <class G>
using Acc = float[G::MT][G::NT][4];

template <class G>
__device__ __forceinline__ void zero(Acc<G>& acc) {
#pragma unroll
  for (int mi = 0; mi < G::MT; ++mi)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;
}

// ------------------------------------------------------------- the products
// One slab (BK columns of K) of the A rows and W^T rows staged in the ring.
template <typename T, class G>
__device__ __forceinline__ void fetch_slab(T* st, const T* __restrict__ xa,
                                           long long row_stride, int rows,
                                           const T* __restrict__ w, int K,
                                           int k0) {
  constexpr int kPer = G::BK / G::VEC;  // 16-byte pieces a row
  constexpr int kA = G::BM * kPer, kW = G::CN * kPer;
#pragma unroll
  for (int j = 0; j < (kA + kThreads - 1) / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (kA % kThreads != 0 && i >= kA) break;
    const int r = i / kPer, c = (i % kPer) * G::VEC;
    const bool valid = r < rows;
    svt::cp_async16(st + r * G::LDK + c,
                    xa + (valid ? r * row_stride : 0LL) + k0 + c, valid);
  }
  T* sw = st + G::BM * G::LDK;
#pragma unroll
  for (int j = 0; j < (kW + kThreads - 1) / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    if (kW % kThreads != 0 && i >= kW) break;
    const int r = i / kPer, c = (i % kPer) * G::VEC;
    svt::cp_async16(sw + r * G::LDK + c, w + (long long)r * K + k0 + c, true);
  }
}

// acc += A . W^T over one staged slab: bf16 on m16n8k16, the warp's A
// fragments of a k step held across its n-tiles, each B fragment (two
// n-tiles a ldmatrix_x4) across its m-tiles
template <class G>
__device__ __forceinline__ void slab_product(Acc<G>& acc,
                                             const __nv_bfloat16* sa,
                                             const __nv_bfloat16* sw,
                                             const Lane& l) {
  constexpr int LDK = G::LDK;
  const __nv_bfloat16* a =
      sa + (l.wm * G::MT * 16 + (l.lane & 15)) * LDK + (l.lane >> 4) * 8;
  const __nv_bfloat16* b = sw +
                           (l.wn * G::WCOLS + (l.lane & 7) +
                            (l.lane >> 4) * 8) * LDK +
                           ((l.lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < G::BK / 16; ++ks) {
    uint32_t fa[G::MT][4];
#pragma unroll
    for (int mi = 0; mi < G::MT; ++mi)
      svt::ldmatrix_x4(fa[mi], a + mi * 16 * LDK + ks * 16);
#pragma unroll
    for (int np = 0; np < G::NT / 2; ++np) {
      uint32_t fb[4];
      svt::ldmatrix_x4(fb, b + np * 16 * LDK + ks * 16);
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi) {
        svt::mma_bf16(acc[mi][2 * np], fa[mi], fb[0], fb[1]);
        svt::mma_bf16(acc[mi][2 * np + 1], fa[mi], fb[2], fb[3]);
      }
    }
    if constexpr (G::NT % 2 == 1) {
      uint32_t fb[2];
      svt::ldmatrix_x2(fb, sw + (l.wn * G::WCOLS + (G::NT - 1) * 8 +
                                 (l.lane & 7)) * LDK +
                               ((l.lane >> 3) & 1) * 8 + ks * 16);
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi)
        svt::mma_bf16(acc[mi][G::NT - 1], fa[mi], fb[0], fb[1]);
    }
  }
}

// f32: each k step of 8 as three TF32 products summed in a fresh fragment,
// then added to the accumulator in f32 (tile_mma.cuh: truncation)
template <class G>
__device__ __forceinline__ void slab_product(Acc<G>& acc, const float* sa,
                                             const float* sw, const Lane& l) {
  constexpr int LDK = G::LDK;
  const float* a = sa + (l.wm * G::MT * 16 + l.g) * LDK + l.tq;
  const float* b = sw + (l.wn * G::WCOLS + l.g) * LDK + l.tq;
#pragma unroll
  for (int ks = 0; ks < G::BK / 8; ++ks) {
    svt::Tf32x3<4> fa[G::MT];
#pragma unroll
    for (int mi = 0; mi < G::MT; ++mi) {
      const float* p = a + mi * 16 * LDK + ks * 8;
      fa[mi].split(0, p[0]);
      fa[mi].split(1, p[8 * LDK]);
      fa[mi].split(2, p[4]);
      fa[mi].split(3, p[8 * LDK + 4]);
    }
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      const float* q = b + nt * 8 * LDK + ks * 8;
      svt::Tf32x3<2> fb;
      fb.split(0, q[0]);
      fb.split(1, q[4]);
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi) {
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        svt::mma_tf32x3(part, fa[mi], fb);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nt][e] += part[e];
      }
    }
  }
}

// acc = A . W^T over all of K through the ring; w is the pass's first
// W^T row. Ends with every copy landed (the ring may be reused after a
// barrier).
template <typename T, class G>
__device__ __forceinline__ void mainloop(Acc<G>& acc, T* ring,
                                         const T* __restrict__ xa,
                                         long long row_stride, int rows,
                                         const T* __restrict__ w, int K,
                                         const Lane& l) {
  zero<G>(acc);
  const int nk = K / G::BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {  // one group a slab
    if (s < nk)
      fetch_slab<T, G>(ring + s * G::kSlab, xa, row_stride, rows, w, K,
                       s * G::BK);
    svt::cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    svt::cp_async_wait<kStages - 2>();  // slab kb
    __syncthreads();  // landed for all; slab kb - 1 is consumed, so its
    const int next = kb + kStages - 1;  // stage refills
    if (next < nk)
      fetch_slab<T, G>(ring + (next % kStages) * G::kSlab, xa, row_stride,
                       rows, w, K, next * G::BK);
    svt::cp_async_commit();
    const T* st = ring + (kb % kStages) * G::kSlab;
    slab_product<G>(acc, st, st + G::BM * G::LDK, l);
  }
  svt::cp_async_wait<0>();
}

// --------------------------------------------------------------- epilogue
template <class G>
__device__ __forceinline__ void add_bias(Acc<G>& acc,
                                         const float* __restrict__ bias,
                                         int col0, const Lane& l) {
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt) {
    const int n = col0 + nt * 8 + 2 * l.tq;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int mi = 0; mi < G::MT; ++mi) {
      acc[mi][nt][0] += b0;
      acc[mi][nt][1] += b1;
      acc[mi][nt][2] += b0;
      acc[mi][nt][3] += b1;
    }
  }
}

// s[ri] += the thread's values of row ri (or their squared deviations from
// mean[ri])
template <class G, bool kSquares>
__device__ __forceinline__ void row_sums(float (&s)[G::R], const Acc<G>& acc,
                                         const float (&mean)[G::R]) {
#pragma unroll
  for (int mi = 0; mi < G::MT; ++mi)
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = 2 * mi + (e >> 1);
        const float v = acc[mi][nt][e];
        s[ri] += kSquares ? (v - mean[ri]) * (v - mean[ri]) : v;
      }
}

// the thread's partial row sums -> the block's sum of each of its rows:
// across the 4 lanes of a row, then across the WN warps of a row band
template <class G>
__device__ __forceinline__ void block_rows(float (&s)[G::R], float* red,
                                           const Lane& l) {
#pragma unroll
  for (int ri = 0; ri < G::R; ++ri) {
    s[ri] += __shfl_xor_sync(0xffffffffu, s[ri], 1);
    s[ri] += __shfl_xor_sync(0xffffffffu, s[ri], 2);
  }
  if (l.tq == 0) {
#pragma unroll
    for (int ri = 0; ri < G::R; ++ri)
      red[l.wn * G::BM + frag_row<G>(ri, l)] = s[ri];
  }
  __syncthreads();
#pragma unroll
  for (int ri = 0; ri < G::R; ++ri) {
    float tot = 0.0f;
#pragma unroll
    for (int w = 0; w < G::WN; ++w) tot += red[w * G::BM + frag_row<G>(ri, l)];
    s[ri] = tot;
  }
  __syncthreads();  // red is reused
}

// the cluster's two blocks' row sums, added in rank order (both blocks get
// the same bits); xr is this pass's exchange buffer
template <class G>
__device__ __forceinline__ void cluster_rows(float (&s)[G::R], float* xr,
                                             const Lane& l) {
  cg::cluster_group cluster = cg::this_cluster();
  if (l.wn == 0 && l.tq == 0) {
#pragma unroll
    for (int ri = 0; ri < G::R; ++ri) xr[frag_row<G>(ri, l)] = s[ri];
  }
  cluster.sync();
  const float* r0 = cluster.map_shared_rank(xr, 0);
  const float* r1 = cluster.map_shared_rank(xr, 1);
#pragma unroll
  for (int ri = 0; ri < G::R; ++ri) {
    const int r = frag_row<G>(ri, l);
    s[ri] = r0[r] + r1[r];
  }
}

// m-tile mi's 16 rows of the warp's columns [col0, col0 + WCOLS): LayerNorm
// affine and GELU, staged by the warp, then 16-byte stores of each row's
// piece (WCOLS * sizeof(T) bytes: a whole 128-byte line at WCOLS 64 in
// bf16); rows >= `rows` are not written
template <typename T, class G>
__device__ __forceinline__ void store_rows(
    const float (&v)[G::NT][4], int mi, const float (&mean)[G::R],
    const float (&rstd)[G::R], const float* __restrict__ gamma,
    const float* __restrict__ beta, int col0, T* stage, T* __restrict__ out,
    int rows, const Lane& l) {
#pragma unroll
  for (int nt = 0; nt < G::NT; ++nt) {
    const int n = col0 + nt * 8 + 2 * l.tq;
    const float g0 = gamma[n], g1 = gamma[n + 1];
    const float b0 = beta[n], b1 = beta[n + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ri = 2 * mi + h;
      const float y0 = (v[nt][2 * h] - mean[ri]) * rstd[ri] * g0 + b0;
      const float y1 = (v[nt][2 * h + 1] - mean[ri]) * rstd[ri] * g1 + b1;
      svt::store2(stage + (h * 8 + l.g) * G::SLD + nt * 8 + 2 * l.tq,
                  gelu<T>(y0), gelu<T>(y1));
    }
  }
  __syncwarp();
  constexpr int kPer = G::WCOLS / G::VEC;
  const int row0 = l.wm * G::MT * 16 + mi * 16;
#pragma unroll
  for (int i = l.lane; i < 16 * kPer; i += 32) {
    const int r = i / kPer, c = (i % kPer) * G::VEC;
    if (row0 + r < rows)
      *reinterpret_cast<uint4*>(out + (long long)(row0 + r) * G::C + col0 +
                                c) =
          *reinterpret_cast<const uint4*>(stage + r * G::SLD + c);
  }
  __syncwarp();
}

// ------------------------------------------------------------ layers 1-6
template <typename T, int C>
__host__ __device__ constexpr size_t ring_bytes() {
  using G = MainGeo<T, C>;
  return G::kRing > G::kStaging ? G::kRing : G::kStaging;
}

template <typename T, int C>
constexpr size_t main_smem_bytes() {
  using G = MainGeo<T, C>;
  // ring (and staging) | red (WN x BM) | exchange (2 x BM)
  return ring_bytes<T, C>() + 4 * ((size_t)G::WN * G::BM + 2 * G::BM);
}

// A 2-block cluster owns BM frames: block rank h computes columns
// [h C/2, (h + 1) C/2) and the two exchange their LayerNorm row sums.
template <typename T, int C>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    conv_ln_gelu_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                        const float* __restrict__ bias,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ out,
                        int tin, int k, int s, int tout, float eps) {
  using G = MainGeo<T, C>;
  constexpr int R = G::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + ring_bytes<T, C>());
  float* xred = red + G::WN * G::BM;

  const Lane l = lane_of<G>();
  const int b = blockIdx.y;
  const int tile = blockIdx.x >> 1;
  const int half = (int)cg::this_cluster().block_rank();
  const int t0 = tile * G::BM;
  const int rows = tout - t0;
  const int K = k * C;
  const long long row_stride = (long long)s * C;
  const T* xa = x + ((long long)b * tin + (long long)t0 * s) * C;
  const int col0 = half * G::CN + l.wn * G::WCOLS;  // the warp's columns

  float acc[G::MT][G::NT][4];
  mainloop<T, G>(acc, ring, xa, row_stride, rows,
                 wt + (long long)half * G::CN * K, K, l);

  float sum[R], mean[R], rstd[R];
#pragma unroll
  for (int ri = 0; ri < R; ++ri) sum[ri] = mean[ri] = 0.0f;
  add_bias<G>(acc, bias, col0, l);
  row_sums<G, false>(sum, acc, mean);
  block_rows<G>(sum, red, l);
  cluster_rows<G>(sum, xred, l);
#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    mean[ri] = sum[ri] / C;
    sum[ri] = 0.0f;
  }
  row_sums<G, true>(sum, acc, mean);
  block_rows<G>(sum, red, l);
  cluster_rows<G>(sum, xred + G::BM, l);
#pragma unroll
  for (int ri = 0; ri < R; ++ri) rstd[ri] = rsqrtf(sum[ri] / C + eps);

  // the ring is drained (block_rows' barriers): each warp stages in it
  T* stage = ring + (threadIdx.x >> 5) * 16 * G::SLD;
  T* orow = out + ((long long)b * tout + t0) * C;
#pragma unroll
  for (int mi = 0; mi < G::MT; ++mi)
    store_rows<T, G>(acc[mi], mi, mean, rstd, gamma, beta, col0, stage, orow,
                     rows, l);
  cg::this_cluster().sync();  // the peer's reads of xred are done
}

// -------------------------------------- layers 1-6, bf16 C 512 on wgmma
// The same function and cluster as conv_ln_gelu_kernel (BM 128),
// with the products on warpgroup MMAs: two warpgroups of 4 warps, each
// owning 64 frames x 256 columns (wgmma.m64n256k16, 128 f32 accumulators a
// thread), A and W^T read by the tensor cores from shared memory. Slabs of
// 64 columns of K (one 128-byte row a frame or a channel) come by 16-byte
// cp.async into a 4-stage ring in the 128-byte swizzled layout the MMA
// descriptors name (chunk c of row r at chunk c ^ (r % 8)); a slab's MMAs
// run asynchronously while the next slabs are in flight. A warp's
// accumulators are the m16n8 C fragments of its 16 rows x 32 n-tiles, so
// the epilogue is the mma.sync body's.
namespace wg {
// two slabs in flight ahead of the one multiplied, whose MMAs run on
// across the next barrier (three ahead with none left running was slower)
constexpr int kBM = 128, kBK = 64, kStages = 4, kAhead = kStages - 2;
constexpr int kRowBytes = kBK * 2;                     // a swizzle atom's row
constexpr int kSlabBytes = (kBM + 256) * kRowBytes;    // A rows, W^T rows
using G = Geo<__nv_bfloat16, 512, kBM, 2, kWarps>;     // a warp: 16 x 256
constexpr size_t kSmem = 1024 + (size_t)kStages * kSlabBytes +
                         4 * (size_t)(G::BM + 2 * G::BM);

// the descriptor, fences, commit and wait are wgmma.cuh's
using svt::wg::commit;
using svt::wg::desc;
using svt::wg::fence;
using svt::wg::fence_operands;
using svt::wg::wait;

// d += A (64 x 16, descriptor da) . B^T (256 x 16, descriptor db)
__device__ __forceinline__ void mma(float (&d)[32][4], uint64_t da,
                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "l"(da), "l"(db), "r"(1));
}

// slab kb of A (this block's 128 frames) and W^T (its 256 channels)
__device__ __forceinline__ void fetch(unsigned char* st,
                                      const __nv_bfloat16* __restrict__ xa,
                                      long long row_stride, int rows,
                                      const __nv_bfloat16* __restrict__ w,
                                      int K, int k0) {
#pragma unroll
  for (int j = 0; j < kBM * 8 / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int r = i >> 3, c = i & 7;
    const bool valid = r < rows;
    svt::cp_async16(st + r * kRowBytes + ((c ^ (r & 7)) << 4),
                    xa + (valid ? r * row_stride : 0LL) + k0 + c * 8, valid);
  }
  unsigned char* sw = st + kBM * kRowBytes;
#pragma unroll
  for (int j = 0; j < 256 * 8 / kThreads; ++j) {
    const int i = j * kThreads + threadIdx.x;
    const int r = i >> 3, c = i & 7;
    svt::cp_async16(sw + r * kRowBytes + ((c ^ (r & 7)) << 4),
                    w + (long long)r * K + k0 + c * 8, true);
  }
}
}  // namespace wg

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    conv_ln_gelu_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                              const __nv_bfloat16* __restrict__ wt,
                              const float* __restrict__ bias,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              __nv_bfloat16* __restrict__ out, int tin, int k,
                              int s, int tout, float eps) {
  using G = wg::G;
  constexpr int C = G::C, R = G::R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  unsigned char* ring = smem_raw + (1024 - raw % 1024) % 1024;
  const uint32_t ring_addr = (uint32_t)__cvta_generic_to_shared(ring);
  float* red = reinterpret_cast<float*>(ring + wg::kStages * wg::kSlabBytes);
  float* xred = red + G::BM;

  const Lane l = lane_of<G>();
  const int b = blockIdx.y;
  const int tile = blockIdx.x >> 1;
  const int half = (int)cg::this_cluster().block_rank();
  const int t0 = tile * G::BM;
  const int rows = tout - t0;
  const int K = k * C;
  const long long row_stride = (long long)s * C;
  const __nv_bfloat16* xa = x + ((long long)b * tin + (long long)t0 * s) * C;
  const __nv_bfloat16* w = wt + (long long)half * G::CN * K;
  const int group = (threadIdx.x >> 5) >> 2;  // the warpgroup's 64 frames

  float acc[1][32][4];
  zero<G>(acc);
  const int nk = K / wg::kBK;
#pragma unroll
  for (int st = 0; st < wg::kAhead; ++st) {
    if (st < nk)
      wg::fetch(ring + st * wg::kSlabBytes, xa, row_stride, rows, w, K,
                st * wg::kBK);
    svt::cp_async_commit();
  }
  for (int kb = 0; kb < nk; ++kb) {
    svt::cp_async_wait<wg::kAhead - 1>();  // slab kb
    svt::wg::fence_shared();
    __syncthreads();  // landed for all; every warpgroup is done with the
    const int next = kb + wg::kAhead;  // stage that slab `next` refills
    if (next < nk)
      wg::fetch(ring + (next % wg::kStages) * wg::kSlabBytes, xa, row_stride,
                rows, w, K, next * wg::kBK);
    svt::cp_async_commit();
    const uint32_t st = ring_addr + (kb % wg::kStages) * wg::kSlabBytes;
    const uint64_t da = wg::desc(st + group * 64 * wg::kRowBytes);
    const uint64_t db = wg::desc(st + wg::kBM * wg::kRowBytes);
    wg::fence_operands(acc[0]);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < wg::kBK / 16; ++kk)  // 32 bytes a k step
      wg::mma(acc[0], da + 2 * kk, db + 2 * kk);
    wg::commit();
    wg::wait<1>();  // slab kb - 1's MMAs are done: its stage may refill
  }
  wg::wait<0>();
  wg::fence_operands(acc[0]);
  svt::cp_async_wait<0>();

  float sum[R], mean[R], rstd[R];
#pragma unroll
  for (int ri = 0; ri < R; ++ri) sum[ri] = mean[ri] = 0.0f;
  const int col0 = half * G::CN;
  add_bias<G>(acc, bias, col0, l);
  row_sums<G, false>(sum, acc, mean);
  block_rows<G>(sum, red, l);
  cluster_rows<G>(sum, xred, l);
#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    mean[ri] = sum[ri] / C;
    sum[ri] = 0.0f;
  }
  row_sums<G, true>(sum, acc, mean);
  block_rows<G>(sum, red, l);
  cluster_rows<G>(sum, xred + G::BM, l);
#pragma unroll
  for (int ri = 0; ri < R; ++ri) rstd[ri] = rsqrtf(sum[ri] / C + eps);

  // every warpgroup's MMAs are done (block_rows' barriers): warps stage in
  // the ring
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(ring) +
                         (threadIdx.x >> 5) * 16 * G::SLD;
  store_rows<__nv_bfloat16, G>(acc[0], 0, mean, rstd, gamma, beta, col0,
                               stage, out + ((long long)b * tout + t0) * C,
                               rows, l);
  cg::this_cluster().sync();  // peer reads are done
}

// --------------------------------------------------------------- layer 0
template <typename T, int C>
__host__ __device__ constexpr int span_floats() {
  // the block's samples, rounded up to 16 bytes
  return (kStride0 * (FirstGeo<T, C>::BM - 1) + kTaps0 + 3) / 4 * 4;
}

template <typename T, int C>
constexpr size_t first_smem_bytes() {
  using G = FirstGeo<T, C>;
  // staging | W^T transposed (10 x C) | span | red (WN x BM)
  return G::kStaging + 4 * ((size_t)kTaps0 * C + span_floats<T, C>() +
                            (size_t)G::WN * G::BM);
}

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
    conv_ln_gelu_first_kernel(const T* __restrict__ x,
                              const T* __restrict__ wt,
                              const float* __restrict__ bias,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              T* __restrict__ out, int tin, int tout,
                              float eps) {
  using G = FirstGeo<T, C>;
  constexpr int R = G::R;
  constexpr int kSpan = span_floats<T, C>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* staging = reinterpret_cast<T*>(smem_raw);
  float* wts = reinterpret_cast<float*>(smem_raw + G::kStaging);  // [j][n]
  float* span = wts + kTaps0 * C;
  float* red = span + kSpan;

  const Lane l = lane_of<G>();
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * G::BM;
  const int rows = tout - t0;
  const T* xb = x + (long long)b * tin;
  const long long s0 = (long long)t0 * kStride0;
  for (int i = threadIdx.x; i < kSpan; i += kThreads)
    span[i] = s0 + i < tin ? svt::Num<T>::to_f32(xb[s0 + i]) : 0.0f;
  for (int i = threadIdx.x; i < kTaps0 * C; i += kThreads)
    wts[(i % kTaps0) * C + i / kTaps0] = svt::Num<T>::to_f32(wt[i]);
  __syncthreads();

  const int wcol = l.wn * G::WCOLS;
  float acc[G::MT][G::NT][4];
  zero<G>(acc);
#pragma unroll
  for (int j = 0; j < kTaps0; ++j) {
    float xv[R];
#pragma unroll
    for (int ri = 0; ri < R; ++ri)
      xv[ri] = span[kStride0 * frag_row<G>(ri, l) + j];
#pragma unroll
    for (int nt = 0; nt < G::NT; ++nt) {
      const float2 w2 = *reinterpret_cast<const float2*>(
          wts + j * C + wcol + nt * 8 + 2 * l.tq);
#pragma unroll
      for (int mi = 0; mi < G::MT; ++mi) {
        acc[mi][nt][0] = fmaf(xv[2 * mi], w2.x, acc[mi][nt][0]);
        acc[mi][nt][1] = fmaf(xv[2 * mi], w2.y, acc[mi][nt][1]);
        acc[mi][nt][2] = fmaf(xv[2 * mi + 1], w2.x, acc[mi][nt][2]);
        acc[mi][nt][3] = fmaf(xv[2 * mi + 1], w2.y, acc[mi][nt][3]);
      }
    }
  }

  float sum[R], mean[R], rstd[R];
#pragma unroll
  for (int ri = 0; ri < R; ++ri) sum[ri] = mean[ri] = 0.0f;
  add_bias<G>(acc, bias, wcol, l);
  row_sums<G, false>(sum, acc, mean);
  block_rows<G>(sum, red, l);
#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    mean[ri] = sum[ri] / C;
    sum[ri] = 0.0f;
  }
  row_sums<G, true>(sum, acc, mean);
  block_rows<G>(sum, red, l);
#pragma unroll
  for (int ri = 0; ri < R; ++ri) rstd[ri] = rsqrtf(sum[ri] / C + eps);

  T* stage = staging + (threadIdx.x >> 5) * 16 * G::SLD;
  T* orow = out + ((long long)b * tout + t0) * C;
#pragma unroll
  for (int mi = 0; mi < G::MT; ++mi)
    store_rows<T, G>(acc[mi], mi, mean, rstd, gamma, beta, wcol, stage, orow,
                     rows, l);
}

// ------------------------------------------------------------------- host
template <typename T>
struct TypeTag {
  using type = T;
};

// f(TypeTag<T>, integral_constant<int, C>) for dtype 0 = float32,
// 1 = bfloat16 and C in {64, 128, 256, 512}; else cudaErrorInvalidValue
template <typename F>
cudaError_t dispatch(int dtype, int c, F&& f) {
  auto by_c = [&](auto t) -> cudaError_t {
    switch (c) {
      case 64: return f(t, std::integral_constant<int, 64>{});
      case 128: return f(t, std::integral_constant<int, 128>{});
      case 256: return f(t, std::integral_constant<int, 256>{});
      case 512: return f(t, std::integral_constant<int, 512>{});
      default: return cudaErrorInvalidValue;
    }
  };
  if (dtype == 0) return by_c(TypeTag<float>{});
  if (dtype == 1) return by_c(TypeTag<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T, int C>
cudaError_t launch(const void* x, const void* wt, const float* bias,
                   const float* gamma, const float* beta, void* out, int batch,
                   int tin, int cin, int k, int s, int tout, float eps,
                   cudaStream_t stream) {
  const T* xs = static_cast<const T*>(x);
  const T* ws = static_cast<const T*>(wt);
  T* os = static_cast<T*>(out);
  if (cin == 1) {
    if (k != kTaps0 || s != kStride0) return cudaErrorInvalidValue;
    using G = FirstGeo<T, C>;
    static bool configured = false;
    const size_t smem = first_smem_bytes<T, C>();
    const cudaError_t err = svt::allow_smem(conv_ln_gelu_first_kernel<T, C>,
                                            smem, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((tout + G::BM - 1) / G::BM, batch);
    conv_ln_gelu_first_kernel<T, C><<<grid, kThreads, smem, stream>>>(
        xs, ws, bias, gamma, beta, os, tin, tout, eps);
    return cudaGetLastError();
  }
  using G = MainGeo<T, C>;
  if (cin != C || (k * C) % G::BK != 0) return cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(wt) || !aligned16(out))
    return cudaErrorMisalignedAddress;
  if constexpr (C == 512 && std::is_same<T, __nv_bfloat16>::value) {
    if ((k * C) % wg::kBK != 0) return cudaErrorInvalidValue;
    static bool configured = false;
    const cudaError_t err = svt::allow_smem(conv_ln_gelu_wgmma_kernel,
                                            wg::kSmem, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((tout + wg::kBM - 1) / wg::kBM * 2, batch);
    conv_ln_gelu_wgmma_kernel<<<grid, kThreads, wg::kSmem, stream>>>(
        xs, ws, bias, gamma, beta, os, tin, k, s, tout, eps);
  } else {
    static bool configured = false;
    const size_t smem = main_smem_bytes<T, C>();
    const cudaError_t err =
        svt::allow_smem(conv_ln_gelu_kernel<T, C>, smem, configured);
    if (err != cudaSuccess) return err;
    const dim3 grid((tout + G::BM - 1) / G::BM * 2, batch);
    conv_ln_gelu_kernel<T, C><<<grid, kThreads, smem, stream>>>(
        xs, ws, bias, gamma, beta, os, tin, k, s, tout, eps);
  }
  return cudaGetLastError();
}

template <typename K>
cudaError_t attributes(K kernel, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaFuncAttributes a;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, kernel);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. cin 1 is layer 0 (k 10, s 5, any
// alignment); otherwise cin = c and x, W^T and out 16-byte aligned. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for an
// unsupported dtype, C or shape, cudaErrorMisalignedAddress for a
// misaligned operand of layers 1-6).
extern "C" int svt_conv_ln_gelu(int dtype, const void* x, const void* wt,
                                const void* bias, const void* gamma,
                                const void* beta, void* out, int batch,
                                int tin, int cin, int k, int s, int tout,
                                int c, float eps, void* stream) {
  if (batch <= 0 || tout <= 0 || (tout - 1) * s + k > tin)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, c, [&](auto t, auto cc) -> cudaError_t {
    using T = typename decltype(t)::type;
    constexpr int C = decltype(cc)::value;
    return launch<T, C>(x, wt, static_cast<const float*>(bias),
                        static_cast<const float*>(gamma),
                        static_cast<const float*>(beta), out, batch, tin, cin,
                        k, s, tout, eps, static_cast<cudaStream_t>(stream));
  });
}

// out[4] = registers per thread, local memory bytes per thread (0 = no
// spills), dynamic shared memory bytes per block, resident blocks per SM of
// the instantiation for (dtype, c) of layer 0 (first != 0) or of layers 1-6.
extern "C" int svt_conv_frontend_attributes(int dtype, int c, int first,
                                            int* out) {
  return (int)dispatch(dtype, c, [&](auto t, auto cc) -> cudaError_t {
    using T = typename decltype(t)::type;
    constexpr int C = decltype(cc)::value;
    if (first)
      return attributes(conv_ln_gelu_first_kernel<T, C>,
                        first_smem_bytes<T, C>(), out);
    if constexpr (C == 512 && std::is_same<T, __nv_bfloat16>::value)
      return attributes(conv_ln_gelu_wgmma_kernel, wg::kSmem, out);
    else
      return attributes(conv_ln_gelu_kernel<T, C>, main_smem_bytes<T, C>(),
                        out);
  });
}
