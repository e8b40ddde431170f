// Variant 0 of tools/tune_conv_frontend.py: the conv frontend kernel as it
// stood before its Hopper redesign (svt_speechbrain_tpu_torch/csrc/
// conv_frontend.cu, first version), kept so that the tuning script times the
// old design beside the new one in the same run. Self-contained: the
// shared-memory tile product it used is inlined below. Not built by the
// package; same C interface (`svt_conv_ln_gelu`).
//
// wav2vec2 conv frontend, one layer per launch: strided conv + bias +
// per-frame LayerNorm over channels + GELU.
//
// Replaces the TPU kernel svt_speechbrain_tpu/ops/conv_frontend.py
// `fused_conv_frontend` (`_frontend_kernel`), which ran all seven layers of a
// 32-frame tile inside VMEM. On Hopper that design does not carry over: the
// deepest intermediate of one tile (the first conv's 2063 x 512 output) is
// about 2 MB in bf16, and a block has 227 KB of shared memory. Here each of
// the seven layers is one launch, and intermediates go to device memory.
//
// Channel-last input makes the conv a GEMM with strided rows and no im2col:
// output frame t reads the k * C_in contiguous elements of input rows
// [s*t, s*t + k), so A[t] = x + t * s * C_in with K = k * C_in. The packed
// weight is W^T (C, K) with K index = tap * C_in + c_in. Layer 0 (C_in = 1,
// k = 10, s = 5) is the same formula with K = 10.
//
// A block owns BM = 32 output frames x all C channels, so the LayerNorm
// reduction over channels stays inside the block: 8 warps, each owns C/8
// columns and both 16-row m-tiles, accumulating in f32 registers over
// 16-wide K slabs staged in shared memory. The product is computed here
// (mma.sync bf16 tensor cores, or f32 FMAs), then bias, the two-pass
// LayerNorm (mean, then mean of squared deviations, eps inside the rsqrt),
// GELU and the store.
//
// What bounds it on the H100: the products (about 24.5 GFLOP per 5 s
// chunk, half of it in layer 1); bytes are small next to that (the layer-1
// activation is 8 MB a chunk in bf16). This simple design reloads the A
// fragment for every n-tile, so shared-memory bandwidth, not the tensor
// cores, limits it; wgmma with TMA-staged tiles is the later fix.
//
// Requirements: C in {64, 128, 256, 512}; x, W^T and out contiguous;
// bias, gamma, beta f32. GELU: tanh form in f32 arithmetic for bf16 (as
// the TPU kernel's `_ln_gelu`), CUDA's erff for f32 (the TPU kernel's
// rational A&S erf existed only because Mosaic has no erf; erff is within
// a few ulp of the exact erf the plain version uses).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace svt {

template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float from_f32(float v) { return v; }
  static constexpr int kPad = 1;
};

template <> struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from_f32(float v) {
    return __float2bfloat16(v);
  }
  static constexpr int kPad = 8;
};

// c += A (16 x 16 k) . B (8 columns x 16 k), fragments read from shared
// memory at every call; bf16 on m16n8k16, f32 on FMAs
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

}  // namespace svt

namespace {

constexpr int kBM = 32;
constexpr int kBK = 16;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <typename T>
__device__ __forceinline__ float gelu(float y) {
  if constexpr (std::is_same<T, float>::value) {
    return 0.5f * y * (1.0f + erff(y * 0.7071067811865476f));
  } else {
    return 0.5f * y *
           (1.0f + tanhf(0.7978845608028654f * (y + 0.044715f * y * y * y)));
  }
}

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
    conv_ln_gelu_kernel(const T* __restrict__ x, const T* __restrict__ wt,
                        const float* __restrict__ bias,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, T* __restrict__ out,
                        int tin, int cin, int k, int s, int tout, float eps) {
  constexpr int C = kWarps * NT * 8;
  constexpr int LD = kBK + svt::Num<T>::kPad;
  __shared__ __align__(16) T sa[kBM * LD];
  __shared__ __align__(16) T sb[C * LD];
  __shared__ float red[kWarps][kBM];

  const int K = k * cin;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kBM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const T* xb = x + (size_t)b * tin * cin;
  const size_t row_stride = (size_t)s * cin;
  const T zero = svt::Num<T>::from_f32(0.0f);

  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = tid; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, kk = i % kBK;
      const int t = t0 + r, kg = k0 + kk;
      sa[r * LD + kk] =
          (t < tout && kg < K) ? xb[(size_t)t * row_stride + kg] : zero;
    }
    for (int i = tid; i < C * kBK; i += kThreads) {
      const int n = i / kBK, kk = i % kBK;
      const int kg = k0 + kk;
      sb[n * LD + kk] = kg < K ? wt[(size_t)n * K + kg] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        svt::Tile<T>::mma(acc[mi][nt], sa + mi * 16 * LD, LD,
                          sb + (warp * NT + nt) * 8 * LD, LD, lane);
    __syncthreads();
  }

  // epilogue: this thread's rows are r = mi*16 + half*8 + g, its columns
  // n = (warp*NT + nt)*8 + 2*tq + {0, 1}
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = (warp * NT + nt) * 8 + 2 * tq;
      acc[mi][nt][0] += bias[n];
      acc[mi][nt][1] += bias[n + 1];
      acc[mi][nt][2] += bias[n];
      acc[mi][nt][3] += bias[n + 1];
    }

  float mean[4], rstd[4];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float part[4];
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int mi = ri >> 1, half = ri & 1;
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = acc[mi][nt][half * 2 + e];
          sum += pass == 0 ? v : (v - mean[ri]) * (v - mean[ri]);
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      part[ri] = sum;
    }
    if (tq == 0) {
#pragma unroll
      for (int ri = 0; ri < 4; ++ri)
        red[warp][(ri >> 1) * 16 + (ri & 1) * 8 + g] = part[ri];
    }
    __syncthreads();
#pragma unroll
    for (int ri = 0; ri < 4; ++ri) {
      const int r = (ri >> 1) * 16 + (ri & 1) * 8 + g;
      float tot = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) tot += red[w][r];
      if (pass == 0)
        mean[ri] = tot / C;
      else
        rstd[ri] = rsqrtf(tot / C + eps);
    }
    __syncthreads();
  }

#pragma unroll
  for (int ri = 0; ri < 4; ++ri) {
    const int mi = ri >> 1, half = ri & 1;
    const int t = t0 + mi * 16 + half * 8 + g;
    if (t >= tout) continue;
    T* orow = out + ((size_t)b * tout + t) * C;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = (warp * NT + nt) * 8 + 2 * tq + e;
        const float y =
            (acc[mi][nt][half * 2 + e] - mean[ri]) * rstd[ri] * gamma[n] +
            beta[n];
        orow[n] = svt::Num<T>::from_f32(gelu<T>(y));
      }
  }
}

template <typename T, int NT>
cudaError_t launch(const void* x, const void* wt, const float* bias,
                   const float* gamma, const float* beta, void* out, int batch,
                   int tin, int cin, int k, int s, int tout, float eps,
                   cudaStream_t stream) {
  const dim3 grid((tout + kBM - 1) / kBM, batch);
  conv_ln_gelu_kernel<T, NT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), bias, gamma, beta,
      static_cast<T*>(out), tin, cin, k, s, tout, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_c(int c, const void* x, const void* wt, const float* bias,
                       const float* gamma, const float* beta, void* out,
                       int batch, int tin, int cin, int k, int s, int tout,
                       float eps, cudaStream_t stream) {
  switch (c) {
    case 64:
      return launch<T, 1>(x, wt, bias, gamma, beta, out, batch, tin, cin, k, s,
                          tout, eps, stream);
    case 128:
      return launch<T, 2>(x, wt, bias, gamma, beta, out, batch, tin, cin, k, s,
                          tout, eps, stream);
    case 256:
      return launch<T, 4>(x, wt, bias, gamma, beta, out, batch, tin, cin, k, s,
                          tout, eps, stream);
    case 512:
      return launch<T, 8>(x, wt, bias, gamma, beta, out, batch, tin, cin, k, s,
                          tout, eps, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (or cudaErrorInvalidValue for an unsupported dtype or C).
extern "C" int svt_conv_ln_gelu(int dtype, const void* x, const void* wt,
                                const void* bias, const void* gamma,
                                const void* beta, void* out, int batch,
                                int tin, int cin, int k, int s, int tout,
                                int c, float eps, void* stream) {
  if (batch <= 0 || tout <= 0) return (int)cudaErrorInvalidValue;
  const auto* bi = static_cast<const float*>(bias);
  const auto* ga = static_cast<const float*>(gamma);
  const auto* be = static_cast<const float*>(beta);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_c<float>(c, x, wt, bi, ga, be, out, batch, tin, cin,
                                  k, s, tout, eps, st);
  if (dtype == 1)
    return (int)dispatch_c<__nv_bfloat16>(c, x, wt, bi, ga, be, out, batch,
                                          tin, cin, k, s, tout, eps, st);
  return (int)cudaErrorInvalidValue;
}
