// Variant 0 of tools/tune_int8_matmul.py: the int8 quantize+product kernel
// of svt_speechbrain_tpu_torch/csrc/quant_matmul.cu as it was before its
// Hopper redesign (mma.sync.m16n8k32 on 32- or 64-row blocks that hold their
// int8 rows at full K in shared memory), kept so that the tuning script
// times the old design in the same run as the new one. Its C interface is
// the old one (block_m, tiles_per_group); nothing in the package loads it.
//
// Fused per-token int8 quantization + s8 x s8 -> s32 matrix product (a8w8).
//
//   amax[m]  = max_k |float(x[m, k])|
//   scale[m] = max(amax[m], 1e-8) / 127                  (true f32 division)
//   x8[m, k] = clip(rint(float(x[m, k]) / scale[m]), -127, 127)
//              (true division, round half to even)
//   out[m, n] = T((float(sum_k x8[m, k] * w8[k, n]) * scale[m]) * w_scale[n])
//
// Replaces the TPU kernel svt_speechbrain_tpu/ops/quant.py `int8_matmul_fused`
// (`_qmm_kernel`). That kernel's grid runs in order: it quantizes a 256-row
// block of x into VMEM scratch on the first column block and reuses it for
// every later one. On Hopper blocks run in no order and share nothing, so
// here one block owns BM rows: it quantizes them once into shared memory
// (the int8 rows and their scales never reach device memory) and then walks
// over its own group of 128-column tiles. The grid's second dimension
// splits the column tiles into groups so that the card's 132 SMs are filled
// at the serving shapes (M = 1992 gives only 32 to 63 row blocks); each
// group re-reads and re-quantizes its rows, which is cheap: x is a quarter
// of the output's size at the widest layer.
//
// The int8 rows of a block stay in shared memory for the whole K, so BM is
// bounded by K: 64 rows where 64 * (K + 16) bytes fit beside the weight
// slabs (K <= 2944), else 32 rows (K = 4096 takes 128.5 KB of the 227 KB a
// block may use). 8 warps as 2 (rows) x 4 (columns), each owning
// (BM / 2) x 32 outputs in s32 registers. The weights come as w8t (N, K)
// with K contiguous, the layout the B fragment of `mma.sync.m16n8k32` wants
// (packed once from the tree's (K, N) by the wrapper's caller), in 128-byte
// slabs staged through two cp.async buffers. Rows are padded by 16 bytes
// so that fragment reads hit 32 distinct banks. The last row tile is masked
// here: rows past M quantize to zeros and are not stored, so the caller
// never pads or copies its activations.
//
// What bounds it on the H100: operations at the serving shapes (2 M K N
// against 1,979 TOP/s: 8.4 us at M 1992, K 1024, N 4096, where the bytes
// take 7.3 us). This simple design is far from that bound (measured on an
// H100 at 700 W, bf16, M 1992: 237 TOP/s at K 1024, N 4096 with 64-row
// blocks, 107 TOP/s at K 4096, N 1024 with 32-row blocks). Every row block
// streams its whole weight group from L2 (M / BM times the weight's bytes)
// through a pipeline only two slabs deep, with two block-wide barriers per
// slab. The fragment loads are not the limit: the compiler keeps each
// fragment of an unrolled k step in registers across its tiles (loading
// them explicitly once per step changed no time). wgmma on TMA-staged
// tiles with 128-row blocks that quantize K slab by slab is the later
// design.
//
// Contract: K and N multiples of 128; x, w8t and out contiguous and
// 16-byte aligned; x and out f32 or bf16; w_scale f32 or bf16. Built without
// -use_fast_math: the divisions and the rounding are IEEE.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


namespace {

// s8 x s8 -> s32 m16n8k32 with fragments read from shared memory: A 16 rows
// x 32 k, B 8 columns x 32 k, k contiguous, lda and ldb in bytes
__device__ __forceinline__ void mma_s8(int c[4], const int8_t* A, int lda,
                                       const int8_t* B, int ldb, int lane) {
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

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBN = 128;          // output columns per tile
constexpr int kBK = 128;          // k per staged weight slab (bytes)
constexpr int kPad = 16;          // row padding (bytes) of both operands
constexpr int kLdb = kBK + kPad;  // weight slab row stride
constexpr int kStages = 2;
constexpr int kSlab = kBN * kLdb;  // bytes of one staged slab
constexpr int kMaxShared = 232448;

__host__ __device__ constexpr size_t shared_bytes(int bm, int k) {
  return (size_t)bm * (k + kPad) + (size_t)kStages * kSlab +
         (size_t)bm * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes of a row as floats
template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float v[kN]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float v[kN]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a,
                                                float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

__device__ __forceinline__ uint32_t quantize4(const float* v, float scale) {
  uint32_t word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int q = __float2int_rn(__fdiv_rn(v[e], scale));
    q = max(-127, min(127, q));
    word |= (static_cast<uint32_t>(q) & 0xffu) << (8 * e);
  }
  return word;
}

__device__ __forceinline__ float load_scale(const void* ws, int ws_bf16,
                                            int n) {
  return ws_bf16
             ? __bfloat162float(static_cast<const __nv_bfloat16*>(ws)[n])
             : static_cast<const float*>(ws)[n];
}

// MT: 16-row tiles per warp; a block owns BM = 32 * MT rows.
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w8t,
                       const void* __restrict__ ws, int ws_bf16,
                       T* __restrict__ out, int8_t* __restrict__ x8_out,
                       float* __restrict__ xs_out, int M, int K, int N,
                       int tiles_per_group) {
  constexpr int BM = 32 * MT;
  constexpr int VN = Vec<T>::kN;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = K + kPad;
  int8_t* sa = reinterpret_cast<int8_t*>(smem);
  int8_t* sb = sa + (size_t)BM * lda;
  float* sscale = reinterpret_cast<float*>(sb + kStages * kSlab);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const bool debug = x8_out != nullptr && blockIdx.y == 0;

  // ---- quantize this block's rows into shared memory, one warp per row
  for (int r = warp; r < BM; r += kWarps) {
    const int m = m0 + r;
    int8_t* srow = sa + (size_t)r * lda;
    if (m >= M) {
      for (int c = lane * 4; c < K; c += 32 * 4)
        *reinterpret_cast<uint32_t*>(srow + c) = 0u;
      if (lane == 0) sscale[r] = 0.0f;
      continue;
    }
    const T* xr = x + (size_t)m * K;
    float v[VN];
    float amax = 0.0f;
    for (int c = lane * VN; c < K; c += 32 * VN) {
      Vec<T>::load(xr + c, v);
#pragma unroll
      for (int e = 0; e < VN; ++e) amax = fmaxf(amax, fabsf(v[e]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
    for (int c = lane * VN; c < K; c += 32 * VN) {
      Vec<T>::load(xr + c, v);
#pragma unroll
      for (int w = 0; w < VN / 4; ++w) {
        const uint32_t word = quantize4(v + 4 * w, scale);
        *reinterpret_cast<uint32_t*>(srow + c + 4 * w) = word;
        if (debug)
          *reinterpret_cast<uint32_t*>(x8_out + (size_t)m * K + c + 4 * w) =
              word;
      }
    }
    if (lane == 0) {
      sscale[r] = scale;
      if (debug) xs_out[m] = scale;
    }
  }
  __syncthreads();

  // ---- this block's column tiles
  const int warp_m = warp >> 2, warp_n = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  const int n_tiles = N / kBN;
  const int tile_begin = blockIdx.y * tiles_per_group;
  const int tile_end = min(n_tiles, tile_begin + tiles_per_group);
  const int nkb = K / kBK;
  const int8_t* a_warp = sa + (size_t)(warp_m * 16 * MT) * lda;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int n0 = tile * kBN;
    int acc[MT][4][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

    auto stage_slab = [&](int kb) {
      int8_t* dst = sb + (kb & 1) * kSlab;
      const int8_t* src = w8t + (size_t)n0 * K + (size_t)kb * kBK;
      for (int i = tid; i < kBN * (kBK / 16); i += kThreads) {
        const int n = i >> 3, c = (i & 7) * 16;
        cp_async16(dst + n * kLdb + c, src + (size_t)n * K + c);
      }
      cp_async_commit();
    };

    stage_slab(0);
    for (int kb = 0; kb < nkb; ++kb) {
      if (kb + 1 < nkb) {
        stage_slab(kb + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int8_t* b_warp = sb + (kb & 1) * kSlab + (warp_n * 32) * kLdb;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 32)
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
            mma_s8(acc[mi][ni],
                                   a_warp + (size_t)(mi * 16) * lda +
                                       kb * kBK + kk,
                                   lda, b_warp + (ni * 8) * kLdb + kk, kLdb,
                                   lane);
      __syncthreads();   // the slab is free before it is staged again
    }

    // epilogue in f32, in the reference's order: (acc * x_scale) * w_scale
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp_m * 16 * MT + mi * 16 + half * 8 + g;
        const int m = m0 + r;
        if (m >= M) continue;
        const float xs = sscale[r];
        T* orow = out + (size_t)m * N;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int n = n0 + warp_n * 32 + ni * 8 + 2 * tq;
          const float y0 = (__int2float_rn(acc[mi][ni][half * 2]) * xs) *
                           load_scale(ws, ws_bf16, n);
          const float y1 = (__int2float_rn(acc[mi][ni][half * 2 + 1]) * xs) *
                           load_scale(ws, ws_bf16, n + 1);
          Vec<T>::store2(orow + n, y0, y1);
        }
      }
  }
}

template <typename T, int MT>
cudaError_t launch(const void* x, const void* w8t, const void* ws,
                   int ws_bf16, void* out, void* x8_out, void* xs_out, int m,
                   int k, int n, int tiles_per_group, cudaStream_t stream) {
  constexpr int BM = 32 * MT;
  const size_t bytes = shared_bytes(BM, k);
  if (bytes > kMaxShared) return cudaErrorInvalidValue;
  // the opt-in is per kernel and grows only: remember what was granted
  static size_t granted = 0;
  if (bytes > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_matmul_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
    granted = bytes;
  }
  const int n_tiles = n / kBN;
  const dim3 grid((m + BM - 1) / BM,
                  (n_tiles + tiles_per_group - 1) / tiles_per_group);
  int8_matmul_kernel<T, MT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w8t), ws, ws_bf16,
      static_cast<T*>(out), static_cast<int8_t*>(x8_out),
      static_cast<float*>(xs_out), m, k, n, tiles_per_group);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bm(int block_m, const void* x, const void* w8t,
                        const void* ws, int ws_bf16, void* out, void* x8_out,
                        void* xs_out, int m, int k, int n, int tiles_per_group,
                        cudaStream_t stream) {
  if (block_m == 32)
    return launch<T, 1>(x, w8t, ws, ws_bf16, out, x8_out, xs_out, m, k, n,
                        tiles_per_group, stream);
  if (block_m == 64)
    return launch<T, 2>(x, w8t, ws, ws_bf16, out, x8_out, xs_out, m, k, n,
                        tiles_per_group, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (x and out) and ws_dtype (w_scale): 0 = float32, 1 = bfloat16.
// x8_out (M, K) int8 and xs_out (M,) f32 are both null, or both given to
// receive the quantized rows and their scales (written by the first column
// group). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for what the kernel does not take.
extern "C" int svt_int8_matmul(int dtype, const void* x, const void* w8t,
                               const void* ws, int ws_dtype, void* out,
                               void* x8_out, void* xs_out, int m, int k, int n,
                               int block_m, int tiles_per_group,
                               void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % kBK || n % kBN ||
      tiles_per_group <= 0 || (ws_dtype != 0 && ws_dtype != 1) ||
      (x8_out == nullptr) != (xs_out == nullptr))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_bm<float>(block_m, x, w8t, ws, ws_dtype, out, x8_out,
                                   xs_out, m, k, n, tiles_per_group, st);
  if (dtype == 1)
    return (int)dispatch_bm<__nv_bfloat16>(block_m, x, w8t, ws, ws_dtype, out,
                                           x8_out, xs_out, m, k, n,
                                           tiles_per_group, st);
  return (int)cudaErrorInvalidValue;
}
