// Pieces shared by the attention kernels (flash_attention.cu: forward;
// flash_attention_bwd.cu: the two backward programs).
//
// * Block geometry: 4 warps over a 64-row tile of queries or keys, each
//   warp owning 16 rows; head dim D = 16 (TINY_ARCH) or 64
//   (wav2vec2-large).
// * The in-kernel dropout hash, bit-identical to the JAX package's
//   `_dropout_bits` / `_keep_scale` (svt_speechbrain_tpu/ops/
//   flash_attention.py:65-95): chained murmur3 fmix32 finalizers over the
//   GLOBAL score coordinates (seed, row = b*H + h, q, k), uint32 wraparound
//   arithmetic. Every kernel regenerates the identical mask from those
//   coordinates, whatever its tiling.
// * The panel copies of the kernels' rings (16-byte cp.async,
//   async_copy.cuh), zero past the array's end.
// * `dispatch`: (dtype, D, dropout) at run time -> a template instantiation;
//   `attributes`: what ptxas and the occupancy calculator made of one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "tile_mma.cuh"

namespace svt {

constexpr int kWarps = 4;  // each warp owns 16 rows of the block's tile
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // the block's own tile
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, t;
};

struct Dropout {
  uint32_t seed;    // the call's seed, as uint32
  uint32_t thresh;  // keep where bits >= thresh: min(int(rate * 2^32), 2^32 - 1)
  float scale;      // f32(1 / (1 - rate))
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// h0 = fmix32(seed ^ row * GOLDEN); hq = fmix32(q * C2 ^ h0);
// bits = fmix32(k * C1 ^ hq)
__device__ __forceinline__ uint32_t row_hash(const Dropout& dr, uint32_t row) {
  return fmix32(dr.seed ^ (row * 0x9E3779B9u));
}

__device__ __forceinline__ uint32_t query_hash(uint32_t h0, uint32_t q) {
  return fmix32((q * 0xC2B2AE35u) ^ h0);
}

// the multiplier of score (q, k): 0 where dropped, 1 / (1 - rate) where kept
__device__ __forceinline__ float keep(const Dropout& dr, uint32_t hq,
                                      uint32_t k) {
  return fmix32((k * 0x85EBCA6Bu) ^ hq) >= dr.thresh ? dr.scale : 0.0f;
}

// a batch row's key length, clamped to [0, tk] (null: every key valid)
__device__ __forceinline__ int clamp_len(const int* lengths, int b, int tk) {
  const int len = lengths == nullptr ? tk : lengths[b];
  return len < 0 ? 0 : (len > tk ? tk : len);
}

// rows [r0, r0 + ROWS) of a (T, D) panel (row stride `st` elements, unit
// stride on D) into `dst` (row width `ld`) by 16-byte cp.async from all
// THREADS threads; rows >= t are zero. The source rows and `dst`'s rows must
// be 16-byte aligned.
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void cp_async_panel(T* dst, int ld,
                                               const T* __restrict__ src,
                                               long long st, int r0, int t) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  constexpr int kPieces = ROWS * kPerRow;
#pragma unroll
  for (int j = 0; j < (kPieces + THREADS - 1) / THREADS; ++j) {
    const int i = j * THREADS + threadIdx.x;
    if (kPieces % THREADS != 0 && i >= kPieces) break;
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool valid = r0 + r < t;
    cp_async16(dst + r * ld + c,
               src + (valid ? (long long)(r0 + r) * st : 0LL) + c, valid);
  }
}

template <typename T>
struct TypeTag {
  using type = T;
};

// Calls f(TypeTag<T>, integral_constant<int, D>, bool_constant<dropout>)
// for dtype 0 = float32, 1 = bfloat16 and D in {16, 64}; anything else is
// cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch(int dtype, int d, int dropout, F&& f) {
  auto by_d = [&](auto t, auto drop) -> cudaError_t {
    if (d == 16) return f(t, std::integral_constant<int, 16>{}, drop);
    if (d == 64) return f(t, std::integral_constant<int, 64>{}, drop);
    return cudaErrorInvalidValue;
  };
  auto by_drop = [&](auto t) -> cudaError_t {
    return dropout ? by_d(t, std::true_type{}) : by_d(t, std::false_type{});
  };
  if (dtype == 0) return by_drop(TypeTag<float>{});
  if (dtype == 1) return by_drop(TypeTag<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

// registers, local memory (bytes per thread: 0 = no spills), dynamic shared
// memory per block and resident blocks per SM of one instantiation
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

}  // namespace svt
