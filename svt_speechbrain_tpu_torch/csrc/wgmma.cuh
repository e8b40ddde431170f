// Type-free pieces of Hopper's warpgroup MMAs (`wgmma.mma_async`), shared by
// the kernels that run them (conv_frontend.cu in bf16, quant_matmul.cu in
// s8): the shared-memory descriptor of a K-major operand in the 128-byte
// swizzle, the fences around the asynchronous MMAs, commit and wait. Each
// kernel keeps its own `mma` (the instruction's shape and types), and its
// own staging, which writes the layout `desc` names: chunk c (16 bytes) of
// row r of an operand at chunk c ^ (r % 8) of a 128-byte row, eight rows an
// atom, atoms 1024 bytes apart, from a 1024-aligned base.
#pragma once

#include <stdint.h>

namespace svt {
namespace wg {

// descriptor: start >> 4, leading offset unused, stride 1024 >> 4, layout
// 1 = 128-byte swizzle. A k step of 32 bytes inside the row advances the
// start by 2 (32 >> 4).
__device__ __forceinline__ uint64_t desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of this warpgroup's committed MMA groups run on
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// copies into shared memory by the generic proxy (cp.async, st.shared)
// become visible to the MMAs, which read through the async proxy
__device__ __forceinline__ void fence_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the compiler may not move accumulator reads or writes across the MMAs
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e])::"memory");
}

}  // namespace wg
}  // namespace svt
