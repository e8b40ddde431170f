// Pieces shared by the port's kernels that stage tiles through shared
// memory (conv_frontend.cu; the attention kernels through flash_common.cuh):
// asynchronous 16- and 4-byte copies into a shared-memory ring, and the
// opt-in to more than 48 KB of dynamic shared memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace svt {

// `cp.async` of 16 (cg, past L1) or 4 (ca) bytes; `valid` false writes zeros
// and reads nothing (src-size 0), though `src` must still be a valid address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Opt a kernel into more than 48 KB of dynamic shared memory (once per
// kernel instantiation: `configured` is the caller's static flag).
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured = true;
  return err;
}

}  // namespace svt
