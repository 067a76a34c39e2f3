// Asynchronous copies from global to shared memory (cp.async, sm_80 and
// later), shared by the kernels that stage tiles ahead of their use: the
// attention kernels (flash_attention.cu, flash_decode.cu, flash_prefill.cu)
// and the SBMM tile (sbmm_tile.cuh); and the shared memory limit of a kernel
// whose staged tiles need more than the default.
#pragma once

#include <cuda_runtime.h>

// Copy 16 bytes from global to shared memory without staging them in
// registers; with `valid` false nothing is read and the 16 bytes are zeroed
// (`src` must still be a mapped address). Both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// Copy 4 bytes (both addresses 4-byte aligned), through L1.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// close the copies issued since the last commit into one group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Raise a kernel's dynamic shared memory limit to `bytes` once it needs
// more than the default 48 KB; `raised` remembers the last limit set.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* raised) {
  if (bytes <= 48 * 1024 || bytes <= *raised) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *raised = bytes;
  return err;
}
