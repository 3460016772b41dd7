// Asynchronous copies from device memory to shared memory (cp.async,
// sm_80 and later), for the CUDA-core (ffma) kernels: stagecc_gemm_ffma.cuh
// and flash_attention_ffma.cu.  A thread issues 16-byte copies, which run
// while it computes; each thread waits for its own groups of copies, and a
// __syncthreads after the wait makes every thread's copies visible to all.

#pragma once

namespace cpa {

// Copy 16 bytes from gmem to smem (both 16-byte aligned).  With src_bytes
// below 16 only that many are read and the rest is filled with zeros; with
// 0 nothing is read (gmem must still be a valid address).
__device__ __forceinline__ void copy16(void* smem, const void* gmem,
                                       int src_bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// Close the group of copies this thread issued since the last commit.
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace cpa
