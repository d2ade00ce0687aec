// cp.async (sm_80+) wrappers shared by the kernels that stage device
// memory in shared memory ahead of its use: a copy is issued by a thread,
// runs in the background, and is waited for per commit group.
#pragma once

#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes, L2 only (the data is read once from this SM's shared memory)
__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// 16 bytes through L1 as well (rows that other warps of the SM read again)
__device__ __forceinline__ void copy16_ca(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// 8 bytes through L1 (four narrowed values; .cg takes 16 bytes only)
__device__ __forceinline__ void copy8(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem)
               : "memory");
}

// 16 bytes of which the first src_bytes (0 or 16) are read, the rest
// zero-filled: a tile's ragged edge without a branch around the copy
__device__ __forceinline__ void copy16_zfill(void* smem, const void* gmem,
                                             int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

// 4 bytes (src_bytes 0 or 4, the rest zero-filled)
__device__ __forceinline__ void copy4_zfill(void* smem, const void* gmem,
                                            int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's commit groups are still in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace async_copy
