// cp.async (sm_80+) helpers shared by the port's kernels.
//
// A copy moves global memory into shared memory without passing through
// registers; the issuing thread goes on at once. `commit` closes the copies
// issued so far into a group and `wait_all` blocks the thread until all its
// groups have landed; a __syncthreads() (or cluster barrier) after the wait
// makes them visible to the other threads of the block. A copy whose
// predicate is false reads nothing and writes zeros (source size 0).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ void copy4(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 4 : 0)
               : "memory");
}

// dst and src 16-byte aligned.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace async_copy
