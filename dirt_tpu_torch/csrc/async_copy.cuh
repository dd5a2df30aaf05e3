// Asynchronous copies from device memory into shared memory (cp.async),
// shared by the run walks of the gradient reductions (grad_math.cuh's
// reduce_run, K3 and K6) and of the forward sweeps (sweep_math.cuh's
// sweep_run, K1, K5b and K8; K5's resident table).  A thread starts
// copies, closes them into a group with cp_async_commit, and waits for its
// own groups; a barrier then publishes every thread's copies to the
// block.

#pragma once

#include <cuda_runtime.h>

namespace dirt {

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of the thread's newest groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace dirt
