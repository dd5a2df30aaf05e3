// The slot lists of K5b slot_sweep (slot_sweep.cu) and K6 slot_grad_reduce
// (slot_grad.cu): a flat, batch-folded array of run ids, non-decreasing,
// in which each run's slots are consecutive.  A thread block owns one run
// and finds its slots by binary search, so no state rides from one slot
// to the next across blocks (the TPU carried it across grid steps).

#pragma once

#include <cuda_runtime.h>

namespace dirt {

// The first index of keys[0 .. n) whose value is not below `key`; keys
// must be non-decreasing.
__device__ __forceinline__ int lower_bound(const int* keys, int n, int key) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (keys[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

}  // namespace dirt
