// The visit lists of the run walks: how a thread block finds the visits of
// the run it owns and writes them into a list in shared memory before it
// walks them.
//
// CSR runs (K1 raster_sweep, K5 resident_sweep, K3 grad_reduce): run r's
// visits are ids[starts[r] .. starts[r] + counts[r]); CsrFill copies
// them, and K7 dense_sweep's and K8 pallas_raster's tile lists
// (face_ids[bt, 0 .. counts[bt])) alike.
//
// Slot lists (K5b slot_sweep, K6 slot_grad_reduce): a flat, batch-folded
// array of run ids, non-decreasing, in which each run's slots are
// consecutive; a slot whose item is -1 is a no-op (a run's mandatory slot
// without hits, the filler tail).  The block finds its run's range by
// search (K6: two binary searches side by side; K5b: find_slot_run), so no
// state rides from one slot to the next across blocks (the TPU carried it
// across grid steps), and SlotFill compacts the live slots, in order, into
// the list.

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

// Narrows lower_bound(keys, .., key) to `bracket` candidates with one warp
// (all 32 lanes call it): each round probes 32 points of [lo, hi), which
// cuts the range 33-fold.  Returns lo with the answer in [lo, hi], hi - lo
// <= bracket (hi is updated too).
__device__ __forceinline__ int warp_bracket(const int* keys, int lo, int& hi,
                                            int key, int bracket) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > bracket) {
    const int m = hi - lo;
    // Probes lo + (lane + 1) * m / 33 are distinct and inside (lo, hi).
    const bool less = keys[lo + (int)(((long long)(lane + 1) * m) / 33)] < key;
    const int c = __popc(__ballot_sync(0xffffffffu, less));
    const int next_lo = c == 0 ? lo : lo + (int)(((long long)c * m) / 33) + 1;
    hi = c == 32 ? hi : lo + (int)(((long long)(c + 1) * m) / 33);
    lo = next_lo;
  }
  return lo;
}

// lower_bound(keys, n, key) over keys[lo .. n) by one warp (all 32 lanes
// call it).
__device__ __forceinline__ int warp_lower_bound(const int* keys, int lo,
                                                int n, int key) {
  int hi = n;
  lo = warp_bracket(keys, lo, hi, key, 32);
  const int idx = lo + (threadIdx.x & 31);
  return lo + __popc(__ballot_sync(0xffffffffu, idx < hi && keys[idx] < key));
}

// Slots the last round of find_slot_run reads, kWindow / 32 a lane: the
// search's 64 candidates for the run's first slot, then 32 more.
constexpr int kWindow = 96;

// The slots [lo, hi) of run `key`, and `live` of them compacted into the
// list (-1: not compacted).
struct SlotRun {
  int lo, hi, live;
};

// Finds run `key`'s slots in keys[0 .. n) with one warp (all 32 lanes call
// it; every lane returns the same).  warp_bracket narrows the first slot to
// 64 candidates; one round then reads kWindow slots from there -- keys,
// items and visits at once.  Where the run's slots end inside the window,
// its live slots (item >= 0) are compacted, in order, into `list` (at
// least kWindow ints) with their visits (dma): one search and no further
// load, which is the case of every run with at most 32 slots.  Else the
// end is found by a second search and `live` is -1.
__device__ __forceinline__ SlotRun find_slot_run(const int* keys,
                                                 const int* item,
                                                 const int* dma, int n,
                                                 int key, int* list) {
  constexpr int kPer = kWindow / 32;
  const int lane = threadIdx.x & 31;
  int hi = n;
  const int base = warp_bracket(keys, 0, hi, key, kWindow - 32);
  int k[kPer], it[kPer], d[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int idx = base + j * 32 + lane;
    const bool in = idx < n;
    k[j] = in ? keys[idx] : key + 1;   // past the end: after the run
    it[j] = in ? item[idx] : -1;
    d[j] = in ? dma[idx] : 0;
  }
  int below = 0, mine = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    below += __popc(__ballot_sync(0xffffffffu, k[j] < key));
    mine += __popc(__ballot_sync(0xffffffffu, k[j] == key));
  }
  SlotRun run{base + below, base + below + mine, -1};
  if (run.hi < base + kWindow) {
    int live = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool take = k[j] == key && it[j] >= 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, take);
      if (take) list[live + __popc(ballot & ((1u << lane) - 1u))] = d[j];
      live += __popc(ballot);
    }
    run.live = live;
  } else {
    run.hi = warp_lower_bound(keys, base + kWindow, n, key + 1);
  }
  return run;
}

// A CSR run's visits, or a tile's face list: ids[0 .. count), at most
// `capacity` a piece.
struct CsrFill {
  const int* ids;
  int count;
  int capacity;
  int cursor;

  __device__ void reset() { cursor = 0; }
  __device__ bool done() const { return cursor >= count; }
  // Writes the next piece into `list` and returns its length; ends with a
  // barrier.  Every thread of the block must call it.
  __device__ int next(int* list) {
    const int m = min(capacity, count - cursor);
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      list[j] = ids[cursor + j];
    }
    cursor += m;
    __syncthreads();
    return m;
  }
};

// A slot run's live slots in [lo, hi) (item >= 0), their batch-folded
// visits (dma) compacted in order, one window of blockDim.x slots at a
// time while the piece has room for a whole window (`capacity`, the
// list's length, must be at least blockDim.x).
struct SlotFill {
  const int* item;
  const int* dma;
  int lo;
  int hi;
  int* scratch;   // [32] per-warp counts, then offsets; [32] the total
  int capacity;
  int cursor;

  __device__ void reset() { cursor = lo; }
  __device__ bool done() const { return cursor >= hi; }
  // Writes the next piece into `list` and returns its length; ends with a
  // barrier.  Every thread of the block must call it.
  __device__ int next(int* list) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int in_warp = min(32, (int)blockDim.x - warp * 32);
    const unsigned members = in_warp == 32 ? 0xffffffffu
                                           : (1u << in_warp) - 1u;
    int n = 0;
    while (cursor < hi && n + (int)blockDim.x <= capacity) {
      const int idx = cursor + threadIdx.x;
      const bool live = idx < hi && item[idx] >= 0;
      const int visit = live ? dma[idx] : 0;
      const unsigned ballot = __ballot_sync(members, live);
      if (lane == 0) scratch[warp] = __popc(ballot);
      __syncthreads();
      if (threadIdx.x == 0) {
        int total = 0;
        for (int w = 0; w < ((int)blockDim.x + 31) >> 5; ++w) {
          const int c = scratch[w];
          scratch[w] = total;
          total += c;
        }
        scratch[32] = total;
      }
      __syncthreads();
      if (live) {
        list[n + scratch[warp] + __popc(ballot & ((1u << lane) - 1u))] =
            visit;
      }
      n += scratch[32];
      cursor += blockDim.x;
      __syncthreads();
    }
    return n;
  }
};

}  // namespace dirt
