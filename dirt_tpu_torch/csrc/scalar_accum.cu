// K11: scalar_accum -- scalar accumulation of masked vector reductions.
//
// Replaces repro/mosaic_scalar_smem_accum.py:_kernel, the minimised
// repro of a Mosaic miscompile: grid (tiles, chunks), the chunk axis
// sequential; each step loops over its n_live = min(CHUNK, count -
// chunk * CHUNK) rows (a dynamic bound) and, for each row j, adds four
// masked sums over the tile's pixels into an SMEM output row that an
// aliased zeros input initialises:
//   out[j] += (sum(a | id == fid_j), sum(b | id == fid_j),
//              sum(a * b | id == fid_j), -sum(b * a | id == fid_j)).
// The pattern is pinned here on the H100: the same scalar += of block
// reductions, under a dynamic loop bound, into an output that the
// wrapper zero-fills first (the aliased zeros).
//
// Work: one block of kAccumWarps warps per tile, over all its chunks
// (chunk c's row j is the tile's row c * chunk + j); a tile whose count
// is 0 retires at once, and rows at or past min(count, N) -- dead rows,
// dead chunks -- are never visited.  The tile's pixels go in passes of
// kAccumPass = 32 * kIdsPerLane: the block stages the pass's three planes
// into shared memory once (cp.async, 16 bytes a copy where the planes
// allow it), then each lane holds its kIdsPerLane pixel ids (pixels lane
// + 32 k) in registers, and warp w takes the live rows w, w +
// kAccumWarps, ...: the row's id is one broadcast load, the compares run
// on registers into a bit mask a lane, only a matching pixel (a set bit)
// loads its a and b from shared memory, the four sums stay in registers,
// a butterfly of shuffles combines the lanes, and lane 0 adds the row
// into the output.  A row has one owner warp, so the adds need no
// atomics; two block barriers a pass, none a row.  (Six shuffles for the
// four sums in place of twenty ran no faster on the H100: PERF.md.)
//
// What bounds it on the H100: the bytes, each tile's three planes, its
// ids and its rows once (3.1 MB at 256 tiles x 1,024 pixels, 0.0011 ms at
// 3.35 TB/s); the compares, live rows x pixels, are about 1 us of the
// SMs' issue rate at that size.  The older design (a block per (tile,
// chunk) walking its rows one after another, two block barriers and a
// re-read of the planes a row) was held by that chain of rows.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

// The launch shape; mirrored by repro/scalar_accum.py's ACCUM_WARPS and
// ACCUM_IDS_PER_LANE (a CPU test checks).
constexpr int kAccumWarps = 16;
constexpr int kIdsPerLane = 32;
constexpr int kAccumThreads = 32 * kAccumWarps;
constexpr int kAccumPass = 32 * kIdsPerLane;
static_assert(kAccumPass % 4 == 0, "a pass stages in 16-byte copies");

__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kAccumThreads) scalar_accum_kernel(
    const float* __restrict__ planes,    // [T, 3, pix]: a, b, ids
    const float* __restrict__ ids,       // [T, num_ids]
    const int* __restrict__ counts,      // [T]
    float* __restrict__ out,             // [T, num_ids, 4], zeroed
    int pix, int num_ids) {
  __shared__ __align__(16) float staged[3][kAccumPass];
  const int t = blockIdx.x;
  const int live = min(counts[t], num_ids);
  if (live <= 0) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* tile = planes + (long long)t * 3 * pix;
  const float* row_ids = ids + (long long)t * num_ids;
  float* rows = out + (long long)t * num_ids * 4;
  // 16-byte copies need every plane's start 16-byte aligned.
  const bool by16 = (pix % 4) == 0 &&
                    (reinterpret_cast<unsigned long long>(planes) & 15) == 0;
  for (int base = 0; base < pix; base += kAccumPass) {
    const int n = min(kAccumPass, pix - base);
    __syncthreads();   // the previous pass's reads are done
    if (by16) {
      for (int q = threadIdx.x; q < 3 * (n / 4); q += kAccumThreads) {
        const int plane = q / (n / 4);
        const int off = 4 * (q - plane * (n / 4));
        dirt::cp_async16(&staged[plane][off], tile + plane * pix + base + off);
      }
    } else {
      for (int q = threadIdx.x; q < 3 * n; q += kAccumThreads) {
        const int plane = q / n;
        const int off = q - plane * n;
        dirt::cp_async4(&staged[plane][off], tile + plane * pix + base + off);
      }
    }
    dirt::cp_async_commit();
    dirt::cp_async_wait_all();
    __syncthreads();
    // A pixel past the pass gets a NaN id, which equals no row's id.
    float pixel_ids[kIdsPerLane];
#pragma unroll
    for (int k = 0; k < kIdsPerLane; ++k) {
      const int p = lane + 32 * k;
      pixel_ids[k] = p < n ? staged[2][p] : __int_as_float(0x7fc00000);
    }
    for (int r = warp; r < live; r += kAccumWarps) {
      const float fid = row_ids[r];
      // The lane's matching pixels as a bit mask: the compares run on
      // registers without a branch; only the set bits load a and b.
      unsigned hits = 0u;
#pragma unroll
      for (int k = 0; k < kIdsPerLane; ++k) {
        hits |= (pixel_ids[k] == fid ? 1u : 0u) << k;
      }
      float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
      while (hits != 0u) {
        const int p = lane + 32 * (__ffs(hits) - 1);
        hits &= hits - 1u;
        const float ap = staged[0][p];
        const float bp = staged[1][p];
        s0 += ap;
        s1 += bp;
        s2 += ap * bp;
        s3 += bp * ap;
      }
      s0 = lane_sum(s0);
      s1 = lane_sum(s1);
      s2 = lane_sum(s2);
      s3 = lane_sum(s3);
      if (lane == 0) {
        float* row = rows + r * 4;
        row[0] += s0;
        row[1] += s1;
        row[2] += s2;
        row[3] += -s3;
      }
    }
  }
}

}  // namespace

extern "C" int dirt_scalar_accum(const float* planes, const float* ids,
                                 const int* counts, float* out, int tiles,
                                 int pix, int num_ids, cudaStream_t stream) {
  if (tiles == 0 || num_ids == 0) return (int)cudaGetLastError();
  scalar_accum_kernel<<<tiles, kAccumThreads, 0, stream>>>(
      planes, ids, counts, out, pix, num_ids);
  return (int)cudaGetLastError();
}
