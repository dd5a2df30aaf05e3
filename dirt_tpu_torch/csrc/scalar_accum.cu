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
// Work: one thread block per (tile, chunk) -- the two grid axes, which
// write disjoint rows, so no order between blocks is needed -- and 256
// threads.  For each live row the threads sum their strided pixels, the
// four sums are reduced across warps (shuffles, then shared memory), and
// one thread adds them into the row.
//
// What bounds it on the H100: the pixel scan, live rows x pixels
// compares and masked adds, with the tile's planes re-read from L1/L2
// for every row; device memory traffic is the planes, ids and rows once.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads) scalar_accum_kernel(
    const float* __restrict__ planes,    // [T, 3, pix]: a, b, ids
    const float* __restrict__ ids,       // [T, num_ids]
    const int* __restrict__ counts,      // [T]
    float* __restrict__ out,             // [T, chunks, chunk, 4], zeroed
    int pix, int num_ids, int chunk) {
  __shared__ float partial[4][kWarps];
  const int t = blockIdx.x;
  const int c = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* a = planes + (long long)t * 3 * pix;
  const float* b = a + pix;
  const float* pid = b + pix;
  const int n_live = min(chunk, min(counts[t], num_ids) - c * chunk);
  float* rows = out + ((long long)t * gridDim.y + c) * chunk * 4;
  for (int j = 0; j < n_live; ++j) {
    const float fid = ids[(long long)t * num_ids + c * chunk + j];
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int p = threadIdx.x; p < pix; p += kThreads) {
      if (pid[p] == fid) {
        const float ap = a[p];
        const float bp = b[p];
        s[0] += ap;
        s[1] += bp;
        s[2] += ap * bp;
        s[3] += bp * ap;
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[k] = warp_sum(s[k]);
      if (lane == 0) partial[k][warp] = s[k];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float total[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int w = 0; w < kWarps; ++w) {
#pragma unroll
        for (int k = 0; k < 4; ++k) total[k] += partial[k][w];
      }
      rows[j * 4 + 0] += total[0];
      rows[j * 4 + 1] += total[1];
      rows[j * 4 + 2] += total[2];
      rows[j * 4 + 3] += -total[3];
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dirt_scalar_accum(const float* planes, const float* ids,
                                 const int* counts, float* out, int tiles,
                                 int chunks, int pix, int num_ids, int chunk,
                                 cudaStream_t stream) {
  if (tiles == 0 || chunks == 0) return (int)cudaGetLastError();
  scalar_accum_kernel<<<dim3(tiles, chunks), kThreads, 0, stream>>>(
      planes, ids, counts, out, pix, num_ids, chunk);
  return (int)cudaGetLastError();
}
