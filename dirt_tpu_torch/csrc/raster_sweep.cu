// K1: raster_sweep -- the block-binned forward sweep.
//
// Replaces dirt_tpu/ops/forward_blocks.py:_raster_kernel_fused (the TPU's
// production forward sweep, with its math in forward_dense._chunk_candidates
// and merge_state).
//
// Work: one thread block per (image, tile) of tile_h x tile_w pixels, one
// thread per pixel.  The block walks its tile's CSR run of face blocks
// (block_ids[starts[bt] .. starts[bt] + counts[bt]]); each visit stages the
// block's chunk x width_d face-table rows in shared memory, and every thread
// tests the rows in order against its pixel centre: edge functions, the
// COVER_FAST fill rule with the |s_z| <= |s_w| clip, depth s_z / s_w, and
// the lexicographic (depth, original face index) z-test against its running
// winner, which starts at glClearDepth's (1.0, -1).  The lexicographic
// minimum is associative, so visiting faces one by one picks the same
// winner as the TPU's chunk minimum followed by the merge.
//
// The block walk, the per-face test and the state write are
// sweep_math.cuh's, shared with K5b slot_sweep, K5 resident_sweep and K7
// dense_sweep: the thread keeps the winner's depth, index, E0..E2, S_w
// and table row number in registers, and at the end reads the row's vertex
// ids and corner attributes from global memory and writes the packed state
// [C+9, PIX] of forward_dense.
//
// What bounds it on the H100: arithmetic and shared-memory reads per
// (pixel, swept face) -- about 30 flops and 18 broadcast shared loads, with
// one division only for covered fragments.  Device memory traffic is the
// face blocks (once per visit per tile, L2-resident: the bench table is
// 74 KB) and one state write per pixel.  The design answers with the
// spatially sorted CSR runs, which keep the swept faces near the tile, and
// with shared-memory staging that every thread of the tile reuses.
//
// Built with -fmad=false and IEEE division: every product rounds as in
// eager PyTorch, so the state equals the plain version's
// (forward_blocks.raster_sweep_plain) bit for bit, except that a -0.0 the
// plain version's pick sum turns into +0.0 may stay -0.0 here.

#include <cuda_runtime.h>

#include "sweep_math.cuh"

namespace {

__global__ void raster_sweep_kernel(
    const float* __restrict__ table,      // [B*NB, chunk, width_d]
    const int* __restrict__ starts,       // [B*T]
    const int* __restrict__ counts,       // [B*T]
    const int* __restrict__ block_ids,    // [B*S], batch-folded
    float* __restrict__ state,            // [B*T, C+9, PIX]
    int num_tiles, int tiles_x, int tile_h, int tile_w,
    int chunk, int width_d, int channels, float sx, float sy) {
  extern __shared__ float rows[];          // [chunk, width_d]
  const int bt = blockIdx.x;
  const int tile = bt % num_tiles;
  const int pix = tile_h * tile_w;
  const int p = threadIdx.x;
  const int r = p / tile_w;
  const int c = p - r * tile_w;
  const int row = (tile / tiles_x) * tile_h + r;
  const int col = (tile % tiles_x) * tile_w + c;
  // forward_dense.pixel_ndc: ((col + 0.5) * (2/W) - 1, 1 - (row + 0.5) * (2/H)).
  const float xg = ((float)col + 0.5f) * sx - 1.0f;
  const float yg = 1.0f - ((float)row + 0.5f) * sy;

  dirt::Winner w;
  const int start = starts[bt];
  const int n = counts[bt];
  for (int i = 0; i < n; ++i) {
    dirt::sweep_block(table, block_ids[start + i], chunk, width_d, rows, xg,
                      yg, w);
  }

  if (p >= pix) return;
  dirt::write_state(table, width_d, channels, w,
                    state + (long long)bt * (channels + 9) * pix + p, pix);
}

}  // namespace

extern "C" int dirt_raster_sweep(
    const float* table, const int* starts, const int* counts,
    const int* block_ids, float* state, int runs, int num_tiles, int tiles_x,
    int tile_h, int tile_w, int chunk, int width_d, int channels, float sx,
    float sy, cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)chunk * width_d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(raster_sweep_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  raster_sweep_kernel<<<runs, tile_h * tile_w, smem, stream>>>(
      table, starts, counts, block_ids, state, num_tiles, tiles_x, tile_h,
      tile_w, chunk, width_d, channels, sx, sy);
  return (int)cudaGetLastError();
}
