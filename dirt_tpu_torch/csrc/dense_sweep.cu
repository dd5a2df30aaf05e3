// K7: dense_sweep -- the "dense" backend's forward sweep over exact
// per-tile face lists.
//
// Replaces dirt_tpu/ops/forward_dense.py:_raster_kernel_fused (the fused
// dense sweep: a tile's whole face list resident, a loop over its live
// chunks) and _raster_kernel (the same sweep with one chunk per grid step,
// DIRT_TPU_DENSE_FUSED=0).  Both merge the same chunks into the same
// per-tile state in the same order; only the TPU's streaming of the chunks
// differs, so one kernel covers both.
//
// Work: one thread block per (image, tile) of tile_h x tile_w pixels, one
// thread per pixel (at most 1024).  The block walks its tile's face list
// (face_ids[bt, 0 .. counts[bt]), row indices into the stacked face table,
// hits first in draw order -- forward_pallas._pack_faces); `chunk` rows at
// a time are gathered by index into shared memory, and every thread tests
// them in list order against its pixel centre with sweep_math.cuh's
// per-face arithmetic (shared with K1 raster_sweep).  Only the hits are
// tested: the TPU's live-chunk tail holds faces whose conservative bboxes
// miss the tile, which cover nothing, so the winner is the same.  The
// winner's numerators, edge values and ids go into the packed state
// [C+9, PIX] of forward_dense; forward_dense.finalize divides.
//
// What bounds it on the H100: at the bench size the state it writes
// (16 x 256 tiles x 12 rows x 256 pixels x 4 B = 50 MB) is far more than
// the face table it reads (16 x 512 x 36 x 4 B = 1.2 MB) and the list
// indices; the per-(pixel, listed face) arithmetic (~22 flops and 18
// broadcast shared loads) comes next.  Each thread writes its state rows
// once, neighbouring threads on neighbouring addresses (coalesced); the
// gathered rows are staged once per block and read by every thread.
//
// Built with -fmad=false and IEEE division: the state equals the plain
// version's (forward_dense.dense_sweep_plain) bit for bit, except that a
// -0.0 the plain version's pick sum turns into +0.0 may stay -0.0 here.

#include <cuda_runtime.h>

#include "sweep_math.cuh"

namespace {

__global__ void dense_sweep_kernel(
    const float* __restrict__ table,      // [B*F', width_d]
    const int* __restrict__ face_ids,     // [B*T, slots], batch-folded rows
    const int* __restrict__ counts,       // [B*T]
    float* __restrict__ state,            // [B*T, C+9, PIX]
    int slots, int num_tiles, int tiles_x, int tile_h, int tile_w,
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
  dirt::sweep_list(table, face_ids + (long long)bt * slots, counts[bt], chunk,
                   width_d, rows, xg, yg, w);

  if (p >= pix) return;
  dirt::write_state(table, width_d, channels, w,
                    state + (long long)bt * (channels + 9) * pix + p, pix);
}

}  // namespace

extern "C" int dirt_dense_sweep(
    const float* table, const int* face_ids, const int* counts, float* state,
    int runs, int slots, int num_tiles, int tiles_x, int tile_h, int tile_w,
    int chunk, int width_d, int channels, float sx, float sy,
    cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)chunk * width_d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(dense_sweep_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  dense_sweep_kernel<<<runs, tile_h * tile_w, smem, stream>>>(
      table, face_ids, counts, state, slots, num_tiles, tiles_x, tile_h,
      tile_w, chunk, width_d, channels, sx, sy);
  return (int)cudaGetLastError();
}
