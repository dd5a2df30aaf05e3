// K5b: slot_sweep -- the forward sweep on the slot schedule.
//
// Replaces dirt_tpu/ops/forward_blocks.py:_raster_kernel, the TPU's slot
// kernel: a 1-D grid over slots, one (tile, face block) hit per grid step
// plus one mandatory slot per tile, each tile's state carried in VMEM
// across its consecutive steps and initialised from an aliased background
// input, so a tile whose slots the static budget cut stays background.
//
// Work: the H100 runs blocks in parallel and in no order, so nothing can
// ride from one slot to the next.  One thread block owns one (image, tile)
// run and one thread one pixel.  The block finds its run's slots, a
// consecutive range of the batch-folded, non-decreasing slot_tile, by
// binary search (slots.cuh), and walks them in order: slots with block -1
// (a tile's mandatory slot without hits, the filler tail) are skipped,
// every other slot's face block (slot_dma, batch-folded) is staged in
// shared memory and tested row by row with K1's per-face test
// (sweep_math.cuh's sweep_block).  A tile without a live slot writes the
// initial state, the background, which stands for the aliased input.
// The winner is a lexicographic minimum, so the state equals K1's bit for
// bit wherever the two schedules visit the same blocks.
//
// What bounds it on the H100: as K1, arithmetic and shared-memory reads
// per (pixel, swept face), plus one binary search per tile over the slot
// list (~log2(B*S) reads of an L2-resident array).  Device memory traffic
// is the face blocks (L2-resident), the slot arrays and one state write
// per pixel.
//
// Built with -fmad=false and IEEE division: the state equals the plain
// version's (forward_blocks.slot_sweep_plain) bit for bit.

#include <cuda_runtime.h>

#include "slots.cuh"
#include "sweep_math.cuh"

namespace {

__global__ void slot_sweep_kernel(
    const float* __restrict__ table,      // [B*NB, chunk, width_d]
    const int* __restrict__ slot_tile,    // [B*S], batch-folded tile
    const int* __restrict__ slot_block,   // [B*S], per-image block or -1
    const int* __restrict__ slot_dma,     // [B*S], batch-folded block
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
  const float xg = ((float)col + 0.5f) * sx - 1.0f;
  const float yg = 1.0f - ((float)row + 0.5f) * sy;

  dirt::Winner w;
  const int lo = dirt::lower_bound(slot_tile, slots, bt);
  const int hi = dirt::lower_bound(slot_tile, slots, bt + 1);
  for (int s = lo; s < hi; ++s) {
    if (slot_block[s] < 0) continue;     // the same for every thread
    dirt::sweep_block(table, slot_dma[s], chunk, width_d, rows, xg, yg, w);
  }

  if (p >= pix) return;
  dirt::write_state(table, width_d, channels, w,
                    state + (long long)bt * (channels + 9) * pix + p, pix);
}

}  // namespace

extern "C" int dirt_slot_sweep(
    const float* table, const int* slot_tile, const int* slot_block,
    const int* slot_dma, float* state, int runs, int slots, int num_tiles,
    int tiles_x, int tile_h, int tile_w, int chunk, int width_d, int channels,
    float sx, float sy, cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)chunk * width_d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(slot_sweep_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  slot_sweep_kernel<<<runs, tile_h * tile_w, smem, stream>>>(
      table, slot_tile, slot_block, slot_dma, state, slots, num_tiles,
      tiles_x, tile_h, tile_w, chunk, width_d, channels, sx, sy);
  return (int)cudaGetLastError();
}
