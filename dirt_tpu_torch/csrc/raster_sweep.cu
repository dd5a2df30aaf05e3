// K1: raster_sweep -- the block-binned forward sweep.
//
// Replaces dirt_tpu/ops/forward_blocks.py:_raster_kernel_fused (the TPU's
// production forward sweep, with its math in forward_dense._chunk_candidates
// and merge_state).
//
// Work: one thread block per (image, tile) run of tile_h x tile_w pixels.
// A run without a visit writes the background and retires.  Else the block
// copies its tile's CSR run of face blocks (block_ids[starts[bt] ..
// starts[bt] + counts[bt]], ascending) into a visit list in shared memory
// and sweeps it with sweep_math.cuh's sweep_run, shared with K5b
// slot_sweep, K5 resident_sweep and K8 pallas_raster: the visits' face
// rows staged by cp.async, each visit's faces dealt to S face groups of
// one thread a pixel, a face tested only at the pixels its bbox holds
// (edge functions, the COVER_FAST fill rule with the |s_z| <= |s_w| clip,
// depth s_z / s_w, and the lexicographic (depth, original face index)
// z-test against the running winner, which starts at glClearDepth's
// (1.0, -1)), then the groups' winners combined in group order and the
// packed state [C+9, PIX] of forward_dense written.
//
// What bounds it on the H100: the bytes bound is the state write (16 x 256
// tiles x 12 rows x 256 pixels x 4 B = 50 MB at the bench, 0.015 ms), the
// face tests' operations a third of that.  But the work sits in few runs
// (96 of 4,096 at the bench, 448 faces in the busiest), so the time is
// the empty runs' state write plus the busiest run's chain of face tests
// on its SM, which one thread a pixel walking every face made 0.13 ms
// long (NVIDIA H100 80GB HBM3, 700 W; PERF.md).  Here two face
// groups halve the chain, the bbox cull turns three in four tests at the
// bench into four compares, staging takes one barrier a piece, and the
// launch bound (kSweepBlocks blocks of 512 threads an SM, 40 registers)
// keeps enough empty runs in flight to write at the memory's rate.  The
// shape is forward_blocks.sweep_shape.

// Built with -fmad=false and IEEE division: every product rounds as in
// eager PyTorch, so the state equals the plain version's
// (forward_blocks.raster_sweep_plain) bit for bit, except that a -0.0 the
// plain version's pick sum turns into +0.0 may stay -0.0 here.

#include <cuda_runtime.h>

#include "slots.cuh"
#include "sweep_math.cuh"

namespace {

// kMaxThreads / kMinBlocks: the launch bound, (kSweepThreads, kSweepBlocks)
// for the shapes sweep_shape gives up to kSweepThreads threads, (1024, 1)
// for a group of more (tiles of more than kSweepThreads pixels).
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) raster_sweep_kernel(
    const float* __restrict__ table,      // [B*NB, chunk, width_d]
    const int* __restrict__ starts,       // [B*T]
    const int* __restrict__ counts,       // [B*T]
    const int* __restrict__ block_ids,    // [B*S], batch-folded
    float* __restrict__ state,            // [B*T, C+9, PIX]
    int num_tiles, int tiles_x, int tile_h, int tile_w, int chunk,
    int width_d, int channels, int height, int width, float sx, float sy,
    dirt::SweepShape shape) {
  extern __shared__ __align__(16) float smem[];
  const int bt = blockIdx.x;
  const int tile = bt % num_tiles;
  const int pix = tile_h * tile_w;
  const int n = counts[bt];
  float* out = state + (long long)bt * (channels + 9) * pix;
  if (n == 0) {
    dirt::write_background(out, channels, pix);
    return;
  }
  dirt::CsrFill fill{block_ids + starts[bt], n, shape.list, 0};
  dirt::sweep_run(
      fill, dirt::StagedFaces<false>{table, chunk, width_d},
      dirt::StateEpilogue{table, width_d, channels, out, pix}, shape, smem,
      (tile / tiles_x) * tile_h, (tile % tiles_x) * tile_w, tile_w, pix,
      height, width, sx, sy);
}

}  // namespace

extern "C" int dirt_raster_sweep(
    const float* table, const int* starts, const int* counts,
    const int* block_ids, float* state, int runs, int num_tiles, int tiles_x,
    int tile_h, int tile_w, int chunk, int width_d, int channels, float sx,
    float sy, int height, int width, int groups, int cap, int region,
    int list, int vec16, int smem, cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const dirt::SweepShape shape{groups, cap, region, list, vec16};
  const int threads = groups * tile_h * tile_w;
  auto kernel = threads <= dirt::kSweepThreads
                    ? raster_sweep_kernel<dirt::kSweepThreads,
                                          dirt::kSweepBlocks>
                    : raster_sweep_kernel<1024, 1>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  kernel<<<runs, threads, smem, stream>>>(
      table, starts, counts, block_ids, state, num_tiles, tiles_x, tile_h,
      tile_w, chunk, width_d, channels, height, width, sx, sy, shape);
  return (int)cudaGetLastError();
}
