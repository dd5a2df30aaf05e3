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
// Work: one thread block per (image, tile) of tile_h x tile_w pixels; the
// lists are forward_pallas._pack_faces' (via forward_dense.pack), K8's.
// The block runs sweep_math.cuh's run walk, sweep_run, as K8 does: the
// tile's list (face_ids[bt, 0 .. counts[bt]), rows of the face table, hits
// first in draw order) copied into shared memory in pieces of shape.list
// ids (slots.cuh's CsrFill), each piece's rows staged by cp.async (their
// first 24 columns, all at once or through two halves), the list dealt to
// S face groups of one thread a pixel (entry v of a staged batch to group
// v mod S: StagedFaces<true>), a face tested only where its pixel bbox
// (columns 20-23) holds the pixel, and the groups' lexicographic (depth,
// original index) winners combined in group order.  Group 0 writes the
// packed state [C+9, PIX] of forward_dense (StateEpilogue, K1's);
// forward_dense.finalize divides.  A tile without a listed face writes the
// background state with every thread and retires.
//
// Only the listed hits are tested: the TPU's live-chunk tail holds faces
// whose conservative bboxes miss the tile, which cover nothing, so the
// winner is the same.  The state covers the whole padded tile, pixels past
// the image edge too; there the cull compares the pixel clamped to the
// image, as the bbox is clamped, so a face that covers such a pixel still
// passes it (tests/test_torch_list_walk.py holds the plain side of this).
//
// What bounds it on the H100: the bytes bound is the state it writes
// (16 x 256 tiles x 12 rows x 256 pixels x 4 B = 50 MB at the bench), far
// more than the face table (1.2 MB) and the lists it reads: 0.0154 ms.
// But the work sits in few tiles (96 of 4,096 busy at the bench, 301 faces
// in the busiest list; 3,728 on the 8,192-face scene), so the time is the
// empty tiles' state writes plus the busiest list's chain of face tests on
// its SM.  The walk halves that chain with two face groups, turns most
// tests into four compares with the bbox cull and stages a piece with one
// barrier; the empty tiles write their state by float4 stores and retire,
// and the launch bound (K1's) keeps three blocks an SM in flight.
//
// Built with -fmad=false and IEEE division: the state equals the plain
// version's (forward_dense.dense_sweep_plain) under torch.equal, bit for
// bit but for the sign of a zero: a -0.0 edge value or numerator of the
// winner, which the plain version's pick sum turns into +0.0, stays -0.0
// here (as in K1's state).

#include <cuda_runtime.h>

#include "slots.cuh"
#include "sweep_math.cuh"

namespace {

// kMaxThreads / kMinBlocks: the launch bound, as K1's.
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    dense_sweep_kernel(
        const float* __restrict__ table,      // [B*F', width_d]
        const int* __restrict__ face_ids,     // [B*T, slots], table rows
        const int* __restrict__ counts,       // [B*T]
        float* __restrict__ state,            // [B*T, C+9, PIX]
        int slots, int num_tiles, int tiles_x, int tile_h, int tile_w,
        int width_d, int channels, int height, int width, float sx, float sy,
        dirt::SweepShape shape) {
  extern __shared__ __align__(16) float smem[];
  const int bt = blockIdx.x;
  const int tile = bt % num_tiles;
  const int pix = tile_h * tile_w;
  const dirt::StateEpilogue out{table, width_d, channels,
                                state + (long long)bt * (channels + 9) * pix,
                                pix};
  dirt::CsrFill fill{face_ids + (long long)bt * slots, counts[bt], shape.list,
                     0};
  dirt::sweep_run(fill, dirt::StagedFaces<true>{table, 1, width_d}, out,
                  shape, smem, (tile / tiles_x) * tile_h,
                  (tile % tiles_x) * tile_w, tile_w, pix, height, width, sx,
                  sy);
}

}  // namespace

extern "C" int dirt_dense_sweep(
    const float* table, const int* face_ids, const int* counts, float* state,
    int runs, int slots, int num_tiles, int tiles_x, int tile_h, int tile_w,
    int width_d, int channels, int height, int width, float sx, float sy,
    int groups, int cap, int region, int list, int vec16, int smem,
    cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const dirt::SweepShape shape{groups, cap, region, list, vec16};
  const int threads = groups * tile_h * tile_w;
  auto kernel = threads <= dirt::kSweepThreads
                    ? dense_sweep_kernel<dirt::kSweepThreads,
                                         dirt::kSweepBlocks>
                    : dense_sweep_kernel<1024, 1>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  kernel<<<runs, threads, smem, stream>>>(
      table, face_ids, counts, state, slots, num_tiles, tiles_x, tile_h,
      tile_w, width_d, channels, height, width, sx, sy, shape);
  return (int)cudaGetLastError();
}
