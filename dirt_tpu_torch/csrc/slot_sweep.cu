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
// run.  One warp finds its slots, a consecutive range of the batch-folded,
// non-decreasing slot_tile (slots.cuh's find_slot_run): a 33-ary search,
// then one round that reads the window of 96 slots where the run starts,
// and compacts the live slots (slot_block >= 0; the others are a tile's
// mandatory slot without hits and the filler tail), in order, their
// batch-folded face blocks (slot_dma), into a visit list in shared memory.
// A run whose slots outrun that window is compacted by slots.cuh's
// SlotFill, K6's fill.  From there it is K1's walk (sweep_math.cuh's
// sweep_run): the same staging, face groups, bbox cull and combine, so the
// state equals K1's bit for bit wherever the two schedules visit the same
// blocks.  A tile without a live slot writes the background, which stands
// for the aliased input, and retires.
//
// What bounds it on the H100: as K1 (raster_sweep.cu), the empty runs'
// state write and the busiest run's chain of face tests; on top, each
// block's search of the slot list, which every block, empty or not, waits
// for.  Two binary searches one after the other chained 32 dependent
// loads of the bench's 36,864-slot list, and the walk read slot_block,
// then slot_dma, before each visit; that cost 0.18 ms (NVIDIA H100 80GB
// HBM3, 700 W; PERF.md).
// Here the search takes three rounds, the first ones of every block
// probing the same, cached points, and the last one also brings the
// run's items and visits.

// Built with -fmad=false and IEEE division: the state equals the plain
// version's (forward_blocks.slot_sweep_plain) bit for bit.

#include <cuda_runtime.h>

#include "slots.cuh"
#include "sweep_math.cuh"

namespace {

// The run's visits: the piece find_slot_run compacted, or SlotFill's
// pieces where the run's slots outran the search's window.
struct SweepSlotFill {
  dirt::SlotFill slots;
  int found;      // visits find_slot_run compacted into the list, or -1
  bool given;

  __device__ void reset() {
    given = false;
    slots.reset();
  }
  __device__ bool done() const { return found >= 0 ? given : slots.done(); }
  __device__ int next(int* list) {
    if (found < 0) return slots.next(list);
    given = true;
    return found;
  }
};

// kMaxThreads / kMinBlocks: the launch bound, as K1's.
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) slot_sweep_kernel(
    const float* __restrict__ table,      // [B*NB, chunk, width_d]
    const int* __restrict__ slot_tile,    // [B*S], batch-folded tile
    const int* __restrict__ slot_block,   // [B*S], per-image block or -1
    const int* __restrict__ slot_dma,     // [B*S], batch-folded block
    float* __restrict__ state,            // [B*T, C+9, PIX]
    int slots, int num_tiles, int tiles_x, int tile_h, int tile_w,
    int chunk, int width_d, int channels, int height, int width, float sx,
    float sy, dirt::SweepShape shape) {
  extern __shared__ __align__(16) float smem[];
  int* list = reinterpret_cast<int*>(smem + shape.region);
  int* scratch = list + shape.list;
  const int bt = blockIdx.x;
  const int tile = bt % num_tiles;
  const int pix = tile_h * tile_w;
  if (threadIdx.x < 32) {
    const dirt::SlotRun run = dirt::find_slot_run(
        slot_tile, slot_block, slot_dma, slots, bt, list);
    if (threadIdx.x == 0) {
      scratch[33] = run.lo;
      scratch[34] = run.hi;
      scratch[35] = run.live;
    }
  }
  __syncthreads();
  SweepSlotFill fill{{slot_block, slot_dma, scratch[33], scratch[34], scratch,
                      shape.list, 0},
                     scratch[35], false};
  dirt::sweep_run(
      fill, dirt::StagedFaces<false>{table, chunk, width_d},
      dirt::StateEpilogue{table, width_d, channels,
                          state + (long long)bt * (channels + 9) * pix, pix},
      shape, smem, (tile / tiles_x) * tile_h, (tile % tiles_x) * tile_w,
      tile_w, pix, height, width, sx, sy);
}

}  // namespace

extern "C" int dirt_slot_sweep(
    const float* table, const int* slot_tile, const int* slot_block,
    const int* slot_dma, float* state, int runs, int slots, int num_tiles,
    int tiles_x, int tile_h, int tile_w, int chunk, int width_d, int channels,
    float sx, float sy, int height, int width, int groups, int cap,
    int region, int list, int vec16, int smem, cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const dirt::SweepShape shape{groups, cap, region, list, vec16};
  const int threads = groups * tile_h * tile_w;
  auto kernel = threads <= dirt::kSweepThreads
                    ? slot_sweep_kernel<dirt::kSweepThreads,
                                        dirt::kSweepBlocks>
                    : slot_sweep_kernel<1024, 1>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  kernel<<<runs, threads, smem, stream>>>(
      table, slot_tile, slot_block, slot_dma, state, slots, num_tiles,
      tiles_x, tile_h, tile_w, chunk, width_d, channels, height, width, sx,
      sy, shape);
  return (int)cudaGetLastError();
}
