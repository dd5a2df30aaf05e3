// K6: slot_grad_reduce -- the face-major gradient reductions on the slot
// schedule.
//
// Replaces dirt_tpu/ops/grad_blocks.py:_grad_kernel, the TPU's slot
// kernel: a 1-D grid over slots, one (face block, tile) hit per grid step
// plus one mandatory slot per face block, each block's sums carried in
// VMEM across its consecutive steps and initialised from aliased zeros, so
// a block whose slots the static budget cut keeps zero gradients.  The
// math is grad_dense.chunk_sums.
//
// Work: the H100 runs blocks in parallel and in no order, so nothing can
// ride from one slot to the next.  One thread block of chunk x P threads
// owns one (image, face block) run.  Two threads find the ends of its
// slots, a consecutive range of the batch-folded, non-decreasing
// slot_run, by binary search at the same time (slots.cuh); the block then
// compacts the live slots (slot_item >= 0; the others are a block's
// mandatory slot without hits and the filler tail) into a visit list in
// shared memory, keeping their order, their batch-folded tiles
// (slot_dma) in pieces of at most kVisitList (slots.cuh's SlotFill, shared
// with K5b slot_sweep).  From there it is K3's walk
// (grad_math.cuh's reduce_run): the same list, lanes, ring, colour groups
// and lane combine, so the rows equal K3's bit for bit on the same tiles.
// No atomics.  A run without a live slot writes zeros, which stand for the
// aliased zeros.
//
// What bounds it on the H100: as K3 (grad_reduce.cu), latency -- the scan
// of pix / P pixels a visit and the longest run -- far above the bytes
// bound.  Searching in one thread would chain two ~15-step runs of
// dependent L2 loads, and reading slot_item, then slot_dma, before each
// visit's staging two more; here the searches run side by side once, and
// the per-slot loads are the compaction's coalesced reads, outside the
// walk.
//
// Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 64, 103 and 108 for
// groups of 4, 8 and 12 in blocks of up to 256 threads, without spills;
// 64 in blocks of up to 1024 threads, spilling 16 bytes (G = 8) and 68
// (G = 12) a thread.
//
// The summation order differs from the plain version's (torch sums each
// [chunk, pix] plane with its own reduction tree), so the rows agree with
// grad_blocks.slot_grad_reduce_plain within a normalised tolerance.

#include <cuda_runtime.h>

#include "grad_math.cuh"
#include "slots.cuh"

namespace {

template <int G, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) slot_grad_kernel(
    const float* __restrict__ table,     // [R, chunk, width_d]
    const float* __restrict__ planes,    // [B*T, n_planes, pix]
    const int* __restrict__ slot_run,    // [B*S], batch-folded face block
    const int* __restrict__ slot_item,   // [B*S], per-image tile or -1
    const int* __restrict__ slot_dma,    // [B*S], batch-folded tile
    float* __restrict__ out,             // [R, chunk, d_out]
    int slots, int chunk, int width_d, int n_planes, int pix, int d_out,
    int channels, int want_pos, dirt::GradLayout layout,
    dirt::RunShape shape) {
  extern __shared__ __align__(16) float smem[];
  int* scratch = reinterpret_cast<int*>(smem + shape.region) +
                 dirt::kVisitList;
  const int run = blockIdx.x;
  const int f = threadIdx.x % chunk;
  if (threadIdx.x < 2) {
    scratch[33 + threadIdx.x] =
        dirt::lower_bound(slot_run, slots, run + (int)threadIdx.x);
  }
  const dirt::GradFace face = dirt::load_grad_face(
      table + ((long long)run * chunk + f) * width_d);
  __syncthreads();
  dirt::SlotFill fill{slot_item, slot_dma, scratch[33], scratch[34], scratch,
                      dirt::kVisitList, 0};
  dirt::reduce_run<G>(fill, planes, (long long)n_planes * pix, pix, chunk,
                      shape, smem, face, layout, want_pos != 0, channels,
                      d_out, out + (long long)run * chunk * d_out);
}

template <int G, int kMaxThreads>
int launch(const float* table, const float* planes, const int* slot_run,
           const int* slot_item, const int* slot_dma, float* out, int runs,
           int slots, int chunk, int width_d, int n_planes, int pix,
           int d_out, int channels, int want_pos,
           const dirt::GradLayout& layout, const dirt::RunShape& shape,
           size_t smem, cudaStream_t stream) {
  auto kernel = slot_grad_kernel<G, kMaxThreads>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  kernel<<<runs, chunk * shape.lanes, smem, stream>>>(
      table, planes, slot_run, slot_item, slot_dma, out, slots, chunk,
      width_d, n_planes, pix, d_out, channels, want_pos, layout, shape);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dirt_slot_grad_reduce(
    const float* table, const float* planes, const int* slot_run,
    const int* slot_item, const int* slot_dma, float* out, int runs,
    int slots, int chunk, int width_d, int n_planes, int pix, int d_out,
    int channels, int want_pos, int l_ax, int l_ay, int l_px, int l_py,
    int l_bd, int l_fd, int l_bp, int l_fp, int l_grad, int group, int lanes,
    int depth, int slot, int region, int staged, int vec16, int smem,
    cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const dirt::GradLayout layout{l_ax, l_ay, l_px, l_py, l_bd,
                                l_fd, l_bp, l_fp, l_grad};
  const dirt::RunShape shape{lanes, depth, slot, region, staged, vec16};
  const bool wide = chunk * lanes > 256;
#define DIRT_LAUNCH(G, T)                                                   \
  launch<G, T>(table, planes, slot_run, slot_item, slot_dma, out, runs,     \
               slots, chunk, width_d, n_planes, pix, d_out, channels,       \
               want_pos, layout, shape, smem, stream)
  switch (group) {
    case 4: return wide ? DIRT_LAUNCH(4, 1024) : DIRT_LAUNCH(4, 256);
    case 8: return wide ? DIRT_LAUNCH(8, 1024) : DIRT_LAUNCH(8, 256);
    case 12: return wide ? DIRT_LAUNCH(12, 1024) : DIRT_LAUNCH(12, 256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DIRT_LAUNCH
}
