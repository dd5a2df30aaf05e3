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
// ride from one slot to the next.  One thread block owns one (image, face
// block) run and one thread one face of it.  The block finds its run's
// slots, a consecutive range of the batch-folded, non-decreasing
// slot_run, by binary search (slots.cuh), and walks them in order with
// K3's run walk (grad_math.cuh's reduce_run): slots with tile -1 (a
// block's mandatory slot without hits, the filler tail) are skipped, every
// other slot's tile (slot_dma, batch-folded) is staged in shared memory
// and its pixels are added to the face's sums in registers.  No atomics:
// each face row has one owner and K3's summation order (colour passes of
// four, tiles ascending, pixels in order), so the rows equal K3's bit for
// bit on the same tiles.  A run without a live slot writes zeros, which
// stand for the aliased zeros.
//
// What bounds it on the H100: as K3, the pixel scan per visit and the
// staging of each tile's planes (L2-resident), plus one binary search per
// face block over the slot list.
//
// The summation order differs from the plain version's (torch sums each
// [chunk, pix] plane with its own reduction tree), so the rows agree with
// grad_blocks.slot_grad_reduce_plain within a normalised tolerance.

#include <cuda_runtime.h>

#include "grad_math.cuh"
#include "slots.cuh"

namespace {

__global__ void slot_grad_kernel(
    const float* __restrict__ table,     // [R, chunk, width_d]
    const float* __restrict__ planes,    // [B*T, n_planes, pix]
    const int* __restrict__ slot_run,    // [B*S], batch-folded face block
    const int* __restrict__ slot_item,   // [B*S], per-image tile or -1
    const int* __restrict__ slot_dma,    // [B*S], batch-folded tile
    float* __restrict__ out,             // [R, chunk, d_out]
    int slots, int chunk, int width_d, int n_planes, int pix, int d_out,
    int channels, int want_pos, dirt::GradLayout layout) {
  extern __shared__ float tile[];        // [n_planes, pix]
  const int run = blockIdx.x;
  const int f = threadIdx.x;
  const dirt::GradFace face = dirt::load_grad_face(
      table + ((long long)run * chunk + f) * width_d);
  const int lo = dirt::lower_bound(slot_run, slots, run);
  const int hi = dirt::lower_bound(slot_run, slots, run + 1);
  dirt::reduce_run(
      planes, hi - lo,
      [&](int i) {
        return slot_item[lo + i] < 0 ? -1LL : (long long)slot_dma[lo + i];
      },
      tile, n_planes, pix, face, layout, want_pos, channels, d_out,
      out + ((long long)run * chunk + f) * d_out);
}

}  // namespace

extern "C" int dirt_slot_grad_reduce(
    const float* table, const float* planes, const int* slot_run,
    const int* slot_item, const int* slot_dma, float* out, int runs,
    int slots, int chunk, int width_d, int n_planes, int pix, int d_out,
    int channels, int want_pos, int l_ax, int l_ay, int l_px, int l_py,
    int l_bd, int l_fd, int l_bp, int l_fp, int l_grad, cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)n_planes * pix * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(slot_grad_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dirt::GradLayout layout{l_ax, l_ay, l_px, l_py, l_bd,
                                l_fd, l_bp, l_fp, l_grad};
  slot_grad_kernel<<<runs, chunk, smem, stream>>>(
      table, planes, slot_run, slot_item, slot_dma, out, slots, chunk,
      width_d, n_planes, pix, d_out, channels, want_pos, layout);
  return (int)cudaGetLastError();
}
