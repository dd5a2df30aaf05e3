// K3: grad_reduce -- the face-major masked gradient reductions.
//
// Replaces dirt_tpu/ops/grad_blocks.py:_grad_kernel_fused_resident and its
// DMA-streamed twin _grad_kernel_fused (the two differ only in how the
// plane stack reaches VMEM); the math is grad_dense.chunk_sums.
//
// Work: one thread block per (image, face block) -- a CSR run -- and one
// thread per face of the block.  The block walks its run's tiles
// (tile_ids[starts[r] .. starts[r] + counts[r]], ascending); each visit
// stages the tile's plane stack (np x pix floats) in shared memory, and
// every thread scans the tile's pixels, adding for its face
//   gx_k += bary_d_k * ax, gy_k += bary_d_k * ay,
//   gw_k += bary_d_k * (Px * cx + Py * cy)      where face_d == fid,
//   colour_kc += bary_pre_k * grad_c             where face_pre == fid,
// in registers (gw is negated at the end), with grad_math.cuh's run walk
// (shared with K6 slot_grad_reduce) and per-pixel arithmetic (shared with
// K9 dense_grad_reduce).  No atomics: each face row
// has one owner and a fixed summation order, so the rows are deterministic.
// Colour channels are reduced in passes of four (re-walking the run), so
// any channel count fits the register budget.
//
// What bounds it on the H100: per visit, the pixel scan (pix iterations of
// two shared-memory compares per thread, broadcast reads) and the staging
// of the tile's planes (np * pix floats, L2-resident).  The design keeps
// every reduction in registers and every plane read in shared memory, and
// the spatially sorted blocks keep runs short.  Occupancy is low at small
// face counts (B * F / chunk blocks of `chunk` threads): a later PR can
// split runs across blocks or reduce over pixels instead.
//
// The summation order differs from the plain version's (torch sums each
// [chunk, pix] plane with its own reduction tree), so the rows agree within
// a normalised tolerance, not bitwise.

#include <cuda_runtime.h>

#include "grad_math.cuh"

namespace {

__global__ void grad_reduce_kernel(
    const float* __restrict__ table,     // [R, chunk, width_d]
    const float* __restrict__ planes,    // [B*T, n_planes, pix]
    const int* __restrict__ starts,      // [R]
    const int* __restrict__ counts,      // [R]
    const int* __restrict__ tile_ids,    // [B*S], batch-folded
    float* __restrict__ out,             // [R, chunk, d_out]
    int chunk, int width_d, int n_planes, int pix, int d_out, int channels,
    int want_pos, dirt::GradLayout layout) {
  extern __shared__ float tile[];        // [n_planes, pix]
  const int run = blockIdx.x;
  const int f = threadIdx.x;
  const dirt::GradFace face = dirt::load_grad_face(
      table + ((long long)run * chunk + f) * width_d);
  const int start = starts[run];
  dirt::reduce_run(
      planes, counts[run],
      [&](int i) { return (long long)tile_ids[start + i]; }, tile, n_planes,
      pix, face, layout, want_pos, channels, d_out,
      out + ((long long)run * chunk + f) * d_out);
}

}  // namespace

extern "C" int dirt_grad_reduce(
    const float* table, const float* planes, const int* starts,
    const int* counts, const int* tile_ids, float* out, int runs, int chunk,
    int width_d, int n_planes, int pix, int d_out, int channels,
    int want_pos, int l_ax, int l_ay, int l_px, int l_py, int l_bd, int l_fd,
    int l_bp, int l_fp, int l_grad, cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)n_planes * pix * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(grad_reduce_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dirt::GradLayout layout{l_ax, l_ay, l_px, l_py, l_bd,
                                l_fd, l_bp, l_fp, l_grad};
  grad_reduce_kernel<<<runs, chunk, smem, stream>>>(
      table, planes, starts, counts, tile_ids, out, chunk, width_d, n_planes,
      pix, d_out, channels, want_pos, layout);
  return (int)cudaGetLastError();
}
