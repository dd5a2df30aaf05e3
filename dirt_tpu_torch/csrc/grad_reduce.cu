// K3: grad_reduce -- the face-major masked gradient reductions.
//
// Replaces dirt_tpu/ops/grad_blocks.py:_grad_kernel_fused_resident and its
// DMA-streamed twin _grad_kernel_fused (the two differ only in how the
// plane stack reaches VMEM); the math is grad_dense.chunk_sums.
//
// Work: one thread block per (image, face block) -- a CSR run -- of chunk
// x P threads, P pixel lanes per face.  The block copies its run's tile
// ids (tile_ids[starts[r] .. starts[r] + counts[r]], ascending) into a
// visit list in shared memory (slots.cuh's CsrFill, shared with K1
// raster_sweep), then walks them with grad_math.cuh's
// reduce_run (shared with K6 slot_grad_reduce; the per-pixel arithmetic
// also with K9 dense_grad_reduce): a ring of two staged plane stacks fed
// by cp.async, each lane adding its face's masked sums
//   gx_k += bary_d_k * ax, gy_k += bary_d_k * ay,
//   gw_k += bary_d_k * (Px * cx + Py * cy)      where face_d == fid,
//   colour_kc += bary_pre_k * grad_c             where face_pre == fid,
// over its 1/P of each visit's pixels in registers, up to 12 colour
// channels a pass, then a fixed pairwise combine of the lanes.  No
// atomics: each face row has one owner and a fixed summation order, so
// the rows are deterministic.
//
// What bounds it on the H100: the bytes bound (each plane read once) is
// ~0.02 ms at the bench size; the walk is bound by latency -- per visit,
// the scan of pix / P pixels (two broadcast shared loads and compares
// each) and one barrier -- and by the longest run, since all runs are
// resident at once (B * NB blocks of chunk * P threads).  Against one
// warp a block, each thread scanning every pixel of a visit alone, the
// design gives P times the warps and 1/P of the serial scan, overlaps
// each visit's staging with the previous scan, keeps dependent global
// loads out of the walk, and reduces three or ten colour channels in one
// walk instead of one to three passes of four.
//
// Registers (nvcc -Xptxas -v, sm_90a, CUDA 12.8): blocks of up to 256
// threads use 64, 80 and 114 for colour groups of 4, 8 and 12 (a thread
// holds 9 + 3G sums), without spills; blocks of up to 1024 threads are
// held to 64 by __launch_bounds__, and spill 16 bytes (G = 8) and 64
// (G = 12) a thread.  The bench's 256-thread blocks of group 4 fit four
// to an SM by registers.
//
// The summation order differs from the plain version's (torch sums each
// [chunk, pix] plane with its own reduction tree), so the rows agree within
// a normalised tolerance, not bitwise.

#include <cuda_runtime.h>

#include "grad_math.cuh"
#include "slots.cuh"

namespace {

template <int G, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads) grad_reduce_kernel(
    const float* __restrict__ table,     // [R, chunk, width_d]
    const float* __restrict__ planes,    // [B*T, n_planes, pix]
    const int* __restrict__ starts,      // [R]
    const int* __restrict__ counts,      // [R]
    const int* __restrict__ tile_ids,    // [B*S], batch-folded
    float* __restrict__ out,             // [R, chunk, d_out]
    int chunk, int width_d, int n_planes, int pix, int d_out, int channels,
    int want_pos, dirt::GradLayout layout, dirt::RunShape shape) {
  extern __shared__ __align__(16) float smem[];
  const int run = blockIdx.x;
  const int f = threadIdx.x % chunk;
  const dirt::GradFace face = dirt::load_grad_face(
      table + ((long long)run * chunk + f) * width_d);
  dirt::CsrFill fill{tile_ids + starts[run], counts[run], dirt::kVisitList,
                     0};
  dirt::reduce_run<G>(fill, planes, (long long)n_planes * pix, pix, chunk,
                      shape, smem, face, layout, want_pos != 0, channels,
                      d_out, out + (long long)run * chunk * d_out);
}

template <int G, int kMaxThreads>
int launch(const float* table, const float* planes, const int* starts,
           const int* counts, const int* tile_ids, float* out, int runs,
           int chunk, int width_d, int n_planes, int pix, int d_out,
           int channels, int want_pos, const dirt::GradLayout& layout,
           const dirt::RunShape& shape, size_t smem, cudaStream_t stream) {
  auto kernel = grad_reduce_kernel<G, kMaxThreads>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  kernel<<<runs, chunk * shape.lanes, smem, stream>>>(
      table, planes, starts, counts, tile_ids, out, chunk, width_d, n_planes,
      pix, d_out, channels, want_pos, layout, shape);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dirt_grad_reduce(
    const float* table, const float* planes, const int* starts,
    const int* counts, const int* tile_ids, float* out, int runs, int chunk,
    int width_d, int n_planes, int pix, int d_out, int channels,
    int want_pos, int l_ax, int l_ay, int l_px, int l_py, int l_bd, int l_fd,
    int l_bp, int l_fp, int l_grad, int group, int lanes, int depth,
    int slot, int region, int staged, int vec16, int smem,
    cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const dirt::GradLayout layout{l_ax, l_ay, l_px, l_py, l_bd,
                                l_fd, l_bp, l_fp, l_grad};
  const dirt::RunShape shape{lanes, depth, slot, region, staged, vec16};
  const bool wide = chunk * lanes > 256;
#define DIRT_LAUNCH(G, T)                                                   \
  launch<G, T>(table, planes, starts, counts, tile_ids, out, runs, chunk,   \
               width_d, n_planes, pix, d_out, channels, want_pos, layout,   \
               shape, smem, stream)
  switch (group) {
    case 4: return wide ? DIRT_LAUNCH(4, 1024) : DIRT_LAUNCH(4, 256);
    case 8: return wide ? DIRT_LAUNCH(8, 1024) : DIRT_LAUNCH(8, 256);
    case 12: return wide ? DIRT_LAUNCH(12, 1024) : DIRT_LAUNCH(12, 256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DIRT_LAUNCH
}
