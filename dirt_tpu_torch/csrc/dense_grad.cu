// K9: dense_grad_reduce -- the tile-major masked gradient reductions of the
// "dense" gradient.
//
// Replaces dirt_tpu/ops/grad_dense.py:_grad_kernel_fused (a tile's whole
// face list resident, a loop writing each live chunk's rows and zeros for
// the dead ones) and _grad_kernel (the same rows, one chunk per grid
// step).  Both write the same rows; only the TPU's streaming differs, so
// one kernel covers both.  The math is grad_dense._chunk_sums.
//
// Work: one thread block per (image, tile, chunk of the tile's face list),
// one thread per face slot of the chunk.  A chunk at or past the tile's
// hit count is dead: its block writes zeros and returns (the rows scatter
// through sorted_orig into vertex rows, so they must be zeros, never left
// unwritten).  A live block reads each slot's row of the gradient face
// table by index (forward_pallas._pack_faces layout), stages the tile's
// plane stack in shared memory in pieces of `piece` pixels -- every thread
// then reads the same pixel, a shared-memory broadcast -- and each thread
// adds its face's masked sums over the tile's pixels with grad_math.cuh's
// per-pixel arithmetic (shared with K3 grad_reduce), in registers.  No
// atomics: each row has one owner and a fixed summation order.  Colour
// channels are reduced in passes of four; a tile that fits one piece is
// staged once for all passes.  As on the TPU, the tail slots of a live
// chunk (faces whose bboxes miss the tile) are reduced too, to zeros.
//
// What bounds it on the H100: the pixel scan, pix iterations of two shared
// compares per face slot of every live chunk (data-dependent: ~count x
// pix per tile), plus the masked products where a pixel belongs to the
// slot's face.  Device memory traffic is the tile's planes, read once per
// live chunk (L2-resident), and the rows it writes, O(T x slots x d_out):
// the GPU tile is chosen large (32x128, as dirt_tpu's) to keep those rows
// at ~9.4 MB at the bench size instead of ~151 MB at 16x16 tiles; a
// thread per face slot (not per pixel) puts no limit on the tile's size.
//
// The summation order differs from the plain version's (torch sums each
// [chunk, pix] plane with its own reduction tree), so the rows agree within
// a normalised tolerance, not bitwise.

#include <cuda_runtime.h>

#include "grad_math.cuh"

namespace {

__global__ void dense_grad_kernel(
    const float* __restrict__ table,     // [B*F', width_d]
    const int* __restrict__ face_ids,    // [B*T, slots], batch-folded rows
    const int* __restrict__ counts,      // [B*T]
    const float* __restrict__ planes,    // [B*T, np_stride, pix]
    float* __restrict__ out,             // [B*T, slots, d_out]
    int slots, int chunk, int width_d, int n_planes, int np_stride, int pix,
    int piece, int d_out, int channels, int want_pos,
    dirt::GradLayout layout) {
  extern __shared__ float tile[];        // [n_planes, piece]
  const int num_chunks = slots / chunk;
  const long long bt = blockIdx.x / num_chunks;
  const int slot = (blockIdx.x % num_chunks) * chunk + threadIdx.x;
  float* dst = out + (bt * slots + slot) * d_out;
  if ((blockIdx.x % num_chunks) * chunk >= counts[bt]) {
    for (int j = 0; j < d_out; ++j) dst[j] = 0.0f;
    return;                              // the whole block is dead
  }

  const dirt::GradFace face = dirt::load_grad_face(
      table + (long long)face_ids[bt * slots + slot] * width_d);
  const float* src = planes + bt * np_stride * pix;
  const bool want_col = layout.fp >= 0;
  const int d_corner = d_out / 3;
  const int col_base = want_pos ? 3 : 0;
  const bool one_piece = piece >= pix;
  const int passes = want_col ? (channels + dirt::kGroup - 1) / dirt::kGroup
                              : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const bool do_pos = want_pos && pass == 0;
    const int c0 = pass * dirt::kGroup;
    const int nc = want_col ? min(dirt::kGroup, channels - c0) : 0;
    dirt::GradSums sums;
    dirt::clear_sums(sums);
    for (int p0 = 0; p0 < pix; p0 += piece) {
      const int n = min(piece, pix - p0);
      if (!one_piece || pass == 0) {
        __syncthreads();
        for (int j = threadIdx.x; j < n_planes * n; j += blockDim.x) {
          const int k = j / n;
          const int q = j - k * n;
          tile[k * piece + q] = src[(long long)k * pix + p0 + q];
        }
        __syncthreads();
      }
      for (int q = 0; q < n; ++q) {
        dirt::add_pixel(tile, piece, q, face, layout, do_pos, want_col, c0,
                        nc, sums);
      }
    }
    dirt::write_sums(dst, d_corner, do_pos, col_base, c0, nc, sums);
  }
}

}  // namespace

extern "C" int dirt_dense_grad_reduce(
    const float* table, const int* face_ids, const int* counts,
    const float* planes, float* out, int runs, int slots, int chunk,
    int width_d, int n_planes, int np_stride, int pix, int piece, int d_out,
    int channels, int want_pos, int l_ax, int l_ay, int l_px, int l_py,
    int l_bd, int l_fd, int l_bp, int l_fp, int l_grad,
    cudaStream_t stream) {
  if (runs == 0 || slots == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)n_planes * piece * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(dense_grad_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const dirt::GradLayout layout{l_ax, l_ay, l_px, l_py, l_bd,
                                l_fd, l_bp, l_fp, l_grad};
  const long long blocks = (long long)runs * (slots / chunk);
  dense_grad_kernel<<<(unsigned int)blocks, chunk, smem, stream>>>(
      table, face_ids, counts, planes, out, slots, chunk, width_d, n_planes,
      np_stride, pix, piece, d_out, channels, want_pos, layout);
  return (int)cudaGetLastError();
}
