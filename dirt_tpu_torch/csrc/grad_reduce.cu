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
// in registers (gw is negated at the end).  No atomics: each face row has
// one owner and a fixed summation order, so the rows are deterministic.
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

namespace {

constexpr int kGroup = 4;   // colour channels per pass

__global__ void grad_reduce_kernel(
    const float* __restrict__ table,     // [R, chunk, width_d]
    const float* __restrict__ planes,    // [B*T, n_planes, pix]
    const int* __restrict__ starts,      // [R]
    const int* __restrict__ counts,      // [R]
    const int* __restrict__ tile_ids,    // [B*S], batch-folded
    float* __restrict__ out,             // [R, chunk, d_out]
    int chunk, int width_d, int n_planes, int pix, int d_out, int channels,
    int want_pos, int l_ax, int l_ay, int l_px, int l_py, int l_bd, int l_fd,
    int l_bp, int l_fp, int l_grad) {
  extern __shared__ float tile[];        // [n_planes, pix]
  const int run = blockIdx.x;
  const int f = threadIdx.x;
  const float* row = table + ((long long)run * chunk + f) * width_d;
  const float fid = row[4];
  const float x0 = row[6], x1 = row[7], x2 = row[8];
  const float y0 = row[9], y1 = row[10], y2 = row[11];
  const bool want_col = l_fp >= 0;
  const int d_corner = d_out / 3;
  const int col_base = want_pos ? 3 : 0;
  float* dst = out + ((long long)run * chunk + f) * d_out;

  const int start = starts[run];
  const int n = counts[run];
  const int tile_floats = n_planes * pix;
  const int passes = want_col ? (channels + kGroup - 1) / kGroup : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const bool do_pos = want_pos && pass == 0;
    const int c0 = pass * kGroup;
    const int nc = want_col ? min(kGroup, channels - c0) : 0;
    float gx[3] = {0.0f, 0.0f, 0.0f};
    float gy[3] = {0.0f, 0.0f, 0.0f};
    float gw[3] = {0.0f, 0.0f, 0.0f};
    float gc[3][kGroup];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int c = 0; c < kGroup; ++c) gc[k][c] = 0.0f;
    }

    for (int i = 0; i < n; ++i) {
      const long long tid = tile_ids[start + i];
      __syncthreads();
      const float* src = planes + tid * tile_floats;
      for (int j = threadIdx.x; j < tile_floats; j += blockDim.x) {
        tile[j] = src[j];
      }
      __syncthreads();
      for (int p = 0; p < pix; ++p) {
        if (do_pos && tile[l_fd * pix + p] == fid) {
          const float b0 = tile[(l_bd + 0) * pix + p];
          const float b1 = tile[(l_bd + 1) * pix + p];
          const float b2 = tile[(l_bd + 2) * pix + p];
          const float cx = (b0 * x0 + b1 * x1) + b2 * x2;
          const float cy = (b0 * y0 + b1 * y1) + b2 * y2;
          const float pv = tile[l_px * pix + p] * cx + tile[l_py * pix + p] * cy;
          const float ax = tile[l_ax * pix + p];
          const float ay = tile[l_ay * pix + p];
          gx[0] += b0 * ax; gy[0] += b0 * ay; gw[0] += b0 * pv;
          gx[1] += b1 * ax; gy[1] += b1 * ay; gw[1] += b1 * pv;
          gx[2] += b2 * ax; gy[2] += b2 * ay; gw[2] += b2 * pv;
        }
        if (want_col && tile[l_fp * pix + p] == fid) {
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float bp = tile[(l_bp + k) * pix + p];
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
              if (c < nc) gc[k][c] += bp * tile[(l_grad + c0 + c) * pix + p];
            }
          }
        }
      }
    }

    for (int k = 0; k < 3; ++k) {
      float* d = dst + k * d_corner;
      if (do_pos) {
        d[0] = gx[k];
        d[1] = gy[k];
        d[2] = -gw[k];
      }
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        if (c < nc) d[col_base + c0 + c] = gc[k][c];
      }
    }
  }
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
  grad_reduce_kernel<<<runs, chunk, smem, stream>>>(
      table, planes, starts, counts, tile_ids, out, chunk, width_d, n_planes,
      pix, d_out, channels, want_pos, l_ax, l_ay, l_px, l_py, l_bd, l_fd,
      l_bp, l_fp, l_grad);
  return (int)cudaGetLastError();
}
