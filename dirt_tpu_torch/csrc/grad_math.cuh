// The per-pixel arithmetic of the gradient reductions, shared by K3
// grad_reduce (grad_reduce.cu, face-major), K6 slot_grad_reduce
// (slot_grad.cu, face-major on slot lists) and K9 dense_grad_reduce
// (dense_grad.cu, tile-major) so they cannot drift.  One thread owns one
// face and adds, over pixels held in shared memory, grad_dense._chunk_sums'
// masked sums:
//   gx_k += bary_d_k * ax, gy_k += bary_d_k * ay,
//   gw_k += bary_d_k * (Px * cx + Py * cy)      where face_d == fid,
//   colour_kc += bary_pre_k * grad_c             where face_pre == fid,
// in registers (gw is negated when written).  Colour channels are reduced in
// groups of kGroup per pass, so any channel count fits the register budget.

#pragma once

#include <cuda_runtime.h>

namespace dirt {

constexpr int kGroup = 4;   // colour channels per pass

// Plane indices of grad_dense.plane_layout (-1: not in the stack).
struct GradLayout {
  int ax, ay, px, py, bd, fd, bp, fp, grad;
};

// A face's gradient-table constants: original index, corner clip x and y.
struct GradFace {
  float fid, x0, x1, x2, y0, y1, y2;
};

__device__ __forceinline__ GradFace load_grad_face(const float* row) {
  return GradFace{row[4], row[6], row[7], row[8], row[9], row[10], row[11]};
}

struct GradSums {
  float gx[3], gy[3], gw[3];
  float gc[3][kGroup];
};

__device__ __forceinline__ void clear_sums(GradSums& s) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.gx[k] = 0.0f;
    s.gy[k] = 0.0f;
    s.gw[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < kGroup; ++c) s.gc[k][c] = 0.0f;
  }
}

// Adds pixel p of `tile` (plane i at tile[i * stride + p]) to the face's
// sums: the position terms when do_pos, colour channels c0 .. c0 + nc - 1
// when want_col.
__device__ __forceinline__ void add_pixel(const float* tile, int stride,
                                          int p, const GradFace& f,
                                          const GradLayout& L, bool do_pos,
                                          bool want_col, int c0, int nc,
                                          GradSums& s) {
  if (do_pos && tile[L.fd * stride + p] == f.fid) {
    const float b0 = tile[(L.bd + 0) * stride + p];
    const float b1 = tile[(L.bd + 1) * stride + p];
    const float b2 = tile[(L.bd + 2) * stride + p];
    const float cx = (b0 * f.x0 + b1 * f.x1) + b2 * f.x2;
    const float cy = (b0 * f.y0 + b1 * f.y1) + b2 * f.y2;
    const float pv = tile[L.px * stride + p] * cx + tile[L.py * stride + p] * cy;
    const float ax = tile[L.ax * stride + p];
    const float ay = tile[L.ay * stride + p];
    s.gx[0] += b0 * ax; s.gy[0] += b0 * ay; s.gw[0] += b0 * pv;
    s.gx[1] += b1 * ax; s.gy[1] += b1 * ay; s.gw[1] += b1 * pv;
    s.gx[2] += b2 * ax; s.gy[2] += b2 * ay; s.gw[2] += b2 * pv;
  }
  if (want_col && tile[L.fp * stride + p] == f.fid) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float bp = tile[(L.bp + k) * stride + p];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        if (c < nc) s.gc[k][c] += bp * tile[(L.grad + c0 + c) * stride + p];
      }
    }
  }
}

// Writes one pass's sums into the face's output row [3, d_corner]: per
// corner (gx, gy, gw) when do_pos, then the colour channels of the pass.
__device__ __forceinline__ void write_sums(float* dst, int d_corner,
                                           bool do_pos, int col_base, int c0,
                                           int nc, const GradSums& s) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float* d = dst + k * d_corner;
    if (do_pos) {
      d[0] = s.gx[k];
      d[1] = s.gy[k];
      d[2] = -s.gw[k];
    }
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      if (c < nc) d[col_base + c0 + c] = s.gc[k][c];
    }
  }
}

// Reduces one face's row over a run of n tile visits, in K3's order:
// colour passes of kGroup channels (the first pass also takes the
// position terms), each walking the visits in order and each visit's
// pixels in order.  tile_at(i) gives visit i's tile in `planes` ([tiles,
// n_planes, pix]), or a negative value for a visit to skip (the same for
// every thread).  Each visit's planes are staged in shared memory `tile`;
// every thread of the block must call it (it synchronises).  The row
// [3, d_out / 3] is written to dst: zeros when no visit is live.  Used by
// K3 grad_reduce (CSR runs) and K6 slot_grad_reduce (slot lists), so the
// two sum in the same order and agree bit for bit.
template <typename TileAt>
__device__ __forceinline__ void reduce_run(const float* planes, int n,
                                           TileAt tile_at, float* tile,
                                           int n_planes, int pix,
                                           const GradFace& face,
                                           const GradLayout& layout,
                                           bool want_pos, int channels,
                                           int d_out, float* dst) {
  const bool want_col = layout.fp >= 0;
  const int d_corner = d_out / 3;
  const int col_base = want_pos ? 3 : 0;
  const int tile_floats = n_planes * pix;
  const int passes = want_col ? (channels + kGroup - 1) / kGroup : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const bool do_pos = want_pos && pass == 0;
    const int c0 = pass * kGroup;
    const int nc = want_col ? min(kGroup, channels - c0) : 0;
    GradSums sums;
    clear_sums(sums);

    for (int i = 0; i < n; ++i) {
      const long long tid = tile_at(i);
      if (tid < 0) continue;
      __syncthreads();
      const float* src = planes + tid * tile_floats;
      for (int j = threadIdx.x; j < tile_floats; j += blockDim.x) {
        tile[j] = src[j];
      }
      __syncthreads();
      for (int p = 0; p < pix; ++p) {
        add_pixel(tile, pix, p, face, layout, do_pos, want_col, c0, nc,
                  sums);
      }
    }
    write_sums(dst, d_corner, do_pos, col_base, c0, nc, sums);
  }
}

}  // namespace dirt
