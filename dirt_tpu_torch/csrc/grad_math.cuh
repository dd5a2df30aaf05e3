// The per-pixel arithmetic of the gradient reductions, shared by K3
// grad_reduce (grad_reduce.cu, face-major) and K9 dense_grad_reduce
// (dense_grad.cu, tile-major) so the two cannot drift.  One thread owns one
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

}  // namespace dirt
