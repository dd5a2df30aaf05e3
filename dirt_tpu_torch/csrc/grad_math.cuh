// The gradient reductions' shared arithmetic and the face-major run walk.
//
// Per-pixel arithmetic, shared by K3 grad_reduce (grad_reduce.cu), K6
// slot_grad_reduce (slot_grad.cu) and K9 dense_grad_reduce (dense_grad.cu)
// so they cannot drift: one thread adds, for one face and over pixels
// held in shared memory, grad_dense._chunk_sums' masked sums
//   gx_k += bary_d_k * ax, gy_k += bary_d_k * ay,
//   gw_k += bary_d_k * (Px * cx + Py * cy)      where face_d == fid,
//   colour_kc += bary_pre_k * grad_c             where face_pre == fid,
// in registers (gw is negated when written), G colour channels a pass
// (4, 8 or 12; the wrappers' launch shapes pick G).  K9 combines a warp's
// partial sums with warp_sum, K3 and K6 theirs with combine_lanes.
//
// The run walk, reduce_run, is K3's and K6's whole kernel body: the H100
// form of dirt_tpu/ops/grad_blocks.py's face-major reductions
// (_grad_kernel_fused_resident, _grad_kernel_fused, _grad_kernel).  Its
// bound is the bytes each plane is read once, far below what the walk
// costs, so its design is about latency and parallelism, not arithmetic:
//   * P pixel lanes per face: a block is chunk x P threads (P a power of
//     two, at most 8 and at most 1024 / chunk); thread (lane q, face f)
//     adds its face's sums over pixels q, q + P, q + 2P, ... of every
//     visit, so a block has P times the warps and each visit 1/P of the
//     serial scan.  Threads are face-minor, so the threads of a warp share
//     q and read the same pixel: shared-memory broadcasts.
//   * A ring of staged tiles: visit i + 1's plane stack is copied into
//     shared memory with cp.async (16 bytes a copy where the stack is
//     16-byte aligned, else 4) while visit i is scanned; one barrier a
//     visit.  Depth 2, or 1 where two stacks do not fit the opt-in shared
//     memory (the wrapper decides).
//   * The visit list in shared memory: the caller's fill writes the run's
//     live tile ids there before the walk (in pieces of at most
//     kVisitList), so the ring's producer never waits on a dependent
//     global load.
//   * Up to 12 colour channels a pass, so three and ten channels take one
//     walk; the position terms ride on the first pass.  A thread then
//     holds 9 + 36 sums: 114 registers in K3's 256-thread blocks, and a
//     64-byte spill where __launch_bounds__(1024) caps it at 64 (the
//     kernels' notes give the counts).
//   * One owner per row, no atomics: after the walk the P partial rows of
//     each face are combined through shared memory (the ring's space) by a
//     fixed pairwise tree over q, and lane 0 writes the row.  Each
//     channel's order is the same whatever G, so rows are deterministic,
//     and K3 and K6, which differ only in their fill, agree bit for bit.

#pragma once

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace dirt {

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

template <int G>
struct GradSumsN {
  float gx[3], gy[3], gw[3];
  float gc[3][G];
};

template <int G>
__device__ __forceinline__ void clear_sums(GradSumsN<G>& s) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.gx[k] = 0.0f;
    s.gy[k] = 0.0f;
    s.gw[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < G; ++c) s.gc[k][c] = 0.0f;
  }
}

// Adds pixel p of `tile` (plane i at tile[i * stride + p]) to the face's
// sums: the position terms when do_pos, colour channels c0 .. c0 + nc - 1
// when want_col.
template <int G>
__device__ __forceinline__ void add_pixel(const float* tile, int stride,
                                          int p, const GradFace& f,
                                          const GradLayout& L, bool do_pos,
                                          bool want_col, int c0, int nc,
                                          GradSumsN<G>& s) {
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
      for (int c = 0; c < G; ++c) {
        if (c < nc) s.gc[k][c] += bp * tile[(L.grad + c0 + c) * stride + p];
      }
    }
  }
}

// Writes one pass's sums into the face's output row [3, d_corner]: per
// corner (gx, gy, gw) when do_pos, then the colour channels of the pass.
template <int G>
__device__ __forceinline__ void write_sums(float* dst, int d_corner,
                                           bool do_pos, int col_base, int c0,
                                           int nc, const GradSumsN<G>& s) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float* d = dst + k * d_corner;
    if (do_pos) {
      d[0] = s.gx[k];
      d[1] = s.gy[k];
      d[2] = -s.gw[k];
    }
#pragma unroll
    for (int c = 0; c < G; ++c) {
      if (c < nc) d[col_base + c0 + c] = s.gc[k][c];
    }
  }
}

// Sums every lane's partial sums over the warp by a butterfly (xor 16, 8,
// 4, 2, 1): lanes i and i ^ m add the same two values, so every lane ends
// with the same bits, in the same order in every call.  All 32 lanes must
// call it.
template <int G>
__device__ __forceinline__ void warp_sum(GradSumsN<G>& s) {
  auto add = [](float& v) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  };
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    add(s.gx[k]);
    add(s.gy[k]);
    add(s.gw[k]);
#pragma unroll
    for (int c = 0; c < G; ++c) add(s.gc[k][c]);
  }
}

// --------------------------------------------------------------------------
// The face-major run walk (K3, K6)
// --------------------------------------------------------------------------

// The launch shape grad_blocks.reduce_shape computes, with the dynamic
// shared memory it sizes: the ring (depth slots of `slot` floats; the lane
// combine reuses it), then the visit list (kVisitList ints), then kScratch
// ints.  grad_blocks.VISIT_LIST and _SCRATCH mirror the two constants.
struct RunShape {
  int lanes;      // P pixel lanes per face, a power of two
  int depth;      // ring slots, 1 or 2
  int slot;       // floats per ring slot (the staged planes, rounded to 4)
  int region;     // floats of the ring / combine region, a multiple of 4
  int staged;     // floats staged per visit (the planes the layout reads)
  int vec16;      // stage with 16-byte copies (else 4-byte)
};

constexpr int kVisitList = 1024;   // visit ids: at least a block's threads
constexpr int kScratch = 64;       // ints: per-warp counts, total, lo, hi

// Every thread issues its share of one visit's copies as one group.
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           const RunShape& rs) {
  if (rs.vec16) {
    for (int j = threadIdx.x * 4; j < rs.staged; j += blockDim.x * 4) {
      cp_async16(dst + j, src + j);
    }
  } else {
    for (int j = threadIdx.x; j < rs.staged; j += blockDim.x) {
      cp_async4(dst + j, src + j);
    }
  }
  cp_async_commit();
}

// Adds the n visits of `list` (tile ids into planes, `stack` floats
// apart) to the thread's sums, through the ring.  Every thread calls it
// with the same n; it ends with a barrier, so the list and the ring may
// be rewritten after it.
template <int G>
__device__ __forceinline__ void walk_visits(
    const float* planes, long long stack, const int* list, int n,
    float* ring, const RunShape& rs, int q, int pix, const GradFace& face,
    const GradLayout& layout, bool do_pos, bool want_col, int c0, int nc,
    GradSumsN<G>& sums) {
  if (n == 0) return;
  stage_tile(ring, planes + list[0] * stack, rs);
  for (int i = 0; i < n; ++i) {
    cp_async_wait_all();
    // Visit i has landed, and every thread is done with visit i - 1's
    // slot, into which visit i + 1 now goes.
    __syncthreads();
    const float* tile = ring + (i & (rs.depth - 1)) * rs.slot;
    if (rs.depth == 2 && i + 1 < n) {
      stage_tile(ring + ((i + 1) & 1) * rs.slot,
                 planes + list[i + 1] * stack, rs);
    }
    for (int p = q; p < pix; p += rs.lanes) {
      add_pixel(tile, pix, p, face, layout, do_pos, want_col, c0, nc, sums);
    }
    if (rs.depth == 1) {
      __syncthreads();
      if (i + 1 < n) stage_tile(ring, planes + list[i + 1] * stack, rs);
    }
  }
  __syncthreads();
}

// Adds lane q + h's partial sums into lane q's for h = P/2, P/4, .., 1
// through `buf` ([P/2, 9 + 3G, chunk] floats), so lane 0 ends with the
// face's row, in the same order for every block.
template <int G>
__device__ __forceinline__ void combine_lanes(GradSumsN<G>& s, float* buf,
                                              int q, int f, int chunk,
                                              int lanes) {
  constexpr int kRow = 9 + 3 * G;
  for (int h = lanes >> 1; h >= 1; h >>= 1) {
    if (q >= h && q < 2 * h) {
      float* b = buf + (q - h) * kRow * chunk + f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        b[(3 * k + 0) * chunk] = s.gx[k];
        b[(3 * k + 1) * chunk] = s.gy[k];
        b[(3 * k + 2) * chunk] = s.gw[k];
#pragma unroll
        for (int c = 0; c < G; ++c) b[(9 + k * G + c) * chunk] = s.gc[k][c];
      }
    }
    __syncthreads();
    if (q < h) {
      const float* b = buf + q * kRow * chunk + f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s.gx[k] += b[(3 * k + 0) * chunk];
        s.gy[k] += b[(3 * k + 1) * chunk];
        s.gw[k] += b[(3 * k + 2) * chunk];
#pragma unroll
        for (int c = 0; c < G; ++c) s.gc[k][c] += b[(9 + k * G + c) * chunk];
      }
    }
    __syncthreads();
  }
}

// Reduces the block's face rows over one run; thread (q, f) =
// (threadIdx.x / chunk, threadIdx.x % chunk).  `fill` supplies the run's
// live tile ids: fill.reset() rewinds it, fill.next(list) writes the next
// piece (at most kVisitList ids, ending with a barrier) and returns its
// length, fill.done() says whether the run is exhausted; all three are
// block-uniform.  Colour passes of G channels (the first also takes the
// position terms) each fill and walk the visits in order.  Face f's row
// [3, d_out / 3] is written to out[f * d_out ..]: zeros when no visit is
// live.  Every thread of the block must call it.
template <int G, typename Fill>
__device__ __forceinline__ void reduce_run(
    Fill& fill, const float* planes, long long stack, int pix, int chunk,
    const RunShape& rs, float* smem, const GradFace& face,
    const GradLayout& layout, bool want_pos, int channels, int d_out,
    float* out) {
  float* ring = smem;
  int* list = reinterpret_cast<int*>(smem + rs.region);
  const int f = threadIdx.x % chunk;
  const int q = threadIdx.x / chunk;
  const bool want_col = layout.fp >= 0;
  const int d_corner = d_out / 3;
  const int col_base = want_pos ? 3 : 0;
  const int passes = want_col ? (channels + G - 1) / G : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const bool do_pos = want_pos && pass == 0;
    const int c0 = pass * G;
    const int nc = want_col ? min(G, channels - c0) : 0;
    GradSumsN<G> sums;
    clear_sums(sums);
    fill.reset();
    do {
      const int n = fill.next(list);
      walk_visits(planes, stack, list, n, ring, rs, q, pix, face, layout,
                  do_pos, want_col, c0, nc, sums);
    } while (!fill.done());
    combine_lanes(sums, ring, q, f, chunk, rs.lanes);
    if (q == 0) {
      write_sums(out + (long long)f * d_out, d_corner, do_pos, col_base, c0,
                 nc, sums);
    }
  }
}

}  // namespace dirt
