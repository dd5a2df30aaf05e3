// The per-face arithmetic of the forward sweeps, shared by K1 raster_sweep
// (raster_sweep.cu), K7 dense_sweep (dense_sweep.cu) and K8 pallas_raster
// (pallas_raster.cu) so they cannot drift: one thread tests one face-table
// row against its pixel centre and keeps the lexicographic (depth, original
// face index) winner; K1 and K7 then write the packed per-pixel state of
// forward_dense, K8 shades the winner itself.
//
// The arithmetic is forward_dense._chunk_candidates' expression tree for
// one row: edge functions, the COVER_FAST fill rule with the
// |s_z| <= |s_w| clip (a NaN s_w of an invalid row passes != 0 and fails
// the magnitude test), depth s_z / s_w.  The lexicographic minimum is
// associative, so testing faces one by one picks the same winner as the
// TPU's chunk minimum followed by merge_state, and the winner's values are
// the same expressions, so they agree bit for bit when the sources are
// built with -fmad=false and IEEE division (never --use_fast_math).

#pragma once

#include <cuda_runtime.h>

namespace dirt {

constexpr int kBase = 27;   // forward_pallas._BASE

// A pixel's running winner; starts at glClearDepth's (1.0, -1).
struct Winner {
  float depth = 1.0f;
  float orig = -1.0f;
  float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f, sw = 0.0f;
  long long row = -1;       // the winner's face-table row
};

// Tests face-table row `f` (number `row` of the table) at pixel centre
// (xg, yg) and makes it the winner if it covers the pixel nearer, or as
// near with a smaller original index.
__device__ __forceinline__ void test_face(const float* f, float xg, float yg,
                                          long long row, Winner& w) {
  const float e0 = (f[0] * xg + f[1] * yg) + f[2];
  const float e1 = (f[3] * xg + f[4] * yg) + f[5];
  const float e2 = (f[6] * xg + f[7] * yg) + f[8];
  const float s_z = (e0 * f[9] + e1 * f[10]) + e2 * f[11];
  const float s_w = (e0 * f[12] + e1 * f[13]) + e2 * f[14];
  const bool sp = s_w > 0.0f;
  const bool d0 = ((e0 > 0.0f) || ((e0 == 0.0f) && (f[15] != 0.0f))) == sp;
  const bool d1 = ((e1 > 0.0f) || ((e1 == 0.0f) && (f[16] != 0.0f))) == sp;
  const bool d2 = ((e2 > 0.0f) || ((e2 == 0.0f) && (f[17] != 0.0f))) == sp;
  const bool covered = d0 && d1 && d2 && (s_w != 0.0f) &&
                       (fabsf(s_z) <= fabsf(s_w));
  if (!covered) return;
  const float depth = s_z / s_w;
  const float orig = f[19];
  if (depth < w.depth || (depth == w.depth && orig < w.orig)) {
    w.depth = depth;
    w.orig = orig;
    w.e0 = e0;
    w.e1 = e1;
    w.e2 = e2;
    w.sw = s_w;
    w.row = row;
  }
}

// Stages face block `bid` (chunk x width_d floats of `table`) in shared
// memory `rows` and tests its rows in order at (xg, yg).  Every thread of
// the block must call it (it synchronises); used by K1 raster_sweep and
// K5b slot_sweep, which walk the same blocks in the same order.
__device__ __forceinline__ void sweep_block(const float* table, long long bid,
                                            int chunk, int width_d,
                                            float* rows, float xg, float yg,
                                            Winner& w) {
  const int block_floats = chunk * width_d;
  __syncthreads();
  const float* src = table + bid * block_floats;
  for (int j = threadIdx.x; j < block_floats; j += blockDim.x) {
    rows[j] = src[j];
  }
  __syncthreads();
  for (int k = 0; k < chunk; ++k) {
    test_face(rows + k * width_d, xg, yg, bid * chunk + k, w);
  }
}

// Walks one tile's face list: the n table rows ids[0 .. n), staged by
// index into shared memory `rows` (chunk x width_d floats) `chunk` rows at
// a time, each tested in list order at (xg, yg).  Every thread of the
// block must call it (it synchronises); used by K7 dense_sweep and K8
// pallas_raster, which walk the same per-tile lists.
__device__ __forceinline__ void sweep_list(const float* table, const int* ids,
                                           int n, int chunk, int width_d,
                                           float* rows, float xg, float yg,
                                           Winner& w) {
  for (int i0 = 0; i0 < n; i0 += chunk) {
    const int k_end = min(chunk, n - i0);
    __syncthreads();
    for (int j = threadIdx.x; j < k_end * width_d; j += blockDim.x) {
      const int k = j / width_d;
      rows[j] = table[(long long)ids[i0 + k] * width_d + (j - k * width_d)];
    }
    __syncthreads();
    for (int k = 0; k < k_end; ++k) {
      test_face(rows + k * width_d, xg, yg, ids[i0 + k], w);
    }
  }
}

// Writes the packed state [C+9] of one pixel (stride `pix` between rows):
// the winner's interpolation numerators ((E0*a0 + E1*a1) + E2*a2, read
// from its table row, so finalize's single division keeps constant
// attributes exact), E0..E2, S_w, vertex ids, depth and original index;
// zeros and (1.0, -1) for the background.
__device__ __forceinline__ void write_state(const float* table, int width_d,
                                            int channels, const Winner& w,
                                            float* out, int pix) {
  if (w.row >= 0) {
    const float* f = table + w.row * width_d;
    for (int ch = 0; ch < channels; ++ch) {
      out[ch * pix] = (w.e0 * f[kBase + ch] + w.e1 * f[kBase + channels + ch])
                      + w.e2 * f[kBase + 2 * channels + ch];
    }
    out[(channels + 0) * pix] = w.e0;
    out[(channels + 1) * pix] = w.e1;
    out[(channels + 2) * pix] = w.e2;
    out[(channels + 3) * pix] = w.sw;
    out[(channels + 4) * pix] = f[24];
    out[(channels + 5) * pix] = f[25];
    out[(channels + 6) * pix] = f[26];
  } else {
    for (int k = 0; k < channels + 7; ++k) out[k * pix] = 0.0f;
  }
  out[(channels + 7) * pix] = w.depth;
  out[(channels + 8) * pix] = w.orig;
}

}  // namespace dirt
