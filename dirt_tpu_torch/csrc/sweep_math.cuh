// The per-face arithmetic and the run walk of the forward sweeps, shared
// by K1 raster_sweep (raster_sweep.cu), K5b slot_sweep (slot_sweep.cu), K5
// resident_sweep (resident_sweep.cu), K7 dense_sweep (dense_sweep.cu) and
// K8 pallas_raster (pallas_raster.cu) so they cannot drift: a thread tests
// a face-table row against its pixel centre and keeps the lexicographic
// (depth, original face index) winner; all but K8 then write the packed
// per-pixel state of forward_dense, K8 shades the winner itself.  All five
// walk their runs (face blocks of a CSR run or a slot list, or a tile's
// face list) with sweep_run, below.
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

#include "async_copy.cuh"

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

// --------------------------------------------------------------------------
// The run walk of K1 raster_sweep, K5b slot_sweep, K5 resident_sweep, K7
// dense_sweep and K8 pallas_raster
// --------------------------------------------------------------------------
//
// sweep_run is the H100 form of dirt_tpu/ops/forward_blocks.py's CSR and
// slot sweeps, of its resident-table sweep and of forward_dense.py's and
// forward_pallas.py's list sweeps.  On the TPU a grid step swept a whole tile on the vector unit
// and the time followed the total work; here one block owns a run (a
// tile), and at the bench 96 of 4,096 runs carry every visit, so the
// busiest run's dependent chain of face tests sets the time and the empty
// runs only write their outputs.  A run's visits are face blocks of
// `chunk` table rows (K1, K5b, K5) or single rows (K7 and K8: a tile's
// face list, `chunk` 1); its faces come staged from the table
// (StagedFaces) or in place from a table resident in shared memory (K5's
// ResidentFaces); its outputs are the packed state (StateEpilogue: K1,
// K5b, K5, K7) or K8's shaded pixels.
// The walk answers:
//   * The visit list in shared memory: the caller's fill writes the run's
//     visits (batch-folded face blocks) there before any face test (in
//     pieces of at most `list` ids), so staging never waits on a dependent
//     global load.
//   * Staging without a barrier a visit: every visit's face rows -- only
//     their first kFaceFloats columns, 96 bytes a face -- come in
//     by cp.async (16 bytes a copy where the rows are 16-byte aligned,
//     else 4), all of the piece at once where they fit the staging area
//     (one wait and one barrier), else through two halves of it, each
//     refilled while the other is tested (two barriers a half).
//   * A busy run's faces over S x pix threads: S face groups of one
//     thread a pixel, group g testing faces g, g + S, g + 2S, ... of every
//     visit (of a piece's list where a visit is one face), each face
//     loaded into registers by 16-byte shared loads.  So a thread's chain
//     is 1/S of the run's faces.  (Two pixels a thread, sharing each
//     face's loads, ran the busiest run faster but cost K5b the blocks an
//     SM holds: PERF.md.)
//   * A bbox cull: a face is tested only at the pixels its conservative
//     pixel bbox (table columns 20-23, loaded first) holds, the premise
//     the block hit test and the dense lists already rest on; a warp
//     skips the face where none of its pixels is inside.  Of the 448
//     faces the bench's busiest run visits, a warp's pixels meet 120 on
//     average, so most faces cost one load and four compares.
//   * A fixed-order combine: groups 1 .. S-1 leave their winners in shared
//     memory (the staging area's space), group 0 takes them in group
//     order by the same lexicographic (depth, original index) test and
//     writes the state.  Among covered fragments of one image that order
//     is total (the original index is unique), so every partition and
//     every combine order picks the winner one thread walking the faces
//     in order picks; the cull drops only faces whose bbox misses the
//     pixel, never its winner; and the winner's E0..E2 and S_w are
//     test_face's: the outputs are equal bit for bit.
//   * A run without a visit writes the background with every thread of
//     the block and retires.

constexpr int kFaceFloats = 24;      // test_face's columns, then the bbox
// The launch shape, chosen by trials at the bench (PERF.md): the
// most S, a block's threads at most, and the blocks an SM must hold (the
// launch bound's 40 registers a thread); forward_blocks.SWEEP_GROUPS,
// SWEEP_THREADS and SWEEP_BLOCKS mirror them.
constexpr int kSweepGroups = 2;
constexpr int kSweepThreads = 512;
constexpr int kSweepBlocks = 3;
constexpr int kSweepScratch = 64;    // ints after the list (_SWEEP_SCRATCH)

// The launch shape forward_blocks.sweep_shape computes, with the dynamic
// shared memory it sizes: the staging area (region floats; the combine
// reuses it), the visit list (list ints), then kSweepScratch ints.
struct SweepShape {
  int groups;   // S face groups of pix threads each
  int cap;      // visits the staging area holds (at least 2)
  int region;   // floats of the staging area, a multiple of 4
  int list;     // ints of the visit list, at least the block's threads
  int vec16;    // stage with 16-byte copies
};

// The background state [C+9, pix] of a tile: zeros, then depth 1.0 and
// index -1; written by every thread of the block.
__device__ __forceinline__ void write_background(float* out, int channels,
                                                 int pix) {
  const int ns = channels + 9;
  if ((pix & 3) == 0) {
    const int quads = pix >> 2;
    for (int j = threadIdx.x; j < ns * quads; j += blockDim.x) {
      const int k = j / quads;
      const float v = k < channels + 7 ? 0.0f
                                       : (k == channels + 7 ? 1.0f : -1.0f);
      reinterpret_cast<float4*>(out)[j] = make_float4(v, v, v, v);
    }
  } else {
    for (int j = threadIdx.x; j < ns * pix; j += blockDim.x) {
      const int k = j / pix;
      out[j] = k < channels + 7 ? 0.0f : (k == channels + 7 ? 1.0f : -1.0f);
    }
  }
}

// Stages the kFaceFloats leading columns of the face rows of visits
// [v0, v1) of `list`, face after face, at dst; the thread's copies form
// one commit group (empty when v0 == v1).
__device__ __forceinline__ void stage_visits(float* dst, const float* table,
                                             const int* list, int v0, int v1,
                                             int chunk, int width_d,
                                             bool vec16) {
  const int faces = (v1 - v0) * chunk;
  if (vec16) {
    constexpr int kQuads = kFaceFloats / 4;
    for (int j = threadIdx.x; j < faces * kQuads; j += blockDim.x) {
      const int face = j / kQuads;
      const int v = face / chunk;
      const long long row =
          (long long)list[v0 + v] * chunk + (face - v * chunk);
      const int c = (j - face * kQuads) * 4;
      cp_async16(dst + face * kFaceFloats + c, table + row * width_d + c);
    }
  } else {
    for (int j = threadIdx.x; j < faces * kFaceFloats; j += blockDim.x) {
      const int face = j / kFaceFloats;
      const int v = face / chunk;
      const long long row =
          (long long)list[v0 + v] * chunk + (face - v * chunk);
      cp_async4(dst + j, table + row * width_d + (j - face * kFaceFloats));
    }
  }
  cp_async_commit();
}

// The thread's pixel: its centre (xg, yg) in NDC, and the row and column
// the bbox cull compares, clamped to the image (a face's bbox is, so a
// pixel past the edge meets the bbox of every face that can cover it).
struct Pixel {
  float xg, yg, row, col;
};

// The Pixel of image row `row`, column `col` of a height x width image;
// forward_dense.pixel_ndc: ((col + 0.5) * (2/W) - 1, 1 - (row + 0.5) *
// (2/H)), sx = 2/W and sy = 2/H.
__device__ __forceinline__ Pixel pixel_at(int row, int col, int height,
                                          int width, float sx, float sy) {
  return Pixel{((float)col + 0.5f) * sx - 1.0f,
               1.0f - ((float)row + 0.5f) * sy,
               (float)min(row, height - 1), (float)min(col, width - 1)};
}

// Tests the staged face at `face` (row number `row` of the table) at the
// thread's pixel if its pixel bbox holds the pixel; the face's other
// columns are loaded only then.
__device__ __forceinline__ void test_staged(const float* face, long long row,
                                            const Pixel& px, Winner& w) {
  const float4* src = reinterpret_cast<const float4*>(face);
  const float4 box = src[kFaceFloats / 4 - 1];   // r0, r1, c0, c1
  if (!(box.x <= px.row && px.row <= box.y && box.z <= px.col &&
        px.col <= box.w)) {
    return;
  }
  float f[kFaceFloats - 4];
#pragma unroll
  for (int q = 0; q < kFaceFloats / 4 - 1; ++q) {
    const float4 v = src[q];
    f[4 * q + 0] = v.x;
    f[4 * q + 1] = v.y;
    f[4 * q + 2] = v.z;
    f[4 * q + 3] = v.w;
  }
  test_face(f, px.xg, px.yg, row, w);
}

// Tests group g's faces of the n visits of `list` at the thread's pixel,
// staged through `stage`: face k of a visit of `chunk` rows goes to group
// k mod S, or, kOneFace (chunk 1, a face list), visit v of a staged batch
// to group v mod S.  Every thread calls it with the same n; it ends with a
// barrier, so the list and the staging area may be rewritten after it.
template <bool kOneFace>
__device__ __forceinline__ void sweep_visits(
    const float* table, const int* list, int n, int chunk, int width_d,
    float* stage, const SweepShape& ss, int g, const Pixel& px, Winner& w) {
  if (n == 0) return;
  const int per = chunk * kFaceFloats;
  const bool ring = n > ss.cap;
  const int batch = ring ? ss.cap / 2 : n;
  stage_visits(stage, table, list, 0, batch, chunk, width_d, ss.vec16);
  if (ring) {
    stage_visits(stage + batch * per, table, list, batch, 2 * batch, chunk,
                 width_d, ss.vec16);
  }
  int half = 0;
  for (int b0 = 0; b0 < n; b0 += batch) {
    // This batch has landed (the other half may still be in flight).
    if (ring) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* rows = stage + half * batch * per;
    const int m = min(batch, n - b0);
    if (kOneFace) {
      for (int v = g; v < m; v += ss.groups) {
        test_staged(rows + v * kFaceFloats, list[b0 + v], px, w);
      }
    } else {
      for (int v = 0; v < m; ++v) {
        const long long base = (long long)list[b0 + v] * chunk;
        const float* vr = rows + v * per;
        for (int k = g; k < chunk; k += ss.groups) {
          test_staged(vr + k * kFaceFloats, base + k, px, w);
        }
      }
    }
    if (ring) {
      // Every thread is done with this half: batch b0 + 2 * batch goes in.
      __syncthreads();
      const int v0 = min(b0 + 2 * batch, n);
      stage_visits(stage + half * batch * per, table, list, v0,
                   min(v0 + batch, n), chunk, width_d, ss.vec16);
      half ^= 1;
    }
  }
  __syncthreads();
}

// Groups 1 .. S-1 leave their winners (7 words a pixel) in `buf`; group 0
// takes them into its own in group order.  Ends with group 0 holding the
// tile's winners.
__device__ __forceinline__ void combine_groups(Winner& w, float* buf, int g,
                                               int p, int pix, int groups) {
  const int slots = (groups - 1) * pix;
  int* rows = reinterpret_cast<int*>(buf + 6 * slots);
  if (g > 0) {
    const int e = (g - 1) * pix + p;
    buf[e] = w.depth;
    buf[slots + e] = w.orig;
    buf[2 * slots + e] = w.e0;
    buf[3 * slots + e] = w.e1;
    buf[4 * slots + e] = w.e2;
    buf[5 * slots + e] = w.sw;
    rows[e] = (int)w.row;
  }
  __syncthreads();
  if (g > 0) return;
  for (int h = 1; h < groups; ++h) {
    const int e = (h - 1) * pix + p;
    const float depth = buf[e];
    const float orig = buf[slots + e];
    if (depth < w.depth || (depth == w.depth && orig < w.orig)) {
      w.depth = depth;
      w.orig = orig;
      w.e0 = buf[2 * slots + e];
      w.e1 = buf[3 * slots + e];
      w.e2 = buf[4 * slots + e];
      w.sw = buf[5 * slots + e];
      w.row = rows[e];
    }
  }
}

// A run's faces staged from the table a piece at a time (K1 and K5b:
// visits of `chunk` rows; K7 and K8: kOneFace, a list of single rows,
// chunk 1).
template <bool kOneFace>
struct StagedFaces {
  const float* table;
  int chunk;
  int width_d;

  // Tests group g's faces of the n visits of `list`; ends with a barrier.
  __device__ void sweep(const int* list, int n, float* stage,
                        const SweepShape& ss, int g, const Pixel& px,
                        Winner& w) const {
    sweep_visits<kOneFace>(table, list, n, chunk, width_d, stage, ss, g, px,
                           w);
  }
};

// The packed state [C+9, pix] of a run at `out` (K1, K5b, K5 and K7).
struct StateEpilogue {
  const float* table;
  int width_d;
  int channels;
  float* out;
  int pix;

  // Every thread of the block: the run has no visit.
  __device__ void background() const {
    write_background(out, channels, pix);
  }
  // Group 0's thread of pixel p (image row `row`, column `col`).
  __device__ void winner(const Winner& w, int p, int row, int col) const {
    write_state(table, width_d, channels, w, out + p, pix);
  }
};

// Sweeps one run, the tile whose first pixel is (row0, col0) of a height
// x width image.  `fill` supplies the run's visits: fill.reset() rewinds
// it, fill.next(list) writes the next piece (ending with a barrier) and
// returns its length, fill.done() says whether the run is exhausted; all
// three are block-uniform.  faces.sweep tests group g's faces of a piece
// (StagedFaces, or K5's resident table) and ends with a barrier; the
// groups' winners combine in `smem`'s first ss.region floats, which the
// staging shares.  `out` writes the outputs: out.background() with every
// thread where the run has no visit, else out.winner() with each of
// group 0's threads.  A block is ss.groups x pix threads, and every
// thread must call it.
template <typename Fill, typename Faces, typename Epilogue>
__device__ __forceinline__ void sweep_run(
    Fill& fill, const Faces& faces, const Epilogue& out, const SweepShape& ss,
    float* smem, int row0, int col0, int tile_w, int pix, int height,
    int width, float sx, float sy) {
  float* stage = smem;
  int* list = reinterpret_cast<int*>(smem + ss.region);
  fill.reset();
  int n = fill.next(list);
  if (n == 0 && fill.done()) {
    out.background();
    return;
  }
  const int g = threadIdx.x / pix;
  const int p = threadIdx.x - g * pix;
  const int row = row0 + p / tile_w;
  const int col = col0 + p % tile_w;
  const Pixel px = pixel_at(row, col, height, width, sx, sy);
  Winner w;
  for (;;) {
    faces.sweep(list, n, stage, ss, g, px, w);
    if (fill.done()) break;
    n = fill.next(list);
  }
  combine_groups(w, stage, g, p, pix, ss.groups);
  if (g == 0) out.winner(w, p, row, col);
}

}  // namespace dirt
