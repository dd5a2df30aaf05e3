// K8: pallas_raster -- the "pallas" backend's fused forward: visibility over
// exact per-tile face lists, then shading in the same kernel.
//
// Replaces dirt_tpu/ops/forward_pallas.py:_raster_kernel (phase 1: the
// z-buffered visibility sweep over a tile's exact face list; phase 2: the
// face-major shading pass that writes pixels and the 8 aux planes).  The
// TPU walks the list twice, once per phase, because its vector unit shades
// a whole tile per face; on the GPU each pixel has its own thread, so phase
// 2 is one evaluation per pixel of its own winner, with no face loop.
//
// Work: one thread block per (image, tile) of tile_h x tile_w pixels; the
// lists are forward_pallas._pack_faces' (via forward_dense.pack), the same
// as K7's.  Phase 1 is sweep_math.cuh's run walk, sweep_run, as K1's: the
// tile's list (face_ids[bt, 0 .. counts[bt]), rows of the face table)
// copied into shared memory in pieces of shape.list ids (slots.cuh's
// CsrFill), each piece's rows staged by cp.async (their first 24 columns,
// all at once or through two halves), the list dealt to S face groups of
// one thread a pixel (entry v of a staged batch to group v mod S), a face
// tested only where its pixel bbox (columns 20-23) holds the pixel, with
// the COVER_FAST form of the coverage tree (dirt_tpu pins it bitwise to the
// literal tree of _raster_kernel that the plain version evaluates: invalid
// rows carry NaN z/w and an empty bbox), and the groups' lexicographic
// (depth, original index) winners combined in group order.  Phase 2, the
// epilogue (ShadeEpilogue): group 0's thread of a pixel inside the image
// with a winner reads the winner's row once from global memory and writes
//   pixels_c = ((E0 a0_c + E1 a1_c) + E2 a2_c) / d,   d = (E0 + E1) + E2
//   (1 where that is 0), barycentrics E_k / d, clip w S_w / d,
//   vertex ids and original index (the row's floats, as int32);
// a pixel with none writes the background and the aux clears (-1, +inf),
// and a tile without a listed face writes them with every thread and
// retires.  These are forward_dense.finalize's expressions, so the outputs
// equal the blocks (K1) and dense (K7) backends' bit for bit.  Pixels of
// the padded tile grid past the image edge take part in the sweep (their
// cull clamps them to the image, as the bbox is) and write nothing: the
// outputs are [B, H, W, ...], not padded.
//
// What bounds it on the H100: the bytes bound is the outputs (pixels, face
// index, vertex ids, barycentrics, clip w: C + 8 words a pixel) and the
// background read, 0.018 ms at the bench.  But the work sits in few tiles
// (96 of 4,096 at the bench, 301 faces in the busiest list, 3,728 on the
// 8,192-face scene), so the time is the empty tiles' writes plus the
// busiest list's chain of face tests on its SM, which one thread a pixel
// walking every face, 64 rows gathered by index and two barriers at a
// time, made 0.13 ms long (NVIDIA H100 80GB HBM3, 700 W; PERF.md).  On the
// run walk two face groups halve the chain, the bbox cull turns most tests
// into four compares, staging takes one barrier a piece, and the launch
// bound (K1's) keeps empty tiles in flight.  The shape is
// forward_blocks.sweep_shape at one face a visit.
//
// Built with -fmad=false and IEEE division, so every output equals the plain
// version's (forward_pallas.pallas_raster_plain) bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "slots.cuh"
#include "sweep_math.cuh"

namespace {

// K8's outputs for the tile whose first pixel is (row0, col0) of image b:
// the shaded winner, or the background and the aux clears; nothing for a
// pixel past the image edge.
struct ShadeEpilogue {
  const float* table;        // [B*F', width_d]
  const float* bg;           // [B, H, W, C], the background
  float* pixels;             // [B, H, W, C]
  int* face_index;           // [B, H, W]
  int* indices;              // [B, H, W, 3]
  float* bary;               // [B, H, W, 3]
  float* clip_w;             // [B, H, W]
  long long b;
  int width_d, channels, height, width, row0, col0, tile_w, pix;

  __device__ void clear(long long q) const {
    for (int ch = 0; ch < channels; ++ch) {
      pixels[q * channels + ch] = bg[q * channels + ch];
    }
    for (int k = 0; k < 3; ++k) {
      bary[q * 3 + k] = -1.0f;
      indices[q * 3 + k] = -1;
    }
    clip_w[q] = INFINITY;
    face_index[q] = -1;
  }

  // Every thread of the block: the tile has no listed face.
  __device__ void background() const {
    for (int p = threadIdx.x; p < pix; p += blockDim.x) {
      const int row = row0 + p / tile_w;
      const int col = col0 + p % tile_w;
      if (row < height && col < width) {
        clear((b * height + row) * width + col);
      }
    }
  }

  // Group 0's thread of pixel (row, col).
  __device__ void winner(const dirt::Winner& w, int p, int row,
                         int col) const {
    if (row >= height || col >= width) return;
    const long long q = (b * height + row) * width + col;
    if (w.row < 0) {
      clear(q);
      return;
    }
    const float* f = table + w.row * width_d;
    const float s_e = (w.e0 + w.e1) + w.e2;
    const float d = s_e == 0.0f ? 1.0f : s_e;
    for (int ch = 0; ch < channels; ++ch) {
      const float num =
          (w.e0 * f[dirt::kBase + ch] + w.e1 * f[dirt::kBase + channels + ch]) +
          w.e2 * f[dirt::kBase + 2 * channels + ch];
      pixels[q * channels + ch] = num / d;
    }
    bary[q * 3 + 0] = w.e0 / d;
    bary[q * 3 + 1] = w.e1 / d;
    bary[q * 3 + 2] = w.e2 / d;
    clip_w[q] = w.sw / d;
    indices[q * 3 + 0] = (int)f[24];
    indices[q * 3 + 1] = (int)f[25];
    indices[q * 3 + 2] = (int)f[26];
    face_index[q] = (int)w.orig;
  }
};

// kMaxThreads / kMinBlocks: the launch bound, as K1's.
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    pallas_raster_kernel(
        const float* __restrict__ table,       // [B*F', width_d]
        const int* __restrict__ face_ids,      // [B*T, slots], table rows
        const int* __restrict__ counts,        // [B*T]
        const float* __restrict__ background,  // [B, H, W, C]
        float* __restrict__ pixels, int* __restrict__ face_index,
        int* __restrict__ indices, float* __restrict__ bary,
        float* __restrict__ clip_w, int slots, int num_tiles, int tiles_x,
        int tile_h, int tile_w, int width_d, int channels, int height,
        int width, float sx, float sy, dirt::SweepShape shape) {
  extern __shared__ __align__(16) float smem[];
  const int bt = blockIdx.x;
  const int tile = bt % num_tiles;
  const int pix = tile_h * tile_w;
  const int row0 = (tile / tiles_x) * tile_h;
  const int col0 = (tile % tiles_x) * tile_w;
  const ShadeEpilogue out{table, background, pixels, face_index, indices,
                          bary, clip_w, bt / num_tiles, width_d, channels,
                          height, width, row0, col0, tile_w, pix};
  dirt::CsrFill fill{face_ids + (long long)bt * slots, counts[bt], shape.list,
                     0};
  dirt::sweep_run(fill, dirt::StagedFaces<true>{table, 1, width_d}, out,
                  shape, smem, row0, col0, tile_w, pix, height, width, sx,
                  sy);
}

}  // namespace

extern "C" int dirt_pallas_raster(
    const float* table, const int* face_ids, const int* counts,
    const float* background, float* pixels, int* face_index, int* indices,
    float* bary, float* clip_w, int runs, int slots, int num_tiles,
    int tiles_x, int tile_h, int tile_w, int width_d, int channels,
    int height, int width, float sx, float sy, int groups, int cap,
    int region, int list, int vec16, int smem, cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const dirt::SweepShape shape{groups, cap, region, list, vec16};
  const int threads = groups * tile_h * tile_w;
  auto kernel = threads <= dirt::kSweepThreads
                    ? pallas_raster_kernel<dirt::kSweepThreads,
                                           dirt::kSweepBlocks>
                    : pallas_raster_kernel<1024, 1>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  kernel<<<runs, threads, smem, stream>>>(
      table, face_ids, counts, background, pixels, face_index, indices, bary,
      clip_w, slots, num_tiles, tiles_x, tile_h, tile_w, width_d, channels,
      height, width, sx, sy, shape);
  return (int)cudaGetLastError();
}
