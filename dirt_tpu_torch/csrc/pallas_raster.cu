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
// Work: one thread block per (image, tile) of tile_h x tile_w pixels, one
// thread per pixel (at most 1024); the lists are forward_pallas._pack_faces'
// (via forward_dense.pack), the same as K7's.  Phase 1 is sweep_math.cuh's
// sweep_list: the tile's listed hits, staged by index into shared memory
// `chunk` rows at a time, each tested with the COVER_FAST form of the
// coverage tree (dirt_tpu pins it bitwise to the literal tree of
// _raster_kernel that the plain version evaluates: invalid rows carry NaN
// z/w and die on the |s_z| <= |s_w| clip), keeping the lexicographic
// (depth, original index) winner with its E0..E2, S_w and table row in
// registers.  Phase 2: a pixel inside the image with a winner reads the
// winner's row once from global memory and writes
//   pixels_c = ((E0 a0_c + E1 a1_c) + E2 a2_c) / d,   d = (E0 + E1) + E2
//   (1 where that is 0), barycentrics E_k / d, clip w S_w / d,
//   vertex ids and original index (the row's floats, as int32);
// a pixel with none writes the background and the aux clears (-1, +inf).
// These are forward_dense.finalize's expressions, so the outputs equal the
// blocks (K1) and dense (K7) backends' bit for bit.  Pixels of the padded
// tile grid past the image edge take part in the sweep (they synchronise)
// and write nothing: the outputs are [B, H, W, ...], not padded.
//
// What bounds it on the H100: the per-(pixel, listed face) arithmetic, as in
// K7 (~22 flops and 18 broadcast shared loads per test).  Device memory
// traffic is the face table (once per tile through L2), the lists, the
// background and the outputs -- (C + 9) floats per pixel, 15 MB at the bench
// size, against the 50 MB state that K7 writes and finalize reads again.
//
// Built with -fmad=false and IEEE division, so every output equals the plain
// version's (forward_pallas.pallas_raster_plain) bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "sweep_math.cuh"

namespace {

__global__ void pallas_raster_kernel(
    const float* __restrict__ table,       // [B*F', width_d]
    const int* __restrict__ face_ids,      // [B*T, slots], batch-folded rows
    const int* __restrict__ counts,        // [B*T]
    const float* __restrict__ background,  // [B, H, W, C]
    float* __restrict__ pixels,            // [B, H, W, C]
    int* __restrict__ face_index,          // [B, H, W]
    int* __restrict__ indices,             // [B, H, W, 3]
    float* __restrict__ bary,              // [B, H, W, 3]
    float* __restrict__ clip_w,            // [B, H, W]
    int slots, int num_tiles, int tiles_x, int tile_h, int tile_w, int chunk,
    int width_d, int channels, int height, int width, float sx, float sy) {
  extern __shared__ float rows[];          // [chunk, width_d]
  const int bt = blockIdx.x;
  const long long b = bt / num_tiles;
  const int tile = bt % num_tiles;
  const int p = threadIdx.x;
  const int r = p / tile_w;
  const int c = p - r * tile_w;
  const int row = (tile / tiles_x) * tile_h + r;
  const int col = (tile % tiles_x) * tile_w + c;
  // forward_dense.pixel_ndc: ((col + 0.5) * (2/W) - 1, 1 - (row + 0.5) * (2/H)).
  const float xg = ((float)col + 0.5f) * sx - 1.0f;
  const float yg = 1.0f - ((float)row + 0.5f) * sy;

  // Phase 1: visibility.
  dirt::Winner w;
  dirt::sweep_list(table, face_ids + (long long)bt * slots, counts[bt], chunk,
                   width_d, rows, xg, yg, w);

  // Phase 2: shading of this pixel's winner.
  if (row >= height || col >= width) return;
  const long long q = (b * height + row) * width + col;
  if (w.row >= 0) {
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
  } else {
    for (int ch = 0; ch < channels; ++ch) {
      pixels[q * channels + ch] = background[q * channels + ch];
    }
    for (int k = 0; k < 3; ++k) {
      bary[q * 3 + k] = -1.0f;
      indices[q * 3 + k] = -1;
    }
    clip_w[q] = INFINITY;
    face_index[q] = -1;
  }
}

}  // namespace

extern "C" int dirt_pallas_raster(
    const float* table, const int* face_ids, const int* counts,
    const float* background, float* pixels, int* face_index, int* indices,
    float* bary, float* clip_w, int runs, int slots, int num_tiles,
    int tiles_x, int tile_h, int tile_w, int chunk, int width_d, int channels,
    int height, int width, float sx, float sy, cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)chunk * width_d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(pallas_raster_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  pallas_raster_kernel<<<runs, tile_h * tile_w, smem, stream>>>(
      table, face_ids, counts, background, pixels, face_index, indices, bary,
      clip_w, slots, num_tiles, tiles_x, tile_h, tile_w, chunk, width_d,
      channels, height, width, sx, sy);
  return (int)cudaGetLastError();
}
