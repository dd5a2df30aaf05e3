// K4: hit_plane -- the per-image [T, F] keep plane of the CSR schedules.
//
// Replaces dirt_tpu/ops/forward_blocks.py:_hit_kernel (called through
// _hit_matrix_pallas), the TPU kernel that decides which (tile, face) pairs
// the forward sweep (dilate = 0) and the gradient reduction (dilate = 1)
// visit.
//
// A face is kept when its pixel bbox overlaps the tile and, with
// edge_col >= 0, the conservative half-plane cull cannot rule it out: each
// edge function is linear in NDC, so its extremes over the tile's (dilated)
// pixel-centre rectangle sit at corners; the tile is culled iff some edge
// is below -margin everywhere and some edge is above +margin everywhere,
// with margin = 2^-20 (|a|+|b|+|c|).  The expression tree is the TPU
// kernel's term for term (and the plain version's,
// forward_blocks.hit_plane_plain), so with -fmad=false the planes are
// bitwise equal; the schedule's correctness needs only that the cull is
// conservative, which the margin guarantees.
//
// Work: a block of kHitFaces threads takes one image, kHitFaces
// consecutive faces (a thread a face) and a group of kHitTiles tiles.  The
// grid is one-dimensional, face blocks fastest, then tile groups, then
// images, so any batch whose block count fits an int launches (a 3-D grid
// would cap the images at gridDim.z's 65,535); dirt_hit_plane sizes it.
// The group's tile constants (the bbox bounds and the dilated rectangle's
// NDC corners) are computed once per tile by the block's first threads
// into shared memory; each thread loads its face's bbox and nine edge
// coefficients once, derives the three margins once, then loops over the
// tiles: the four bbox compares first, the edge test only where they pass
// and edge_col >= 0.  The TPU kernel put faces on the lanes and tiles on
// the sublanes for the same reason: a face's columns are read once per
// tile group, not once per (tile, face).
//
// What bounds it on the H100: writing the [B, T, F] float plane (8 MB at
// the bench's 16 x 256 tiles x 512 faces) and reading each face's 13
// columns once (0.4 MB), 0.0026 ms.  Neighbouring threads take
// neighbouring faces, so each tile's stores are coalesced along F; the
// tile groups give 1,024 blocks of 128 threads at the bench (4 face blocks
// x 16 tile groups x 16 images) and on 1 x 256 tiles x 8,192 faces (64 x
// 16 x 1), so the card holds every block at once.  With these blocks the
// stores alone take about a fill of the plane (0.0029 ms); the compares,
// and the edge test of the warps where a face's bbox meets the tile, take
// the rest (PERF.md), so the tile loop is unrolled for their overlap.

#include <cuda_runtime.h>

namespace {

// The launch shape: threads (faces) a block and tiles a block; mirrored by
// forward_blocks.HIT_FACES and HIT_TILES.  The block's first kHitTiles
// threads compute the tile constants, so kHitTiles <= kHitFaces.
constexpr int kHitFaces = 128;
constexpr int kHitTiles = 16;
static_assert(kHitTiles <= kHitFaces, "a thread a tile's constants");

__global__ void __launch_bounds__(kHitFaces) hit_plane_kernel(
    const float* __restrict__ table,   // [B, F, width_d]
    float* __restrict__ keep,          // [B, T, F]
    int face_blocks, int tile_groups, int num_faces, int width_d,
    int num_tiles, int tiles_x, int tile_h, int tile_w, int r0c, int r1c,
    int c0c, int c1c, int edge_col, int dilate, float sx, float sy) {
  // Per tile of the group: the bbox bounds, then the NDC rectangle.
  __shared__ float r_end[kHitTiles], r_beg[kHitTiles], c_end[kHitTiles],
      c_beg[kHitTiles], x_lo[kHitTiles], x_hi[kHitTiles], y_lo[kHitTiles],
      y_hi[kHitTiles];
  const int face_block = blockIdx.x % face_blocks;
  const int group = blockIdx.x / face_blocks;
  const int t0 = (group % tile_groups) * kHitTiles;
  const int nt = min(kHitTiles, num_tiles - t0);
  const long long b = group / tile_groups;
  if (threadIdx.x < nt) {
    const int i = threadIdx.x;
    const int t = t0 + i;
    const int ty = t / tiles_x;
    const int tx = t % tiles_x;
    const float tile_r0 = (float)(ty * tile_h);
    const float tile_c0 = (float)(tx * tile_w);
    r_end[i] = tile_r0 + (float)(tile_h - 1);
    r_beg[i] = tile_r0;
    c_end[i] = tile_c0 + (float)(tile_w - 1);
    c_beg[i] = tile_c0;
    const float c_lo = tile_c0 - (float)dilate;
    const float c_hi = (c_lo + (float)(tile_w - 1)) + (float)(2 * dilate);
    const float r_lo = tile_r0 - (float)dilate;
    const float r_hi = (r_lo + (float)(tile_h - 1)) + (float)(2 * dilate);
    x_lo[i] = (c_lo + 0.5f) * sx - 1.0f;
    x_hi[i] = (c_hi + 0.5f) * sx - 1.0f;
    y_hi[i] = 1.0f - (r_lo + 0.5f) * sy;
    y_lo[i] = 1.0f - (r_hi + 0.5f) * sy;
  }
  __syncthreads();
  const int f = face_block * kHitFaces + threadIdx.x;
  if (f >= num_faces) return;

  const float* row = table + (b * num_faces + f) * width_d;
  const float r0 = row[r0c], r1 = row[r1c], c0 = row[c0c], c1 = row[c1c];
  const bool edges = edge_col >= 0;
  float ea[3], eb[3], ec[3], margin[3];
  if (edges) {
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      ea[e] = row[edge_col + 3 * e];
      eb[e] = row[edge_col + 3 * e + 1];
      ec[e] = row[edge_col + 3 * e + 2];
      margin[e] = ((fabsf(ea[e]) + fabsf(eb[e])) + fabsf(ec[e])) * 0x1p-20f;
    }
  }
  float* out = keep + (b * num_tiles + t0) * num_faces + f;
  // Unrolled, so that the tiles' compares and stores overlap.
#pragma unroll
  for (int i = 0; i < kHitTiles; ++i, out += num_faces) {
    if (i >= nt) break;
    bool k = (r0 <= r_end[i]) && (r1 >= r_beg[i]) && (c0 <= c_end[i]) &&
             (c1 >= c_beg[i]);
    if (k && edges) {
      bool any_max_neg = false;
      bool any_min_pos = false;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float a = ea[e];
        const float bb = eb[e];
        const float c = ec[e];
        const bool a_pos = a > 0.0f;
        const bool b_pos = bb > 0.0f;
        const float ax_max = a * (a_pos ? x_hi[i] : x_lo[i]);
        const float ax_min = a * (a_pos ? x_lo[i] : x_hi[i]);
        const float by_max = bb * (b_pos ? y_hi[i] : y_lo[i]);
        const float by_min = bb * (b_pos ? y_lo[i] : y_hi[i]);
        const float emax = by_max + (ax_max + c);
        const float emin = by_min + (ax_min + c);
        any_max_neg = any_max_neg || (emax < -margin[e]);
        any_min_pos = any_min_pos || (emin > margin[e]);
      }
      k = !(any_max_neg && any_min_pos);
    }
    *out = k ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" int dirt_hit_plane(
    const float* table, float* keep, int batch, int num_faces, int width_d,
    int num_tiles, int tiles_x, int tile_h, int tile_w, int r0c, int r1c,
    int c0c, int c1c, int edge_col, int dilate, float sx, float sy,
    cudaStream_t stream) {
  const int face_blocks = (num_faces + kHitFaces - 1) / kHitFaces;
  const int tile_groups = (num_tiles + kHitTiles - 1) / kHitTiles;
  const long long blocks = (long long)face_blocks * tile_groups * batch;
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  hit_plane_kernel<<<(unsigned int)blocks, kHitFaces, 0, stream>>>(
      table, keep, face_blocks, tile_groups, num_faces, width_d, num_tiles,
      tiles_x, tile_h, tile_w, r0c, r1c, c0c, c1c, edge_col, dilate, sx, sy);
  return (int)cudaGetLastError();
}
