// K4: hit_plane -- the per-image [T, F] keep plane of the CSR schedules.
//
// Replaces dirt_tpu/ops/forward_blocks.py:_hit_kernel (called through
// _hit_matrix_pallas), the TPU kernel that decides which (tile, face) pairs
// the forward sweep (dilate = 0) and the gradient reduction (dilate = 1)
// visit.
//
// Work: one thread per (image, tile, face).  A face is kept when its pixel
// bbox overlaps the tile and, with edge_col >= 0, the conservative
// half-plane cull cannot rule it out: each edge function is linear in NDC,
// so its extremes over the tile's (dilated) pixel-centre rectangle sit at
// corners; the tile is culled iff some edge is below -margin everywhere and
// some edge is above +margin everywhere, with margin = 2^-20 (|a|+|b|+|c|).
// The expression tree is the TPU kernel's term for term (and the plain
// version's, forward_blocks.hit_plane_plain), so with -fmad=false the
// planes are bitwise equal; the schedule's correctness needs only that the
// cull is conservative, which the margin guarantees.
//
// What bounds it on the H100: writing the [B, T, F] float plane (8 MB at
// the bench's 16 x 256 tiles x 512 faces) and reading 13 table floats per
// thread (the table is L2-resident).  Consecutive threads take consecutive
// faces, so both the table reads (strided by the row width) and the plane
// writes are coalesced along F; there is no VMEM-style size gate.

#include <cuda_runtime.h>

namespace {

__global__ void hit_plane_kernel(
    const float* __restrict__ table,   // [B, F, width_d]
    float* __restrict__ keep,          // [B, T, F]
    long long total, int num_faces, int width_d, int num_tiles, int tiles_x,
    int tile_h, int tile_w, int r0c, int r1c, int c0c, int c1c, int edge_col,
    int dilate, float sx, float sy) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int f = (int)(idx % num_faces);
  const long long bt = idx / num_faces;
  const int t = (int)(bt % num_tiles);
  const long long b = bt / num_tiles;
  const float* row = table + (b * num_faces + f) * width_d;

  const int ty = t / tiles_x;
  const int tx = t % tiles_x;
  const float tile_r0 = (float)(ty * tile_h);
  const float tile_c0 = (float)(tx * tile_w);
  bool k = (row[r0c] <= tile_r0 + (float)(tile_h - 1)) &&
           (row[r1c] >= tile_r0) &&
           (row[c0c] <= tile_c0 + (float)(tile_w - 1)) &&
           (row[c1c] >= tile_c0);
  if (k && edge_col >= 0) {
    const float c_lo = tile_c0 - (float)dilate;
    const float c_hi = (c_lo + (float)(tile_w - 1)) + (float)(2 * dilate);
    const float r_lo = tile_r0 - (float)dilate;
    const float r_hi = (r_lo + (float)(tile_h - 1)) + (float)(2 * dilate);
    const float x_lo = (c_lo + 0.5f) * sx - 1.0f;
    const float x_hi = (c_hi + 0.5f) * sx - 1.0f;
    const float y_hi = 1.0f - (r_lo + 0.5f) * sy;
    const float y_lo = 1.0f - (r_hi + 0.5f) * sy;
    bool any_max_neg = false;
    bool any_min_pos = false;
    for (int i = 0; i < 3; ++i) {
      const float a = row[edge_col + 3 * i];
      const float bb = row[edge_col + 3 * i + 1];
      const float c = row[edge_col + 3 * i + 2];
      const float margin = ((fabsf(a) + fabsf(bb)) + fabsf(c)) * 0x1p-20f;
      const bool a_pos = a > 0.0f;
      const bool b_pos = bb > 0.0f;
      const float ax_max = a * (a_pos ? x_hi : x_lo);
      const float ax_min = a * (a_pos ? x_lo : x_hi);
      const float by_max = bb * (b_pos ? y_hi : y_lo);
      const float by_min = bb * (b_pos ? y_lo : y_hi);
      const float emax = by_max + (ax_max + c);
      const float emin = by_min + (ax_min + c);
      any_max_neg = any_max_neg || (emax < -margin);
      any_min_pos = any_min_pos || (emin > margin);
    }
    k = !(any_max_neg && any_min_pos);
  }
  keep[idx] = k ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int dirt_hit_plane(
    const float* table, float* keep, int batch, int num_faces, int width_d,
    int num_tiles, int tiles_x, int tile_h, int tile_w, int r0c, int r1c,
    int c0c, int c1c, int edge_col, int dilate, float sx, float sy,
    cudaStream_t stream) {
  const long long total = (long long)batch * num_tiles * num_faces;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  hit_plane_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
      table, keep, total, num_faces, width_d, num_tiles, tiles_x, tile_h,
      tile_w, r0c, r1c, c0c, c1c, edge_col, dilate, sx, sy);
  return (int)cudaGetLastError();
}
