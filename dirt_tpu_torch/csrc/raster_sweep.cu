// K1: raster_sweep -- the block-binned forward sweep.
//
// Replaces dirt_tpu/ops/forward_blocks.py:_raster_kernel_fused (the TPU's
// production forward sweep, with its math in forward_dense._chunk_candidates
// and merge_state).
//
// Work: one thread block per (image, tile) of tile_h x tile_w pixels, one
// thread per pixel.  The block walks its tile's CSR run of face blocks
// (block_ids[starts[bt] .. starts[bt] + counts[bt]]); each visit stages the
// block's chunk x width_d face-table rows in shared memory, and every thread
// tests the rows in order against its pixel centre: edge functions, the
// COVER_FAST fill rule with the |s_z| <= |s_w| clip, depth s_z / s_w, and
// the lexicographic (depth, original face index) z-test against its running
// winner, which starts at glClearDepth's (1.0, -1).  The lexicographic
// minimum is associative, so visiting faces one by one picks the same
// winner as the TPU's chunk minimum followed by the merge.
//
// The thread keeps the winner's depth, index, E0..E2 and S_w in registers,
// and the winner's table row number; at the end it reads the row's vertex
// ids and corner attributes from global memory and writes the packed state
// [C+9, PIX] of forward_dense (numerators ((E0*a0 + E1*a1) + E2*a2), so
// finalize's single division keeps constant attributes exact).
//
// What bounds it on the H100: arithmetic and shared-memory reads per
// (pixel, swept face) -- about 30 flops and 18 broadcast shared loads, with
// one division only for covered fragments.  Device memory traffic is the
// face blocks (once per visit per tile, L2-resident: the bench table is
// 74 KB) and one state write per pixel.  The design answers with the
// spatially sorted CSR runs, which keep the swept faces near the tile, and
// with shared-memory staging that every thread of the tile reuses.
//
// Built with -fmad=false and IEEE division: every product rounds as in
// eager PyTorch, so the state equals the plain version's
// (forward_blocks.raster_sweep_plain) bit for bit, except that a -0.0 the
// plain version's pick sum turns into +0.0 may stay -0.0 here.

#include <cuda_runtime.h>

namespace {

constexpr int kBase = 27;   // forward_pallas._BASE

__global__ void raster_sweep_kernel(
    const float* __restrict__ table,      // [B*NB, chunk, width_d]
    const int* __restrict__ starts,       // [B*T]
    const int* __restrict__ counts,       // [B*T]
    const int* __restrict__ block_ids,    // [B*S], batch-folded
    float* __restrict__ state,            // [B*T, C+9, PIX]
    int num_tiles, int tiles_x, int tile_h, int tile_w,
    int chunk, int width_d, int channels, float sx, float sy) {
  extern __shared__ float rows[];          // [chunk, width_d]
  const int bt = blockIdx.x;
  const int tile = bt % num_tiles;
  const int pix = tile_h * tile_w;
  const int p = threadIdx.x;
  const int r = p / tile_w;
  const int c = p - r * tile_w;
  const int row = (tile / tiles_x) * tile_h + r;
  const int col = (tile % tiles_x) * tile_w + c;
  // forward_dense.pixel_ndc: ((col + 0.5) * (2/W) - 1, 1 - (row + 0.5) * (2/H)).
  const float xg = ((float)col + 0.5f) * sx - 1.0f;
  const float yg = 1.0f - ((float)row + 0.5f) * sy;

  float best_d = 1.0f;
  float best_o = -1.0f;
  float w_e0 = 0.0f, w_e1 = 0.0f, w_e2 = 0.0f, w_sw = 0.0f;
  long long best_row = -1;

  const int start = starts[bt];
  const int n = counts[bt];
  const int block_floats = chunk * width_d;
  for (int i = 0; i < n; ++i) {
    const long long bid = block_ids[start + i];
    __syncthreads();
    const float* src = table + bid * block_floats;
    for (int j = threadIdx.x; j < block_floats; j += blockDim.x) {
      rows[j] = src[j];
    }
    __syncthreads();
    for (int k = 0; k < chunk; ++k) {
      const float* f = rows + k * width_d;
      const float e0 = (f[0] * xg + f[1] * yg) + f[2];
      const float e1 = (f[3] * xg + f[4] * yg) + f[5];
      const float e2 = (f[6] * xg + f[7] * yg) + f[8];
      const float s_z = (e0 * f[9] + e1 * f[10]) + e2 * f[11];
      const float s_w = (e0 * f[12] + e1 * f[13]) + e2 * f[14];
      const bool sp = s_w > 0.0f;
      const bool d0 = ((e0 > 0.0f) || ((e0 == 0.0f) && (f[15] != 0.0f))) == sp;
      const bool d1 = ((e1 > 0.0f) || ((e1 == 0.0f) && (f[16] != 0.0f))) == sp;
      const bool d2 = ((e2 > 0.0f) || ((e2 == 0.0f) && (f[17] != 0.0f))) == sp;
      // NaN s_w (invalid rows) passes != 0 and fails the magnitude test.
      const bool covered = d0 && d1 && d2 && (s_w != 0.0f) &&
                           (fabsf(s_z) <= fabsf(s_w));
      if (!covered) continue;
      const float depth = s_z / s_w;
      const float orig = f[19];
      if (depth < best_d || (depth == best_d && orig < best_o)) {
        best_d = depth;
        best_o = orig;
        w_e0 = e0;
        w_e1 = e1;
        w_e2 = e2;
        w_sw = s_w;
        best_row = bid * chunk + k;
      }
    }
  }

  if (p >= pix) return;
  float* out = state + (long long)bt * (channels + 9) * pix + p;
  if (best_row >= 0) {
    const float* f = table + best_row * width_d;
    for (int ch = 0; ch < channels; ++ch) {
      out[ch * pix] = (w_e0 * f[kBase + ch] + w_e1 * f[kBase + channels + ch])
                      + w_e2 * f[kBase + 2 * channels + ch];
    }
    out[(channels + 0) * pix] = w_e0;
    out[(channels + 1) * pix] = w_e1;
    out[(channels + 2) * pix] = w_e2;
    out[(channels + 3) * pix] = w_sw;
    out[(channels + 4) * pix] = f[24];
    out[(channels + 5) * pix] = f[25];
    out[(channels + 6) * pix] = f[26];
  } else {
    for (int k = 0; k < channels + 7; ++k) out[k * pix] = 0.0f;
  }
  out[(channels + 7) * pix] = best_d;
  out[(channels + 8) * pix] = best_o;
}

}  // namespace

extern "C" int dirt_raster_sweep(
    const float* table, const int* starts, const int* counts,
    const int* block_ids, float* state, int runs, int num_tiles, int tiles_x,
    int tile_h, int tile_w, int chunk, int width_d, int channels, float sx,
    float sy, cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)chunk * width_d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(raster_sweep_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  raster_sweep_kernel<<<runs, tile_h * tile_w, smem, stream>>>(
      table, starts, counts, block_ids, state, num_tiles, tiles_x, tile_h,
      tile_w, chunk, width_d, channels, sx, sy);
  return (int)cudaGetLastError();
}
