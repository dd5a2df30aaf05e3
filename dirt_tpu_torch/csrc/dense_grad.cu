// K9: dense_grad_reduce -- the tile-major masked gradient reductions of the
// "dense" gradient.
//
// Replaces dirt_tpu/ops/grad_dense.py:_grad_kernel_fused (a tile's whole
// face list resident, a loop writing each live chunk's rows and zeros for
// the dead ones) and _grad_kernel (the same rows, one chunk per grid
// step).  Both write the same rows; only the TPU's streaming differs, so
// one kernel covers both.  The math is grad_dense._chunk_sums.
//
// Work: one warp per face slot of a tile's list at a time; a block of
// `warps` warps takes warps x per_warp consecutive slots of one tile, warp
// w the slots w, w + warps, ... (grad_dense.dense_shape).  A slot of a
// chunk at or past the tile's hit count is dead and its row is zeros (the
// rows scatter through sorted_orig into vertex rows, so they must be
// zeros, never left unwritten); dead chunks are a suffix of the list, so
// a block whose first slot is dead writes all its rows together and ends.
// A live slot reads its row of the gradient face table by index
// (forward_pallas._pack_faces layout) and adds its face's masked sums with
// grad_math.cuh's per-pixel arithmetic (shared with K3 and K6) over its
// window only: the face's table bbox (grad_tables, widened one pixel for
// dilation; the whole image for a face crossing the camera plane) clipped
// to the tile.  No pixel outside that bbox carries the face's id in face_d
// or face_pre (tests/test_torch_dense_grad.py holds the premise), so the
// sums are the plain version's up to summation order; the tail slots of a
// live chunk (faces whose bboxes miss the tile, reduced on the TPU too)
// and padded rows have empty windows and write zeros.  The window's pixels
// are flattened row-major and dealt to the 32 lanes in turn, so
// neighbouring lanes read neighbouring pixels of one row; each lane sums
// its pixels in order in registers, up to 12 colour channels a pass (the
// position terms ride on the first), and the warp combines its lanes by a
// butterfly (grad_math.cuh warp_sum): one owner per row, a fixed order, no
// atomics.
//
// The lanes read the planes straight from device memory (L2): each lane
// loads the id planes of its pixels, and the other planes only where an
// id matches.  (A ring of row-band pieces staged through cp.async lost to
// it by 3.2x at the bench configuration: PERF.md.)
//
// What bounds it on the H100: its bytes bound (the planes of the windows'
// pixels, each read once, and the rows it writes) is ~0.003 ms at the
// bench size.  The work is the windows' pixels, ~59 a live face slot
// there against the tile's 4,096; a warp a slot keeps many warps on every
// SM, and latency (the
// dependent loads of a short window, and of the table row before it) sets
// the time.
//
// The summation order differs from the plain version's (torch sums each
// [chunk, pix] plane with its own reduction tree), so the rows agree within
// a normalised tolerance, not bitwise.

#include <cuda_runtime.h>

#include "grad_math.cuh"

namespace {

constexpr int kMaxWarps = 8;   // grad_dense.MAX_WARPS

// The launch shape grad_dense.dense_shape computes.
struct DenseShape {
  int warps;      // warps a block
  int per_warp;   // face slots a warp, in turn
};

// Where run bt's tile lies: tile t = bt % tiles of its image, tiles_x a
// row, tile_h x tile_w pixels.
struct TileGeom {
  int tile_h, tile_w, tiles_x, tiles;
};

// A face slot's window in tile-local rows and columns, inclusive; empty
// when r0 > r1 or c0 > c1.
struct Window {
  int r0, r1, c0, c1;
  __device__ bool empty() const { return r0 > r1 || c0 > c1; }
};

// The table bbox (columns 0-3: r0, r1, c0, c1, whole numbers held in
// floats; padded rows hold the empty box 2^30 .. -1) clipped to the tile.
__device__ __forceinline__ Window face_window(const float* row,
                                              long long run,
                                              const TileGeom& g) {
  const int t = (int)(run % g.tiles);
  const int oy = (t / g.tiles_x) * g.tile_h;
  const int ox = (t % g.tiles_x) * g.tile_w;
  return Window{max((int)row[0] - oy, 0), min((int)row[1] - oy, g.tile_h - 1),
                max((int)row[2] - ox, 0), min((int)row[3] - ox, g.tile_w - 1)};
}

// Adds the pixels of window w of a tile's plane stack (plane i at
// tile[i * pix ..], rows of tile_w pixels) to the lane's sums: the
// window's pixels flattened row-major, pixel j to lane j % 32.
template <int G>
__device__ __forceinline__ void scan_window(
    const float* tile, int pix, int tile_w, const Window& w, int lane,
    const dirt::GradFace& face, const dirt::GradLayout& layout, bool do_pos,
    bool want_col, int c0, int nc, dirt::GradSumsN<G>& sums) {
  const int width = w.c1 - w.c0 + 1;
  const int dr = 32 / width, dc = 32 % width;
  int r = w.r0 + lane / width;
  int c = w.c0 + lane % width;
  while (r <= w.r1) {
    dirt::add_pixel(tile, pix, r * tile_w + c, face, layout, do_pos,
                    want_col, c0, nc, sums);
    r += dr;
    c += dc;
    if (c > w.c1) {
      c -= width;
      ++r;
    }
  }
}

// One face slot's row, by one warp (dense_grad_kernel's body); `live`:
// the slot's chunk is live.
template <int G>
__device__ __forceinline__ void reduce_slot(
    const float* __restrict__ table, const int* __restrict__ face_ids,
    const float* __restrict__ planes, float* __restrict__ out,
    long long run, int slot, bool live, int slots, int width_d,
    int np_stride, int pix, int d_out, int channels, int want_pos,
    const dirt::GradLayout& layout, const TileGeom& geom) {
  const int lane = threadIdx.x % 32;
  float* dst = out + (run * slots + slot) * d_out;
  const float* row =
      table + (long long)(live ? face_ids[run * slots + slot] : 0) * width_d;
  Window w{1, 0, 1, 0};
  if (live) w = face_window(row, run, geom);
  const dirt::GradFace face = dirt::load_grad_face(row);
  const float* src = planes + run * np_stride * pix;

  const bool want_col = layout.fp >= 0;
  const int d_corner = d_out / 3;
  const int col_base = want_pos ? 3 : 0;
  const int passes = want_col ? (channels + G - 1) / G : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const bool do_pos = want_pos && pass == 0;
    const int c0 = pass * G;
    const int nc = want_col ? min(G, channels - c0) : 0;
    dirt::GradSumsN<G> sums;
    dirt::clear_sums(sums);
    if (!w.empty()) {
      scan_window(src, pix, geom.tile_w, w, lane, face, layout, do_pos,
                  want_col, c0, nc, sums);
      dirt::warp_sum(sums);
    }
    if (lane == 0) {
      dirt::write_sums(dst, d_corner, do_pos, col_base, c0, nc, sums);
    }
  }
}

template <int G>
__global__ void __launch_bounds__(kMaxWarps * 32) dense_grad_kernel(
    const float* __restrict__ table,     // [B*F', width_d]
    const int* __restrict__ face_ids,    // [B*T, slots], batch-folded rows
    const int* __restrict__ counts,      // [B*T]
    const float* __restrict__ planes,    // [B*T, np_stride, pix]
    float* __restrict__ out,             // [B*T, slots, d_out]
    int slots, int chunk, int width_d, int np_stride, int pix, int d_out,
    int channels, int want_pos, dirt::GradLayout layout, TileGeom geom,
    DenseShape shape) {
  const int warp = threadIdx.x / 32;
  const int per_block = shape.warps * shape.per_warp;
  const int groups = slots / per_block;
  const long long run = blockIdx.x / groups;
  const int first = (blockIdx.x % groups) * per_block;
  const int count = counts[run];
  if (first / chunk * chunk >= count) {
    // Dead chunks are a suffix of the list: every slot here is dead.
    float* rows = out + (run * slots + first) * d_out;
    for (int j = threadIdx.x; j < per_block * d_out; j += blockDim.x) {
      rows[j] = 0.0f;
    }
    return;
  }
  for (int k = 0; k < shape.per_warp; ++k) {
    const int slot = first + k * shape.warps + warp;
    reduce_slot<G>(table, face_ids, planes, out, run, slot,
                   slot / chunk * chunk < count, slots, width_d, np_stride,
                   pix, d_out, channels, want_pos, layout, geom);
  }
}

template <int G>
int launch(const float* table, const int* face_ids, const int* counts,
           const float* planes, float* out, int runs, int slots, int chunk,
           int width_d, int np_stride, int pix, int d_out, int channels,
           int want_pos, const dirt::GradLayout& layout, const TileGeom& geom,
           const DenseShape& shape, cudaStream_t stream) {
  const long long blocks =
      (long long)runs * (slots / (shape.warps * shape.per_warp));
  dense_grad_kernel<G><<<(unsigned int)blocks, shape.warps * 32, 0,
                         stream>>>(
      table, face_ids, counts, planes, out, slots, chunk, width_d, np_stride,
      pix, d_out, channels, want_pos, layout, geom, shape);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dirt_dense_grad_reduce(
    const float* table, const int* face_ids, const int* counts,
    const float* planes, float* out, int runs, int slots, int chunk,
    int width_d, int np_stride, int pix, int d_out, int channels,
    int want_pos, int l_ax, int l_ay, int l_px, int l_py, int l_bd, int l_fd,
    int l_bp, int l_fp, int l_grad, int tile_h, int tile_w, int tiles_x,
    int tiles, int group, int warps, int per_warp, cudaStream_t stream) {
  if (runs == 0 || slots == 0) return (int)cudaGetLastError();
  if (warps < 1 || warps > kMaxWarps || per_warp < 1 ||
      slots % (warps * per_warp)) {
    return (int)cudaErrorInvalidValue;
  }
  const dirt::GradLayout layout{l_ax, l_ay, l_px, l_py, l_bd,
                                l_fd, l_bp, l_fp, l_grad};
  const TileGeom geom{tile_h, tile_w, tiles_x, tiles};
  const DenseShape shape{warps, per_warp};
#define DIRT_LAUNCH(G)                                                       \
  launch<G>(table, face_ids, counts, planes, out, runs, slots, chunk,        \
            width_d, np_stride, pix, d_out, channels, want_pos, layout,      \
            geom, shape, stream)
  switch (group) {
    case 4: return DIRT_LAUNCH(4);
    case 8: return DIRT_LAUNCH(8);
    case 12: return DIRT_LAUNCH(12);
    default: return (int)cudaErrorInvalidValue;
  }
#undef DIRT_LAUNCH
}
