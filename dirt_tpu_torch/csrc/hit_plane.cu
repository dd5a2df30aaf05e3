// K4: hit_plane -- the [B, T, NB] block hits of the CSR schedules.
//
// Replaces dirt_tpu/ops/forward_blocks.py:_hit_kernel (called through
// _hit_matrix_pallas), the TPU kernel that decides which (tile, face) pairs
// the forward sweep (dilate = 0) and the gradient reduction (dilate = 1)
// visit, and the reduction of its [T, F] plane to one hit a (tile, block
// of `chunk` consecutive table rows) that followed it.  This kernel
// decides the block hits itself: no plane is written.
//
// A face is kept when its pixel bbox overlaps the tile and, with
// edge_col >= 0, the conservative half-plane cull cannot rule it out: each
// edge function is linear in NDC, so its extremes over the tile's (dilated)
// pixel-centre rectangle sit at corners; the tile is culled iff some edge
// is below -margin everywhere and some edge is above +margin everywhere,
// with margin = 2^-20 (|a|+|b|+|c|).  The expression tree is the TPU
// kernel's term for term (and the plain version's,
// forward_blocks.hit_plane_plain), so with -fmad=false every face's test,
// and so every block hit, is bitwise the plain version's; the schedule's
// correctness needs only that the cull is conservative, which the margin
// guarantees.
//
// What bounds it on the H100: the plane it replaced was B x T x F entries
// (2^31 at 32 images of 512^2 and 65,536 faces: 8 GiB of float32, then
// PyTorch's compare and its reduction over rows of 32 bools, ~51 ms a
// step of the two packs), for an output of B x T x NB bytes (64 MiB
// there).  What this kernel must move is that output and each face's 13
// columns of the table, once; the work that decides the hits scales with
// the tiles the faces can reach, not with T x F.  So:
//
//  * Tile window.  Each lane takes one face and derives the tile rows and
//    columns its four bbox compares can pass, widened by one tile on each
//    side (float rounding of the division) and clamped to the image (the
//    whole image where a bound is not finite).  A min / max over the
//    block's lanes gives the block's window, its bounding rectangle; every
//    (tile, block) outside it is a miss that no member could pass, and the
//    wrapper zero-fills the output (one memset), so the kernel stores only
//    inside windows.  Morton-sorted faces under a pixel span a few tiles a
//    block.
//  * Warp vote.  Inside the window every lane runs its face's exact test
//    on the window's tiles in order, __ballot_sync gathers the votes and
//    one lane stores the byte where any member kept the tile.  At chunk
//    32 one warp is one block; a chunk below 32 masks the ballot into
//    lane segments (a segment a block, each with its own window, the warp
//    looping to the longest); a chunk above 32 (a power of two up to 1024,
//    the threads of one thread block) ORs its warps' votes, 32 tiles at a
//    time, through shared memory.
//  * Counter.  With `window` non-null (a profiler session), the tile
//    count of each (image, block) window goes to window[b, nb].
//
// Launch: thread blocks of kHitThreads threads (chunk <= 32) or of chunk
// threads (chunk > 32), a face a thread, on a one-dimensional grid of the
// image's thread blocks fastest, then images, so any batch whose block
// count fits an int launches; dirt_hit_blocks sizes it.

#include <cuda_runtime.h>

namespace {

// Threads a thread block where a block's faces fit one warp; mirrored by
// forward_blocks.HIT_THREADS.  A chunk above kWarp runs chunk threads,
// at most kMaxChunk.
constexpr int kHitThreads = 128;
constexpr int kWarp = 32;
constexpr int kMaxChunk = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int tiles_y, tiles_x, tile_h, tile_w, dilate;
  float sx, sy;
  bool edges;
};

// One face's columns and edge margins, loaded once.
struct Face {
  float r0, r1, c0, c1;
  float ea[3], eb[3], ec[3], margin[3];
};

// The tiles [lo, hi] along one axis whose two bbox compares the face's
// [lo_px, hi_px] can pass (lo_px <= t * tile + tile - 1, hi_px >= t *
// tile), widened by one on each side and clamped to [0, tiles - 1]; all of
// them where a bound is not finite, none (lo > hi) where none can pass.
__device__ __forceinline__ void tile_range(float lo_px, float hi_px,
                                           int tile, int tiles, int& lo,
                                           int& hi) {
  if (!(isfinite(lo_px) && isfinite(hi_px))) {
    lo = 0;
    hi = tiles - 1;
    return;
  }
  const float a =
      fmaxf(ceilf((lo_px - (float)(tile - 1)) / (float)tile) - 1.0f, 0.0f);
  const float b =
      fminf(floorf(hi_px / (float)tile) + 1.0f, (float)(tiles - 1));
  if (a > b) {
    lo = tiles;
    hi = -1;
  } else {
    lo = (int)a;
    hi = (int)b;
  }
}

// The exact test of the face on tile (ty, tx): the four bbox compares,
// then the edge test where they pass and the cull is on.
__device__ __forceinline__ bool keeps(const Face& f, const Geometry& g,
                                      int ty, int tx) {
  const float tile_r0 = (float)(ty * g.tile_h);
  const float tile_c0 = (float)(tx * g.tile_w);
  const bool k = (f.r0 <= tile_r0 + (float)(g.tile_h - 1)) &&
                 (f.r1 >= tile_r0) &&
                 (f.c0 <= tile_c0 + (float)(g.tile_w - 1)) &&
                 (f.c1 >= tile_c0);
  if (!k || !g.edges) return k;
  const float c_lo = tile_c0 - (float)g.dilate;
  const float c_hi = (c_lo + (float)(g.tile_w - 1)) + (float)(2 * g.dilate);
  const float r_lo = tile_r0 - (float)g.dilate;
  const float r_hi = (r_lo + (float)(g.tile_h - 1)) + (float)(2 * g.dilate);
  const float x_lo = (c_lo + 0.5f) * g.sx - 1.0f;
  const float x_hi = (c_hi + 0.5f) * g.sx - 1.0f;
  const float y_hi = 1.0f - (r_lo + 0.5f) * g.sy;
  const float y_lo = 1.0f - (r_hi + 0.5f) * g.sy;
  bool any_max_neg = false;
  bool any_min_pos = false;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float a = f.ea[e];
    const float bb = f.eb[e];
    const float c = f.ec[e];
    const bool a_pos = a > 0.0f;
    const bool b_pos = bb > 0.0f;
    const float ax_max = a * (a_pos ? x_hi : x_lo);
    const float ax_min = a * (a_pos ? x_lo : x_hi);
    const float by_max = bb * (b_pos ? y_hi : y_lo);
    const float by_min = bb * (b_pos ? y_lo : y_hi);
    const float emax = by_max + (ax_max + c);
    const float emin = by_min + (ax_min + c);
    any_max_neg = any_max_neg || (emax < -f.margin[e]);
    any_min_pos = any_min_pos || (emin > f.margin[e]);
  }
  return !(any_max_neg && any_min_pos);
}

// kAcrossWarps: chunk > 32, a thread block a block of faces; else chunk
// <= 32, lane segments of `chunk` lanes a block.
template <bool kAcrossWarps>
__global__ void __launch_bounds__(kAcrossWarps ? kMaxChunk : kHitThreads)
    hit_block_kernel(const float* __restrict__ table,  // [B, F, width_d]
                     unsigned char* __restrict__ hit,  // [B, T, NB], zeros
                     int* __restrict__ window,         // [B, NB] or null
                     int parts, int num_faces, int width_d, int num_blocks,
                     int chunk, int r0c, int r1c, int c0c, int c1c,
                     int edge_col, Geometry g) {
  __shared__ int bounds[kAcrossWarps ? kMaxChunk / kWarp : 1][4];
  __shared__ unsigned votes[kAcrossWarps ? kMaxChunk / kWarp : 1][kWarp];
  const int part = blockIdx.x % parts;
  const long long b = blockIdx.x / parts;
  const int first = part * blockDim.x;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  // A warp wholly past the table's last row has nothing to vote on (only
  // where chunk <= 32: a chunk above 32 fills its thread block).
  if (first + warp * kWarp >= num_faces) return;
  const int f = first + threadIdx.x;
  const bool live = f < num_faces;

  Face face;
  int ry0 = g.tiles_y, ry1 = -1, cx0 = g.tiles_x, cx1 = -1;
  if (live) {
    const float* row = table + (b * num_faces + f) * width_d;
    face.r0 = row[r0c];
    face.r1 = row[r1c];
    face.c0 = row[c0c];
    face.c1 = row[c1c];
    int a0, a1, b0, b1;
    tile_range(face.r0, face.r1, g.tile_h, g.tiles_y, a0, a1);
    tile_range(face.c0, face.c1, g.tile_w, g.tiles_x, b0, b1);
    if (a0 <= a1 && b0 <= b1) {
      ry0 = a0;
      ry1 = a1;
      cx0 = b0;
      cx1 = b1;
    }
    if (g.edges) {
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        face.ea[e] = row[edge_col + 3 * e];
        face.eb[e] = row[edge_col + 3 * e + 1];
        face.ec[e] = row[edge_col + 3 * e + 2];
        face.margin[e] =
            ((fabsf(face.ea[e]) + fabsf(face.eb[e])) + fabsf(face.ec[e])) *
            0x1p-20f;
      }
    }
  }
  // The block's window: min / max over its lanes (xor offsets below the
  // segment stay inside it), then over its warps.
  const int seg = kAcrossWarps ? kWarp : chunk;
  for (int off = 1; off < seg; off <<= 1) {
    ry0 = min(ry0, __shfl_xor_sync(kFull, ry0, off));
    ry1 = max(ry1, __shfl_xor_sync(kFull, ry1, off));
    cx0 = min(cx0, __shfl_xor_sync(kFull, cx0, off));
    cx1 = max(cx1, __shfl_xor_sync(kFull, cx1, off));
  }
  if (kAcrossWarps) {
    if (lane == 0) {
      bounds[warp][0] = ry0;
      bounds[warp][1] = ry1;
      bounds[warp][2] = cx0;
      bounds[warp][3] = cx1;
    }
    __syncthreads();
    for (int w = 0; w < (int)(blockDim.x / kWarp); ++w) {
      ry0 = min(ry0, bounds[w][0]);
      ry1 = max(ry1, bounds[w][1]);
      cx0 = min(cx0, bounds[w][2]);
      cx1 = max(cx1, bounds[w][3]);
    }
  }
  const int cols = cx1 - cx0 + 1;
  const int n = ry1 >= ry0 ? (ry1 - ry0 + 1) * cols : 0;
  const int nb = f / chunk;
  const bool lead = live && f % chunk == 0;
  if (window != nullptr && lead) window[b * num_blocks + nb] = n;
  const int num_tiles = g.tiles_y * g.tiles_x;
  unsigned char* out = hit + b * num_tiles * (long long)num_blocks + nb;

  int ty = ry0, tx = cx0;
  if (!kAcrossWarps) {
    // Segments of one warp loop together, to the longest window.
    int longest = n;
    for (int off = seg; off < kWarp; off <<= 1)
      longest = max(longest, __shfl_xor_sync(kFull, longest, off));
    const unsigned mask =
        seg == kWarp ? kFull : ((1u << seg) - 1u) << (lane & ~(seg - 1));
    for (int i = 0; i < longest; ++i) {
      const bool k = live && i < n && keeps(face, g, ty, tx);
      const unsigned vote = __ballot_sync(kFull, k);
      if (lead && (vote & mask) != 0u)
        out[(long long)(ty * g.tiles_x + tx) * num_blocks] = 1;
      if (++tx > cx1) {
        tx = cx0;
        ++ty;
      }
    }
    return;
  }
  // The thread block's warps take 32 tiles of the window at a time: lane
  // j of each warp keeps its warp's ballot of tile base + j, and warp 0
  // ORs them.
  const int warps = blockDim.x / kWarp;
  for (int base = 0; base < n; base += kWarp) {
    const int m = min(kWarp, n - base);
    unsigned mine = 0u;
    for (int j = 0; j < m; ++j) {
      const unsigned vote = __ballot_sync(kFull, keeps(face, g, ty, tx));
      if (lane == j) mine = vote;
      if (++tx > cx1) {
        tx = cx0;
        ++ty;
      }
    }
    votes[warp][lane] = mine;
    __syncthreads();
    if (warp == 0 && lane < m) {
      unsigned any = 0u;
      for (int w = 0; w < warps; ++w) any |= votes[w][lane];
      if (any != 0u) {
        const int i = base + lane;
        out[(long long)((ry0 + i / cols) * g.tiles_x + cx0 + i % cols) *
            num_blocks] = 1;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dirt_hit_blocks(
    const float* table, unsigned char* hit, int* window, int batch,
    int num_faces, int width_d, int num_blocks, int chunk, int tiles_y,
    int tiles_x, int tile_h, int tile_w, int r0c, int r1c, int c0c, int c1c,
    int edge_col, int dilate, float sx, float sy, cudaStream_t stream) {
  if (chunk < 1 || chunk > kMaxChunk || (chunk & (chunk - 1)) != 0 ||
      (long long)num_blocks * chunk != num_faces)
    return (int)cudaErrorInvalidValue;
  const int threads = chunk > kWarp ? chunk : kHitThreads;
  const int parts = (num_faces + threads - 1) / threads;
  const long long blocks = (long long)parts * batch;
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const Geometry g{tiles_y, tiles_x, tile_h, tile_w, dilate, sx, sy,
                   edge_col >= 0};
  if (chunk > kWarp)
    hit_block_kernel<true><<<(unsigned int)blocks, threads, 0, stream>>>(
        table, hit, window, parts, num_faces, width_d, num_blocks, chunk,
        r0c, r1c, c0c, c1c, edge_col, g);
  else
    hit_block_kernel<false><<<(unsigned int)blocks, threads, 0, stream>>>(
        table, hit, window, parts, num_faces, width_d, num_blocks, chunk,
        r0c, r1c, c0c, c1c, edge_col, g);
  return (int)cudaGetLastError();
}
