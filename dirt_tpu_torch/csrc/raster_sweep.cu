// K1: raster_sweep -- the block-binned forward sweep.
//
// Replaces dirt_tpu/ops/forward_blocks.py:_raster_kernel_fused (the TPU's
// production forward sweep, with its math in forward_dense._chunk_candidates
// and merge_state).
//
// Work: one thread block per (image, tile) run of tile_h x tile_w pixels,
// and one more per further piece of a long run.  A run without a visit
// writes the background and retires.  Else the block copies its tile's CSR
// run of face blocks (block_ids[starts[bt] .. starts[bt] + counts[bt]],
// ascending) into a visit list in shared memory and sweeps it with
// sweep_math.cuh's sweep_run, shared with K5b slot_sweep, K5 resident_sweep
// and K8 pallas_raster: the visits' face rows staged by cp.async, each
// visit's faces dealt to S face groups of one thread a pixel, a face tested
// only at the pixels its bbox holds (edge functions, the COVER_FAST fill
// rule with the |s_z| <= |s_w| clip, depth s_z / s_w, and the lexicographic
// (depth, original face index) z-test against the running winner, which
// starts at glClearDepth's (1.0, -1)), then the groups' winners combined in
// group order and the packed state [C+9, PIX] of forward_dense written.
//
// What bounds it on the H100: the bytes bound is the state write and the
// face rows, the face tests' operations a fraction of that.  But the work
// sits in few runs (at 32 x 512^2 and 65,536 faces, 4,814 visits an image
// on 16 of its 1,024 tiles, runs of up to 830 visits), so with a block a
// run one block's dependent chain of face tests on its SM set the time
// while most SMs had retired their empty runs.  Two face groups halve the
// chain, the bbox cull turns most tests into four compares, staging takes
// one barrier a piece, and the launch bound (kSweepBlocks blocks of 512
// threads an SM, 40 registers) keeps enough empty runs in flight to write
// at the memory's rate.  The shape is forward_blocks.sweep_shape.
//
// A run of more than `piece` visits (kSweepPiece on the main path) is cut
// into ceil(n / piece) pieces of consecutive visits, a block each, the
// load balancing of split-K: no block sweeps more than `piece` visits, so
// the busy runs' work spreads over the SMs (PERF.md: K1 alone at 32 x
// 512^2 5.8 -> 2.9 ms on an H100).
// Piece k sweeps visits [k * piece, (k + 1) * piece) with the same walk
// and stores its partial winner (depth, original index, table row) a
// pixel: piece 0 in its run's own state slice, piece k > 0 in the scratch
// slot the plan gave it.  The block then takes a ticket on its run; the
// run's last block merges the pieces' partial winners in piece order by
// the same lexicographic test, which among one image's covered fragments
// is a total order (the original index is unique), so every split picks
// the winner one block walking the run picks.  It then tests the winning
// row at the pixel centre again (test_face: the same expression, so the
// same E0..E2, S_w and depth bits) and writes the state.  A run of at most
// `piece` visits takes the path above, unchanged.
//
// The plan (raster_sweep_kernel_plan, one block an image, launched first)
// scans the image's counts into the extra pieces' slots: run bt's pieces
// 1 .. ceil(n / piece) - 1 take slots first[bt] .., consecutively, and
// map[slot] = bt (-1 for the unused slots); it zeroes the tickets.  The
// sweep's grid is sized from shapes alone: the extra slots (an image's
// n sum to at most its S slots, so it has at most (S - 1) / piece extra
// pieces), then the runs; an unused slot's block retires at once.  The
// extra pieces come first in the grid, so they start before the empty
// runs.
//
// Built with -fmad=false and IEEE division: every product rounds as in
// eager PyTorch, so the state equals the plain version's
// (forward_blocks.raster_sweep_plain) bit for bit, except that a -0.0 the
// plain version's pick sum turns into +0.0 may stay -0.0 here.

#include <cuda_runtime.h>

#include "slots.cuh"
#include "sweep_math.cuh"

namespace {

// Visits a block of K1 sweeps at most on the main path
// (forward_blocks.SWEEP_PIECE).
constexpr int kSweepPiece = 32;
static_assert(kSweepPiece <= dirt::kSweepThreads,
              "a piece fits one fill of the main shape's visit list");
constexpr int kPlanThreads = 1024;

// A piece's partial winner a pixel: depth, original index and table row
// (as int bits), each a row of `pix` floats.
struct PartialEpilogue {
  float* depth;
  float* orig;
  int* rows;

  // A piece has at least one visit, so sweep_run never calls it.
  __device__ void background() const {}
  __device__ void winner(const dirt::Winner& w, int p, int, int) const {
    depth[p] = w.depth;
    orig[p] = w.orig;
    rows[p] = (int)w.row;
  }
};

// Takes the partial winner (depth, orig, row) if it covers the pixel
// nearer than w, or as near with a smaller original index (sweep_math.cuh's
// test).
__device__ __forceinline__ void take_partial(dirt::Winner& w, float depth,
                                             float orig, int row) {
  if (depth < w.depth || (depth == w.depth && orig < w.orig)) {
    w.depth = depth;
    w.orig = orig;
    w.row = row;
  }
}

// The run's last block: merges the `pieces` partial winners of each pixel
// (piece 0's in the state slice `out`, pieces 1 .. at `extra`, 3 x pix
// floats each) in piece order, tests the winning row again at the pixel
// centre and writes the state.  The partials were stored by other blocks:
// read through L2.
__device__ void merge_pieces(const float* table, int width_d, int channels,
                             float* out, const float* extra, int pieces,
                             int pix, int row0, int col0, int tile_w,
                             int height, int width, float sx, float sy) {
  for (int p = threadIdx.x; p < pix; p += blockDim.x) {
    dirt::Winner w;
    take_partial(w, __ldcg(out + (channels + 7) * pix + p),
                 __ldcg(out + (channels + 8) * pix + p),
                 __ldcg(reinterpret_cast<const int*>(out) + p));
    for (int k = 1; k < pieces; ++k) {
      const float* part = extra + (long long)(k - 1) * 3 * pix;
      take_partial(w, __ldcg(part + p), __ldcg(part + pix + p),
                   __ldcg(reinterpret_cast<const int*>(part + 2 * pix) + p));
    }
    dirt::Winner won;
    if (w.row >= 0) {
      const int row = row0 + p / tile_w;
      const int col = col0 + p % tile_w;
      const dirt::Pixel px = dirt::pixel_at(row, col, height, width, sx, sy);
      dirt::test_face(table + w.row * width_d, px.xg, px.yg, w.row, won);
    }
    dirt::write_state(table, width_d, channels, won, out + p, pix);
  }
}

// One block an image: run bt of the image takes extra pieces'
// slots first[bt] .. first[bt] + (n - 1) / piece - 1 (n > piece), in run
// order from the image's first slot b * extras; map[slot] = bt, -1 past the
// image's last; tickets[bt] = 0.
__global__ void __launch_bounds__(kPlanThreads) raster_sweep_kernel_plan(
    const int* __restrict__ counts, int num_tiles, int piece, int extras,
    int* __restrict__ first, int* __restrict__ map, int* __restrict__ tickets) {
  __shared__ int sums[32];
  __shared__ int carry;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int t0 = 0; t0 < num_tiles; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const long long bt = (long long)b * num_tiles + t;
    const int n = t < num_tiles ? counts[bt] : 0;
    const int x = n > piece ? (n - 1) / piece : 0;
    int incl = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int s = lane < warps ? sums[lane] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, s, d);
        if (lane >= d) s += v;
      }
      sums[lane] = s;
    }
    __syncthreads();
    const int excl = carry + (warp > 0 ? sums[warp - 1] : 0) + incl - x;
    if (t < num_tiles) {
      tickets[bt] = 0;
      const int slot = b * extras + excl;
      first[bt] = slot;
      // The image's n sum to at most S, so excl + x <= extras.
      for (int i = 0; i < x && excl + i < extras; ++i) map[slot + i] = (int)bt;
    }
    __syncthreads();
    if (threadIdx.x == 0) carry += sums[warps - 1];
    __syncthreads();
  }
  for (int j = carry + threadIdx.x; j < extras; j += blockDim.x) {
    map[b * extras + j] = -1;
  }
}

// kMaxThreads / kMinBlocks: the launch bound, (kSweepThreads, kSweepBlocks)
// for the shapes sweep_shape gives up to kSweepThreads threads, (1024, 1)
// for a group of more (tiles of more than kSweepThreads pixels).  Blocks
// [0, slots) are the extra pieces' slots, block slots + bt run bt's piece 0.
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks) raster_sweep_kernel(
    const float* __restrict__ table,      // [B*NB, chunk, width_d]
    const int* __restrict__ starts,       // [B*T]
    const int* __restrict__ counts,       // [B*T]
    const int* __restrict__ block_ids,    // [B*S], batch-folded
    float* __restrict__ state,            // [B*T, C+9, PIX]
    const int* __restrict__ first,        // [B*T], the plan's
    const int* __restrict__ map,          // [slots], the plan's
    int* __restrict__ tickets,            // [B*T]
    float* __restrict__ partials,         // [slots, 3, PIX]
    int slots, int piece, int num_tiles, int tiles_x, int tile_h, int tile_w,
    int chunk, int width_d, int channels, int height, int width, float sx,
    float sy, dirt::SweepShape shape) {
  extern __shared__ __align__(16) float smem[];
  int bt, k;
  if ((int)blockIdx.x < slots) {
    bt = map[blockIdx.x];
    if (bt < 0) return;
    k = blockIdx.x - first[bt] + 1;
  } else {
    bt = blockIdx.x - slots;
    k = 0;
  }
  const int tile = bt % num_tiles;
  const int pix = tile_h * tile_w;
  const int n = counts[bt];
  float* out = state + (long long)bt * (channels + 9) * pix;
  if (n == 0) {
    dirt::write_background(out, channels, pix);
    return;
  }
  const int row0 = (tile / tiles_x) * tile_h;
  const int col0 = (tile % tiles_x) * tile_w;
  const dirt::StagedFaces<false> faces{table, chunk, width_d};
  if (n <= piece) {
    dirt::CsrFill fill{block_ids + starts[bt], n, shape.list, 0};
    dirt::sweep_run(fill, faces,
                    dirt::StateEpilogue{table, width_d, channels, out, pix},
                    shape, smem, row0, col0, tile_w, pix, height, width, sx,
                    sy);
    return;
  }
  const int v0 = k * piece;
  dirt::CsrFill fill{block_ids + starts[bt] + v0, min(piece, n - v0),
                     shape.list, 0};
  // Piece k > 0's partial is slot first[bt] + k - 1's.
  float* extra = partials + (long long)first[bt] * 3 * pix;
  float* part = k == 0 ? out + (channels + 7) * pix
                       : extra + (long long)(k - 1) * 3 * pix;
  const PartialEpilogue partial =
      k == 0 ? PartialEpilogue{part, part + pix, reinterpret_cast<int*>(out)}
             : PartialEpilogue{part, part + pix,
                               reinterpret_cast<int*>(part + 2 * pix)};
  dirt::sweep_run(fill, faces, partial, shape, smem, row0, col0, tile_w, pix,
                  height, width, sx, sy);
  // The ticket: the partial is visible to every block before the run's
  // counter moves; the block that moves it last merges.
  int* last = reinterpret_cast<int*>(smem + shape.region) + shape.list;
  const int pieces = (n + piece - 1) / piece;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(tickets + bt, 1) == pieces - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  merge_pieces(table, width_d, channels, out, extra, pieces, pix, row0, col0,
               tile_w, height, width, sx, sy);
}

}  // namespace

// `piece`: the visits a block sweeps at most (kSweepPiece, or fewer to test
// the split); `slots`: the extra pieces' slots, B * ((S - 1) / piece), 0
// where no run can be split (then first, map, tickets and partials are not
// read and the plan is not launched).
extern "C" int dirt_raster_sweep(
    const float* table, const int* starts, const int* counts,
    const int* block_ids, float* state, int* first, int* map, int* tickets,
    float* partials, int runs, int slots, int piece, int num_tiles,
    int tiles_x, int tile_h, int tile_w, int chunk, int width_d,
    int channels, float sx, float sy, int height, int width, int groups,
    int cap, int region, int list, int vec16, int smem,
    cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  if (slots > 0) {
    const int images = runs / num_tiles;
    raster_sweep_kernel_plan<<<images, kPlanThreads, 0, stream>>>(
        counts, num_tiles, piece, slots / images, first, map, tickets);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const dirt::SweepShape shape{groups, cap, region, list, vec16};
  const int threads = groups * tile_h * tile_w;
  auto kernel = threads <= dirt::kSweepThreads
                    ? raster_sweep_kernel<dirt::kSweepThreads,
                                          dirt::kSweepBlocks>
                    : raster_sweep_kernel<1024, 1>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  }
  kernel<<<slots + runs, threads, smem, stream>>>(
      table, starts, counts, block_ids, state, first, map, tickets, partials,
      slots, piece, num_tiles, tiles_x, tile_h, tile_w, chunk, width_d,
      channels, height, width, sx, sy, shape);
  return (int)cudaGetLastError();
}
