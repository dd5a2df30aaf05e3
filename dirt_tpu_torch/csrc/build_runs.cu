// build_runs: the CSR runs of the blocks schedules, laid out from the
// [B, R, I] block hits without a sort.
//
// Replaces no Pallas kernel: dirt_tpu's build_runs
// (dirt_tpu/ops/forward_blocks.py) is plain jnp, a stable argsort (or a
// cumsum rank) and a scatter that XLA compiles.  Its PyTorch form
// (forward_blocks.build_runs_plain, kept as the CPU path and the
// reference) sorted every row of the hits only to compact it, made int64
// orders and positions of B x R x I entries and scattered all of them,
// twice a step: the forward's runs are tiles over blocks, the gradient's
// are blocks over tiles, read from the transposed view of the same hits.
//
// What bounds it on the H100: the bytes of the hits, one an entry (64 MiB
// a call at 32 views of 512^2 and 65,536 faces), and the live ids it
// writes (about 0.2% of the entries there).  So:
//
//  * Two launches of one kernel.  kCompact = false counts each run's live
//    items into n [B, R]; the wrapper's cumsum of that small array gives
//    the starts and counts, clamped by the slot budget as the plain
//    version clamps them; kCompact = true stores each run's live item ids,
//    ascending, from its start, `counts` of them, into an output the
//    wrapper zero-filled.  Each hit byte is read at most twice (once a
//    launch; a warp of the second stops once its runs' counts are
//    stored), and only the live ids are written: no sort, no int64
//    array, no [B, R, I] temporary.
//  * Either orientation, coalesced, read in place.  A warp walks a group
//    of runs of one image along their items, step by step; each step is
//    32 loads of V adjacent bytes a lane (V = 4 where the view's strides
//    and address allow whole words, else 1), all issued before the first
//    is used, each a warp's 32 V adjacent bytes.  Where the items have the
//    smaller stride (the forward's rows: `kRow`), load k reads 32 V
//    adjacent items of run k of the warp's 32, and V ballots hand run k's
//    bits to lane k, which interleaves them into item order; where the
//    runs have it (the gradient's transposed view), load k reads 32 V
//    adjacent runs at item k of the step's 32, and each lane sets the
//    bits of its own V runs.
//  * Ranks without a prefix.  A lane owns its runs: a run's count is the
//    sum of its masks' __popc, and in the compact launch its next slot is
//    a register carried along the run, each set bit (__ffs, ascending
//    item order) stored at it.  The outputs are the plain version's bit
//    for bit, truncated tails included.
//
// Launch: thread blocks of kThreads threads, a warp a group of 32 runs
// (kRow) or 32 V runs, an image's groups consecutive; dirt_build_runs
// sizes the grid from the layout forward_blocks.runs_layout chose.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// One image's hits: byte (r, i) of image b at hit + b sb + r sr + i si.
struct Hits {
  const unsigned char* hit;
  long long sb, sr, si;
  int runs, items, groups;
};

// A warp's walk: lanes read V adjacent items of one of its 32 runs
// (kRow) or V adjacent runs at one of the step's 32 items.  A lane owns
// kRuns runs and gets kWords masks of 32 items of each a step.
template <int V, bool kRow>
struct Walk {
  static constexpr int kRuns = kRow ? 1 : V;
  static constexpr int kWords = kRow ? V : 1;
  static constexpr int kGroup = kRow ? kWarp : kWarp * V;   // runs a warp
  static constexpr int kStep = kRow ? kWarp * V : kWarp;    // items a step
};

template <int V>
__device__ __forceinline__ unsigned load_word(const unsigned char* p) {
  if constexpr (V == 4)
    return *reinterpret_cast<const unsigned*>(p);
  else
    return *p;
}

__device__ __forceinline__ bool byte_set(unsigned word, int t) {
  return ((word >> (8 * t)) & 0xffu) != 0u;
}

// Bits 0..7 of x to bits 0, 4, ..., 28.
__device__ __forceinline__ unsigned spread4(unsigned x) {
  x &= 0xffu;
  x = (x | (x << 12)) & 0x000f000fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// The step's masks of the lane's runs: m[u][q] has bit j for item
// i0 + 32 q + j of run u (run r0 + lane for kRow, r0 + V lane + u
// otherwise), zero past the image's runs and items.
template <int V, bool kRow>
__device__ __forceinline__ void step_masks(
    const Hits& h, const unsigned char* image, int r0, int i0, int lane,
    unsigned (&m)[Walk<V, kRow>::kRuns][Walk<V, kRow>::kWords]) {
  unsigned w[kWarp];
  if constexpr (kRow) {
    const int i = i0 + V * lane;
    const int rows = min(kWarp, h.runs - r0);
    const unsigned char* at =
        image + (long long)r0 * h.sr + (long long)i * h.si;
#pragma unroll
    for (int k = 0; k < kWarp; ++k)
      w[k] = (k < rows && i < h.items) ? load_word<V>(at + k * h.sr) : 0u;
    // Ballot t of load k: bit j for item i0 + V j + t of run r0 + k.
    unsigned b[V];
#pragma unroll
    for (int t = 0; t < V; ++t) b[t] = 0u;
#pragma unroll
    for (int k = 0; k < kWarp; ++k) {
#pragma unroll
      for (int t = 0; t < V; ++t) {
        const unsigned vote = __ballot_sync(kFull, byte_set(w[k], t));
        if (lane == k) b[t] = vote;
      }
    }
    // Word q holds items i0 + 32 q .. + 31: ballot bits 8 q .. 8 q + 7,
    // each item V j + t at bit V (j - 8 q) + t.
#pragma unroll
    for (int q = 0; q < V; ++q) {
      if constexpr (V == 1) {
        m[0][q] = b[0];
      } else {
        unsigned word = 0u;
#pragma unroll
        for (int t = 0; t < V; ++t) word |= spread4(b[t] >> (8 * q)) << t;
        m[0][q] = word;
      }
    }
  } else {
    const int r = r0 + V * lane;
    const int cols = min(kWarp, h.items - i0);
    const unsigned char* at =
        image + (long long)r * h.sr + (long long)i0 * h.si;
#pragma unroll
    for (int k = 0; k < kWarp; ++k)
      w[k] = (k < cols && r < h.runs) ? load_word<V>(at + k * h.si) : 0u;
#pragma unroll
    for (int u = 0; u < V; ++u) {
      unsigned mask = 0u;
#pragma unroll
      for (int k = 0; k < kWarp; ++k)
        mask |= (unsigned)byte_set(w[k], u) << k;
      m[u][0] = mask;
    }
  }
}

template <int V, bool kRow, bool kCompact>
__global__ void __launch_bounds__(kThreads) build_runs_kernel(
    Hits h, int* __restrict__ n, const int* __restrict__ starts,
    const int* __restrict__ counts, int* __restrict__ ids, int num_slots,
    long long warps) {
  using W = Walk<V, kRow>;
  const long long w =
      (long long)blockIdx.x * (kThreads / kWarp) + threadIdx.x / kWarp;
  if (w >= warps) return;   // a whole warp
  const int lane = threadIdx.x % kWarp;
  const int b = (int)(w / h.groups);
  const int r0 = (int)(w % h.groups) * W::kGroup;
  const unsigned char* image = h.hit + (long long)b * h.sb;
  const int first = kRow ? r0 + lane : r0 + V * lane;   // the lane's runs
  const long long at = (long long)b * h.runs + first;
  unsigned m[W::kRuns][W::kWords];
  if constexpr (!kCompact) {
    int count[W::kRuns];
#pragma unroll
    for (int u = 0; u < W::kRuns; ++u) count[u] = 0;
    for (int i0 = 0; i0 < h.items; i0 += W::kStep) {
      step_masks<V, kRow>(h, image, r0, i0, lane, m);
#pragma unroll
      for (int u = 0; u < W::kRuns; ++u)
#pragma unroll
        for (int q = 0; q < W::kWords; ++q) count[u] += __popc(m[u][q]);
    }
#pragma unroll
    for (int u = 0; u < W::kRuns; ++u)
      if (first + u < h.runs) n[at + u] = count[u];
  } else {
    // starts[r] + counts[r] <= num_slots: the stores stay in the budget.
    int left[W::kRuns], slot[W::kRuns];
    bool any = false;
#pragma unroll
    for (int u = 0; u < W::kRuns; ++u) {
      left[u] = first + u < h.runs ? counts[at + u] : 0;
      slot[u] = left[u] > 0 ? starts[at + u] : 0;
      any |= left[u] > 0;
    }
    int* out = ids + (long long)b * num_slots;
    for (int i0 = 0; i0 < h.items && __any_sync(kFull, any);
         i0 += W::kStep) {
      step_masks<V, kRow>(h, image, r0, i0, lane, m);
      any = false;
#pragma unroll
      for (int u = 0; u < W::kRuns; ++u) {
#pragma unroll
        for (int q = 0; q < W::kWords; ++q)
          for (unsigned mask = m[u][q]; mask != 0u && left[u] > 0;
               mask &= mask - 1u, --left[u])
            out[slot[u]++] = i0 + kWarp * q + __ffs(mask) - 1;
        any |= left[u] > 0;
      }
    }
  }
}

template <int V, bool kRow>
int launch(const Hits& h, int* n, const int* starts, const int* counts,
           int* ids, int num_slots, int batch, int compact,
           cudaStream_t stream) {
  Hits g = h;
  g.groups = (h.runs + Walk<V, kRow>::kGroup - 1) / Walk<V, kRow>::kGroup;
  const long long warps = (long long)g.groups * batch;
  const long long blocks =
      (warps + kThreads / kWarp - 1) / (kThreads / kWarp);
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (compact)
    build_runs_kernel<V, kRow, true>
        <<<(unsigned int)blocks, kThreads, 0, stream>>>(
            g, n, starts, counts, ids, num_slots, warps);
  else
    build_runs_kernel<V, kRow, false>
        <<<(unsigned int)blocks, kThreads, 0, stream>>>(
            g, n, starts, counts, ids, num_slots, warps);
  return (int)cudaGetLastError();
}

}  // namespace

// lanes_on_items and width (V, 1 or 4) are forward_blocks.runs_layout's;
// a width of 4 needs word-aligned words that never straddle two runs
// (kRow) or two items.
extern "C" int dirt_build_runs(
    const unsigned char* hit, int* n, const int* starts, const int* counts,
    int* ids, int batch, int runs, int items, long long sb, long long sr,
    long long si, int num_slots, int lanes_on_items, int width,
    int compact, cudaStream_t stream) {
  if (batch < 0 || runs < 0 || items < 0 || num_slots < 0 ||
      (width != 1 && width != 4))
    return (int)cudaErrorInvalidValue;
  if (width == 4) {
    const long long along = lanes_on_items ? si : sr;
    const long long across = lanes_on_items ? sr : si;
    const int length = lanes_on_items ? items : runs;
    if (along != 1 || across % 4 != 0 || sb % 4 != 0 || length % 4 != 0 ||
        reinterpret_cast<unsigned long long>(hit) % 4 != 0)
      return (int)cudaErrorInvalidValue;
  }
  const Hits h{hit, sb, sr, si, runs, items, 0};
  if (lanes_on_items)
    return width == 4 ? launch<4, true>(h, n, starts, counts, ids, num_slots,
                                        batch, compact, stream)
                      : launch<1, true>(h, n, starts, counts, ids, num_slots,
                                        batch, compact, stream);
  return width == 4 ? launch<4, false>(h, n, starts, counts, ids, num_slots,
                                       batch, compact, stream)
                    : launch<1, false>(h, n, starts, counts, ids, num_slots,
                                       batch, compact, stream);
}
