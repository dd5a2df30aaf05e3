// K10: mxu_grad -- the "mxu" gradient's masked sums as bf16 tensor-core
// matrix products.
//
// Replaces dirt_tpu/ops/grad_mxu.py:_grad_kernel (per (image, band, face
// chunk): masks [2*CHUNK, PIX] of the chunk's face ids against the band's
// post- and pre-dilation face-id planes, times the band's value planes
// [PIX, P] split into bf16 hi/mid/lo groups, three MXU passes accumulated in
// f32; zeros for dead chunks).
//
// Work: one cluster of kSplit blocks of kWarps warps per (image, band)
// -- or, where a band's list has more chunks than a block holds (kWarps *
// kTiles row tiles of 16 mask rows), per group of `chunks` chunks -- and
// each block of the cluster takes an equal share of the band's pixels, so
// each value tile is staged once for all the live chunks it serves.  A
// block's mask rows (2*chunk a chunk: the post-dilation rows of its
// faces, then the pre-dilation rows) fall into m16 row tiles, dealt to the
// warps in turn, at most kTiles a warp, each warp holding its tiles' f32
// accumulators in registers.  Chunks at or past the band's hit count are
// dead: rank 0 writes their rows as zeros (the rows scatter through
// sorted_orig, so they must be zeros).  A block's pixels stream through a
// ring of kDepth stages of kSlice pixels (grad_mxu.mxu_shape), fed by
// 16-byte cp.async copies: the two id planes (f32) and the three split
// groups' value rows (bf16, plane-major [3, P, PIX], so a column's pixels
// are contiguous); one barrier a stage.  At the end each block leaves its
// partial fragments in its shared memory and the block of rank tile %
// kSplit sums the cluster's partials of the tile, rank by rank, through
// distributed shared memory and writes the rows.
//
// The mask is sparse (a pixel matches at most one listed face before and
// one after the dilation), so most row tiles have nothing to add at most
// k-steps of 16 pixels.  The block sorts its faces by id once (a bitonic
// sort in shared memory); when a stage lands, kSteps warps look each of
// its pixels' ids up (a binary search) and mark, per k-step, the row
// tiles some pixel falls in, a 64-bit mask combined across the lanes by
// shuffles (no atomics).  The products lag one stage behind the marks, so
// the stage's one barrier also publishes them.  A warp then skips a
// k-step on a bit test unless one of its tiles is marked; for a marked
// tile each lane builds its A fragments of mma.sync.m16n8k16 in
// registers, straight from its four pixels' ids and its two rows' face
// ids ({0, 1} in bf16; -1 background, -2 a pixel past the image and -3 a
// padded list entry match nothing), so the mask never touches shared
// memory, and reads its B fragments from the staged rows (padded to kRow,
// so the 32 lanes hit 32 banks), the hi, mid and lo groups in turn into
// the same accumulators.  A skipped tile would have added exact zeros.
// Columns go in n8 tiles, kN8 (32 columns) a pass: the bench's 27 columns
// take 32, and the accumulators are written straight from the fragments,
// only the real columns.
//
// A mask entry times a bf16 value is exact and the tensor cores accumulate
// in f32, so the rows differ from the plain version (mxu_grad_plain: three
// f32 matmuls) only by summation order; each row's order is fixed (pixel
// order and group within a block, then rank order), so two calls give
// the same bits.  A face is listed once a band
// (grad_mxu._pack_grad_bands' lists).
//
// What bounds it on the H100: the bytes (the bf16 value planes and the
// ids of every band, each read once, and the rows) more than the products
// on the bf16 tensor cores (989 TFLOP/s); the products the mask needs are
// few.  What the design spends is the stream of a band's stages, the
// marks and the tests; one block fills an SM (512 threads at ~125
// registers), so the clusters of the busiest bands set the time, and a
// split of two blocks a band beat one, four and eight at the bench
// (PERF.md).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 16;              // grad_mxu.WARPS
constexpr int kTiles = 4;               // m16 row tiles a warp: grad_mxu.TILES
constexpr int kSplit = 2;               // blocks a cluster: grad_mxu.SPLIT
constexpr int kDepth = 4;               // ring stages: grad_mxu.DEPTH
constexpr int kN8 = 4;                  // n8 column tiles a pass (32 columns)
constexpr int kSlice = 64;              // pixels a stage
constexpr int kSteps = kSlice / 16;     // k-steps a stage
constexpr int kRow = kSlice + 8;        // bf16 a staged value row, padded
constexpr int kIdBytes = 2 * kSlice * 4;
constexpr int kStageBytes = kIdBytes + 3 * kN8 * 8 * kRow * 2;   // 14336
constexpr int kMaxFaces = kWarps * kTiles * 8;   // 512, one per thread
// After the ring: the sorted face ids, their list positions, and the
// marks of two stages ([2][kSteps][2] words).
constexpr int kTableBytes = kMaxFaces * 8 + 2 * kSteps * 2 * 4;  // 4160
// The partial rows a block hands its cluster, in the ring's place:
// [tile][lane][kN8 * 4] floats.
constexpr int kCombineBytes = kWarps * kTiles * 32 * kN8 * 4 * 4;  // 131072
// Bytes of shared memory before the table: the ring, or the partial rows
// where they take more.
constexpr int kRingBytes =
    kCombineBytes > kDepth * kStageBytes ? kCombineBytes
                                         : kDepth * kStageBytes;
static_assert(kSteps <= kWarps, "a warp marks each k-step of a stage");
static_assert(kSplit >= 2 && kSplit <= 8, "a cluster of 2 to 8 blocks");
static_assert(kDepth >= 3, "the ring runs two stages ahead of the products");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src) : "memory");
}

// Waits until at most kDepth - 3 of this thread's copy groups are in
// flight.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 3) : "memory");
}

// Two bf16 mask entries (low half: the first pixel): 1.0 where the id is
// the face's.
__device__ __forceinline__ uint32_t mask2(float2 id, float face) {
  return (id.x == face ? 0x3F80u : 0u) | (id.y == face ? 0x3F800000u : 0u);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The block's list position of face `id` (keys: the block's face ids in
// ascending order, +inf past them; slots: each key's position), or -1.
__device__ __forceinline__ int find_face(const float* keys, const int* slots,
                                         float id) {
  int lo = 0, hi = kMaxFaces;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < id) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < kMaxFaces && keys[lo] == id ? slots[lo] : -1;
}

__global__ void __launch_bounds__(kWarps * 32, 1) mxu_grad_kernel(
    const float* __restrict__ face_ids,    // [B*bands, NC*chunk]
    const int* __restrict__ counts,        // [B*bands]
    const float* __restrict__ ids,         // [B*bands, 2, pix]
    const uint16_t* __restrict__ values,   // [B*bands, 3, ncols, pix] bf16
    float* __restrict__ out,               // [B*bands*NC, 2*chunk, ncols]
    int num_chunks, int chunk, int pix, int ncols, int chunks) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* keys = reinterpret_cast<float*>(smem + kRingBytes);
  int* slots = reinterpret_cast<int*>(keys + kMaxFaces);
  uint32_t* marks = reinterpret_cast<uint32_t*>(slots + kMaxFaces);
  // Block (item, rank): the cluster of kSplit blocks of one item (a
  // band's group of `chunks` chunks) shares its pixels, rank r the r-th
  // share.
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)(blockIdx.x % kSplit);
  const long long item = blockIdx.x / kSplit;
  const int groups = (num_chunks + chunks - 1) / chunks;
  const long long band = item / groups;
  const int first = (int)(item % groups) * chunks;
  const int last = min(num_chunks, first + chunks);
  const int live_end =
      max(first, min(last, (counts[band] + chunk - 1) / chunk));
  const long long chunk_rows = 2LL * chunk * ncols;   // floats a chunk
  float* band_out = out + band * num_chunks * chunk_rows;
  if (rank == 0) {
    for (long long j = live_end * chunk_rows + threadIdx.x;
         j < last * chunk_rows; j += blockDim.x) {
      band_out[j] = 0.0f;
    }
  }
  if (live_end == first) return;   // the whole cluster

  // This warp's row tiles: warp, warp + kWarps, ... of the live chunks'.
  const int tiles_per_chunk = chunk / 8;
  const int post_tiles = chunk / 16;   // then as many pre-dilation tiles
  const int n_tiles = (live_end - first) * tiles_per_chunk;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const float* block_faces = face_ids + (band * num_chunks + first) * chunk;
  float face_a[kTiles], face_b[kTiles];   // the faces of rows gid, gid + 8
  bool pre[kTiles];                       // pre-dilation rows
  int mine = 0;
#pragma unroll
  for (int m = 0; m < kTiles; ++m) {
    const int tile = warp + m * kWarps;
    face_a[m] = face_b[m] = -3.0f;
    pre[m] = false;
    if (tile < n_tiles) {
      mine = m + 1;
      const int j = tile % tiles_per_chunk;
      const int f0 = tile / tiles_per_chunk * chunk + (j % post_tiles) * 16;
      pre[m] = j >= post_tiles;
      face_a[m] = block_faces[f0 + gid];
      face_b[m] = block_faces[f0 + gid + 8];
    }
  }

  // The block's faces sorted by id, one per thread (a bitonic sort; padded
  // entries, -3, become +inf and sort last).
  {
    const int i = threadIdx.x;
    const int n_faces = (live_end - first) * chunk;
    const float f = i < n_faces ? block_faces[i] : -3.0f;
    keys[i] = f < 0.0f ? __int_as_float(0x7f800000) : f;
    slots[i] = i;
    for (int k = 2; k <= kMaxFaces; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        __syncthreads();
        const int l = i ^ j;
        if (l > i) {
          const float a = keys[i], b = keys[l];
          if ((i & k) == 0 ? a > b : a < b) {
            keys[i] = b;
            keys[l] = a;
            const int t = slots[i];
            slots[i] = slots[l];
            slots[l] = t;
          }
        }
      }
    }
  }

  const float* band_ids = ids + band * 2 * pix;
  const uint16_t* band_vals = values + band * 3 * ncols * (long long)pix;
  // This block's stages: slices s0 .. s0 + n_slices - 1 of the band's.
  const int band_slices = (pix + kSlice - 1) / kSlice;
  const int s0 = rank * band_slices / kSplit;
  const int n_slices = (rank + 1) * band_slices / kSplit - s0;
  for (int col0 = 0; col0 < ncols; col0 += kN8 * 8) {
    const int pass_cols = min(kN8 * 8, ncols - col0);
    const int n8 = (pass_cols + 7) / 8;
    // Value rows past the pass's columns stay zero in every stage.
    const int pad_words = (kN8 * 8 - pass_cols) * kRow / 2;
    for (int j = threadIdx.x; j < kDepth * 3 * pad_words;
         j += blockDim.x) {
      const int s = j / (3 * pad_words), rest = j % (3 * pad_words);
      const int g = rest / pad_words, w = rest % pad_words;
      reinterpret_cast<uint32_t*>(smem + s * kStageBytes + kIdBytes)
          [(g * kN8 * 8 + pass_cols) * kRow / 2 + w] = 0u;
    }

    // Stage s: pixels (s0 + s) * kSlice .. of both id planes and the pass's
    // value rows; past the band, ids -2 and values 0.
    auto stage = [&](int s) {
      unsigned char* base = smem + (s % kDepth) * kStageBytes;
      float* sid = reinterpret_cast<float*>(base);
      uint16_t* sval = reinterpret_cast<uint16_t*>(base + kIdBytes);
      const int p0 = (s0 + s) * kSlice;
      const int n_px = min(kSlice, pix - p0);   // a multiple of 8
      const int id_vecs = 2 * kSlice / 4;
      for (int j = threadIdx.x; j < id_vecs + 3 * pass_cols * (kSlice / 8);
           j += blockDim.x) {
        if (j < id_vecs) {
          const int plane = j / (kSlice / 4), v = j % (kSlice / 4);
          float* d = sid + plane * kSlice + 4 * v;
          if (4 * v < n_px) {
            cp_async16(d, band_ids + (long long)plane * pix + p0 + 4 * v);
          } else {
            *reinterpret_cast<float4*>(d) = make_float4(-2.f, -2.f, -2.f,
                                                        -2.f);
          }
        } else {
          const int k = j - id_vecs, vecs = kSlice / 8;   // vectors a row
          const int g = k / (pass_cols * vecs), rest = k % (pass_cols * vecs);
          const int n = rest / vecs, v = rest % vecs;
          uint16_t* d = sval + (g * kN8 * 8 + n) * kRow + 8 * v;
          if (8 * v < n_px) {
            cp_async16(d, band_vals + ((long long)g * ncols + col0 + n) * pix +
                              p0 + 8 * v);
          } else {
            *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      }
    };

    // Warp k < kSteps marks the row tiles k-step k of stage s touches:
    // lanes 0-15 look up the post-dilation ids of its 16 pixels, lanes
    // 16-31 the pre-dilation ids.
    auto mark = [&](int s) {
      if (warp >= kSteps) return;
      const float* sid = reinterpret_cast<const float*>(
          smem + (s % kDepth) * kStageBytes);
      const int plane = lane >> 4;
      const float id = sid[plane * kSlice + warp * 16 + (lane & 15)];
      uint32_t bits[2] = {0u, 0u};
      if (id >= 0.0f) {
        const int f = find_face(keys, slots, id);
        if (f >= 0) {
          const int tile = f / chunk * tiles_per_chunk + plane * post_tiles +
                           f % chunk / 16;
          bits[tile >> 5] = 1u << (tile & 31);
        }
      }
#pragma unroll
      for (int m = 16; m >= 1; m >>= 1) {
        bits[0] |= __shfl_xor_sync(0xffffffffu, bits[0], m);
        bits[1] |= __shfl_xor_sync(0xffffffffu, bits[1], m);
      }
      if (lane == 0) {
        marks[((s & 1) * kSteps + warp) * 2] = bits[0];
        marks[((s & 1) * kSteps + warp) * 2 + 1] = bits[1];
      }
    };

    float acc[kTiles][kN8][4];
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
#pragma unroll
      for (int n = 0; n < kN8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.0f;
      }
    }

    // The products of stage s's marked tiles.
    auto products = [&](int s) {
      const unsigned char* base = smem + (s % kDepth) * kStageBytes;
      const float* sid = reinterpret_cast<const float*>(base);
      const uint16_t* sval =
          reinterpret_cast<const uint16_t*>(base + kIdBytes);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        const uint32_t* mk = marks + ((s & 1) * kSteps + kk) * 2;
        unsigned hit = 0;   // this warp's marked tiles, bit m
#pragma unroll
        for (int m = 0; m < kTiles; ++m) {
          const int tile = warp + m * kWarps;
          if (m < mine && (mk[tile >> 5] >> (tile & 31) & 1u)) hit |= 1u << m;
        }
        if (hit == 0) continue;
        const int k0 = kk * 16;
        // This lane's pixels k0 + 2 tig (+1) and k0 + 2 tig + 8 (+9).
        const float2 post0 =
            *reinterpret_cast<const float2*>(sid + k0 + 2 * tig);
        const float2 post8 =
            *reinterpret_cast<const float2*>(sid + k0 + 2 * tig + 8);
        const float2 pre0 =
            *reinterpret_cast<const float2*>(sid + kSlice + k0 + 2 * tig);
        const float2 pre8 =
            *reinterpret_cast<const float2*>(sid + kSlice + k0 + 2 * tig + 8);
        uint32_t a[kTiles][4];
#pragma unroll
        for (int m = 0; m < kTiles; ++m) {
          if (!(hit >> m & 1u)) continue;
          const float2 x0 = pre[m] ? pre0 : post0;
          const float2 x8 = pre[m] ? pre8 : post8;
          a[m][0] = mask2(x0, face_a[m]);
          a[m][1] = mask2(x0, face_b[m]);
          a[m][2] = mask2(x8, face_a[m]);
          a[m][3] = mask2(x8, face_b[m]);
        }
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          uint32_t b[kN8][2];
#pragma unroll
          for (int n = 0; n < kN8; ++n) {
            const uint16_t* v =
                sval + (g * kN8 * 8 + n * 8 + gid) * kRow + k0 + 2 * tig;
            b[n][0] = *reinterpret_cast<const uint32_t*>(v);
            b[n][1] = *reinterpret_cast<const uint32_t*>(v + 8);
          }
#pragma unroll
          for (int m = 0; m < kTiles; ++m) {
            if (!(hit >> m & 1u)) continue;
#pragma unroll
            for (int n = 0; n < kN8; ++n) {
              if (n < n8) mma_bf16(acc[m][n], a[m], b[n]);
            }
          }
        }
      }
    };

    // The ring runs kDepth - 2 stages ahead of the marks and kDepth - 1
    // ahead of the products, which lag one stage: at step i stage i lands
    // and is marked, stage i - 1's products run, and stage i + kDepth - 2
    // goes into the slot stage i - 2 left.
    for (int s = 0; s < kDepth - 2; ++s) {
      if (s < n_slices) stage(s);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    for (int i = 0; i < n_slices; ++i) {
      cp_async_wait_ring();
      // Stage i has landed, stage i - 1's marks are written, and every
      // warp is done with stage i - 2 and its marks.
      __syncthreads();
      if (i + kDepth - 2 < n_slices) stage(i + kDepth - 2);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      mark(i);
      if (i > 0) products(i - 1);
    }
    __syncthreads();
    if (n_slices > 0) products(n_slices - 1);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // the ring is free; the next pass rewrites it

    // Rows gid and gid + 8 of tile m, columns 2 tig and 2 tig + 1 of each
    // n8 tile, straight from the fragments `v`.
    auto write_rows = [&](int m, const float (&v)[kN8][4]) {
      const int tile = warp + m * kWarps;
      float* rows = band_out +
                    (first + tile / tiles_per_chunk) * chunk_rows +
                    (long long)(tile % tiles_per_chunk) * 16 * ncols;
#pragma unroll
      for (int n = 0; n < kN8; ++n) {
        const int col = col0 + n * 8 + 2 * tig;
        if (n >= n8) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e < ncols) {
            rows[gid * ncols + col + e] = v[n][e];
            rows[(gid + 8) * ncols + col + e] = v[n][2 + e];
          }
        }
      }
    };
    // Each block leaves its partial fragments in its shared memory, and
    // the block of rank tile % kSplit sums the cluster's partials of the
    // tile in rank order, a fixed order, and writes them.
    float* part = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
      if (m >= mine) continue;
      float* p = part + ((warp + m * kWarps) * 32 + lane) * kN8 * 4;
#pragma unroll
      for (int n = 0; n < kN8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[n * 4 + e] = acc[m][n][e];
      }
    }
    cluster.sync();
#pragma unroll
    for (int m = 0; m < kTiles; ++m) {
      const int tile = warp + m * kWarps;
      if (m >= mine || tile % kSplit != rank) continue;
      float sum[kN8][4] = {};
      for (int q = 0; q < kSplit; ++q) {
        const float* p = cluster.map_shared_rank(part, q) +
                         (tile * 32 + lane) * kN8 * 4;
#pragma unroll
        for (int n = 0; n < kN8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[n][e] += p[n * 4 + e];
        }
      }
      write_rows(m, sum);
    }
    cluster.sync();   // the partials are read; the ring may be rewritten
  }
}

}  // namespace

extern "C" int dirt_mxu_grad(const float* face_ids, const int* counts,
                             const float* ids, const uint16_t* values,
                             float* out, int bands, int num_chunks, int chunk,
                             int pix, int ncols, int chunks, int smem,
                             cudaStream_t stream) {
  if (bands == 0 || num_chunks == 0) return (int)cudaGetLastError();
  if (chunk % 16 || chunks < 1 || chunks * (chunk / 8) > kWarps * kTiles ||
      smem < kRingBytes + kTableBytes || pix % 8) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mxu_grad_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned int)((long long)bands * kSplit *
                                       ((num_chunks + chunks - 1) / chunks)));
  config.blockDim = dim3(kWarps * 32);
  config.dynamicSmemBytes = (size_t)smem;
  config.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kSplit;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  config.attrs = &cluster;
  config.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, mxu_grad_kernel, face_ids, counts, ids,
                         values, out, num_chunks, chunk, pix, ncols, chunks);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
