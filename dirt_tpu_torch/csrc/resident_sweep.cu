// K5: resident_sweep -- the forward sweep with the image's face table
// resident in shared memory.
//
// Replaces dirt_tpu/ops/forward_blocks.py:_raster_kernel_fused_resident,
// the TPU's resident variant of the fused-CSR sweep: the image's whole
// face table arrives in VMEM once per image and each visit reads its face
// block by index instead of streaming it.
//
// Work: one thread block per (image, group of kResidentTiles tiles; the
// last group of an image may hold fewer).  A group in which no tile has a
// visit writes the background of each tile and retires without reading
// the table.  Else the block stages the image's table once by cp.async,
// only the kFaceFloats leading columns of each face (the test's columns,
// then the pixel bbox), and walks each tile of its group with
// sweep_math.cuh's sweep_run, K1's walk: the tile's CSR run of face blocks
// (block_ids[starts[bt] .. starts[bt] + counts[bt]], batch-folded) copied
// into a visit list in shared memory (slots.cuh's CsrFill), each visit's
// faces read in place from the resident table by the block's per-image
// index (ResidentFaces) and dealt to S face groups of one thread a pixel,
// a face tested only where its bbox holds the pixel, the groups' winners
// combined in group order, and write_state reading the winner's attribute
// columns from the global table.  Each tile's winner starts afresh, so the
// state equals K1's bit for bit.  Shared memory: the combine's (S - 1) x
// pix winners of 7 words, the visit list, then the resident table, which
// never overlap.
//
// What bounds it on the H100: as K1 (raster_sweep.cu), the empty tiles'
// state write (50 MB at the bench, 0.015 ms) and the busiest tile's chain
// of face tests on its SM.  The old design, one thread a pixel walking
// every face of a group of 8 tiles in turn, each block staging the whole
// 36-column table (73,728 bytes at the bench), took 0.156 ms at the bench
// (0.066 of it the staging of groups with no visit) and 0.245 on a scene
// with 5 busy tiles in a group (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// Here empty groups stage nothing, a busy tile's faces go to two groups
// and through the bbox cull, and a group is one tile (kResidentTiles, by
// trials), so busy tiles never wait on each other.  The table must fit the
// opt-in shared memory of one block (227 KB on the H100;
// forward_blocks.takes_resident decides on the whole rows, and
// resident_shape raises where the staged columns do not fit); a table of
// 1,536 faces (147,456 bytes staged) leaves one block an SM.
//
// Built with -fmad=false and IEEE division: the state equals the plain
// version's (forward_blocks.resident_sweep_plain) bit for bit.
//
// dirt_shared_memory_optin reports the limit the wrapper's budget reads.

#include <cuda_runtime.h>

#include "slots.cuh"
#include "sweep_math.cuh"

namespace {

// Tiles a block takes, chosen by trials (PERF.md);
// forward_blocks.RESIDENT_TILES mirrors it.
constexpr int kResidentTiles = 1;

// A run's faces read in place from the image's table, resident in shared
// memory at kFaceFloats floats a face: face k of visit v is row
// (list[v] - first) * chunk + k of it.
struct ResidentFaces {
  const float* resident;
  long long first;   // the image's first block (batch-folded)
  int chunk;

  // Tests group g's faces of the n visits of `list`; ends with a barrier.
  __device__ void sweep(const int* list, int n, float*,
                        const dirt::SweepShape& ss, int g,
                        const dirt::Pixel& px, dirt::Winner& w) const {
    for (int v = 0; v < n; ++v) {
      const long long base = (long long)list[v] * chunk;
      const float* vr =
          resident + (base - first * chunk) * dirt::kFaceFloats;
      for (int k = g; k < chunk; k += ss.groups) {
        dirt::test_staged(vr + k * dirt::kFaceFloats, base + k, px, w);
      }
    }
    __syncthreads();
  }
};

// Stages the kFaceFloats leading columns of `faces` rows of `src` (width_d
// floats apart) at dst, kFaceFloats floats a row; one commit group.
__device__ __forceinline__ void stage_table(float* dst, const float* src,
                                            int faces, int width_d,
                                            bool vec16) {
  if (vec16) {
    constexpr int kQuads = dirt::kFaceFloats / 4;
    for (int j = threadIdx.x; j < faces * kQuads; j += blockDim.x) {
      const int face = j / kQuads;
      const int c = (j - face * kQuads) * 4;
      dirt::cp_async16(dst + face * dirt::kFaceFloats + c,
                       src + (long long)face * width_d + c);
    }
  } else {
    for (int j = threadIdx.x; j < faces * dirt::kFaceFloats;
         j += blockDim.x) {
      const int face = j / dirt::kFaceFloats;
      dirt::cp_async4(dst + j, src + (long long)face * width_d +
                                   (j - face * dirt::kFaceFloats));
    }
  }
  dirt::cp_async_commit();
}

// kMaxThreads / kMinBlocks: the launch bound, as K1's.
template <int kMaxThreads, int kMinBlocks>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    resident_sweep_kernel(
        const float* __restrict__ table,      // [B*NB, chunk, width_d]
        const int* __restrict__ starts,       // [B*T]
        const int* __restrict__ counts,       // [B*T]
        const int* __restrict__ block_ids,    // [B*S], batch-folded
        float* __restrict__ state,            // [B*T, C+9, PIX]
        int blocks_per_image, int num_tiles, int tiles_x, int tile_h,
        int tile_w, int chunk, int width_d, int channels, int height,
        int width, float sx, float sy, dirt::SweepShape shape,
        int table_at) {
  extern __shared__ __align__(16) float smem[];
  const int groups = (num_tiles + kResidentTiles - 1) / kResidentTiles;
  const int image = blockIdx.x / groups;
  const int tile0 = (blockIdx.x - image * groups) * kResidentTiles;
  const int tiles = min(kResidentTiles, num_tiles - tile0);
  const int bt0 = image * num_tiles + tile0;
  const int pix = tile_h * tile_w;
  const long long stride = (long long)(channels + 9) * pix;
  const bool live = threadIdx.x < tiles && counts[bt0 + threadIdx.x] > 0;
  if (!__syncthreads_or(live)) {
    for (int t = 0; t < tiles; ++t) {
      dirt::write_background(state + (bt0 + t) * stride, channels, pix);
    }
    return;
  }
  float* resident = smem + table_at;
  const int faces = blocks_per_image * chunk;
  stage_table(resident, table + (long long)image * faces * width_d, faces,
              width_d, shape.vec16);
  dirt::cp_async_wait_all();
  __syncthreads();
  const ResidentFaces source{resident, (long long)image * blocks_per_image,
                             chunk};
  for (int t = 0; t < tiles; ++t) {
    const int bt = bt0 + t;
    const int tile = tile0 + t;
    dirt::CsrFill fill{block_ids + starts[bt], counts[bt], shape.list, 0};
    dirt::sweep_run(
        fill, source,
        dirt::StateEpilogue{table, width_d, channels, state + bt * stride,
                            pix},
        shape, smem, (tile / tiles_x) * tile_h, (tile % tiles_x) * tile_w,
        tile_w, pix, height, width, sx, sy);
  }
}

}  // namespace

extern "C" int dirt_resident_sweep(
    const float* table, const int* starts, const int* counts,
    const int* block_ids, float* state, int runs, int blocks_per_image,
    int num_tiles, int tiles_x, int tile_h, int tile_w, int chunk,
    int width_d, int channels, float sx, float sy, int height, int width,
    int groups, int region, int list, int vec16, int table_at, int smem,
    cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const dirt::SweepShape shape{groups, 0, region, list, vec16};
  const int threads = groups * tile_h * tile_w;
  auto kernel = threads <= dirt::kSweepThreads
                    ? resident_sweep_kernel<dirt::kSweepThreads,
                                            dirt::kSweepBlocks>
                    : resident_sweep_kernel<1024, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) {
      cudaGetLastError();   // clear it: the error is this call's
      return (int)err;
    }
  }
  const int blocks = (runs / num_tiles) *
                     ((num_tiles + kResidentTiles - 1) / kResidentTiles);
  kernel<<<blocks, threads, smem, stream>>>(
      table, starts, counts, block_ids, state, blocks_per_image, num_tiles,
      tiles_x, tile_h, tile_w, chunk, width_d, channels, height, width, sx,
      sy, shape, table_at);
  return (int)cudaGetLastError();
}

extern "C" int dirt_shared_memory_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
