// K5: resident_sweep -- the forward sweep with the image's face table
// resident in shared memory.
//
// Replaces dirt_tpu/ops/forward_blocks.py:_raster_kernel_fused_resident,
// the TPU's resident variant of the fused-CSR sweep: the image's whole
// face table arrives in VMEM once per image and each visit reads its face
// block by index instead of streaming it.
//
// Work: one thread block per (image, group of G tiles), G the largest of
// 8, 4 and 2 that divides the tile count (forward_blocks.group_for), and
// one thread per pixel.  The block stages the image's table (NB x chunk x
// width_d floats) in dynamic shared memory once, then walks each tile of
// its group: the tile's CSR run of face blocks (block_ids[starts[bt] ..
// starts[bt] + counts[bt]], batch-folded), each block read in place by its
// per-image index, its rows tested in order with K1's per-face test
// (sweep_math.cuh).  No per-visit staging and no barrier after the first;
// each tile's winner starts afresh, so the state equals K1's bit for bit.
//
// What bounds it on the H100: arithmetic and broadcast shared-memory reads
// per (pixel, swept face), as K1; in place of K1's per-visit staging (one
// chunk x width_d block and two barriers per visit) it stages the whole
// table once per group, NB x chunk x width_d x 4 bytes from L2.  The table
// must fit the opt-in shared memory of one block (227 KB on the H100;
// forward_blocks.takes_resident decides); a larger one fails to launch.
// Fewer blocks fit on an SM as the table grows.
//
// Built with -fmad=false and IEEE division: the state equals the plain
// version's (forward_blocks.resident_sweep_plain) bit for bit.
//
// dirt_shared_memory_optin reports the limit the wrapper's budget reads.

#include <cuda_runtime.h>

#include "sweep_math.cuh"

namespace {

__global__ void resident_sweep_kernel(
    const float* __restrict__ table,      // [B*NB, chunk, width_d]
    const int* __restrict__ starts,       // [B*T]
    const int* __restrict__ counts,       // [B*T]
    const int* __restrict__ block_ids,    // [B*S], batch-folded
    float* __restrict__ state,            // [B*T, C+9, PIX]
    int group, int blocks_per_image, int num_tiles, int tiles_x, int tile_h,
    int tile_w, int chunk, int width_d, int channels, float sx, float sy) {
  extern __shared__ float image_table[];   // [NB, chunk, width_d]
  const int bt0 = blockIdx.x * group;
  const int image = bt0 / num_tiles;
  const int block_floats = chunk * width_d;
  const int image_floats = blocks_per_image * block_floats;
  const float* src = table + (long long)image * image_floats;
  for (int j = threadIdx.x; j < image_floats; j += blockDim.x) {
    image_table[j] = src[j];
  }
  __syncthreads();

  const int pix = tile_h * tile_w;
  const int p = threadIdx.x;
  const int r = p / tile_w;
  const int c = p - r * tile_w;
  const long long first_block = (long long)image * blocks_per_image;
  for (int g = 0; g < group; ++g) {
    const int bt = bt0 + g;
    const int tile = bt % num_tiles;
    const int row = (tile / tiles_x) * tile_h + r;
    const int col = (tile % tiles_x) * tile_w + c;
    const float xg = ((float)col + 0.5f) * sx - 1.0f;
    const float yg = 1.0f - ((float)row + 0.5f) * sy;

    dirt::Winner w;
    const int start = starts[bt];
    const int n = counts[bt];
    for (int i = 0; i < n; ++i) {
      const long long bid = block_ids[start + i];
      const float* rows = image_table + (bid - first_block) * block_floats;
      for (int k = 0; k < chunk; ++k) {
        dirt::test_face(rows + k * width_d, xg, yg, bid * chunk + k, w);
      }
    }
    if (p < pix) {
      dirt::write_state(table, width_d, channels, w,
                        state + (long long)bt * (channels + 9) * pix + p,
                        pix);
    }
  }
}

}  // namespace

extern "C" int dirt_resident_sweep(
    const float* table, const int* starts, const int* counts,
    const int* block_ids, float* state, int runs, int group,
    int blocks_per_image, int num_tiles, int tiles_x, int tile_h, int tile_w,
    int chunk, int width_d, int channels, float sx, float sy,
    cudaStream_t stream) {
  if (runs == 0) return (int)cudaGetLastError();
  const size_t smem =
      (size_t)blocks_per_image * chunk * width_d * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        resident_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();   // clear it: the error is this call's
      return (int)err;
    }
  }
  resident_sweep_kernel<<<runs / group, tile_h * tile_w, smem, stream>>>(
      table, starts, counts, block_ids, state, group, blocks_per_image,
      num_tiles, tiles_x, tile_h, tile_w, chunk, width_d, channels, sx, sy);
  return (int)cudaGetLastError();
}

extern "C" int dirt_shared_memory_optin(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}
