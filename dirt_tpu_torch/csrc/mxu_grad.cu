// K10: mxu_grad -- the "mxu" gradient's masked sums as bf16 tensor-core
// matrix products.
//
// Replaces dirt_tpu/ops/grad_mxu.py:_grad_kernel (per (image, band, face
// chunk): masks [2*CHUNK, PIX] of the chunk's face ids against the band's
// post- and pre-dilation face-id planes, times the band's value planes
// [PIX, P] split into bf16 hi/mid/lo groups, three MXU passes accumulated in
// f32; zeros for dead chunks).
//
// Work: one thread block per (image, band, chunk), 2*chunk threads: warp w
// owns mask rows [32w, 32w + 32), two 16-row fragments, and the output's
// columns in fragments of 16, at most four fragments (64 columns) per
// pass; wider rows take more passes.  A chunk at or past the band's hit
// count is dead: the block writes zeros and returns (the rows scatter
// through sorted_orig, so they must be zeros).  A live block walks the
// band's pixels in slices of kSlice:
//   * the {0, 1} mask tile [2*chunk, kSlice] bf16 is built in shared
//     memory: each lane holds the post- and pre-dilation ids of two
//     pixels in registers, and a warp writes one row at a time (row i <
//     chunk against face id i, row chunk + i against the pre-dilation ids;
//     -1 background, -2 padded pixel and -3 padded list entry match
//     nothing);
//   * the value tiles of the three split groups are copied 16 bytes at a
//     time from the plane-major values [3, P, PIX] (a plane's pixels are
//     contiguous) into column-major B tiles [3][64 columns][kSlice];
//     columns past P stay zero;
//   * each warp issues nvcuda::wmma bf16 16x16x16 products with f32
//     accumulators, the hi, mid and lo groups into the same fragments.
// A mask entry times a bf16 value is exact and the tensor cores
// accumulate in f32, so the rows differ from the plain version
// (mxu_grad_plain: three f32 matmuls) only by summation order.  Fragments
// are stored through a per-warp 16x16 scratch tile, so only the P real
// columns reach the output.  PIX is a multiple of 16 (BAND_H = 16 rows),
// so every 8-pixel vector lies wholly inside or outside the band.
//
// What bounds it on the H100: the products are 2 * (2*chunk) * PIX * P *
// 3 flops per live item, on the bf16 dense tensor-core peak (989 TFLOP/s);
// the bytes are the ids, the bf16 values (re-read from L2 for every chunk
// of a band), the face ids and the rows.  Building the masks and staging
// the tiles through registers, with two barriers per slice, is what sets
// its time, not the tensor cores; wgmma fed by TMA rings is the faster
// form.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kSlice = 64;     // pixels per staged slice (four k-steps)
constexpr int kFrags = 4;      // 16-column output fragments per pass
constexpr int kPassCols = kFrags * 16;

struct Smem {
  __nv_bfloat16* mask;   // [rows][kSlice]
  __nv_bfloat16* vals;   // [3][kPassCols][kSlice], column-major B tiles
  float* scratch;        // [warps][16 * 16]
  float* fid;            // [chunk]
};

__global__ void mxu_grad_kernel(
    const float* __restrict__ face_ids,        // [B*bands, NC*chunk]
    const int* __restrict__ counts,            // [B*bands]
    const float* __restrict__ ids,             // [B*bands, 2, pix]
    const __nv_bfloat16* __restrict__ values,  // [B*bands, 3, ncols, pix]
    float* __restrict__ out,                   // [B*bands*NC, 2*chunk, ncols]
    int num_chunks, int chunk, int pix, int ncols) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int rows = 2 * chunk;
  Smem s;
  s.mask = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  s.vals = s.mask + rows * kSlice;
  s.scratch = reinterpret_cast<float*>(s.vals + 3 * kPassCols * kSlice);
  s.fid = s.scratch + (rows / 32) * 256;

  const long long item = blockIdx.x;
  const long long band = item / num_chunks;              // b * bands + t
  const int c = (int)(item % num_chunks);
  float* dst = out + item * rows * ncols;
  if (c * chunk >= counts[band]) {
    for (int j = threadIdx.x; j < rows * ncols; j += blockDim.x) dst[j] = 0.0f;
    return;
  }
  for (int j = threadIdx.x; j < chunk; j += blockDim.x) {
    s.fid[j] = face_ids[band * num_chunks * chunk + c * chunk + j];
  }
  const float* band_ids = ids + band * 2 * pix;
  const __nv_bfloat16* band_vals = values + band * 3 * ncols * pix;
  const int warps = rows / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat162 zero2 = __floats2bfloat162_rn(0.0f, 0.0f);

  for (int col0 = 0; col0 < ncols; col0 += kPassCols) {
    const int pass_cols = min(kPassCols, ncols - col0);
    const int nf = (pass_cols + 15) / 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][kFrags];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kFrags; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    }
    __syncthreads();   // the previous pass is done with the value tiles
    // Columns past P stay zero for the whole pass.
    for (int j = threadIdx.x; j < 3 * kPassCols * kSlice / 2; j += blockDim.x) {
      reinterpret_cast<__nv_bfloat162*>(s.vals)[j] = zero2;
    }

    for (int p0 = 0; p0 < pix; p0 += kSlice) {
      // This lane's two pixels, p0 + 2*lane and the next (-2 past PIX).
      const int p = p0 + 2 * lane;
      float2 post = make_float2(-2.0f, -2.0f), pre = post;
      if (p < pix) {
        post = *reinterpret_cast<const float2*>(band_ids + p);
        pre = *reinterpret_cast<const float2*>(band_ids + pix + p);
      }
      __syncthreads();   // the previous slice's products are done
      // Mask tile: warp w writes rows w, w + warps, ...; lane, two pixels.
      for (int r = warp; r < rows; r += warps) {
        const float2 id = r < chunk ? post : pre;
        const float f = s.fid[r < chunk ? r : r - chunk];
        reinterpret_cast<__nv_bfloat162*>(s.mask + r * kSlice)[lane] =
            __floats2bfloat162_rn(id.x == f ? 1.0f : 0.0f,
                                  id.y == f ? 1.0f : 0.0f);
      }
      // Value tiles: 8 pixels (16 bytes) per copy, zeros past PIX.
      const int vecs = kSlice / 8;
      for (int j = threadIdx.x; j < 3 * pass_cols * vecs; j += blockDim.x) {
        const int g = j / (pass_cols * vecs);
        const int rest = j - g * pass_cols * vecs;
        const int cc = rest / vecs;
        const int v = rest - cc * vecs;
        uint4 word = make_uint4(0u, 0u, 0u, 0u);
        if (p0 + 8 * v < pix) {
          word = *reinterpret_cast<const uint4*>(
              band_vals + ((long long)g * ncols + col0 + cc) * pix + p0 +
              8 * v);
        }
        *reinterpret_cast<uint4*>(s.vals + (g * kPassCols + cc) * kSlice +
                                  8 * v) = word;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kSlice; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          wmma::load_matrix_sync(
              a[i], s.mask + (warp * 32 + i * 16) * kSlice + kk, kSlice);
        }
#pragma unroll
        for (int g = 0; g < 3; ++g) {
#pragma unroll
          for (int j = 0; j < kFrags; ++j) {
            if (j >= nf) continue;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> b;
            wmma::load_matrix_sync(
                b, s.vals + (g * kPassCols + j * 16) * kSlice + kk, kSlice);
            wmma::mma_sync(acc[0][j], a[0], b, acc[0][j]);
            wmma::mma_sync(acc[1][j], a[1], b, acc[1][j]);
          }
        }
      }
    }
    // Fragments -> this warp's scratch tile -> the real columns of out.
    float* tile = s.scratch + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < kFrags; ++j) {
        if (j >= nf) continue;
        wmma::store_matrix_sync(tile, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int col = j * 16 + e % 16;
          if (col < pass_cols) {
            dst[(long long)(warp * 32 + i * 16 + e / 16) * ncols + col0 +
                col] = tile[e];
          }
        }
        __syncwarp();
      }
    }
  }
}

// The layout of Smem: mask, value tiles, scratch tiles, face ids.
size_t smem_bytes(int chunk) {
  const int rows = 2 * chunk;
  return (size_t)rows * kSlice * 2 + (size_t)3 * kPassCols * kSlice * 2 +
         (size_t)(rows / 32) * 256 * 4 + (size_t)chunk * 4;
}

}  // namespace

extern "C" int dirt_mxu_grad(const float* face_ids, const int* counts,
                             const float* ids, const __nv_bfloat16* values,
                             float* out, int bands, int num_chunks, int chunk,
                             int pix, int ncols, cudaStream_t stream) {
  if (bands == 0 || num_chunks == 0) return (int)cudaGetLastError();
  const size_t smem = smem_bytes(chunk);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(mxu_grad_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  }
  const long long blocks = (long long)bands * num_chunks;
  mxu_grad_kernel<<<(unsigned int)blocks, 2 * chunk, smem, stream>>>(
      face_ids, counts, ids, values, out, num_chunks, chunk, pix, ncols);
  return (int)cudaGetLastError();
}
