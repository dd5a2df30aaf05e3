// K2: grad_prepass -- Scharr, occluder dilation, viewport factors and the
// tile-major plane stack of the block-binned gradient.
//
// Replaces dirt_tpu/ops/prepass_fused.py:_prepass_kernel (the TPU's fused
// gradient pre-pass; semantics of csrc/rasterise_grad_egl.cu:113-208 as
// dirt_tpu/ops/backward.py implements them).
//
// Work: one thread per pixel of the padded tile grid.  A pixel inside the
// image reads its edge-clamped 3x3 neighbourhood of every colour channel
// and computes the Scharr responses, their L1 norms and the cotangent dot
// products channel by channel (left to right, as the plain version sums);
// picks the dominant axis with the parity-dithered sign; tries the primary
// then the opposite 4-neighbour for an occluder (over a triangle, a
// different triangle, nearer; interior pixels only; both attempts compare
// against the pixel's own state); and writes ax, ay, Px, Py, the dilated
// barycentrics and face id, then (parts "all") the pre-dilation
// barycentrics, face id and cotangent channels, into plane k of its tile at
// planes[(b*T + t)*np_dma + k][p].  Pixels past the image edge and planes
// past the layout are written as zeros.  `dilated` gets the adoption mask.
//
// What bounds it on the H100: device memory traffic -- ~(3C + 10) floats
// read per pixel through L1/L2 (neighbour reads hit cache) and np_dma
// floats written (16 at C = 3: 64 B per pixel, 67 MB for the bench batch).
// Neighbouring threads take neighbouring pixels of one tile row, so reads
// along a row and the plane writes coalesce.  There is no whole-image
// residency, hence no size limit and no fallback path.
//
// Built with -fmad=false and IEEE division, so the planes equal the plain
// version's (prepass_fused.plane_stack_plain) bit for bit.

#include <cuda_runtime.h>

namespace {

__global__ void grad_prepass_kernel(
    const float* __restrict__ pixels,      // [B, H, W, C]
    const float* __restrict__ grad,        // [B, H, W, C]
    const float* __restrict__ cot,         // [B, H, W, CC]
    const float* __restrict__ bary,        // [B, H, W, 3]
    const int* __restrict__ indices,       // [B, H, W, 3]
    const float* __restrict__ clip_w,      // [B, H, W]
    const int* __restrict__ face,          // [B, H, W]
    float* __restrict__ planes,            // [B*T, np_dma, tile_h*tile_w]
    bool* __restrict__ dilated,            // [B, H, W]
    long long total, int height, int width, int channels, int cot_channels,
    int tile_h, int tile_w, int tiles_x, int num_tiles, int np_dma,
    int all_parts) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  // idx enumerates (b, t, p): consecutive threads fill one tile row.
  const int pix = tile_h * tile_w;
  const int p = (int)(idx % pix);
  const long long bt = idx / pix;
  const int t = (int)(bt % num_tiles);
  const long long b = bt / num_tiles;
  const int r = (t / tiles_x) * tile_h + p / tile_w;
  const int c = (t % tiles_x) * tile_w + p % tile_w;
  float* out = planes + bt * np_dma * pix + p;

  if (r >= height || c >= width) {
    for (int k = 0; k < np_dma; ++k) out[k * pix] = 0.0f;
    return;
  }
  const long long img = b * height * width;
  const long long here = img + (long long)r * width + c;

  // --- Scharr responses, channel by channel (rasterise_grad_egl.cu:113-127).
  // at(ox, oy) reads row r - oy, column c + ox, edge-clamped.
  const int rm = r > 0 ? r - 1 : 0;                 // row r-1 (oy = +1)
  const int rp = r < height - 1 ? r + 1 : height - 1;  // row r+1 (oy = -1)
  const int cm = c > 0 ? c - 1 : 0;                 // col c-1 (ox = -1)
  const int cp = c < width - 1 ? c + 1 : width - 1;    // col c+1 (ox = +1)
  float l1_x = 0.0f, l1_y = 0.0f, dl_dx = 0.0f, dl_dy = 0.0f;
  for (int ch = 0; ch < channels; ++ch) {
    const float* P = pixels + img * channels + ch;
    auto at = [&](int rr, int cc) { return P[((long long)rr * width + cc) * channels]; };
    const float mm = at(rm, cm);    // at(-1, +1): row r-1, col c-1
    const float mp = at(rp, cm);    // at(-1, -1): row r+1, col c-1
    const float pm = at(rm, cp);    // at(+1, +1): row r-1, col c+1
    const float pp = at(rp, cp);    // at(+1, -1): row r+1, col c+1
    const float m0 = at(r, cm);     // at(-1, 0)
    const float p0 = at(r, cp);     // at(+1, 0)
    const float zm = at(rm, c);     // at(0, +1)
    const float zp = at(rp, c);     // at(0, -1)
    // scharr_x = (at(-1,-1) + at(-1,+1) - at(+1,-1) - at(+1,+1)) * 3/32
    //            + (at(-1,0) - at(+1,0)) * 10/32
    const float sx = (((mp + mm) - pp) - pm) * 0.09375f + (m0 - p0) * 0.3125f;
    // scharr_y = (at(-1,-1) + at(+1,-1) - at(-1,+1) - at(+1,+1)) * 3/32
    //            + (at(0,-1) - at(0,+1)) * 10/32
    const float sy = (((mp + pp) - mm) - pm) * 0.09375f + (zp - zm) * 0.3125f;
    const float g = grad[here * channels + ch];
    if (ch == 0) {
      l1_x = fabsf(sx);
      l1_y = fabsf(sy);
      dl_dx = g * sx;
      dl_dy = g * sy;
    } else {
      l1_x = l1_x + fabsf(sx);
      l1_y = l1_y + fabsf(sy);
      dl_dx = dl_dx + g * sx;
      dl_dy = dl_dy + g * sy;
    }
  }

  // --- Occluder dilation (rasterise_grad_egl.cu:153-194).
  // Offsets 0:(+1,0) 1:(-1,0) 2:(0,+1) 3:(0,-1): (r, c+1) (r, c-1)
  // (r-1, c) (r+1, c).
  const bool horizontal = l1_x > l1_y;
  const bool flip = ((r + c) % 2) == 1;
  const int primary = horizontal ? (flip ? 1 : 0) : (flip ? 3 : 2);
  const bool interior = r > 0 && r < height - 1 && c > 0 && c < width - 1;
  const int idx0 = indices[here * 3 + 0];
  const int idx1 = indices[here * 3 + 1];
  const int idx2 = indices[here * 3 + 2];
  const float w_here = clip_w[here];
  const int face_here = face[here];

  long long adopt = -1;   // flat pixel whose state is adopted
  for (int attempt = 0; attempt < 2 && adopt < 0; ++attempt) {
    const int o = attempt == 0 ? primary : (primary ^ 1);
    const int nr = o == 2 ? r - 1 : (o == 3 ? r + 1 : r);
    const int nc = o == 0 ? c + 1 : (o == 1 ? c - 1 : c);
    if (!interior) break;   // border pixels never dilate
    const long long q = img + (long long)nr * width + nc;
    const int n0 = indices[q * 3 + 0];
    const int n1 = indices[q * 3 + 1];
    const int n2 = indices[q * 3 + 2];
    const bool different = (n0 != idx0) || (n1 != idx1) || (n2 != idx2);
    if (n0 != -1 && different && w_here > clip_w[q]) adopt = q;
  }
  const long long src = adopt >= 0 ? adopt : here;
  const float bd0 = bary[src * 3 + 0];
  const float bd1 = bary[src * 3 + 1];
  const float bd2 = bary[src * 3 + 2];
  const float w_d = clip_w[src];
  const int face_d = face[src];
  dilated[here] = adopt >= 0;

  // --- Viewport chain-rule factors (rasterise_grad_egl.cu:203-208).
  const bool covered_d = face_d >= 0;
  const float safe_w = covered_d ? w_d : 1.0f;
  const float half_w = 0.5f * (float)width;
  const float half_h = 0.5f * (float)height;
  const float ax = covered_d ? (dl_dx * half_w) / safe_w : 0.0f;
  const float ay = covered_d ? (dl_dy * half_h) / safe_w : 0.0f;
  const float px = covered_d ? (dl_dx * half_w) / (safe_w * safe_w) : 0.0f;
  const float py = covered_d ? (dl_dy * half_h) / (safe_w * safe_w) : 0.0f;

  int k = 0;
  out[(k++) * pix] = ax;
  out[(k++) * pix] = ay;
  out[(k++) * pix] = px;
  out[(k++) * pix] = py;
  out[(k++) * pix] = bd0;
  out[(k++) * pix] = bd1;
  out[(k++) * pix] = bd2;
  out[(k++) * pix] = (float)face_d;
  if (all_parts) {
    const bool covered_pre = face_here >= 0;
    for (int j = 0; j < 3; ++j) {
      out[(k++) * pix] = covered_pre ? bary[here * 3 + j] : 0.0f;
    }
    out[(k++) * pix] = (float)face_here;
    for (int ch = 0; ch < cot_channels; ++ch) {
      out[(k++) * pix] = cot[here * cot_channels + ch];
    }
  }
  for (; k < np_dma; ++k) out[k * pix] = 0.0f;
}

}  // namespace

extern "C" int dirt_grad_prepass(
    const float* pixels, const float* grad, const float* cot,
    const float* bary, const int* indices, const float* clip_w,
    const int* face, float* planes, bool* dilated, int batch, int height,
    int width, int channels, int cot_channels, int tile_h, int tile_w,
    int tiles_x, int num_tiles, int np_dma, int all_parts,
    cudaStream_t stream) {
  const long long total = (long long)batch * num_tiles * tile_h * tile_w;
  if (total == 0) return (int)cudaGetLastError();
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  grad_prepass_kernel<<<(unsigned int)blocks, threads, 0, stream>>>(
      pixels, grad, cot, bary, indices, clip_w, face, planes, dilated, total,
      height, width, channels, cot_channels, tile_h, tile_w, tiles_x,
      num_tiles, np_dma, all_parts);
  return (int)cudaGetLastError();
}
