// K13: face_table -- both passes' face tables, written from the vertices
// straight into the order the block schedules sweep them in.
//
// Replaces no Pallas kernel: dirt_tpu's face tables
// (dirt_tpu/ops/forward_pallas.py's _face_table, dirt_tpu/ops/
// grad_tables.py's _grad_face_table) and their Morton sort
// (forward_blocks.spatial_order) are plain jnp that XLA fuses.  Their
// PyTorch form, kept as the CPU path and the reference
// (forward_blocks.face_table_plain), took ~160 eager launches a table,
// synchronising host-to-device copies (a list index, the pad rows' scalar
// writes), an unsorted table and an int64 [B, F, D] gather index beside
// the sorted table.
//
// What bounds it on the H100: the rows it writes, B x N x D floats (302 MB
// for the forward's 36 columns at 32 images of 65,536 faces, 176 MB for
// the gradient's 21), against 12 bytes of face and 48 of corners a row,
// which the L2 holds.  So:
//
//  * Two launches.  The keys launch gives row j < F of each image the
//    int32 Morton key of its bbox-centre tile (spatial_order's), INT32_MAX
//    for an empty bbox and for the pad rows j >= F, from the face's
//    corners alone: the bbox needs only them and the validity
//    determinant.  The wrapper's stable argsort of the keys is the
//    schedule's order.  The rows launch writes sorted row j of image b
//    from face order[b, j], set up again from its corners, or the pad row
//    where order[b, j] >= F (identity order where none is given): no
//    unsorted table, no gather index, no pad rows built on the host.
//  * Coalesced rows.  A thread block of kThreads threads sets up one row
//    each into shared memory (the layout's leading columns: the
//    gradient's 21, the forward's 27 before its attributes), then stores
//    the block's rows, one contiguous stretch of the output, thread t at
//    floats t, t + kThreads, ...; an attribute column is gathered from the
//    vertex attributes as it is stored.
//  * The plain ops' bits.  Built with -fmad=false and IEEE division, each
//    product, quotient and sum rounds as its eager op does on the card
//    (geometry._cross_xyw, forward_pallas.pixel_bbox); the minimum and
//    maximum over corners propagate NaN as torch.amin / amax do (fminf
//    would not); float -> int32 is PyTorch's conversion on the card
//    (cvt.rzi: saturating, NaN to 0), and the int32 sums after it wrap as
//    the card's do.
//  * The near/far clip.  A face with a corner at w <= 0 takes the bbox of
//    its part inside -w <= z <= w (forward_pallas._clipped_bounds:
//    Sutherland-Hodgman against z + w >= 0, then w - z >= 0, each crossing
//    S + t (E - S) with t = d_S / (d_S - d_E)), in a function of its own
//    that only those faces call, its arguments and result in registers and
//    its polygons in local memory; the empty bbox where nothing is left, the full screen where a point left
//    has w <= 0 or projects to a non-finite pixel.  Faces with every w > 0
//    keep the projection of their corners.
//
// Layouts (forward_pallas.py, grad_tables.py), chosen by `grad`: the
// forward's 27 + 3C columns (e, z and w -- NaN where the face is
// degenerate --, accept, valid, face, bbox, vertex ids, corner attributes)
// or the gradient's 21 (bbox widened by `widen`, face, valid, corner x,
// corner y, e).
//
// Launch: one kernel, face_table_kernel, in three modes (keys, forward
// rows, gradient rows), on a one-dimensional grid of kThreads-thread
// blocks, a row a thread, an image's blocks fastest, then images.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kForwardBase = 27;   // forward_pallas._BASE
constexpr int kGradColumns = 21;   // grad_tables._DF
constexpr int kBig = 1 << 30;      // forward_pallas._BIG
// torch.where(valid, z, torch.nan)'s NaN on the card.
constexpr unsigned kNaN = 0x7fc00000u;

struct Mesh {
  const float* vertices;   // [B, V, 4] clip space
  const int* faces;        // [B, F, 3]
  int num_vertices, num_faces, height, width, widen;
  float half_w, half_h;    // width / 2, height / 2
};

// One face: its corners and what the tables derive from them.
struct Face {
  float x[3], y[3], z[3], w[3];
  int v[3];
  float e[9];
  bool valid;
  int bbox[4];   // r0, r1, c0, c1
};

__device__ __forceinline__ void load_corners(const Mesh& m, int b, int f,
                                             Face& s) {
  const int* tri = m.faces + ((long long)b * m.num_faces + f) * 3;
  const float* image = m.vertices + (long long)b * m.num_vertices * 4;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.v[k] = tri[k];
    const float* p = image + (long long)s.v[k] * 4;
    s.x[k] = p[0];
    s.y[k] = p[1];
    s.z[k] = p[2];
    s.w[k] = p[3];
  }
}

// geometry._cross_xyw of corners j and k in (x, y, w): each product rounds
// before the subtraction.
__device__ __forceinline__ void cross(const Face& s, int j, int k,
                                      float* out) {
  out[0] = s.y[j] * s.w[k] - s.w[j] * s.y[k];
  out[1] = s.w[j] * s.x[k] - s.x[j] * s.w[k];
  out[2] = s.x[j] * s.y[k] - s.y[j] * s.x[k];
}

// geometry.face_setup's valid: det[p0; p1; p2] != 0, from e0.
__device__ __forceinline__ bool nondegenerate(const Face& s,
                                              const float* e0) {
  return ((s.x[0] * e0[0] + s.y[0] * e0[1]) + s.w[0] * e0[2]) != 0.0f;
}

// torch.amin / torch.amax over three values: NaN where any is NaN.
__device__ __forceinline__ float amin3(const float* p) {
  if (isnan(p[0]) || isnan(p[1]) || isnan(p[2]))
    return __int_as_float(kNaN);
  return fminf(fminf(p[0], p[1]), p[2]);
}

__device__ __forceinline__ float amax3(const float* p) {
  if (isnan(p[0]) || isnan(p[1]) || isnan(p[2]))
    return __int_as_float(kNaN);
  return fmaxf(fmaxf(p[0], p[1]), p[2]);
}

// int32 sums as the card's int ops give them: wrapping.
__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int clamp_to(int v, int hi) {
  return min(max(v, 0), hi);
}

// A point of a clipped polygon, clip space.
struct Point {
  float x, y, z, w;
};

// forward_pallas._clip_plane: the polygon in[0, n) clipped to d >= 0, d =
// z + w (the near plane) or w - z (`far`), into out, in order; returns its
// points.  out holds 2n.
__device__ __forceinline__ int clip_plane(const Point* in, int n, bool far,
                                          Point* out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const Point s = in[i];
    const Point e = in[i + 1 == n ? 0 : i + 1];
    const float ds = far ? s.w - s.z : s.z + s.w;
    const float de = far ? e.w - e.z : e.z + e.w;
    const bool s_in = ds >= 0.0f;
    if (s_in) out[m++] = s;
    if (s_in != (de >= 0.0f)) {
      const float t = ds / (ds - de);
      out[m++] = Point{s.x + t * (e.x - s.x), s.y + t * (e.y - s.y),
                       s.z + t * (e.z - s.z), s.w + t * (e.w - s.w)};
    }
  }
  return m;
}

// A clipped bound, clamped to +/- forward_pallas._CLIP_LIMIT, to int32.
__device__ __forceinline__ int clip_to_int(float v) {
  constexpr float kLimit = 16777216.0f;
  return __float2int_rz(fminf(fmaxf(v, -kLimit), kLimit));
}

// forward_pallas's clip status of a face's bbox.
enum Clip { kFront = 0, kClipped = 1, kCulled = 2, kWhole = 3 };

// A face's clip status and, where kClipped, its clipped points' projected
// pixel bounds (floored least, ceiled greatest, each clamped to +/-
// forward_pallas._CLIP_LIMIT).
struct ClipBox {
  int clip, col0, col1, row0, row1;
};

// forward_pallas._clipped_bounds of the face of corners p0, p1, p2 (x, y,
// z, w): clipped to -w <= z <= w.  Its own function, called only for faces
// with a corner at w <= 0, with its arguments and result in registers: the
// polygons' local memory stays out of the table's common path.
__device__ __noinline__ ClipBox clipped_bounds(Point p0, Point p1, Point p2,
                                               float half_w, float half_h) {
  const Point tri[3] = {p0, p1, p2};
  Point once[6], both[12];
  const int n_once = clip_plane(tri, 3, false, once);
  const int n = clip_plane(once, n_once, true, both);
  ClipBox box{kCulled, 0, 0, 0, 0};
  if (n == 0) return box;
  const float inf = __int_as_float(0x7f800000);
  float c0 = inf, c1 = -inf, r0 = inf, r1 = -inf;
  for (int i = 0; i < n; ++i) {
    const float px = (both[i].x / both[i].w + 1.0f) * half_w;
    const float py = (1.0f - both[i].y / both[i].w) * half_h;
    if (both[i].w <= 0.0f || !isfinite(px) || !isfinite(py)) {
      box.clip = kWhole;
      return box;
    }
    c0 = fminf(c0, px);
    c1 = fmaxf(c1, px);
    r0 = fminf(r0, py);
    r1 = fmaxf(r1, py);
  }
  box.clip = kClipped;
  box.col0 = clip_to_int(floorf(c0 - 0.5f));
  box.col1 = clip_to_int(ceilf(c1 - 0.5f));
  box.row0 = clip_to_int(floorf(r0 - 0.5f));
  box.row1 = clip_to_int(ceilf(r1 - 0.5f));
  return box;
}

// forward_pallas.pixel_bbox of the face, widened by m.widen, into s.bbox.
__device__ __forceinline__ void pixel_bbox(const Mesh& m, Face& s) {
  float px[3], py[3];
  bool unbounded = false;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float safe_w = s.w[k] > 0.0f ? s.w[k] : 1.0f;
    px[k] = (s.x[k] / safe_w + 1.0f) * m.half_w;
    py[k] = (1.0f - s.y[k] / safe_w) * m.half_h;
    unbounded |= s.w[k] <= 0.0f;
  }
  const int h1 = m.height - 1, w1 = m.width - 1;
  int col0, col1, row0, row1;
  int clip = kFront;
  if (unbounded) {
    // The clipped path: its bounds are in range, so plain int sums.
    const ClipBox box = clipped_bounds(
        Point{s.x[0], s.y[0], s.z[0], s.w[0]},
        Point{s.x[1], s.y[1], s.z[1], s.w[1]},
        Point{s.x[2], s.y[2], s.z[2], s.w[2]}, m.half_w, m.half_h);
    clip = box.clip;
    col0 = box.col0 - 1 - m.widen;
    col1 = box.col1 + 1 + m.widen;
    row0 = box.row0 - 1 - m.widen;
    row1 = box.row1 + 1 + m.widen;
  } else {
    // floor / ceil, then PyTorch's float -> int32 (__float2int_rz is
    // cvt.rzi.s32.f32, as static_cast on the card), then the int32 sums.
    col0 = wrap_add(
        wrap_add(__float2int_rz(floorf(amin3(px) - 0.5f)), -1), -m.widen);
    col1 = wrap_add(
        wrap_add(__float2int_rz(ceilf(amax3(px) - 0.5f)), 1), m.widen);
    row0 = wrap_add(
        wrap_add(__float2int_rz(floorf(amin3(py) - 0.5f)), -1), -m.widen);
    row1 = wrap_add(
        wrap_add(__float2int_rz(ceilf(amax3(py) - 0.5f)), 1), m.widen);
  }
  const bool whole = clip == kWhole;
  const bool empty = !s.valid || clip == kCulled;
  s.bbox[0] = empty ? kBig : whole ? 0 : clamp_to(row0, h1);
  s.bbox[1] = empty ? -1 : whole ? h1 : clamp_to(row1, h1);
  s.bbox[2] = empty ? kBig : whole ? 0 : clamp_to(col0, w1);
  s.bbox[3] = empty ? -1 : whole ? w1 : clamp_to(col1, w1);
}

// forward_blocks._morton's spread: the low 16 bits to the even bits.
__device__ __forceinline__ int spread(int v) {
  v = (v | (v << 8)) & 0x00FF00FF;
  v = (v | (v << 4)) & 0x0F0F0F0F;
  v = (v | (v << 2)) & 0x33333333;
  return (v | (v << 1)) & 0x55555555;
}

// forward_blocks.spatial_keys of one bbox (r0, r1, c0, c1).
__device__ __forceinline__ int morton_key(const int* bbox, int tile_h,
                                          int tile_w) {
  if (bbox[1] < bbox[0]) return INT_MAX;
  // (a + b) // 2 floors: an arithmetic shift.
  const int ty = max(wrap_add(bbox[0], bbox[1]) >> 1, 0) / tile_h;
  const int tx = max(wrap_add(bbox[2], bbox[3]) >> 1, 0) / tile_w;
  constexpr int kCap = (1 << 15) - 1;
  return (spread(clamp_to(ty, kCap)) << 1) | spread(clamp_to(tx, kCap));
}

// The keys launch's key of row j < F of image b.
__device__ __forceinline__ int face_key(const Mesh& m, int b, int j,
                                        int tile_h, int tile_w) {
  Face s;
  load_corners(m, b, j, s);
  cross(s, 1, 2, s.e);
  s.valid = nondegenerate(s, s.e);
  pixel_bbox(m, s);
  return morton_key(s.bbox, tile_h, tile_w);
}

// The row of face `f` (set up in full) or, where f is past the faces, the
// pad row, into `row`; the row's vertex ids into ids (-1 for the pad row).
template <bool kGrad>
__device__ __forceinline__ void set_row(const Mesh& m, int b, int f,
                                        float* row, int* ids) {
  if ((unsigned)f >= (unsigned)m.num_faces) {
    constexpr int kBase = kGrad ? kGradColumns : kForwardBase;
    for (int c = 0; c < kBase; ++c) row[c] = 0.0f;
    const int at = kGrad ? 0 : 20;   // the bbox columns
    row[at] = row[at + 2] = (float)kBig;
    row[at + 1] = row[at + 3] = -1.0f;
    if (kGrad) row[4] = -1.0f;       // the gradient's face column
    ids[0] = ids[1] = ids[2] = -1;
    return;
  }
  Face s;
  load_corners(m, b, f, s);
  cross(s, 1, 2, s.e);
  cross(s, 2, 0, s.e + 3);
  cross(s, 0, 1, s.e + 6);
  s.valid = nondegenerate(s, s.e);
  pixel_bbox(m, s);
  const float valid = s.valid ? 1.0f : 0.0f;
  if (kGrad) {
#pragma unroll
    for (int c = 0; c < 4; ++c) row[c] = (float)s.bbox[c];
    row[4] = (float)f;
    row[5] = valid;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      row[6 + k] = s.x[k];
      row[9 + k] = s.y[k];
    }
#pragma unroll
    for (int c = 0; c < 9; ++c) row[12 + c] = s.e[c];
  } else {
    const float nan = __int_as_float(kNaN);
#pragma unroll
    for (int c = 0; c < 9; ++c) row[c] = s.e[c];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      row[9 + k] = s.valid ? s.z[k] : nan;
      row[12 + k] = s.valid ? s.w[k] : nan;
      const float a = s.e[3 * k], bb = s.e[3 * k + 1];
      row[15 + k] = (a > 0.0f || (a == 0.0f && bb > 0.0f)) ? 1.0f : 0.0f;
      row[24 + k] = (float)s.v[k];
    }
    row[18] = valid;
    row[19] = (float)f;
#pragma unroll
    for (int c = 0; c < 4; ++c) row[20 + c] = (float)s.bbox[c];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) ids[k] = s.v[k];
}

enum Mode { kKeys, kForwardRows, kGradRows };

// A thread a row: block blockIdx.x takes rows [j0, j0 + kThreads) of
// image b, its image's blocks fastest.
template <int kMode>
__global__ void __launch_bounds__(kThreads) face_table_kernel(
    Mesh m, const float* __restrict__ attrs, int channels,
    const int* __restrict__ order, int* __restrict__ keys,
    float* __restrict__ out, int rows, int parts, int tile_h, int tile_w) {
  const int b = blockIdx.x / parts;
  const int j0 = (blockIdx.x % parts) * kThreads;
  const int t = threadIdx.x;
  const int n = min(kThreads, rows - j0);
  const long long first = (long long)b * rows + j0;
  if constexpr (kMode == kKeys) {
    if (t < n)
      keys[first + t] = j0 + t < m.num_faces
                            ? face_key(m, b, j0 + t, tile_h, tile_w)
                            : INT_MAX;
  } else {
    constexpr bool kGrad = kMode == kGradRows;
    constexpr int kBase = kGrad ? kGradColumns : kForwardBase;
    __shared__ float staged[kThreads * kBase];
    __shared__ int ids[kThreads * 3];
    if (t < n) {
      const int f = order != nullptr ? order[first + t] : j0 + t;
      set_row<kGrad>(m, b, f, staged + t * kBase, ids + 3 * t);
    }
    __syncthreads();
    // The block's rows are floats [0, n D) from `first`; thread t stores
    // element e = r D + c at e = t, t + kThreads, ...
    const int width_d = kBase + (kGrad ? 0 : 3 * channels);
    const int count = n * width_d;
    const int step_r = kThreads / width_d, step_c = kThreads % width_d;
    int r = t / width_d, c = t % width_d;
    float* dst = out + first * width_d;
    const float* image_attrs =
        kGrad ? nullptr : attrs + (long long)b * m.num_vertices * channels;
    for (int e = t; e < count; e += kThreads) {
      float value;
      if (c < kBase) {
        value = staged[r * kBase + c];
      } else {
        const int a = c - kBase;
        const int k = a / channels;
        const int v = ids[3 * r + k];
        value = v < 0 ? 0.0f
                      : image_attrs[(long long)v * channels +
                                    (a - k * channels)];
      }
      dst[e] = value;
      r += step_r;
      c += step_c;
      if (c >= width_d) {
        c -= width_d;
        ++r;
      }
    }
  }
}

}  // namespace

// The keys launch where `keys` is given ([B, rows] int32), else the rows
// launch into `out` ([B, rows, D] float32, D = 21 with `grad`, else 27 +
// 3 channels) in the order `order` ([B, rows] int32; identity where null).
// vertices [B, V, 4] float32, faces [B, F, 3] int32 and attrs [B, V, C]
// float32 (the forward's) are contiguous; rows >= F.
extern "C" int dirt_face_table(
    const float* vertices, const int* faces, const float* attrs,
    const int* order, int* keys, float* out, int batch, int num_vertices,
    int num_faces, int rows, int channels, int grad, int widen, int height,
    int width, float half_w, float half_h, int tile_h, int tile_w,
    cudaStream_t stream) {
  if (batch < 0 || num_vertices < 0 || num_faces < 0 || rows < num_faces ||
      channels < 0 || height < 1 || width < 1 || widen < 0)
    return (int)cudaErrorInvalidValue;
  if (keys != nullptr ? tile_h < 1 || tile_w < 1
                      : out == nullptr ||
                            (!grad && channels > 0 && attrs == nullptr))
    return (int)cudaErrorInvalidValue;
  const Mesh m{vertices, faces, num_vertices, num_faces, height, width,
               widen, half_w, half_h};
  const int parts = (rows + kThreads - 1) / kThreads;
  const long long blocks = (long long)parts * batch;
  if (blocks == 0) return (int)cudaGetLastError();
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const unsigned grid = (unsigned)blocks;
  if (keys != nullptr)
    face_table_kernel<kKeys><<<grid, kThreads, 0, stream>>>(
        m, attrs, channels, order, keys, out, rows, parts, tile_h, tile_w);
  else if (grad)
    face_table_kernel<kGradRows><<<grid, kThreads, 0, stream>>>(
        m, attrs, 0, order, keys, out, rows, parts, tile_h, tile_w);
  else
    face_table_kernel<kForwardRows><<<grid, kThreads, 0, stream>>>(
        m, attrs, channels, order, keys, out, rows, parts, tile_h, tile_w);
  return (int)cudaGetLastError();
}
