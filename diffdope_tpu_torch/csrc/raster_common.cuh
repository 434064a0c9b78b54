// Device code shared by the bin-table rasters (K3, K7: raster.cu) and the
// sorted-range raster (K10: its forward in raster.cu, its backward in
// raster_v3.cu): pixel NDC, the best slot at a pixel, and the sorted
// table's chunk gate.
//
// Numeric contract (build with -fmad=false, no fast math): coverage
// e = x*a + (y*b + c) with a, b, c pre-scaled by sign(det), z = zlin *
// (1/det) with an IEEE divide, pixel NDC x = (2*(col+ox)+1)/fw - 1 — the
// reference's f32 operation order (raster_v2.py:699-707, 882-905).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace dd {

constexpr int kLanes = 32;
constexpr int kChunk = 128;  // slots a chunk of the sorted table (raster_v3.K_CHUNK)

__device__ __forceinline__ float ndc(int pix, int frame) {
  return __fsub_rn(
      __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, (float)pix), 1.0f), (float)frame),
      1.0f);
}

// the best slot so far at one pixel; start from none()
struct Best {
  float z;
  float id;
  int slot;
};

__device__ __forceinline__ Best none() { return Best{CUDART_INF_F, 0.0f, -1}; }

// whether K10 walks chunk c at tile t (row ty, first pixel row y0, th
// rows): c in the row's [clo, chi) and the chunk's row interval at the
// tile (rlo_tc, rhi_tc: (tiles, nc), empty off its x range) not empty and
// meeting the tile's rows: the gate (raster_v3._gate); its four loads go
// out together
__device__ __forceinline__ bool v3_gated(const int* __restrict__ clo,
                                         const int* __restrict__ chi,
                                         const int* __restrict__ rlo_tc,
                                         const int* __restrict__ rhi_tc, int nc,
                                         int t, int ty, int c, int y0, int th) {
  const int a = clo[ty], z = chi[ty];
  const int lo = rlo_tc[(size_t)t * nc + c], hi = rhi_tc[(size_t)t * nc + c];
  return (c >= a) & (c < z) & (lo <= hi) & (lo <= y0 + th - 1) & (hi >= y0);
}

// The frame pixel rows [rlo, rhi] and columns [clo, chi] at which a
// slot's edge planes, pre-signed by sign(det), can all test >= 0 in f32,
// taken from the planes themselves.  Both tests the rasters run round four
// times and no more: K3's x*a + (y*b + c) and K8's (a*x + b*y) + c (its
// e*sign(det) >= 0 is the test of the pre-signed planes: negation is exact
// and rounding symmetric).  So an f32 e_k >= 0 means an exact e_k >= -d_k,
// d_k = 4u (xm |a_k| + ym |b_k| + |c_k|) (each term carries at most three
// roundings, 3u + O(u^2) < 4u; |x| <= xm, |y| <= ym over the padded frame),
// and the pixel lies in the triangle that the three relaxed lines bound.
// Its corners are computed in f64 (the signs of the 2x2 determinants
// exactly: f32 products are exact in f64), and a hundredth of a pixel of
// margin takes up the rounding of pixel NDC.  Lines that bound no triangle
// (parallel, or an open wedge, as when a corner lies behind the camera)
// or non-finite values give every pixel.  The vertex bounds of the packed
// table's lanes 28-31 do not hold for a sliver, whose f32 planes can cover
// pixels past its corners (phase 11 of chip_smoke.py met one 8 rows off),
// nor in the padding past the frame's edge.
__device__ __forceinline__ void cover_range(const float (&a)[3], const float (&b)[3],
                                            const float (&c)[3], double xm, double ym,
                                            int fh, int fw, int& rlo, int& rhi, int& clo,
                                            int& chi) {
  constexpr double kU = 1.0 / (1 << 24);  // f32 unit roundoff
  constexpr double kAll = 1 << 20;        // past any pixel
  constexpr double kSlack = 0.01;         // pixels
  rlo = clo = -(1 << 20);
  rhi = chi = 1 << 20;
  double cc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    cc[k] = c[k] + 4.0 * kU * (xm * fabs((double)a[k]) + ym * fabs((double)b[k]) +
                               fabs((double)c[k]));
  double x0 = CUDART_INF, x1 = -CUDART_INF, y0 = CUDART_INF, y1 = -CUDART_INF;
  int pos = 0, neg = 0;
  bool finite = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {  // lines k and k + 1 meet at one corner
    const int j = (k + 1) % 3;
    const double d = (double)a[k] * b[j] - (double)a[j] * b[k];
    pos += d > 0.0;
    neg += d < 0.0;
    const double r = __drcp_rn(d);
    const double cx = ((double)b[k] * cc[j] - (double)b[j] * cc[k]) * r;
    const double cy = ((double)a[j] * cc[k] - (double)a[k] * cc[j]) * r;
    finite = finite && fabs(cx) < kAll && fabs(cy) < kAll;
    x0 = fmin(x0, cx);
    x1 = fmax(x1, cx);
    y0 = fmin(y0, cy);
    y1 = fmax(y1, cy);
  }
  if ((pos != 3 && neg != 3) || !finite) return;  // no triangle: every pixel
  // pixel r's NDC is (2r + 1)/n - 1, within 2^-22 (< 1e-3 pixel) in f32
  auto px = [](double v) { return (int)fmin(fmax(v, -kAll), kAll); };
  rlo = px(floor(((y0 + 1.0) * fh - 1.0) * 0.5 - kSlack));
  rhi = px(ceil(((y1 + 1.0) * fh - 1.0) * 0.5 + kSlack));
  clo = px(floor(((x0 + 1.0) * fw - 1.0) * 0.5 - kSlack));
  chi = px(ceil(((x1 + 1.0) * fw - 1.0) * 0.5 + kSlack));
}

// the largest |NDC| of the pixels [o, o + n) of a frame of ``full`` pixels
// (at least 1): cover_range's xm or ym over a padded or cropped window
__device__ __forceinline__ double extent(int o, int n, int full) {
  return fmax(1.0, fmax((2.0 * (o + n) - 1.0) / full - 1.0, 1.0 - (2.0 * o + 1.0) / full));
}

// (lo, hi) as one word, each clamped to 16 bits (frames below 2^15 pixels
// a side)
__device__ __forceinline__ int pack_box(int lo, int hi) {
  lo = min(max(lo, -32768), 32767);
  hi = min(max(hi, -32768), 32767);
  return (int)(((unsigned)lo & 0xffffu) | ((unsigned)hi << 16));
}

__device__ __forceinline__ void unpack_box(int v, int& lo, int& hi) {
  lo = (int)(short)(v & 0xffff);
  hi = v >> 16;
}

// the packed box (rows, columns) of one slot, ``lane(k)`` its f32 lane k
// (0-8 the edge planes, 12 det): cover_range of its planes pre-signed by
// sign(det); det 0, which covers no pixel, an empty box that meets none
template <class Lane>
__device__ __forceinline__ int2 slot_box(Lane lane, double xm, double ym, int fh, int fw) {
  const float det = lane(12);
  if (det == 0.0f) {
    const int empty = pack_box(32767, -32768);
    return make_int2(empty, empty);
  }
  const float sg = det > 0.0f ? 1.0f : -1.0f;
  float pa[3], pb[3], pc[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    pa[k] = lane(3 * k) * sg;
    pb[k] = lane(3 * k + 1) * sg;
    pc[k] = lane(3 * k + 2) * sg;
  }
  int rlo, rhi, clo, chi;
  cover_range(pa, pb, pc, xm, ym, fh, fw, rlo, rhi, clo, chi);
  return make_int2(pack_box(rlo, rhi), pack_box(clo, chi));
}

}  // namespace dd
