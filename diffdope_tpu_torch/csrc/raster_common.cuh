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

}  // namespace dd
