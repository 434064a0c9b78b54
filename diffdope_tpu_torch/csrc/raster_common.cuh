// Device code shared by the bin-table rasters (K3, K7: raster.cu) and the
// sorted-range raster (K10: raster_v3.cu): pixel NDC, the pre-signed edge
// planes, the per-slot z test with its (z, triangle id) lexicographic
// minimum, and the winner's write.  K3/K7 stage the planes pre-signed and
// run the same test's arithmetic over four pixels of a row (raster.cu);
// test_slot and write_winner are K10's.
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
constexpr int kIdLanes = 14;  // lanes 0..12 (coverage, z) and 13 (id)

__device__ __forceinline__ float ndc(int pix, int frame) {
  return __fsub_rn(
      __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, (float)pix), 1.0f), (float)frame),
      1.0f);
}

// e = x*a + (y*b + c), each product and sum rounded (no FMA)
__device__ __forceinline__ float plane(float x, float y, float a, float b,
                                       float c) {
  return __fadd_rn(__fmul_rn(x, a), __fadd_rn(__fmul_rn(y, b), c));
}

// the best slot so far at one pixel; start from none()
struct Best {
  float z;
  float id;
  int slot;
};

__device__ __forceinline__ Best none() { return Best{CUDART_INF_F, 0.0f, -1}; }

// tests staged slot j (lanes st[lane][j], stride kStage) at NDC (x, y) and
// keeps the (z, id) lexicographic minimum among covered slots with
// |z| <= 1; ``slot`` is the slot's index in the table
template <int kStage>
__device__ __forceinline__ void test_slot(const float (*st)[kStage], int j,
                                          int slot, float x, float y,
                                          Best& best) {
  const float det = st[12][j];
  if (det == 0.0f) return;
  const float sg = det > 0.0f ? 1.0f : -1.0f;
  const float e0 = plane(x, y, st[0][j] * sg, st[1][j] * sg, st[2][j] * sg);
  const float e1 = plane(x, y, st[3][j] * sg, st[4][j] * sg, st[5][j] * sg);
  const float e2 = plane(x, y, st[6][j] * sg, st[7][j] * sg, st[8][j] * sg);
  if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)) return;
  const float zlin = plane(x, y, st[9][j], st[10][j], st[11][j]);
  const float z = __fmul_rn(zlin, __fdiv_rn(1.0f, det));
  if (!(z >= -1.0f && z <= 1.0f)) return;
  const float id = st[13][j];
  if (z < best.z || (z == best.z && id < best.id)) {
    best.z = z;
    best.id = id;
    best.slot = slot;
  }
}

// writes pixel ``pix`` of hypothesis b: ids (+1, 0 = background), win (the
// winner's slot, -1) and the winner's 32 lanes of table tb (B's slice,
// ``tot`` slots a lane) into the planar rows (zeros on background)
__device__ __forceinline__ void write_winner(const Best& best,
                                             const float* __restrict__ tb,
                                             int tot, size_t plane_px,
                                             int b, size_t pix,
                                             int* __restrict__ ids,
                                             int* __restrict__ win,
                                             float* __restrict__ rows) {
  ids[(size_t)b * plane_px + pix] = best.slot >= 0 ? (int)best.id + 1 : 0;
  win[(size_t)b * plane_px + pix] = best.slot;
  float* out = rows + (size_t)b * kLanes * plane_px + pix;
  if (best.slot >= 0) {
    const float* src = tb + best.slot;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) out[k * plane_px] = src[(size_t)k * tot];
  } else {
#pragma unroll
    for (int k = 0; k < kLanes; ++k) out[k * plane_px] = 0.0f;
  }
}

}  // namespace dd
