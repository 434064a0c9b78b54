// Bin-table raster forward and backward for Hopper (sm_90a): over the
// compact table (K3, K4) and over the uniform-K table (K7).
//
// K3 replaces diffdope_tpu/render/raster_v2.py:_fwd_kernel_v2_compact
// (-> _fwd_kernel_body, driven by _fwd_from_bins_compact).  K4 replaces
// raster_v2.py:_bwd_kernel_v2_compact (-> _bwd_kernel_body, driven by
// _compact_dbins).  K7 replaces raster_v2.py:_fwd_kernel_v2 and
// _bwd_kernel_v2 (the same bodies, driven by _fwd_from_bins and _dbin_flat
// with zero_tail): tile t owns slots [t*K, t*K + min(count_t, K)) of the
// uniform table.  The two tables differ only in that slot-range rule
// (CompactRange, UniformRange below); each has its own entry points.  The
// plain torch versions that these are held to live in
// diffdope_tpu_torch/render/raster.py.
//
// K3: one thread block per (screen tile, hypothesis), each thread four
// pixels of one tile row (64 threads for the port's 16x16 tile).  The block
// walks its tile's compact slots through shared memory, 128 slots at a
// time, staged slot-major once per block: the edge planes pre-signed by
// sign(det), the z plane, 1/det (the same IEEE divide), the id, and the
// rows and columns of the tile the slot can cover, from the packed table's
// conservative NDC ranges (lanes 28-31) by the reference's rule and its
// half-row slack (raster_v2.py:1346-1377, where the TPU kernel gates its
// chunks on them).  A warp skips a slot whose rows miss its eight rows, a
// thread one whose rows or columns miss its pixels; a thread that tests
// computes y*b + c of each plane once for its four pixels, then x*a + that
// per pixel.  It keeps the (z, triangle id) lexicographic minimum among
// covered slots with |z| <= 1 and writes ids (+1, 0 = background), the
// winner's 32 lanes and the winner's slot index (the backward's map).
// Bound on this card: the rows write (32 lanes a pixel) and the table
// reads; the tests are those of the (pixel, slot) pairs inside the slots'
// ranges, 15 FP32 operations each (kernels/check.py).  The design keeps
// the numeric contract: a skipped test could not cover, and every test that
// runs is test_slot's arithmetic bit for bit (signing and 1/det are exact
// per-slot work, and the contract's order x*a + (y*b + c) shares y*b + c
// along a row).  The TPU kernel's quad windows and one-hot matmul gather
// are not carried over: a row gather is a plain indexed load here.
//
// K4: one block per (tile, hypothesis).  Every slot belongs to
// exactly one tile, and every pixel's winner lies in its own tile, so the
// block sums the d_rows of the pixels that share a winner in pixel order
// (the first such pixel's thread does the sum) and writes each won slot
// once: deterministic, no atomics.  d_bins is zero-filled by the caller.
// Bound: the d_rows read (32 floats per foreground pixel).
//
// K7 runs the same two bodies over the uniform table, so its bounds are
// K3's and K4's: a tile walks only the slots its bin holds, never the
// padding up to K.
//
// K4 (and the spanning op's bf16 lane, dd_raster_bwd_bf16) reads d_rows in
// f32 or bf16 and sums in f32; K7's backward takes f32 only.
//
// Numeric contract (build with -fmad=false, no fast math): the reference's
// f32 operation order, in raster_common.cuh (test_slot, which K10 runs).

#include <cuda_bf16.h>

#include "raster_common.cuh"

namespace {

using dd::Best;
using dd::kLanes;
constexpr int kStage = 128;   // slots staged in shared memory per round
constexpr int kPix = 4;       // K3/K7: pixels of one tile row per thread

// the slots [base, base + n) of tile t in the compact table
struct CompactRange {
  const int* counts;
  const int* off_c;
  const int* used;
  int k_chunk;
  __device__ void operator()(int t, int& base, int& n) const {
    n = min(counts[t], used[t] * k_chunk);
    base = off_c[t] * k_chunk;
  }
};

// the slots [base, base + n) of tile t in the uniform-K table
struct UniformRange {
  const int* counts;
  int k;
  __device__ void operator()(int t, int& base, int& n) const {
    n = min(counts[t], k);
    base = t * k;
  }
};

// the packed pair (lo + 1) | (hi + 1) << 16 of a range clamped to [-1, n]
__device__ __forceinline__ float pack_range(int lo, int hi, int n) {
  lo = min(max(lo, -1), n);
  hi = min(max(hi, -1), n);
  return __int_as_float((lo + 1) | ((hi + 1) << 16));
}

__device__ __forceinline__ void unpack_range(float v, int& lo, int& hi) {
  const int pk = __float_as_int(v);
  lo = (pk & 0xffff) - 1;
  hi = (pk >> 16) - 1;
}

// the first and the last pixel row (or column) of a frame of n that a
// slot's NDC range [lo, hi] can cover: the reference's rule with half a
// row of slack (raster_v2.py:1346-1377), ceil((lo + 1) n/2 - 1) and
// floor((hi + 1) n/2); NaN and out-of-frame values widen to the frame
__device__ __forceinline__ int first_px(float lo, int n) {
  const float v = __fsub_rn(__fmul_rn(__fadd_rn(lo, 1.0f), 0.5f * n), 1.0f);
  if (!(v > -1.0f)) return -1;
  if (!(v < (float)n)) return n;
  return (int)ceilf(v);
}

__device__ __forceinline__ int last_px(float hi, int n) {
  const float v = __fmul_rn(__fadd_rn(hi, 1.0f), 0.5f * n);
  if (!(v < (float)n)) return n;
  if (!(v > -1.0f)) return -1;
  return (int)floorf(v);
}

// kPix values of consecutive pixels as one store (aligned: kPix divides
// the pixel index and every plane's size)
__device__ __forceinline__ void store_px(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store_px(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_px(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_px(int* p, const int (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store_px(int* p, const int (&v)[2]) {
  *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
}
__device__ __forceinline__ void store_px(int* p, const int (&v)[4]) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// dd::write_winner for a thread's kPix consecutive pixels pix.. of
// hypothesis b, each lane of the rows in one vector store
__device__ __forceinline__ void write_winners(const Best (&best)[kPix],
                                              const float* __restrict__ tb,
                                              int tot, size_t plane_px, int b,
                                              size_t pix, int* __restrict__ ids,
                                              int* __restrict__ win,
                                              float* __restrict__ rows) {
  int iv[kPix], wv[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    iv[p] = best[p].slot >= 0 ? (int)best[p].id + 1 : 0;
    wv[p] = best[p].slot;
  }
  store_px(ids + (size_t)b * plane_px + pix, iv);
  store_px(win + (size_t)b * plane_px + pix, wv);
  float* out = rows + (size_t)b * kLanes * plane_px + pix;
#pragma unroll 4
  for (int k = 0; k < kLanes; ++k) {
    float v[kPix];
#pragma unroll
    for (int p = 0; p < kPix; ++p)
      v[p] = best[p].slot >= 0 ? tb[best[p].slot + (size_t)k * tot] : 0.0f;
    store_px(out + k * plane_px, v);
  }
}

// K3/K7 forward: one block of th*tw/kPix threads per (tile, hypothesis);
// thread i owns pixels kPix*i .. kPix*i + kPix - 1 of the tile (row-major,
// one tile row).  Each round stages kStage slots slot-major in four float4
// groups (the pre-signed edge planes, the z plane, 1/det, the id and the
// slot's tile-relative row and column ranges, empty when det == 0); then a
// warp skips a slot whose rows miss its rows, a thread one whose rows or
// columns miss its pixels, and a thread that tests computes y*b + c of
// each plane once for its kPix pixels.  Every test that runs is test_slot's
// arithmetic, bit for bit.
template <class Range>
__global__ void raster_fwd_kernel(
    const float* __restrict__ bins, Range range, int tot, int ntx, int th,
    int tw, int hc, int wc, int oy, int ox, int fh, int fw,
    int* __restrict__ ids, int* __restrict__ win, float* __restrict__ rows) {
  __shared__ float4 st_e0[kStage];  // a0 b0 c0 a1, pre-signed by sign(det)
  __shared__ float4 st_e1[kStage];  // b1 c1 a2 b2
  __shared__ float4 st_z[kStage];   // c2, the z plane
  __shared__ float4 st_m[kStage];   // 1/det, id, row range, column range
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = (t / ntx) * th, c0 = (t % ntx) * tw;  // the tile's origin
  const int lr = kPix * threadIdx.x / tw;                // tile-relative row
  const int lc = kPix * threadIdx.x % tw;                // first column
  const int warp0 = threadIdx.x & ~31;
  const int warp1 = min(warp0 + 31, (int)blockDim.x - 1);
  const int wr0 = kPix * warp0 / tw, wr1 = kPix * warp1 / tw;  // warp's rows
  const float y = dd::ndc(r0 + lr + oy, fh);
  float x[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) x[p] = dd::ndc(c0 + lc + p + ox, fw);
  int base, n;
  range(t, base, n);
  const float* tb = bins + (size_t)b * kLanes * tot;

  Best best[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) best[p] = dd::none();
  for (int s0 = 0; s0 < n; s0 += kStage) {
    const int m = min(kStage, n - s0);
    __syncthreads();
    for (int j = threadIdx.x; j < m; j += blockDim.x) {
      const float* src = tb + base + s0 + j;
      auto lane = [&](int k) { return src[(size_t)k * tot]; };
      const float det = lane(12);
      if (det == 0.0f) {  // test_slot's early return: an empty row range
        st_m[j] = make_float4(0.0f, 0.0f, pack_range(th, -1, th), 0.0f);
        continue;
      }
      const float sg = det > 0.0f ? 1.0f : -1.0f;
      st_e0[j] = make_float4(lane(0) * sg, lane(1) * sg, lane(2) * sg, lane(3) * sg);
      st_e1[j] = make_float4(lane(4) * sg, lane(5) * sg, lane(6) * sg, lane(7) * sg);
      st_z[j] = make_float4(lane(8) * sg, lane(9), lane(10), lane(11));
      const int ra = r0 + oy, ca = c0 + ox;  // the tile's frame pixel origin
      st_m[j] = make_float4(
          __fdiv_rn(1.0f, det), lane(13),
          pack_range(first_px(lane(30), fh) - ra, last_px(lane(31), fh) - ra, th),
          pack_range(first_px(lane(28), fw) - ca, last_px(lane(29), fw) - ca, tw));
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float4 mj = st_m[j];
      int lo, hi;
      unpack_range(mj.z, lo, hi);
      if (hi < wr0 || lo > wr1) continue;  // the same for the whole warp
      if (lr < lo || lr > hi) continue;
      unpack_range(mj.w, lo, hi);
      if (lc + kPix - 1 < lo || lc > hi) continue;
      const float4 e0 = st_e0[j], e1 = st_e1[j], ez = st_z[j];
      // e = x*a + (y*b + c): y*b + c once per (slot, row)
      const float yb0 = __fadd_rn(__fmul_rn(y, e0.y), e0.z);
      const float yb1 = __fadd_rn(__fmul_rn(y, e1.x), e1.y);
      const float yb2 = __fadd_rn(__fmul_rn(y, e1.w), ez.x);
      const float ybz = __fadd_rn(__fmul_rn(y, ez.z), ez.w);
#pragma unroll
      for (int p = 0; p < kPix; ++p) {
        const float a = __fadd_rn(__fmul_rn(x[p], e0.x), yb0);
        const float c = __fadd_rn(__fmul_rn(x[p], e0.w), yb1);
        const float d = __fadd_rn(__fmul_rn(x[p], e1.z), yb2);
        if (!(a >= 0.0f && c >= 0.0f && d >= 0.0f)) continue;
        const float z = __fmul_rn(__fadd_rn(__fmul_rn(x[p], ez.y), ybz), mj.x);
        if (!(z >= -1.0f && z <= 1.0f)) continue;
        if (z < best[p].z || (z == best[p].z && mj.y < best[p].id)) {
          best[p].z = z;
          best[p].id = mj.y;
          best[p].slot = base + s0 + j;
        }
      }
    }
  }
  write_winners(best, tb, tot, (size_t)hc * wc, b, (size_t)(r0 + lr) * wc + c0 + lc,
                ids, win, rows);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// d_rows in T: f32, or bf16 (the spanning op's default lane), read as f32
template <typename T>
__global__ void raster_bwd_kernel(const T* __restrict__ d_rows,
                                  const int* __restrict__ win, int tot,
                                  int ntx, int th, int tw, int hc, int wc,
                                  float* __restrict__ d_bins) {
  extern __shared__ int sw[];  // winner slot per tile pixel
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int npx = th * tw;
  const int r0 = (t / ntx) * th, c0 = (t % ntx) * tw;
  const size_t plane_px = (size_t)hc * wc;
  const int p = threadIdx.x;
  auto pix_of = [&](int q) {
    return (size_t)(r0 + q / tw) * wc + (c0 + q % tw);
  };
  sw[p] = win[(size_t)b * plane_px + pix_of(p)];
  __syncthreads();
  const int s = sw[p];
  if (s < 0) return;
  for (int q = 0; q < p; ++q)
    if (sw[q] == s) return;  // an earlier pixel of this tile owns the sum
  float acc[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) acc[k] = 0.0f;
  const T* db = d_rows + (size_t)b * kLanes * plane_px;
  for (int q = p; q < npx; ++q) {
    if (sw[q] != s) continue;
    const T* src = db + pix_of(q);
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      acc[k] = __fadd_rn(acc[k], to_f32(src[k * plane_px]));
  }
  float* dst = d_bins + (size_t)b * kLanes * tot + s;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) dst[(size_t)k * tot] = acc[k];
}

}  // namespace

extern "C" int dd_raster_fwd(const float* bins, const int* counts,
                             const int* off_c, const int* used, int B,
                             int tot, int k_chunk, int nty, int ntx, int th,
                             int tw, int oy, int ox, int fh, int fw, int* ids,
                             int* win, float* rows, void* stream) {
  dim3 grid(nty * ntx, B);
  raster_fwd_kernel<<<grid, th * tw / kPix, 0, (cudaStream_t)stream>>>(
      bins, CompactRange{counts, off_c, used, k_chunk}, tot, ntx, th, tw,
      nty * th, ntx * tw, oy, ox, fh, fw, ids, win, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int raster_bwd_launch(const T* d_rows, const int* win, int B, int tot,
                      int nty, int ntx, int th, int tw, float* d_bins,
                      cudaStream_t stream) {
  dim3 grid(nty * ntx, B);
  raster_bwd_kernel<T><<<grid, th * tw, th * tw * sizeof(int), stream>>>(
      d_rows, win, tot, ntx, th, tw, nty * th, ntx * tw, d_bins);
  return (int)cudaGetLastError();
}

extern "C" int dd_raster_bwd(const float* d_rows, const int* win, int B,
                             int tot, int nty, int ntx, int th, int tw,
                             float* d_bins, void* stream) {
  return raster_bwd_launch(d_rows, win, B, tot, nty, ntx, th, tw, d_bins,
                           (cudaStream_t)stream);
}

// K4 on bf16 d_rows (the spanning op's default lane, DD_DROWS_BF16=1): each
// value widened to f32, the same f32 sums in the same order
extern "C" int dd_raster_bwd_bf16(const __nv_bfloat16* d_rows, const int* win,
                                  int B, int tot, int nty, int ntx, int th,
                                  int tw, float* d_bins, void* stream) {
  return raster_bwd_launch(d_rows, win, B, tot, nty, ntx, th, tw, d_bins,
                           (cudaStream_t)stream);
}

// K7 forward: the uniform table (B, 32, nty*ntx*k), the full frame padded
// to whole tiles, pixel NDC over the real (fh, fw) frame
extern "C" int dd_raster_uniform_fwd(const float* bins, const int* counts,
                                     int B, int k, int nty, int ntx, int th,
                                     int tw, int fh, int fw, int* ids,
                                     int* win, float* rows, void* stream) {
  dim3 grid(nty * ntx, B);
  raster_fwd_kernel<<<grid, th * tw / kPix, 0, (cudaStream_t)stream>>>(
      bins, UniformRange{counts, k}, nty * ntx * k, ntx, th, tw, nty * th,
      ntx * tw, 0, 0, fh, fw, ids, win, rows);
  return (int)cudaGetLastError();
}

// K7 backward: d_bins (B, 32, nty*ntx*k) from d_rows over the winner-slot
// map of K7's forward; d_bins is zero-filled by the caller (the tail of
// every tile stays 0, the TPU kernel's zero_tail)
extern "C" int dd_raster_uniform_bwd(const float* d_rows, const int* win,
                                     int B, int k, int nty, int ntx, int th,
                                     int tw, float* d_bins, void* stream) {
  return raster_bwd_launch(d_rows, win, B, nty * ntx * k, nty, ntx, th, tw,
                           d_bins, (cudaStream_t)stream);
}
