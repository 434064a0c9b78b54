// Bin-table raster forward and backward for Hopper (sm_90a): over the
// compact table (K3, K4) and over the uniform-K table (K7); and the
// sorted-range raster's forward (K10): K3's stage and tests over the
// chunks of the sorted table.
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
// rows and columns of the tile the slot can cover, taken from its f32 edge
// planes (dd::cover_range, over the whole window: they hold in the padding
// and for slivers).  Every slot belongs to one tile, so the staging block
// is the one place its box is computed, once per (hypothesis, slot), and
// nothing is computed for the uniform table's padding past a tile's count.
// (The TPU kernel gates whole 128-slot chunks on the packed table's vertex
// bounds, lanes 28-31, with slack, raster_v2.py:1346-1377: those miss a
// sliver's pixels past its corners and the padding past the frame's
// edge.)  A warp skips a slot whose rows miss its eight rows, a thread one
// whose rows or columns miss its pixels; a thread that tests computes
// y*b + c of each plane once for its four pixels, then x*a + that per
// pixel.  It keeps the (z, triangle id) lexicographic minimum among
// covered slots with |z| <= 1 and writes ids (+1, 0 = background), the
// winner's 32 lanes and the winner's slot index (the backward's map).
// Bound on this card: the rows write (32 lanes a pixel) and the table
// reads; the tests are those of the (pixel, slot) pairs inside the slots'
// ranges, 15 FP32 operations each (kernels/check.py).  The design keeps
// the numeric contract: a skipped test could not cover, and every test that
// runs is the reference's per-slot arithmetic bit for bit (signing and
// 1/det are exact per-slot work, and the contract's order x*a + (y*b + c)
// shares y*b + c along a row).  The TPU kernel's quad windows and one-hot
// matmul gather are not carried over: a row gather is a plain indexed load
// here.
//
// K4: one block per (16 x 16 tile, hypothesis).  Every slot belongs to
// exactly one tile, and every pixel's winner lies in its own tile, so the
// block sums the d_rows of the pixels that share a winner in pixel order
// and writes every slot the tile holds: deterministic, no atomics.  The
// design (raster_bwd_kernel): the tile's pixels are grouped by winner with a
// bitonic sort of 256 (slot, pixel) keys, O(n log^2 n), no per-pixel scan
// of the tile; the tile's d_rows are staged in shared memory with 4-pixel
// vector loads; one warp a run, one thread a lane, adds the run from +0 in
// ascending pixel order (each slot's sum in the reference's order);
// the held slots are written coalesced, consecutive threads on consecutive
// slots of a lane in float4 streaming stores, 0 where no pixel won (the TPU
// kernel's zero_tail), and
// extra blocks zero the compact table's tail past the held chunks, so the
// caller allocates d_bins without a zero fill.  Bound: the d_rows read (32
// lanes per foreground pixel), win, and the d_bins write.

// K7 runs the same two bodies over the uniform table, so its bounds are
// K3's and K4's: a tile walks only the slots its bin holds, never the
// padding up to K.
//
// K10's forward replaces diffdope_tpu/render/raster_v3.py:_fwd_kernel_v3
// (driven by raster_gather_rows_v3; its backward is in raster_v3.cu).  The
// tile's candidates are the 128-slot chunks of the (band, x_min)-sorted
// table that the chunk gate admits (SortedRange), and a chunk that
// straddles tiles is a candidate in each: the TPU kernel tests every slot
// of them (~4.85x the exact bins' slots at the bench shapes).  Here each
// candidate's rows and columns are taken from its edge planes first
// (dd::cover_range, as K3's: they hold over the padded frame and for
// slivers), and only the slots whose rows and columns meet the tile are
// staged, many chunks to a stage (raster_v3_fwd_kernel);
// the pixels, the stage and the tests are K3's.  So the outputs are the
// TPU kernel's and the plain twin's on every pixel of the padded frame.
// Bound: the rows write, as K3's, and the tests inside the slots' ranges.
//
// K4 (and the spanning op's bf16 lane, dd_raster_bwd_bf16) reads d_rows in
// f32 or bf16 and sums in f32; K7's backward takes f32 only and writes each
// tile's whole bin, the padding past its count included.
//
// Numeric contract (build with -fmad=false, no fast math): the reference's
// f32 operation order, as raster_common.cuh states it.

#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>

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

// K10: the chunks [c*kChunk, (c + 1)*kChunk) of the sorted table that
// tile t walks (the gate of dd::v3_gated), in ascending order.  A warp
// decides the gate of 32 chunks at once, lane l on chunk c0 + l (one
// coalesced load of the tile's rlo_tc/rhi_tc row), and every warp of the
// block gets the same ballot: the block's threads must be whole warps.
struct SortedRange {
  const int* clo;
  const int* chi;
  const int* rlo_tc;
  const int* rhi_tc;
  int nc, ntx, th;
  struct Cursor {
    const int* lo_t;  // the tile's rlo_tc and rhi_tc rows
    const int* hi_t;
    int c0, end, y0, y1;
    unsigned mask;  // the gated chunks of [c0, c0 + 32) not yet walked
    __device__ unsigned window() const {
      const int c = c0 + (threadIdx.x & 31);
      bool g = false;
      if (c < end) {
        const int lo = lo_t[c], hi = hi_t[c];
        g = lo <= hi && lo <= y1 && hi >= y0;
      }
      return __ballot_sync(0xffffffffu, g);
    }
    // the next chunk's first slot
    __device__ bool next(int& base) {
      while (mask == 0) {
        c0 += 32;
        if (c0 >= end) return false;
        mask = window();
      }
      base = (c0 + __ffs(mask) - 1) * dd::kChunk;
      mask &= mask - 1;
      return true;
    }
  };
  __device__ Cursor cursor(int t) const {
    const int ty = t / ntx;
    Cursor c{rlo_tc + (size_t)t * nc, rhi_tc + (size_t)t * nc, clo[ty], chi[ty], ty * th,
             ty * th + th - 1, 0u};
    c.mask = c.window();
    return c;
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

// writes a thread's kPix consecutive pixels pix.. of hypothesis b: ids
// (+1, 0 = background), win (the winner's slot, -1) and the winner's 32
// lanes of table tb (B's slice, ``tot`` slots a lane; zeros on
// background), each lane of the rows in one vector store
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
// slot's tile-relative row and column ranges, dd::cover_range of its
// planes over the window, empty when det == 0); then a warp skips a slot
// whose rows miss its rows, a thread one whose rows or columns miss its
// pixels, and a thread that tests computes y*b + c of
// each plane once for its kPix pixels.  Every test that runs is the
// reference's per-slot arithmetic, bit for bit.
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
  // |x| and |y| over the window: the boxes hold over all of it
  const double xm = dd::extent(ox, wc, fw), ym = dd::extent(oy, hc, fh);

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
      if (det == 0.0f) {  // no pixel is covered: an empty row range
        st_m[j] = make_float4(0.0f, 0.0f, pack_range(th, -1, th), 0.0f);
        continue;
      }
      const float sg = det > 0.0f ? 1.0f : -1.0f;
      float pa[3], pb[3], pc[3];  // the edge planes, pre-signed
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pa[k] = lane(3 * k) * sg;
        pb[k] = lane(3 * k + 1) * sg;
        pc[k] = lane(3 * k + 2) * sg;
      }
      st_e0[j] = make_float4(pa[0], pb[0], pc[0], pa[1]);
      st_e1[j] = make_float4(pb[1], pc[1], pa[2], pb[2]);
      st_z[j] = make_float4(pc[2], lane(9), lane(10), lane(11));
      int rlo, rhi, clo, chi;
      dd::cover_range(pa, pb, pc, xm, ym, fh, fw, rlo, rhi, clo, chi);
      const int ra = r0 + oy, ca = c0 + ox;  // the tile's frame pixel origin
      st_m[j] = make_float4(__fdiv_rn(1.0f, det), lane(13),
                            pack_range(rlo - ra, rhi - ra, th),
                            pack_range(clo - ca, chi - ca, tw));
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

// K10 forward: one block of kV3Threads threads per (16 x 16 tile,
// hypothesis), the pixels, the stage and the tests of K3/K7's body above;
// only the staging differs.  The tile's candidates are the gated chunks of
// the sorted table (SortedRange).  For each chunk a thread loads the det
// and the box (the pre-pass's cover_range) of its kCand candidates (j =
// i*kV3Threads + tid) at once; a slot whose rows or columns miss the whole
// tile cannot win in it and is not staged; the others fill the stage in
// the order of a block prefix sum of the threads' survivors, from as many
// chunks as fit, and the stage keeps each survivor's table slot for win.
// The order in which slots are tested does not change the (z, id)
// minimum: ids are unique in the table.  The boxes hold over the whole
// padded frame (nty*16, ntx*16), padding included, so every pixel gets the
// plain twin's winner.  (K3's body itself, walked over segments, measured
// 3.5% slower for K3 and 7% for K7: the two keep their loop.)
constexpr int kV3Th = 16, kV3Tw = 16;               // K10's tile
constexpr int kV3Threads = kV3Th * kV3Tw / kPix;    // 64: two warps
constexpr int kCand = dd::kChunk / kV3Threads;      // a chunk's candidates a thread
static_assert(dd::kChunk == kStage, "a chunk's survivors fit one stage");

// K10's pre-pass: one thread per (hypothesis, slot) of the sorted table,
// its frame rows and columns (dd::slot_box over the padded frame hc x wc)
// packed into boxes[b*tot + slot]: the f64 work once per slot, not once
// per tile that walks it
__global__ void raster_v3_boxes_kernel(const float* __restrict__ bins, int tot, int hc,
                                       int wc, int fh, int fw, int2* __restrict__ boxes) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= tot) return;
  const float* src = bins + (size_t)b * kLanes * tot + j;
  boxes[(size_t)b * tot + j] =
      dd::slot_box([&](int k) { return src[(size_t)k * tot]; }, dd::extent(0, wc, fw),
                   dd::extent(0, hc, fh), fh, fw);
}

__global__ void __launch_bounds__(kV3Threads)
    raster_v3_fwd_kernel(const float* __restrict__ bins, const int2* __restrict__ boxes,
                         SortedRange range, int tot, int ntx, int hc, int wc, int fh,
                         int fw, int* __restrict__ ids, int* __restrict__ win,
                         float* __restrict__ rows) {
  __shared__ float4 st_e0[kStage];  // a0 b0 c0 a1, pre-signed by sign(det)
  __shared__ float4 st_e1[kStage];  // b1 c1 a2 b2
  __shared__ float4 st_z[kStage];   // c2, the z plane
  __shared__ float4 st_m[kStage];   // 1/det, id, row range, column range
  __shared__ int st_slot[kStage];   // the staged slot's index in the table
  __shared__ int st_warp[2][kV3Threads / 32];  // survivors a warp, two rounds in turn
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = (t / ntx) * kV3Th, c0 = (t % ntx) * kV3Tw;  // the tile's origin
  const int lr = kPix * threadIdx.x / kV3Tw;                  // tile-relative row
  const int lc = kPix * threadIdx.x % kV3Tw;                  // first column
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr0 = kPix * 32 * warp / kV3Tw, wr1 = wr0 + kPix * 32 / kV3Tw - 1;  // warp's rows
  const float y = dd::ndc(r0 + lr, fh);
  float x[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) x[p] = dd::ndc(c0 + lc + p, fw);
  auto cur = range.cursor(t);
  const float* tb = bins + (size_t)b * kLanes * tot;

  Best best[kPix];
#pragma unroll
  for (int p = 0; p < kPix; ++p) best[p] = dd::none();
  // the m staged slots against the thread's pixels: K3's loop
  auto test = [&](int m) {
    for (int j = 0; j < m; ++j) {
      const float4 mj = st_m[j];
      int lo, hi;
      unpack_range(mj.z, lo, hi);
      if (hi < wr0 || lo > wr1) continue;  // the same for the whole warp
      if (lr < lo || lr > hi) continue;
      unpack_range(mj.w, lo, hi);
      if (lc + kPix - 1 < lo || lc > hi) continue;
      const float4 e0 = st_e0[j], e1 = st_e1[j], ez = st_z[j];
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
          best[p].slot = st_slot[j];
        }
      }
    }
  };

  int base, m = 0, round = 0;
  while (cur.next(base)) {
    // the thread's candidates: det and the frame rows and columns each can
    // cover (cover_range, from the pre-pass), all loads at once
    float det[kCand];
    int2 box[kCand];
#pragma unroll
    for (int i = 0; i < kCand; ++i) {
      const int j = base + i * kV3Threads + threadIdx.x;
      det[i] = tb[(size_t)12 * tot + j];
      box[i] = boxes[(size_t)b * tot + j];
    }
    // those whose rows and columns meet the tile (det 0: no pixel is
    // covered), and their tile-relative ranges
    unsigned keep = 0;
    int rlo[kCand], rhi[kCand], clo[kCand], chi[kCand];
#pragma unroll
    for (int i = 0; i < kCand; ++i) {
      dd::unpack_box(box[i].x, rlo[i], rhi[i]);
      dd::unpack_box(box[i].y, clo[i], chi[i]);
      rlo[i] -= r0;
      rhi[i] -= r0;
      clo[i] -= c0;
      chi[i] -= c0;
      if (det[i] != 0.0f && rlo[i] <= rhi[i] && rhi[i] >= 0 && rlo[i] <= kV3Th - 1 &&
          clo[i] <= chi[i] && chi[i] >= 0 && clo[i] <= kV3Tw - 1)
        keep |= 1u << i;
    }
    // a block prefix sum of the survivors, in thread order
    const int cnt = __popc(keep);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane_id >= o) incl += v;
    }
    if (lane_id == 31) st_warp[round][warp] = incl;
    __syncthreads();  // the stage's writes before it are done too
    int pos = incl - cnt, total = 0;
#pragma unroll
    for (int w = 0; w < kV3Threads / 32; ++w) {
      const int v = st_warp[round][w];
      total += v;
      if (w < warp) pos += v;
    }
    round ^= 1;
    if (m + total > kStage) {  // the same for the whole block
      test(m);
      __syncthreads();
      m = 0;
    }
    pos += m;
    // stage the survivors as K3 does: the planes pre-signed, the z plane,
    // 1/det, the id and the packed ranges
#pragma unroll
    for (int i = 0; i < kCand; ++i) {
      if (!(keep >> i & 1u)) continue;
      const int j = base + i * kV3Threads + threadIdx.x;
      const float* src = tb + j;
      auto lane = [&](int k) { return src[(size_t)k * tot]; };
      const float sg = det[i] > 0.0f ? 1.0f : -1.0f;
      st_e0[pos] = make_float4(lane(0) * sg, lane(1) * sg, lane(2) * sg, lane(3) * sg);
      st_e1[pos] = make_float4(lane(4) * sg, lane(5) * sg, lane(6) * sg, lane(7) * sg);
      st_z[pos] = make_float4(lane(8) * sg, lane(9), lane(10), lane(11));
      st_m[pos] = make_float4(__fdiv_rn(1.0f, det[i]), lane(13),
                              pack_range(rlo[i], rhi[i], kV3Th),
                              pack_range(clo[i], chi[i], kV3Tw));
      st_slot[pos++] = j;
    }
    m += total;
  }
  __syncthreads();
  test(m);
  write_winners(best, tb, tot, (size_t)hc * wc, b, (size_t)(r0 + lr) * wc + c0 + lc,
                ids, win, rows);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the tile K4 takes: 16 x 16 pixels, one a thread (the sort's width)
constexpr int kBwdTh = 16, kBwdTw = 16, kBwdPx = kBwdTh * kBwdTw;
constexpr int kRowPad = kLanes + 1;  // a staged pixel's lanes, padded
constexpr int kMapChunk = 1024;      // held slots mapped to their run a round
constexpr int kTailSlots = 4096;     // slots of the table's tail a block zeroes
constexpr unsigned kNoKey = 0xffffffffu;  // a background pixel's key

// the slots [base, base + n) that tile t holds in the compact table: its
// chunks, the slots past its count in its last chunk included
struct CompactHeld {
  const int* off_c;
  const int* used;
  int k_chunk;
  __device__ void operator()(int t, int& base, int& n) const {
    base = off_c[t] * k_chunk;
    n = used[t] * k_chunk;
  }
  // the end of the chunks the tiles hold: the table's tail starts there
  __device__ int end(int ntiles) const {
    int e = 0;
    for (int t = threadIdx.x; t < ntiles; t += blockDim.x)
      e = max(e, (off_c[t] + used[t]) * k_chunk);
    return e;
  }
};

// the slots [t*K, (t + 1)*K) of the uniform table: its whole bin, the
// padding past its count included; no tail
struct UniformHeld {
  int k;
  __device__ void operator()(int t, int& base, int& n) const {
    base = t * k;
    n = k;
  }
  __device__ int end(int ntiles) const { return ntiles * k; }
};

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const unsigned w[2] = {q.x, q.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat16 h;
    const unsigned short bits = (unsigned short)(w[i / 2] >> (16 * (i % 2)));
    memcpy(&h, &bits, sizeof(h));
    v[i] = __bfloat162float(h);  // exact
  }
}

// K4/K7 backward, d_rows in T (f32, or bf16 widened to f32): one block of
// 256 threads per (16 x 16 tile, hypothesis), thread p on pixel p of the
// tile (row-major).  (1) Each pixel's key, its winner's slot relative to
// the tile's first held slot and its index, (rel << 8) | p (background
// last), and the tile's d_rows staged in shared memory: one 4-pixel vector
// load per (lane, tile row, quarter row), none where the four pixels are
// background.  (2) A bitonic sort of the 256 keys (shuffles within a warp,
// shared memory across warps): each winner's pixels form a run in
// ascending pixel order.  (3) One warp per run, one thread per lane, sums
// the run from +0 in that order.
// (4) Every slot the tile holds is written, consecutive threads on
// consecutive slots of a lane, four slots a thread in one streaming float4
// store (__stcs: d_bins is read by a later kernel, not this one) where
// ``vec4`` (every held range and the lane stride a multiple of 4, the base
// aligned): the run's sum at a won slot, 0 elsewhere.
// Blocks past the tiles zero the table's tail (slots no tile holds, after
// the held chunks), each kTailSlots of it, so d_bins needs no zero fill.
template <typename T, class Held>
__global__ void __launch_bounds__(kBwdPx)
    raster_bwd_kernel(const T* __restrict__ d_rows, const int* __restrict__ win,
                      Held held, int tot, int ntiles, int ntx, int hc, int wc,
                      bool vec4, float* __restrict__ d_bins) {
  __shared__ float st[kBwdPx][kRowPad];  // the staged d_rows, then run sums
  __shared__ unsigned keys[kBwdPx];
  __shared__ unsigned run_starts[kBwdPx / 32];
  __shared__ int run_pos[kBwdPx + 1];  // sorted position of each run's start
  __shared__ int map[kMapChunk];       // held slot -> its run's first pixel
  __shared__ int tail_start;
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int p = threadIdx.x;
  float* out = d_bins + (size_t)b * kLanes * tot;
  if (t >= ntiles) {  // the tail: slots past every held chunk
    if (p == 0) tail_start = 0;
    __syncthreads();
    atomicMax(&tail_start, held.end(ntiles));
    __syncthreads();
    const int lo = max(tail_start, (t - ntiles) * kTailSlots);
    const int hi = min(tot, (t - ntiles + 1) * kTailSlots);
    for (int k = 0; k < kLanes; ++k) {
      if (vec4) {  // lo and hi are multiples of 4
        for (int j = lo + 4 * p; j < hi; j += 4 * kBwdPx)
          __stcs(reinterpret_cast<float4*>(out + (size_t)k * tot + j),
                 make_float4(0.0f, 0.0f, 0.0f, 0.0f));
      } else {
        for (int j = lo + p; j < hi; j += kBwdPx) out[(size_t)k * tot + j] = 0.0f;
      }
    }
    return;
  }
  const int r0 = (t / ntx) * kBwdTh, c0 = (t % ntx) * kBwdTw;
  const size_t plane_px = (size_t)hc * wc;
  int base, n_held;
  held(t, base, n_held);
  const int s = win[(size_t)b * plane_px + (size_t)(r0 + p / kBwdTw) * wc + c0 + p % kBwdTw];
  unsigned key = s >= 0 ? (unsigned)(s - base) << 8 | p : kNoKey;
  keys[p] = key;
  const int n_fg = __syncthreads_count(s >= 0);

  int n_runs = 0;
  if (n_fg > 0) {  // the same for the whole block
    // (1) stage: item i is (lane 4 kh + kl, row 2 rh + rl, quarter g), so a
    // warp's 32 stores to st hit 32 banks
    const T* db = d_rows + (size_t)b * kLanes * plane_px;
    for (int i = p; i < kLanes * kBwdTh * (kBwdTw / 4); i += kBwdPx) {
      const int g = i & 3, rl = (i >> 2) & 1, kl = (i >> 3) & 3, rh = (i >> 5) & 7,
                kh = i >> 8;
      const int row = 2 * rh + rl, k = 4 * kh + kl, p0 = row * kBwdTw + 4 * g;
      if (keys[p0] == kNoKey && keys[p0 + 1] == kNoKey && keys[p0 + 2] == kNoKey &&
          keys[p0 + 3] == kNoKey)
        continue;
      float v[4];
      load4(db + k * plane_px + (size_t)(r0 + row) * wc + c0 + 4 * g, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) st[p0 + e][k] = v[e];
    }
    // (2) bitonic sort, ascending; keys are distinct (they hold the pixel)
    for (int size = 2; size <= kBwdPx; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        unsigned other;
        if (stride >= 32) {
          __syncthreads();
          keys[p] = key;
          __syncthreads();
          other = keys[p ^ stride];
        } else {
          other = __shfl_xor_sync(0xffffffffu, key, stride);
        }
        const bool ascending = (p & size) == 0, lower = (p & stride) == 0;
        key = lower == ascending ? min(key, other) : max(key, other);
      }
    }
    __syncthreads();
    keys[p] = key;
    __syncthreads();
    // the runs: a run starts where the winner changes
    const bool start = key != kNoKey && (p == 0 || (keys[p - 1] >> 8) != (key >> 8));
    const unsigned ballot = __ballot_sync(0xffffffffu, start);
    if ((p & 31) == 0) run_starts[p >> 5] = ballot;
    __syncthreads();
    int before = __popc(ballot & ((1u << (p & 31)) - 1u));
    for (int w = 0; w < kBwdPx / 32; ++w) {
      if (w < (p >> 5)) before += __popc(run_starts[w]);
      n_runs += __popc(run_starts[w]);
    }
    if (start) run_pos[before] = p;
    if (p == 0) run_pos[n_runs] = n_fg;
    __syncthreads();
    // (3) a warp a run, a thread a lane: the sum from +0 in pixel order,
    // left at the run's first pixel
    const int lane = p & 31;
    for (int r = p >> 5; r < n_runs; r += kBwdPx / 32) {
      const int first = keys[run_pos[r]] & 0xff;
      float acc = 0.0f;
      for (int q = run_pos[r]; q < run_pos[r + 1]; ++q)
        acc = __fadd_rn(acc, st[keys[q] & 0xff][lane]);
      st[first][lane] = acc;
    }
  }

  // (4) every held slot: its run's sum, or 0
  for (int j0 = 0; j0 < n_held; j0 += kMapChunk) {
    const int cn = min(kMapChunk, n_held - j0);
    if (n_runs > 0) {
      __syncthreads();
      for (int j = p; j < cn; j += kBwdPx) map[j] = -1;
      __syncthreads();
      for (int r = p; r < n_runs; r += kBwdPx) {
        const unsigned kr = keys[run_pos[r]];
        const int rel = (int)(kr >> 8) - j0;
        if (rel >= 0 && rel < cn) map[rel] = kr & 0xff;
      }
      __syncthreads();
    }
    float* dst = out + base + j0;
    if (vec4) {  // cn is a multiple of 4
      for (int k = 0; k < kLanes; ++k)
        for (int j = 4 * p; j < cn; j += 4 * kBwdPx) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = n_runs > 0 ? map[j + e] : -1;
            v[e] = q >= 0 ? st[q][k] : 0.0f;
          }
          __stcs(reinterpret_cast<float4*>(dst + (size_t)k * tot + j),
                 make_float4(v[0], v[1], v[2], v[3]));
        }
    } else {
      for (int k = 0; k < kLanes; ++k)
        for (int j = p; j < cn; j += kBwdPx) {
          const int q = n_runs > 0 ? map[j] : -1;
          dst[(size_t)k * tot + j] = q >= 0 ? st[q][k] : 0.0f;
        }
    }
  }
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

// ``align`` divides every tile's held range (its base and its size)
template <typename T, class Held>
int raster_bwd_launch(const T* d_rows, const int* win, Held held, int align, int n_tail,
                      int B, int tot, int nty, int ntx, int th, int tw, float* d_bins,
                      cudaStream_t stream) {
  // the keys hold a relative slot in 24 bits (all ones: background)
  if (th != kBwdTh || tw != kBwdTw || tot >= (1 << 24) - 1)
    return (int)cudaErrorInvalidValue;
  const bool vec4 = align % 4 == 0 && tot % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(d_bins) % sizeof(float4) == 0;
  dim3 grid(nty * ntx + n_tail, B);
  raster_bwd_kernel<T, Held><<<grid, kBwdPx, 0, stream>>>(
      d_rows, win, held, tot, nty * ntx, ntx, nty * th, ntx * tw, vec4, d_bins);
  return (int)cudaGetLastError();
}

// K4: d_bins (B, 32, tot) of the compact table, every slot written (the
// held chunks by their tiles, the tail past them by extra blocks)
extern "C" int dd_raster_bwd(const float* d_rows, const int* win, const int* off_c,
                             const int* used, int B, int tot, int k_chunk, int nty,
                             int ntx, int th, int tw, float* d_bins, void* stream) {
  return raster_bwd_launch(d_rows, win, CompactHeld{off_c, used, k_chunk}, k_chunk,
                           (tot + kTailSlots - 1) / kTailSlots, B, tot, nty, ntx, th,
                           tw, d_bins, (cudaStream_t)stream);
}

// K4 on bf16 d_rows (the spanning op's default lane, DD_DROWS_BF16=1): each
// value widened to f32, the same f32 sums in the same order
extern "C" int dd_raster_bwd_bf16(const __nv_bfloat16* d_rows, const int* win,
                                  const int* off_c, const int* used, int B, int tot,
                                  int k_chunk, int nty, int ntx, int th, int tw,
                                  float* d_bins, void* stream) {
  return raster_bwd_launch(d_rows, win, CompactHeld{off_c, used, k_chunk}, k_chunk,
                           (tot + kTailSlots - 1) / kTailSlots, B, tot, nty, ntx, th,
                           tw, d_bins, (cudaStream_t)stream);
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
// map of K7's forward; every tile writes its whole bin (the padding past its
// count as 0, the TPU kernel's zero_tail), so every slot is written
extern "C" int dd_raster_uniform_bwd(const float* d_rows, const int* win,
                                     int B, int k, int nty, int ntx, int th,
                                     int tw, float* d_bins, void* stream) {
  return raster_bwd_launch(d_rows, win, UniformHeld{k}, k, 0, B, nty * ntx * k, nty, ntx,
                           th, tw, d_bins, (cudaStream_t)stream);
}

// K10 forward: the sorted table packed_s (B, 32, tp) over the chunks each
// tile walks (SortedRange), compacted to the slots whose boxes meet the
// tile; the frame padded to whole 16 x 16 tiles (nty*16, ntx*16), below
// 2^15 pixels a side, pixel NDC over the real (fh, fw) frame; boxes is
// scratch of B*tp int2 for the pre-pass
extern "C" int dd_raster_v3_fwd(const float* packed_s, const int* clo,
                                const int* chi, const int* rlo_tc,
                                const int* rhi_tc, int B, int tp, int nty,
                                int ntx, int th, int tw, int fh, int fw,
                                int* ids, int* win, float* rows, int* boxes,
                                void* stream) {
  const int hc = nty * kV3Th, wc = ntx * kV3Tw;
  if (th != kV3Th || tw != kV3Tw || tp % dd::kChunk || hc > 32767 || wc > 32767)
    return (int)cudaErrorInvalidValue;
  int2* box = reinterpret_cast<int2*>(boxes);
  raster_v3_boxes_kernel<<<dim3((tp + 255) / 256, B), 256, 0, (cudaStream_t)stream>>>(
      packed_s, tp, hc, wc, fh, fw, box);
  raster_v3_fwd_kernel<<<dim3(nty * ntx, B), kV3Threads, 0, (cudaStream_t)stream>>>(
      packed_s, box, SortedRange{clo, chi, rlo_tc, rhi_tc, tp / dd::kChunk, ntx, kV3Th},
      tp, ntx, hc, wc, fh, fw, ids, win, rows);
  return (int)cudaGetLastError();
}
