// Binned triangle-id search of the nvdiffrast-style rasterize() op for
// Hopper (sm_90a): K8; and the v1 raster + row gather on the same search:
// K9 (its forward shares K8's kernel; its backward is further down).
//
// Replaces diffdope_tpu/render/rasterize.py:_raster_tile_kernel (launched by
// raster_ids_pallas).  The plain torch version that it is held to is
// raster_ids_binned_plain in diffdope_tpu_torch/render/rasterize.py.
//
// Inputs: setup rows coef (B, T, 16) f32 (setup_tris.py layout: lanes 0-8
// the edge planes c0, c1, c2 over (X, Y, 1), 9-11 zc, 12 det), the
// row-major tiles' bins tile_idx (num_tiles, K) i32, shared by the batch
// and ascending within a tile, and counts (num_tiles,) i32.  Output: ids of
// the padded (nty*th, ntx*tw) frame (B, ., .) i32, winner's index + 1,
// 0 = background.
//
// Design.  The TPU kernel runs one grid step per (hypothesis, tile of the
// op's tile_hw, 32 x 128 by default) and tests every bin entry at every
// pixel of the tile.  Here:
// - a pre-pass (row_boxes_kernel) computes each (hypothesis, triangle)'s
//   cover box once, the frame rows and columns its f32 edge planes can
//   cover (dd::cover_range in raster_common.cuh, over the padded frame; a
//   triangle sits in several tiles' bins);
// - one block of 64 threads per (16 x 16 sub-tile of a tile, hypothesis),
//   four pixels of one row a thread: at phase 9's shapes (960 x 540, B = 8,
//   17 x 8 tiles) 17,408 blocks where one per tile gave 1,088, of which the
//   few busy ones held the card;
// - the block walks its tile's bin in ascending order, 128 entries a
//   round, each thread two consecutive entries: it keeps those whose box
//   meets the sub-tile and compacts them with a block prefix sum in that
//   order into a stage of 128 slots in shared memory (rows read as four
//   float4, the edge planes pre-signed by sign(det), the slot's rows and
//   columns relative to the sub-tile), so a triangle of a few pixels is
//   tested in the one or two sub-tiles it meets, not at 4,096 pixels;
// - a warp skips a staged slot whose rows miss its eight rows, a thread
//   one whose rows or columns miss its pixels; a thread computes the first
//   edge at its four pixels first, the others only where it passes, and
//   the IEEE divide only at a covered pixel;
// - the stage is tested in its order, the bin's ascending order, so the
//   strict z < keeps the smallest bin index on a tie, as the TPU kernel's
//   fori_loop does.
// Bound on this card: the per-(pixel, slot) tests inside each slot's box
// (kernels/check.py counts them; the TPU kernel's tests, every pixel of the
// tile against every entry of its bin, are kept there as tested_pairs),
// and K9's rows write.  The TPU kernel's pre-gathered (B, tiles, K, 16)
// table, which exists only to give Pallas legal block shapes, is not built.
//
// Numeric contract (build with -fmad=false, no fast math), the reference's
// f32 operation order (rasterize.py:123-143), which is not K3's: pixel NDC
// x = (2*col + 1)/W - 1 with an IEEE divide; e = (c0*x + c1*y) + c2 without
// FMA; coverage e*sign(det) >= 0 on all three edges and det != 0 (the
// pre-signed planes' e >= 0: negation is exact and rounding symmetric, so
// their e is -e or e bit for bit up to the sign of a zero, which >= 0 does
// not see); z = zlin / det with an IEEE divide (K3 multiplies by 1/det);
// -1 <= z <= 1 and a strictly smaller z wins.  A skipped test could not
// cover, so ids are the TPU kernel's and the plain twin's.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "raster_common.cuh"

namespace {

constexpr int kWidth = 16;      // lanes of a setup row
constexpr int kRowWidth = 32;   // lanes of a packed row (K9)
constexpr int kSub = 16;        // a block's sub-tile: kSub x kSub pixels
constexpr int kPx = 4;          // pixels of one sub-tile row a thread
constexpr int kThreads = kSub * kSub / kPx;  // 64: two warps
constexpr int kWarps = kThreads / 32;
constexpr int kWarpRows = 32 * kPx / kSub;   // rows of a warp: 8
constexpr int kCand = 2;                     // consecutive bin entries a thread a round
constexpr int kRound = kThreads * kCand;     // 128
constexpr int kStage = 128;                  // staged slots
static_assert(kRound <= kStage, "a round's survivors fit the stage");

__device__ __forceinline__ float ndc(int pix, int frame) {
  return __fsub_rn(
      __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, (float)pix), 1.0f), (float)frame),
      1.0f);
}

// (a*x + b*y) + c, each product and sum rounded (no FMA), b*y given
__device__ __forceinline__ float edge(float a, float by, float c, float x) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), by), c);
}

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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a thread's kPx pixels' values from dst on: one vector store where all
// are in the tile and dst is 16-byte aligned (``vec``), else the first np
__device__ __forceinline__ void store_px(int* dst, const int (&v)[kPx], int np, bool vec) {
  if (vec) {
    *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int p = 0; p < kPx; ++p)
      if (p < np) dst[p] = v[p];
  }
}
__device__ __forceinline__ void store_px(float* dst, const float (&v)[kPx], int np,
                                         bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int p = 0; p < kPx; ++p)
      if (p < np) dst[p] = v[p];
  }
}

// the pre-pass: one thread per (hypothesis, row) of rows (B, T, W), its
// packed cover box (dd::slot_box over the padded hp x wp frame, pixel NDC
// over the real fh x fw) into boxes[b*T + row]
template <int W>
__global__ void row_boxes_kernel(const float* __restrict__ coef, int T, int hp, int wp,
                                 int fh, int fw, int2* __restrict__ boxes) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (j >= T) return;
  const float* src = coef + ((size_t)b * T + j) * W;
  boxes[(size_t)b * T + j] = dd::slot_box([&](int k) { return src[k]; },
                                          dd::extent(0, wp, fw), dd::extent(0, hp, fh),
                                          fh, fw);
}

// kRows false: K8, rows ``coef`` (B, T, 16), the id is the bin entry + 1.
// kRows true: K9, rows ``coef`` (B, T, 32) of shade.pack_rows, the id is
// lane 13 + 1 (the triangle index the row carries), and the block also
// writes the winner's flat slot t*K + k (-1 on background) to ``win`` and
// its 32 lanes to the planar ``rows`` (B, 32, hp, wp).  Block x is (tile
// t, sub-tile s of the tile's nsub, row-major by nsx a row); a sub-tile
// cut by the tile's edge tests and writes only its pixels in the tile.
template <bool kRows>
__global__ void __launch_bounds__(kThreads)
    raster_ids_kernel(const float* __restrict__ coef, const int* __restrict__ tile_idx,
                      const int* __restrict__ counts, const int2* __restrict__ boxes,
                      int T, int K, int ntx, int th, int tw, int nsx, int nsub, int hp,
                      int wp, int fh, int fw, int* __restrict__ ids,
                      int* __restrict__ win, float* __restrict__ rows) {
  constexpr int width = kRows ? kRowWidth : kWidth;
  __shared__ float4 st_e0[kStage];  // a0 b0 c0 a1, pre-signed by sign(det)
  __shared__ float4 st_e1[kStage];  // b1 c1 a2 b2
  __shared__ float4 st_z[kStage];   // c2, the z plane zc
  __shared__ float4 st_m[kStage];   // det, id (int bits), row range, column range
  __shared__ int st_k[kRows ? kStage : 1];      // the slot's bin position (win)
  __shared__ int st_warp[2][kWarps];            // survivors a warp, two rounds in turn
  const int t = blockIdx.x / nsub, sub = blockIdx.x % nsub;
  const int b = blockIdx.y;
  const int sr = (sub / nsx) * kSub, sc = (sub % nsx) * kSub;     // in the tile
  const int r0 = (t / ntx) * th + sr, c0 = (t % ntx) * tw + sc;   // in the frame
  const int sh = min(kSub, th - sr), sw = min(kSub, tw - sc);     // inside the tile
  const int lr = threadIdx.x / (kSub / kPx);                      // sub-tile row
  const int lc = kPx * (threadIdx.x % (kSub / kPx));              // first column
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr0 = warp * kWarpRows, wr1 = wr0 + kWarpRows - 1;    // warp's rows
  const float y = ndc(r0 + lr, fh);
  float x[kPx];
#pragma unroll
  for (int p = 0; p < kPx; ++p) x[p] = ndc(c0 + lc + p, fw);
  const int n = min(counts[t], K);
  const int* bin = tile_idx + (size_t)t * K;
  const float* cb = coef + (size_t)b * T * width;
  const int2* bx = boxes + (size_t)b * T;

  float zb[kPx];
  int ib[kPx], sb[kPx];
#pragma unroll
  for (int p = 0; p < kPx; ++p) {
    zb[p] = CUDART_INF_F;
    ib[p] = 0;
    sb[p] = -1;
  }
  // the m staged slots against the thread's pixels, in stage order
  auto test = [&](int m) {
    for (int j = 0; j < m; ++j) {
      const float4 mj = st_m[j];
      int lo, hi;
      unpack_range(mj.z, lo, hi);
      if (hi < wr0 || lo > wr1) continue;  // the same for the whole warp
      if (lr < lo || lr > hi) continue;
      unpack_range(mj.w, lo, hi);
      if (lc + kPx - 1 < lo || lc > hi) continue;
      const float4 e0 = st_e0[j];
      const float by0 = __fmul_rn(e0.y, y);
      float ea[kPx];
      bool any = false;
#pragma unroll
      for (int p = 0; p < kPx; ++p) {
        ea[p] = edge(e0.x, by0, e0.z, x[p]);
        any |= ea[p] >= 0.0f;
      }
      if (!any) continue;
      const float4 e1 = st_e1[j], ez = st_z[j];
      const float by1 = __fmul_rn(e1.x, y), by2 = __fmul_rn(e1.w, y);
      const float byz = __fmul_rn(ez.z, y);
#pragma unroll
      for (int p = 0; p < kPx; ++p) {
        if (!(ea[p] >= 0.0f && edge(e0.w, by1, e1.y, x[p]) >= 0.0f &&
              edge(e1.z, by2, ez.x, x[p]) >= 0.0f))
          continue;
        const float z = __fdiv_rn(edge(ez.y, byz, ez.w, x[p]), mj.x);
        if (z >= -1.0f && z <= 1.0f && z < zb[p]) {
          zb[p] = z;
          ib[p] = __float_as_int(mj.y);
          if (kRows) sb[p] = st_k[j];
        }
      }
    }
  };

  int m = 0, round = 0;
  for (int s0 = 0; s0 < n; s0 += kRound) {
    // the thread's candidates k0, k0 + 1: entry and box loads at once
    const int k0 = s0 + kCand * threadIdx.x;
    int tri[kCand], row[kCand];
    int2 box[kCand];
#pragma unroll
    for (int i = 0; i < kCand; ++i) {
      tri[i] = k0 + i < n ? bin[k0 + i] : 0;
      row[i] = min(tri[i], T - 1);
    }
#pragma unroll
    for (int i = 0; i < kCand; ++i) box[i] = bx[row[i]];
    // those whose box meets the sub-tile (det 0: an empty box)
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
      if (k0 + i < n && rlo[i] <= rhi[i] && rhi[i] >= 0 && rlo[i] <= sh - 1 &&
          clo[i] <= chi[i] && chi[i] >= 0 && clo[i] <= sw - 1)
        keep |= 1u << i;
    }
    // a block prefix sum of the survivors, in thread order: the bin's order
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
    for (int w = 0; w < kWarps; ++w) {
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
#pragma unroll
    for (int i = 0; i < kCand; ++i) {
      if (!(keep >> i & 1u)) continue;
      const float* src = cb + (size_t)row[i] * width;
      const float4 q0 = ld4(src), q1 = ld4(src + 4), q2 = ld4(src + 8), q3 = ld4(src + 12);
      const float sg = q3.x > 0.0f ? 1.0f : -1.0f;  // lane 12: det, not 0 here
      st_e0[pos] = make_float4(q0.x * sg, q0.y * sg, q0.z * sg, q0.w * sg);
      st_e1[pos] = make_float4(q1.x * sg, q1.y * sg, q1.z * sg, q1.w * sg);
      st_z[pos] = make_float4(q2.x * sg, q2.y, q2.z, q2.w);
      const int id = kRows ? (int)q3.y + 1 : tri[i] + 1;
      st_m[pos] = make_float4(q3.x, __int_as_float(id), pack_range(rlo[i], rhi[i], kSub),
                              pack_range(clo[i], chi[i], kSub));
      if (kRows) st_k[pos] = k0 + i;
      ++pos;
    }
    m += total;
  }
  __syncthreads();
  test(m);

  if (lr >= sh) return;
  const size_t frame_px = (size_t)hp * wp;
  const size_t pix = (size_t)(r0 + lr) * wp + c0 + lc;
  const int np = min(kPx, sw - lc);  // the thread's pixels inside the tile
  const bool vec = np == kPx && pix % 4 == 0 && frame_px % 4 == 0;  // aligned
  store_px(ids + (size_t)b * frame_px + pix, ib, np, vec);
  if constexpr (kRows) {
    int wv[kPx], rw[kPx];
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      wv[p] = sb[p] >= 0 ? t * K + sb[p] : -1;
      rw[p] = sb[p] >= 0 ? min(bin[sb[p]], T - 1) : -1;
    }
    store_px(win + (size_t)b * frame_px + pix, wv, np, vec);
    // the winners' 32 lanes, four at a time: one float4 load a pixel, then
    // one store of the thread's four pixels a lane (zeros on background)
    float* out = rows + (size_t)b * kRowWidth * frame_px + pix;
#pragma unroll 2
    for (int g = 0; g < kRowWidth / 4; ++g) {
      float4 v[kPx];
#pragma unroll
      for (int p = 0; p < kPx; ++p)
        v[p] = rw[p] >= 0 ? ld4(cb + (size_t)rw[p] * kRowWidth + 4 * g)
                          : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const float l0[kPx] = {v[0].x, v[1].x, v[2].x, v[3].x};
      const float l1[kPx] = {v[0].y, v[1].y, v[2].y, v[3].y};
      const float l2[kPx] = {v[0].z, v[1].z, v[2].z, v[3].z};
      const float l3[kPx] = {v[0].w, v[1].w, v[2].w, v[3].w};
      store_px(out + (size_t)(4 * g) * frame_px, l0, np, vec);
      store_px(out + (size_t)(4 * g + 1) * frame_px, l1, np, vec);
      store_px(out + (size_t)(4 * g + 2) * frame_px, l2, np, vec);
      store_px(out + (size_t)(4 * g + 3) * frame_px, l3, np, vec);
    }
  }
}

// the pre-pass, then the search: boxes (B*T int2) is scratch
template <bool kRows>
int search(const float* coef, const int* tile_idx, const int* counts, int B, int T, int K,
           int nty, int ntx, int th, int tw, int fh, int fw, int* ids, int* win,
           float* rows, int* boxes, cudaStream_t s) {
  const int hp = nty * th, wp = ntx * tw;
  if (hp > 32767 || wp > 32767) return (int)cudaErrorInvalidValue;
  int2* box = reinterpret_cast<int2*>(boxes);
  constexpr int width = kRows ? kRowWidth : kWidth;
  if (T > 0)
    row_boxes_kernel<width><<<dim3((T + 255) / 256, B), 256, 0, s>>>(coef, T, hp, wp, fh,
                                                                     fw, box);
  const int nsx = (tw + kSub - 1) / kSub, nsy = (th + kSub - 1) / kSub;
  raster_ids_kernel<kRows><<<dim3(nty * ntx * nsy * nsx, B), kThreads, 0, s>>>(
      coef, tile_idx, counts, box, T, K, ntx, th, tw, nsx, nsy * nsx, hp, wp, fh, fw, ids,
      win, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// ids (B, nty*th, ntx*tw) from coef (B, T, 16) (16-byte aligned), tile_idx
// (nty*ntx, K) and counts (nty*ntx,); pixel NDC over the real (fh, fw)
// frame, the padded frame below 2^15 pixels a side; boxes: scratch of B*T
// int2
extern "C" int dd_raster_ids(const float* coef, const int* tile_idx,
                             const int* counts, int B, int T, int K, int nty,
                             int ntx, int th, int tw, int fh, int fw,
                             int* ids, int* boxes, void* stream) {
  return search<false>(coef, tile_idx, counts, B, T, K, nty, ntx, th, tw, fh, fw, ids,
                       nullptr, nullptr, boxes, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// K9: the v1 raster + row gather.
//
// Replaces diffdope_tpu/render/gather_rows.py:_fwd_kernel (forward) and
// _bwd_kernel (backward), driven by raster_gather_rows.  The plain torch
// versions that these are held to live in
// diffdope_tpu_torch/render/gather_rows.py.
//
// Forward: K8's search (raster_ids_kernel<true> above, with its box
// pre-pass and sub-tiles) over the bins of (B, T, 32) packed rows, then the
// winner's 32 lanes: a thread reads its four pixels' rows four lanes at a
// time (float4) and writes each lane's four pixels in one float4 store,
// background zeros included (the rows' layout and readers are kept).
// Bound on this card: the per-(pixel, slot) tests inside the boxes, as
// K8's, and the rows write; the TPU kernel's one-hot matmul gather is a
// plain indexed load here.
//
// Backward: d_bin (B, tiles, K, 32), for each (tile, slot) the sum of
// d_rows over the tile's pixels that the slot wins, from +0 in ascending
// pixel order (the frame's row-major order within the tile), and +0 at
// every other slot, the tile's count to K included.  Every slot belongs to
// one tile, so one block of 1,024 threads per (tile, hypothesis) owns the
// tile's K x 32 floats, one contiguous span, and writes them with no
// atomics.  Bound on this card: the d_bin write, every entry (1.8 GB at the
// bench shapes, 83% of it past the tiles' counts), then win and the d_rows
// read at the foreground pixels.  So:
// (1) +0 over the span in float4 stores (a slot's 32 lanes are 128
//     contiguous bytes): the tile's block writes its held slots in plain
//     stores (its won rows are read back below), and a tail block per
//     (tile, hypothesis), launched after all the tiles' blocks so that no
//     walk starts late, the slots past the count in streaming stores; a
//     tile that holds no slot does nothing else;
// (2) the tile's block walks its pixels in row-major chunks of 1,024,
//     thread e on pixel e of the chunk, as K4 walks a 16 x 16 tile: each
//     foreground pixel's key (slot << 10) | e, the chunk's d_rows staged
//     in shared memory by coalesced loads (none at background pixels), a
//     bitonic sort of the keys (shuffles within a warp, shared memory
//     across warps), so each winner's pixels of the chunk form a run in
//     ascending pixel order;
// (3) a warp a run, a thread a lane: the slot's row as the earlier chunks
//     left it (+0 before its first), the run's pixels added in order with
//     __fadd_rn, and the row stored; a warp loads the rows of up to
//     kRowBatch of its runs at once.  Each slot's sum is one fixed
//     sequence of additions over its pixels in ascending order, chunk
//     after chunk, bit-identical across launches; shared memory does not
//     grow with the tile or with K.  The chunk is the tile's 32 x 128
//     pixels a quarter at a time: chunks of 256 and 512 pixels took more
//     rounds of the walk, each a few memory latencies long under the
//     fill's traffic.

namespace {

constexpr int kBwdThreads = 1024;         // a thread a pixel of a chunk
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kChunkPx = kBwdThreads;     // consecutive tile pixels (row-major) a chunk
constexpr int kPxBits = 10;               // a key's pixel bits: kChunkPx = 1 << kPxBits
constexpr int kChunkPad = kRowWidth + 1;  // a staged pixel's lanes, padded
constexpr int kStageBatch = 16;           // a thread's d_rows loads in flight
constexpr int kRowBatch = 8;              // a warp's runs whose rows load at once
constexpr unsigned kNoKey = 0xffffffffu;  // background, sorted last
static_assert(kChunkPx == 1 << kPxBits, "a key holds a chunk's pixel");
// the stage: 135,168 bytes of dynamic shared memory
constexpr int kBwdShared = kChunkPx * kChunkPad * (int)sizeof(float);

__global__ void __launch_bounds__(kBwdThreads, 1)
    gather_rows_bwd_kernel(const float* __restrict__ d_rows, const int* __restrict__ win,
                           const int* __restrict__ counts, int K, int ntx, int th, int tw,
                           int hp, int wp, float* __restrict__ d_bin) {
  extern __shared__ float stage[];  // the chunk's staged d_rows
  float(*st)[kChunkPad] = reinterpret_cast<float(*)[kChunkPad]>(stage);
  __shared__ unsigned keys[kChunkPx];
  __shared__ unsigned run_starts[kBwdWarps];
  __shared__ int run_at[kChunkPx + 1];  // sorted position of each run's start
  const int t = blockIdx.x, b = blockIdx.y;
  const int e = threadIdx.x, lane = e & 31, warp = e >> 5;
  const int npx = th * tw;
  const int n = min(counts[t], K);
  const int r0 = (t / ntx) * th, c0 = (t % ntx) * tw;
  const size_t plane_px = (size_t)hp * wp;
  auto pix_of = [&](int p) { return (size_t)(r0 + p / tw) * wp + c0 + p % tw; };
  float* out = d_bin + ((size_t)b * gridDim.x + t) * K * kRowWidth;

  // (1) +0 everywhere: a tail block past the tile's count, in streaming
  // stores; the tile's block over its held slots
  float4* out4 = reinterpret_cast<float4*>(out);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (blockIdx.z) {
    for (int i = n * (kRowWidth / 4) + e; i < K * (kRowWidth / 4); i += kBwdThreads)
      __stcs(out4 + i, zero);
    return;
  }
  if (n == 0) return;  // the same for the whole block
  for (int i = e; i < n * (kRowWidth / 4); i += kBwdThreads) out4[i] = zero;
  __syncthreads();  // the held rows' zeros before any block load of them

  const int* wb = win + (size_t)b * plane_px;
  const float* db = d_rows + (size_t)b * kRowWidth * plane_px;
  int s_next = e < npx ? wb[pix_of(e)] - t * K : -1;
  for (int p0 = 0; p0 < npx; p0 += kChunkPx) {
    // (2) the chunk: keys, staged d_rows, sort
    const int s = s_next;
    s_next = p0 + kChunkPx + e < npx ? wb[pix_of(p0 + kChunkPx + e)] - t * K : -1;
    const bool fg = s >= 0 && s < n;
    const int n_fg = __syncthreads_count(fg);  // st, keys and run_at are free too
    if (n_fg == 0) continue;  // the same for the whole block
    if (fg) {
      const float* src = db + pix_of(p0 + e);
#pragma unroll
      for (int l0 = 0; l0 < kRowWidth; l0 += kStageBatch) {
        float v[kStageBatch];
#pragma unroll
        for (int l = 0; l < kStageBatch; ++l) v[l] = __ldg(src + (size_t)(l0 + l) * plane_px);
#pragma unroll
        for (int l = 0; l < kStageBatch; ++l) st[e][l0 + l] = v[l];
      }
    }
    unsigned key = fg ? (unsigned)s << kPxBits | (unsigned)e : kNoKey;
    for (int size = 2; size <= kChunkPx; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        unsigned other;
        if (stride >= 32) {
          __syncthreads();
          keys[e] = key;
          __syncthreads();
          other = keys[e ^ stride];
        } else {
          other = __shfl_xor_sync(0xffffffffu, key, stride);
        }
        const bool ascending = (e & size) == 0, lower = (e & stride) == 0;
        key = lower == ascending ? min(key, other) : max(key, other);
      }
    }
    __syncthreads();
    keys[e] = key;
    __syncthreads();
    // the runs: a run starts where the winner changes
    const bool start =
        key != kNoKey && (e == 0 || (keys[e - 1] >> kPxBits) != (key >> kPxBits));
    const unsigned ballot = __ballot_sync(0xffffffffu, start);
    if (lane == 0) run_starts[warp] = ballot;
    __syncthreads();
    int before = __popc(ballot & ((1u << lane) - 1u)), n_run = 0;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) {
      const int c = __popc(run_starts[w]);
      if (w < warp) before += c;
      n_run += c;
    }
    if (start) run_at[before] = e;
    if (e == 0) run_at[n_run] = n_fg;
    __syncthreads();
    // (3) a warp a run, a thread a lane, kRowBatch runs' rows loaded at once
    for (int rb = warp; rb < n_run; rb += kBwdWarps * kRowBatch) {
      float acc[kRowBatch];
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        const int r = rb + j * kBwdWarps;
        if (r < n_run) acc[j] = out[(size_t)(keys[run_at[r]] >> kPxBits) * kRowWidth + lane];
      }
#pragma unroll
      for (int j = 0; j < kRowBatch; ++j) {
        const int r = rb + j * kBwdWarps;
        if (r >= n_run) break;
        for (int q = run_at[r]; q < run_at[r + 1]; ++q)
          acc[j] = __fadd_rn(acc[j], st[keys[q] & (kChunkPx - 1)][lane]);
        out[(size_t)(keys[run_at[r]] >> kPxBits) * kRowWidth + lane] = acc[j];
      }
    }
  }
}

}  // namespace

// K9 forward: ids, win (flat slot t*K + k) of the padded (nty*th, ntx*tw)
// frame and the planar rows (B, 32, ., .) from packed rows (B, T, 32)
// (16-byte aligned), the bins tile_idx (nty*ntx, K) and counts; pixel NDC
// over the real (fh, fw) frame; boxes: scratch of B*T int2
extern "C" int dd_gather_rows_fwd(const float* packed, const int* tile_idx,
                                  const int* counts, int B, int T, int K,
                                  int nty, int ntx, int th, int tw, int fh,
                                  int fw, int* ids, int* win, float* rows,
                                  int* boxes, void* stream) {
  return search<true>(packed, tile_idx, counts, B, T, K, nty, ntx, th, tw, fh, fw, ids,
                      win, rows, boxes, (cudaStream_t)stream);
}

// K9 backward: d_bin (B, nty*ntx, K, 32) (16-byte aligned), every entry
// written, from d_rows (B, 32, nty*th, ntx*tw) over the forward's map win;
// K below 2^22 (a key holds the slot in 22 bits)
extern "C" int dd_gather_rows_bwd(const float* d_rows, const int* win,
                                  const int* counts, int B, int K, int nty,
                                  int ntx, int th, int tw, float* d_bin,
                                  void* stream) {
  if (K >= (1 << (32 - kPxBits)) - 1 ||
      reinterpret_cast<uintptr_t>(d_bin) % sizeof(float4))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      gather_rows_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(nty * ntx, B, 2);  // the tiles' blocks first, then their tails'
  gather_rows_bwd_kernel<<<grid, kBwdThreads, kBwdShared, (cudaStream_t)stream>>>(
      d_rows, win, counts, K, ntx, th, tw, nty * th, ntx * tw, d_bin);
  return (int)cudaGetLastError();
}

// The backward of rasterize()'s setup-row gather (render/rasterize.py:
// SetupRows) and of the port's other gathers (IndexRows, slot_sums): no TPU
// kernel; the reference leaves the transpose of its take_along_axis
// (diffdope_tpu/render/rasterize.py:245) and its other gathers to XLA.
// out[h, s, k] = the sum, in ascending i, of src[h * hyp_stride +
// order[i] * row_stride + k * lane_stride] over i in [start[s], start[s +
// 1]), for n_hyp hypotheses of nseg segments: the caller sorts the entries
// stably by segment, so a segment sums its entries in entry order, every
// call the same and as the CPU's index_add_ does (the scatter-add of
// autograd's gather adds with atomics).  The strides let a caller sum rows
// where they lie: the DD_BINNED=0 route's d_bins (B, 32, slots) is read in
// place, one launch for every hypothesis (hyp_stride 32 * slots, row
// stride 1, lane stride slots); a row-major (entries, width) source is
// (0, width, 1) with one hypothesis.  One thread per (hypothesis,
// segment, lane).  Bound: the entries' values read and out written
// (memory bound).
namespace {

__global__ void segment_sum_kernel(const float* __restrict__ src,
                                   const int* __restrict__ order,
                                   const int* __restrict__ start, int nseg,
                                   int width, long long hyp_stride,
                                   long long row_stride, long long lane_stride,
                                   long long n, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long per_hyp = (long long)nseg * width;
  const long long h = i / per_hyp, r = i % per_hyp;
  const int s = (int)(r / width), k = (int)(r % width);
  const float* base = src + h * hyp_stride + k * lane_stride;
  float acc = 0.0f;
  for (int q = start[s]; q < start[s + 1]; ++q)
    acc = __fadd_rn(acc, base[(long long)order[q] * row_stride]);
  out[i] = acc;
}

}  // namespace

extern "C" int dd_segment_sum(const float* src, const int* order,
                              const int* start, int n_hyp, int nseg, int width,
                              long long hyp_stride, long long row_stride,
                              long long lane_stride, float* out,
                              void* stream) {
  const long long n = (long long)n_hyp * nseg * width;
  if (n == 0) return 0;
  if (n_hyp < 0 || nseg < 0 || width < 0 || (n + 255) / 256 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  segment_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                       (cudaStream_t)stream>>>(src, order, start, nseg, width,
                                               hyp_stride, row_stride,
                                               lane_stride, n, out);
  return (int)cudaGetLastError();
}
