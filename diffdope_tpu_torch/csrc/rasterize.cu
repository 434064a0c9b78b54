// Binned triangle-id search of the nvdiffrast-style rasterize() op for
// Hopper (sm_90a): K8; and the v1 raster + row gather on the same search:
// K9 (at the end of this file).
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
// Design: one thread block per (tile, hypothesis).  A tile is any th x tw
// (the op's tile_hw is free; 32 x 128 = 4,096 pixels by default, more than
// a block's threads), so each thread owns PPT pixels, strided by the block
// size so that the final writes coalesce; a tile larger than one block's
// PPT pixels is walked in pixel groups.  The block stages its tile's rows
// coef[b, tile_idx[t, k]] (lanes 0-12) and the indices in shared memory,
// kStage slots at a time, and reads no slot at or past min(counts[t], K).
// The TPU kernel's pre-gathered (B, tiles, K, 16) table, which exists only
// to give Pallas legal block shapes, is not built: its bytes grow with K.
//
// Bound on this card: the per-(pixel, slot) tests, ~23 FP32 operations
// each on data in shared memory and registers (compute bound; a row staged
// once serves the tile's every pixel).
//
// Numeric contract (build with -fmad=false, no fast math), the reference's
// f32 operation order (rasterize.py:123-143), which is not K3's: pixel NDC
// x = (2*col + 1)/W - 1 with an IEEE divide; e = (c0*x + c1*y) + c2 without
// FMA; coverage e*sign(det) >= 0 on all three edges and det != 0;
// z = zlin / det with an IEEE divide (K3 multiplies by 1/det); -1 <= z <= 1
// and a strictly smaller z wins, so over a bin walked in ascending order the
// smallest triangle index keeps a tie.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWidth = 16;    // lanes of a setup row
constexpr int kRowWidth = 32; // lanes of a packed row (K9)
constexpr int kIdLanes = 13;  // lanes 0..12: edge planes, zc, det
constexpr int kStage = 256;   // slots staged in shared memory per round
constexpr int kThreads = 256;

__device__ __forceinline__ float ndc(int pix, int frame) {
  return __fsub_rn(
      __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, (float)pix), 1.0f), (float)frame),
      1.0f);
}

// (c0*x + c1*y) + c2, each product and sum rounded (no FMA)
__device__ __forceinline__ float edge(float c0, float c1, float c2, float x,
                                      float y) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c0, x), __fmul_rn(c1, y)), c2);
}

// kRows false: K8, rows ``coef`` (B, T, 16), the id is the bin entry + 1.
// kRows true: K9, rows ``coef`` (B, T, 32) of shade.pack_rows, the id is
// lane 13 + 1 (the triangle index the row carries), and the block also
// writes the winner's flat slot t*K + k (-1 on background) to ``win`` and
// its 32 lanes to the planar ``rows`` (B, 32, nty*th, ntx*tw).
template <int PPT, bool kRows>
__global__ void raster_ids_kernel(const float* __restrict__ coef,
                                  const int* __restrict__ tile_idx,
                                  const int* __restrict__ counts, int T, int K,
                                  int ntx, int th, int tw, int fh, int fw,
                                  int* __restrict__ ids,
                                  int* __restrict__ win,
                                  float* __restrict__ rows) {
  constexpr int width = kRows ? kRowWidth : kWidth;
  constexpr int lanes = kRows ? kIdLanes + 1 : kIdLanes;
  __shared__ float st[kIdLanes + 1][kStage];
  __shared__ int sid[kStage];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int npx = th * tw;
  const int row0 = (t / ntx) * th, col0 = (t % ntx) * tw;
  const int frame_w = ntx * tw;
  const size_t frame_px = (size_t)(gridDim.x / ntx) * th * frame_w;  // nty*th rows
  const int n = min(counts[t], K);
  const int* bin = tile_idx + (size_t)t * K;
  const float* cb = coef + (size_t)b * T * width;

  for (int p0 = 0; p0 < npx; p0 += blockDim.x * PPT) {
    float px[PPT], py[PPT], zb[PPT];
    int ib[PPT], sb[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int p = p0 + threadIdx.x + q * blockDim.x;
      px[q] = ndc(col0 + p % tw, fw);
      py[q] = ndc(row0 + p / tw, fh);
      zb[q] = CUDART_INF_F;
      ib[q] = 0;
      sb[q] = -1;
    }
    for (int s0 = 0; s0 < n; s0 += kStage) {
      const int m = min(kStage, n - s0);
      __syncthreads();
      for (int j = threadIdx.x; j < m; j += blockDim.x) sid[j] = bin[s0 + j];
      __syncthreads();
      for (int i = threadIdx.x; i < lanes * m; i += blockDim.x) {
        const int j = i / lanes, lane = i % lanes;
        st[lane][j] = cb[(size_t)sid[j] * width + lane];
      }
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const float det = st[12][j];
        if (det == 0.0f) continue;  // the same slot for the whole block
        const bool pos = det > 0.0f;
        const int id = kRows ? (int)st[13][j] + 1 : sid[j] + 1;
        float c[12];
#pragma unroll
        for (int l = 0; l < 12; ++l) c[l] = st[l][j];
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          const float x = px[q], y = py[q];
          const float e0 = edge(c[0], c[1], c[2], x, y);
          const float e1 = edge(c[3], c[4], c[5], x, y);
          const float e2 = edge(c[6], c[7], c[8], x, y);
          // e*sign(det) >= 0 for sign(det) = +-1
          const bool covered = pos ? (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)
                                   : (e0 <= 0.0f && e1 <= 0.0f && e2 <= 0.0f);
          if (!covered) continue;
          const float z = __fdiv_rn(edge(c[9], c[10], c[11], x, y), det);
          if (z >= -1.0f && z <= 1.0f && z < zb[q]) {
            zb[q] = z;
            ib[q] = id;
            sb[q] = s0 + j;
          }
        }
      }
    }
    int* out = ids + (size_t)b * frame_px;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int p = p0 + threadIdx.x + q * blockDim.x;
      if (p >= npx) continue;
      const size_t pix = (size_t)(row0 + p / tw) * frame_w + col0 + p % tw;
      out[pix] = ib[q];
      if (!kRows) continue;
      win[(size_t)b * frame_px + pix] = sb[q] >= 0 ? t * K + sb[q] : -1;
      float* dst = rows + (size_t)b * kRowWidth * frame_px + pix;
      if (sb[q] >= 0) {
        const float* src = cb + (size_t)bin[sb[q]] * kRowWidth;
#pragma unroll
        for (int l = 0; l < kRowWidth; ++l) dst[l * frame_px] = src[l];
      } else {
#pragma unroll
        for (int l = 0; l < kRowWidth; ++l) dst[l * frame_px] = 0.0f;
      }
    }
  }
}

template <int PPT, bool kRows>
int launch(const float* coef, const int* tile_idx, const int* counts, int B,
           int T, int K, int nty, int ntx, int th, int tw, int fh, int fw,
           int threads, int* ids, int* win, float* rows, cudaStream_t stream) {
  dim3 grid(nty * ntx, B);
  raster_ids_kernel<PPT, kRows><<<grid, threads, 0, stream>>>(
      coef, tile_idx, counts, T, K, ntx, th, tw, fh, fw, ids, win, rows);
  return (int)cudaGetLastError();
}

// the search over any tile: PPT pixels a thread, chosen from the tile
template <bool kRows>
int search(const float* coef, const int* tile_idx, const int* counts, int B,
           int T, int K, int nty, int ntx, int th, int tw, int fh, int fw,
           int* ids, int* win, float* rows, cudaStream_t s) {
  const int npx = th * tw;
  const int threads = min(kThreads, (npx + 31) / 32 * 32);
  const int need = (npx + threads - 1) / threads;  // pixels per thread
  if (need <= 1)
    return launch<1, kRows>(coef, tile_idx, counts, B, T, K, nty, ntx, th, tw,
                            fh, fw, threads, ids, win, rows, s);
  if (need <= 2)
    return launch<2, kRows>(coef, tile_idx, counts, B, T, K, nty, ntx, th, tw,
                            fh, fw, threads, ids, win, rows, s);
  if (need <= 4)
    return launch<4, kRows>(coef, tile_idx, counts, B, T, K, nty, ntx, th, tw,
                            fh, fw, threads, ids, win, rows, s);
  if (need <= 8)
    return launch<8, kRows>(coef, tile_idx, counts, B, T, K, nty, ntx, th, tw,
                            fh, fw, threads, ids, win, rows, s);
  return launch<16, kRows>(coef, tile_idx, counts, B, T, K, nty, ntx, th, tw,
                           fh, fw, threads, ids, win, rows, s);
}

}  // namespace

// ids (B, nty*th, ntx*tw) from coef (B, T, 16), tile_idx (nty*ntx, K) and
// counts (nty*ntx,); pixel NDC over the real (fh, fw) frame
extern "C" int dd_raster_ids(const float* coef, const int* tile_idx,
                             const int* counts, int B, int T, int K, int nty,
                             int ntx, int th, int tw, int fh, int fw,
                             int* ids, void* stream) {
  return search<false>(coef, tile_idx, counts, B, T, K, nty, ntx, th, tw, fh,
                       fw, ids, nullptr, nullptr, (cudaStream_t)stream);
}

// ---------------------------------------------------------------------------
// K9: the v1 raster + row gather.
//
// Replaces diffdope_tpu/render/gather_rows.py:_fwd_kernel (forward) and
// _bwd_kernel (backward), driven by raster_gather_rows.  The plain torch
// versions that these are held to live in
// diffdope_tpu_torch/render/gather_rows.py.
//
// Forward: K8's search (raster_ids_kernel<PPT, true> above) over the bins
// of (B, T, 32) packed rows, then the winner's 32 lanes, one contiguous
// 128-byte row read per foreground pixel.  Bound on this card: the
// per-(pixel, slot) tests, as K8's; the TPU kernel's one-hot matmul gather
// is a plain indexed load here.
//
// Backward: d_bin (B, tiles, K, 32), for each (tile, slot) the sum of
// d_rows over the tile's pixels that the slot wins.  Every slot belongs to
// one tile, so one block per (tile, hypothesis) writes it alone, with no
// atomics; but a tile has up to 4,096 pixels and K up to thousands of
// slots, so K4's owner scan (quadratic in the tile's pixels) is replaced by
// a stable counting sort of the tile's pixels by winner slot in shared
// memory: warp 0 counts and places them 32 pixels at a time (__match_any_sync
// groups equal slots; a pixel's place is its slot's offset, the count
// placed so far and its rank among earlier lanes of its group), so each
// slot's pixels keep pixel order.  Then a thread per slot sums its pixels'
// d_rows in that order: a fixed order, bit-identical across launches.  Bound:
// the d_rows read at the foreground pixels and the d_bin write.

namespace {

constexpr int kBwdThreads = 256;

__global__ void gather_rows_bwd_kernel(const float* __restrict__ d_rows,
                                       const int* __restrict__ win,
                                       const int* __restrict__ counts, int K,
                                       int ntx, int th, int tw, int hp,
                                       int wp, float* __restrict__ d_bin) {
  extern __shared__ int sh[];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int npx = th * tw;
  const int n = min(counts[t], K);
  int* slot = sh;             // npx: the pixel's winner slot in the tile, -1
  int* order = slot + npx;    // npx: the pixels, stably sorted by slot
  int* cnt = order + npx;     // K: pixels per slot (then placed so far)
  int* off = cnt + K;         // K: first place of each slot's pixels
  const int r0 = (t / ntx) * th, c0 = (t % ntx) * tw;
  const size_t plane_px = (size_t)hp * wp;
  auto pix_of = [&](int p) { return (size_t)(r0 + p / tw) * wp + c0 + p % tw; };

  for (int p = threadIdx.x; p < npx; p += blockDim.x) {
    const int w = win[(size_t)b * plane_px + pix_of(p)];
    slot[p] = w >= 0 ? w - t * K : -1;
  }
  for (int k = threadIdx.x; k < n; k += blockDim.x) cnt[k] = 0;
  __syncthreads();

  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const unsigned lower = (1u << lane) - 1u;
    for (int i = 0; i < npx; i += 32) {  // counts
      const int p = i + lane;
      const int s = p < npx ? slot[p] : -1;
      const unsigned m = __match_any_sync(0xffffffffu, s);
      if (s >= 0 && (m & lower) == 0u) cnt[s] += __popc(m);
      __syncwarp();
    }
    // exclusive scan of cnt into off: lane L takes a contiguous segment
    const int seg = (n + 31) / 32;
    const int lo = min(n, lane * seg), hi = min(n, lo + seg);
    int local = 0;
    for (int k = lo; k < hi; ++k) local += cnt[k];
    int incl = local;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    int run = incl - local;
    for (int k = lo; k < hi; ++k) {
      off[k] = run;
      run += cnt[k];
      cnt[k] = 0;
    }
    __syncwarp();
    for (int i = 0; i < npx; i += 32) {  // stable placement
      const int p = i + lane;
      const int s = p < npx ? slot[p] : -1;
      const unsigned m = __match_any_sync(0xffffffffu, s);
      if (s >= 0) order[off[s] + cnt[s] + __popc(m & lower)] = p;
      __syncwarp();
      if (s >= 0 && (m & lower) == 0u) cnt[s] += __popc(m);
      __syncwarp();
    }
  }
  __syncthreads();

  const float* db = d_rows + (size_t)b * kRowWidth * plane_px;
  float* out = d_bin + ((size_t)b * gridDim.x + t) * K * kRowWidth;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float acc[kRowWidth];
#pragma unroll
    for (int l = 0; l < kRowWidth; ++l) acc[l] = 0.0f;
    if (k < n) {
      for (int q = off[k]; q < off[k] + cnt[k]; ++q) {
        const float* src = db + pix_of(order[q]);
#pragma unroll
        for (int l = 0; l < kRowWidth; ++l)
          acc[l] = __fadd_rn(acc[l], src[l * plane_px]);
      }
    }
    float* dst = out + (size_t)k * kRowWidth;
#pragma unroll
    for (int l = 0; l < kRowWidth; ++l) dst[l] = acc[l];
  }
}

}  // namespace

// K9 forward: ids, win (flat slot t*K + k) of the padded (nty*th, ntx*tw)
// frame and the planar rows (B, 32, ., .) from packed rows (B, T, 32), the
// bins tile_idx (nty*ntx, K) and counts; pixel NDC over the real (fh, fw)
// frame
extern "C" int dd_gather_rows_fwd(const float* packed, const int* tile_idx,
                                  const int* counts, int B, int T, int K,
                                  int nty, int ntx, int th, int tw, int fh,
                                  int fw, int* ids, int* win, float* rows,
                                  void* stream) {
  return search<true>(packed, tile_idx, counts, B, T, K, nty, ntx, th, tw, fh,
                      fw, ids, win, rows, (cudaStream_t)stream);
}

// K9 backward: d_bin (B, nty*ntx, K, 32), every entry written, from d_rows
// (B, 32, nty*th, ntx*tw) over the forward's map win
extern "C" int dd_gather_rows_bwd(const float* d_rows, const int* win,
                                  const int* counts, int B, int K, int nty,
                                  int ntx, int th, int tw, float* d_bin,
                                  void* stream) {
  const int shared = 4 * (2 * th * tw + 2 * K);
  if (shared > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gather_rows_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(nty * ntx, B);
  gather_rows_bwd_kernel<<<grid, kBwdThreads, shared, (cudaStream_t)stream>>>(
      d_rows, win, counts, K, ntx, th, tw, nty * th, ntx * tw, d_bin);
  return (int)cudaGetLastError();
}

// The backward of rasterize()'s setup-row gather (render/rasterize.py:
// SetupRows): no TPU kernel; the reference leaves the transpose of its
// take_along_axis (diffdope_tpu/render/rasterize.py:245) to XLA.  out[s, k]
// = the sum, in ascending i, of src[order[i], k] over i in [start[s],
// start[s + 1]): the caller sorts the foreground pixels stably by (hypothesis,
// triangle), so a triangle's row sums its pixels' row cotangents in pixel
// order, every call the same and as the CPU's index_add_ does (the
// scatter-add of autograd's gather adds with atomics).  One thread per
// (segment, lane); a warp reads two 64-byte rows at a time.  Bound: the src
// rows read and out written (memory bound).
namespace {

__global__ void segment_sum_kernel(const float* __restrict__ src,
                                   const int* __restrict__ order,
                                   const int* __restrict__ start, int nseg,
                                   int width, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nseg * width) return;
  const int s = (int)(i / width), k = (int)(i % width);
  float acc = 0.0f;
  for (int q = start[s]; q < start[s + 1]; ++q)
    acc = __fadd_rn(acc, src[(size_t)order[q] * width + k]);
  out[i] = acc;
}

}  // namespace

extern "C" int dd_segment_sum(const float* src, const int* order,
                              const int* start, int nseg, int width,
                              float* out, void* stream) {
  const long long n = (long long)nseg * width;
  if (n == 0) return 0;
  segment_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                       (cudaStream_t)stream>>>(src, order, start, nseg, width,
                                               out);
  return (int)cudaGetLastError();
}
