// Binned triangle-id search of the nvdiffrast-style rasterize() op for
// Hopper (sm_90a): K8.
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

template <int PPT>
__global__ void raster_ids_kernel(const float* __restrict__ coef,
                                  const int* __restrict__ tile_idx,
                                  const int* __restrict__ counts, int T, int K,
                                  int ntx, int th, int tw, int fh, int fw,
                                  int* __restrict__ ids) {
  __shared__ float st[kIdLanes][kStage];
  __shared__ int sid[kStage];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int npx = th * tw;
  const int row0 = (t / ntx) * th, col0 = (t % ntx) * tw;
  const int frame_w = ntx * tw;
  const size_t frame_px = (size_t)(gridDim.x / ntx) * th * frame_w;  // nty*th rows
  const int n = min(counts[t], K);
  const int* bin = tile_idx + (size_t)t * K;
  const float* cb = coef + (size_t)b * T * kWidth;

  for (int p0 = 0; p0 < npx; p0 += blockDim.x * PPT) {
    float px[PPT], py[PPT], zb[PPT];
    int ib[PPT];
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int p = p0 + threadIdx.x + q * blockDim.x;
      px[q] = ndc(col0 + p % tw, fw);
      py[q] = ndc(row0 + p / tw, fh);
      zb[q] = CUDART_INF_F;
      ib[q] = 0;
    }
    for (int s0 = 0; s0 < n; s0 += kStage) {
      const int m = min(kStage, n - s0);
      __syncthreads();
      for (int j = threadIdx.x; j < m; j += blockDim.x) sid[j] = bin[s0 + j];
      __syncthreads();
      for (int i = threadIdx.x; i < kIdLanes * m; i += blockDim.x) {
        const int j = i / kIdLanes, lane = i % kIdLanes;
        st[lane][j] = cb[(size_t)sid[j] * kWidth + lane];
      }
      __syncthreads();
      for (int j = 0; j < m; ++j) {
        const float det = st[12][j];
        if (det == 0.0f) continue;  // the same slot for the whole block
        const bool pos = det > 0.0f;
        const int id = sid[j] + 1;
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
          }
        }
      }
    }
    int* out = ids + (size_t)b * frame_px;
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      const int p = p0 + threadIdx.x + q * blockDim.x;
      if (p < npx) out[(size_t)(row0 + p / tw) * frame_w + col0 + p % tw] = ib[q];
    }
  }
}

template <int PPT>
int launch(const float* coef, const int* tile_idx, const int* counts, int B,
           int T, int K, int nty, int ntx, int th, int tw, int fh, int fw,
           int threads, int* ids, cudaStream_t stream) {
  dim3 grid(nty * ntx, B);
  raster_ids_kernel<PPT><<<grid, threads, 0, stream>>>(
      coef, tile_idx, counts, T, K, ntx, th, tw, fh, fw, ids);
  return (int)cudaGetLastError();
}

}  // namespace

// ids (B, nty*th, ntx*tw) from coef (B, T, 16), tile_idx (nty*ntx, K) and
// counts (nty*ntx,); pixel NDC over the real (fh, fw) frame
extern "C" int dd_raster_ids(const float* coef, const int* tile_idx,
                             const int* counts, int B, int T, int K, int nty,
                             int ntx, int th, int tw, int fh, int fw,
                             int* ids, void* stream) {
  const int npx = th * tw;
  const int threads = min(kThreads, (npx + 31) / 32 * 32);
  const int need = (npx + threads - 1) / threads;  // pixels per thread
  cudaStream_t s = (cudaStream_t)stream;
  if (need <= 1)
    return launch<1>(coef, tile_idx, counts, B, T, K, nty, ntx, th, tw, fh,
                     fw, threads, ids, s);
  if (need <= 2)
    return launch<2>(coef, tile_idx, counts, B, T, K, nty, ntx, th, tw, fh,
                     fw, threads, ids, s);
  if (need <= 4)
    return launch<4>(coef, tile_idx, counts, B, T, K, nty, ntx, th, tw, fh,
                     fw, threads, ids, s);
  if (need <= 8)
    return launch<8>(coef, tile_idx, counts, B, T, K, nty, ntx, th, tw, fh,
                     fw, threads, ids, s);
  return launch<16>(coef, tile_idx, counts, B, T, K, nty, ntx, th, tw, fh,
                    fw, threads, ids, s);
}
