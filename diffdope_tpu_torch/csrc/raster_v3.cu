// Sorted-range raster forward and backward for Hopper (sm_90a): K10.
//
// Replaces diffdope_tpu/render/raster_v3.py:_fwd_kernel_v3 (forward) and
// _bwd_kernel_v3 (backward), driven by raster_gather_rows_v3.  The plain
// torch versions that these are held to, and the sort and gating tables
// (_prepare), live in diffdope_tpu_torch/render/raster_v3.py.
//
// Inputs: the sorted table packed_s (B, 32, tp) f32, tp a whole number of
// kChunk-slot chunks (padding slots have det 0); per tile row ty the chunk
// range [clo[ty], chi[ty]); per (tile, chunk) the chunk's pixel-row
// interval [rlo_tc, rhi_tc] (empty where its x range misses the tile).  A
// tile walks chunk c when c is in its row's range and the interval is not
// empty and meets the tile's rows: the gate, the same in both kernels.
//
// Forward: one thread block per (tile, hypothesis), one thread per pixel.
// The block stages each gated chunk's 14 id lanes in shared memory and
// runs K3's per-slot test (raster_common.cuh: pre-signed planes,
// z = zlin * (1/det), the (z, id) lexicographic minimum), so the outputs
// do not depend on the tile or the sort and equal the bin-table rasters'
// over the same table.  It writes ids (+1, 0 = background), the winner's 32
// lanes and its sorted slot (the backward's map).  Bound on this card: the
// per-(pixel, slot) tests, ~20 FP32 operations each on data in shared
// memory; the gate skips the chunks a tile cannot see, but a chunk that
// straddles tiles is tested whole by each (the reference measured ~2.3x the
// exact bins' work on its TPU tiles).
//
// Backward: a sorted slot is won in many tiles, so K4's per-tile owner sum
// does not give one writer per slot.  One block per (chunk, hypothesis),
// one thread per slot of the chunk: the block walks the tiles the forward
// gated this chunk into, in row-major order; per tile it loads the tile's
// winner map (keeping only winners in this chunk), skips a tile with none,
// and each thread adds the d_rows of the pixels its slot won in pixel
// order.  Every slot's sum has one fixed order and one writer: no atomics,
// bit-identical across launches, every slot written (zeros where not won).
// Bound: the d_rows read at the foreground pixels (32 floats each) and the
// d_packed write.

#include "raster_common.cuh"

namespace {

using dd::Best;
using dd::kIdLanes;
using dd::kLanes;
constexpr int kChunk = 128;  // slots a chunk (raster_v3.K_CHUNK)

// whether tile t (row ty, first pixel row y0, th rows) walks chunk c
__device__ __forceinline__ bool gated(const int* __restrict__ clo,
                                      const int* __restrict__ chi,
                                      const int* __restrict__ rlo_tc,
                                      const int* __restrict__ rhi_tc, int nc,
                                      int t, int ty, int c, int y0, int th) {
  if (c < clo[ty] || c >= chi[ty]) return false;
  const int lo = rlo_tc[(size_t)t * nc + c], hi = rhi_tc[(size_t)t * nc + c];
  return lo <= hi && lo <= y0 + th - 1 && hi >= y0;
}

__global__ void raster_v3_fwd_kernel(
    const float* __restrict__ packed_s, const int* __restrict__ clo,
    const int* __restrict__ chi, const int* __restrict__ rlo_tc,
    const int* __restrict__ rhi_tc, int tp, int ntx, int th, int tw, int hp,
    int wp, int fh, int fw, int* __restrict__ ids, int* __restrict__ win,
    float* __restrict__ rows) {
  __shared__ float st[kIdLanes][kChunk];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int ty = t / ntx;
  const int y0 = ty * th;
  const int row = y0 + threadIdx.x / tw;
  const int col = (t % ntx) * tw + threadIdx.x % tw;
  const float x = dd::ndc(col, fw);
  const float y = dd::ndc(row, fh);
  const int nc = tp / kChunk;
  const float* tb = packed_s + (size_t)b * kLanes * tp;

  Best best = dd::none();
  for (int c = clo[ty]; c < chi[ty]; ++c) {
    if (!gated(clo, chi, rlo_tc, rhi_tc, nc, t, ty, c, y0, th)) continue;
    const int base = c * kChunk;
    __syncthreads();
    for (int i = threadIdx.x; i < kIdLanes * kChunk; i += blockDim.x) {
      const int lane = i / kChunk, j = i % kChunk;
      st[lane][j] = tb[(size_t)lane * tp + base + j];
    }
    __syncthreads();
    for (int j = 0; j < kChunk; ++j)
      dd::test_slot<kChunk>(st, j, base + j, x, y, best);
  }
  dd::write_winner(best, tb, tp, (size_t)hp * wp, b, (size_t)row * wp + col, ids,
                   win, rows);
}

__global__ void raster_v3_bwd_kernel(
    const float* __restrict__ d_rows, const int* __restrict__ win,
    const int* __restrict__ clo, const int* __restrict__ chi,
    const int* __restrict__ rlo_tc, const int* __restrict__ rhi_tc, int tp,
    int nty, int ntx, int th, int tw, float* __restrict__ d_packed_s) {
  extern __shared__ int sw[];  // per tile pixel: its winner's slot in the
                               // chunk, or -1
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int j = threadIdx.x;
  const int nc = tp / kChunk;
  const int base = c * kChunk;
  const int npx = th * tw;
  const int wp = ntx * tw;
  const size_t plane_px = (size_t)nty * th * wp;
  const int* wb = win + (size_t)b * plane_px;
  const float* db = d_rows + (size_t)b * kLanes * plane_px;

  float acc[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) acc[k] = 0.0f;
  for (int ty = 0; ty < nty; ++ty) {
    if (c < clo[ty] || c >= chi[ty]) continue;
    const int y0 = ty * th;
    for (int tx = 0; tx < ntx; ++tx) {
      const int t = ty * ntx + tx;
      if (!gated(clo, chi, rlo_tc, rhi_tc, nc, t, ty, c, y0, th)) continue;
      const int x0 = tx * tw;
      __syncthreads();  // the previous tile's map is read
      int any = 0;
      for (int p = j; p < npx; p += blockDim.x) {
        const int s = wb[(size_t)(y0 + p / tw) * wp + x0 + p % tw] - base;
        const bool in = s >= 0 && s < kChunk;
        sw[p] = in ? s : -1;
        any |= in;
      }
      if (!__syncthreads_or(any)) continue;
      for (int p = 0; p < npx; ++p) {
        if (sw[p] != j) continue;
        const float* src = db + (size_t)(y0 + p / tw) * wp + x0 + p % tw;
#pragma unroll
        for (int k = 0; k < kLanes; ++k)
          acc[k] = __fadd_rn(acc[k], src[k * plane_px]);
      }
    }
  }
  float* dst = d_packed_s + (size_t)b * kLanes * tp + base + j;
#pragma unroll
  for (int k = 0; k < kLanes; ++k) dst[(size_t)k * tp] = acc[k];
}

}  // namespace

// K10 forward: packed_s (B, 32, tp), the tables, over the frame padded to
// whole (th, tw) tiles (nty*th, ntx*tw), pixel NDC over the real (fh, fw)
// frame
extern "C" int dd_raster_v3_fwd(const float* packed_s, const int* clo,
                                const int* chi, const int* rlo_tc,
                                const int* rhi_tc, int B, int tp, int nty,
                                int ntx, int th, int tw, int fh, int fw,
                                int* ids, int* win, float* rows,
                                void* stream) {
  dim3 grid(nty * ntx, B);
  raster_v3_fwd_kernel<<<grid, th * tw, 0, (cudaStream_t)stream>>>(
      packed_s, clo, chi, rlo_tc, rhi_tc, tp, ntx, th, tw, nty * th, ntx * tw,
      fh, fw, ids, win, rows);
  return (int)cudaGetLastError();
}

// K10 backward: d_packed_s (B, 32, tp), every slot written, from d_rows
// (B, 32, nty*th, ntx*tw) over the forward's winner map
extern "C" int dd_raster_v3_bwd(const float* d_rows, const int* win,
                                const int* clo, const int* chi,
                                const int* rlo_tc, const int* rhi_tc, int B,
                                int tp, int nty, int ntx, int th, int tw,
                                float* d_packed_s, void* stream) {
  dim3 grid(tp / kChunk, B);
  raster_v3_bwd_kernel<<<grid, kChunk, th * tw * sizeof(int),
                         (cudaStream_t)stream>>>(d_rows, win, clo, chi, rlo_tc,
                                                 rhi_tc, tp, nty, ntx, th, tw,
                                                 d_packed_s);
  return (int)cudaGetLastError();
}
