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
// K3: one thread block per (screen tile, hypothesis), one thread per pixel.
// The block walks its tile's compact slots through shared memory, 128 slots
// at a time; each thread evaluates every slot at its pixel centre and keeps
// the (z, triangle id) lexicographic minimum among covered slots with
// |z| <= 1.  It writes ids (+1, 0 = background), the winner's 32 lanes and
// the winner's slot index (the backward's map).  Bound on this card: the
// per-(pixel, slot) edge tests, ~20 FP32 operations each on data already in
// shared memory (compute bound, no reuse across pixels beyond the slot
// stage).
// The TPU kernel's chunk row-bound gating, quad windows and one-hot matmul
// gather are not carried over: gating only skips work, and a row gather is a
// plain indexed load here.
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
// padding up to K, which the TPU kernel skips by its row-bound gating.
//
// Numeric contract (build with -fmad=false, no fast math): the reference's
// f32 operation order, in raster_common.cuh (shared with K10).

#include "raster_common.cuh"

namespace {

using dd::Best;
using dd::kIdLanes;
using dd::kLanes;
constexpr int kStage = 128;   // slots staged in shared memory per round

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

template <class Range>
__global__ void raster_fwd_kernel(
    const float* __restrict__ bins, Range range, int tot, int ntx, int th,
    int tw, int hc, int wc, int oy, int ox, int fh, int fw,
    int* __restrict__ ids, int* __restrict__ win, float* __restrict__ rows) {
  __shared__ float st[kIdLanes][kStage];
  const int t = blockIdx.x;
  const int b = blockIdx.y;
  const int row = (t / ntx) * th + threadIdx.x / tw;
  const int col = (t % ntx) * tw + threadIdx.x % tw;
  const float x = dd::ndc(col + ox, fw);
  const float y = dd::ndc(row + oy, fh);
  int base, n;
  range(t, base, n);
  const float* tb = bins + (size_t)b * kLanes * tot;

  Best best = dd::none();
  for (int s0 = 0; s0 < n; s0 += kStage) {
    const int m = min(kStage, n - s0);
    __syncthreads();
    for (int i = threadIdx.x; i < kIdLanes * m; i += blockDim.x) {
      const int lane = i / m, j = i % m;
      st[lane][j] = tb[(size_t)lane * tot + base + s0 + j];
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) dd::test_slot<kStage>(st, j, base + s0 + j, x, y, best);
  }
  dd::write_winner(best, tb, tot, (size_t)hc * wc, b, (size_t)row * wc + col, ids,
                   win, rows);
}

__global__ void raster_bwd_kernel(const float* __restrict__ d_rows,
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
  const float* db = d_rows + (size_t)b * kLanes * plane_px;
  for (int q = p; q < npx; ++q) {
    if (sw[q] != s) continue;
    const float* src = db + pix_of(q);
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      acc[k] = __fadd_rn(acc[k], src[k * plane_px]);
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
  raster_fwd_kernel<<<grid, th * tw, 0, (cudaStream_t)stream>>>(
      bins, CompactRange{counts, off_c, used, k_chunk}, tot, ntx, th, tw,
      nty * th, ntx * tw, oy, ox, fh, fw, ids, win, rows);
  return (int)cudaGetLastError();
}

extern "C" int dd_raster_bwd(const float* d_rows, const int* win, int B,
                             int tot, int nty, int ntx, int th, int tw,
                             float* d_bins, void* stream) {
  dim3 grid(nty * ntx, B);
  raster_bwd_kernel<<<grid, th * tw, th * tw * sizeof(int),
                      (cudaStream_t)stream>>>(d_rows, win, tot, ntx, th, tw,
                                              nty * th, ntx * tw, d_bins);
  return (int)cudaGetLastError();
}

// K7 forward: the uniform table (B, 32, nty*ntx*k), the full frame padded
// to whole tiles, pixel NDC over the real (fh, fw) frame
extern "C" int dd_raster_uniform_fwd(const float* bins, const int* counts,
                                     int B, int k, int nty, int ntx, int th,
                                     int tw, int fh, int fw, int* ids,
                                     int* win, float* rows, void* stream) {
  dim3 grid(nty * ntx, B);
  raster_fwd_kernel<<<grid, th * tw, 0, (cudaStream_t)stream>>>(
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
  dim3 grid(nty * ntx, B);
  raster_bwd_kernel<<<grid, th * tw, th * tw * sizeof(int),
                      (cudaStream_t)stream>>>(d_rows, win, nty * ntx * k, ntx,
                                              th, tw, nty * th, ntx * tw,
                                              d_bins);
  return (int)cudaGetLastError();
}
