// Sorted-range raster backward for Hopper (sm_90a): K10's backward.
//
// Replaces diffdope_tpu/render/raster_v3.py:_bwd_kernel_v3, driven by
// raster_gather_rows_v3.  K10's forward is K3's body over the sorted
// table's chunks (raster.cu, SortedRange).  The plain torch versions that
// these are held to, and the sort and gating tables (_prepare), live in
// diffdope_tpu_torch/render/raster_v3.py.
//
// Inputs: the forward's winner map win (B, Hp, Wp), each pixel's sorted
// slot or -1, and d_rows (B, 32, Hp, Wp) over the frame padded to whole
// 16 x 16 tiles; per tile row ty the chunk range [clo[ty], chi[ty]); per
// (tile, chunk) the chunk's pixel-row interval [rlo_tc, rhi_tc] (empty
// where its x range misses the tile).  A tile walks chunk c when c is in
// its row's range and the interval is not empty and meets the tile's
// rows: the gate (dd::v3_gated), the same in both kernels, so every pixel
// a chunk's slot won lies in a tile gated to that chunk.
//
// A sorted slot is won in many tiles, so K4's per-tile owner sum does not
// give one writer per slot.  One block of 256 threads per (128-slot chunk,
// hypothesis) keeps the chunk's 128 x 32 sums in registers (warp w holds
// slots w, w + 8, ..., a thread one lane of them) and walks the tiles the
// forward gated this chunk into, in row-major order.  The gate of up to
// 1,024 tiles is decided at once, four tiles a thread, into a bit mask in
// shared memory; each thread loads its pixel's winner at the next gated
// tile while the block works on the current one.  Per gated tile, thread p
// on pixel p: (1) whether the pixel's winner lies in the chunk (a tile with
// none is skipped); (2) the d_rows of every 4-pixel quad holding such a
// pixel staged in shared memory, one float4 load per (lane, quad); (3)
// each warp walks the tile's pixels in ascending order, a ballot of 32 at
// a time, and adds each pixel whose winner is one of its slots onto that
// slot's sums, a thread a lane: no sort and no per-thread scan of the
// tile.  Each slot's sum is the TPU kernel's and the plain twin's
// sequence: from +0, the tiles in row-major order, a tile's pixels in
// ascending order, one __fadd_rn each; so it is bit-identical across
// launches, with one writer and no atomics.  After the last tile the sums
// go out through shared memory, consecutive threads on consecutive slots
// of a lane in float4 streaming stores, every slot written (zeros where not
// won).  Bound: the d_rows read at the foreground pixels (32 floats each),
// win, and the d_packed write.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using dd::kChunk;
using dd::kLanes;
constexpr int kTh = 16, kTw = 16, kPx = kTh * kTw;  // the tile; a thread a pixel
constexpr int kWarps = kPx / 32;
constexpr int kRowPad = kLanes + 1;             // a staged pixel's lanes, padded
constexpr int kSlotsPerWarp = kChunk / kWarps;  // slot j: warp j % 8, acc[j / 8]
constexpr int kGate = 4;                        // tiles whose gate a thread decides
constexpr int kWin = kGate * kPx;               // tiles a round of the walk
constexpr int kStageItems = kLanes * kTh * (kTw / 4) / kPx;  // (lane, quad)s a thread
constexpr int kBatch = 4;                                    // of them loaded at once

__global__ void __launch_bounds__(kPx, 4)
    raster_v3_bwd_kernel(const float* __restrict__ d_rows, const int* __restrict__ win,
                         const int* __restrict__ clo, const int* __restrict__ chi,
                         const int* __restrict__ rlo_tc, const int* __restrict__ rhi_tc,
                         int tp, int nty, int ntx, float* __restrict__ d_packed_s) {
  __shared__ float st[kPx][kRowPad];  // the tile's staged d_rows; at the end the sums
  __shared__ __align__(4) signed char sw[2][kPx];  // a pixel's slot in the chunk or
                                                   // -1, two tiles in turn
  __shared__ unsigned gated[kWin / 32];            // the round's gated tiles
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int p = threadIdx.x;
  const int warp = p >> 5, lane = p & 31;
  const int nc = tp / kChunk;
  const int base = c * kChunk;
  const int ntiles = nty * ntx;
  const int wp = ntx * kTw;
  const size_t plane_px = (size_t)nty * kTh * wp;
  const int* wb = win + (size_t)b * plane_px;
  const float* db = d_rows + (size_t)b * kLanes * plane_px;

  float acc[kSlotsPerWarp];  // slot warp + kWarps*i, lane ``lane``
#pragma unroll
  for (int i = 0; i < kSlotsPerWarp; ++i) acc[i] = 0.0f;
  int buf = 0;
  for (int t0 = 0; t0 < ntiles; t0 += kWin) {
    const int nt = min(kWin, ntiles - t0);
    bool g[kGate];
#pragma unroll
    for (int k = 0; k < kGate; ++k) {
      const int t = t0 + k * kPx + p;
      g[k] = t < ntiles && dd::v3_gated(clo, chi, rlo_tc, rhi_tc, nc, t, t / ntx, c,
                                        (t / ntx) * kTh, kTh);
    }
    __syncthreads();  // the last round's mask is read
#pragma unroll
    for (int k = 0; k < kGate; ++k) {
      const unsigned bits = __ballot_sync(0xffffffffu, g[k]);
      if (lane == 0) gated[k * kWarps + warp] = bits;
    }
    __syncthreads();
    // the first gated tile of the round at index >= i, or nt
    auto next_tile = [&](int i) {
      if (i >= nt) return nt;
      int w = i >> 5;
      unsigned m = gated[w] & (0xffffffffu << (i & 31));
      while (m == 0) {
        if (++w >= (nt + 31) >> 5) return nt;
        m = gated[w];
      }
      return (w << 5) + __ffs(m) - 1;
    };
    // this thread's pixel's winner at round tile i, relative to the chunk
    auto winner = [&](int i) {
      const int t = t0 + i, ty = t / ntx;
      return wb[(size_t)(ty * kTh + p / kTw) * wp + (t - ty * ntx) * kTw + p % kTw] - base;
    };
    int i = next_tile(0);
    int s_next = i < nt ? winner(i) : 0;
    while (i < nt) {
      const int t = t0 + i, s = s_next;
      i = next_tile(i + 1);
      if (i < nt) s_next = winner(i);  // in flight while this tile is summed
      const int y0 = (t / ntx) * kTh, x0 = (t % ntx) * kTw;
      // (1) the tile's winners in this chunk
      const bool in = s >= 0 && s < kChunk;
      signed char* swb = sw[buf];
      swb[p] = in ? s : -1;
      if (!__syncthreads_count(in)) continue;  // the same for the whole block
      // (2) stage: item q is (lane 4 kh + kl, row 2 rh + rl, quad g4), so a
      // warp's 32 stores to st hit 32 banks; quads without a pixel of the
      // chunk are not read; four loads of a thread in flight at once
#pragma unroll
      for (int h = 0; h < kStageItems / kBatch; ++h) {
        float4 v[kBatch];
        int at[kBatch], lane_of[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int q = p + kPx * (kBatch * h + u);
          const int g4 = q & 3, rl = (q >> 2) & 1, kl = (q >> 3) & 3, rh = (q >> 5) & 7,
                    kh = q >> 8;
          const int row = 2 * rh + rl, k = 4 * kh + kl, p0 = row * kTw + 4 * g4;
          at[u] = *reinterpret_cast<const int*>(&swb[p0]) == -1 ? -1 : p0;  // four -1
          lane_of[u] = k;
          if (at[u] >= 0)
            v[u] = *reinterpret_cast<const float4*>(
                db + k * plane_px + (size_t)(y0 + row) * wp + x0 + 4 * g4);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (at[u] < 0) continue;
          st[at[u]][lane_of[u]] = v[u].x;
          st[at[u] + 1][lane_of[u]] = v[u].y;
          st[at[u] + 2][lane_of[u]] = v[u].z;
          st[at[u] + 3][lane_of[u]] = v[u].w;
        }
      }
      __syncthreads();
      // (3) a warp its slots' pixels in ascending order, a thread a lane
#pragma unroll
      for (int r = 0; r < kPx / 32; ++r) {
        const int sq = swb[32 * r + lane];
        unsigned mine = __ballot_sync(0xffffffffu, sq >= 0 && sq % kWarps == warp);
        while (mine) {
          const int bit = __ffs(mine) - 1;
          mine &= mine - 1;
          const int j = __shfl_sync(0xffffffffu, sq, bit) / kWarps;
          const float v = st[32 * r + bit][lane];
#pragma unroll
          for (int a = 0; a < kSlotsPerWarp; ++a)
            if (a == j) acc[a] = __fadd_rn(acc[a], v);
        }
      }
      buf ^= 1;
    }
  }

  // every slot of the chunk: its sums through shared memory, then a lane's
  // four consecutive slots a thread in one streaming float4 store
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSlotsPerWarp; ++i) st[warp + kWarps * i][lane] = acc[i];
  __syncthreads();
  float* out = d_packed_s + (size_t)b * kLanes * tp + base;
  for (int i = p; i < kLanes * kChunk / 4; i += kPx) {
    const int k = i / (kChunk / 4), j = 4 * (i % (kChunk / 4));
    __stcs(reinterpret_cast<float4*>(out + (size_t)k * tp + j),
           make_float4(st[j][k], st[j + 1][k], st[j + 2][k], st[j + 3][k]));
  }
}

}  // namespace

// K10 backward: d_packed_s (B, 32, tp), every slot written, from d_rows
// (B, 32, nty*16, ntx*16) over the forward's winner map; 16 x 16 tiles
// only, d_rows 16-byte aligned
extern "C" int dd_raster_v3_bwd(const float* d_rows, const int* win,
                                const int* clo, const int* chi,
                                const int* rlo_tc, const int* rhi_tc, int B,
                                int tp, int nty, int ntx, int th, int tw,
                                float* d_packed_s, void* stream) {
  if (th != kTh || tw != kTw || tp % kChunk) return (int)cudaErrorInvalidValue;
  dim3 grid(tp / kChunk, B);
  raster_v3_bwd_kernel<<<grid, kPx, 0, (cudaStream_t)stream>>>(
      d_rows, win, clo, chi, rlo_tc, rhi_tc, tp, nty, ntx, d_packed_s);
  return (int)cudaGetLastError();
}
