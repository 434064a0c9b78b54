// Fused shade + mask antialiasing + masked L1 loss sums (K5) and its
// backward (K6) for Hopper (sm_90a).
//
// K5 replaces diffdope_tpu/render/fused_loss.py:_fwd_kernel (driven by _fwd
// / fused_loss_sums / _rlc_fwd).  K6 replaces fused_loss.py:_bwd_kernel
// (driven by backward_pass / _rlc_bwd), whose body calls jax.vjp; the
// derivative here is written out by hand.  The plain torch versions that
// these are held to are in diffdope_tpu_torch/render/fused_loss.py (K6's is
// torch.autograd of K5's).
//
// A thread takes pixels of a hypothesis' (hc, wc) frame window.  A pixel's
// antialiased mask needs its four neighbour pairs (shade.py:264-292); the
// TPU kernel's row slabs and 2-row halos exist only for VMEM.
//
// K5: shade (shade.py:168-197), mask AA over the pixel's horizontal and
// vertical pairs, masked L1 terms (fused_loss.py:78-121).  Bound on this
// card: the bytes (below).  The design (loss_fwd_kernel):
// - a pair is evaluated only on the silhouette (one pixel foreground, the
//   other not, both real), which is exact: on a pair of two foreground
//   pixels the mask colour is 1 on both sides, so both deltas are +-0, and
//   x + +-0 = x for every x the sum meets.  The foreground side is then the
//   one with id > 0, so K5 needs no depth order (the reference's zw) at all;
// - a block takes a 16 x 16 pixel tile, two pixels a thread, with its ids
//   and a one-pixel halo and the NDC of its rows and columns in shared
//   memory; its silhouette pairs are listed there and searched once each,
//   one a thread, so no warp runs four divergent searches;
// - a background pixel reads no rows (its attributes are 0); a foreground
//   pixel reads its edge planes and the channels its lane shades;
// - the block's sums: warp shuffles, then the warps in order; then one
//   block per hypothesis adds its tile partials, 256 strided runs in
//   order, then the same tree — deterministic, no atomics in a sum, all in
//   f32 (every term is >= 0, so the rounding stays ~1e-6 of the sum).
// The pixel terms are the previous kernel's bit for bit; only the order of
// the sums changed.
//
// K6: d_rows per pixel as a gather over the pixel's own terms: the rgb term
// through s and lanes 16-24, plus, for each silhouette pair this pixel is
// the foreground pixel of, the mask term through the pair's lam into that
// edge line's lanes 0-8.  Tie rules are JAX's: d|x|/dx = +1 at 0,
// maximum/clip split 0.5/0.5.  The design (loss_bwd_kernel), as the TPU
// kernel's one pallas_call with 2-row halos (fused_loss.py:284-343): one
// launch, a block per 16 x 16 tile with its ids staged with a two-pixel
// halo, g = dL/d(aa) computed in shared memory at the pixels of the tile
// and its one-pixel halo that a silhouette pair reads (K5's gate and
// premise: a pair of two foreground pixels adds +-0 to the mask and to
// every edge lane), each silhouette pair searched once; two consecutive
// pixels a thread, so each of the 32 lanes goes out as one vector store.
// Every output value is bit for bit what a per-pixel evaluation of all four
// pairs of both pixels gives in the reference's order.
//
// The depth lane (kDepth, when the caller passes a dplane = gt depth + t_z
// per hypothesis): K5 adds |attr_z + dplane| * seg0 per pixel
// (fused_loss.py:117-120; attr_z, the rotated-z attribute in lanes 25-27,
// is 0 on background, so a background pixel adds |dplane| * seg0 as the TPU
// kernel's background slabs do, :253-256), and K6 writes d_dplane =
// dd * seg0 * d|v|/dv at every real pixel, foreground or not
// (:346-354), and the attr_z cotangent into lanes 25-27 of a foreground
// pixel.  d|v|/dv is +1 at v = 0 everywhere: the TPU kernel takes
// jnp.sign (0 at 0) on slabs without foreground, a rule that depends on
// its slab height; the port keeps one rule.  The rgb + mask launch
// (kDepth and kColors false) keeps the arithmetic it had before the depth
// and colour lanes existed.
//
// The colour lane (kColors, when the caller passes colour planes (B, 3, hc,
// wc): the semi-fused exact-texture route's texture samples, foreground-
// masked by the caller; the TPU kernel's with_colors=True): the rows then
// hold n_ch = 2 uv channels (lanes 16-21) before the rotated z (22-24), and
// the rgb term reads colors[b, c, p] in place of the shaded colour
// (fused_loss.py:115).  The shade computes only what is still read: s
// and, with depth, the z channel.  K6 writes d_colors[b, c, p] = dr * seg_c
// * sgn(col_c - rgb_c) at every real pixel (0 past the frame) and no rgb
// cotangent into the attribute lanes; the uv lanes' cotangent comes from
// the sampler outside.  The TPU kernel writes d_colors only in slabs with
// foreground (zeros elsewhere, :346-356); the caller's foreground factor
// removes the background values in both.
//
// The bf16 lane (dd_loss_bwd_bf16, the rgb + mask launch only): the
// reference's spanning op writes its d_rows cotangent in bf16 by default
// (DD_DROWS_BF16=1, fused_loss.py:552); the same f32 values are rounded
// once with __float2bfloat16_rn at the store, halving the d_rows write.
//
// Bound on this card: the bytes (memory bound).  K5 and K6 read the same
// row lanes: of each foreground pixel the edge lanes 0-8 and its lane's
// channels (16-24, and the rotated z with depth), and lanes 12 and 14 at a
// silhouette pair's foreground pixel (kernels/check.py:k5_row_lanes); K6
// writes all 32 lanes of d_rows at every pixel.
//
// Numeric contract (build with -fmad=false, no fast math): every product
// and sum is rounded as in the reference's f32 expression order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kLanes = 32;
constexpr int kBlock = 256;
constexpr int kTileH = 16, kTileW = 16;  // K5's pixel tile, one block
constexpr int kPx = 2;                   // K5's pixels a thread
constexpr float kEps = 1e-12f;

__device__ __forceinline__ float ndc(int pix, int frame) {
  return __fsub_rn(
      __fdiv_rn(__fadd_rn(__fmul_rn(2.0f, (float)pix), 1.0f), (float)frame),
      1.0f);
}

// (a*x + b*y) + c, each product and sum rounded
__device__ __forceinline__ float lin3(float a, float x, float b, float y,
                                      float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

// d|v|/dv as JAX differentiates abs: +1 at 0
__device__ __forceinline__ float sgn_jax(float v) {
  return v >= 0.0f ? 1.0f : -1.0f;
}

struct Frame {
  const float* rows;  // (32, hc, wc) of one hypothesis
  const int* ids;     // (hc, wc)
  const float* gt6;   // (6, hc, wc)
  int hc, wc;
  size_t plane;
  int oy, ox, fh, fw, vh, vw;

  __device__ float lane(int k, size_t p) const { return rows[k * plane + p]; }
  __device__ float x(int c) const { return ndc(c + ox, fw); }
  __device__ float y(int r) const { return ndc(r + oy, fh); }
  __device__ bool valid(int r, int c) const { return r < vh && c < vw; }
};

__device__ Frame make_frame(const float* rows, const int* ids,
                            const float* gt6, int b, int hc, int wc, int oy,
                            int ox, int fh, int fw) {
  Frame f;
  f.hc = hc;
  f.wc = wc;
  f.plane = (size_t)hc * wc;
  f.rows = rows + (size_t)b * kLanes * f.plane;
  f.ids = ids + (size_t)b * f.plane;
  f.gt6 = gt6;
  f.oy = oy;
  f.ox = ox;
  f.fh = fh;
  f.fw = fw;
  f.vh = min(hc, fh - oy);
  f.vw = min(wc, fw - ox);
  return f;
}

// One antialiasing pair (a, b), b right of / below a (shade.py:296-387).
struct Pair {
  float delta_a = 0.0f, delta_b = 0.0f;
  bool gate = false, fg_is_a = false;
  // for the backward: the selected edge line m of the foreground pixel
  int m = -1;
  float lam = 0.0f, mu = 0.0f, diff = 0.0f;
  float cross = 0.0f, denom = 0.0f, across = 0.0f, seg = 1.0f;
};

// The crossing search of an active pair whose foreground pixel is a
// (fg_is_a) or b, on that pixel's edge planes: the pair's deltas and, for
// the backward, its selected edge line.  xy gives the pixels' NDC
// (xy.x(c), xy.y(r)): the frame itself, or a table of the same values.
template <class XY>
__device__ Pair search_pair(const Frame& f, const XY& xy, int ra, int ca, int rb,
                            int cb, bool horizontal, bool fg_is_a, int id_a, int id_b) {
  Pair out;
  out.fg_is_a = fg_is_a;
  const size_t pf = fg_is_a ? (size_t)ra * f.wc + ca : (size_t)rb * f.wc + cb;
  const float along = horizontal ? xy.x(ca) : xy.y(ra);
  const float along_next = horizontal ? xy.x(cb) : xy.y(rb);
  const float across = horizontal ? xy.y(ra) : xy.x(ca);
  const float seg = __fsub_rn(along_next, along);
  const int sil = (int)f.lane(14, pf);
  const float det = f.lane(12, pf);
  const float det_sign = det > 0.0f ? 1.0f : (det < 0.0f ? -1.0f : 0.0f);
  float a[3], bq[3], cq[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    a[j] = f.lane(3 * j, pf);
    bq[j] = f.lane(3 * j + 1, pf);
    cq[j] = f.lane(3 * j + 2, pf);
  }
  float lam_min = CUDART_INF_F, lam_max = -CUDART_INF_F;
  int m_min = -1, m_max = -1;
  float cross_l[3], den_l[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const float denom = horizontal ? a[m] : bq[m];
    const float num = horizontal
                          ? -__fadd_rn(__fmul_rn(bq[m], across), cq[m])
                          : -__fadd_rn(__fmul_rn(a[m], across), cq[m]);
    const bool dok = fabsf(denom) > kEps;
    const float cross = __fdiv_rn(num, dok ? denom : kEps);
    cross_l[m] = cross;
    den_l[m] = denom;
    const float lam = __fdiv_rn(__fsub_rn(cross, along), seg);
    bool on_edge = true;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j == m) continue;
      const float ej = horizontal ? lin3(a[j], cross, bq[j], across, cq[j])
                                  : lin3(a[j], across, bq[j], cross, cq[j]);
      on_edge = on_edge && (__fmul_rn(ej, det_sign) >= 0.0f);
    }
    const bool valid = dok && on_edge && lam >= 0.0f && lam <= 1.0f &&
                       ((sil >> m) & 1) != 0;
    if (valid && lam < lam_min) {
      lam_min = lam;
      m_min = m;
    }
    if (valid && lam > lam_max) {
      lam_max = lam;
      m_max = m;
    }
  }
  if (m_min < 0) return out;  // no valid crossing: the pair is gated off

  const float lam = fg_is_a ? lam_min : lam_max;
  const int m = fg_is_a ? m_min : m_max;
  const float lam_c = fminf(fmaxf(lam, 0.0f), 1.0f);
  const float mu = fg_is_a ? __fsub_rn(lam_c, 0.5f) : __fsub_rn(0.5f, lam_c);
  const float c_a = id_a > 0 ? 1.0f : 0.0f, c_b = id_b > 0 ? 1.0f : 0.0f;
  const float diff = fg_is_a ? __fsub_rn(c_a, c_b) : __fsub_rn(c_b, c_a);
  const float delta_bg = __fmul_rn(fmaxf(mu, 0.0f), diff);
  const float delta_fg = __fmul_rn(-fmaxf(-mu, 0.0f), diff);
  out.delta_a = fg_is_a ? delta_fg : delta_bg;
  out.delta_b = fg_is_a ? delta_bg : delta_fg;
  out.gate = true;
  out.m = m;
  out.lam = lam;
  out.mu = mu;
  out.diff = diff;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (k == m) {
      out.cross = cross_l[k];
      out.denom = den_l[k];
    }
  out.across = across;
  out.seg = seg;
  return out;
}

// The attribute channels a launch reads: the rows hold kNCh colour (3) or
// uv (2) channels from lane 16, then the rotated z; the rgb + mask lanes
// read the colours (and z), the colour lane z alone, with depth.
template <bool kDepth, bool kColors>
struct Lanes {
  static constexpr int kNCh = kColors ? 2 : 3;
  static constexpr int kFirst = kColors ? kNCh : 0;  // first channel read
  static constexpr int kRead = (kColors ? 0 : kNCh) + (kDepth ? 1 : 0);
  static constexpr int kZ = kRead - 1;  // index of z among those read
};

// kN >= 1 attribute channels from channel kFirst (lanes 16 + 3 kFirst on)
template <int kN>
struct Shade {
  float e[3], s, s_safe, num[kN], attr[kN];
};

template <int kFirst, int kN, class XY>
__device__ Shade<kN> shade_at(const Frame& f, const XY& xy, int r, int c, bool fg) {
  Shade<kN> sh;
  const size_t p = (size_t)r * f.wc + c;
  const float x = xy.x(c), y = xy.y(r);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    sh.e[j] = lin3(f.lane(3 * j, p), x, f.lane(3 * j + 1, p), y,
                   f.lane(3 * j + 2, p));
  sh.s = __fadd_rn(__fadd_rn(sh.e[0], sh.e[1]), sh.e[2]);
  sh.s_safe = fabsf(sh.s) > kEps ? sh.s : 1.0f;
#pragma unroll
  for (int ch = 0; ch < kN; ++ch) {
    const int k = 16 + 3 * (kFirst + ch);
    sh.num[ch] = lin3(f.lane(k, p), x, f.lane(k + 1, p), y, f.lane(k + 2, p));
    sh.attr[ch] = fg ? __fdiv_rn(sh.num[ch], sh.s_safe) : 0.0f;
  }
  return sh;
}

// The NDC of a tile's columns and rows and its one-pixel halo, staged once
// by the block (the frame's own values: Frame::x, Frame::y).
struct TileXY {
  const float* xs;  // kTileW + 2 columns from c0 - 1
  const float* ys;  // kTileH + 2 rows from r0 - 1
  int c0, r0;
  __device__ float x(int c) const { return xs[c - c0 + 1]; }
  __device__ float y(int r) const { return ys[r - r0 + 1]; }
};

// K5's gate of a pair (a, b), b right of / below a: a silhouette pair, one
// pixel foreground and the other not, both real (a past the window's first
// row or column is not).  A pair of two foreground pixels adds +-0 to both
// (the mask colour is 1 on both sides, so diff = 0), and adding +-0 changes
// no antialiased value: the reference evaluates those pairs, K5 skips them.
// On a silhouette pair the foreground side is the one with id > 0, so no
// depth order is needed.
__device__ __forceinline__ bool silhouette(const Frame& f, int ra, int ca, int rb,
                                           int cb, int id_a, int id_b) {
  return (id_a > 0) != (id_b > 0) && ra >= 0 && ca >= 0 && f.valid(rb, cb);
}

// the sum of v over the block's threads: warp shuffles, then the warps in
// order (thread 0 holds it)
template <int kN>
__device__ __forceinline__ void block_sum(float (&v)[kN], float (&warp_sums)[kN][32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kN; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] = __fadd_rn(v[k], __shfl_down_sync(0xffffffffu, v[k], off));
    if (lane == 0) warp_sums[k][warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      v[k] = warp_sums[k][0];
      for (int w = 1; w < (int)(blockDim.x >> 5); ++w)
        v[k] = __fadd_rn(v[k], warp_sums[k][w]);
    }
  }
}

// K5: one block per (kTileH x kTileW pixel tile, hypothesis), kPx pixels
// of one column a thread (rows kTileH / kPx apart).  The tile's ids with a
// one-pixel halo and the NDC of its rows and columns are staged in shared
// memory, so the pair gates read no device memory and no pixel divides for
// its NDC; the loads that need no id (gt6, the planes) go out before the
// staging barrier.  The tile's silhouette pairs (its pixels' right and
// lower pairs, and the pairs into its left and upper halo) are listed in
// shared memory and searched one a thread, each once, in place of a
// divergent search by both pixels of the pair; their deltas wait in
// shared memory for the pixels.  Only a foreground pixel reads rows (its
// edge planes and the channels its lane shades), and only a silhouette
// pair's search reads its foreground pixel's det and silhouette lanes.  A
// thread adds its pixels' terms in row order; the block's sums go to
// partials[b, tile, :] by block_sum.
template <bool kDepth, bool kColors>
__global__ void __launch_bounds__(kTileH * kTileW / kPx)
    loss_fwd_kernel(const float* __restrict__ rows, const int* __restrict__ ids,
                    const float* __restrict__ gt6, const float* __restrict__ dplane,
                    const float* __restrict__ colors, int hc, int wc, int oy,
                    int ox, int fh, int fw, float* __restrict__ partials) {
  using L = Lanes<kDepth, kColors>;
  constexpr int kSums = kDepth ? 3 : 2;
  constexpr int kStep = kTileH / kPx;  // rows between a thread's pixels
  constexpr int kPairs = kTileH * (kTileW + 1) + (kTileH + 1) * kTileW;
  __shared__ int tile_ids[kTileH + 2][kTileW + 2];
  __shared__ float xs[kTileW + 2], ys[kTileH + 2];
  // the deltas of a's and b's side: dh[i][j] of the horizontal pair at row
  // r0 + i, a in column c0 - 1 + j; dv[i][j] of the vertical pair at column
  // c0 + j, a in row r0 - 1 + i
  __shared__ float dh[kTileH][kTileW + 1][2], dv[kTileH + 1][kTileW][2];
  __shared__ int pairs[kPairs], n_pairs;
  __shared__ float warp_sums[kSums][32];
  const int b = blockIdx.y;
  const Frame f = make_frame(rows, ids, gt6, b, hc, wc, oy, ox, fh, fw);
  const int ntx = (wc + kTileW - 1) / kTileW;
  const int r0 = (blockIdx.x / ntx) * kTileH, c0 = (blockIdx.x % ntx) * kTileW;
  const int lx = threadIdx.x % kTileW + 1, ly0 = threadIdx.x / kTileW + 1;
  const int c = c0 + lx - 1;
  // the loads that need no id go out with the tile's ids, one round trip
  float seg[kPx][3], rgb[kPx][3], col[kPx][3], dpl[kPx];
#pragma unroll
  for (int q = 0; q < kPx; ++q) {
    const int r = r0 + ly0 - 1 + q * kStep;
    const size_t p = (size_t)r * wc + c;
    const bool real = r < hc && c < wc && f.valid(r, c);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      seg[q][ch] = real ? f.gt6[ch * f.plane + p] : 0.0f;
      rgb[q][ch] = real ? f.gt6[(3 + ch) * f.plane + p] : 0.0f;
      col[q][ch] = kColors && real ? colors[((size_t)b * 3 + ch) * f.plane + p] : 0.0f;
    }
    dpl[q] = kDepth && real ? dplane[(size_t)b * f.plane + p] : 0.0f;
  }
  for (int i = threadIdx.x; i < (kTileH + 2) * (kTileW + 2); i += blockDim.x) {
    const int rr = r0 - 1 + i / (kTileW + 2), cc = c0 - 1 + i % (kTileW + 2);
    tile_ids[i / (kTileW + 2)][i % (kTileW + 2)] =
        rr >= 0 && rr < hc && cc >= 0 && cc < wc ? f.ids[(size_t)rr * wc + cc] : 0;
  }
  for (int i = threadIdx.x; i < kTileW + 2; i += blockDim.x) xs[i] = f.x(c0 - 1 + i);
  for (int i = threadIdx.x; i < kTileH + 2; i += blockDim.x) ys[i] = f.y(r0 - 1 + i);
  if (threadIdx.x == 0) n_pairs = 0;
  __syncthreads();

  // list the silhouette pairs (code: vertical << 16 | i << 8 | j); the
  // list's order does not matter, each pair's deltas have a place of their own
#pragma unroll
  for (int q = 0; q < kPx; ++q) {
    const int ly = ly0 + q * kStep, r = r0 + ly - 1;
    if (!(r < hc && c < wc && f.valid(r, c))) continue;
    const int id = tile_ids[ly][lx];
    if (silhouette(f, r, c, r, c + 1, id, tile_ids[ly][lx + 1]))
      pairs[atomicAdd(&n_pairs, 1)] = (ly - 1) << 8 | lx;
    if (silhouette(f, r, c, r + 1, c, id, tile_ids[ly + 1][lx]))
      pairs[atomicAdd(&n_pairs, 1)] = 1 << 16 | ly << 8 | (lx - 1);
    if (lx == 1 && silhouette(f, r, c - 1, r, c, tile_ids[ly][0], id))
      pairs[atomicAdd(&n_pairs, 1)] = (ly - 1) << 8;
    if (ly == 1 && silhouette(f, r - 1, c, r, c, tile_ids[0][lx], id))
      pairs[atomicAdd(&n_pairs, 1)] = 1 << 16 | (lx - 1);
  }
  __syncthreads();
  const TileXY xy{xs, ys, c0, r0};
  for (int k = threadIdx.x; k < n_pairs; k += blockDim.x) {
    const bool vertical = pairs[k] >> 16;
    const int i = (pairs[k] >> 8) & 0xff, j = pairs[k] & 0xff;
    // a's and b's place in the tile (1-based, 0 the halo)
    const int ya = vertical ? i : i + 1, xa = vertical ? j + 1 : j;
    const int yb = i + 1, xb = j + 1;
    const int id_a = tile_ids[ya][xa], id_b = tile_ids[yb][xb];
    const Pair pr = search_pair(f, xy, r0 + ya - 1, c0 + xa - 1, r0 + yb - 1, c0 + xb - 1,
                                !vertical, id_a > 0, id_a, id_b);
    float* d = vertical ? dv[i][j] : dh[i][j];
    d[0] = pr.delta_a;
    d[1] = pr.delta_b;
  }
  __syncthreads();

  float sums[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) sums[k] = 0.0f;
#pragma unroll
  for (int q = 0; q < kPx; ++q) {
    const int ly = ly0 + q * kStep, r = r0 + ly - 1;
    if (!(r < hc && c < wc && f.valid(r, c))) continue;
    const int id = tile_ids[ly][lx];
    const bool fg = id > 0;
    float attr_z = 0.0f;
    if constexpr (L::kRead > 0) {
      if (fg) {  // a background pixel's attributes are 0
        const Shade<L::kRead> sh = shade_at<L::kFirst, L::kRead>(f, xy, r, c, true);
        if constexpr (!kColors) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) col[q][ch] = sh.attr[ch];
        }
        if constexpr (kDepth) attr_z = sh.attr[L::kZ];
      }
    }
    // antialiased foreground mask: color + ((h_a + h_b) + v_a) + v_b
    const float h_a =
        silhouette(f, r, c, r, c + 1, id, tile_ids[ly][lx + 1]) ? dh[ly - 1][lx][0] : 0.0f;
    const float h_b = silhouette(f, r, c - 1, r, c, tile_ids[ly][lx - 1], id)
                          ? dh[ly - 1][lx - 1][1] : 0.0f;
    const float v_a =
        silhouette(f, r, c, r + 1, c, id, tile_ids[ly + 1][lx]) ? dv[ly][lx - 1][0] : 0.0f;
    const float v_b = silhouette(f, r - 1, c, r, c, tile_ids[ly - 1][lx], id)
                          ? dv[ly - 1][lx - 1][1] : 0.0f;
    const float aa = __fadd_rn(fg ? 1.0f : 0.0f,
                               __fadd_rn(__fadd_rn(__fadd_rn(h_a, h_b), v_a), v_b));
    float m_term = 0.0f, r_term = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      m_term = __fadd_rn(m_term, fabsf(__fsub_rn(aa, seg[q][ch])));
      r_term = __fadd_rn(r_term,
                         __fmul_rn(fabsf(__fsub_rn(col[q][ch], rgb[q][ch])), seg[q][ch]));
    }
    sums[0] = __fadd_rn(sums[0], m_term);
    sums[1] = __fadd_rn(sums[1], r_term);
    if constexpr (kDepth)
      sums[kSums - 1] = __fadd_rn(sums[kSums - 1],
                                  __fmul_rn(fabsf(__fadd_rn(attr_z, dpl[q])), seg[q][0]));
  }
  block_sum(sums, warp_sums);
  if (threadIdx.x == 0) {
    float* out = partials + ((size_t)b * gridDim.x + blockIdx.x) * kSums;
#pragma unroll
    for (int k = 0; k < kSums; ++k) out[k] = sums[k];
  }
}

// sums[b, :]: hypothesis b's tile partials (one block), thread t adding
// tiles t, t + 256, ... in order, then block_sum; the depth sum is 0
// without the depth lane
template <int kSums>
__global__ void loss_reduce_kernel(const float* __restrict__ partials, int ntiles,
                                   float* __restrict__ sums) {
  __shared__ float warp_sums[kSums][32];
  const int b = blockIdx.x;
  const float* pp = partials + (size_t)b * ntiles * kSums;
  float v[kSums];
#pragma unroll
  for (int k = 0; k < kSums; ++k) v[k] = 0.0f;
  for (int i = threadIdx.x; i < ntiles; i += blockDim.x) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) v[k] = __fadd_rn(v[k], pp[(size_t)kSums * i + k]);
  }
  block_sum(v, warp_sums);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) sums[b * 3 + k] = k < kSums ? v[k] : 0.0f;
  }
}

// adds v to lane k (0 <= k < 9) with static register indices
__device__ __forceinline__ void add_lane(float (&d)[9], int k, float v) {
#pragma unroll
  for (int i = 0; i < 9; ++i)
    if (i == k) d[i] = __fadd_rn(d[i], v);
}

// d_rows' element types: f32, or bf16 rounded once to nearest even (the
// reference's .astype(bfloat16) of the f32 value).  Two consecutive pixels'
// values of one lane go out as one vector store where ``pair`` (the first
// pixel's index even, the frame's width even, the base aligned), else one
// store each (the second where ``second``).
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b, bool pair,
                                       bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
    return;
  }
  p[0] = a;
  if (second) p[1] = b;
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    return;
  }
  store(p, a);
  if (second) store(p + 1, b);
}

// K6's tile: the ids are staged with a two-pixel halo (tile_ids[0][0] is
// pixel (r0 - 2, c0 - 2)); g lives on the region, the tile and its
// one-pixel halo (gs[0][0] is pixel (r0 - 1, c0 - 1)); the pairs are the
// region's: horizontal pair (i, j) joins (r0 - 1 + i, c0 - 2 + j) and the
// pixel to its right, vertical pair (i, j) joins (r0 - 2 + i, c0 - 1 + j)
// and the pixel below.  A pair's code is its index: the horizontal pairs,
// then the vertical ones.
constexpr int kBwdPx = 2;  // K6: consecutive pixels of one tile row a thread
constexpr int kRegH = kTileH + 2, kRegW = kTileW + 2;
constexpr int kHPairs = kRegH * (kRegW + 1), kVPairs = (kRegH + 1) * kRegW;

// pair ``code``: whether it is vertical, its (i, j), and its pixels a and b
// in tile_ids
__device__ __forceinline__ bool pair_at(int code, int& i, int& j, int& ya, int& xa,
                                        int& yb, int& xb) {
  const bool vertical = code >= kHPairs;
  if (vertical) {
    code -= kHPairs;
    i = code / kRegW;
    j = code % kRegW;
    ya = i;
    yb = i + 1;
    xa = xb = j + 1;
  } else {
    i = code / (kRegW + 1);
    j = code % (kRegW + 1);
    ya = yb = i + 1;
    xa = j;
    xb = j + 1;
  }
  return vertical;
}

// K6: one block per (kTileH x kTileW pixel tile, hypothesis), kBwdPx
// consecutive pixels of one tile row a thread; g = dL/d(aa) never leaves
// the block.  (1) The tile's ids with a two-pixel halo and the NDC of its
// rows and columns are staged in shared memory (the loads that every real
// pixel needs, and no id, go out first).  (2) The region's silhouette pairs
// are listed (none, with no barrier, where its ids hold no foreground) and
// (3) searched once each, one a thread: their deltas and the backward's
// scalars (lam, cross, denom, m) wait in shared memory.  (4) g at every
// region pixel on a silhouette pair: aa from its four pairs (the
// reference's sum order, K5's gate), then dm * sum_c sgn(aa - seg_c).
// (5) Each pixel's cotangent in the previous kernel's order: the shading
// backward into the edge lanes, then its pairs right, left, below, above,
// each a silhouette pair (on a pair of two foreground pixels diff = 0 and
// every term is +-0, and an edge lane that starts at +0 is never -0 under
// round to nearest, so x + +-0 = x: skipping them is exact); then the 32
// lanes of the two pixels, one vector store a lane.  A background pixel
// reads no rows, and on the rgb lane no ground truth either.
template <bool kDepth, bool kColors, typename TOut>
__global__ void __launch_bounds__(kTileH * kTileW / kBwdPx)
    loss_bwd_kernel(const float* __restrict__ rows, const int* __restrict__ ids,
                    const float* __restrict__ gt6, const float* __restrict__ dplane,
                    const float* __restrict__ colors, const float* __restrict__ d_sums,
                    int hc, int wc, int oy, int ox, int fh, int fw, bool pair_stores,
                    TOut* __restrict__ d_rows, float* __restrict__ d_dplane,
                    float* __restrict__ d_colors) {
  using L = Lanes<kDepth, kColors>;
  constexpr int kN = L::kRead > 0 ? L::kRead : 1;  // array extent
  constexpr int kOut = 9 + 3 * kN;                 // the edge lanes, the channels read
  __shared__ int tile_ids[kTileH + 4][kTileW + 4];
  __shared__ float xs[kTileW + 4], ys[kTileH + 4];
  __shared__ float2 dh[kRegH][kRegW + 1], dv[kRegH + 1][kRegW];  // delta_a, delta_b
  __shared__ float4 bh[kRegH][kRegW + 1], bv[kRegH + 1][kRegW];  // lam, cross, denom, m
  __shared__ float gs[kRegH][kRegW];
  __shared__ unsigned short pairs[kHPairs + kVPairs];
  __shared__ int n_pairs;
  const int b = blockIdx.y;
  const Frame f = make_frame(rows, ids, gt6, b, hc, wc, oy, ox, fh, fw);
  const int ntx = (wc + kTileW - 1) / kTileW;
  const int r0 = (blockIdx.x / ntx) * kTileH, c0 = (blockIdx.x % ntx) * kTileW;
  const int ty = threadIdx.x / (kTileW / kBwdPx), tx = threadIdx.x % (kTileW / kBwdPx);
  const int r = r0 + ty, c = c0 + kBwdPx * tx;  // the thread's first pixel

  // the loads that need no id go out with the tile's ids: what every real
  // pixel needs (the colour lane's planes, the depth lane's seg0 and
  // dplane); the rgb lane's planes wait for a foreground pixel
  float seg[kBwdPx][3], rgb[kBwdPx][3], col[kBwdPx][3], dpl[kBwdPx];
  bool real[kBwdPx], valid[kBwdPx];
#pragma unroll
  for (int e = 0; e < kBwdPx; ++e) {
    const size_t p = (size_t)r * wc + c + e;
    real[e] = r < hc && c + e < wc;
    valid[e] = real[e] && f.valid(r, c + e);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const bool now = valid[e] && (kColors || (kDepth && ch == 0));
      seg[e][ch] = now ? f.gt6[ch * f.plane + p] : 0.0f;
      rgb[e][ch] = kColors && valid[e] ? f.gt6[(3 + ch) * f.plane + p] : 0.0f;
      col[e][ch] = kColors && valid[e] ? colors[((size_t)b * 3 + ch) * f.plane + p] : 0.0f;
    }
    dpl[e] = kDepth && valid[e] ? dplane[(size_t)b * f.plane + p] : 0.0f;
  }
  int any_fg = 0;
  for (int i = threadIdx.x; i < (kTileH + 4) * (kTileW + 4); i += blockDim.x) {
    const int rr = r0 - 2 + i / (kTileW + 4), cc = c0 - 2 + i % (kTileW + 4);
    const int id =
        rr >= 0 && rr < hc && cc >= 0 && cc < wc ? f.ids[(size_t)rr * wc + cc] : 0;
    tile_ids[i / (kTileW + 4)][i % (kTileW + 4)] = id;
    any_fg |= id > 0;
  }
  for (int i = threadIdx.x; i < kTileW + 4; i += blockDim.x) xs[i] = f.x(c0 - 2 + i);
  for (int i = threadIdx.x; i < kTileH + 4; i += blockDim.x) ys[i] = f.y(r0 - 2 + i);
  if (threadIdx.x == 0) n_pairs = 0;
  any_fg = __syncthreads_or(any_fg);

  // list the region's silhouette pairs (none without foreground); the
  // list's order does not matter, each pair has its own place
  for (int k = threadIdx.x; any_fg && k < kHPairs + kVPairs; k += blockDim.x) {
    int i, j, ya, xa, yb, xb;
    pair_at(k, i, j, ya, xa, yb, xb);
    if (silhouette(f, r0 - 2 + ya, c0 - 2 + xa, r0 - 2 + yb, c0 - 2 + xb,
                   tile_ids[ya][xa], tile_ids[yb][xb]))
      pairs[atomicAdd(&n_pairs, 1)] = (unsigned short)k;
  }
  if (any_fg) __syncthreads();  // the same for the whole block
  const TileXY xy{xs, ys, c0 - 1, r0 - 1};  // xs[0] is column c0 - 2
  const int np = n_pairs;
  if (np > 0) {  // the same for the whole block
    for (int k = threadIdx.x; k < np; k += blockDim.x) {
      int i, j, ya, xa, yb, xb;
      const bool vertical = pair_at(pairs[k], i, j, ya, xa, yb, xb);
      const int id_a = tile_ids[ya][xa], id_b = tile_ids[yb][xb];
      const Pair pr = search_pair(f, xy, r0 - 2 + ya, c0 - 2 + xa, r0 - 2 + yb,
                                  c0 - 2 + xb, !vertical, id_a > 0, id_a, id_b);
      const float2 d = make_float2(pr.delta_a, pr.delta_b);
      const float4 bw = make_float4(pr.lam, pr.cross, pr.denom, __int_as_float(pr.m));
      if (vertical) {
        dv[i][j] = d;
        bv[i][j] = bw;
      } else {
        dh[i][j] = d;
        bh[i][j] = bw;
      }
    }
    __syncthreads();
    // g = dm * sum_c sgn(aa - seg_c) where a silhouette pair reads it
    for (int k = threadIdx.x; k < kRegH * kRegW; k += blockDim.x) {
      const int yy = k / kRegW, xx = k % kRegW;
      const int rr = r0 - 1 + yy, cc = c0 - 1 + xx;
      const int id = tile_ids[yy + 1][xx + 1];
      const bool ha = silhouette(f, rr, cc, rr, cc + 1, id, tile_ids[yy + 1][xx + 2]);
      const bool hb = silhouette(f, rr, cc - 1, rr, cc, tile_ids[yy + 1][xx], id);
      const bool va = silhouette(f, rr, cc, rr + 1, cc, id, tile_ids[yy + 2][xx + 1]);
      const bool vb = silhouette(f, rr - 1, cc, rr, cc, tile_ids[yy][xx + 1], id);
      if (!(ha || hb || va || vb)) continue;
      // antialiased foreground mask: color + ((h_a + h_b) + v_a) + v_b
      const float delta = __fadd_rn(
          __fadd_rn(__fadd_rn(ha ? dh[yy][xx + 1].x : 0.0f, hb ? dh[yy][xx].y : 0.0f),
                    va ? dv[yy + 1][xx].x : 0.0f),
          vb ? dv[yy][xx].y : 0.0f);
      const float aa = __fadd_rn(id > 0 ? 1.0f : 0.0f, delta);
      const size_t p = (size_t)rr * wc + cc;
      float s = 0.0f;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        s = __fadd_rn(s, sgn_jax(__fsub_rn(aa, f.gt6[ch * f.plane + p])));
      gs[yy][xx] = __fmul_rn(d_sums[b * 3 + 0], s);
    }
    __syncthreads();
  }

  const float dr = d_sums[b * 3 + 1];
  float out[kBwdPx][kOut];
#pragma unroll
  for (int e = 0; e < kBwdPx; ++e) {
    float d_edge[9];
#pragma unroll
    for (int k = 0; k < kOut; ++k) out[e][k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) d_edge[k] = 0.0f;
    if (!real[e]) continue;
    const int px = c + e;
    const size_t p = (size_t)r * wc + px;
    const int yy = ty + 1, xx = kBwdPx * tx + e + 1;  // in the region
    const int id = tile_ids[yy + 1][xx + 1];
    const bool fg = id > 0;
    if constexpr (kColors) {
      // d|col_c - rgb_c| * seg_c: the cotangent of the colour planes
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float dc = valid[e] ? __fmul_rn(__fmul_rn(dr, seg[e][ch]),
                                              sgn_jax(__fsub_rn(col[e][ch], rgb[e][ch])))
                                  : 0.0f;
        d_colors[((size_t)b * 3 + ch) * f.plane + p] = dc;
      }
    }
    if constexpr (L::kRead > 0) {
      Shade<kN> sh;  // read only at a real foreground pixel
      if (fg && valid[e]) sh = shade_at<L::kFirst, kN>(f, xy, r, px, true);
      float h[kN];  // the cotangent of each attribute channel read
      if constexpr (kDepth) {
        // d|attr_z + dplane| * seg0: the same cotangent reaches dplane and,
        // on a foreground pixel, attr_z
        float dz = 0.0f;
        if (valid[e]) {
          const float attr_z = fg ? sh.attr[L::kZ] : 0.0f;
          const float v = __fadd_rn(attr_z, dpl[e]);
          dz = __fmul_rn(__fmul_rn(d_sums[b * 3 + 2], seg[e][0]), sgn_jax(v));
        }
        d_dplane[(size_t)b * f.plane + p] = dz;
        h[L::kZ] = dz;
      }
      if (fg && valid[e]) {
        const float x = xy.x(px), y = xy.y(r);
        if constexpr (!kColors) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float sg = f.gt6[ch * f.plane + p], rg = f.gt6[(3 + ch) * f.plane + p];
            h[ch] = __fmul_rn(__fmul_rn(dr, sg), sgn_jax(__fsub_rn(sh.attr[ch], rg)));
          }
        }
        // attr = num / s: d num = h / s, d s = -h * ((num / s) / s) — the
        // division's derivative in the plain version's (autograd's)
        // rounding; the terms can cancel, so their order matters too:
        // autograd adds the channels' d s last channel first
        float ds = 0.0f;
#pragma unroll
        for (int ch = kN - 1; ch >= 0; --ch) {
          const float dn = __fdiv_rn(h[ch], sh.s_safe);
          const float ds_c = __fmul_rn(-h[ch], __fdiv_rn(sh.attr[ch], sh.s_safe));
          ds = ch == kN - 1 ? ds_c : __fadd_rn(ds, ds_c);
          out[e][9 + 3 * ch + 0] = __fmul_rn(dn, x);
          out[e][9 + 3 * ch + 1] = __fmul_rn(dn, y);
          out[e][9 + 3 * ch + 2] = dn;
        }
        if (fabsf(sh.s) > kEps) {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            d_edge[3 * j + 0] = __fadd_rn(d_edge[3 * j + 0], __fmul_rn(ds, x));
            d_edge[3 * j + 1] = __fadd_rn(d_edge[3 * j + 1], __fmul_rn(ds, y));
            d_edge[3 * j + 2] = __fadd_rn(d_edge[3 * j + 2], ds);
          }
        }
      }
    }

    if (fg) {
      // the silhouette pairs holding this pixel, each with this pixel as its
      // foreground side: (self, right), (left, self), (self, below), (above,
      // self)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool horizontal = q < 2;
        const bool fg_is_a = (q % 2) == 0;
        bool sil;
        float4 bw;
        float g_a, g_b, along, along_next, across;
        if (q == 0) {
          sil = silhouette(f, r, px, r, px + 1, id, tile_ids[yy + 1][xx + 2]);
          bw = bh[yy][xx + 1];
          g_a = gs[yy][xx];
          g_b = gs[yy][xx + 1];
          along = xy.x(px);
          along_next = xy.x(px + 1);
          across = xy.y(r);
        } else if (q == 1) {
          sil = silhouette(f, r, px - 1, r, px, tile_ids[yy + 1][xx], id);
          bw = bh[yy][xx];
          g_a = gs[yy][xx - 1];
          g_b = gs[yy][xx];
          along = xy.x(px - 1);
          along_next = xy.x(px);
          across = xy.y(r);
        } else if (q == 2) {
          sil = silhouette(f, r, px, r + 1, px, id, tile_ids[yy + 2][xx + 1]);
          bw = bv[yy + 1][xx];
          g_a = gs[yy][xx];
          g_b = gs[yy + 1][xx];
          along = xy.y(r);
          along_next = xy.y(r + 1);
          across = xy.x(px);
        } else {
          sil = silhouette(f, r - 1, px, r, px, tile_ids[yy][xx + 1], id);
          bw = bv[yy][xx];
          g_a = gs[yy - 1][xx];
          g_b = gs[yy][xx];
          along = xy.y(r - 1);
          along_next = xy.y(r);
          across = xy.x(px);
        }
        if (!sil) continue;
        const int m = __float_as_int(bw.w);
        if (m < 0) continue;  // no valid crossing: the pair is gated off
        const float lam = bw.x, cross = bw.y, denom = bw.z;
        const float seg_len = __fsub_rn(along_next, along);
        const float lam_c = fminf(fmaxf(lam, 0.0f), 1.0f);
        const float mu = fg_is_a ? __fsub_rn(lam_c, 0.5f) : __fsub_rn(0.5f, lam_c);
        const float diff = 1.0f;  // c_fg - c_bg on a silhouette pair
        const float g_fg = fg_is_a ? g_a : g_b;
        const float g_bg = fg_is_a ? g_b : g_a;
        // delta_bg = max(mu, 0) * diff, delta_fg = -max(-mu, 0) * diff
        const float m_bg = mu > 0.0f ? 1.0f : (mu == 0.0f ? 0.5f : 0.0f);
        const float m_fg = mu < 0.0f ? 1.0f : (mu == 0.0f ? 0.5f : 0.0f);
        const float dmu =
            __fmul_rn(__fadd_rn(__fmul_rn(g_bg, m_bg), __fmul_rn(g_fg, m_fg)), diff);
        const float d_lam_c = fg_is_a ? dmu : -dmu;
        // clip(lam, 0, 1) = minimum(1, maximum(0, lam))
        const float lo = fmaxf(lam, 0.0f);
        const float c_lo = lam > 0.0f ? 1.0f : (lam == 0.0f ? 0.5f : 0.0f);
        const float c_hi = lo < 1.0f ? 1.0f : (lo == 1.0f ? 0.5f : 0.0f);
        const float d_lam = __fmul_rn(__fmul_rn(d_lam_c, c_lo), c_hi);
        // lam = (cross - along) / seg, cross = num / denom,
        // num = -(coef * across + c_m); d denom = -d_cross * (cross / denom)
        const float d_cross = __fdiv_rn(d_lam, seg_len);
        const float d_num = __fdiv_rn(d_cross, denom);
        const float d_den = __fmul_rn(-d_cross, __fdiv_rn(cross, denom));
        const int k_den = horizontal ? 3 * m : 3 * m + 1;
        const int k_num = horizontal ? 3 * m + 1 : 3 * m;
        add_lane(d_edge, k_den, d_den);
        add_lane(d_edge, k_num, __fmul_rn(-d_num, across));
        add_lane(d_edge, 3 * m + 2, -d_num);
      }
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) out[e][k] = d_edge[k];
  }

  // lanes 16 + 3 kFirst on carry the channels read; every other lane is 0
  if (real[0]) {
    constexpr int kLo = 16 + 3 * L::kFirst, kHi = kLo + 3 * L::kRead;
    TOut* o = d_rows + (size_t)b * kLanes * f.plane + (size_t)r * wc + c;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      float v0 = 0.0f, v1 = 0.0f;
      if (k < 9) {
        v0 = out[0][k];
        v1 = out[1][k];
      } else if (k >= kLo && k < kHi) {
        v0 = out[0][9 + k - kLo];
        v1 = out[1][9 + k - kLo];
      }
      store2(o + k * f.plane, v0, v1, pair_stores, real[1]);
    }
  }
}

template <bool kDepth, bool kColors>
int loss_fwd_launch(const float* rows, const int* ids, const float* gt6,
                    const float* dplane, const float* colors, int B, int hc,
                    int wc, int oy, int ox, int fh, int fw, float* partials,
                    float* sums, cudaStream_t st) {
  constexpr int kSums = kDepth ? 3 : 2;
  const int ntiles = ((hc + kTileH - 1) / kTileH) * ((wc + kTileW - 1) / kTileW);
  loss_fwd_kernel<kDepth, kColors><<<dim3(ntiles, B), kTileH * kTileW / kPx, 0, st>>>(
      rows, ids, gt6, dplane, colors, hc, wc, oy, ox, fh, fw, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  loss_reduce_kernel<kSums><<<B, kBlock, 0, st>>>(partials, ntiles, sums);
  return (int)cudaGetLastError();
}

template <bool kDepth, bool kColors, typename TOut = float>
int loss_bwd_launch(const float* rows, const int* ids, const float* gt6,
                    const float* dplane, const float* colors,
                    const float* d_sums, int B, int hc, int wc, int oy, int ox,
                    int fh, int fw, TOut* d_rows, float* d_dplane,
                    float* d_colors, cudaStream_t st) {
  const int ntiles = ((hc + kTileH - 1) / kTileH) * ((wc + kTileW - 1) / kTileW);
  const bool pair_stores =
      wc % 2 == 0 && reinterpret_cast<uintptr_t>(d_rows) % (2 * sizeof(TOut)) == 0;
  loss_bwd_kernel<kDepth, kColors, TOut>
      <<<dim3(ntiles, B), kTileH * kTileW / kBwdPx, 0, st>>>(
          rows, ids, gt6, dplane, colors, d_sums, hc, wc, oy, ox, fh, fw, pair_stores,
          d_rows, d_dplane, d_colors);
  return (int)cudaGetLastError();
}

}  // namespace

// dplane (B, hc, wc) may be null: depth sum 0; colors (B, 3, hc, wc) may be
// null: the rgb term reads the rows' colour channels
extern "C" int dd_loss_fwd(const float* rows, const int* ids, const float* gt6,
                           const float* dplane, const float* colors, int B,
                           int hc, int wc, int oy, int ox, int fh, int fw,
                           float* partials, float* sums, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dplane && colors)
    return loss_fwd_launch<true, true>(rows, ids, gt6, dplane, colors, B, hc, wc,
                                       oy, ox, fh, fw, partials, sums, st);
  if (dplane)
    return loss_fwd_launch<true, false>(rows, ids, gt6, dplane, nullptr, B, hc,
                                        wc, oy, ox, fh, fw, partials, sums, st);
  if (colors)
    return loss_fwd_launch<false, true>(rows, ids, gt6, nullptr, colors, B, hc,
                                        wc, oy, ox, fh, fw, partials, sums, st);
  return loss_fwd_launch<false, false>(rows, ids, gt6, nullptr, nullptr, B, hc,
                                       wc, oy, ox, fh, fw, partials, sums, st);
}

// dplane and d_dplane (B, hc, wc) both null or both set; so colors and
// d_colors (B, 3, hc, wc).  g is not read and may be null: the g buffer of
// the earlier two-launch K6, kept in the interface so that
// tools/port_kernel_ab.py runs trees before and after on one set of
// arguments.
extern "C" int dd_loss_bwd(const float* rows, const int* ids, const float* gt6,
                           const float* dplane, const float* colors,
                           const float* d_sums, int B, int hc, int wc, int oy,
                           int ox, int fh, int fw, float* g, float* d_rows,
                           float* d_dplane, float* d_colors, void* stream) {
  if ((dplane == nullptr) != (d_dplane == nullptr) ||
      (colors == nullptr) != (d_colors == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dplane && colors)
    return loss_bwd_launch<true, true>(rows, ids, gt6, dplane, colors, d_sums, B,
                                       hc, wc, oy, ox, fh, fw, d_rows,
                                       d_dplane, d_colors, st);
  if (dplane)
    return loss_bwd_launch<true, false>(rows, ids, gt6, dplane, nullptr, d_sums,
                                        B, hc, wc, oy, ox, fh, fw, d_rows,
                                        d_dplane, nullptr, st);
  if (colors)
    return loss_bwd_launch<false, true>(rows, ids, gt6, nullptr, colors, d_sums,
                                        B, hc, wc, oy, ox, fh, fw, d_rows,
                                        nullptr, d_colors, st);
  return loss_bwd_launch<false, false>(rows, ids, gt6, nullptr, nullptr, d_sums,
                                       B, hc, wc, oy, ox, fh, fw, d_rows,
                                       nullptr, nullptr, st);
}

// K6 on the spanning op's rgb + mask lane with bf16 d_rows (the reference's
// default, DD_DROWS_BF16=1: fused_loss.py:552, raster_loss_compact's
// d_rows_bf16): the f32 launch's values, each rounded to nearest even; g
// unused, as in dd_loss_bwd
extern "C" int dd_loss_bwd_bf16(const float* rows, const int* ids,
                                const float* gt6, const float* d_sums, int B,
                                int hc, int wc, int oy, int ox, int fh, int fw,
                                float* g, __nv_bfloat16* d_rows, void* stream) {
  return loss_bwd_launch<false, false, __nv_bfloat16>(
      rows, ids, gt6, nullptr, nullptr, d_sums, B, hc, wc, oy, ox, fh, fw,
      d_rows, nullptr, nullptr, (cudaStream_t)stream);
}
