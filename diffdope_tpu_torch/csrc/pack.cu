// Bin-ordered pack forward (K1) and its pose backward (K2) for Hopper
// (sm_90a).
//
// K1 replaces diffdope_tpu/render/pack_kernel.py:_fwd_pack_kernel (driven by
// _run_fwd / pack_binned_pallas).  K2 replaces pack_kernel.py:
// _bwd_pack_kernel (driven by _run_bwd).  The plain torch version that both
// are held to is diffdope_tpu_torch/render/planar.py:pack_binned and its
// autograd; the wrappers are in diffdope_tpu_torch/render/pack_kernel.py.
//
// Inputs, per hypothesis b: mvpm[b] = 20 floats (the 4x4 mvp row-major, then
// row 2 of the pose mtx, then a pad); per slot s the static table column
// tab[:, s] (R = 9 + 3*n_ch + 2 rows: the 9 object-space corner coordinates,
// row 3k+c; the 3*n_ch corner attributes, row 9 + k*n_ch + c; the slot's
// unclamped triangle id; its degenerate flag) and the silhouette bits
// sil[b, s].
//
// K1: one thread per (hypothesis, slot); the 20 scalars of the block's
// hypothesis sit in shared memory.  The thread writes the slot's 32 lanes;
// neighbouring threads write neighbouring slots, so every lane store is
// coalesced.  Bound on this card: the table write, 128 bytes per (b, slot)
// (memory bound; ~250 FP32 operations per 132 bytes moved).
//
// K2: the TPU kernel accumulates the 19 sums (d_mvp 16, d_mtx row 2) over a
// sequential grid in VMEM; blocks here run in no order, so each block takes
// one (chunk of 2048 places, hypothesis) pair, reduces its slots to 19
// partial sums in a fixed-order tree (warp shuffles, then warps in order),
// and a second launch adds the partials of each hypothesis in chunk order.
// No atomics: the result is deterministic.  The adjoint is the reference's,
// written out (pack_kernel.py:225-308).  Bound: the d_packed read of the
// 16 + 3*n_ch lanes that carry a gradient, 100 bytes per (b, slot) at
// n_ch = 3, at the slots whose degenerate flag is clear.  What the design
// does about it:
// - The sums run over places, not table positions: the compact layout of
//   the table's bins, each tile's slots in rank order from a whole
//   128-slot chunk (pack_kernel.slot_order, built once a table on the
//   device).  The uniform-K table pads every tile to K slots, the compact
//   table to whole chunks; both hold the same slots per tile in the same
//   order, and summed by position each put its live slots at other places
//   of the tree: the two layouts gave gradients apart in the last bit,
//   which a refinement at the default loss scales amplifies into other
//   poses.  Summed by place they give the same gradients bit for bit, and
//   the compact table keeps the sums (and the trajectories) it had: the
//   default configuration's runs are chaotic in K2's rounding, and a sum
//   over live indices (in f32, or in f64 rounded once) moved them so that
//   other phases' criteria failed (PERF.md §6).  A uniform tile's padding
//   past its chunks is never visited: blocks past the places exit.  The
//   compact table's places are its positions, so it needs no order and
//   K2 walks it as before; the uniform table's next place's slot is
//   loaded before this slot's body (with an order for both, K2 took
//   0.1153 against 0.1102 ms on the compact table at the bench shapes;
//   H100 SXM at 700 W, tools/port_kernel_ab.py).
// - The slot body is instantiated per n_ch and fully unrolled, so a
//   thread's 25 cotangent loads and 19 table loads of a slot go out
//   together; a loop over a run-time n_ch, a load and a dependent add an
//   iteration, had chained ~9 L2 round trips per slot.
// - A degenerate slot (mesh padding, a sentinel) has keep = 0, so each of
//   its terms is +-0 for any finite cotangent, and adding +-0 leaves a sum
//   that starts at +0 unchanged: the kernel skips such slots (by their
//   flag, or they have no place in the order), their cotangent reads and
//   their adjoint.
// - 2 blocks of 256 threads an SM: the unrolled slot body takes ~120
//   registers; capped at 85 (3 blocks) it spilled and ran 0.170 against
//   0.107 ms at the bench shapes.

// Numeric contract (build with -fmad=false, no fast math): K1 evaluates every
// expression in planar.pack_binned's order, each product and sum rounded
// (m0*p0 + m1*p1 + m2*p2 + m3, left to right; the rotated z adds the zero
// translation as the plain version does), so the table equals the plain
// pack bit for bit: a 1-ulp difference flips z-test winners on silhouette
// pixels.

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMvpm = 20;
constexpr int kOut = 19;         // d_mvp (16, row-major) + d_mtx row 2 (3)
constexpr int kThreads = 256;
constexpr int kChunk = 2048;        // slots per K2 block
constexpr int kBwdBlocksPerSm = 2;  // 128 registers a thread at most: no spill
constexpr float kEpsW = 1e-9f;   // planar._axis_bounds_ndc eps
constexpr float kOpen = 4.0f;    // planar._Y_OPEN

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// ((a0*b0 + a1*b1) + a2*b2), each product and sum rounded
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
}

// torch.minimum / torch.maximum on the card: NaN propagates, else ::min/max
__device__ __forceinline__ float tmin(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// The slot's corner clip coordinates x/y/z/w[k] and rotated z zr[k] under the
// hypothesis' matrices M (planar.pack_binned's transform).
struct Corners {
  float p[3][3];
  float x[3], y[3], z[3], w[3], zr[3];

  __device__ void load(const float* tab, int n, int s) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int c = 0; c < 3; ++c) p[k][c] = tab[(size_t)(3 * k + c) * n + s];
  }

  __device__ void transform(const float* M) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x[k] = add(dot3(M[0], p[k][0], M[1], p[k][1], M[2], p[k][2]), M[3]);
      y[k] = add(dot3(M[4], p[k][0], M[5], p[k][1], M[6], p[k][2]), M[7]);
      z[k] = add(dot3(M[8], p[k][0], M[9], p[k][1], M[10], p[k][2]), M[11]);
      w[k] = add(dot3(M[12], p[k][0], M[13], p[k][1], M[14], p[k][2]), M[15]);
      zr[k] = add(dot3(M[16], p[k][0], M[17], p[k][1], M[18], p[k][2]), 0.0f);
    }
  }

  // raw cross plane m of the corner pair (j, k): (y_j w_k - w_j y_k,
  // w_j x_k - x_j w_k, x_j y_k - y_j x_k)
  __device__ void cross(int j, int k, float out[3]) const {
    out[0] = sub(mul(y[j], w[k]), mul(w[j], y[k]));
    out[1] = sub(mul(w[j], x[k]), mul(x[j], w[k]));
    out[2] = sub(mul(x[j], y[k]), mul(y[j], x[k]));
  }
};

// conservative NDC interval of one axis (planar._axis_bounds_ndc)
__device__ __forceinline__ void bounds(const float v[3], const float w[3],
                                       bool degen, float* lo, float* hi) {
  float vn[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    vn[k] = __fdiv_rn(v[k], fabsf(w[k]) > kEpsW ? w[k] : kEpsW);
  const bool bc = (w[0] <= kEpsW) | (w[1] <= kEpsW) | (w[2] <= kEpsW);
  float l = tmin(tmin(vn[0], vn[1]), vn[2]);
  float h = tmax(tmax(vn[0], vn[1]), vn[2]);
  l = bc ? -kOpen : l;
  h = bc ? kOpen : h;
  *lo = degen ? kOpen : l;
  *hi = degen ? -kOpen : h;
}

__global__ void pack_fwd_kernel(const float* __restrict__ mvpm,
                                const float* __restrict__ tab,
                                const float* __restrict__ sil, int n, int n_ch,
                                float* __restrict__ out) {
  __shared__ float M[kMvpm];
  const int b = blockIdx.y;
  if (threadIdx.x < kMvpm) M[threadIdx.x] = mvpm[b * kMvpm + threadIdx.x];
  __syncthreads();
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= n) return;

  Corners cr;
  cr.load(tab, n, s);
  cr.transform(M);
  const float tri_f = tab[(size_t)(9 + 3 * n_ch) * n + s];
  const float degen = tab[(size_t)(10 + 3 * n_ch) * n + s];
  const float keep = degen > 0.5f ? 0.0f : 1.0f;

  float c[3][3];
  cr.cross(1, 2, c[0]);
  cr.cross(2, 0, c[1]);
  cr.cross(0, 1, c[2]);
  const float det =
      mul(dot3(c[0][0], cr.x[0], c[0][1], cr.y[0], c[0][2], cr.w[0]), keep);
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int i = 0; i < 3; ++i) c[m][i] = mul(c[m][i], keep);

  float* o = out + (size_t)b * kLanes * n + s;
  auto put = [&](int lane, float v) { o[(size_t)lane * n] = v; };
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int i = 0; i < 3; ++i) put(3 * m + i, c[m][i]);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    put(9 + i, dot3(cr.z[0], c[0][i], cr.z[1], c[1][i], cr.z[2], c[2][i]));
  put(12, det);
  put(13, tri_f);
  put(14, sil[(size_t)b * n + s]);
  put(15, 0.0f);
  int lane = 16;
  for (int ch = 0; ch < n_ch; ++ch) {
    float a[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) a[k] = tab[(size_t)(9 + k * n_ch + ch) * n + s];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      put(lane++, dot3(a[0], c[0][i], a[1], c[1][i], a[2], c[2][i]));
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    put(lane++, dot3(cr.zr[0], c[0][i], cr.zr[1], c[1][i], cr.zr[2], c[2][i]));
  for (; lane < kLanes - 4; ++lane) put(lane, 0.0f);
  const bool dg = degen > 0.5f;
  float lo, hi;
  bounds(cr.x, cr.w, dg, &lo, &hi);
  put(28, lo);
  put(29, hi);
  bounds(cr.y, cr.w, dg, &lo, &hi);
  put(30, lo);
  put(31, hi);
}

// One live slot's 19 contributions to d_mvp / d_mtx row 2 (pack_kernel.py:
// _bwd_pack_kernel, per column), added into acc.  The slot's degenerate
// flag is clear, so its keep factor is 1 and every product with it is
// dropped (exactly: x * 1 = x); the arithmetic is otherwise the
// reference's adjoint in its order.
template <int kNCh>
__device__ __forceinline__ void pack_bwd_slot(const float* M, const float* tab,
                                              const float* gb, int n, int s,
                                              float acc[kOut]) {
  Corners cr;
  cr.load(tab, n, s);
  cr.transform(M);
  auto g = [&](int lane) { return gb[(size_t)lane * n + s]; };
  auto attr = [&](int k, int ch) { return tab[(size_t)(9 + k * kNCh + ch) * n + s]; };

  float cm[3][3];
  cr.cross(1, 2, cm[0]);
  cr.cross(2, 0, cm[1]);
  cr.cross(0, 1, cm[2]);

  constexpr int zr_base = 16 + 3 * kNCh;
  float g_zc[3], g_zr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g_zc[i] = g(9 + i);
    g_zr[i] = g(zr_base + i);
  }
  // adjoints of the cross planes: direct lanes, zc, attrs, zrot
  float dcr[3][3];
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float d = g(3 * m + i) + cr.z[m] * g_zc[i] + cr.zr[m] * g_zr[i];
#pragma unroll
      for (int ch = 0; ch < kNCh; ++ch) d = d + attr(m, ch) * g(16 + 3 * ch + i);
      dcr[m][i] = d;
    }
  float d_z[3], d_zr[3];
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    d_z[m] = cm[m][0] * g_zc[0] + cm[m][1] * g_zc[1] + cm[m][2] * g_zc[2];
    d_zr[m] = cm[m][0] * g_zr[0] + cm[m][1] * g_zr[1] + cm[m][2] * g_zr[2];
  }
  // det = c0 . (x0, y0, w0)
  const float g_det = g(12);
  float d_x[3] = {cm[0][0] * g_det, 0.0f, 0.0f};
  float d_y[3] = {cm[0][1] * g_det, 0.0f, 0.0f};
  float d_w[3] = {cm[0][2] * g_det, 0.0f, 0.0f};
  dcr[0][0] = dcr[0][0] + cr.x[0] * g_det;
  dcr[0][1] = dcr[0][1] + cr.y[0] * g_det;
  dcr[0][2] = dcr[0][2] + cr.w[0] * g_det;

#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int j = (m + 1) % 3, k = (m + 2) % 3;  // (1, 2), (2, 0), (0, 1)
    const float dX = dcr[m][0], dY = dcr[m][1], dZ = dcr[m][2];
    // cmX = y_j w_k - w_j y_k
    d_y[j] = d_y[j] + cr.w[k] * dX;
    d_w[k] = d_w[k] + cr.y[j] * dX;
    d_w[j] = d_w[j] - cr.y[k] * dX;
    d_y[k] = d_y[k] - cr.w[j] * dX;
    // cmY = w_j x_k - x_j w_k
    d_w[j] = d_w[j] + cr.x[k] * dY;
    d_x[k] = d_x[k] + cr.w[j] * dY;
    d_x[j] = d_x[j] - cr.w[k] * dY;
    d_w[k] = d_w[k] - cr.x[j] * dY;
    // cmZ = x_j y_k - y_j x_k
    d_x[j] = d_x[j] + cr.y[k] * dZ;
    d_y[k] = d_y[k] + cr.x[j] * dZ;
    d_y[j] = d_y[j] - cr.x[k] * dZ;
    d_x[k] = d_x[k] - cr.y[j] * dZ;
  }

  // d_M[r, c] = sum_k d_coord_r[k] * p[k][c]; d_M[r, 3] = sum_k d_coord_r[k]
  auto reduce_row = [&](int r, const float (&dk)[3]) {
#pragma unroll
    for (int c = 0; c < 3; ++c)
      acc[4 * r + c] += dk[0] * cr.p[0][c] + dk[1] * cr.p[1][c] + dk[2] * cr.p[2][c];
    acc[4 * r + 3] += dk[0] + dk[1] + dk[2];
  };
  reduce_row(0, d_x);
  reduce_row(1, d_y);
  reduce_row(2, d_z);
  reduce_row(3, d_w);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    acc[16 + c] +=
        d_zr[0] * cr.p[0][c] + d_zr[1] * cr.p[1][c] + d_zr[2] * cr.p[2][c];
}

// K2's partial sums at the compact layout's places: one block per (2048
// places, hypothesis), thread t adding the slots at places t, t + 256, ...
// of its block in order, then a fixed-order tree (warp shuffles, then the
// warps in order).  On the compact table (kByPlace false) the places are
// the table's positions, and a slot is skipped where its degenerate flag
// is set (a sentinel, mesh padding: its terms are all +-0).  On the
// uniform-K table (kByPlace true) order[v] is the table position summed at
// place v, -1 for none (pack_kernel.slot_order: each tile's slots where
// the compact table of the same bins holds them), and order[n] the number
// of places; blocks past it exit (no host read: the launch is captured in
// a CUDA graph), and the next place's slot is loaded before this slot's
// body.  So the two tables give the same sums bit for bit, and the
// compact table the sums it had when K2 summed every table by position.
template <int kNCh, bool kByPlace>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
    pack_bwd_partial_kernel(const float* __restrict__ mvpm,
                            const float* __restrict__ tab,
                            const float* __restrict__ g,
                            const int* __restrict__ order, int n,
                            float* __restrict__ partial) {
  __shared__ float M[kMvpm];
  __shared__ float warp_sums[kThreads / 32][kOut];
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int n_places = kByPlace ? order[n] : n;
  if (chunk * kChunk >= n_places) return;  // the same for the whole block
  if (threadIdx.x < kMvpm) M[threadIdx.x] = mvpm[b * kMvpm + threadIdx.x];
  __syncthreads();

  float acc[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) acc[o] = 0.0f;
  const float* gb = g + (size_t)b * kLanes * n;
  const int end = min(n_places, (chunk + 1) * kChunk);
  if (kByPlace) {
    int i = chunk * kChunk + threadIdx.x;
    int s = i < end ? order[i] : -1;
    for (; i < end; i += blockDim.x) {
      const int j = i + blockDim.x;
      const int s_next = j < end ? order[j] : -1;
      if (s >= 0) pack_bwd_slot<kNCh>(M, tab, gb, n, s, acc);
      s = s_next;
    }
  } else {
    const float* degen = tab + (size_t)(10 + 3 * kNCh) * n;
    for (int s = chunk * kChunk + threadIdx.x; s < end; s += blockDim.x)
      if (degen[s] <= 0.5f) pack_bwd_slot<kNCh>(M, tab, gb, n, s, acc);
  }

  // fixed-order tree: within each warp, then the warps in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    float v = acc[o];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][o] = v;
  }
  __syncthreads();
  if (threadIdx.x < kOut) {
    float v = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) v += warp_sums[w][threadIdx.x];
    partial[((size_t)b * gridDim.x + chunk) * kOut + threadIdx.x] = v;
  }
}

// out[b, o] = sum over the blocks that hold places of partial[b, chunk, o],
// in block order (n_chunks: the partials' row stride, the grid of the
// first launch; order null: every block)
__global__ void pack_bwd_reduce_kernel(const float* __restrict__ partial,
                                       const int* __restrict__ order, int n,
                                       int n_chunks, float* __restrict__ out) {
  const int b = blockIdx.x;
  const int o = threadIdx.x;
  if (o >= kOut) return;
  const int n_used = order ? (order[n] + kChunk - 1) / kChunk : n_chunks;
  float v = 0.0f;
  for (int c = 0; c < n_used; ++c) v += partial[((size_t)b * n_chunks + c) * kOut + o];
  out[b * kOut + o] = v;
}

template <int kNCh>
int pack_bwd_launch(const float* mvpm, const float* tab, const float* g,
                    const int* order, int B, int n, float* partial, float* out,
                    cudaStream_t st) {
  const int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > 0) {
    const dim3 grid(n_chunks, B);
    if (order)
      pack_bwd_partial_kernel<kNCh, true><<<grid, kThreads, 0, st>>>(mvpm, tab, g, order,
                                                                     n, partial);
    else
      pack_bwd_partial_kernel<kNCh, false><<<grid, kThreads, 0, st>>>(mvpm, tab, g, order,
                                                                      n, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pack_bwd_reduce_kernel<<<B, 32, 0, st>>>(partial, order, n, n_chunks, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int dd_pack_fwd(const float* mvpm, const float* tab,
                           const float* sil, int B, int n, int n_ch,
                           float* out, void* stream) {
  dim3 grid((n + kThreads - 1) / kThreads, B);
  pack_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(mvpm, tab, sil,
                                                               n, n_ch, out);
  return (int)cudaGetLastError();
}

// order: null for the compact table (its places are its positions), else
// (n + 1) int32, the table position summed at each place (-1 for none) and
// the number of places at [n]; partial: scratch of B * ceil(n / 2048) * 19
// floats; out: (B, 19)
extern "C" int dd_pack_bwd(const float* mvpm, const float* tab, const float* g,
                           const int* order, int B, int n, int n_ch, float* partial,
                           float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_ch) {
    case 0: return pack_bwd_launch<0>(mvpm, tab, g, order, B, n, partial, out, st);
    case 1: return pack_bwd_launch<1>(mvpm, tab, g, order, B, n, partial, out, st);
    case 2: return pack_bwd_launch<2>(mvpm, tab, g, order, B, n, partial, out, st);
    case 3: return pack_bwd_launch<3>(mvpm, tab, g, order, B, n, partial, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
