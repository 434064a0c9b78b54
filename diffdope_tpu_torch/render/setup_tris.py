"""Triangle setup and screen-tile binning for the nvdiffrast-style API ops
(plain torch, differentiable).

Counterpart of ``diffdope_tpu/render/setup_tris.py``.  Homogeneous
rasterization (Olano & Greer): for a triangle with clip-space corners
p_k = (x_k, y_k, z_k, w_k) and a_k = (x_k, y_k, w_k),

    c_0 = a_1 x a_2,   c_1 = a_2 x a_0,   c_2 = a_0 x a_1

so that chat_k(X, Y) = c_k . (X, Y, 1) at NDC pixel position (X, Y) gives
unnormalized perspective-correct barycentrics, alpha_k = chat_k / sum_j
chat_j, and z/w = (sum_k z_k c_k) . (X, Y, 1) / det with det = a_0 . (a_1 x
a_2).  Coverage is "all chat_k of the sign of det" (both windings), and
det == 0 rejects degenerate triangles.

Every product and sum is written out in a fixed order, so the CPU and the
card compute the same bits; the K8 id search (``rasterize.raster_ids``)
reads a detached copy of the coefficients, and ``rasterize.rast_from_ids``
re-evaluates them with gradients intact.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from diffdope_tpu_torch.render.shade import ndc

# layout of a packed setup row (``setup_tris.py:34-41``):
#   [0:3]  c0 (coefficients of X, Y, 1)
#   [3:6]  c1
#   [6:9]  c2
#   [9:12] zc = z0*c0 + z1*c1 + z2*c2
#   [12]   det
#   [13:16] padding
SETUP_WIDTH = 16


class TriangleSetup(NamedTuple):
    """Per-triangle rasterization coefficients: coef (B, T, 16) float32."""

    coef: torch.Tensor

    @property
    def c0(self) -> torch.Tensor:
        return self.coef[..., 0:3]

    @property
    def c1(self) -> torch.Tensor:
        return self.coef[..., 3:6]

    @property
    def c2(self) -> torch.Tensor:
        return self.coef[..., 6:9]

    @property
    def zc(self) -> torch.Tensor:
        return self.coef[..., 9:12]

    @property
    def det(self) -> torch.Tensor:
        return self.coef[..., 12]


def triangle_setup(pos_clip: torch.Tensor, tri: torch.Tensor) -> TriangleSetup:
    """Packed coefficients (B, T, 16) from (B, N, 4) clip positions and
    (T, 3) triangle indices; triangles with a repeated index are
    degenerate (``setup_tris.py:73-95``).  The corners' gather sums each
    vertex's corners in a fixed order in its backward
    (``rasterize.IndexRows``)."""
    from diffdope_tpu_torch.render.rasterize import gather_rows

    tri = tri.long()
    degenerate = (
        (tri[..., 0] == tri[..., 1])
        | (tri[..., 1] == tri[..., 2])
        | (tri[..., 2] == tri[..., 0])
    )
    corners = gather_rows(pos_clip, tri.reshape(-1)).reshape(
        pos_clip.shape[:1] + tri.shape + pos_clip.shape[2:])
    return triangle_setup_from_corners(corners, degenerate)


def _cross(a, b):
    """a x b for lists of three (..., ) tensors, jnp.cross's order."""
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def triangle_setup_from_corners(
    corners: torch.Tensor, degenerate: Optional[torch.Tensor] = None
) -> TriangleSetup:
    """Packed coefficients from corner-expanded clip positions (B, T, 3, 4)
    (``setup_tris.py:98-144``).  ``degenerate`` (T,) or (B, T) marks
    triangles whose rows are zeroed exactly; by default those with two
    bit-identical corners (the zero-index padding rows among them)."""
    v = corners
    a = [[v[..., k, i] for i in (0, 1, 3)] for k in range(3)]  # (x, y, w)
    z = [v[..., k, 2] for k in range(3)]
    c0 = _cross(a[1], a[2])
    c1 = _cross(a[2], a[0])
    c2 = _cross(a[0], a[1])
    det = (c0[0] * a[0][0] + c0[1] * a[0][1]) + c0[2] * a[0][2]
    zc = [(z[0] * c0[i] + z[1] * c1[i]) + z[2] * c2[i] for i in range(3)]

    if degenerate is None:
        same = [torch.all(v[..., i, :] == v[..., j, :], dim=-1)
                for i, j in ((0, 1), (1, 2), (2, 0))]
        degenerate = same[0] | same[1] | same[2]
    keepf = (~degenerate).to(det.dtype).expand(det.shape)
    lanes = [x * keepf for x in c0 + c1 + c2 + zc]
    det = torch.where(keepf > 0, det, torch.zeros_like(det))
    pad = torch.zeros_like(det)
    coef = torch.stack(lanes + [det, pad, pad, pad], dim=-1)
    return TriangleSetup(coef=coef)


def pixel_ndc(resolution: Tuple[int, int], dtype=torch.float32,
              device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """NDC of pixel centres as (H, W) grids of ``dtype``
    (``setup_tris.py:147-160``): X = (2j+1)/W - 1, Y = (2i+1)/H - 1 with
    an IEEE divide (:func:`shade.ndc`).  Row 0 is the NDC bottom."""
    h, w = resolution
    x = ndc(torch.arange(w, device=device), w, dtype)
    y = ndc(torch.arange(h, device=device), h, dtype)
    return x[None, :].expand(h, w), y[:, None].expand(h, w)


def _tensor(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=like.dtype, device=like.device)


@torch.no_grad()
def bin_triangles(
    corners: torch.Tensor,
    det: torch.Tensor,
    resolution: Tuple[int, int],
    tile_hw: Tuple[int, int],
    max_tris_per_tile: int,
    margin_px: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Conservative screen-tile binning shared across the hypothesis batch
    (``setup_tris.py:163-262``): each triangle goes to every tile its
    bounding box, united over the hypotheses and grown by ``margin_px``,
    touches; a triangle with a corner behind the camera (w <= 1e-9) goes to
    every tile; one with det == 0 in every hypothesis to none.  No culling.

    Args:
        corners: (B, T, 3, 4) corner-expanded clip positions.
        det: (B, T) or (T,) determinants (0 = degenerate).
        resolution: (H, W).  tile_hw: (th, tw) pixels per tile.
        max_tris_per_tile: K; a tile keeps its K smallest triangle indices.

    Returns:
        idx (num_tiles, K') int32: each tile's triangle indices in
            ascending order (row-major tiles), padded with the sentinel T;
            K' is min(K, T) rounded up to a multiple of 128.
        counts (num_tiles,) int32: valid entries per tile.
        overflow () int32: (tile, triangle) pairs dropped by K.
    """
    h, w = resolution
    th, tw = tile_hw
    nty = -(-h // th)
    ntx = -(-w // tw)
    t_count = corners.shape[1]
    dev = corners.device

    x, y, wc = corners[..., 0], corners[..., 1], corners[..., 3]
    eps = 1e-9
    safe_w = torch.where(wc.abs() > eps, wc, _tensor(eps, wc))
    sx = x / safe_w  # (B, T, 3) NDC
    sy = y / safe_w

    behind = (wc <= eps).any(dim=-1)  # (B, T)
    if det.dim() == 2:
        valid = (det != 0.0).any(dim=0)
        behind = behind.any(dim=0)
    else:
        valid = det != 0.0

    # pixel-space bbox, union over the batch; the divisors are tensors
    # (torch divides a CUDA tensor by a Python scalar as a reciprocal
    # multiply)
    px = (sx + 1.0) * (w / 2.0) - 0.5
    py = (sy + 1.0) * (h / 2.0) - 0.5
    px_min = px.amin(dim=-1).amin(dim=0) - margin_px  # (T,)
    px_max = px.amax(dim=-1).amax(dim=0) + margin_px
    py_min = py.amin(dim=-1).amin(dim=0) - margin_px
    py_max = py.amax(dim=-1).amax(dim=0) + margin_px

    def tile_of(p, size, n):
        return torch.floor(p / _tensor(size, p)).clamp(0, n - 1).to(torch.int32)

    tx_min, tx_max = tile_of(px_min, tw, ntx), tile_of(px_max, tw, ntx)
    ty_min, ty_max = tile_of(py_min, th, nty), tile_of(py_max, th, nty)

    onscreen = (px_max >= 0) & (px_min <= w - 1) & (py_max >= 0) & (py_min <= h - 1)
    zero = torch.zeros_like(tx_min)
    tx_min = torch.where(behind, zero, tx_min)
    tx_max = torch.where(behind, zero + (ntx - 1), tx_max)
    ty_min = torch.where(behind, zero, ty_min)
    ty_max = torch.where(behind, zero + (nty - 1), ty_max)
    keep = valid & (onscreen | behind)

    num_tiles = nty * ntx
    tiles_y = torch.arange(nty, dtype=torch.int32, device=dev)
    tiles_x = torch.arange(ntx, dtype=torch.int32, device=dev)
    oy = (tiles_y[:, None] >= ty_min[None, :]) & (tiles_y[:, None] <= ty_max[None, :])
    ox = (tiles_x[:, None] >= tx_min[None, :]) & (tiles_x[:, None] <= tx_max[None, :])
    mask = (oy[:, None, :] & ox[None, :, :] & keep[None, None, :]).reshape(num_tiles, t_count)

    # first-K compaction by ascending triangle index: the K largest of the
    # negated indices, sorted, are the K smallest in ascending order
    vals = torch.where(mask, torch.arange(t_count, dtype=torch.int32, device=dev)[None, :],
                       t_count)
    k = min(max_tris_per_tile, t_count)
    idx = -torch.topk(-vals, k, dim=-1, sorted=True).values
    counts_full = mask.sum(dim=-1, dtype=torch.int32)
    counts = counts_full.clamp(max=k)
    overflow = (counts_full - k).clamp(min=0).sum(dtype=torch.int32)
    k_pad = -(-k // 128) * 128
    if k_pad != k:
        idx = torch.nn.functional.pad(idx, (0, k_pad - k), value=t_count)
    return idx.to(torch.int32).contiguous(), counts.contiguous(), overflow
