"""The port's render and fused refinement loss.

Counterpart of ``diffdope_tpu/render/pipeline.py``, restricted to its
Pallas configuration on the card: per-corner colour planes or an exact
per-pixel texture, the bin-ordered pack (``DD_PACK=pallas``, the
reference's default; here K1/K2, or the plain pack where the reference's
eligibility rule sends traced colours), and one of two bin tables.  ``compact_total`` (slots) selects the compact table, every
tile's slots in one chunk-aligned table; None selects the uniform-K table,
K slots for every tile, as in the reference.  The raster is K3/K4 over the
compact table and K7 over the uniform one (:func:`_raster`).

- :func:`make_fused_loss` (reference :383-858): rgb, depth and mask L1
  terms.  On the compact table the ROI crop with ``_crop_leak`` telemetry;
  rgb + mask there take the spanning raster+loss op (K1 -> K3 -> K5,
  backward K6 -> K4 -> K2, the d_rows between K6 and K4 in bf16 unless
  ``DD_DROWS_BF16=0``, read when the loss is built), and with depth the
  raster and the fused loss are chained (K1 -> K3 -> K5, backward K6 ->
  K4 -> K2, d_dplane to t_z by autograd).  The uniform table runs the full frame (K1 -> K7 -> K5,
  backward K6 -> K7 -> K2).  With a texture (``tex``, ``uv``, ``uv_idx``)
  the semi-fused exact-texture route (reference :770-822): the table holds
  the uv corners, no ROI crop, the raster and the colour lane of K5/K6
  chained around the plain uv shade and texture sampler
  (``render/texture.py``) on the gt segmentation's crop (``DD_TEX_CROP``).
  With ``gt=None`` the ground truth comes with each call, ``fn(mtx, gt)``,
  on the full frame (no crop needs it at build time).
- :func:`render_batch` (reference :79-380): on its pallas branch K1 -> K3
  or K7 with the plain shade and mask antialiasing, backward K4 or K7 ->
  K2; on its reference branch (``raster_impl`` 'reference', or 'auto' for
  at most 256 triangles) the brute-force id search and the same shade,
  plain torch throughout; the ``stacked`` and ``channels`` layouts,
  ``return_rast_out`` and ``antialias_rgb``; colours per corner or by
  sampling a texture at the interpolated uv (its 'texture' mode, :322-325).
- :func:`render_rgb_mask`, the gt render over a compact table sized to the
  bins exactly (``EXACT``), and :func:`compact_capacity`.

The reference's environment switches select its planar route on both
entry points, and the port's (:func:`raster_route`, read when a loss is
built and once per ``render_batch`` call): ``DD_RASTER=v3`` the sorted-
range raster K10 over the triangle-order table (``planar.pack_planar``,
plain torch: no K1/K2, no bins, no back-face cull); ``DD_BINNED=0`` K7
over that table gathered into the per-tile bins, the gather's backward
summing each triangle's slots in slot order (``raster.RasterV2``).  Then
the plain shade and antialiasing (render) or K5/K6 on the full frame
(fused loss).

Every bin-ordered pack goes through :func:`_pack_dispatch`, so the kernel
route and its eligibility rules cannot diverge between call sites.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from diffdope_tpu_torch import trace
from diffdope_tpu_torch.convert import tensor
from diffdope_tpu_torch.geometry import matmul44, xfm_points
from diffdope_tpu_torch.render.fused_loss import (
    DEPTH_LANE,
    MASK_LANE,
    RGB_LANE,
    fused_loss_sums,
    raster_loss_compact,
)
from diffdope_tpu_torch.render.gather_rows import bin_occupancy, invert_bins
from diffdope_tpu_torch.render.planar import (
    _silhouette_planar,
    _xbounds_ndc,
    _ybounds_ndc,
    bin_triangles_planar,
    compact_bins,
    corner_planes,
    det_planar,
    pack_planar,
    static_pack_rows,
)
from diffdope_tpu_torch.render.pack_kernel import pack_binned_auto, slot_order
from diffdope_tpu_torch.render.raster import (
    raster_compact,
    raster_gather_rows_binned,
    raster_gather_rows_v2,
)
from diffdope_tpu_torch.render.raster_v3 import raster_gather_rows_v3
from diffdope_tpu_torch.render.rasterize import (
    AUTO_REFERENCE_MAX_TRIS,
    gather_rows,
    raster_ids_reference,
)
from diffdope_tpu_torch.render.setup_tris import triangle_setup_from_corners
from diffdope_tpu_torch.render.shade import (
    antialias_rows,
    attribute_planes,
    pack_rows,
    pixel_ndc,
    shade_from_rows,
    shade_rows,
    silhouette_bits,
)
from diffdope_tpu_torch.render.texture import (
    pack_bilinear_blocks4,
    table_tensor,
    texture,
    texture_planar,
    texture_planar_packed4,
)

#: GPU raster tile (pixels): one thread per pixel, one block per tile
TILE_HW = (16, 16)
#: alignment of each tile's region in the compact table (slots)
K_CHUNK = 32
#: per-tile bin capacity before compaction (triangles); drops are counted
#: in '_bin_overflow'
MAX_TRIS_PER_TILE = 1024
#: compact capacity over a probe pose's need (the root bench's rule,
#: ``bench.py:207-235``)
CAPACITY_SLACK = 1.35
#: ROI crop margin around the gt support (px): covers the bench protocol's
#: drift (8 degrees, ~25 px) with no measured leak in the reference
CROP_MARGIN = 24
#: a table capacity: the compact table sized to the bins exactly (reads the
#: counts on the host), for the gt render and the capacity probe
EXACT = "exact"
#: the inverted bin map's width on the ``DD_BINNED=0`` route: every
#: occurrence of a triangle, as ``gather_rows.invert_bins``' 'auto' (the
#: reference's ``precompute_bins``, ``pipeline.py:926``), so no triangle
#: loses gradient; the reference's fixed 16 (``pipeline.py:99, 404``) was
#: set for its 32x128 tiles, and any fixed width may drop gradient, so
#: ``render_batch`` and ``make_fused_loss`` take no ``max_occ`` (the
#: reference's do).  The port's backward sums each triangle's slots in
#: slot order (``rasterize.slot_sums``), with no map whose width would hang
#: on the bins; '_bin_occupancy' reports the most occurrences
MAX_OCC = "auto"


def raster_route() -> Optional[str]:
    """The raster route the reference's environment switches select
    (``pipeline.py:218-223, 278, 617-621, 740``): None for the bin-ordered
    pack (the default), else the planar route, 'v3' under ``DD_RASTER=v3``
    and 'v2' under ``DD_BINNED=0``."""
    raster = os.environ.get("DD_RASTER", "v2")
    if os.environ.get("DD_BINNED", "1") == "1" and raster != "v3":
        return None
    return "v3" if raster == "v3" else "v2"


class _Mesh:
    """The per-mesh constants every entry point needs, as tensors: the
    projection, triangle indices, corner-expanded positions (3T, 3), the
    per-corner attributes (T, 3, n_ch) — colours (n_ch 3), or with a
    texture its uv (n_ch 2) — the texture (None for colours), the
    degenerate-triangle mask, the edge adjacency and the static pack
    table.  Colours may be tensors that carry a gradient (appearance
    refinement), and per hypothesis: vertex colours (B, N, 3), corner
    colours (B, T, 3, 3)."""

    def __init__(self, proj_cam, pos, pos_idx, edge_adj, vtx_color,
                 corner_colors, device, tex=None, uv=None, uv_idx=None):
        self.device = device
        self.proj = tensor(proj_cam, device).reshape(4, 4)
        self.tri = tensor(pos_idx, device, torch.int64)
        self.t_count = self.tri.shape[0]
        self.pos_c = tensor(pos, device)[self.tri.reshape(-1)]
        tri = self.tri
        self.degenerate = (
            (tri[:, 0] == tri[:, 1]) | (tri[:, 1] == tri[:, 2]) | (tri[:, 2] == tri[:, 0])
        )
        self.adj = None if edge_adj is None else tensor(edge_adj, device, torch.int64)
        self._set_colors(vtx_color, corner_colors, tex, uv, uv_idx)

    def _set_colors(self, vtx_color, corner_colors, tex, uv, uv_idx) -> None:
        """The attributes by the reference's priority (``pipeline.py:146-
        160``): corner colours, else the texture's uv, else vertex
        colours."""
        dev, t, flat = self.device, self.t_count, self.tri.reshape(-1)
        self.tex = None
        if corner_colors is not None:
            self.attrs = tensor(corner_colors, dev)
        elif tex is not None:
            if uv is None or uv_idx is None:
                raise ValueError("textured render requires uv and uv_idx")
            self.tex = tensor(tex, dev)
            uv_flat = tensor(uv_idx, dev, torch.int64).reshape(-1)
            self.attrs = tensor(uv, dev)[uv_flat].reshape(t, 3, 2)
        elif vtx_color is not None:
            # a vertex-colour leaf's gradient sums each vertex's corners in
            # a fixed order (rasterize.IndexRows)
            vtx = tensor(vtx_color, dev)
            corners = gather_rows(vtx if vtx.dim() == 3 else vtx[None], flat)
            self.attrs = corners.reshape((t, 3, 3) if vtx.dim() == 2
                                         else (vtx.shape[0], t, 3, 3))
        else:
            self.attrs = None
        self.n_ch = 0 if self.attrs is None else self.attrs.shape[-1]
        shared = self.attrs is not None and self.attrs.dim() == 3
        self.static = static_pack_rows(self.pos_c, self.attrs if shared else None,
                                       self.degenerate)

    def recolored(self, vtx_color=None, corner_colors=None, tex=None, uv=None,
                  uv_idx=None) -> "_Mesh":
        """This mesh with other colours (a step's appearance leaves)."""
        out = copy.copy(self)
        out._set_colors(vtx_color, corner_colors, tex, uv, uv_idx)
        return out


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _padded(resolution):
    (h, w), (th, tw) = resolution, TILE_HW
    return -(-h // th) * th, -(-w // tw) * tw


def _seg_bounds(seg: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    """(r0, r1, c0, c1), the half-open rows and columns that hold the gt
    segmentation's support, or None when it is empty."""
    seg_any = seg.max(axis=-1) if seg.ndim == 3 else seg
    rows_any = (seg_any > 0).any(axis=1)
    cols_any = (seg_any > 0).any(axis=0)
    if not rows_any.any():
        return None
    return (int(np.argmax(rows_any)), int(len(rows_any) - np.argmax(rows_any[::-1])),
            int(np.argmax(cols_any)), int(len(cols_any) - np.argmax(cols_any[::-1])))


def crop_window(seg: np.ndarray, resolution):
    """Tile-aligned ROI (oy, ox, hc, wc) around the gt segmentation support
    plus ``CROP_MARGIN`` px (``pipeline.py:548-579``), or None when it would
    be the whole padded frame."""
    margin = CROP_MARGIN
    hp, wp = _padded(resolution)
    th, tw = TILE_HW
    bounds = _seg_bounds(seg)
    if bounds is None:
        return None
    r0, r1, c0, c1 = bounds
    oy = max(0, r0 - margin) // th * th
    ox = max(0, c0 - margin) // tw * tw
    hc = min(hp, -(-(r1 + margin - oy) // th) * th)
    wc = min(wp, -(-(c1 + margin - ox) // tw) * tw)
    if (hc, wc) == (hp, wp):
        return None
    return oy, ox, hc, wc


class _Crop:
    """A tile-aligned ROI window (oy, ox, hc, wc) of the padded frame: the
    tiles it keeps, and the pixel bounds of its 2 px interior that every
    triangle must stay inside for the cropped loss to be exact."""

    def __init__(self, window, resolution, device):
        (h, w), (th, tw) = resolution, TILE_HW
        oy, ox, hc, wc = window
        nty, ntx = (n // t for n, t in zip(_padded(resolution), TILE_HW))
        self.window, self.resolution = window, resolution
        self.tiles = (
            torch.arange(nty, device=device)[oy // th : (oy + hc) // th, None] * ntx
            + torch.arange(ntx, device=device)[None, ox // tw : (ox + wc) // tw]
        ).reshape(-1)
        self.x_lo = float(ox + 2) if ox > 0 else -1e9
        self.x_hi = float(ox + wc - 3) if ox + wc < w else 1e9
        self.y_lo = float(oy + 2) if oy > 0 else -1e9
        self.y_hi = float(oy + hc - 3) if oy + hc < h else 1e9

    def leak(self, cp, degenerate) -> torch.Tensor:
        """How many triangles' pixel bounds escape the interior ('_crop_leak')."""
        h, w = self.resolution
        xlo, xhi = _xbounds_ndc(cp, degenerate)
        ylo, yhi = _ybounds_ndc(cp, degenerate)
        px_lo = (xlo + 1.0) * (w / 2.0) - 0.5
        px_hi = (xhi + 1.0) * (w / 2.0) - 0.5
        py_lo = (ylo + 1.0) * (h / 2.0) - 0.5
        py_hi = (yhi + 1.0) * (h / 2.0) - 0.5
        out = (xlo <= xhi) & (
            (px_lo < self.x_lo) | (px_hi > self.x_hi)
            | (py_lo < self.y_lo) | (py_hi > self.y_hi)
        )
        return out.sum(dtype=torch.int32)


class _Binned(NamedTuple):
    """A table's layout before the pack: the poses' mvp, the slot ->
    triangle map, the silhouette bits, the per-tile counts, chunk offsets
    and chunk counts (None for the uniform table), and the binning
    telemetry."""

    mvp: torch.Tensor
    flat: torch.Tensor
    sil: torch.Tensor
    counts: torch.Tensor
    off_c: Optional[torch.Tensor]
    used: Optional[torch.Tensor]
    telemetry: Dict[str, torch.Tensor]


class _Table(NamedTuple):
    """A packed table (B, 32, n_slots), differentiable in the poses, with
    its layout (off_c and used None for the uniform table) and telemetry."""

    packed: torch.Tensor
    counts: torch.Tensor
    off_c: Optional[torch.Tensor]
    used: Optional[torch.Tensor]
    telemetry: Dict[str, torch.Tensor]


class Bins(NamedTuple):
    """Bins computed once for a whole refinement (:func:`precompute_bins`):
    the per-tile slot lists (tiles, K) int32 (sentinel T), their counts,
    and the inverted map (T, max_occ) with its validity: the reference's
    ``Bins`` fields, its planar 'v2' backward's input, laid out once here
    (the width read on the host) and read by no step of the port, whose
    backward sums each triangle's slots in slot order (:data:`MAX_OCC`)."""

    idx: torch.Tensor
    counts: torch.Tensor
    inv_pos: torch.Tensor
    inv_valid: torch.Tensor


class _DepthPlane(torch.autograd.Function):
    """gt depth + t_z per hypothesis over the window (oy, ox, hc, wc) of
    the padded frame (hp, wp): (B, hc, wc), differentiable in t_z (B,).
    The t_z gradient sums the window's cotangent laid into the whole
    padded frame, so the ROI crop and the full frame sum one tensor in
    one order (no depth gradient lies outside the crop) and the compact
    and the uniform-K table give the same pose gradient bit for bit."""

    @staticmethod
    def forward(ctx, gtd, tz, window, frame):
        ctx.window, ctx.frame = window, frame
        return gtd[None] + tz[:, None, None]

    @staticmethod
    def backward(ctx, d):
        (oy, ox, hc, wc), (hp, wp) = ctx.window, ctx.frame
        if (hc, wc) != (hp, wp):
            d = torch.nn.functional.pad(d, (ox, wp - ox - wc, oy, hp - oy - hc))
        return None, d.sum((1, 2)), None, None


def _binned(mesh: _Mesh, mtx: torch.Tensor, resolution,
            capacity: Optional[Union[int, str]] = None, crop: Optional[_Crop] = None,
            cull: bool = False, max_tris: int = MAX_TRIS_PER_TILE,
            bins: Optional[Bins] = None) -> _Binned:
    """Bin the mesh at poses ``mtx`` (B, 4, 4) into a table's layout.

    ``capacity`` is the compact table's slots, ``EXACT`` to size it to the
    bins, or None for the uniform table (the bins as they are: K slots for
    every tile, sentinel padding).  ``crop`` (compact only) drops the
    tiles outside it before compaction and counts '_crop_leak'.
    '_bin_need' is the slots a full-frame compact table needs at these
    poses: the chunk-rounded bins plus the pairs the per-tile capacity
    dropped (the overflow recovery sizes its re-run from it).

    With precomputed ``bins`` nothing is binned (as the reference's
    ``bins=``, ``pipeline.py:228, 628``): '_bin_overflow' counts the
    compact table's drops only, and the uniform table logs none."""
    mvp = matmul44(mesh.proj, mtx)
    cp = corner_planes(mesh.pos_c, mvp)
    det = det_planar(cp, mesh.degenerate)
    if bins is None:
        idx, counts, bin_overflow = bin_triangles_planar(
            cp, det, resolution, TILE_HW, max_tris, cull_backfaces=cull
        )
    else:
        idx, counts, bin_overflow = bins.idx, bins.counts, None
    need = (-(-counts // K_CHUNK) * K_CHUNK).sum(dtype=torch.int32)
    telemetry = {"_bin_max": counts.max(),
                 "_bin_need": need if bin_overflow is None else need + bin_overflow}
    sil = _silhouette_planar(det, mesh.adj)
    if capacity is None:
        if crop is not None:
            raise ValueError("the uniform-K table covers the whole frame: no ROI crop")
        if bin_overflow is not None:
            telemetry["_bin_overflow"] = bin_overflow
        return _Binned(mvp, idx.reshape(-1), sil, counts.contiguous(), None, None,
                       telemetry)
    if crop is not None:
        idx, counts = idx[crop.tiles], counts[crop.tiles]
        telemetry["_crop_leak"] = crop.leak(cp, mesh.degenerate)
    if capacity == EXACT:
        capacity = int((-(-counts // K_CHUNK) * K_CHUNK).sum()) or K_CHUNK
    flat, off_c, used, c_ovf = compact_bins(
        idx, counts, mesh.t_count, K_CHUNK, capacity
    )
    telemetry["_bin_overflow"] = c_ovf if bin_overflow is None else bin_overflow + c_ovf
    return _Binned(mvp, flat, sil, counts.contiguous(), off_c, used, telemetry)


def slot_order_of(bn: _Binned, mesh: _Mesh) -> Optional[torch.Tensor]:
    """K2's places for a table's layout: None for the compact table (its
    places are its positions); for the uniform table its slots at the
    places the compact table of its bins holds them at
    (``pack_kernel.slot_order``)."""
    if bn.off_c is not None:
        return None
    return slot_order(bn.flat, bn.counts, mesh.t_count, K_CHUNK, mesh.degenerate)


def _pack_dispatch(mesh: _Mesh, mvp: torch.Tensor, mtx: torch.Tensor,
                   flat: torch.Tensor, sil: torch.Tensor,
                   order: Optional[torch.Tensor]) -> torch.Tensor:
    """The bin-ordered table of every call site: K1/K2 on the card, the
    plain ``planar.pack_binned`` for CPU tensors (``pack_binned_auto``)."""
    return pack_binned_auto(
        mesh.pos_c, mvp, mtx, flat, mesh.attrs, sil, mesh.degenerate,
        mesh.t_count, mesh.static, order=order,
    )


def _table(mesh: _Mesh, mtx: torch.Tensor, resolution,
           capacity: Optional[Union[int, str]] = None, crop: Optional[_Crop] = None,
           cull: bool = False, max_tris: int = MAX_TRIS_PER_TILE,
           bins: Optional[Bins] = None) -> _Table:
    """The packed table at poses ``mtx`` (B, 4, 4), differentiable in mtx,
    in the layout ``capacity`` selects (see :func:`_binned`); a refinement
    step stamps ``trace.TABLE`` between the binning and the pack."""
    bn = _binned(mesh, mtx, resolution, capacity, crop, cull, max_tris, bins)
    trace.stamp(trace.TABLE)
    packed = _pack_dispatch(mesh, bn.mvp, mtx, bn.flat, bn.sil,
                            slot_order_of(bn, mesh))
    return _Table(packed, bn.counts, bn.off_c, bn.used, bn.telemetry)


def _raster(table: _Table, frame_hw, roi):
    """(ids, rows) of a table over the (hc, wc) window ``frame_hw`` at
    ``roi``: K3/K4 (``RasterCompact``) for the compact table, K7
    (``RasterBinned``) for the uniform one, whose window is the whole
    frame padded to whole tiles."""
    if table.off_c is None:
        ids, rows = raster_gather_rows_binned(table.packed, table.counts, roi[2:], TILE_HW,
                                              padded=True)
        if tuple(ids.shape[1:]) != tuple(frame_hw):
            raise ValueError(f"the uniform table covers {tuple(ids.shape[1:])}, "
                             f"not the window {frame_hw}")
        return ids, rows
    return raster_compact(table.packed, table.counts, table.off_c, table.used,
                          K_CHUNK, frame_hw, TILE_HW, roi)


class _Planar(NamedTuple):
    """The planar route's table (B, 32, T) in triangle order,
    differentiable in the poses; on the 'v2' route also its bins and the
    binning telemetry (None and {} on 'v3')."""

    packed: torch.Tensor
    idx: Optional[torch.Tensor]
    counts: Optional[torch.Tensor]
    telemetry: Dict[str, torch.Tensor]


def _planar_pack(mesh: _Mesh, mtx: torch.Tensor):
    """(packed, corner planes, det) of the triangle-order table at poses
    ``mtx``: ``planar.pack_planar`` with the rotated z of every corner as
    the depth plane (``pipeline.py:272-277``)."""
    mvp = matmul44(mesh.proj, mtx)
    cp = corner_planes(mesh.pos_c, mvp)
    p = mesh.pos_c
    zrot = (mtx[:, 2, 0, None] * p[:, 0] + mtx[:, 2, 1, None] * p[:, 1]) \
        + mtx[:, 2, 2, None] * p[:, 2]  # (B, 3T)
    packed, det = pack_planar(cp, mesh.attrs, zrot, mesh.adj, mesh.degenerate)
    return packed, cp, det


def _planar(mesh: _Mesh, mtx: torch.Tensor, resolution, route: str, cull: bool = False,
            max_tris: int = MAX_TRIS_PER_TILE, bins: Optional[Bins] = None) -> _Planar:
    """The planar route's inputs at poses ``mtx``: on 'v2' the bins of
    ``planar.bin_triangles_planar`` (``cull`` reaches only them), with
    '_bin_overflow', '_bin_max' and '_bin_occupancy' (the most tiles a
    triangle occurs in at these bins, ``gather_rows.bin_occupancy``).
    Precomputed ``bins`` take the 'v2' raster on either route, no
    telemetry (the reference's ``bins=``, ``pipeline.py:278-286,
    740-750``).  A refinement step stamps ``trace.TABLE`` once the table
    and its bins are laid out, before the raster."""
    packed, cp, det = _planar_pack(mesh, mtx)
    if bins is not None:
        pl = _Planar(packed, bins.idx, bins.counts, {})
    elif route == "v3":
        pl = _Planar(packed, None, None, {})
    else:
        idx, counts, overflow = bin_triangles_planar(cp, det.detach(), resolution, TILE_HW,
                                                     max_tris, cull_backfaces=cull)
        telemetry = {"_bin_overflow": overflow, "_bin_max": counts.max(),
                     "_bin_occupancy": bin_occupancy(idx, mesh.t_count)}
        pl = _Planar(packed, idx, counts.contiguous(), telemetry)
    trace.stamp(trace.TABLE)
    return pl


def _raster_planar(pl: _Planar, resolution):
    """(ids, rows) of the planar route over the frame padded to whole
    tiles: K10 (``raster_gather_rows_v3``) on 'v3', K7 over the gathered
    bins (``raster_gather_rows_v2``) on 'v2'."""
    if pl.idx is None:
        return raster_gather_rows_v3(pl.packed, resolution, TILE_HW, padded=True)
    return raster_gather_rows_v2(pl.packed, pl.idx, pl.counts, None, None, resolution,
                                 TILE_HW, padded=True)


def make_fused_loss(
    proj_cam,
    pos,
    pos_idx,
    resolution: Tuple[int, int],
    gt: Optional[Dict[str, object]],
    learning_rates,
    weights: Dict[str, float],
    use_rgb: bool = False,
    use_depth: bool = False,
    use_mask: bool = True,
    edge_adj=None,
    corner_colors=None,
    vtx_color=None,
    tex=None,
    compact_total: Optional[int] = None,
    roi_crop: str = "auto",
    cull_backfaces: bool = False,
    max_tris_per_tile: int = MAX_TRIS_PER_TILE,
    device="cuda",
    uv=None,
    uv_idx=None,
    bins: Optional[Bins] = None,
):
    """Build ``fn(mtx, learning_rates=None) -> (total_loss, logs)``.

    Same loss semantics as the reference: per-term per-hypothesis means,
    per-hypothesis loss scales, weighted total, logs under 'rgb', 'depth'
    and 'mask_selection', and underscore telemetry keys '_bin_overflow',
    '_bin_max', '_bin_need' and (with the crop) '_crop_leak'.
    ``learning_rates`` given to ``fn`` replace the build's loss scales for
    that call (the reference's, :592-597: ``optimize.refine`` hands each
    rank of a sharded run its own slice).  ``gt`` holds
    numpy or tensor 'rgb' and 'segmentation' (H, W, 3) images, and 'depth'
    (H, W) for ``use_depth``.  ``compact_total`` None runs the uniform-K
    table on the full frame (no ROI crop), as the reference does.

    ``gt`` None defers the ground truth (reference :425-427, 487-499):
    the returned function is ``fn(mtx, gt, learning_rates=None)``, its gt
    planes laid out from the given dict at every call, so one loss serves
    many scenes (the BOP sweep).  Both crops need the gt at build time, so
    a deferred loss has neither, as in the reference (:501-512, 546-553):
    the full frame, and on the texture route the texture sampled over all
    of it.
    ``fn.bind_gt(gt)`` is the deferred loss with one gt bound, carrying
    the planes the kernel checks read, as a baked loss does.

    With ``tex`` (TH, TW, 3) and its ``uv`` (N, 2) / ``uv_idx`` (T, 3) the
    colours are the texture sampled at each pixel's uv (the semi-fused
    exact-texture route, reference :770-822): no ROI crop; the raster, then
    the uv shade and the sampler on the crop around the gt segmentation
    (``DD_TEX_CROP``, default on, reference :503-532; 8-bit textures
    through ``texture_planar_packed4``, others ``texture_planar``), the
    colours foreground-masked and padded back to the frame, then K5/K6's
    colour lane; the sums' backward reaches the uv through the sampler.

    ``DD_DROWS_BF16`` (default "1", as in the reference, :583-590) is read
    here, once: "1" gives the spanning op bf16 d_rows between K6 and K4,
    anything else f32; changing it after the build has no effect.  Only
    the spanning op (rgb + mask on the compact table) reads it.

    The route is read from the environment here (:func:`raster_route`):
    on the planar routes the table is ``planar.pack_planar``'s, the frame
    is full and ``compact_total`` is not read; 'v3' logs no binning
    telemetry, 'v2' '_bin_overflow', '_bin_max' and '_bin_occupancy'.

    ``bins`` (:func:`precompute_bins`) replaces each step's binning (the
    reference's ``bins=``, :628, :749): the compact or uniform table,
    crop included, is laid out from them (see :func:`_binned`), and on
    the planar routes the 'v2' raster runs over them.
    """
    deferred = gt is None
    compact_total = _check_capacity(compact_total)
    if not deferred and use_depth and gt.get("depth") is None:
        raise ValueError("the depth loss needs gt['depth']")
    device = torch.device(device)
    mesh = _Mesh(proj_cam, pos, pos_idx, edge_adj, vtx_color, corner_colors, device,
                 tex, uv, uv_idx)
    if mesh.attrs is None:
        raise ValueError("fused loss requires corner_colors, vtx_color, or tex(+uv)")
    texture_mode = mesh.tex is not None

    h, w = resolution
    hp, wp = _padded(resolution)
    seg_np = None if deferred else _numpy(gt["segmentation"]).astype(np.float32)

    route = raster_route()
    drows_bf16 = os.environ.get("DD_DROWS_BF16", "1") == "1"
    # the reference crops the compact table only, not in texture mode, and
    # only around a gt given at build time
    crop_on = (roi_crop != "off" and compact_total is not None and route is None
               and not texture_mode and not deferred)
    window = crop_window(seg_np, resolution) if crop_on else None
    crop = None if window is None else _Crop(window, resolution, device)
    oy, ox, hc, wc = window or (0, 0, hp, wp)
    roi = (oy, ox, h, w)
    npx = float(h * w)
    lrs = tensor(learning_rates, device)
    sample = _texture_sampler(mesh, seg_np, (hc, wc), resolution) if texture_mode else None

    def gt_planes(g) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The gt segmentation and rgb as planes (6, hc, wc) over the
        window, and the depth plane (hc, wc) for ``use_depth`` (reference
        ``prep_gt``, :487-499), zero past the frame."""
        if g.get("segmentation") is None:
            raise ValueError("fused loss requires gt['segmentation']")
        if use_depth and g.get("depth") is None:
            raise ValueError("the depth loss needs gt['depth']")
        planes = torch.zeros((7, hp, wp), dtype=torch.float32, device=device)
        planes[0:3, :h, :w] = tensor(g["segmentation"], device)[..., :3].permute(2, 0, 1)
        if g.get("rgb") is not None:
            planes[3:6, :h, :w] = tensor(g["rgb"], device).permute(2, 0, 1)
        if use_depth:
            planes[6, :h, :w] = tensor(g["depth"], device)
        planes = planes[:, oy : oy + hc, ox : ox + wc]
        return planes[:6].contiguous(), planes[6].contiguous() if use_depth else None

    def binned(mtx: torch.Tensor) -> _Binned:
        return _binned(mesh, mtx, resolution, compact_total, crop,
                       cull_backfaces, max_tris_per_tile, bins)

    def table(mtx: torch.Tensor) -> _Table:
        return _table(mesh, mtx, resolution, compact_total, crop,
                      cull_backfaces, max_tris_per_tile, bins)

    def planar(mtx: torch.Tensor) -> _Planar:
        return _planar(mesh, mtx, resolution, route, cull_backfaces, max_tris_per_tile,
                       bins)

    def depth_plane(gtd, mtx: torch.Tensor) -> Optional[torch.Tensor]:
        """gt depth + t_z per hypothesis (B, hc, wc), differentiable in t_z."""
        return None if gtd is None else _DepthPlane.apply(gtd, mtx[:, 2, 3],
                                                          (oy, ox, hc, wc), (hp, wp))

    def sums_of(ids, rows, mtx, gt6, gtd):
        colors = None if sample is None else sample(rows, ids)
        return fused_loss_sums(rows, ids, gt6, depth_plane(gtd, mtx), colors, (hc, wc), roi)

    def loss(mtx: torch.Tensor, gt6: torch.Tensor, gtd: Optional[torch.Tensor],
             learning_rates=None):
        if mtx.dim() == 2:
            mtx = mtx[None]
        scales = lrs if learning_rates is None else tensor(learning_rates, device)
        if route is not None:
            tab = planar(mtx)
            sums = sums_of(*_raster_planar(tab, resolution), mtx, gt6, gtd)
        else:
            tab = table(mtx)
            if not use_depth and not texture_mode and tab.off_c is not None:
                sums = raster_loss_compact(
                    tab.packed, tab.counts, tab.off_c, tab.used, gt6, K_CHUNK, (hc, wc),
                    TILE_HW, roi, drows_bf16,
                )
            else:
                sums = sums_of(*_raster(tab, (hc, wc), roi), mtx, gt6, gtd)
        total = sums.new_zeros(())
        logs = {}
        if use_rgb:
            per_hyp = sums[:, RGB_LANE] / (3.0 * npx)
            total = total + torch.mean(per_hyp * scales) * weights["rgb"]
            logs["rgb"] = per_hyp * weights["rgb"]
        if use_depth:
            per_hyp = sums[:, DEPTH_LANE] / npx
            total = total + torch.mean(per_hyp * scales) * weights["depth"]
            logs["depth"] = per_hyp * weights["depth"]
        if use_mask:
            per_hyp = sums[:, MASK_LANE] / (3.0 * npx)
            total = total + torch.mean(per_hyp * scales) * weights["mask"]
            logs["mask_selection"] = per_hyp * weights["mask"]
        logs.update({k: v.detach() for k, v in tab.telemetry.items()})
        return total, logs

    def attach(f, gt6, gtd):
        # what the kernel checks need to drive the pack, the raster and the
        # loss kernels on this loss's own tables (``sample``: the colour
        # planes of a raster's rows and ids on the texture route, else None)
        f.mesh, f.binned, f.table = mesh, binned, table
        f.gt6, f.dplane = gt6, lambda mtx: depth_plane(gtd, mtx)
        f.frame_hw, f.roi, f.crop = (hc, wc), roi, window
        f.route, f.planar, f.sample = route, planar, sample
        # the spanning op's d_rows lane, where this loss takes the op
        f.drows_bf16 = drows_bf16 and not use_depth and not texture_mode \
            and route is None and compact_total is not None
        return f

    def bind_gt(g):
        gt6, gtd = gt_planes(g)

        def fn(mtx: torch.Tensor, learning_rates=None):
            return loss(mtx, gt6, gtd, learning_rates)

        return attach(fn, gt6, gtd)

    if not deferred:
        return bind_gt(gt)

    def fn(mtx: torch.Tensor, gt, learning_rates=None):
        return loss(mtx, *gt_planes(gt), learning_rates)

    attach(fn, None, None)
    fn.bind_gt = bind_gt
    return fn


def _texture_sampler(mesh: _Mesh, seg: Optional[np.ndarray], frame_hw, resolution):
    """``sample(rows, ids) -> colors (B, 3, hc, wc)`` of the semi-fused
    exact-texture route (reference ``pipeline.py:503-532, 770-822``): the
    uv shade of the rows on the crop around the gt segmentation (8-px
    aligned; the whole frame under ``DD_TEX_CROP=0``), bit for bit the
    frame's pixels there (the whole frame for a ``seg`` of None, a gt
    given per call), the texture sampled at that uv, masked to the
    foreground and padded back to the frame.  The rgb term reads colours
    only where the segmentation is nonzero, so the crop is loss- and
    gradient-exact.  A texture that no gradient reaches and that is 8-bit
    quantized is sampled from its packed 2x2 blocks (one row gather a
    pixel, the regather-free backward); any other by ``texture_planar``."""
    hp, wp = frame_hw
    h, w = resolution
    ct, cl, chh, cww = 0, 0, hp, wp
    bounds = None if seg is None else _seg_bounds(seg)
    if os.environ.get("DD_TEX_CROP", "1") == "1" and bounds is not None:
        r0, r1, c0, c1 = bounds
        ct, cl = r0 // 8 * 8, c0 // 8 * 8
        chh = min(hp - ct, -(-(r1 - ct) // 8) * 8)
        cww = min(wp - cl, -(-(c1 - cl) // 8) * 8)
    tex = mesh.tex
    th, tw, n_col = tex.shape
    blocks = None if tex.requires_grad else pack_bilinear_blocks4(tex)
    table4 = None if blocks is None else table_tensor(blocks, tex.device)
    xy = pixel_ndc((chh, cww), (ct, cl, h, w), device=tex.device)

    def sample(rows: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        rows_c = rows[:, :, ct:ct + chh, cl:cl + cww]
        ids_c = ids[:, ct:ct + chh, cl:cl + cww]
        shd = shade_from_rows(ids_c, rows_c, (chh, cww), attr_channels=2, xy=xy)
        u, v = shd["attrs_list"]
        fg = (ids_c > 0).to(rows.dtype)
        if table4 is not None:
            colors = (texture_planar_packed4(table4, u, v, th, tw, n_col) * fg).movedim(0, 1)
        else:
            colors = torch.stack([c * fg for c in texture_planar(tex, u, v)], dim=1)
        if (chh, cww) != (hp, wp):
            colors = torch.nn.functional.pad(colors, (cl, wp - cl - cww, ct, hp - ct - chh))
        return colors.contiguous()

    sample.crop = (ct, cl, chh, cww)
    sample.packed = table4 is not None
    return sample


def _check_capacity(compact_total) -> Optional[int]:
    """The compact table's slots, or None (also for 0) for the uniform
    table, as the reference reads ``compact_total``."""
    if not compact_total:
        return None
    if compact_total % K_CHUNK:
        raise ValueError(f"compact_total must be a multiple of {K_CHUNK}")
    return int(compact_total)


@torch.no_grad()
def compact_capacity(proj_cam, pos, pos_idx, mtx, resolution,
                     max_tris_per_tile: int = MAX_TRIS_PER_TILE, boost: float = 1.0,
                     device="cuda", slack: float = CAPACITY_SLACK) -> int:
    """Compact-table capacity sized from a probe pose (the root bench's
    rule, ``bench.py:207-235``, and ``DiffDope._resolve_compact_total``):
    the probe's chunk-rounded slot count times ``slack`` (and the overflow
    recovery's ``boost``) plus one chunk, rounded to the chunk.  Traced as
    ``dd.probe``."""
    with trace.span("probe", what="compact_capacity"):
        mesh = _Mesh(proj_cam, pos, pos_idx, None, None, None, torch.device(device))
        bn = _binned(mesh, tensor(mtx, device).reshape(-1, 4, 4), resolution, EXACT,
                     max_tris=max_tris_per_tile)
        tot0 = int(bn.used.sum()) * K_CHUNK
    return -(-int(tot0 * slack * boost + K_CHUNK) // K_CHUNK) * K_CHUNK


@torch.no_grad()
def max_tile_count(proj_cam, pos, pos_idx, mtx, resolution, device="cuda") -> int:
    """The most triangles any tile's bin holds at poses ``mtx``, uncapped
    (``DiffDope._resolve_max_tris`` sizes ``max_tris_per_tile`` from it).
    Traced as ``dd.probe``."""
    with trace.span("probe", what="max_tile_count"):
        mesh = _Mesh(proj_cam, pos, pos_idx, None, None, None, torch.device(device))
        cp = corner_planes(mesh.pos_c,
                           matmul44(mesh.proj, tensor(mtx, device).reshape(-1, 4, 4)))
        det = det_planar(cp, mesh.degenerate)
        _, counts, _ = bin_triangles_planar(cp, det, resolution, TILE_HW, mesh.t_count)
        return int(counts.max())


@torch.no_grad()
def precompute_bins(proj_cam, mtx0, pos, pos_idx, resolution,
                    max_tris_per_tile: Union[int, str] = "auto", margin_px: float = 24.0,
                    cull_backfaces: bool = False, device="cuda") -> Bins:
    """One binning for a whole refinement (``pipeline.py:861-935``): the
    mesh binned at the initial poses ``mtx0`` (B, 4, 4), union over the
    batch, on the port's ``TILE_HW`` tiles, each triangle's pixel bounds
    widened by ``margin_px`` to cover the poses' drift, with the inverted
    map sized to the most tiles a triangle occurs in ('auto').

    A bin need only hold every triangle that can cover one of its tile's
    pixels: the rasters test each (pixel, slot) pair by the slot's own f32
    planes, and K3/K7 skip a slot outside the pixel box those planes give
    (F5), so the slots a margin adds never win a pixel
    (``tests/test_torch_refine_options.py`` holds the ids equal in both
    packages).  ``max_tris_per_tile`` 'auto' sizes K to the fullest bin
    (rounded up to 128); a given K that drops a (tile, triangle) pair
    raises, as the reference's does.  ``cull_backfaces`` drops the faces
    back-facing at every initial pose (:func:`planar.bin_triangles_planar`);
    ``DiffDope`` culls none, as the reference's bins none: a face that is
    back-facing at the init may face the camera later."""
    device = torch.device(device)
    mesh = _Mesh(proj_cam, pos, pos_idx, None, None, None, device)
    mtx0 = tensor(mtx0, device).reshape(-1, 4, 4)
    cp = corner_planes(mesh.pos_c, matmul44(mesh.proj, mtx0))
    det = det_planar(cp, mesh.degenerate)
    k = mesh.t_count if max_tris_per_tile == "auto" else int(max_tris_per_tile)
    idx, counts, overflow = bin_triangles_planar(cp, det, resolution, TILE_HW, k,
                                                 cull_backfaces=cull_backfaces,
                                                 margin_px=margin_px)
    if int(overflow) > 0:
        raise ValueError(
            f"bin overflow: {int(overflow)} (tile, triangle) pairs dropped at "
            f"max_tris_per_tile={k} (max tile count {int(counts.max())}); raise "
            "max_tris_per_tile")
    if max_tris_per_tile == "auto":
        idx = idx[:, : max(128, -(-int(counts.max()) // 128) * 128)].contiguous()
    inv_pos, inv_valid = invert_bins(idx, mesh.t_count, "auto")
    return Bins(idx, counts.contiguous(), inv_pos, inv_valid)


def _shade_and_aa(rows, ids, tz, resolution, n_ch: int, antialias_rgb: bool = False,
                  with_rast: bool = False, shd=None, tex=None):
    """The plain shade and antialiasing of ``render_batch`` (reference
    :308-337): the antialiased mask, the three colour planes (antialiased
    too with ``antialias_rgb``), the depth -(rotated z + t_z) (background
    -t_z) and, ``with_rast``, the (B, H, W, 4) rast.  The colours are the
    first of the n_ch attribute channels, or with a texture ``tex`` its
    bilinear samples at the uv channels, masked to the foreground.
    ``shd`` is the shade of ``rows`` where the caller has it
    (``shade.shade_rows``)."""
    xy = pixel_ndc(resolution, device=rows.device)
    if shd is None:
        shd = shade_from_rows(ids, rows, resolution, attr_channels=n_ch + 1, xy=xy,
                              stack_outputs=with_rast)
    fg = (ids > 0).to(rows.dtype)
    mask = antialias_rows(fg, ids, shd["zw"], rows, resolution, xy=xy)
    if tex is not None:
        img = texture(tex, torch.stack(shd["attrs_list"][:2], dim=-1), filter_mode="linear")
        colors = [img[..., c] * fg for c in range(3)]
    else:
        colors = shd["attrs_list"][:3]
    if antialias_rgb:
        colors = [antialias_rows(c, ids, shd["zw"], rows, resolution, xy=xy)
                  for c in colors]
    depth = -(shd["attrs_list"][n_ch] + tz[:, None, None])
    return (mask, *colors, depth) + ((shd["rast"],) if with_rast else ())


def _reference_ids_rows(mesh: _Mesh, mtx: torch.Tensor, resolution, with_rast: bool):
    """The reference branch of ``render_batch`` (reference :167-188): the
    corners' clip positions by ``xfm_points``, their setup, attribute
    planes of the colours (or uv) and the rotated z, the packed rows, the
    brute-force id search (no kernel) and the shade of the gathered
    rows."""
    b, t = mtx.shape[0], mesh.t_count
    mvp = matmul44(mesh.proj, mtx)
    setup = triangle_setup_from_corners(xfm_points(mesh.pos_c, mvp).reshape(b, t, 3, 4))
    p = mesh.pos_c
    zrot = (mtx[:, 2, 0, None] * p[:, 0] + mtx[:, 2, 1, None] * p[:, 1]) \
        + mtx[:, 2, 2, None] * p[:, 2]  # (B, 3T)
    corner_vals = torch.cat([mesh.attrs.expand(b, t, 3, mesh.n_ch),
                             zrot.reshape(b, t, 3, 1)], dim=-1)
    packed = pack_rows(setup, silhouette_bits(setup.det, mesh.adj),
                       attribute_planes(corner_vals, setup))
    ids = raster_ids_reference(setup.coef, resolution)
    shd = shade_rows(ids, packed, resolution, attr_channels=mesh.n_ch + 1,
                     stack_outputs=with_rast)
    return ids, shd


def _impl(raster_impl: str, t_count: int) -> str:
    """'reference' or 'pallas' for ``raster_impl``, 'auto' resolved by the
    reference's rule (the brute force for at most 256 triangles)."""
    if raster_impl == "auto":
        return "reference" if t_count <= AUTO_REFERENCE_MAX_TRIS else "pallas"
    if raster_impl not in ("reference", "pallas"):
        raise ValueError(f"unknown raster_impl {raster_impl!r} (pallas | reference | auto)")
    return raster_impl


def _render(mesh: _Mesh, mtx: torch.Tensor, resolution,
            capacity: Optional[Union[int, str]], layout: str = "stacked",
            cull: bool = False, max_tris: int = MAX_TRIS_PER_TILE,
            impl: str = "pallas", return_rast_out: bool = False,
            antialias_rgb: bool = False, route: Optional[str] = None,
            bins: Optional[Bins] = None) -> Dict[str, object]:
    """:func:`render_batch` on a prepared mesh.  ``impl`` 'pallas': K1 ->
    K3 (compact table) or K7 (``capacity`` None: the uniform table), then
    the plain shade and antialiasing; backward K4 or K7 -> K2; or, with a
    planar ``route`` (:func:`raster_route`), the triangle-order table and
    K10 ('v3') or K7 over its gathered bins ('v2'), ``capacity`` unread.
    'reference': the brute-force branch (:func:`_reference_ids_rows`),
    plain torch throughout; it bins nothing and carries no telemetry.
    Precomputed ``bins`` replace the kernel branch's binning (as in
    :func:`make_fused_loss`).

    On the kernel branch the shading is recomputed in the backward
    (``checkpoint``), as the reference does (:339-348): its autograd
    residuals are dozens of (B, H, W) temporaries, while recomputing them
    costs a few elementwise passes; the raster kernel is not re-run."""
    if layout not in ("stacked", "channels"):
        raise ValueError(f"unknown layout {layout!r} (stacked | channels)")
    if mesh.attrs is None:
        raise ValueError("render requires corner_colors, tex(+uv), or vtx_color")
    if mesh.tex is None and mesh.n_ch != 3:
        raise ValueError("render_batch requires 3-channel corner_colors or vtx_color")
    if mtx.dim() == 2:
        mtx = mtx[None]
    h, w = resolution
    if impl == "reference":
        ids, shd = _reference_ids_rows(mesh, mtx, resolution, return_rast_out)
        out = _shade_and_aa(shd["rows"], ids, mtx[:, 2, 3], tuple(resolution), mesh.n_ch,
                            antialias_rgb, return_rast_out, shd, mesh.tex)
        tel = {}
    else:
        if route is None:
            tab = _table(mesh, mtx, resolution, capacity, None, cull, max_tris, bins)
            ids, rows = _raster(tab, _padded(resolution), (0, 0, h, w))
            keys = tuple(k for k in ("_bin_overflow", "_bin_need") if k in tab.telemetry)
        else:
            tab = _planar(mesh, mtx, resolution, route, cull, max_tris, bins)
            ids, rows = _raster_planar(tab, resolution)
            keys = ("_bin_overflow", "_bin_occupancy") if tab.telemetry else ()
        ids, rows = ids[:, :h, :w], rows[:, :, :h, :w]
        # the shade draws no random numbers: no RNG state to stash, which a
        # captured step could not read
        out = checkpoint(_shade_and_aa, rows, ids, mtx[:, 2, 3], tuple(resolution),
                         mesh.n_ch, antialias_rgb, return_rast_out, None, mesh.tex,
                         use_reentrant=False, preserve_rng_state=False)
        tel = {k: tab.telemetry[k].detach() for k in keys}
    mask, colors, depth = out[0], out[1:4], out[4]
    rast = out[5] if return_rast_out else None
    if layout == "channels":
        return {"mask": mask, "rgb": colors, "depth": depth, "ids": ids,
                "rast_out": rast, **tel}
    return {
        "rgb": torch.stack(colors, dim=-1),
        "depth": depth,
        "mask": mask[..., None].expand(mask.shape + (3,)),
        "rast_out": rast,
        **tel,
    }


def render_batch(
    proj_cam,
    mtx: torch.Tensor,
    pos,
    pos_idx,
    resolution: Tuple[int, int],
    vtx_color=None,
    corner_colors=None,
    edge_adj=None,
    layout: str = "stacked",
    max_tris_per_tile: int = MAX_TRIS_PER_TILE,
    cull_backfaces: bool = False,
    compact_total: Optional[int] = None,
    raster_impl: str = "auto",
    return_rast_out: bool = False,
    antialias_rgb: bool = False,
    device="cuda",
    tex=None,
    uv=None,
    uv_idx=None,
    bins: Optional[Bins] = None,
) -> Dict[str, object]:
    """Render a mesh under B pose hypotheses ``mtx`` (B, 4, 4),
    differentiably in mtx and in the colours (``vtx_color``,
    ``corner_colors`` or ``tex`` may carry a gradient).

    The colours are ``corner_colors`` (T, 3, 3), else the texture ``tex``
    (TH, TW, 3) sampled bilinearly at the uv (N, 2) interpolated by
    ``uv_idx`` (T, 3) (the reference's 'texture' mode, ``pipeline.py:322-
    325``; the texture's gradient sums each texel's taps in a fixed order,
    ``texture``), else
    ``vtx_color`` (N, 3).

    ``raster_impl`` 'pallas' is the reference's pallas branch on the
    kernels: the compact table for ``compact_total`` slots, else the
    uniform-K table, or the planar route that ``DD_RASTER=v3`` /
    ``DD_BINNED=0`` select (:func:`raster_route`, read at each call);
    'reference' its
    brute-force branch (no kernel, no binning); 'auto' the brute force for
    at most 256 triangles.
    ``antialias_rgb`` also antialiases the colours (the reference
    antialiases only the mask).

    Returns, layout 'stacked': 'rgb' (B, H, W, 3), 'depth' (B, H, W),
    'mask' (B, H, W, 3) antialiased; layout 'channels': 'mask' (B, H, W),
    'rgb' a tuple of 3 (B, H, W), 'depth', 'ids' (B, H, W) int32 (+1,
    0 = background).  Both carry 'rast_out', the (B, H, W, 4) rast with
    ``return_rast_out``, else None, and on the kernel branch
    '_bin_overflow', the (tile, triangle) pairs dropped by the
    capacities, and '_bin_need', the slots a compact table holding every
    pair would need ('v2': '_bin_overflow' and '_bin_occupancy'; 'v3'
    bins nothing and carries neither).  ``bins`` (:func:`precompute_bins`)
    replaces the kernel branch's per-call binning (the reference's
    ``bins=``, ``pipeline.py:228, 285``); the uniform table then logs no
    '_bin_overflow', the compact table its own drops only."""
    compact_total = _check_capacity(compact_total)
    mesh = _Mesh(proj_cam, pos, pos_idx, edge_adj, vtx_color, corner_colors,
                 torch.device(device), tex, uv, uv_idx)
    return _render(mesh, tensor(mtx, device).reshape(-1, 4, 4), tuple(resolution),
                   compact_total, layout, cull_backfaces, max_tris_per_tile,
                   _impl(raster_impl, mesh.t_count), return_rast_out, antialias_rgb,
                   raster_route(), bins)


@torch.no_grad()
def render_rgb_mask(proj_cam, mtx, pos, pos_idx, resolution, edge_adj=None,
                    vtx_color=None, corner_colors=None, device="cuda", tex=None,
                    uv=None, uv_idx=None, cull_backfaces: bool = False
                    ) -> Dict[str, torch.Tensor]:
    """Render (B, H, W, 3) 'rgb' and 'mask' and (B, H, W) 'depth' at poses
    ``mtx`` (B, 4, 4) over a compact table sized to the bins exactly, or on
    the planar route the environment selects (the gt render):
    ``render_batch``'s stacked semantics and colours, the mask
    antialiased, the rgb not; ``cull_backfaces`` as ``render_batch``'s."""
    mesh = _Mesh(proj_cam, pos, pos_idx, edge_adj, vtx_color, corner_colors,
                 torch.device(device), tex, uv, uv_idx)
    out = _render(mesh, tensor(mtx, device).reshape(-1, 4, 4), tuple(resolution),
                  EXACT, cull=cull_backfaces, route=raster_route())
    dropped = int(out.get("_bin_overflow", 0))  # the 'v3' route bins nothing
    if dropped:
        raise RuntimeError(f"gt render dropped {dropped} (tile, triangle) pairs: "
                           f"more than {MAX_TRIS_PER_TILE} triangles in a tile")
    return {"rgb": out["rgb"], "mask": out["mask"], "depth": out["depth"]}
