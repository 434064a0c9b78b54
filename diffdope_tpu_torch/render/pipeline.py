"""The fused refinement loss on the port's main path.

Counterpart of ``diffdope_tpu/render/pipeline.py:make_fused_loss``
(:383-858), restricted to its production configuration: per-corner
colour planes, rgb+mask L1 terms, the compact bin table, the ROI crop with
``_crop_leak`` telemetry, and the spanning raster+loss op.  The pack is the
plain ``planar.pack_binned`` (the reference's ``DD_PACK=xla`` route).

Also the gt render of this slice (:func:`render_rgb_mask`): K3's ids and
rows at one pose, then the plain shade and mask antialiasing, with
``render_batch``'s stacked semantics (mask antialiased, rgb not).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from diffdope_tpu_torch.convert import tensor
from diffdope_tpu_torch.geometry import matmul44
from diffdope_tpu_torch.render.fused_loss import (
    MASK_LANE,
    RGB_LANE,
    raster_loss_compact,
)
from diffdope_tpu_torch.render.planar import (
    _silhouette_planar,
    _xbounds_ndc,
    _ybounds_ndc,
    bin_triangles_planar,
    compact_bins,
    corner_planes,
    det_planar,
    pack_binned,
    static_pack_rows,
)
from diffdope_tpu_torch.render.raster import raster_fwd
from diffdope_tpu_torch.render.shade import (
    antialias_rows,
    pixel_ndc,
    shade_from_rows,
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


class _Mesh:
    """The per-mesh constants every entry point needs, as tensors: the
    projection, triangle indices, corner-expanded positions (3T, 3), the
    per-corner colours (T, 3, 3), the degenerate-triangle mask, the edge
    adjacency and the static pack table."""

    def __init__(self, proj_cam, pos, pos_idx, edge_adj, vtx_color,
                 corner_colors, device):
        self.proj = tensor(proj_cam, device).reshape(4, 4)
        self.tri = tensor(pos_idx, device, torch.int64)
        self.t_count = self.tri.shape[0]
        flat = self.tri.reshape(-1)
        self.pos_c = tensor(pos, device)[flat]
        if corner_colors is not None:
            self.attrs = tensor(corner_colors, device)
        elif vtx_color is not None:
            self.attrs = tensor(vtx_color, device)[flat].reshape(self.t_count, 3, 3)
        else:
            self.attrs = None
        tri = self.tri
        self.degenerate = (
            (tri[:, 0] == tri[:, 1]) | (tri[:, 1] == tri[:, 2]) | (tri[:, 2] == tri[:, 0])
        )
        self.adj = None if edge_adj is None else tensor(edge_adj, device, torch.int64)
        self.static = static_pack_rows(self.pos_c, self.attrs, self.degenerate)


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _padded(resolution):
    (h, w), (th, tw) = resolution, TILE_HW
    return -(-h // th) * th, -(-w // tw) * tw


def crop_window(seg: np.ndarray, resolution):
    """Tile-aligned ROI (oy, ox, hc, wc) around the gt segmentation support
    plus ``CROP_MARGIN`` px (``pipeline.py:548-579``), or None when it would
    be the whole padded frame."""
    margin = CROP_MARGIN
    hp, wp = _padded(resolution)
    th, tw = TILE_HW
    seg_any = seg.max(axis=-1) if seg.ndim == 3 else seg
    rows_any = (seg_any > 0).any(axis=1)
    cols_any = (seg_any > 0).any(axis=0)
    if not rows_any.any():
        return None
    r0 = int(np.argmax(rows_any))
    r1 = int(len(rows_any) - np.argmax(rows_any[::-1]))
    c0 = int(np.argmax(cols_any))
    c1 = int(len(cols_any) - np.argmax(cols_any[::-1]))
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


def _compact_table(mesh: _Mesh, mtx: torch.Tensor, resolution,
                   capacity: Optional[int] = None, crop: Optional[_Crop] = None):
    """The compact packed table at poses ``mtx`` (B, 4, 4), differentiable
    in mtx, and its telemetry: (packed, counts, off_c, used, telemetry).

    ``capacity`` None sizes the table to the bins exactly (which reads the
    counts on the host).  ``crop`` drops the tiles outside it before
    compaction and counts '_crop_leak'."""
    mvp = matmul44(mesh.proj, mtx)
    cp = corner_planes(mesh.pos_c, mvp)
    det = det_planar(cp, mesh.degenerate)
    idx, counts, bin_overflow = bin_triangles_planar(
        cp, det, resolution, TILE_HW, MAX_TRIS_PER_TILE
    )
    telemetry = {"_bin_max": counts.max()}
    if crop is not None:
        idx, counts = idx[crop.tiles], counts[crop.tiles]
        telemetry["_crop_leak"] = crop.leak(cp, mesh.degenerate)
    if capacity is None:
        capacity = int((-(-counts // K_CHUNK) * K_CHUNK).sum()) or K_CHUNK
    flat, off_c, used, c_ovf = compact_bins(
        idx, counts, mesh.t_count, K_CHUNK, capacity
    )
    telemetry["_bin_overflow"] = bin_overflow + c_ovf
    sil = _silhouette_planar(det, mesh.adj)
    packed = pack_binned(
        mesh.pos_c, mvp, mtx, flat, mesh.attrs, sil, mesh.degenerate,
        mesh.t_count, mesh.static,
    )
    return packed, counts.contiguous(), off_c, used, telemetry


def make_fused_loss(
    proj_cam,
    pos,
    pos_idx,
    resolution: Tuple[int, int],
    gt: Dict[str, object],
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
    device="cpu",
):
    """Build ``fn(mtx) -> (total_loss, logs)``.

    Same loss semantics as the reference: per-term per-hypothesis means,
    per-hypothesis loss scales, weighted total, logs under 'rgb' and
    'mask_selection', and underscore telemetry keys '_bin_overflow',
    '_bin_max' and (with the crop) '_crop_leak'.  ``gt`` holds numpy or
    tensor 'rgb' and 'segmentation' (H, W, 3) images.
    """
    if use_depth:
        raise NotImplementedError(
            "the depth loss is not ported yet: ROADMAP queue 1, item 8"
        )
    if tex is not None:
        raise NotImplementedError(
            "exact texture is not ported yet: ROADMAP queue 1, item 10"
        )
    if not compact_total:
        raise NotImplementedError(
            "the uniform-K (uncompacted) table is not ported yet: the port's "
            "path is the compact table; pass compact_total (ROADMAP queue 1, "
            "item 7)"
        )
    if compact_total % K_CHUNK:
        raise ValueError(f"compact_total must be a multiple of {K_CHUNK}")
    if gt is None:
        raise NotImplementedError(
            "deferred (traced) ground truth is not ported yet: ROADMAP queue "
            "1, item 14"
        )
    device = torch.device(device)
    mesh = _Mesh(proj_cam, pos, pos_idx, edge_adj, vtx_color, corner_colors, device)
    if mesh.attrs is None:
        raise ValueError("fused loss requires corner_colors or vtx_color")

    h, w = resolution
    hp, wp = _padded(resolution)
    seg_np = _numpy(gt["segmentation"]).astype(np.float32)
    planes = np.zeros((6, hp, wp), np.float32)
    planes[0:3, :h, :w] = np.moveaxis(seg_np[..., :3], -1, 0)
    if gt.get("rgb") is not None:
        planes[3:6, :h, :w] = np.moveaxis(_numpy(gt["rgb"]).astype(np.float32), -1, 0)

    window = crop_window(seg_np, resolution) if roi_crop != "off" else None
    crop = None if window is None else _Crop(window, resolution, device)
    oy, ox, hc, wc = window or (0, 0, hp, wp)
    gt6 = torch.as_tensor(
        np.ascontiguousarray(planes[:, oy : oy + hc, ox : ox + wc]), device=device
    )
    roi = (oy, ox, h, w)
    npx = float(h * w)
    lrs = tensor(learning_rates, device)

    def table(mtx: torch.Tensor):
        return _compact_table(mesh, mtx, resolution, compact_total, crop)

    def fn(mtx: torch.Tensor):
        if mtx.dim() == 2:
            mtx = mtx[None]
        packed, counts, off_c, used, telemetry = table(mtx)
        sums = raster_loss_compact(
            packed, counts, off_c, used, gt6, K_CHUNK, (hc, wc), TILE_HW, roi
        )
        total = sums.new_zeros(())
        logs = {}
        if use_rgb:
            per_hyp = sums[:, RGB_LANE] / (3.0 * npx)
            total = total + torch.mean(per_hyp * lrs) * weights["rgb"]
            logs["rgb"] = per_hyp * weights["rgb"]
        if use_mask:
            per_hyp = sums[:, MASK_LANE] / (3.0 * npx)
            total = total + torch.mean(per_hyp * lrs) * weights["mask"]
            logs["mask_selection"] = per_hyp * weights["mask"]
        logs.update({k: v.detach() for k, v in telemetry.items()})
        return total, logs

    # what the kernel checks need to drive the spanning op's parts
    fn.table = table
    fn.gt6, fn.frame_hw, fn.roi, fn.crop = gt6, (hc, wc), roi, window
    return fn


@torch.no_grad()
def compact_capacity(proj_cam, pos, pos_idx, mtx, resolution, device="cpu") -> int:
    """Compact-table capacity sized from a probe pose (the root bench's
    rule, ``bench.py:207-235``): the probe's chunk-rounded slot count times
    ``CAPACITY_SLACK`` plus one chunk, rounded to the chunk."""
    mesh = _Mesh(proj_cam, pos, pos_idx, None, None, None, torch.device(device))
    _, _, _, used, _ = _compact_table(mesh, tensor(mtx, device).reshape(-1, 4, 4),
                                      resolution)
    tot0 = int(used.sum()) * K_CHUNK
    return -(-int(tot0 * CAPACITY_SLACK + K_CHUNK) // K_CHUNK) * K_CHUNK


@torch.no_grad()
def render_rgb_mask(proj_cam, mtx, pos, pos_idx, resolution, edge_adj=None,
                    vtx_color=None, corner_colors=None,
                    device="cpu") -> Dict[str, torch.Tensor]:
    """Render (B, H, W, 3) 'rgb' and 'mask' at poses ``mtx`` (B, 4, 4):
    K3's ids and rows over an exactly sized compact table, then the plain
    shade and antialiasing.  Stacked ``render_batch`` semantics: the mask
    is antialiased, the rgb is not."""
    mesh = _Mesh(proj_cam, pos, pos_idx, edge_adj, vtx_color, corner_colors,
                 torch.device(device))
    mtx = tensor(mtx, device).reshape(-1, 4, 4)
    packed, counts, off_c, used, telemetry = _compact_table(mesh, mtx, resolution)
    dropped = int(telemetry["_bin_overflow"])
    if dropped:
        raise RuntimeError(f"gt render dropped {dropped} (tile, triangle) pairs: "
                           f"more than {MAX_TRIS_PER_TILE} triangles in a tile")
    h, w = resolution
    ids, rows, _ = raster_fwd(
        packed, counts, off_c, used, K_CHUNK, _padded(resolution), TILE_HW,
        (0, 0, h, w),
    )
    ids, rows = ids[:, :h, :w], rows[:, :, :h, :w]
    xy = pixel_ndc(resolution, device=mtx.device)
    shd = shade_from_rows(ids, rows, resolution, attr_channels=3, xy=xy)
    fg = (ids > 0).to(rows.dtype)
    mask = antialias_rows(fg, ids, shd["zw"], rows, resolution, xy=xy)
    return {
        "rgb": torch.stack(shd["attrs_list"], dim=-1),
        "mask": mask[..., None].expand(mask.shape + (3,)),
    }
