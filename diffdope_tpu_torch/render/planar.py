"""Planar triangle setup, binning, compaction and the bin-ordered pack.

Counterpart of ``diffdope_tpu/render/planar.py:29-613``, in plain torch
with autograd.  Every per-triangle quantity is a (B, T) plane; the packed
table is (B, 32, n_slots) in bin-slot order, the layout the raster
kernels read.  ``pack_binned`` is the plain version of the pack kernels
K1/K2 (``render/pack_kernel.py``), which CPU tensors take.

Binning differs from the reference in two ways: tiles are the GPU
raster tile (``tile_hw``), and the frame is padded to that tile alone —
the reference's 128-wide super-tile grid (``raster_v2._sub_split``) is a
TPU lane artifact; and inside :func:`union_over` (a sharded run's
ranks) the bins are the union over every rank's hypotheses, where the
reference's shards bin their own.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from diffdope_tpu_torch.render.shade import PACKED_WIDTH

Planes = Union[torch.Tensor, Sequence[torch.Tensor]]

XLO_LANE = PACKED_WIDTH - 4  # 28
XHI_LANE = PACKED_WIDTH - 3  # 29
YLO_LANE = PACKED_WIDTH - 2  # 30
YHI_LANE = PACKED_WIDTH - 1  # 31
_Y_OPEN = 4.0  # beyond any pixel row's NDC y in (-1, 1)


#: the process group whose hypotheses :func:`bin_triangles_planar` takes
#: the union over (:func:`union_over`), or None: the batch's own; scoped
#: to the block (and the thread) that set it
_UNION_GROUP = contextvars.ContextVar("union_group", default=None)


@contextlib.contextmanager
def union_over(group):
    """Within the block, :func:`bin_triangles_planar` bins the union over
    the hypotheses of every rank of ``group`` (a ``torch.distributed``
    group; one all-reduce a call, every rank calling in step), so each
    rank of a sharded run bins, culls and lays out its table as the
    unsharded run does.  A batch's bins are the union over its hypotheses
    and the cull keeps a triangle that faces the camera in any of them,
    so a rank's own union would change its hypotheses' renders (F1's back
    faces win pixels) and the order of K2's sums."""
    token = _UNION_GROUP.set(group)
    try:
        yield
    finally:
        _UNION_GROUP.reset(token)


def _union(lows, highs, flags):
    """Minima, maxima and any-flags (each (T,)) over the union group's
    ranks, in one all-reduce (MIN of the lows, the negated highs and the
    negated flags)."""
    import torch.distributed as dist

    dtype = lows[0].dtype
    packed = torch.stack(list(lows) + [-h for h in highs]
                         + [-f.to(dtype) for f in flags])
    dist.all_reduce(packed, op=dist.ReduceOp.MIN, group=_UNION_GROUP.get())
    n_lo, n_hi = len(lows), len(highs)
    return (list(packed[:n_lo]), [-h for h in packed[n_lo:n_lo + n_hi]],
            [-f > 0.5 for f in packed[n_lo + n_hi:]])


def corner_planes(pos_c: torch.Tensor, mvp: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Corner-expanded object-space points (3T, 3) under (B, 4, 4) mvp ->
    planar clip coordinates {'x','y','z','w'}, each (B, 3T)."""
    out = {}
    for name, r in (("x", 0), ("y", 1), ("z", 2), ("w", 3)):
        m = mvp[:, r]
        out[name] = (
            m[:, 0:1] * pos_c[None, :, 0]
            + m[:, 1:2] * pos_c[None, :, 1]
            + m[:, 2:3] * pos_c[None, :, 2]
            + m[:, 3:4]
        )
    return out


def _corner(p: Planes, k: int) -> torch.Tensor:
    """Corner k's plane from an interleaved (B, 3T) array -> (B, T), or
    from a per-corner list [c0, c1, c2]."""
    if isinstance(p, (list, tuple)):
        return p[k]
    return p[:, k::3]


def det_planar(cp: Dict[str, Planes], degenerate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (B, T) determinant plane (``planar.py:198-212``)."""
    x = [_corner(cp["x"], k) for k in range(3)]
    y = [_corner(cp["y"], k) for k in range(3)]
    w = [_corner(cp["w"], k) for k in range(3)]
    c0 = (
        y[1] * w[2] - w[1] * y[2],
        w[1] * x[2] - x[1] * w[2],
        x[1] * y[2] - y[1] * x[2],
    )
    det = c0[0] * x[0] + c0[1] * y[0] + c0[2] * w[0]
    if degenerate is not None:
        det = det * (~degenerate)[None, :].to(det.dtype)
    return det


def _axis_bounds_ndc(cp, axis: str, degenerate):
    """Per-triangle conservative NDC interval along 'x' or 'y'
    (``planar.py:345-369``); stop-gradient control data."""
    eps = 1e-9
    v = [_corner(cp[axis], k).detach() for k in range(3)]
    w = [_corner(cp["w"], k).detach() for k in range(3)]
    vn = [
        vk / torch.where(wk.abs() > eps, wk, torch.full_like(wk, eps))
        for vk, wk in zip(v, w)
    ]
    bc = (w[0] <= eps) | (w[1] <= eps) | (w[2] <= eps)
    lo = torch.minimum(torch.minimum(vn[0], vn[1]), vn[2])
    hi = torch.maximum(torch.maximum(vn[0], vn[1]), vn[2])
    lo = torch.where(bc, torch.full_like(lo, -_Y_OPEN), lo)
    hi = torch.where(bc, torch.full_like(hi, _Y_OPEN), hi)
    if degenerate is not None:
        dg = degenerate[None, :]
        lo = torch.where(dg, torch.full_like(lo, _Y_OPEN), lo)
        hi = torch.where(dg, torch.full_like(hi, -_Y_OPEN), hi)
    return lo, hi


def _xbounds_ndc(cp, degenerate):
    return _axis_bounds_ndc(cp, "x", degenerate)


def _ybounds_ndc(cp, degenerate):
    return _axis_bounds_ndc(cp, "y", degenerate)


def _silhouette_planar(det: torch.Tensor, edge_adj: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, T) float silhouette bitmask (``planar.py:380-391``)."""
    if edge_adj is None:
        return torch.full_like(det, 7.0)
    facing = det.detach() > 0.0
    bits = torch.zeros(det.shape, dtype=torch.int32, device=det.device)
    for k in range(3):
        nb = edge_adj[:, k].long()
        nb_facing = facing[:, nb.clamp(min=0)]
        sil = (nb < 0)[None, :] | (nb_facing != facing)
        bits = bits | (sil.to(torch.int32) << ((k + 2) % 3))
    return bits.to(det.dtype)


def packed_planar(
    cp: Dict[str, List[torch.Tensor]],
    corner_attrs: Optional[List[List[torch.Tensor]]],
    zrot: Optional[List[torch.Tensor]],
    degenerate: torch.Tensor,
    tri_indices: torch.Tensor,
    sil: torch.Tensor,
) -> torch.Tensor:
    """(B, 32, n) packed rows from per-corner planes (``planar.py:62-195``,
    the per-corner-list form that the bin-ordered pack uses)."""
    x = [_corner(cp["x"], k) for k in range(3)]
    y = [_corner(cp["y"], k) for k in range(3)]
    z = [_corner(cp["z"], k) for k in range(3)]
    w = [_corner(cp["w"], k) for k in range(3)]

    def cross(j, k):
        return (
            y[j] * w[k] - w[j] * y[k],
            w[j] * x[k] - x[j] * w[k],
            x[j] * y[k] - y[j] * x[k],
        )

    c0 = cross(1, 2)
    c1 = cross(2, 0)
    c2 = cross(0, 1)
    det = c0[0] * x[0] + c0[1] * y[0] + c0[2] * w[0]
    keep = (~degenerate)[None, :].to(det.dtype)
    c0 = tuple(c * keep for c in c0)
    c1 = tuple(c * keep for c in c1)
    c2 = tuple(c * keep for c in c2)
    det = det * keep
    zc = tuple(z[0] * c0[i] + z[1] * c1[i] + z[2] * c2[i] for i in range(3))

    b, t = det.shape
    tri_idx = tri_indices.to(det.dtype)[None, :]
    ylo, yhi = _ybounds_ndc(cp, degenerate)
    lanes = [
        c0[0], c0[1], c0[2],
        c1[0], c1[1], c1[2],
        c2[0], c2[1], c2[2],
        zc[0], zc[1], zc[2],
        det, tri_idx, sil, torch.zeros_like(det),
    ]
    cs = (c0, c1, c2)
    if corner_attrs is not None:
        for c in range(len(corner_attrs[0])):
            a = [corner_attrs[k][c] for k in range(3)]
            for i in range(3):
                lanes.append(a[0] * cs[0][i] + a[1] * cs[1][i] + a[2] * cs[2][i])
    if zrot is not None:
        for i in range(3):
            lanes.append(
                zrot[0] * cs[0][i] + zrot[1] * cs[1][i] + zrot[2] * cs[2][i]
            )
    xlo, xhi = _xbounds_ndc(cp, degenerate)
    if len(lanes) > PACKED_WIDTH - 4:
        raise ValueError(f"too many packed lanes: {len(lanes)}")
    while len(lanes) < PACKED_WIDTH - 4:
        lanes.append(torch.zeros_like(det))
    lanes.extend([xlo, xhi, ylo, yhi])
    return torch.stack([p.expand(b, t) for p in lanes], dim=1)


def pack_planar(
    cp: Dict[str, torch.Tensor],
    corner_attrs: Optional[torch.Tensor],
    zrot: Optional[torch.Tensor],
    edge_adj: Optional[torch.Tensor],
    degenerate: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The triangle-order table of the planar route (``planar.py:62-195``
    with its defaults): (packed (B, 32, T), det (B, T)), differentiable in
    the corner planes (so in mvp) and in ``zrot``.

    Args:
        cp: interleaved corner planes (B, 3T) (:func:`corner_planes`).
        corner_attrs: (T, 3, C) per-corner attributes, (B, T, 3, C) per
            hypothesis, or None.
        zrot: (B, 3T) per-corner rotated camera z (the depth plane), or None.
        edge_adj: (T, 3) silhouette adjacency, or None (all edges).
        degenerate: (T,) bool padding-triangle mask.

    Lane 13 is the triangle index, lanes 28-31 the conservative NDC x/y
    bounds that the sorted-range raster gates on."""
    det = det_planar(cp, degenerate)
    t = det.shape[1]
    attrs = None
    if corner_attrs is not None:
        per_b = corner_attrs if corner_attrs.dim() == 4 else corner_attrs[None]
        attrs = [[per_b[:, :, k, c] for c in range(per_b.shape[-1])] for k in range(3)]
    zr = None if zrot is None else [_corner(zrot, k) for k in range(3)]
    tri_idx = torch.arange(t, device=det.device)
    packed = packed_planar(cp, attrs, zr, degenerate, tri_idx,
                           _silhouette_planar(det, edge_adj))
    return packed, det


def static_pack_rows(pc: torch.Tensor, corner_attrs: Optional[torch.Tensor],
                     degenerate: Optional[torch.Tensor]):
    """The (R, T) static per-triangle table (``planar.py:215-231``): 9
    object-space corner coordinates (row 3k + c), 3*n_ch per-corner
    attributes (row 9 + k*n_ch + c), then the degenerate mask."""
    rows = [pc[k::3, c] for k in range(3) for c in range(3)]
    n_ch = 0
    if corner_attrs is not None:
        n_ch = corner_attrs.shape[-1]
        rows += [corner_attrs[:, k, c] for k in range(3) for c in range(n_ch)]
    if degenerate is not None:
        rows.append(degenerate.to(pc.dtype))
    return torch.stack(rows, dim=0), n_ch


def _slot_gather(table: torch.Tensor, safe: torch.Tensor) -> torch.Tensor:
    """(B, R, n_slots) columns ``safe`` of a (B, R, T) table, through
    ``rasterize.gather_rows``."""
    from diffdope_tpu_torch.render.rasterize import gather_rows

    return gather_rows(table.transpose(1, 2), safe).transpose(1, 2)


def pack_binned(
    pos_c: torch.Tensor,
    mvp: torch.Tensor,
    mtx: torch.Tensor,
    idx: torch.Tensor,
    corner_attrs: Optional[torch.Tensor],
    sil: torch.Tensor,
    degenerate: Optional[torch.Tensor],
    t_count: int,
    static_table: Optional[Tuple[torch.Tensor, int]] = None,
) -> torch.Tensor:
    """The packed table directly in bin-slot order: (B, 32, n_slots)
    (``planar.py:234-335``), differentiable w.r.t. mvp and mtx.

    Args:
        pos_c: (3T, 3) corner-expanded object-space points.
        mvp/mtx: (B, 4, 4).
        idx: bin slot -> triangle (any shape; sentinel t_count).
        corner_attrs: (T, 3, C) per-corner attributes (which may carry a
            gradient), or (B, T, 3, C) per hypothesis: gathered per slot
            for every hypothesis (``planar.py:314-322``).
        sil: (B, T) silhouette bits in triangle order.
        degenerate: (T,) bool padding-triangle mask (or None).
        static_table: optional precomputed ``static_pack_rows`` result
            (without the attribute rows for per-hypothesis attributes).
    """
    flat = idx.reshape(-1).long()
    safe = flat.clamp(max=t_count - 1)
    shared = corner_attrs is not None and corner_attrs.dim() == 3
    if static_table is None:
        static_table = static_pack_rows(pos_c, corner_attrs if shared else None,
                                        degenerate)
    table, n_ch = static_table
    # the table's and the colours' slot gathers sum each triangle's slots in
    # slot order in their backward (rasterize.IndexRows)
    tab = _slot_gather(table[None], safe)[0]  # (R, n_slots)

    def row(r):
        return tab[r : r + 1, :]

    pk = [[row(3 * k + c) for c in range(3)] for k in range(3)]

    def transform(rows3, trans):
        return [
            rows3[:, 0:1] * pk[k][0]
            + rows3[:, 1:2] * pk[k][1]
            + rows3[:, 2:3] * pk[k][2]
            + trans[:, None]
            for k in range(3)
        ]

    cp_b = {
        name: transform(mvp[:, r, :3], mvp[:, r, 3])
        for name, r in (("x", 0), ("y", 1), ("z", 2), ("w", 3))
    }
    zrot_b = transform(mtx[:, 2, :3], mtx.new_zeros(mtx.shape[:1]))
    attr_b = None
    if shared:
        attr_b = [[row(9 + k * n_ch + c) for c in range(n_ch)] for k in range(3)]
    elif corner_attrs is not None:
        per_slot = _slot_gather(corner_attrs.flatten(2).transpose(1, 2), safe)
        n_c = corner_attrs.shape[-1]
        attr_b = [[per_slot[:, k * n_c + c] for c in range(n_c)] for k in range(3)]
    sil_b = sil[:, safe]
    degen_b = flat >= t_count
    if degenerate is not None:
        degen_b = degen_b | (tab[9 + 3 * n_ch, :] > 0.5)
    # lane 13 keeps the UNCLAMPED slot value: sentinel slots carry t_count,
    # distinct from every real id (``planar.py:326-331``)
    return packed_planar(cp_b, attr_b, zrot_b, degen_b, flat, sil_b)


def bin_triangles_planar(
    cp: Dict[str, torch.Tensor],
    det: torch.Tensor,
    resolution: Tuple[int, int],
    tile_hw: Tuple[int, int],
    max_tris_per_tile: int,
    cull_backfaces: bool = False,
    margin_px: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Conservative tile binning, union over the batch, y-sorted slots
    (``planar.py:394-546``, its fused-rank ordering).  ``margin_px`` widens
    every triangle's pixel bounds (``pipeline.precompute_bins``).  Inside
    :func:`union_over` the union is over every rank's hypotheses.

    ``cull_backfaces`` drops triangles that are back-facing (det <= 0) in
    every hypothesis, unless a corner is behind the camera (then the sign
    says nothing).  Valid only for closed, consistently wound meshes, where
    a back face never wins the depth test (``planar.py:415-420``).

    Returns idx (num_tiles, K_pad) int32 (sentinel T), counts
    (num_tiles,) int32 and the dropped-pair count (overflow)."""
    h, w = resolution
    th, tw = tile_hw
    nty, ntx = -(-h // th), -(-w // tw)
    eps = 1e-9
    xs = cp["x"].detach()
    ys = cp["y"].detach()
    ws = cp["w"].detach()
    safe_w = torch.where(ws.abs() > eps, ws, torch.full_like(ws, eps))
    px = (xs / safe_w + 1.0) * (w / 2.0) - 0.5
    py = (ys / safe_w + 1.0) * (h / 2.0) - 0.5
    behind_c = ws <= eps

    def minmax3(p):
        c = [_corner(p, k) for k in range(3)]
        lo = torch.minimum(torch.minimum(c[0], c[1]), c[2])
        hi = torch.maximum(torch.maximum(c[0], c[1]), c[2])
        return lo.amin(dim=0), hi.amax(dim=0)

    px_min, px_max = minmax3(px)
    py_min, py_max = minmax3(py)
    px_min, px_max = px_min - margin_px, px_max + margin_px
    py_min, py_max = py_min - margin_px, py_max + margin_px
    behind = (
        _corner(behind_c, 0) | _corner(behind_c, 1) | _corner(behind_c, 2)
    ).any(dim=0)
    nonzero, front = (det != 0.0).any(dim=0), (det > 0.0).any(dim=0)
    if _UNION_GROUP.get() is not None:
        (px_min, py_min), (px_max, py_max), (behind, nonzero, front) = _union(
            (px_min, py_min), (px_max, py_max), (behind, nonzero, front))
    valid = nonzero
    if cull_backfaces:
        valid = valid & (front | behind)

    def tile_range(lo, hi, size, n):
        a = torch.floor(lo / size).clamp(0, n - 1).to(torch.int32)
        b = torch.floor(hi / size).clamp(0, n - 1).to(torch.int32)
        return torch.where(behind, 0, a), torch.where(behind, n - 1, b)

    tx_min, tx_max = tile_range(px_min, px_max, tw, ntx)
    ty_min, ty_max = tile_range(py_min, py_max, th, nty)
    onscreen = (px_max >= 0) & (px_min <= w - 1) & (py_max >= 0) & (py_min <= h - 1)
    keep = valid & (onscreen | behind)

    t_count = det.shape[1]
    if (h + 3) * t_count >= 2 ** 31:
        raise ValueError(f"binning key overflows int32 at H={h}, T={t_count}")
    dev = det.device
    tiles_y = torch.arange(nty, dtype=torch.int32, device=dev)
    tiles_x = torch.arange(ntx, dtype=torch.int32, device=dev)
    oy = (tiles_y[:, None] >= ty_min[None, :]) & (tiles_y[:, None] <= ty_max[None, :])
    ox = (tiles_x[:, None] >= tx_min[None, :]) & (tiles_x[:, None] <= tx_max[None, :])
    mask = (oy[:, None, :] & ox[None, :, :] & keep[None, None, :]).reshape(
        nty * ntx, t_count
    )
    k = min(max_tris_per_tile, t_count)
    counts_full = mask.sum(dim=-1, dtype=torch.int32)
    counts = counts_full.clamp(max=k)
    overflow = (counts_full - k).clamp(min=0).sum(dtype=torch.int32)
    # one int32 key per (tile, triangle): (pixel-row rank, triangle index);
    # the k smallest keys are the y-sorted bin
    rank = torch.floor(py_min).clamp(-1, h).to(torch.int32) + 2
    rank = torch.where(behind, 0, rank)
    comp = rank * t_count + torch.arange(t_count, dtype=torch.int32, device=dev)[None, :]
    big = (h + 3) * t_count
    comp = torch.where(mask, comp, torch.full_like(comp, big))
    vals = torch.topk(comp, k, dim=-1, largest=False, sorted=True).values
    idx = torch.where(vals >= big, torch.full_like(vals, t_count), vals % t_count)
    k_pad = -(-k // 128) * 128
    if k_pad != k:
        idx = torch.nn.functional.pad(idx, (0, k_pad - k), value=t_count)
    return idx, counts, overflow


def compact_bins(
    idx: torch.Tensor,
    counts: torch.Tensor,
    t_count: int,
    k_chunk: int,
    total: int,
):
    """Fixed-K bins -> one flat chunk-aligned slot array
    (``planar.py:549-613``).

    Returns flat (total,) int32 slot -> triangle (sentinel padding),
    off_chunks (nt,) int32, used (nt,) int32 chunk counts, and the number
    of real slots dropped because ``total`` was too small.
    """
    if total % k_chunk:
        raise ValueError(f"total {total} must be a multiple of k_chunk {k_chunk}")
    nt, k = idx.shape
    dev = idx.device
    counts = counts.clamp(max=k)
    cnt_pad = torch.clamp(-(-counts // k_chunk) * k_chunk, max=k)
    off = torch.cat(
        [torch.zeros(1, dtype=torch.int32, device=dev),
         torch.cumsum(cnt_pad, 0)[:-1].to(torch.int32)]
    )
    fits = off + cnt_pad <= total
    used = torch.where(
        fits, cnt_pad // k_chunk,
        torch.clamp(torch.minimum(total - off, cnt_pad), min=0) // k_chunk,
    ).to(torch.int32)
    off_c = (off.clamp(max=total) // k_chunk).to(torch.int32)
    i = torch.arange(k, dtype=torch.int32, device=dev)[None, :]
    pos = off[:, None] + i
    valid = (i < cnt_pad[:, None]) & (pos < total)
    rej = total + torch.arange(nt * k, dtype=torch.int32, device=dev).reshape(nt, k)
    pos = torch.where(valid, pos, rej)
    buf = torch.full((total + nt * k,), t_count, dtype=torch.int32, device=dev)
    buf.scatter_(0, pos.reshape(-1).long(), idx.reshape(-1).to(torch.int32))
    flat = buf[:total]
    overflow = ((i < counts[:, None]) & (pos >= total)).sum(dtype=torch.int32)
    return flat, off_c, used, overflow
