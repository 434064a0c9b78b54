"""The sorted-range raster (K10): the planar route of ``DD_RASTER=v3``.

Counterpart of ``diffdope_tpu/render/raster_v3.py``.  The triangles of a
(B, 32, T) triangle-order table (``planar.pack_planar``) are sorted once a
call by (pixel-row band, x_min) of their bounds, unioned over the batch;
the tiles of a tile row then find every candidate in one contiguous range
of chunks of the sorted table, [clo[ty], chi[ty]), and a chunk whose row
interval misses a tile (its x range too) is skipped there.  No bin lists,
no K cap, no overflow, no back-face cull: the cap-free fallback for scenes
where bins would overflow.

- :func:`_prepare` (``raster_v3.py:77-158``), plain torch control data:
  the sort ``order`` and its inverse ``rank``, ``clo``/``chi`` per tile
  row and the per-(tile, chunk) row intervals ``rlo_tc``/``rhi_tc``
  (empty where the chunk's x range misses the tile).  The band is 4 px.
- K10 forward (:func:`raster_v3_fwd`): per (tile, hypothesis) the (z, id)
  lexicographic minimum over the gated chunks, K3's operation order and
  tie rule, so ids and rows are those of the bin-table routes over the
  same table (the reference holds v3 and v2 bit-equal).  Outputs ids
  (+1, 0 = background), rows and win, the winner's sorted-table slot.
- K10 backward (:func:`raster_v3_bwd`): d_packed_s (B, 32, T_pad) = for
  each sorted slot the sum of d_rows over the pixels it wins; the op
  unpermutes it with ``rank``.

The wrappers take their plain versions for CPU tensors and launch the
kernels for CUDA tensors (the forward is K3's body over the gated chunks,
``csrc/raster.cu``; the backward ``csrc/raster_v3.cu``); any other device
raises.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from diffdope_tpu_torch import kernels
from diffdope_tpu_torch.render.planar import XHI_LANE, XLO_LANE, YHI_LANE, YLO_LANE
from diffdope_tpu_torch.render.raster import (
    _check,
    _frame_tiles,
    _raster_plain,
    raster_bwd_plain,
)
from diffdope_tpu_torch.render.shade import PACKED_WIDTH

#: sort-key row band (pixels), the reference's default
BAND_PX = 4
#: sorted-table chunk (slots): the K10 kernels gate one chunk at a time,
#: and the backward sums one chunk's slots a thread block
K_CHUNK = 128
#: the tile the kernels take (the plain versions take any)
_KERNEL_TILE = (16, 16)
_EMPTY_KEY = 2 ** 30


class Tables(NamedTuple):
    """The sort and gating tables of one call (all control data)."""

    order: torch.Tensor  # (T,) int64: sorted slot -> triangle
    rank: torch.Tensor  # (T,) int64: triangle -> sorted slot
    clo: torch.Tensor  # (nty,) int32: first chunk of a tile row
    chi: torch.Tensor  # (nty,) int32: one past its last chunk
    rlo_tc: torch.Tensor  # (num_tiles, nc) int32: pixel-row interval per
    rhi_tc: torch.Tensor  # (tile, chunk), empty (h, -1) off the tile's x range
    k_chunk: int
    t_pad: int


def _sizes(t_count: int) -> Tuple[int, int]:
    """(k_chunk, T padded to whole chunks)."""
    return K_CHUNK, -(-t_count // K_CHUNK) * K_CHUNK


@torch.no_grad()
def _prepare(packed: torch.Tensor, resolution, tile_hw, k_chunk: int, t_pad: int):
    """(order, rank, clo, chi, rlo_tc, rhi_tc) of a (B, 32, T) table
    (``raster_v3.py:77-158``): the (band, x_min) sort, stable, of the
    triangles' pixel bounds unioned over the batch; per tile row the range
    of chunks that can cover it; per (tile, chunk) the chunk's row
    interval, empty where its x range misses the tile."""
    h, w = resolution
    th, tw = tile_hw
    nty, ntx = -(-h // th), -(-w // tw)
    t_count = packed.shape[2]
    dev = packed.device

    def px_bounds(lo_lane, hi_lane, extent):
        lo_n = packed[:, lo_lane, :].amin(dim=0)  # union over the batch
        hi_n = packed[:, hi_lane, :].amax(dim=0)
        lo = torch.ceil((lo_n + 1.0) * (extent / 2.0) - 1.0)
        hi = torch.floor((hi_n + 1.0) * (extent / 2.0))
        return (lo.clamp(-1, extent).to(torch.int64),
                hi.clamp(-1, extent).to(torch.int64))

    rlo_t, rhi_t = px_bounds(YLO_LANE, YHI_LANE, h)
    xlo_t, xhi_t = px_bounds(XLO_LANE, XHI_LANE, w)

    # empty intervals (degenerate padding) sort last and enter no range;
    # behind-camera (open) intervals sort first
    empty = rlo_t > rhi_t
    band = torch.clamp(rlo_t // BAND_PX, 0, h // BAND_PX + 1)
    key = band * (w + 4) + torch.clamp(xlo_t, -1, w + 1) + 1
    key = torch.where(empty, _EMPTY_KEY, key)
    order = torch.argsort(key, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t_count, device=dev)

    def padded(a, fill):
        return torch.nn.functional.pad(a, (0, t_pad - t_count), value=fill)

    rlo_s = padded(rlo_t[order], h)
    rhi_s = padded(rhi_t[order], -1)
    xlo_s = padded(xlo_t[order], w)
    xhi_s = padded(xhi_t[order], -1)
    band_s = padded(torch.where(empty, _EMPTY_KEY, band)[order], _EMPTY_KEY)

    nc = t_pad // k_chunk
    rlo_c = rlo_s.reshape(nc, k_chunk).amin(dim=1)
    rhi_c = torch.where(rlo_s > rhi_s, -1, rhi_s).reshape(nc, k_chunk).amax(dim=1)
    xlo_c = xlo_s.reshape(nc, k_chunk).amin(dim=1)
    xhi_c = torch.where(xlo_s > xhi_s, -1, xhi_s).reshape(nc, k_chunk).amax(dim=1)

    # tile row ty's candidates are [lo_ty, hi_ty) of the sorted order: hi by
    # the band key (band_s ascends), lo the first triangle reaching its top
    ty = torch.arange(nty, device=dev)
    bottom_band = ((ty + 1) * th - 1) // BAND_PX
    hi_ty = torch.searchsorted(band_s, bottom_band, right=True)
    reach = rhi_s[None, :] >= (ty[:, None] * th)  # (nty, T_pad)
    lo_ty = torch.where(reach.any(dim=1), reach.to(torch.int8).argmax(dim=1), hi_ty)
    lo_ty = torch.minimum(lo_ty, hi_ty)
    clo = lo_ty // k_chunk
    chi = -(-hi_ty // k_chunk)

    tx = torch.arange(ntx, device=dev)
    x_over = ((xlo_c[None, :] <= (tx[:, None] + 1) * tw - 1)
              & (xhi_c[None, :] >= tx[:, None] * tw))  # (ntx, nc)
    x_over = x_over.repeat(nty, 1)  # tiles are row-major: t = ty*ntx + tx
    rlo_tc = torch.where(x_over, rlo_c[None, :], h)
    rhi_tc = torch.where(x_over, rhi_c[None, :], -1)
    i32 = torch.int32
    return (order, rank, clo.to(i32).contiguous(), chi.to(i32).contiguous(),
            rlo_tc.to(i32).contiguous(), rhi_tc.to(i32).contiguous())


def prepare(packed: torch.Tensor, resolution, tile_hw) -> Tables:
    """The :class:`Tables` of a (B, 32, T) table at ``tile_hw``."""
    k_chunk, t_pad = _sizes(packed.shape[2])
    return Tables(*_prepare(packed, resolution, tile_hw, k_chunk, t_pad), k_chunk, t_pad)


def sorted_table(packed: torch.Tensor, tables: Tables) -> torch.Tensor:
    """The table in sorted order, padded with zero slots (det 0, never
    covered) to whole chunks: (B, 32, T_pad)."""
    packed_s = packed.index_select(2, tables.order)
    return torch.nn.functional.pad(packed_s, (0, tables.t_pad - packed.shape[2]))


def _gate(tables: Tables, nty: int, ntx: int, th: int) -> torch.Tensor:
    """(num_tiles, nc) bool: the chunks K10 walks at each tile, in the
    kernels' rule: inside the tile row's [clo, chi) and a row interval that
    is not empty and meets the tile's rows."""
    nc = tables.rlo_tc.shape[1]
    dev = tables.clo.device
    c = torch.arange(nc, device=dev)
    ty = torch.arange(nty * ntx, device=dev) // ntx
    in_range = ((c[None, :] >= tables.clo.long()[ty, None])
                & (c[None, :] < tables.chi.long()[ty, None]))
    lo, hi = tables.rlo_tc.long(), tables.rhi_tc.long()
    y0 = (ty * th)[:, None]
    return in_range & (lo <= hi) & (lo <= y0 + th - 1) & (hi >= y0)


def cover_ranges(packed_s: torch.Tensor, resolution, padded_hw):
    """(rlo, rhi, clo, chi), int64 (B, n_slots): the frame pixel rows and
    columns at which each slot of a table (B, 32, n_slots) can be covered,
    taken from its f32 edge planes, pre-signed by sign(det) as K3's test
    takes them: the plain twin of K10's staging rule (``cover_range`` in
    ``csrc/raster.cu``), in float64.  A test e_k = x*a_k + (y*b_k + c_k) >= 0
    in f32 means an exact e_k >= -4u (xm |a_k| + ym |b_k| + |c_k|) (u the
    f32 unit roundoff, |x| <= xm, |y| <= ym over the padded frame), so the
    pixel lies in the triangle the three relaxed lines bound; its corners'
    box, a hundredth of a pixel wider, gives the rows and columns.  Lines that bound no
    triangle, or non-finite corners, give every pixel (+-2**20); det == 0,
    which covers no pixel, an empty box (2**20, -2**20).  Unlike the vertex
    bounds of lanes 28-31 (``raster.slot_ranges``), this holds for slivers,
    whose f32 planes can cover pixels past their corners.  K3/K7 (their
    window padded_hw from the frame's origin) and K8/K9 (setup rows,
    transposed to (B, 16, T)) stage by the same boxes."""
    (h, w), (hp, wp) = resolution, padded_hw
    xm, ym = max(1.0, (2.0 * wp - 1.0) / w - 1.0), max(1.0, (2.0 * hp - 1.0) / h - 1.0)
    far = 2.0 ** 20
    sg = torch.where(packed_s[:, 12] > 0.0, 1.0, -1.0)
    a, b, c = ([(packed_s[:, 3 * k + m] * sg).double() for k in range(3)] for m in range(3))
    cc = [c[k] + 4.0 * 2.0 ** -24 * (xm * a[k].abs() + ym * b[k].abs() + c[k].abs())
          for k in range(3)]
    d, cx, cy = [], [], []
    for k in range(3):
        j = (k + 1) % 3
        d.append(a[k] * b[j] - a[j] * b[k])
        cx.append((b[k] * cc[j] - b[j] * cc[k]) / d[k])
        cy.append((a[j] * cc[k] - a[k] * cc[j]) / d[k])
    d, cx, cy = torch.stack(d), torch.stack(cx), torch.stack(cy)
    bounded = (d > 0).all(dim=0) | (d < 0).all(dim=0)
    finite = ((cx.abs() < far) & (cy.abs() < far)).all(dim=0)
    every = ~(bounded & finite)

    empty = packed_s[:, 12] == 0.0

    def px(v, lo):
        v = torch.where(every, -far if lo else far, v.clamp(-far, far))
        return torch.where(empty, far if lo else -far, v).long()

    # pixel r's NDC is (2r + 1)/n - 1, within a thousandth of a pixel in f32
    x0, x1 = cx.amin(dim=0), cx.amax(dim=0)
    y0, y1 = cy.amin(dim=0), cy.amax(dim=0)
    return (px(torch.floor(((y0 + 1.0) * h - 1.0) * 0.5 - 0.01), True),
            px(torch.ceil(((y1 + 1.0) * h - 1.0) * 0.5 + 0.01), False),
            px(torch.floor(((x0 + 1.0) * w - 1.0) * 0.5 - 0.01), True),
            px(torch.ceil(((x1 + 1.0) * w - 1.0) * 0.5 + 0.01), False))


def _check_tables(packed_s, tables: Tables, resolution, tile_hw):
    _check(packed_s, "packed_s", torch.float32, 3, packed_s.device)
    if packed_s.shape[1] != PACKED_WIDTH or packed_s.shape[2] != tables.t_pad:
        raise ValueError(f"packed_s {tuple(packed_s.shape)}: expected (B, "
                         f"{PACKED_WIDTH}, {tables.t_pad})")
    (h, w), (th, tw) = resolution, tile_hw
    nty, ntx = -(-h // th), -(-w // tw)
    nc = tables.t_pad // tables.k_chunk
    for t, name, shape in ((tables.clo, "clo", (nty,)), (tables.chi, "chi", (nty,)),
                           (tables.rlo_tc, "rlo_tc", (nty * ntx, nc)),
                           (tables.rhi_tc, "rhi_tc", (nty * ntx, nc))):
        _check(t, name, torch.int32, len(shape), packed_s.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    return nty, ntx


def raster_v3_fwd(packed_s: torch.Tensor, tables: Tables, resolution: Tuple[int, int],
                  tile_hw: Tuple[int, int]):
    """K10 forward over the padded frame: (ids (B, Hp, Wp) int32, rows
    (B, 32, Hp, Wp), win (B, Hp, Wp) int32 sorted slot, -1 background).

    CPU tensors take :func:`raster_v3_fwd_plain`; CUDA tensors launch the
    kernel (csrc/raster.cu), anything else raises."""
    nty, ntx = _check_tables(packed_s, tables, resolution, tile_hw)
    if packed_s.device.type == "cpu":
        return raster_v3_fwd_plain(packed_s, tables, resolution, tile_hw)
    if packed_s.device.type != "cuda":
        raise ValueError(f"raster_v3_fwd: unsupported device {packed_s.device}")
    (h, w), (th, tw) = resolution, tile_hw
    if tuple(tile_hw) != _KERNEL_TILE or tables.k_chunk != K_CHUNK:
        raise ValueError(f"K10 takes {_KERNEL_TILE} tiles and chunks of {K_CHUNK} "
                         f"(tile {tile_hw}, chunk {tables.k_chunk})")
    if max(nty * th, ntx * tw) >= 2 ** 15:
        raise ValueError(f"K10's forward takes frames below {2 ** 15} pixels a side")
    b = packed_s.shape[0]
    dev = packed_s.device
    ids = torch.empty((b, nty * th, ntx * tw), dtype=torch.int32, device=dev)
    win = torch.empty_like(ids)
    rows = torch.empty((b, PACKED_WIDTH, nty * th, ntx * tw), dtype=torch.float32,
                       device=dev)
    boxes = torch.empty((b, tables.t_pad, 2), dtype=torch.int32, device=dev)  # scratch
    kernels.launch(
        "dd_raster_v3_fwd", "raster_v3_fwd",
        packed_s.data_ptr(), tables.clo.data_ptr(), tables.chi.data_ptr(),
        tables.rlo_tc.data_ptr(), tables.rhi_tc.data_ptr(),
        b, tables.t_pad, nty, ntx, th, tw, h, w,
        ids.data_ptr(), win.data_ptr(), rows.data_ptr(), boxes.data_ptr(),
    )
    return ids, rows, win


def raster_v3_fwd_plain(packed_s, tables: Tables, resolution, tile_hw,
                        slot_chunk: int = 64):
    """Plain torch K10 forward: K3's plain raster, each tile walking the
    slots of the chunks K10 walks there (:func:`_gate`) in ascending
    order."""
    nty, ntx = _check_tables(packed_s, tables, resolution, tile_hw)
    (h, w), (th, tw) = resolution, tile_hw
    kc = tables.k_chunk
    gate = _gate(tables, nty, ntx, th)
    nc = gate.shape[1]
    c = torch.arange(nc, device=gate.device)
    chunks = torch.where(gate, c[None, :], nc).sort(dim=1).values  # gated first
    chunks = chunks[:, :int(gate.sum(dim=1).max()) if gate.numel() else 0]
    slots = (chunks[:, :, None] * kc
             + torch.arange(kc, device=gate.device)[None, None, :]).reshape(nty * ntx, -1)
    valid = (chunks < nc)[:, :, None].expand(-1, -1, kc).reshape(nty * ntx, -1)
    return _raster_plain(packed_s, slots, valid, (nty * th, ntx * tw), tile_hw,
                         (0, 0, h, w), slot_chunk)


def raster_v3_bwd(d_rows: torch.Tensor, win: torch.Tensor, tables: Tables,
                  tile_hw: Tuple[int, int]) -> torch.Tensor:
    """K10 backward: d_packed_s (B, 32, T_pad), for each sorted slot the
    sum of d_rows (B, 32, Hp, Wp) over the pixels it wins (zeros
    elsewhere).

    CPU tensors take :func:`raster_v3_bwd_plain`; CUDA tensors launch the
    kernel (csrc/raster_v3.cu), anything else raises."""
    _check(d_rows, "d_rows", torch.float32, 4, d_rows.device)
    _check(win, "win", torch.int32, 3, d_rows.device)
    b, width, hp, wp = d_rows.shape
    if width != PACKED_WIDTH or tuple(win.shape) != (b, hp, wp):
        raise ValueError(f"d_rows {tuple(d_rows.shape)} / win {tuple(win.shape)}")
    nty, ntx = _frame_tiles((hp, wp), tile_hw)
    nc = tables.t_pad // tables.k_chunk
    if tuple(tables.rlo_tc.shape) != (nty * ntx, nc):
        raise ValueError(f"rlo_tc {tuple(tables.rlo_tc.shape)}: expected "
                         f"{(nty * ntx, nc)}")
    if d_rows.device.type == "cpu":
        return raster_v3_bwd_plain(d_rows, win, tables.t_pad)
    if d_rows.device.type != "cuda":
        raise ValueError(f"raster_v3_bwd: unsupported device {d_rows.device}")
    th, tw = tile_hw
    if tuple(tile_hw) != _KERNEL_TILE or tables.k_chunk != K_CHUNK:
        raise ValueError(f"K10 takes {_KERNEL_TILE} tiles and chunks of {K_CHUNK} "
                         f"(tile {tile_hw}, chunk {tables.k_chunk})")
    if d_rows.data_ptr() % 16:
        raise ValueError("raster_v3_bwd: d_rows must be 16-byte aligned (float4 loads)")
    d_packed_s = torch.empty((b, PACKED_WIDTH, tables.t_pad), dtype=torch.float32,
                             device=d_rows.device)
    kernels.launch(
        "dd_raster_v3_bwd", "raster_v3_bwd",
        d_rows.data_ptr(), win.data_ptr(), tables.clo.data_ptr(),
        tables.chi.data_ptr(), tables.rlo_tc.data_ptr(), tables.rhi_tc.data_ptr(),
        b, tables.t_pad, nty, ntx, th, tw, d_packed_s.data_ptr(),
    )
    return d_packed_s


def raster_v3_bwd_plain(d_rows, win, t_pad: int) -> torch.Tensor:
    """Plain torch K10 backward: K4's plain per-slot sum over the sorted
    slots."""
    return raster_bwd_plain(d_rows, win, t_pad)


class RasterV3(torch.autograd.Function):
    """(ids, rows) of the sorted-range raster over the padded frame,
    differentiable in the triangle-order table: the sort tables, the
    sorted table, K10 forward; backward K10, then d_packed unpermuted by
    ``rank`` (``raster_v3.py:475-537``).  ids are not differentiable."""

    @staticmethod
    def forward(ctx, packed, resolution, tile_hw):
        tables = prepare(packed, resolution, tile_hw)
        ids, rows, win = raster_v3_fwd(sorted_table(packed, tables), tables,
                                       resolution, tile_hw)
        ctx.save_for_backward(win)
        ctx.tables, ctx.tile_hw, ctx.t_count = tables, tile_hw, packed.shape[2]
        ctx.mark_non_differentiable(ids)
        return ids, rows

    @staticmethod
    def backward(ctx, d_ids, d_rows):
        (win,) = ctx.saved_tensors
        d_packed_s = raster_v3_bwd(d_rows.contiguous(), win, ctx.tables, ctx.tile_hw)
        return d_packed_s[:, :, :ctx.t_count].index_select(2, ctx.tables.rank), None, None


def raster_gather_rows_v3(packed: torch.Tensor, resolution: Tuple[int, int],
                          tile_hw: Tuple[int, int], padded: bool = False):
    """Sorted-range rasterize + row gather (``raster_v3.py:373``).

    Args:
        packed: (B, 32, T) triangle-order table with the x/y bound lanes
            (``planar.pack_planar``), differentiable.
        resolution: (H, W).  tile_hw: the raster tile, at most 1024 pixels.
        padded: return the frame padded to whole tiles.

    Returns ids (B, H, W) int32 (+1, 0 = background) and rows
    (B, 32, H, W)."""
    ids, rows = RasterV3.apply(packed.contiguous(), tuple(resolution), tuple(tile_hw))
    if padded:
        return ids, rows
    h, w = resolution
    return ids[:, :h, :w], rows[:, :, :h, :w]
