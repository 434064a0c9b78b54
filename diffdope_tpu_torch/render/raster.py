"""Bin-table raster forward and backward: the compact table (K3, K4) and
the uniform-K table (K7), also over bins gathered from a triangle-order
table (the ``DD_BINNED=0`` route, :class:`RasterV2`).

Counterpart of ``diffdope_tpu/render/raster_v2.py``: for the compact table
``_fwd_from_bins_compact`` (:1827), ``_compact_dbins`` (:2033) and their
autograd pairing ``raster_gather_rows_compact`` (:1963, here
:class:`RasterCompact`); for the uniform table ``_fwd_from_bins`` (:1480),
``_dbin_flat`` with ``zero_tail`` (:1614) and their pairing
``raster_gather_rows_binned`` (:1733, here :class:`RasterBinned`).  Each
operation has a plain torch version (used for CPU tensors, and as the
reference the CUDA kernel is held to) and a wrapper that launches the
hand-written kernel in ``csrc/raster.cu`` for CUDA tensors.

Both tables hold (B, 32, n_slots) packed rows in bin-slot order
(``planar.pack_binned``).  In the compact table (``planar.compact_bins``)
tile t owns slots [off_c[t]*k_chunk, off_c[t]*k_chunk + counts[t]),
clamped to used[t]*k_chunk; in the uniform table (the bins of
``planar.bin_triangles_planar`` as they are, K slots a tile) it owns
[t*K, t*K + min(counts[t], K)).  Tiles are (th, tw) pixels in row-major
order over a (hc, wc) frame window at ``roi=(oy, ox, fh, fw)`` of the full
(fh, fw) frame; pixel NDC always comes from the full frame.  The uniform
table covers the whole frame, padded to whole tiles, and has no window.
The reference bins the uniform table on 128-wide super-tiles of
``128 // tw`` sub-tiles; the sub-tiles are row-major over a frame whose
width is padded to 128, so its bins are the port's with the padding
columns' tiles added (tests/test_torch_raster_uniform.py holds the two
tile orders to each other).

Per pixel the winner is the minimum z among covered slots with
|z| <= 1, smallest triangle id on exact ties.  Outputs: ids (+1, 0 =
background), the winner's 32 lanes (rows, zeros on background), and the
winner's slot index (win, -1 on background), which is K4's map.
"""

from __future__ import annotations

from typing import Tuple

import torch

from diffdope_tpu_torch import kernels
from diffdope_tpu_torch.render.shade import PACKED_WIDTH, ndc

_ID_LANES = 14  # lanes 0..12 drive coverage and z, lane 13 the tie break
_BIG = 1e9


def _frame_tiles(frame_hw, tile_hw):
    hc, wc = frame_hw
    th, tw = tile_hw
    if hc % th or wc % tw:
        raise ValueError(f"frame {frame_hw} is not a multiple of tile {tile_hw}")
    return hc // th, wc // tw


def _check(t: torch.Tensor, name: str, dtype, dim: int, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name}: expected {dim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_fwd_inputs(bins, counts, off_c, used, frame_hw, tile_hw):
    _check(bins, "bins", torch.float32, 3, bins.device)
    if bins.shape[1] != PACKED_WIDTH:
        raise ValueError(f"bins: expected {PACKED_WIDTH} lanes, got {bins.shape[1]}")
    nty, ntx = _frame_tiles(frame_hw, tile_hw)
    for t, name in ((counts, "counts"), (off_c, "off_c"), (used, "used")):
        _check(t, name, torch.int32, 1, bins.device)
        if t.shape[0] != nty * ntx:
            raise ValueError(f"{name}: {t.shape[0]} tiles, expected {nty * ntx}")
    return nty, ntx


#: pixels of one tile row per thread of the K3/K7 forward (csrc/raster.cu)
_FWD_PIX = 4


def _check_fwd_tile(tile_hw) -> None:
    th, tw = tile_hw
    if tw % _FWD_PIX or th * tw > 1024 * _FWD_PIX:
        raise ValueError(f"tile {tile_hw}: the forward kernel takes a width that is a "
                         f"multiple of {_FWD_PIX} and at most {1024 * _FWD_PIX} pixels")


def slot_ranges(bins: torch.Tensor, frame_hw: Tuple[int, int]):
    """(rlo, rhi, clo, chi), int64 (B, n_slots): the first and last frame
    pixel row and column of each slot of a table (B, 32, n_slots) by its
    vertex bounds (lanes 28-31) and the reference's rule with half a row
    of slack (``raster_v2.py:1346-1377``, by which its TPU kernel gates
    chunks): rows ceil((ylo + 1) h/2 - 1) to floor((yhi + 1) h/2), clamped
    to [-1, h] with NaN widening to the frame; columns the same over the
    frame width.  Slots with det == 0, which no pixel covers, get an empty
    range (rlo h, rhi -1).  These miss a sliver's f32 coverage past its
    corners and the padding past the frame's edge: the kernels stage by
    ``raster_v3.cover_ranges`` instead; the premise tests hold the two
    apart."""
    h, w = frame_hw

    def first(lo, n):
        v = (lo + 1.0) * (n / 2) - 1.0
        v = torch.where(v > -1.0, v, -1.0)  # NaN and below the frame
        return torch.where(v < n, torch.ceil(v), float(n)).long()

    def last(hi, n):
        v = (hi + 1.0) * (n / 2)
        v = torch.where(v < n, v, float(n))  # NaN and past the frame
        return torch.where(v > -1.0, torch.floor(v), -1.0).long()

    empty = bins[:, 12] == 0.0
    rlo = torch.where(empty, h, first(bins[:, 30], h))
    rhi = torch.where(empty, -1, last(bins[:, 31], h))
    return rlo, rhi, first(bins[:, 28], w), last(bins[:, 29], w)


def raster_fwd(
    bins: torch.Tensor,
    counts: torch.Tensor,
    off_c: torch.Tensor,
    used: torch.Tensor,
    k_chunk: int,
    frame_hw: Tuple[int, int],
    tile_hw: Tuple[int, int],
    roi: Tuple[int, int, int, int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: (ids (B,hc,wc) int32, rows (B,32,hc,wc) f32, win (B,hc,wc) int32).

    CPU tensors take :func:`raster_fwd_plain`; CUDA tensors launch the
    kernel (csrc/raster.cu), anything else raises."""
    nty, ntx = _check_fwd_inputs(bins, counts, off_c, used, frame_hw, tile_hw)
    if bins.device.type == "cpu":
        return raster_fwd_plain(
            bins, counts, off_c, used, k_chunk, frame_hw, tile_hw, roi
        )
    if bins.device.type != "cuda":
        raise ValueError(f"raster_fwd: unsupported device {bins.device}")
    _check_fwd_tile(tile_hw)
    th, tw = tile_hw
    b, _, tot = bins.shape
    hc, wc = frame_hw
    oy, ox, fh, fw = roi
    ids = torch.empty((b, hc, wc), dtype=torch.int32, device=bins.device)
    win = torch.empty_like(ids)
    rows = torch.empty((b, PACKED_WIDTH, hc, wc), dtype=torch.float32,
                       device=bins.device)
    kernels.launch(
        "dd_raster_fwd", "raster_fwd",
        bins.data_ptr(), counts.data_ptr(), off_c.data_ptr(), used.data_ptr(),
        b, tot, k_chunk, nty, ntx, th, tw, oy, ox, fh, fw,
        ids.data_ptr(), win.data_ptr(), rows.data_ptr(),
    )
    return ids, rows, win


def raster_fwd_plain(bins, counts, off_c, used, k_chunk, frame_hw, tile_hw,
                     roi, slot_chunk: int = 64):
    """Plain torch K3: every pixel of a tile against every slot of its
    tile, in slot chunks, keeping the (z, id) lexicographic minimum."""
    n = torch.minimum(counts, used * k_chunk).long()
    base = off_c.long() * k_chunk
    return _raster_plain(bins, *_ranges(base, n), frame_hw, tile_hw, roi, slot_chunk)


def _ranges(base: torch.Tensor, n: torch.Tensor):
    """(slots (nt, S), valid (nt, S)) of the slot ranges [base[t], base[t] +
    n[t]), S the longest."""
    j = torch.arange(int(n.max()) if n.numel() else 0, device=base.device)
    return base[:, None] + j[None, :], j[None, :] < n[:, None]


def _raster_plain(bins, slots, valid, frame_hw, tile_hw, roi, slot_chunk):
    """The plain raster of K3, K7 and K10: tile t walks the slots
    ``slots[t]`` where ``valid[t]``, ``slot_chunk`` columns at a time."""
    b, _, tot = bins.shape
    nty, ntx = _frame_tiles(frame_hw, tile_hw)
    hc, wc = frame_hw
    th, tw = tile_hw
    oy, ox, fh, fw = roi
    dev = bins.device
    nt, npx = nty * ntx, th * tw

    # pixel coordinates per (tile, pixel-in-tile), global NDC
    ti = torch.arange(nt, device=dev)
    pi = torch.arange(npx, device=dev)
    prow = (ti // ntx)[:, None] * th + (pi // tw)[None, :]  # (nt, npx)
    pcol = (ti % ntx)[:, None] * tw + (pi % tw)[None, :]
    x = ndc(pcol + ox, fw)[..., None]  # (nt, npx, 1)
    y = ndc(prow + oy, fh)[..., None]

    smax = slots.shape[1]
    inf = torch.tensor(float("inf"), device=dev)
    big = torch.tensor(_BIG, device=dev)

    ids = torch.zeros((b, hc, wc), dtype=torch.int32, device=dev)
    win = torch.full((b, hc, wc), -1, dtype=torch.int32, device=dev)
    rows = torch.zeros((b, PACKED_WIDTH, hc, wc), dtype=torch.float32, device=dev)
    flat_pix = (prow * wc + pcol).reshape(-1)
    for bi in range(b):
        zb = torch.full((nt, npx), float("inf"), device=dev)
        ib = torch.full((nt, npx), _BIG, device=dev)
        sb = torch.full((nt, npx), -1, dtype=torch.long, device=dev)
        for s0 in range(0, smax, slot_chunk):
            slot = slots[:, s0:s0 + slot_chunk]  # (nt, ch)
            in_tile = valid[:, s0:s0 + slot_chunk]
            lanes = bins[bi, :_ID_LANES][:, slot.clamp(max=tot - 1)]  # (14, nt, ch)
            lanes = lanes[:, :, None, :]  # (14, nt, 1, ch)
            det = lanes[12]
            sgn = torch.sign(det)
            e = [
                x * (lanes[3 * m] * sgn) + (y * (lanes[3 * m + 1] * sgn)
                                            + lanes[3 * m + 2] * sgn)
                for m in range(3)
            ]
            zlin = x * lanes[9] + (y * lanes[10] + lanes[11])
            covered = (e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0)
            inv_det = 1.0 / torch.where(det != 0.0, det, torch.ones_like(det))
            z = zlin * inv_det
            ok = covered & (z >= -1.0) & (z <= 1.0) & (det != 0.0) & in_tile[:, None, :]
            zm = torch.where(ok, z, inf)
            z_c = zm.amin(dim=-1)
            ids_f = lanes[13].expand_as(zm)
            at_min = zm == z_c[..., None]
            id_c = torch.where(at_min, ids_f, big).amin(dim=-1)
            s_c = torch.where(
                at_min & (ids_f == id_c[..., None]),
                slot[:, None, :].expand_as(zm), torch.full_like(zm, -1, dtype=torch.long),
            ).amax(dim=-1)
            better = z_c < zb
            same = (z_c == zb) & (z_c < inf) & (id_c < ib)
            take = better | same
            zb = torch.where(take, z_c, zb)
            ib = torch.where(take, id_c, ib)
            sb = torch.where(take, s_c, sb)
        fg = ib < _BIG
        ids.view(b, -1)[bi, flat_pix] = torch.where(
            fg, ib.to(torch.int32) + 1, 0
        ).reshape(-1)
        win.view(b, -1)[bi, flat_pix] = torch.where(fg, sb, -1).to(torch.int32).reshape(-1)
        gathered = bins[bi][:, sb.clamp(min=0).reshape(-1)]  # (32, nt*npx)
        gathered = torch.where(fg.reshape(1, -1), gathered, 0.0)
        rows.view(b, PACKED_WIDTH, -1)[bi][:, flat_pix] = gathered
    return ids, rows, win


#: the tile of the K4/K7 backward kernel (csrc/raster.cu): one thread a
#: pixel, 256 keys sorted a block
_BWD_TILE = (16, 16)


def _check_bwd_tile(tile_hw) -> None:
    if tuple(tile_hw) != _BWD_TILE:
        raise ValueError(f"tile {tile_hw}: the backward kernel takes {_BWD_TILE} tiles")


def raster_bwd(
    d_rows: torch.Tensor,
    win: torch.Tensor,
    n_slots: int,
    tile_hw: Tuple[int, int],
    off_c: torch.Tensor,
    used: torch.Tensor,
    k_chunk: int,
) -> torch.Tensor:
    """K4: d_bins (B, 32, n_slots) f32 = for each slot, the sum of d_rows
    over the pixels whose winner it is (zeros elsewhere).  d_rows is f32
    or bf16 (the spanning op's default lane), summed in f32.  ``off_c``,
    ``used`` and ``k_chunk`` are the compact table's: tile t holds the
    chunks [off_c[t], off_c[t] + used[t]), and the kernel writes every slot
    (its held chunks by the tile, the tail past them by extra blocks), so
    d_bins is allocated without a zero fill.

    CPU tensors take :func:`raster_bwd_plain`; CUDA tensors launch the
    kernel (csrc/raster.cu; bf16 d_rows its bf16 instantiation, counted
    apart), anything else raises."""
    bf16 = d_rows.dtype == torch.bfloat16
    _check(d_rows, "d_rows", torch.bfloat16 if bf16 else torch.float32, 4, d_rows.device)
    _check(win, "win", torch.int32, 3, d_rows.device)
    b, width, hc, wc = d_rows.shape
    if width != PACKED_WIDTH or tuple(win.shape) != (b, hc, wc):
        raise ValueError(f"d_rows {tuple(d_rows.shape)} / win {tuple(win.shape)}")
    nty, ntx = _frame_tiles((hc, wc), tile_hw)
    for t, name in ((off_c, "off_c"), (used, "used")):
        _check(t, name, torch.int32, 1, d_rows.device)
        if t.shape[0] != nty * ntx:
            raise ValueError(f"{name}: {t.shape[0]} tiles, expected {nty * ntx}")
    if d_rows.device.type == "cpu":
        return raster_bwd_plain(d_rows, win, n_slots)
    if d_rows.device.type != "cuda":
        raise ValueError(f"raster_bwd: unsupported device {d_rows.device}")
    _check_bwd_tile(tile_hw)
    th, tw = tile_hw
    d_bins = torch.empty((b, PACKED_WIDTH, n_slots), dtype=torch.float32,
                         device=d_rows.device)
    kernels.launch(
        "dd_raster_bwd_bf16" if bf16 else "dd_raster_bwd",
        "raster_bwd_bf16" if bf16 else "raster_bwd",
        d_rows.data_ptr(), win.data_ptr(), off_c.data_ptr(), used.data_ptr(), b, n_slots,
        k_chunk, nty, ntx, th, tw, d_bins.data_ptr(),
    )
    return d_bins


def raster_bwd_plain(d_rows: torch.Tensor, win: torch.Tensor, n_slots: int) -> torch.Tensor:
    """Plain torch K4: an index_add of every foreground pixel's d_rows
    (bf16 widened to f32) into its winner slot (background pixels land in
    a discarded extra row)."""
    d_rows = d_rows.float()
    b, width, hc, wc = d_rows.shape
    dev = d_rows.device
    w = win.reshape(b, -1).long()
    target = torch.where(
        w >= 0, torch.arange(b, device=dev)[:, None] * n_slots + w, b * n_slots
    ).reshape(-1)
    src = d_rows.reshape(b, width, -1).permute(0, 2, 1).reshape(-1, width)
    acc = torch.zeros((b * n_slots + 1, width), dtype=d_rows.dtype, device=dev)
    acc.index_add_(0, target, src)
    return acc[:-1].reshape(b, n_slots, width).permute(0, 2, 1).contiguous()


class RasterCompact(torch.autograd.Function):
    """(ids, rows) from the compact bin table, differentiable in ``bins``
    (counterpart of ``raster_gather_rows_compact``): K3 forward, K4
    backward over the winner-slot map K3 writes.  ids are not
    differentiable."""

    @staticmethod
    def forward(ctx, bins, counts, off_c, used, k_chunk, frame_hw, tile_hw, roi):
        ids, rows, win = raster_fwd(
            bins, counts, off_c, used, k_chunk, frame_hw, tile_hw, roi
        )
        ctx.save_for_backward(win, off_c, used)
        ctx.n_slots = bins.shape[2]
        ctx.tile_hw = tile_hw
        ctx.k_chunk = k_chunk
        ctx.mark_non_differentiable(ids)
        return ids, rows

    @staticmethod
    def backward(ctx, d_ids, d_rows):
        win, off_c, used = ctx.saved_tensors
        d_bins = raster_bwd(d_rows.contiguous(), win, ctx.n_slots, ctx.tile_hw, off_c,
                            used, ctx.k_chunk)
        return d_bins, None, None, None, None, None, None, None


def raster_compact(bins, counts, off_c, used, k_chunk, frame_hw, tile_hw, roi):
    return RasterCompact.apply(
        bins, counts, off_c, used, k_chunk, tuple(frame_hw), tuple(tile_hw),
        tuple(roi),
    )


def _uniform_layout(bins, counts, resolution, tile_hw):
    """(nty, ntx, K) of a uniform table over ``resolution`` padded to
    whole tiles; raises on a table that is not one."""
    _check(bins, "bins", torch.float32, 3, bins.device)
    _check(counts, "counts", torch.int32, 1, bins.device)
    if bins.shape[1] != PACKED_WIDTH:
        raise ValueError(f"bins: expected {PACKED_WIDTH} lanes, got {bins.shape[1]}")
    (h, w), (th, tw) = resolution, tile_hw
    nty, ntx = -(-h // th), -(-w // tw)
    if counts.shape[0] != nty * ntx or bins.shape[2] % (nty * ntx):
        raise ValueError(f"{counts.shape[0]} tile counts and {bins.shape[2]} slots "
                         f"are no uniform table of {nty * ntx} tiles")
    return nty, ntx, bins.shape[2] // (nty * ntx)


def raster_uniform_fwd(
    bins: torch.Tensor,
    counts: torch.Tensor,
    resolution: Tuple[int, int],
    tile_hw: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7 forward: (ids, rows, win) as :func:`raster_fwd`'s, over the
    uniform table (B, 32, num_tiles*K) of the (h, w) frame ``resolution``,
    on that frame padded to whole tiles.

    CPU tensors take :func:`raster_uniform_fwd_plain`; CUDA tensors launch
    the kernel (csrc/raster.cu), anything else raises."""
    nty, ntx, k = _uniform_layout(bins, counts, resolution, tile_hw)
    if bins.device.type == "cpu":
        return raster_uniform_fwd_plain(bins, counts, resolution, tile_hw)
    if bins.device.type != "cuda":
        raise ValueError(f"raster_uniform_fwd: unsupported device {bins.device}")
    _check_fwd_tile(tile_hw)
    th, tw = tile_hw
    b = bins.shape[0]
    ids = torch.empty((b, nty * th, ntx * tw), dtype=torch.int32, device=bins.device)
    win = torch.empty_like(ids)
    rows = torch.empty((b, PACKED_WIDTH, nty * th, ntx * tw), dtype=torch.float32,
                       device=bins.device)
    h, w = resolution
    kernels.launch(
        "dd_raster_uniform_fwd", "raster_uniform_fwd",
        bins.data_ptr(), counts.data_ptr(), b, k, nty, ntx, th, tw, h, w,
        ids.data_ptr(), win.data_ptr(), rows.data_ptr(),
    )
    return ids, rows, win


def raster_uniform_fwd_plain(bins, counts, resolution, tile_hw,
                             slot_chunk: int = 64):
    """Plain torch K7 forward: K3's plain raster over the slot ranges
    [t*K, t*K + min(counts[t], K))."""
    nty, ntx, k = _uniform_layout(bins, counts, resolution, tile_hw)
    (h, w), (th, tw) = resolution, tile_hw
    base = torch.arange(nty * ntx, device=bins.device) * k
    n = counts.long().clamp(max=k)
    return _raster_plain(bins, *_ranges(base, n), (nty * th, ntx * tw), tile_hw,
                         (0, 0, h, w), slot_chunk)


def raster_uniform_bwd(
    d_rows: torch.Tensor,
    win: torch.Tensor,
    n_slots: int,
    tile_hw: Tuple[int, int],
) -> torch.Tensor:
    """K7 backward: d_bins (B, 32, n_slots) of the uniform table, for each
    slot the sum of d_rows over the pixels it wins (zeros elsewhere, the
    padding of every tile included: each tile writes its whole bin, so
    d_bins is allocated without a zero fill).

    CPU tensors take :func:`raster_uniform_bwd_plain`; CUDA tensors launch
    the kernel (csrc/raster.cu), anything else raises."""
    _check(d_rows, "d_rows", torch.float32, 4, d_rows.device)
    _check(win, "win", torch.int32, 3, d_rows.device)
    b, width, hc, wc = d_rows.shape
    if width != PACKED_WIDTH or tuple(win.shape) != (b, hc, wc):
        raise ValueError(f"d_rows {tuple(d_rows.shape)} / win {tuple(win.shape)}")
    nty, ntx = _frame_tiles((hc, wc), tile_hw)
    if n_slots % (nty * ntx):
        raise ValueError(f"{n_slots} slots are no uniform table of {nty * ntx} tiles")
    if d_rows.device.type == "cpu":
        return raster_uniform_bwd_plain(d_rows, win, n_slots)
    if d_rows.device.type != "cuda":
        raise ValueError(f"raster_uniform_bwd: unsupported device {d_rows.device}")
    _check_bwd_tile(tile_hw)
    th, tw = tile_hw
    d_bins = torch.empty((b, PACKED_WIDTH, n_slots), dtype=torch.float32,
                         device=d_rows.device)
    kernels.launch(
        "dd_raster_uniform_bwd", "raster_uniform_bwd",
        d_rows.data_ptr(), win.data_ptr(), b, n_slots // (nty * ntx), nty, ntx,
        th, tw, d_bins.data_ptr(),
    )
    return d_bins


def raster_uniform_bwd_plain(d_rows, win, n_slots: int) -> torch.Tensor:
    """Plain torch K7 backward: K4's plain per-slot sum, which does not
    depend on the table's layout."""
    return raster_bwd_plain(d_rows, win, n_slots)


class RasterBinned(torch.autograd.Function):
    """(ids, rows) from the uniform-K table, differentiable in ``bins``
    (counterpart of ``raster_gather_rows_binned``): K7 forward, K7
    backward over the winner-slot map of the forward.  ids are not
    differentiable."""

    @staticmethod
    def forward(ctx, bins, counts, resolution, tile_hw):
        ids, rows, win = raster_uniform_fwd(bins, counts, resolution, tile_hw)
        ctx.save_for_backward(win)
        ctx.n_slots = bins.shape[2]
        ctx.tile_hw = tile_hw
        ctx.mark_non_differentiable(ids)
        return ids, rows

    @staticmethod
    def backward(ctx, d_ids, d_rows):
        (win,) = ctx.saved_tensors
        d_bins = raster_uniform_bwd(d_rows.contiguous(), win, ctx.n_slots, ctx.tile_hw)
        return d_bins, None, None, None


def raster_gather_rows_binned(bins, tile_counts, resolution, tile_hw,
                              padded: bool = False):
    """(ids, rows) of the uniform table over the (h, w) frame
    ``resolution`` (``raster_v2.py:1733``); ``padded`` returns the frame
    padded to whole tiles, as the raster leaves it."""
    ids, rows = RasterBinned.apply(bins, tile_counts, tuple(resolution), tuple(tile_hw))
    if padded:
        return ids, rows
    h, w = resolution
    return ids[:, :h, :w], rows[:, :, :h, :w]


def bins_planar(packed: torch.Tensor, tile_idx: torch.Tensor) -> torch.Tensor:
    """The uniform table (B, 32, num_tiles*K) of a triangle-order table
    (B, 32, T) and its bins (``raster_v2._bins_planar``, :1337): slot
    t*K + k is triangle tile_idx[t, k] (sentinels read triangle T-1, past
    every tile's count)."""
    safe = tile_idx.reshape(-1).long().clamp(max=packed.shape[2] - 1)
    return packed.index_select(2, safe)


class RasterV2(torch.autograd.Function):
    """(ids, rows) of the planar route of ``DD_BINNED=0``, differentiable in
    the triangle-order table (``raster_gather_rows_v2``, :1247): K7 over the
    gathered uniform table, backward K7 to d_bins, then each triangle's
    slots summed (``rasterize.slot_sums``).  Outputs cover the frame padded
    to whole tiles."""

    @staticmethod
    def forward(ctx, packed, tile_idx, tile_counts, resolution, tile_hw):
        from diffdope_tpu_torch.render.rasterize import slot_segments

        bins = bins_planar(packed, tile_idx)
        ids, rows, win = raster_uniform_fwd(bins, tile_counts, resolution, tile_hw)
        ctx.n_slots, ctx.tile_hw, ctx.t_count = bins.shape[2], tile_hw, packed.shape[2]
        del bins
        # on the card the slots are sorted by triangle here, not beside
        # d_bins in the backward, whose peak memory the sort would raise
        segs = slot_segments(tile_idx, ctx.t_count) if tile_idx.is_cuda else ()
        ctx.save_for_backward(win, tile_idx, *segs)
        ctx.mark_non_differentiable(ids)
        return ids, rows

    @staticmethod
    def backward(ctx, d_ids, d_rows):
        from diffdope_tpu_torch.render.rasterize import slot_sums

        win, tile_idx, *segs = ctx.saved_tensors
        d_bins = raster_uniform_bwd(d_rows.contiguous(), win, ctx.n_slots, ctx.tile_hw)
        return (slot_sums(d_bins, tile_idx, ctx.t_count, tuple(segs) or None),
                None, None, None, None)


def raster_gather_rows_v2(packed, tile_idx, tile_counts, inv_pos, inv_valid,
                          resolution, tile_hw, padded: bool = False):
    """Planar rasterize + row gather over per-tile bins (``raster_v2.py:1247``):
    :class:`RasterV2`.

    Args:
        packed: (B, 32, T) triangle-order table (``planar.pack_planar``).
        tile_idx / tile_counts: ``planar.bin_triangles_planar``'s bins at
            ``tile_hw``.
        inv_pos / inv_valid: the reference's inverted bin map
            (``gather_rows.invert_bins``), whose gather-sum
            ``rasterize.slot_sums`` replaces: not read, may be None.
        padded: return the frame padded to whole tiles.

    Returns ids (B, H, W) int32 (+1, 0 = background) and rows
    (B, 32, H, W)."""
    ids, rows = RasterV2.apply(packed.contiguous(), tile_idx.contiguous(),
                               tile_counts.contiguous(), tuple(resolution), tuple(tile_hw))
    if padded:
        return ids, rows
    h, w = resolution
    return ids[:, :h, :w], rows[:, :, :h, :w]
