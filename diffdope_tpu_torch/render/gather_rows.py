"""The v1 raster + row gather (K9) and the inverted bin map.

Counterpart of ``diffdope_tpu/render/gather_rows.py``:

- :func:`invert_bins` (``gather_rows.py:43-100``) and :func:`bin_occupancy`
  (:103): the (num_tiles, K) bin lists inverted into per-triangle lists of
  their flat slot positions, for the backward's gather-sum; the planar
  route of ``DD_BINNED=0`` uses them too (``raster.raster_gather_rows_v2``);
- :func:`raster_gather_rows` (:240), K9: per (hypothesis, tile) the z-tested
  triangle-id search over the tile's bin of (B, T, 32) ``shade.pack_rows``
  rows, then the winner's 32 lanes per pixel; backward per (tile, slot)
  d_bin, then the inverted-bin gather-sum to d_packed in torch (XLA in the
  reference, :388-397).

The id search is K8's exactly (``rasterize.py``'s numeric contract: edge
functions ``(c0*x + c1*y) + c2``, coverage ``e*sign(det) >= 0``, an IEEE
``zlin / det``, a strictly nearer z wins in slot order, and slots hold
ascending triangle ids), not K3's lexicographic (z, id) minimum; the id is
lane 13 of the winning row, + 1.  No entry point of either package calls
this op; it is the reference's public op, driven as its tests drive it.

Each kernel has a plain torch version beside it, which CPU tensors take;
CUDA tensors launch ``csrc/rasterize.cu`` (K9 shares K8's source and its
``edge()``/``ndc()``), any other device raises.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from diffdope_tpu_torch import kernels
from diffdope_tpu_torch.render.raster import _check, raster_bwd_plain
from diffdope_tpu_torch.render.rasterize import _ID_LANES, _edges_z, check_kernel_frame
from diffdope_tpu_torch.render.shade import PACKED_WIDTH, ndc

#: K9's backward keys a pixel by its slot in 22 bits (csrc/rasterize.cu)
_MAX_BWD_K = (1 << 22) - 2


def invert_bins(tile_idx: torch.Tensor, t_count: int,
                max_occ: Union[int, str] = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invert the (num_tiles, K) bin lists into per-triangle occurrence
    lists: (inv_pos (T, M) int64 flat positions into num_tiles*K, inv_valid
    (T, M) bool), element for element the reference's.

    ``max_occ`` 'auto' sizes M to the largest occurrence count (at least 4,
    read on the host from the sort's ranks: one wait for the device, and
    ``inv_valid.sum(1)`` is then each triangle's occurrence count); an int
    fixes M, and a triangle in more than M tiles loses the rest of its
    gradient (check :func:`bin_occupancy`).  The reference's
    sort-then-scatter with a stable sort: a triangle's occurrences keep
    their flat order."""
    flat = tile_idx.reshape(-1).long()
    n = flat.numel()
    order = torch.argsort(flat, stable=True)
    vals = flat[order]
    iota = torch.arange(n, device=flat.device)
    first = torch.ones(n, dtype=torch.bool, device=flat.device)
    first[1:] = vals[1:] != vals[:-1]
    seg_start = torch.cummax(torch.where(first, iota, -1), dim=0).values
    rank = iota - seg_start  # occurrence index within the triangle's group
    if isinstance(max_occ, str):
        if max_occ != "auto":
            raise ValueError(f"max_occ must be an int or 'auto': {max_occ!r}")
        most = torch.where(vals < t_count, rank + 1, 0).max() if n else 0
        max_occ = max(4, int(most))
    ok = (rank < max_occ) & (vals < t_count)
    inv = torch.full((t_count * max_occ,), -1, dtype=torch.long, device=flat.device)
    inv[(vals * max_occ + rank)[ok]] = order[ok]
    inv_pos = inv.reshape(t_count, max_occ)
    return inv_pos.clamp(min=0), inv_pos >= 0


def bin_occupancy(tile_idx: torch.Tensor, t_count: int) -> torch.Tensor:
    """The most tiles any triangle occurs in (a 0-dim int64 tensor): a fixed
    ``invert_bins`` M below it truncates gradients.  Counted at shapes the
    bins fix (the sentinels into a spare slot), so nothing waits for the
    host."""
    flat = tile_idx.reshape(-1).long().clamp(max=t_count)
    occ = torch.zeros((t_count + 1,), dtype=torch.int64, device=flat.device)
    return occ.index_add_(0, flat, torch.ones_like(flat))[:t_count].max()


def inverted_sum(d_bin: torch.Tensor, inv_pos: torch.Tensor,
                 inv_valid: torch.Tensor) -> torch.Tensor:
    """d_packed (B, T, 32) = for each triangle the sum of its valid
    occurrences' rows of d_bin (B, n_slots, 32) (``gather_rows.py:388-397``)."""
    b = d_bin.shape[0]
    t_count, m = inv_pos.shape
    gathered = d_bin[:, inv_pos.reshape(-1)].reshape(b, t_count, m, -1)
    return torch.where(inv_valid[None, :, :, None], gathered, 0.0).sum(dim=2)


def _layout(packed, tile_idx, tile_counts, resolution, tile_hw):
    """(nty, ntx) of the padded frame; raises on inputs K9 does not take."""
    _check(packed, "packed", torch.float32, 3, packed.device)
    _check(tile_idx, "tile_idx", torch.int32, 2, packed.device)
    _check(tile_counts, "tile_counts", torch.int32, 1, packed.device)
    if packed.shape[2] != PACKED_WIDTH:
        raise ValueError(f"packed: expected (B, T, {PACKED_WIDTH}) rows, got "
                         f"{tuple(packed.shape)}")
    (h, w), (th, tw) = resolution, tile_hw
    nty, ntx = -(-h // th), -(-w // tw)
    if tile_idx.shape[0] != nty * ntx or tile_counts.shape[0] != nty * ntx:
        raise ValueError(f"{tile_idx.shape[0]} tile lists and {tile_counts.shape[0]} "
                         f"counts for {nty * ntx} tiles of {tile_hw} over {resolution}")
    return nty, ntx


def gather_rows_fwd(packed: torch.Tensor, tile_idx: torch.Tensor,
                    tile_counts: torch.Tensor, resolution: Tuple[int, int],
                    tile_hw: Tuple[int, int]):
    """K9 forward over the padded (nty*th, ntx*tw) frame: ids (B, Hp, Wp)
    int32 (+1, 0 = background), rows (B, 32, Hp, Wp) f32 (the winner's
    lanes, zeros on background) and win (B, Hp, Wp) int32, the winner's
    flat slot t*K + k (-1 on background), the backward's map.

    CPU tensors take :func:`gather_rows_fwd_plain`; CUDA tensors launch
    the kernel (csrc/rasterize.cu), anything else raises."""
    nty, ntx = _layout(packed, tile_idx, tile_counts, resolution, tile_hw)
    if packed.device.type == "cpu":
        return gather_rows_fwd_plain(packed, tile_idx, tile_counts, resolution, tile_hw)
    if packed.device.type != "cuda":
        raise ValueError(f"gather_rows_fwd: unsupported device {packed.device}")
    check_kernel_frame(packed, nty, ntx, tile_hw)
    b, t_count, _ = packed.shape
    (h, w), (th, tw) = resolution, tile_hw
    dev = packed.device
    ids = torch.empty((b, nty * th, ntx * tw), dtype=torch.int32, device=dev)
    win = torch.empty_like(ids)
    rows = torch.empty((b, PACKED_WIDTH, nty * th, ntx * tw), dtype=torch.float32,
                       device=dev)
    boxes = torch.empty((b, t_count, 2), dtype=torch.int32, device=dev)  # scratch
    kernels.launch(
        "dd_gather_rows_fwd", "gather_rows_fwd",
        packed.data_ptr(), tile_idx.data_ptr(), tile_counts.data_ptr(),
        b, t_count, tile_idx.shape[1], nty, ntx, th, tw, h, w,
        ids.data_ptr(), win.data_ptr(), rows.data_ptr(), boxes.data_ptr(),
    )
    return ids, rows, win


@torch.no_grad()
def gather_rows_fwd_plain(packed, tile_idx, tile_counts, resolution, tile_hw,
                          slot_chunk: int = 64):
    """Plain torch K9 forward: K8's plain search (every tile walks the first
    ``tile_counts[t]`` entries of its bin, ``slot_chunk`` at a time, and a
    pixel keeps the first strictly nearest z), tracking the winning slot,
    then the winner's row gathered."""
    nty, ntx = _layout(packed, tile_idx, tile_counts, resolution, tile_hw)
    b, t_count, _ = packed.shape
    (h, w), (th, tw) = resolution, tile_hw
    dev = packed.device
    nt, npx, k = nty * ntx, th * tw, tile_idx.shape[1]
    ti = torch.arange(nt, device=dev)
    pi = torch.arange(npx, device=dev)
    prow = (ti // ntx)[:, None] * th + (pi // tw)[None, :]  # (nt, npx)
    pcol = (ti % ntx)[:, None] * tw + (pi % tw)[None, :]
    x = ndc(pcol, w)[..., None]  # (nt, npx, 1)
    y = ndc(prow, h)[..., None]
    n = tile_counts.long().clamp(max=k)
    smax = int(n.max()) if nt else 0
    inf = torch.tensor(float("inf"), device=dev)

    hp, wp = nty * th, ntx * tw
    ids = torch.zeros((b, hp, wp), dtype=torch.int32, device=dev)
    win = torch.full((b, hp, wp), -1, dtype=torch.int32, device=dev)
    rows = torch.zeros((b, PACKED_WIDTH, hp, wp), dtype=torch.float32, device=dev)
    flat_pix = (prow * wp + pcol).reshape(-1)
    tri_all = tile_idx.long().clamp(max=t_count - 1)
    for bi in range(b):
        zb = torch.full((nt, npx), float("inf"), device=dev)
        ib = torch.zeros((nt, npx), dtype=torch.int32, device=dev)
        sb = torch.full((nt, npx), -1, dtype=torch.long, device=dev)
        for s0 in range(0, smax, slot_chunk):
            j = torch.arange(s0, min(s0 + slot_chunk, smax), device=dev)
            in_tile = j[None, :] < n[:, None]  # (nt, ch)
            rws = packed[bi][tri_all[:, s0:s0 + j.numel()]]  # (nt, ch, 32)
            lanes = [rws[:, None, :, i] for i in range(_ID_LANES)]  # (nt, 1, ch)
            ok, z = _edges_z(lanes, x, y)
            z_c, k_c = torch.where(ok & in_tile[:, None, :], z, inf).min(dim=-1)
            better = z_c < zb
            zb = torch.where(better, z_c, zb)
            ib = torch.where(better, rws[..., 13].gather(1, k_c).to(torch.int32) + 1, ib)
            sb = torch.where(better, k_c + s0, sb)
        fg = sb >= 0
        ids.view(b, -1)[bi, flat_pix] = ib.reshape(-1)
        win.view(b, -1)[bi, flat_pix] = torch.where(
            fg, ti[:, None] * k + sb, -1).to(torch.int32).reshape(-1)
        tri = tri_all.gather(1, sb.clamp(min=0))  # (nt, npx)
        gathered = torch.where(fg.reshape(-1, 1), packed[bi][tri.reshape(-1)], 0.0)
        rows.view(b, PACKED_WIDTH, -1)[bi][:, flat_pix] = gathered.t()
    return ids, rows, win


def gather_rows_bwd(d_rows: torch.Tensor, win: torch.Tensor, tile_counts: torch.Tensor,
                    k: int, tile_hw: Tuple[int, int]) -> torch.Tensor:
    """K9 backward: d_bin (B, num_tiles, K, 32), for each (tile, slot) the
    sum of d_rows (B, 32, Hp, Wp) over the tile's pixels it wins (zeros
    elsewhere), from the forward's map ``win``.

    CPU tensors take :func:`gather_rows_bwd_plain`; CUDA tensors launch
    the kernel (csrc/rasterize.cu), anything else raises."""
    _check(d_rows, "d_rows", torch.float32, 4, d_rows.device)
    _check(win, "win", torch.int32, 3, d_rows.device)
    _check(tile_counts, "tile_counts", torch.int32, 1, d_rows.device)
    b, width, hp, wp = d_rows.shape
    (th, tw) = tile_hw
    if width != PACKED_WIDTH or tuple(win.shape) != (b, hp, wp) or hp % th or wp % tw:
        raise ValueError(f"d_rows {tuple(d_rows.shape)} / win {tuple(win.shape)} "
                         f"at tile {tile_hw}")
    nty, ntx = hp // th, wp // tw
    if tile_counts.shape[0] != nty * ntx:
        raise ValueError(f"{tile_counts.shape[0]} counts for {nty * ntx} tiles")
    if d_rows.device.type == "cpu":
        return gather_rows_bwd_plain(d_rows, win, nty * ntx, k)
    if d_rows.device.type != "cuda":
        raise ValueError(f"gather_rows_bwd: unsupported device {d_rows.device}")
    if k > _MAX_BWD_K:
        raise ValueError(f"K9 backward: K={k} slots a tile, more than {_MAX_BWD_K}")
    d_bin = torch.empty((b, nty * ntx, k, PACKED_WIDTH), dtype=torch.float32,
                        device=d_rows.device)
    kernels.launch(
        "dd_gather_rows_bwd", "gather_rows_bwd",
        d_rows.data_ptr(), win.data_ptr(), tile_counts.data_ptr(), b, k, nty, ntx,
        th, tw, d_bin.data_ptr(),
    )
    return d_bin


def gather_rows_bwd_plain(d_rows, win, num_tiles: int, k: int) -> torch.Tensor:
    """Plain torch K9 backward: K4's plain per-slot sum over the flat slots,
    laid out (B, num_tiles, K, 32)."""
    b = d_rows.shape[0]
    d = raster_bwd_plain(d_rows, win, num_tiles * k)  # (B, 32, nt*K)
    return d.permute(0, 2, 1).reshape(b, num_tiles, k, PACKED_WIDTH).contiguous()


class RasterGatherRows(torch.autograd.Function):
    """(ids, rows) of K9, differentiable in ``packed``: the forward, then
    the per-slot backward and the inverted-bin gather-sum.  ids are not
    differentiable."""

    @staticmethod
    def forward(ctx, packed, tile_idx, tile_counts, inv_pos, inv_valid, resolution,
                tile_hw):
        ids, rows, win = gather_rows_fwd(packed, tile_idx, tile_counts, resolution,
                                         tile_hw)
        h, w = resolution
        ctx.save_for_backward(win, tile_counts, inv_pos, inv_valid)
        ctx.k, ctx.tile_hw, ctx.resolution = tile_idx.shape[1], tile_hw, resolution
        ids, rows = ids[:, :h, :w], rows[:, :, :h, :w]
        ctx.mark_non_differentiable(ids)
        return ids, rows

    @staticmethod
    def backward(ctx, d_ids, d_rows):
        win, tile_counts, inv_pos, inv_valid = ctx.saved_tensors
        h, w = ctx.resolution
        hp, wp = win.shape[1:]
        d_rows = torch.nn.functional.pad(d_rows, (0, wp - w, 0, hp - h)).contiguous()
        d_bin = gather_rows_bwd(d_rows, win, tile_counts, ctx.k, ctx.tile_hw)
        b = d_bin.shape[0]
        d_packed = inverted_sum(d_bin.reshape(b, -1, PACKED_WIDTH), inv_pos, inv_valid)
        return d_packed, None, None, None, None, None, None


def raster_gather_rows(packed: torch.Tensor, tile_idx: torch.Tensor,
                       tile_counts: torch.Tensor, inv_pos: torch.Tensor,
                       inv_valid: torch.Tensor, resolution: Tuple[int, int],
                       tile_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9: rasterize + gather packed rows per pixel (``gather_rows.py:240``).

    Args:
        packed: (B, T, 32) ``shade.pack_rows`` rows, differentiable; lane
            13 holds the triangle index.
        tile_idx / tile_counts: ``setup_tris.bin_triangles``' bins (shared
            by the batch, ascending within a tile), int32.
        inv_pos / inv_valid: :func:`invert_bins` of ``tile_idx``.
        resolution: (H, W).  tile_hw: (th, tw), any size.

    Returns ids (B, H, W) int32 (+1, 0 = background) and rows (B, 32, H, W)
    f32, channel-planar, zeros on background."""
    return RasterGatherRows.apply(packed.contiguous(), tile_idx, tile_counts, inv_pos,
                                  inv_valid, tuple(resolution), tuple(tile_hw))
