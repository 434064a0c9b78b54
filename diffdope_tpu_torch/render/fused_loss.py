"""Fused shade + antialias + L1 loss sums (K5), its backward (K6), and the
two autograd ops over them.

Counterpart of ``diffdope_tpu/render/fused_loss.py``: ``fused_loss_sums``
(:440, kernel ``_fwd_kernel`` :221, here :class:`FusedLossSums`),
``backward_pass`` (:524, kernel ``_bwd_kernel`` :268; its ``d_rows_dtype``
bf16 here K6's bf16 lane) and ``raster_loss_compact`` (:601-684, here
:class:`RasterLossCompact`, whose d_rows cotangent is bf16 by default, as
the reference's).

The loss sums of one hypothesis over its (hc, wc) frame window are

    mask  = sum_px sum_c |aa - seg_c| * lm
    rgb   = sum_px sum_c |col_c - rgb_c| * seg_c * lm
    depth = sum_px |attr_z + dplane| * seg0 * lm      (with a dplane)

with aa the antialiased foreground mask, col_c the interpolated vertex
colour, or with ``colors`` (B, 3, hc, wc) the given colour planes (the
semi-fused exact-texture route's texture samples, foreground-masked by
the caller: the colour lane), attr_z the interpolated rotated z (0 on
background), dplane = gt depth + t_z per hypothesis (the render's depth
is -(attr_z + t_z)), gt6 = [seg0..2, rgb0..2] planes of the window, and
lm the real pixels of the frame (``fused_loss.py:78-143``).  The rows hold
:func:`n_channels` attribute channels before z: 3 colours, or with
``colors`` 2 uv.  Without a dplane the depth sum is 0.  |.| differentiates
as JAX's abs does, +1 at 0, everywhere: the reference takes jnp.sign (0
at 0) for d_dplane on slabs without foreground (:346-354), which depends
on its slab height; the port keeps one rule.

Each of K5 and K6 has a plain torch version here — K5's is the
differentiable composition of ``shade.shade_from_rows`` and
``shade.antialias_rows``, K6's is ``torch.autograd`` of it — which CPU
tensors take and which the CUDA kernels (csrc/fused_loss.cu) are held to.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from diffdope_tpu_torch import kernels
from diffdope_tpu_torch.render.raster import _check, raster_bwd, raster_fwd
from diffdope_tpu_torch.render.shade import (
    PACKED_WIDTH,
    antialias_rows,
    pixel_ndc,
    shade_from_rows,
)

#: lanes of the (B, 3) sums: mask, rgb, depth
MASK_LANE, RGB_LANE, DEPTH_LANE = 0, 1, 2
_TILE = (16, 16)  # K5's pixel tile, one thread block (csrc/fused_loss.cu)


def n_channels(colors: Optional[torch.Tensor]) -> int:
    """The attribute channels the rows hold before the rotated z: 3
    colours, or 2 uv on the colour lane (``colors`` given)."""
    return 3 if colors is None else 2


def counter(name: str, dplane, colors) -> str:
    """The launch counter of K5 ('loss_fwd') or K6 ('loss_bwd') for the
    lanes a call takes: '_color' with colour planes, '_depth' with a
    dplane."""
    return name + ("_color" if colors is not None else "") + (
        "_depth" if dplane is not None else "")


def _l1(d: torch.Tensor) -> torch.Tensor:
    """|d| with JAX's derivative rule (+1 at d == 0)."""
    return torch.where(d >= 0, d, -d)


def _valid_mask(frame_hw, roi, device) -> torch.Tensor:
    hc, wc = frame_hw
    oy, ox, fh, fw = roi
    rows = torch.arange(hc, device=device) < min(hc, fh - oy)
    cols = torch.arange(wc, device=device) < min(wc, fw - ox)
    return rows[:, None] & cols[None, :]


def loss_sums_plain(rows, ids, gt6, roi, dplane=None, colors=None) -> torch.Tensor:
    """Plain torch K5: (B, 3) [mask, rgb, depth] sums, differentiable in
    rows, dplane and colors (the depth sum is 0 without a dplane).  The
    shade computes only the channels read: the colours (or none, with
    ``colors``), then z with a dplane."""
    b, _, hc, wc = rows.shape
    xy = pixel_ndc((hc, wc), roi, device=rows.device)
    valid = _valid_mask((hc, wc), roi, rows.device)
    n_ch = n_channels(colors)
    n_attr = (n_ch + 1) if dplane is not None else (0 if colors is not None else n_ch)
    shd = shade_from_rows(ids, rows, (hc, wc), attr_channels=n_attr, xy=xy)
    fgm = (ids > 0).to(rows.dtype)
    aa = antialias_rows(fgm, ids, shd["zw"], rows, (hc, wc), xy=xy,
                        valid=valid[None])
    lm = valid.to(rows.dtype)
    m_sum = rows.new_zeros(b)
    r_sum = rows.new_zeros(b)
    for c in range(3):
        col = shd["attrs_list"][c] if colors is None else colors[:, c]
        m_sum = m_sum + (_l1(aa - gt6[c]) * lm).sum(dim=(1, 2))
        r_sum = r_sum + (_l1(col - gt6[3 + c]) * gt6[c] * lm).sum(dim=(1, 2))
    if dplane is None:
        d_sum = torch.zeros_like(m_sum)
    else:
        d_sum = (_l1(shd["attrs_list"][n_ch] + dplane) * gt6[0] * lm).sum(dim=(1, 2))
    return torch.stack([m_sum, r_sum, d_sum], dim=-1)


def loss_bwd_plain(rows, ids, gt6, roi, d_sums, dplane=None, colors=None):
    """Plain torch K6: (d_rows, d_dplane, d_colors) = torch.autograd of the
    plain K5 (d_dplane None without a dplane, d_colors None without
    colors)."""
    with torch.enable_grad():
        leaves = [rows.detach().requires_grad_(True)]
        dp = cp = None
        if dplane is not None:
            dp = dplane.detach().requires_grad_(True)
            leaves.append(dp)
        if colors is not None:
            cp = colors.detach().requires_grad_(True)
            leaves.append(cp)
        sums = loss_sums_plain(leaves[0], ids, gt6, roi, dp, cp)
        grads = list(torch.autograd.grad(sums, leaves, grad_outputs=d_sums))
    d_rows = grads.pop(0)
    d_dplane = grads.pop(0) if dplane is not None else None
    d_colors = grads.pop(0) if colors is not None else None
    return d_rows, d_dplane, d_colors


def _check_loss_inputs(rows, ids, gt6, dplane, colors):
    dev = rows.device
    _check(rows, "rows", torch.float32, 4, dev)
    _check(ids, "ids", torch.int32, 3, dev)
    _check(gt6, "gt6", torch.float32, 3, dev)
    b, width, hc, wc = rows.shape
    if width != PACKED_WIDTH or tuple(ids.shape) != (b, hc, wc):
        raise ValueError(f"rows {tuple(rows.shape)} / ids {tuple(ids.shape)}")
    if tuple(gt6.shape) != (6, hc, wc):
        raise ValueError(f"gt6 {tuple(gt6.shape)}, expected (6, {hc}, {wc})")
    if dplane is not None:
        _check(dplane, "dplane", torch.float32, 3, dev)
        if tuple(dplane.shape) != (b, hc, wc):
            raise ValueError(f"dplane {tuple(dplane.shape)}, expected {(b, hc, wc)}")
    if colors is not None:
        _check(colors, "colors", torch.float32, 4, dev)
        if tuple(colors.shape) != (b, 3, hc, wc):
            raise ValueError(f"colors {tuple(colors.shape)}, expected {(b, 3, hc, wc)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def loss_sums(rows, ids, gt6, roi: Tuple[int, int, int, int],
              dplane: Optional[torch.Tensor] = None,
              colors: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5: (B, 3) loss sums, the depth lane with a dplane (B, hc, wc), the
    colour lane with colour planes (B, 3, hc, wc).  CPU tensors take
    :func:`loss_sums_plain`; CUDA tensors launch the kernel, anything else
    raises."""
    _check_loss_inputs(rows, ids, gt6, dplane, colors)
    if rows.device.type == "cpu":
        return loss_sums_plain(rows, ids, gt6, roi, dplane, colors)
    if rows.device.type != "cuda":
        raise ValueError(f"loss_sums: unsupported device {rows.device}")
    b, _, hc, wc = rows.shape
    oy, ox, fh, fw = roi
    ntiles = -(-hc // _TILE[0]) * -(-wc // _TILE[1])
    partials = torch.empty((b, ntiles, 2 if dplane is None else 3), dtype=torch.float32,
                           device=rows.device)
    sums = torch.empty((b, 3), dtype=torch.float32, device=rows.device)
    kernels.launch(
        "dd_loss_fwd", counter("loss_fwd", dplane, colors),
        rows.data_ptr(), ids.data_ptr(), gt6.data_ptr(), _ptr(dplane), _ptr(colors),
        b, hc, wc, oy, ox, fh, fw, partials.data_ptr(), sums.data_ptr(),
    )
    return sums


def loss_bwd(rows, ids, gt6, roi, d_sums, dplane: Optional[torch.Tensor] = None,
             colors: Optional[torch.Tensor] = None, d_rows_dtype=torch.float32):
    """K6: (d_rows (B, 32, hc, wc), d_dplane (B, hc, wc) or None, d_colors
    (B, 3, hc, wc) or None) from d_sums (B, 3).  ``d_rows_dtype`` bf16 (the
    rgb + mask lane only: no dplane, no colors) rounds each f32 d_rows
    value once to nearest even, as the reference's spanning op does under
    DD_DROWS_BF16=1.  CPU tensors take :func:`loss_bwd_plain` (then the
    cast); CUDA tensors launch the kernel (the bf16 lane its own
    instantiation, counted apart), anything else raises."""
    _check_loss_inputs(rows, ids, gt6, dplane, colors)
    _check(d_sums, "d_sums", torch.float32, 2, rows.device)
    bf16 = d_rows_dtype == torch.bfloat16
    if d_rows_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"d_rows_dtype: f32 or bf16, not {d_rows_dtype}")
    if bf16 and (dplane is not None or colors is not None):
        raise ValueError("bf16 d_rows: the rgb + mask lane only (no dplane, no colors)")
    if rows.device.type == "cpu":
        d_rows, d_dplane, d_colors = loss_bwd_plain(rows, ids, gt6, roi, d_sums, dplane,
                                                    colors)
        return d_rows.to(d_rows_dtype), d_dplane, d_colors
    if rows.device.type != "cuda":
        raise ValueError(f"loss_bwd: unsupported device {rows.device}")
    b, _, hc, wc = rows.shape
    oy, ox, fh, fw = roi
    d_rows = torch.empty_like(rows, dtype=d_rows_dtype)
    if bf16:
        kernels.launch(
            "dd_loss_bwd_bf16", "loss_bwd_bf16",
            rows.data_ptr(), ids.data_ptr(), gt6.data_ptr(), d_sums.data_ptr(), b, hc,
            wc, oy, ox, fh, fw, None, d_rows.data_ptr(),
        )
        return d_rows, None, None
    d_dplane = None if dplane is None else torch.empty_like(dplane)
    d_colors = None if colors is None else torch.empty_like(colors)
    kernels.launch(
        "dd_loss_bwd", counter("loss_bwd", dplane, colors),
        rows.data_ptr(), ids.data_ptr(), gt6.data_ptr(), _ptr(dplane), _ptr(colors),
        d_sums.data_ptr(), b, hc, wc, oy, ox, fh, fw, None,
        d_rows.data_ptr(), _ptr(d_dplane), _ptr(d_colors),
    )
    return d_rows, d_dplane, d_colors


class FusedLossSums(torch.autograd.Function):
    """(B, 3) loss sums from a raster's (rows, ids), differentiable in rows,
    dplane and colors (counterpart of ``fused_loss_sums`` with its custom
    VJP): K5 forward, K6 backward.  d_rows stays f32, as on the
    reference's non-spanning route; the ground truth is a constant."""

    @staticmethod
    def forward(ctx, rows, ids, gt6, dplane, colors, roi):
        ctx.save_for_backward(rows, ids, gt6, dplane, colors)
        ctx.roi = roi
        return loss_sums(rows, ids, gt6, roi, dplane, colors)

    @staticmethod
    def backward(ctx, d_sums):
        rows, ids, gt6, dplane, colors = ctx.saved_tensors
        d_rows, d_dplane, d_colors = loss_bwd(rows, ids, gt6, ctx.roi, d_sums.contiguous(),
                                              dplane, colors)
        return d_rows, None, None, d_dplane, d_colors, None


def fused_loss_sums(rows, ids, gt6, dplane, colors, frame_hw, roi) -> torch.Tensor:
    """(B, 3) [mask, rgb, depth] sums over the (hc, wc) window ``frame_hw``
    of rows (B, 32, hc, wc) and ids, at ``roi=(oy, ox, fh, fw)``; dplane
    (B, hc, wc) or None; colors (B, 3, hc, wc), foreground-masked, or
    None."""
    if tuple(rows.shape[2:]) != tuple(frame_hw):
        raise ValueError(f"rows {tuple(rows.shape)} do not cover the window {frame_hw}")
    return FusedLossSums.apply(rows, ids, gt6, dplane, colors, tuple(roi))


class RasterLossCompact(torch.autograd.Function):
    """(B, 3) loss sums from the compact bin table in one differentiable op
    (counterpart of ``fused_loss.raster_loss_compact``).

    Forward: K3 (raster) then K5 (loss sums).  Backward: K6 (d_rows) then
    K4 (d_bins), the d_rows between them in bf16 with ``d_rows_bf16`` (the
    reference's default: one rounding of each f32 value, all sums in f32)
    or f32 (then bit for bit the chained ops).  Differentiable w.r.t.
    ``bins`` only; the ground truth is a constant.  The rgb + mask route:
    with a depth plane the raster and :class:`FusedLossSums` are chained,
    as the reference does.
    """

    @staticmethod
    def forward(ctx, bins, counts, off_c, used, gt6, k_chunk, frame_hw,
                tile_hw, roi, d_rows_bf16):
        ids, rows, win = raster_fwd(
            bins, counts, off_c, used, k_chunk, frame_hw, tile_hw, roi
        )
        sums = loss_sums(rows, ids, gt6, roi)
        ctx.save_for_backward(rows, ids, win, gt6, off_c, used)
        ctx.n_slots = bins.shape[2]
        ctx.k_chunk = k_chunk
        ctx.tile_hw = tile_hw
        ctx.roi = roi
        ctx.d_rows_dtype = torch.bfloat16 if d_rows_bf16 else torch.float32
        return sums

    @staticmethod
    def backward(ctx, d_sums):
        rows, ids, win, gt6, off_c, used = ctx.saved_tensors
        d_rows, _, _ = loss_bwd(rows, ids, gt6, ctx.roi, d_sums.contiguous(),
                                d_rows_dtype=ctx.d_rows_dtype)
        d_bins = raster_bwd(d_rows, win, ctx.n_slots, ctx.tile_hw, off_c, used,
                            ctx.k_chunk)
        return d_bins, None, None, None, None, None, None, None, None, None


def raster_loss_compact(bins, counts, off_c, used, gt6, k_chunk, frame_hw,
                        tile_hw, roi, d_rows_bf16: bool = True) -> torch.Tensor:
    """:class:`RasterLossCompact`; ``d_rows_bf16`` is the reference's
    argument of the same name (``pipeline.make_fused_loss`` reads it from
    DD_DROWS_BF16 when the loss is built)."""
    return RasterLossCompact.apply(
        bins, counts, off_c, used, gt6, k_chunk, tuple(frame_hw),
        tuple(tile_hw), tuple(roi), bool(d_rows_bf16),
    )
