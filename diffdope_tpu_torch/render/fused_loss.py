"""Fused shade + antialias + L1 loss sums (K5), its backward (K6), and the
spanning raster+loss autograd op.

Counterpart of ``diffdope_tpu/render/fused_loss.py``: ``fused_loss_sums``
(:440, kernel ``_fwd_kernel`` :221), ``backward_pass`` (:524, kernel
``_bwd_kernel`` :268) and ``raster_loss_compact`` (:601-684), on the
rgb+mask path (no depth plane, no pre-sampled colours).

The loss sums of one hypothesis over its (hc, wc) frame window are

    mask = sum_px sum_c |aa - seg_c| * lm
    rgb  = sum_px sum_c |attr_c - rgb_c| * seg_c * lm

with aa the antialiased foreground mask, attr_c the interpolated vertex
colour, gt6 = [seg0..2, rgb0..2] planes of the window, and lm the real
pixels of the frame (``fused_loss.py:78-143``).  |.| differentiates as
JAX's abs does: +1 at 0.

Each of K5 and K6 has a plain torch version here — K5's is the
differentiable composition of ``shade.shade_from_rows`` and
``shade.antialias_rows``, K6's is ``torch.autograd`` of it — which CPU
tensors take and which the CUDA kernels (csrc/fused_loss.cu) are held to.
"""

from __future__ import annotations

from typing import Tuple

import torch

from diffdope_tpu_torch import kernels
from diffdope_tpu_torch.render.raster import _check, raster_bwd, raster_fwd
from diffdope_tpu_torch.render.shade import (
    PACKED_WIDTH,
    antialias_rows,
    pixel_ndc,
    shade_from_rows,
)

#: lanes of the (B, 3) sums: mask, rgb, depth (depth is off this path: 0)
MASK_LANE, RGB_LANE, DEPTH_LANE = 0, 1, 2
_BLOCK = 256  # pixels per K5/K6 thread block (csrc/fused_loss.cu)


def _l1(d: torch.Tensor) -> torch.Tensor:
    """|d| with JAX's derivative rule (+1 at d == 0)."""
    return torch.where(d >= 0, d, -d)


def _valid_mask(frame_hw, roi, device) -> torch.Tensor:
    hc, wc = frame_hw
    oy, ox, fh, fw = roi
    rows = torch.arange(hc, device=device) < min(hc, fh - oy)
    cols = torch.arange(wc, device=device) < min(wc, fw - ox)
    return rows[:, None] & cols[None, :]


def loss_sums_plain(rows, ids, gt6, roi) -> torch.Tensor:
    """Plain torch K5: (B, 3) [mask, rgb, 0] sums, differentiable in rows."""
    b, _, hc, wc = rows.shape
    xy = pixel_ndc((hc, wc), roi, device=rows.device)
    valid = _valid_mask((hc, wc), roi, rows.device)
    shd = shade_from_rows(ids, rows, (hc, wc), attr_channels=3, xy=xy)
    fgm = (ids > 0).to(rows.dtype)
    aa = antialias_rows(fgm, ids, shd["zw"], rows, (hc, wc), xy=xy,
                        valid=valid[None])
    lm = valid.to(rows.dtype)
    m_sum = rows.new_zeros(b)
    r_sum = rows.new_zeros(b)
    for c in range(3):
        m_sum = m_sum + (_l1(aa - gt6[c]) * lm).sum(dim=(1, 2))
        r_sum = r_sum + (
            _l1(shd["attrs_list"][c] - gt6[3 + c]) * gt6[c] * lm
        ).sum(dim=(1, 2))
    return torch.stack([m_sum, r_sum, torch.zeros_like(m_sum)], dim=-1)


def loss_bwd_plain(rows, ids, gt6, roi, d_sums) -> torch.Tensor:
    """Plain torch K6: d_rows = torch.autograd of the plain K5."""
    with torch.enable_grad():
        r = rows.detach().requires_grad_(True)
        sums = loss_sums_plain(r, ids, gt6, roi)
        (d_rows,) = torch.autograd.grad(sums, r, grad_outputs=d_sums)
    return d_rows


def _check_loss_inputs(rows, ids, gt6):
    dev = rows.device
    _check(rows, "rows", torch.float32, 4, dev)
    _check(ids, "ids", torch.int32, 3, dev)
    _check(gt6, "gt6", torch.float32, 3, dev)
    b, width, hc, wc = rows.shape
    if width != PACKED_WIDTH or tuple(ids.shape) != (b, hc, wc):
        raise ValueError(f"rows {tuple(rows.shape)} / ids {tuple(ids.shape)}")
    if tuple(gt6.shape) != (6, hc, wc):
        raise ValueError(f"gt6 {tuple(gt6.shape)}, expected (6, {hc}, {wc})")


def loss_sums(rows, ids, gt6, roi: Tuple[int, int, int, int]) -> torch.Tensor:
    """K5: (B, 3) loss sums.  CPU tensors take :func:`loss_sums_plain`;
    CUDA tensors launch the kernel, anything else raises."""
    _check_loss_inputs(rows, ids, gt6)
    if rows.device.type == "cpu":
        return loss_sums_plain(rows, ids, gt6, roi)
    if rows.device.type != "cuda":
        raise ValueError(f"loss_sums: unsupported device {rows.device}")
    b, _, hc, wc = rows.shape
    oy, ox, fh, fw = roi
    nblk = -(-(hc * wc) // _BLOCK)
    partials = torch.empty((b, nblk, 2), dtype=torch.float32, device=rows.device)
    sums = torch.empty((b, 3), dtype=torch.float32, device=rows.device)
    kernels.launch(
        "dd_loss_fwd", "loss_fwd",
        rows.data_ptr(), ids.data_ptr(), gt6.data_ptr(),
        b, hc, wc, oy, ox, fh, fw, partials.data_ptr(), sums.data_ptr(),
    )
    return sums


def loss_bwd(rows, ids, gt6, roi, d_sums) -> torch.Tensor:
    """K6: d_rows (B, 32, hc, wc) from d_sums (B, 3).  CPU tensors take
    :func:`loss_bwd_plain`; CUDA tensors launch the kernel, anything else
    raises."""
    _check_loss_inputs(rows, ids, gt6)
    _check(d_sums, "d_sums", torch.float32, 2, rows.device)
    if rows.device.type == "cpu":
        return loss_bwd_plain(rows, ids, gt6, roi, d_sums)
    if rows.device.type != "cuda":
        raise ValueError(f"loss_bwd: unsupported device {rows.device}")
    b, _, hc, wc = rows.shape
    oy, ox, fh, fw = roi
    g = torch.empty((b, hc, wc), dtype=torch.float32, device=rows.device)
    d_rows = torch.empty_like(rows)
    kernels.launch(
        "dd_loss_bwd", "loss_bwd",
        rows.data_ptr(), ids.data_ptr(), gt6.data_ptr(), d_sums.data_ptr(),
        b, hc, wc, oy, ox, fh, fw, g.data_ptr(), d_rows.data_ptr(),
    )
    return d_rows


class RasterLossCompact(torch.autograd.Function):
    """(B, 3) loss sums from the compact bin table in one differentiable op
    (counterpart of ``fused_loss.raster_loss_compact``).

    Forward: K3 (raster) then K5 (loss sums).  Backward: K6 (d_rows, kept
    in f32) then K4 (d_bins).  Differentiable w.r.t. ``bins`` only; the
    ground truth is a constant.
    """

    @staticmethod
    def forward(ctx, bins, counts, off_c, used, gt6, k_chunk, frame_hw,
                tile_hw, roi):
        ids, rows, win = raster_fwd(
            bins, counts, off_c, used, k_chunk, frame_hw, tile_hw, roi
        )
        sums = loss_sums(rows, ids, gt6, roi)
        ctx.save_for_backward(rows, ids, win, gt6)
        ctx.n_slots = bins.shape[2]
        ctx.tile_hw = tile_hw
        ctx.roi = roi
        return sums

    @staticmethod
    def backward(ctx, d_sums):
        rows, ids, win, gt6 = ctx.saved_tensors
        d_rows = loss_bwd(rows, ids, gt6, ctx.roi, d_sums.contiguous())
        d_bins = raster_bwd(d_rows, win, ctx.n_slots, ctx.tile_hw)
        return d_bins, None, None, None, None, None, None, None, None


def raster_loss_compact(bins, counts, off_c, used, gt6, k_chunk, frame_hw,
                        tile_hw, roi) -> torch.Tensor:
    return RasterLossCompact.apply(
        bins, counts, off_c, used, gt6, k_chunk, tuple(frame_hw),
        tuple(tile_hw), tuple(roi),
    )
