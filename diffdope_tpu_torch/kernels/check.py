"""Kernel-versus-plain checks, timings and bounds on the card.

Used by ``chip_smoke.py`` and the CUDA tests: hold each kernel against
its plain torch version on the same inputs (the pack inputs and the table
of a fused loss from ``make_fused_loss``, or of a render function, at
given poses; for K8 the setup rows and bins of the ``rasterize`` op, for
K9 the packed rows and bins of ``gather_rows.raster_gather_rows``), and
time both.  A function's tables are checked in their own layout: K3/K4 on
the compact table, K7 on the uniform-K table, on the planar routes K10
('v3') or K7 over the gathered bins ('v2'); K5/K6 take the depth lane
(the ``_depth`` variants) where the loss has a depth term, and the colour
lane (the ``_color`` variants, on the colour planes the loss samples from
the raster's rows) where it samples a texture.

Tolerances: K1's table must equal ``planar.pack_binned``'s bit for bit in
all 32 lanes, K3's, K7's, K9's and K10's ids, slots and rows exactly, and
K8's ids exactly (same f32 operation order, no FMA); K5's sums rtol 1e-5,
atol 1e-7; K2's (d_mvp, d_mtx row 2), K6's d_rows and K4's, K7's, K9's and
K10's slot gradients (also reduced per triangle) rtol 2e-4, atol 1e-6
against the plain autograd, plus 1e-6 of a local scale; K6's d_dplane and
d_colors rtol 2e-4, atol 1e-6.  That term is
there because these gradients are sums of terms that can cancel: a pixel's
lane sums the rgb term (three channels through s) and up to four pair
terms, a slot sums its pixels, a d_mvp entry sums ~4e4 slots; a cancelled
sum keeps the f32 rounding of its largest terms, so its error is measured
against them, not against the small result.  The scale is the pixel's
largest lane (K6), the slot's sum of |d_rows| (K4) and the hypothesis'
sum of |terms| over slots and corners (K2).

Bounds: the least time the card could take for a kernel's work, the larger
of its bytes (each input the kernel must read, read once; each output
written once) over the HBM rate and its FP32 operations over the FP32
rate, from the shapes and data of the call: the table slots the tiles
hold, the foreground pixels whose rows are read, the lanes that carry a
gradient.  The operation counts are counted from the CUDA sources, as
estimates, per element or (K5/K6) per pixel and pair at the call's ids.

Library: where one PyTorch call computes a kernel's function (the raster
backwards K4, K7, K9 and K10: :func:`bwd_library`), the timed rows carry
its time as ``library_ms``, a yardstick the port never calls.

Renders: :func:`plain_render` makes a render's forward take the plain
twins of K1, K3 and K7 on the card too, to hold a whole render (e.g. the
composite of ``DiffDope.render_img``) against the kernel route's.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from diffdope_tpu_torch.render import gather_rows, pipeline, planar, raster_v3
from diffdope_tpu_torch.render.fused_loss import (
    loss_bwd,
    loss_bwd_plain,
    loss_sums,
    loss_sums_plain,
)
from diffdope_tpu_torch.render.pack_kernel import (
    _mvpm,
    _static_table,
    live_positions,
    pack_bwd,
    pack_fwd,
)
from diffdope_tpu_torch.render.pipeline import K_CHUNK, TILE_HW, slot_order_of
from diffdope_tpu_torch.render.raster import (
    bins_planar,
    raster_bwd,
    raster_bwd_plain,
    raster_fwd,
    raster_fwd_plain,
    raster_uniform_bwd,
    raster_uniform_bwd_plain,
    raster_uniform_fwd,
    raster_uniform_fwd_plain,
)
from diffdope_tpu_torch.render.rasterize import raster_ids, raster_ids_binned_plain
from diffdope_tpu_torch.render.setup_tris import bin_triangles, triangle_setup

#: which TPU kernel each port kernel replaces, and where it lives
KERNELS = {
    "K1_pack_fwd": (
        "diffdope_tpu_torch/csrc/pack.cu",
        "diffdope_tpu/render/pack_kernel.py:65",
    ),
    "K2_pack_bwd": (
        "diffdope_tpu_torch/csrc/pack.cu",
        "diffdope_tpu/render/pack_kernel.py:165",
    ),
    "K3_raster_fwd": (
        "diffdope_tpu_torch/csrc/raster.cu",
        "diffdope_tpu/render/raster_v2.py:178",
    ),
    "K4_raster_bwd": (
        "diffdope_tpu_torch/csrc/raster.cu",
        "diffdope_tpu/render/raster_v2.py:1040",
    ),
    "K4_raster_bwd_bf16": (
        "diffdope_tpu_torch/csrc/raster.cu",
        "diffdope_tpu/render/raster_v2.py:1040",
    ),
    "K5_loss_fwd": (
        "diffdope_tpu_torch/csrc/fused_loss.cu",
        "diffdope_tpu/render/fused_loss.py:221",
    ),
    "K6_loss_bwd": (
        "diffdope_tpu_torch/csrc/fused_loss.cu",
        "diffdope_tpu/render/fused_loss.py:268",
    ),
    "K6_loss_bwd_bf16": (
        "diffdope_tpu_torch/csrc/fused_loss.cu",
        "diffdope_tpu/render/fused_loss.py:268",
    ),
    "K7_raster_uniform_fwd": (
        "diffdope_tpu_torch/csrc/raster.cu",
        "diffdope_tpu/render/raster_v2.py:163",
    ),
    "K7_raster_uniform_bwd": (
        "diffdope_tpu_torch/csrc/raster.cu",
        "diffdope_tpu/render/raster_v2.py:1028",
    ),
    "K5_loss_fwd_depth": (
        "diffdope_tpu_torch/csrc/fused_loss.cu",
        "diffdope_tpu/render/fused_loss.py:221",
    ),
    "K6_loss_bwd_depth": (
        "diffdope_tpu_torch/csrc/fused_loss.cu",
        "diffdope_tpu/render/fused_loss.py:268",
    ),
    "K5_loss_fwd_color": (
        "diffdope_tpu_torch/csrc/fused_loss.cu",
        "diffdope_tpu/render/fused_loss.py:221",
    ),
    "K6_loss_bwd_color": (
        "diffdope_tpu_torch/csrc/fused_loss.cu",
        "diffdope_tpu/render/fused_loss.py:268",
    ),
    "K5_loss_fwd_color_depth": (
        "diffdope_tpu_torch/csrc/fused_loss.cu",
        "diffdope_tpu/render/fused_loss.py:221",
    ),
    "K6_loss_bwd_color_depth": (
        "diffdope_tpu_torch/csrc/fused_loss.cu",
        "diffdope_tpu/render/fused_loss.py:268",
    ),
    "K8_raster_ids": (
        "diffdope_tpu_torch/csrc/rasterize.cu",
        "diffdope_tpu/render/rasterize.py:110",
    ),
    "K9_gather_rows_fwd": (
        "diffdope_tpu_torch/csrc/rasterize.cu",
        "diffdope_tpu/render/gather_rows.py:123",
    ),
    "K9_gather_rows_bwd": (
        "diffdope_tpu_torch/csrc/rasterize.cu",
        "diffdope_tpu/render/gather_rows.py:191",
    ),
    "K10_raster_v3_fwd": (
        "diffdope_tpu_torch/csrc/raster.cu",
        "diffdope_tpu/render/raster_v3.py:161",
    ),
    "K10_raster_v3_bwd": (
        "diffdope_tpu_torch/csrc/raster_v3.cu",
        "diffdope_tpu/render/raster_v3.py:298",
    ),
}
#: launch counter of each kernel's wrapper (diffdope_tpu_torch.kernels)
COUNTERS = {
    "K1_pack_fwd": "pack_fwd",
    "K2_pack_bwd": "pack_bwd",
    "K3_raster_fwd": "raster_fwd",
    "K4_raster_bwd": "raster_bwd",
    "K4_raster_bwd_bf16": "raster_bwd_bf16",
    "K5_loss_fwd": "loss_fwd",
    "K6_loss_bwd": "loss_bwd",
    "K6_loss_bwd_bf16": "loss_bwd_bf16",
    "K7_raster_uniform_fwd": "raster_uniform_fwd",
    "K7_raster_uniform_bwd": "raster_uniform_bwd",
    "K5_loss_fwd_depth": "loss_fwd_depth",
    "K6_loss_bwd_depth": "loss_bwd_depth",
    "K5_loss_fwd_color": "loss_fwd_color",
    "K6_loss_bwd_color": "loss_bwd_color",
    "K5_loss_fwd_color_depth": "loss_fwd_color_depth",
    "K6_loss_bwd_color_depth": "loss_bwd_color_depth",
    "K8_raster_ids": "raster_ids",
    "K9_gather_rows_fwd": "gather_rows_fwd",
    "K9_gather_rows_bwd": "gather_rows_bwd",
    "K10_raster_v3_fwd": "raster_v3_fwd",
    "K10_raster_v3_bwd": "raster_v3_bwd",
}


#: one H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM3
#: bytes/s and FP32 (non-tensor-core) operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: FP32 operations per element, counted from the CUDA sources (estimates):
#: K1/K2 per (hypothesis, slot) at n_ch colour channels, K4 per (foreground
#: pixel, lane), K8 (and K9's search) per (pixel, slot) test: the three
#: edge functions (4 each) and their sign tests (a covered test's depth,
#: 8 more, is not counted: how many there are depends on the data).  K3,
#: K7, K10, K8 and K9 count them over the (pixel, slot) pairs inside each
#: slot's cover box only (:func:`range_tests`, :func:`bin_box_tests`): a
#: test outside it cannot cover, and the boxes, signing the planes and
#: 1/det are per-slot work.  K8's and K9's rows keep the TPU kernel's
#: tests, every pixel of a tile against every entry of its bin, as
#: ``tested_pairs``.  K5/K6 by :func:`_loss_ops`
_OPS = {"K1": lambda n_ch: 195 + 15 * n_ch, "K2": lambda n_ch: 330 + 18 * n_ch,
        "K3": 15, "K4": 1, "K8": 15}

#: K5/K6's FP32 operations by part of ``csrc/fused_loss.cu``, each add,
#: sub, mul, div, abs, min, max, negation and compare one (``ndc`` is 4):
#: a silhouette pair's crossing search (three ndc, seg, det_sign, 24 per
#: edge line, the deltas), once per pair in both kernels; K6's g at a pixel
#: on a silhouette pair (aa from its four deltas, the three signs, the
#: product) and a pair's backward at its foreground pixel;
#: ``shade_at``'s x, y, edges, s and s_safe, and per channel read its lin3
#: (and its division at a foreground pixel); K5's mask and rgb terms of a
#: pixel and its depth term; K6's rgb (or d_colors) cotangents of a pixel,
#: its depth cotangent, a channel's division backward and the edge lanes' d s
_LOSS_OPS = dict(search=97, g=15, pair_bwd=27, shade=24, channel=4, terms=21, depth=3,
                 rgb_bwd=12, depth_bwd=4, channel_bwd=7, edge_bwd=17)


def _silhouette(idv: torch.Tensor) -> Tuple[int, int, int]:
    """Of ``idv`` (B, h, w): the horizontal and vertical pairs with one
    pixel foreground and the other not, the foreground pixels in one, and
    all pixels in one."""
    fg = idv > 0
    h, v = fg[:, :, 1:] != fg[:, :, :-1], fg[:, 1:] != fg[:, :-1]
    edge = torch.zeros_like(fg)
    edge[:, :, 1:] |= h
    edge[:, :, :-1] |= h
    edge[:, 1:] |= v
    edge[:, :-1] |= v
    return int(h.sum()) + int(v.sum()), int((edge & fg).sum()), int(edge.sum())


def _loss_ops(ids: torch.Tensor, roi, depth: bool, colors: bool) -> Tuple[int, int]:
    """(K5, K6) FP32 operations at this call's ids, from the lanes' own
    bodies: both kernels run the crossing search once per silhouette pair
    and need no depth order (a pair of two foreground pixels adds +-0);
    K6 computes g at the pixels of silhouette pairs and a pair's backward
    once (the crossing test that gates it not replayed here); the
    attribute channels the launch shades: the rgb + mask lane three
    colours (and z with depth), the colour lane none (z alone with depth),
    at foreground pixels only.  Pairs and pixels past the real frame are
    not counted."""
    c = _LOSS_OPS
    b, hc, wc = ids.shape
    oy, ox, h, w = roi
    idv = ids[:, : min(hc, h - oy), : min(wc, w - ox)]
    n_px, n_fg = idv.numel(), int((idv > 0).sum())
    n_sil, _, n_sil_px = _silhouette(idv)
    n_read = (0 if colors else 3) + (1 if depth else 0)
    n_sums = 3 if depth else 2  # a pixel's adds in the block's tree
    # the pixel's colour test and the deltas' sum
    k5 = n_px * 5 + c["search"] * n_sil
    k5 += n_px * (c["terms"] + (c["depth"] if depth else 0) + n_sums)
    if n_read:
        k5 += n_fg * (c["shade"] + (c["channel"] + 1) * n_read)
    k6 = (c["search"] + c["pair_bwd"]) * n_sil + c["g"] * n_sil_px
    k6 += n_px * ((c["rgb_bwd"] if colors else 0) + (c["depth_bwd"] if depth else 0))
    if n_read:
        k6 += n_fg * (c["shade"] + (c["channel"] + 1 + c["channel_bwd"]) * n_read
                      + (0 if colors else c["rgb_bwd"]) + c["edge_bwd"])
    return k5, k6


def k5_row_lanes(ids: torch.Tensor, roi, depth: bool, colors: bool) -> int:
    """The row lanes K5's function must read at this call's ids, and K6's
    (the same set): at each real foreground pixel the edge planes (0-8)
    and the channels its lane shades (3 colours, or none on the colour
    lane, and z with depth; 3 lanes each) where it shades any; at a
    foreground pixel of a silhouette pair also the det and silhouette
    lanes (12, 14), and the edge planes where it shades none.  A pair of
    two foreground pixels adds nothing (``csrc/fused_loss.cu``'s
    silhouette gate), so it reads nothing."""
    b, hc, wc = ids.shape
    oy, ox, h, w = roi
    idv = ids[:, : min(hc, h - oy), : min(wc, w - ox)]
    n_read = (0 if colors else 3) + (1 if depth else 0)
    n_fg, n_edge = int((idv > 0).sum()), _silhouette(idv)[1]
    shade = 9 + 3 * n_read if n_read else 0
    return n_fg * shade + n_edge * (2 + (0 if n_read else 9))


def loss_bwd_bytes(ids: torch.Tensor, roi, depth: bool, colors: bool, d_rows_dtype) -> int:
    """The bytes K6's function must move at this call's ids: ids and the
    ground truth's six planes of every pixel, the row lanes of
    :func:`k5_row_lanes`, the depth plane (or the colour planes) in and
    its cotangent out, the (B, 3) cotangent of the sums, and all 32 lanes
    of d_rows at every pixel in ``d_rows_dtype``."""
    b, hc, wc = ids.shape
    npx = b * hc * wc
    planes = (4 * npx if depth else 0) + (12 * npx if colors else 0)
    return (4 * npx + 4 * 6 * hc * wc + 4 * k5_row_lanes(ids, roi, depth, colors)
            + 2 * planes + 4 * b * 3 + d_rows_bytes(32 * npx, d_rows_dtype))


def _box_tile_pixels(boxes, t: torch.Tensor, ntx: int, tile_hw, origin=(0, 0)) -> int:
    """The pixels of tile t (row-major, ``ntx`` a row, from ``origin``)
    inside each box ``boxes`` = (rlo, rhi, clo, chi) (B, n), summed."""
    th, tw = tile_hw
    rlo, rhi, clo, chi = boxes
    r0, c0 = (t // ntx) * th + origin[0], (t % ntx) * tw + origin[1]
    n_r = (torch.minimum(rhi, r0 + th - 1) - torch.maximum(rlo, r0) + 1).clamp(min=0)
    n_c = (torch.minimum(chi, c0 + tw - 1) - torch.maximum(clo, c0) + 1).clamp(min=0)
    return int((n_r * n_c).sum())


def range_tests(bins: torch.Tensor, slot_tile: torch.Tensor, frame_hw, tile_hw,
                roi) -> int:
    """The (hypothesis, pixel, slot) tests the K3/K7 forward cannot skip:
    for each slot a tile holds (``slot_tile`` (n_slots,), the slot's tile,
    -1 where no tile holds it), the tile's pixels inside the slot's cover
    box (``raster_v3.cover_ranges`` over the window, the box the kernel
    stages; empty for det == 0), summed over the table's hypotheses.
    Tiles are row-major over the (hc, wc) window ``frame_hw`` at
    ``roi=(oy, ox, fh, fw)``."""
    (hc, wc), (oy, ox, fh, fw) = frame_hw, roi
    slots = torch.nonzero(slot_tile >= 0).reshape(-1)
    boxes = raster_v3.cover_ranges(bins[:, :, slots], (fh, fw), (oy + hc, ox + wc))
    return _box_tile_pixels(boxes, slot_tile[slots].long(), wc // tile_hw[1], tile_hw,
                            (oy, ox))


def bin_box_tests(rows: torch.Tensor, tile_idx: torch.Tensor, counts: torch.Tensor,
                  resolution, tile_hw) -> Tuple[int, int]:
    """(box tests, tested pairs) of the K8/K9 forward on rows (B, T, W) of
    setup-row lanes (``setup_tris`` or ``shade.pack_rows``) and the bins
    tile_idx (num_tiles, K), counts: the (hypothesis, pixel, entry) tests
    it cannot skip, each held entry's triangle's cover box
    (``raster_v3.cover_ranges`` over the padded frame) met with its tile;
    and the TPU kernel's, every pixel of the tile against every held
    entry."""
    (h, w), (th, tw) = resolution, tile_hw
    nty, ntx = -(-h // th), -(-w // tw)
    k = tile_idx.shape[1]
    n = counts.long().clamp(max=k)
    held = torch.arange(k, device=n.device)[None, :] < n[:, None]
    tri = tile_idx.long().clamp(max=rows.shape[1] - 1)[held]
    t = torch.arange(n.numel(), device=n.device)[:, None].expand_as(held)[held]
    boxes = raster_v3.cover_ranges(rows.transpose(1, 2)[:, :, tri], resolution,
                                   (nty * th, ntx * tw))
    return (_box_tile_pixels(boxes, t, ntx, tile_hw),
            rows.shape[0] * int(n.sum()) * th * tw)


def held_slots(base: torch.Tensor, n: torch.Tensor, n_slots: int) -> torch.Tensor:
    """(n_slots,) the tile holding each slot, -1 for none: tile t holds
    [base[t], base[t] + n[t])."""
    out = torch.full((n_slots,), -1, dtype=torch.long, device=base.device)
    j = torch.arange(int(n.max()) if n.numel() else 0, device=base.device)
    ok = j[None, :] < n[:, None]
    slot = (base[:, None] + j[None, :])[ok]
    tile = torch.arange(n.numel(), device=base.device)[:, None].expand_as(ok)[ok]
    out[slot] = tile
    return out


def d_rows_bytes(n_values: int, dtype) -> int:
    """The bytes of ``n_values`` d_rows values in ``dtype``: 4 in f32, 2 in
    the spanning op's bf16 lane."""
    return n_values * (2 if dtype == torch.bfloat16 else 4)


def bound(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """(ms, 'bytes' | 'operations'): the least time for ``n_bytes`` moved
    and ``n_ops`` FP32 operations on one H100, and which of the two sets it."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(f, reps: int) -> float:
    f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        f()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _excess(got, want, rtol, atol, scale=None):
    bound = atol + rtol * want.abs()
    if scale is not None:
        bound = bound + 1e-6 * scale
    return (got - want).abs() - bound


def _close(got, want, rtol, atol, scale=None) -> bool:
    return bool(torch.all(_excess(got, want, rtol, atol, scale) <= 0))


def _worst(got, want, rtol, atol, scale) -> Dict[str, object]:
    """Where ``got`` is furthest outside the tolerance: the element, both
    values, the local scale, and how many elements are outside."""
    excess = _excess(got, want, rtol, atol, scale)
    i = int(excess.argmax())
    idx = tuple(int(v) for v in torch.unravel_index(torch.tensor(i), got.shape))
    return dict(n_outside=int((excess > 0).sum()), at=idx,
                got=float(got.reshape(-1)[i]), want=float(want.reshape(-1)[i]),
                local_scale=float(scale.expand_as(got).reshape(-1)[i]))


class _RasterSpec(NamedTuple):
    """The raster kernel pair of a function's table layout: names, kernel
    and plain calls, the table (B, 32, n_slots) whose lane 13 maps a slot
    to its triangle, and the bounds' inputs."""

    f_name: str
    b_name: str
    fwd: Callable
    fwd_plain: Callable
    bwd: Callable  # (d_rows, win) -> d_slots
    bwd_plain: Callable
    packed: torch.Tensor
    fwd_bound: Callable  # (win, fg) -> (ms, by)
    written: int  # output floats of the backward: all of d_bins
    info: Dict[str, object]


def _binned_spec(fn, mtx, npx: int) -> _RasterSpec:
    """K3/K4 on the compact table, K7 on the uniform one."""
    with torch.no_grad():
        tab = fn.table(mtx)
    packed, counts = tab.packed, tab.counts
    b, _, n_slots = packed.shape
    if tab.off_c is None:  # the uniform table: K7
        k = n_slots // counts.numel()
        n = counts.long().clamp(max=k)
        held = held_slots(torch.arange(counts.numel(), device=n.device) * k, n, n_slots)
        names = ("K7_raster_uniform_fwd", "K7_raster_uniform_bwd")
        res = fn.roi[2:]
        frame = (-(-res[0] // TILE_HW[0]) * TILE_HW[0], -(-res[1] // TILE_HW[1]) * TILE_HW[1])
        calls = (lambda: raster_uniform_fwd(packed, counts, res, TILE_HW),
                 lambda: raster_uniform_fwd_plain(packed, counts, res, TILE_HW),
                 lambda d, win: raster_uniform_bwd(d, win, n_slots, TILE_HW),
                 lambda d, win: raster_uniform_bwd_plain(d, win, n_slots))
        n_read = int(n.sum())  # slots the tiles hold
    else:
        args = (packed, counts, tab.off_c, tab.used, K_CHUNK, fn.frame_hw, TILE_HW,
                fn.roi)
        n = torch.minimum(counts, tab.used * K_CHUNK).long()
        held = held_slots(tab.off_c.long() * K_CHUNK, n, n_slots)
        frame = fn.frame_hw
        names = ("K3_raster_fwd", "K4_raster_bwd")
        calls = (lambda: raster_fwd(*args), lambda: raster_fwd_plain(*args),
                 lambda d, win: raster_bwd(d, win, n_slots, TILE_HW, tab.off_c, tab.used,
                                           K_CHUNK),
                 lambda d, win: raster_bwd_plain(d, win, n_slots))
        n_read = int(n.sum())
    tested = range_tests(packed, held, frame, TILE_HW, fn.roi)

    def fwd_bound(win, fg):
        # the forward reads 14 lanes of every slot its tiles hold, the other
        # 18 lanes of each won slot, and writes ids, win and every pixel's
        # 32 lanes; it tests the pixels in each slot's range
        return bound(4 * (b * 14 * n_read + 18 * _won(win, n_slots) + 3 * counts.numel())
                     + npx * (4 + 4 + 4 * 32), _OPS["K3"] * tested)

    info = dict(slots=n_read, table_slots=n_slots, range_tests=tested)
    if tab.off_c is not None:  # the slots past every tile's chunks
        info["tail_slots"] = n_slots - int(((tab.off_c + tab.used) * K_CHUNK).max())
    return _RasterSpec(*names, *calls, packed, fwd_bound, packed.numel(), info)


def _won(win: torch.Tensor, n_slots: int) -> int:
    """How many (hypothesis, slot) pairs win a pixel."""
    b = win.shape[0]
    w = win.reshape(b, -1).long()
    w = w + n_slots * torch.arange(b, device=w.device)[:, None]
    return int(torch.unique(w[win.reshape(b, -1) >= 0]).numel())


def exact_bin_slots(mesh, mtx: torch.Tensor, resolution) -> int:
    """The (tile, triangle) pairs of exact per-tile bins at poses ``mtx``
    (the port's tile, no capacity, no cull): the slots K7 would walk."""
    with torch.no_grad():
        _, cp, det = pipeline._planar_pack(mesh, mtx)
        _, counts, _ = planar.bin_triangles_planar(cp, det, resolution, TILE_HW,
                                                   mesh.t_count)
    return int(counts.sum())


def _planar_spec(fn, mtx, npx: int) -> _RasterSpec:
    """K10 on the 'v3' route's sorted table; K7 over the bins gathered from
    the triangle-order table on 'v2'."""
    with torch.no_grad():
        pl = fn.planar(mtx)
    res = fn.roi[2:]
    b = pl.packed.shape[0]
    if pl.idx is None:  # 'v3': K10
        tables = raster_v3.prepare(pl.packed, res, TILE_HW)
        packed = raster_v3.sorted_table(pl.packed, tables)
        n_slots = tables.t_pad
        calls = (lambda: raster_v3.raster_v3_fwd(packed, tables, res, TILE_HW),
                 lambda: raster_v3.raster_v3_fwd_plain(packed, tables, res, TILE_HW),
                 lambda d, win: raster_v3.raster_v3_bwd(d, win, tables, TILE_HW),
                 lambda d, win: raster_v3.raster_v3_bwd_plain(d, win, n_slots))
        exact = exact_bin_slots(fn.mesh, mtx, res)
        nty, ntx = (-(-n // t) for n, t in zip(res, TILE_HW))
        gate = raster_v3._gate(tables, nty, ntx, TILE_HW[0])
        walked = int(gate.sum()) * tables.k_chunk
        # the tests exact per-tile bins need at these poses: each triangle's
        # range over the padded frame (as K3's over its tiles)
        tested = range_tests(pl.packed, torch.zeros(pl.packed.shape[2], dtype=torch.long,
                                                    device=pl.packed.device),
                             (nty * TILE_HW[0], ntx * TILE_HW[1]),
                             (nty * TILE_HW[0], ntx * TILE_HW[1]), (0, 0) + tuple(res))

        def fwd_bound(win, fg):
            # bytes: 14 lanes of every triangle, the other 18 of each won
            # slot, the tables, and ids, win and 32 lanes of every pixel
            return bound(4 * (b * 14 * n_slots + 18 * _won(win, n_slots)
                              + 2 * tables.rlo_tc.numel()) + npx * (4 + 4 + 4 * 32),
                         _OPS["K3"] * tested)

        return _RasterSpec("K10_raster_v3_fwd", "K10_raster_v3_bwd", *calls, packed,
                           fwd_bound, b * 32 * n_slots,
                           dict(slots=walked, table_slots=n_slots, exact_slots=exact,
                                range_tests=tested))
    bins = bins_planar(pl.packed, pl.idx)
    n_slots = bins.shape[2]
    k = n_slots // pl.counts.numel()
    n = pl.counts.long().clamp(max=k)
    n_read = int(n.sum())
    frame = (-(-res[0] // TILE_HW[0]) * TILE_HW[0], -(-res[1] // TILE_HW[1]) * TILE_HW[1])
    tested = range_tests(bins, held_slots(torch.arange(n.numel(), device=n.device) * k,
                                          n, n_slots), frame, TILE_HW, (0, 0) + tuple(res))
    calls = (lambda: raster_uniform_fwd(bins, pl.counts, res, TILE_HW),
             lambda: raster_uniform_fwd_plain(bins, pl.counts, res, TILE_HW),
             lambda d, win: raster_uniform_bwd(d, win, n_slots, TILE_HW),
             lambda d, win: raster_uniform_bwd_plain(d, win, n_slots))

    def fwd_bound(win, fg):
        return bound(4 * (b * 14 * n_read + 18 * _won(win, n_slots)
                          + 3 * pl.counts.numel()) + npx * (4 + 4 + 4 * 32),
                     _OPS["K3"] * tested)

    return _RasterSpec("K7_raster_uniform_fwd", "K7_raster_uniform_bwd", *calls, bins,
                       fwd_bound, bins.numel(),
                       dict(slots=n_read, table_slots=n_slots, range_tests=tested,
                            occupancy=int(pl.telemetry["_bin_occupancy"])))


def check_kernels(fn, mtx: torch.Tensor, d_sums: Optional[torch.Tensor] = None,
                  reps: int = 0) -> List[Dict[str, object]]:
    """The raster kernels of ``fn``'s table layout (K3/K4 compact, K7
    uniform; on a planar route K10 on 'v3' and K7 over the gathered bins
    on 'v2') and, for a fused loss, K5/K6 (their depth variants where the
    loss has a depth term), each against its plain version on the table of
    ``mtx``.

    ``fn`` is a fused loss (``make_fused_loss``: the raster forward, its
    texture samples on the texture route, K5, K6, then the raster backward
    under K6's d_rows for the cotangent ``d_sums``) or a render function (``DiffDope._make_render_fn``, the
    unfused route: the raster forward, then its backward under a seeded
    normal d_rows on every lane).  Returns one dict per kernel: name, ok,
    max_abs_err, tolerance, bound (the raster rows also the slots the
    tiles hold, or K10 walks, and the table's slots), and, when ``reps`` >
    0, ms and plain_ms (CUDA events over ``reps`` launches after one
    warm-up)."""
    fused = getattr(fn, "gt6", None) is not None
    with torch.no_grad():
        dplane = fn.dplane(mtx) if fused else None
    b = mtx.shape[0]
    hc, wc = fn.frame_hw
    npx = b * hc * wc
    spec = (_planar_spec if getattr(fn, "route", None) else _binned_spec)(fn, mtx, npx)
    n_slots = spec.packed.shape[2]
    out = []

    ids, rows, win = spec.fwd()
    ids_p, rows_p, win_p = spec.fwd_plain()
    err = float((rows - rows_p).abs().max())
    ok = bool(torch.equal(ids, ids_p) and torch.equal(win, win_p)
              and torch.equal(rows, rows_p))
    fg = int((ids > 0).sum())
    out.append(dict(name=spec.f_name, ok=ok, max_abs_err=err,
                    tolerance="ids, slots and rows exactly equal", fg_pixels=fg,
                    id_mismatches=int((ids != ids_p).sum()),
                    bound=spec.fwd_bound(win, fg), **spec.info))

    if fused:
        depth = dplane is not None
        colors = None
        if getattr(fn, "sample", None) is not None:
            with torch.no_grad():
                colors = fn.sample(rows, ids)
        sfx = ("_color" if colors is not None else "") + ("_depth" if depth else "")
        # K5/K6 read ids everywhere, the planes (the depth plane, the colour
        # planes) and, where ids > 0 only (a background pixel shades to 0;
        # a mask pair reads its foreground side), the row lanes of
        # k5_row_lanes; K6 writes d_rows, d_dplane and d_colors everywhere
        # (loss_bwd_bytes)
        plane_bytes = (4 * npx if depth else 0) + (12 * npx if colors is not None else 0)
        loss_args = (rows, ids, fn.gt6, fn.roi)
        ops5, ops6 = _loss_ops(ids, fn.roi, depth, colors is not None)
        sums = loss_sums(*loss_args, dplane, colors)
        sums_p = loss_sums_plain(*loss_args, dplane, colors)
        out.append(dict(name="K5_loss_fwd" + sfx, ok=_close(sums, sums_p, 1e-5, 1e-7),
                        max_abs_err=float((sums - sums_p).abs().max()),
                        tolerance="rtol 1e-5, atol 1e-7",
                        bound=bound(4 * npx + 4 * k5_row_lanes(ids, fn.roi, depth,
                                                               colors is not None)
                                    + 4 * fn.gt6.numel() + plane_bytes + 4 * b * 3, ops5)))

        d_rows, d_dplane, d_colors = loss_bwd(*loss_args, d_sums, dplane, colors)
        d_rows_p, d_dplane_p, d_colors_p = loss_bwd_plain(*loss_args, d_sums, dplane,
                                                          colors)
        px_scale = d_rows_p.abs().amax(dim=1, keepdim=True)
        ok6 = _close(d_rows, d_rows_p, 2e-4, 1e-6, px_scale)
        err6 = float((d_rows - d_rows_p).abs().max())
        tol6 = "d_rows rtol 2e-4, atol 1e-6 + 1e-6 x pixel's largest lane"
        for plane, name in ((d_dplane, "d_dplane"), (d_colors, "d_colors")):
            if plane is not None:
                want = d_dplane_p if name == "d_dplane" else d_colors_p
                ok6 = ok6 and _close(plane, want, 2e-4, 1e-6)
                err6 = max(err6, float((plane - want).abs().max()))
                tol6 += f"; {name} rtol 2e-4, atol 1e-6"
        out.append(dict(name="K6_loss_bwd" + sfx, ok=ok6, max_abs_err=err6,
                        tolerance=tol6,
                        worst=_worst(d_rows, d_rows_p, 2e-4, 1e-6, px_scale),
                        bound=bound(loss_bwd_bytes(ids, fn.roi, depth, colors is not None,
                                                   torch.float32), ops6)))
    else:
        gen = torch.Generator(device=rows.device).manual_seed(0)
        d_rows = torch.randn(rows.shape, generator=gen, device=rows.device)

    tri = spec.packed[0, 13].long()  # triangle of each slot (sentinel: T)

    def per_triangle(d):
        acc = d.new_zeros((d.shape[0], d.shape[1], int(tri.max()) + 1))
        return acc.index_add_(2, tri, d)

    def check_bwd(name, d_rows):
        d_bins = spec.bwd(d_rows, win)
        d_bins_p = spec.bwd_plain(d_rows, win)
        slot_scale = spec.bwd_plain(d_rows.abs(), win)
        ok4 = _close(d_bins, d_bins_p, 2e-4, 1e-6, slot_scale) and _close(
            per_triangle(d_bins), per_triangle(d_bins_p), 2e-4, 1e-6,
            per_triangle(slot_scale))
        # the backward reads win everywhere and d_rows only at foreground
        # pixels, and writes its output, all of it (K4 and K7 their tables'
        # tails and padding too, with no zero fill before them)
        return dict(name=name, ok=ok4, **spec.info,
                    max_abs_err=float((d_bins - d_bins_p).abs().max()),
                    tolerance="rtol 2e-4, atol 1e-6 + 1e-6 x sum |d_rows|, "
                              "per slot and per triangle",
                    worst=_worst(d_bins, d_bins_p, 2e-4, 1e-6, slot_scale),
                    bound=bound(4 * npx + d_rows_bytes(32 * fg, d_rows.dtype)
                                + 4 * spec.written, _OPS["K4"] * 32 * fg))

    out.append(check_bwd(spec.b_name, d_rows))
    timed = {spec.f_name: (spec.fwd, spec.fwd_plain),
             spec.b_name: (lambda: spec.bwd(d_rows, win),
                           lambda: spec.bwd_plain(d_rows, win))}
    if fused and getattr(fn, "drows_bf16", False):
        # the spanning op's bf16 lane: K6's values rounded once (its f32
        # lane's output cast to bf16 bit for bit; the plain twin's within
        # K6's tolerance plus one bf16 spacing of each value), then K4 on
        # the same bf16 d_rows as its plain twin
        bf16 = torch.bfloat16
        d16, _, _ = loss_bwd(*loss_args, d_sums, d_rows_dtype=bf16)
        want = d_rows_p.to(bf16).float()
        spacing = torch.where(want == 0, 0.0, torch.ldexp(torch.ones_like(want),
                                                          torch.frexp(want)[1] - 8))
        ok16 = bool(torch.equal(d16, d_rows.to(bf16))) and _close(
            d16.float(), want, 2e-4, 1e-6 + spacing, px_scale)
        out.append(dict(name="K6_loss_bwd_bf16", ok=ok16,
                        max_abs_err=float((d16.float() - want).abs().max()),
                        tolerance="the f32 lane's d_rows rounded to bf16 bit for bit; "
                                  + tol6 + " + one bf16 spacing of each value",
                        worst=_worst(d16.float(), want, 2e-4, 1e-6 + spacing, px_scale),
                        bound=bound(loss_bwd_bytes(ids, fn.roi, False, False, bf16), ops6)))
        out.append(check_bwd("K4_raster_bwd_bf16", d16))
        timed["K6_loss_bwd_bf16"] = (
            lambda: loss_bwd(*loss_args, d_sums, d_rows_dtype=bf16),
            lambda: loss_bwd_plain(*loss_args, d_sums)[0].to(bf16))
        timed["K4_raster_bwd_bf16"] = (lambda: spec.bwd(d16, win),
                                       lambda: spec.bwd_plain(d16, win))

    if reps:
        if fused:
            timed["K5_loss_fwd" + sfx] = (
                lambda: loss_sums(*loss_args, dplane, colors),
                lambda: loss_sums_plain(*loss_args, dplane, colors))
            timed["K6_loss_bwd" + sfx] = (
                lambda: loss_bwd(*loss_args, d_sums, dplane, colors),
                lambda: loss_bwd_plain(*loss_args, d_sums, dplane, colors))
        # one PyTorch call computes each raster backward's function
        library = {spec.b_name: lambda: bwd_library(d_rows, win, n_slots)}
        if "K4_raster_bwd_bf16" in timed:
            library["K4_raster_bwd_bf16"] = lambda: bwd_library(d16, win, n_slots)
        for row in out:
            kern, plain = timed[row["name"]]
            row["ms"] = _time_ms(kern, reps)
            row["plain_ms"] = _time_ms(plain, max(1, reps // 10))
            if row["name"] in library:
                row["library_ms"] = _time_ms(library[row["name"]], reps)
    return out


def bwd_library(d_rows: torch.Tensor, win: torch.Tensor, n_slots: int) -> torch.Tensor:
    """K4's function (and K7's, K9's and K10's) in one PyTorch call, the library
    yardstick of the kernel table (the port never calls it): ``scatter_add_``
    of d_rows (bf16 widened to f32) into a zeroed (B, 32, n_slots + 1) by
    each pixel's winner slot, background pixels into the extra slot; the
    result is its first n_slots.  Atomic adds: the order of a slot's sum
    varies from call to call."""
    b, width = d_rows.shape[:2]
    slot = torch.where(win >= 0, win, n_slots).reshape(b, 1, -1).long()
    out = torch.zeros((b, width, n_slots + 1), dtype=torch.float32, device=d_rows.device)
    out.scatter_add_(2, slot.expand(b, width, -1), d_rows.reshape(b, width, -1).float())
    return out[:, :, :n_slots]


def _pack_term_scale(fn, bn, mtx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(B, 19): per hypothesis and output of K2, the sum over slots and
    corners of |d_coord_r[k] * p[k][c]| (|d_coord_r[k]| for the translation
    column): the magnitude of the terms K2 adds.  d_coord is the plain
    autograd of ``planar.packed_planar`` at the slots' corner coordinates."""
    mesh = fn.mesh
    t_count = mesh.t_count
    safe = bn.flat.clamp(max=t_count - 1)
    table, n_ch = mesh.static
    tab = table[:, safe]
    pk = [[tab[3 * k + c][None] for c in range(3)] for k in range(3)]
    mvp, mtx = bn.mvp.detach(), mtx.detach()

    def corners(m, trans):
        return [(m[:, 0:1] * pk[k][0] + m[:, 1:2] * pk[k][1] + m[:, 2:3] * pk[k][2]
                 + trans[:, None]).requires_grad_(True) for k in range(3)]

    cp = {name: corners(mvp[:, r, :3], mvp[:, r, 3]) for r, name in enumerate("xyzw")}
    zrot = corners(mtx[:, 2, :3], mtx.new_zeros(mtx.shape[:1]))
    attr = ([[tab[9 + k * n_ch + c][None] for c in range(n_ch)] for k in range(3)]
            if n_ch else None)
    degen = (bn.flat >= t_count) | (tab[9 + 3 * n_ch] > 0.5)
    with torch.enable_grad():
        packed = planar.packed_planar(cp, attr, zrot, degen, bn.flat, bn.sil[:, safe])
        leaves = [c for name in "xyzw" for c in cp[name]] + zrot
        d = torch.autograd.grad(packed, leaves, g)
    cols = []
    for r in range(5):
        dk = d[3 * r: 3 * r + 3]
        for c in range(3):
            cols.append(sum((dk[k] * pk[k][c]).abs() for k in range(3)).sum(dim=1))
        if r < 4:
            cols.append(sum(dk[k].abs() for k in range(3)).sum(dim=1))
    return torch.stack(cols, dim=1)


class PackInputs(NamedTuple):
    """K1/K2's inputs for a function's table at some poses."""

    bn: object  # the function's binned slots (``fn.binned``)
    mvpm: torch.Tensor  # (B, 20)
    tab: torch.Tensor  # (9 + 3 n_ch + 2, n) static rows, ids, degenerate flag
    sil_b: torch.Tensor  # (B, n)
    n_ch: int
    order: Optional[torch.Tensor]  # K2's places (pipeline.slot_order_of)


def pack_inputs(fn, mtx: torch.Tensor) -> PackInputs:
    """The pack kernels' inputs for ``fn``'s table at poses ``mtx``, as
    ``pack_kernel.pack_binned_auto`` makes them."""
    t_count = fn.mesh.t_count
    with torch.no_grad():
        bn = fn.binned(mtx)
    tab, n_ch = _static_table(bn.flat, t_count, fn.mesh.static)
    sil_b = bn.sil[:, bn.flat.clamp(max=t_count - 1)].to(torch.float32).contiguous()
    return PackInputs(bn, _mvpm(bn.mvp, mtx), tab.contiguous(), sil_b, n_ch,
                      slot_order_of(bn, fn.mesh))


def pack_bwd_bytes(tab: torch.Tensor, b: int, n_ch: int) -> int:
    """The bytes K2's function must move: the degenerate row of every slot;
    for each slot whose flag is clear (a degenerate slot's terms are all
    +-0) its 9 + 3 n_ch static rows and, per hypothesis, the 16 + 3 n_ch
    cotangent lanes that carry a gradient; the (B, 20) scalars in and the
    (B, 19) sums out."""
    live = int((tab[-1] <= 0.5).sum())
    return 4 * (tab.shape[1] + live * (9 + 3 * n_ch) + b * live * (16 + 3 * n_ch)
                + b * (20 + 19))


def check_pack(fn, mtx: torch.Tensor, reps: int = 0) -> List[Dict[str, object]]:
    """K1 and K2 against ``planar.pack_binned`` and its autograd, on the
    pack inputs of ``fn`` at poses ``mtx``; K2 under a seeded normal
    cotangent on every lane.

    Returns one dict per kernel, as :func:`check_kernels` does."""
    mesh = fn.mesh
    t_count = mesh.t_count
    bn, mvpm, tab, sil_b, n_ch, order = pack_inputs(fn, mtx)
    b, n = mvpm.shape[0], tab.shape[1]

    def plain(mvp, mtx_):
        return planar.pack_binned(mesh.pos_c, mvp, mtx_, bn.flat, mesh.attrs, bn.sil,
                                  mesh.degenerate, t_count, mesh.static)

    out = []
    got = pack_fwd(mvpm, tab, sil_b, n_ch)
    with torch.no_grad():
        want = plain(bn.mvp, mtx)
    bits = got.view(torch.int32) != want.view(torch.int32)
    out.append(dict(name="K1_pack_fwd", ok=not bool(bits.any()),
                    max_abs_err=float((got - want).abs().max()),
                    tolerance="all 32 lanes bit for bit",
                    lanes_differing=sorted({int(v) for v in bits.nonzero()[:, 1]}),
                    bound=bound(4 * (mvpm.numel() + tab.numel() + sil_b.numel()
                                     + got.numel()), _OPS["K1"](n_ch) * b * n)))

    gen = torch.Generator(device=mvpm.device).manual_seed(0)
    g = torch.randn(got.shape, generator=gen, device=mvpm.device)
    d = pack_bwd(mvpm, tab, g, n_ch, order)
    leaves = (bn.mvp.detach().requires_grad_(True), mtx.detach().requires_grad_(True))
    with torch.enable_grad():
        packed_p = plain(*leaves)
        d_mvp, d_mtx = torch.autograd.grad(packed_p, leaves, g, retain_graph=True)
    want2 = torch.cat([d_mvp.reshape(b, 16), d_mtx[:, 2, :3]], dim=1)
    rest = d_mtx.clone()
    rest[:, 2, :3] = 0.0
    scale = _pack_term_scale(fn, bn, mtx, g)
    live = int((tab[-1] <= 0.5).sum())  # slots whose terms are not all +-0
    ok2 = _close(d, want2, 2e-4, 1e-6, scale) and not bool(rest.any())
    out.append(dict(name="K2_pack_bwd", ok=ok2,
                    max_abs_err=float((d - want2).abs().max()),
                    tolerance="rtol 2e-4, atol 1e-6 + 1e-6 x the hypothesis' "
                              "sum of |terms|",
                    worst=_worst(d, want2, 2e-4, 1e-6, scale),
                    slots=live, table_slots=n,
                    bound=bound(pack_bwd_bytes(tab, b, n_ch), _OPS["K2"](n_ch) * b * live)))
    if reps:
        with torch.no_grad():
            out[0]["ms"] = _time_ms(lambda: pack_fwd(mvpm, tab, sil_b, n_ch), reps)
            out[0]["plain_ms"] = _time_ms(lambda: plain(bn.mvp, mtx), max(1, reps // 10))
            out[1]["ms"] = _time_ms(lambda: pack_bwd(mvpm, tab, g, n_ch, order), reps)
        out[1]["plain_ms"] = _time_ms(
            lambda: torch.autograd.grad(packed_p, leaves, g, retain_graph=True),
            max(1, reps // 10))
    return out


@torch.no_grad()
def check_pack_layouts(fn_a, fn_b, mtx: torch.Tensor, reps: int = 0) -> Dict[str, object]:
    """K2 on two layouts of one set of bins (the compact table and the
    uniform-K table, or another crop) at poses ``mtx``: the live slots must
    be the same in the same order; each table then takes one seeded normal
    cotangent on its live slots and another on its padding, and K2 must
    give the two tables the same (B, 19) bit for bit.  With ``reps`` K2 is
    timed on each table ('ms_a', 'ms_b')."""
    a, b_ = pack_inputs(fn_a, mtx), pack_inputs(fn_b, mtx)
    out = {"name": "K2_pack_bwd layouts", "tolerance": "bit for bit"}
    pos_a, pos_b = live_positions(a.tab), live_positions(b_.tab)
    m = pos_a.numel()
    same = m == pos_b.numel() and torch.equal(a.bn.flat[pos_a], b_.bn.flat[pos_b])
    out.update(slots=m, table_slots=(a.tab.shape[1], b_.tab.shape[1]),
               same_slots=bool(same))
    if not same:
        out.update(ok=False, max_abs_err=float("inf"))
        return out
    gen = torch.Generator(device=mtx.device).manual_seed(0)
    bsz = mtx.shape[0]
    g_live = torch.randn((bsz, 32, m), generator=gen, device=mtx.device)

    def cotangent(n, pos):
        g = torch.randn((bsz, 32, n), generator=gen, device=mtx.device)  # the padding's
        g[:, :, pos] = g_live
        return g

    g_a, g_b = cotangent(a.tab.shape[1], pos_a), cotangent(b_.tab.shape[1], pos_b)
    d_a = pack_bwd(a.mvpm, a.tab, g_a, a.n_ch, a.order)
    d_b = pack_bwd(b_.mvpm, b_.tab, g_b, b_.n_ch, b_.order)
    out.update(ok=torch.equal(d_a.view(torch.int32), d_b.view(torch.int32)),
               max_abs_err=float((d_a - d_b).abs().max()))
    if reps:
        out["ms_a"] = _time_ms(lambda: pack_bwd(a.mvpm, a.tab, g_a, a.n_ch, a.order), reps)
        out["ms_b"] = _time_ms(lambda: pack_bwd(b_.mvpm, b_.tab, g_b, b_.n_ch, b_.order),
                               reps)
    return out


@torch.no_grad()
def raster_ids_inputs(pos_clip: torch.Tensor, tri: torch.Tensor, resolution,
                      tile_hw) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K8's inputs at clip positions ``pos_clip`` (B, N, 4): the setup rows
    (B, T, 16), and the bins and counts of ``setup_tris.bin_triangles``
    with K the fullest tile's count rounded up to 128, so that no (tile,
    triangle) pair drops (raises if one does)."""
    setup = triangle_setup(pos_clip, tri)
    corners = pos_clip[:, tri.long()]
    _, counts, _ = bin_triangles(corners, setup.det, resolution, tile_hw, tri.shape[0])
    k = max(128, -(-int(counts.max()) // 128) * 128)
    idx, counts, overflow = bin_triangles(corners, setup.det, resolution, tile_hw, k)
    if int(overflow):
        raise RuntimeError(f"{int(overflow)} (tile, triangle) pairs dropped at K={k}")
    return setup.coef.contiguous(), idx, counts


def check_raster_ids(coef: torch.Tensor, tile_idx: torch.Tensor, counts: torch.Tensor,
                     resolution, tile_hw, reps: int = 0) -> Dict[str, object]:
    """K8 against ``raster_ids_binned_plain`` on the same inputs: ids
    exactly equal.  The bound reads lanes 0-12 of each triangle row the
    tiles hold once per hypothesis, the valid bin entries and the counts,
    and writes the padded frame's ids; its operations are ``_OPS['K8']``
    per (hypothesis, pixel, slot) test inside the slots' cover boxes
    (:func:`bin_box_tests`; the TPU kernel's all-pairs count is the row's
    ``tested_pairs``).  With ``reps``,
    ms (CUDA events over ``reps`` launches after one warm-up) and
    plain_ms (the plain twin's one call that the check makes, timed)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ids = raster_ids(coef, tile_idx, counts, resolution, tile_hw)
    torch.cuda.synchronize()
    start.record()
    plain = raster_ids_binned_plain(coef, tile_idx, counts, resolution, tile_hw)
    end.record()
    torch.cuda.synchronize()
    b, k = coef.shape[0], tile_idx.shape[1]
    (h, w), (th, tw) = resolution, tile_hw
    n = counts.long().clamp(max=k)
    held = torch.arange(k, device=n.device)[None, :] < n[:, None]
    slots = int(n.sum())
    rows = int(torch.unique(tile_idx[held]).numel())
    frame_px = -(-h // th) * th * (-(-w // tw) * tw)
    tests, pairs = bin_box_tests(coef, tile_idx, counts, resolution, tile_hw)
    row = dict(name="K8_raster_ids", ok=bool(torch.equal(ids, plain)),
               max_abs_err=float((ids - plain).abs().max()),
               tolerance="ids exactly equal", id_mismatches=int((ids != plain).sum()),
               slots=slots, table_slots=tile_idx.numel(), fg_pixels=int((ids > 0).sum()),
               k=k, fullest=int(n.max()), range_tests=tests, tested_pairs=pairs,
               bound=bound(4 * (b * 13 * rows + slots + counts.numel() + b * frame_px),
                           _OPS["K8"] * tests))
    if reps:
        row["ms"] = _time_ms(lambda: raster_ids(coef, tile_idx, counts, resolution, tile_hw),
                             reps)
        row["plain_ms"] = start.elapsed_time(end)
    return row


@torch.no_grad()
def gather_rows_inputs(pos_clip: torch.Tensor, tri: torch.Tensor, resolution, tile_hw,
                       colors: torch.Tensor, edge_adj: Optional[torch.Tensor] = None):
    """K9's inputs at clip positions ``pos_clip`` (B, N, 4): the
    ``shade.pack_rows`` rows (B, T, 32) of the setup, its silhouette bits
    and the attribute planes of the per-vertex ``colors`` and the clip z,
    and ``setup_tris.bin_triangles``' bins with K the fullest tile's
    count rounded up to 128 (raises if a pair drops)."""
    from diffdope_tpu_torch.render.shade import attribute_planes, pack_rows, silhouette_bits

    coef, idx, counts = raster_ids_inputs(pos_clip, tri, resolution, tile_hw)
    setup = triangle_setup(pos_clip, tri)
    b, t = setup.det.shape
    corner_vals = torch.cat([colors[tri.long()].expand(b, t, 3, 3),
                             pos_clip[:, tri.long(), 2:3]], dim=-1)
    packed = pack_rows(setup, silhouette_bits(setup.det, edge_adj),
                       attribute_planes(corner_vals, setup))
    return packed.contiguous(), idx, counts


def check_gather_rows(packed: torch.Tensor, tile_idx: torch.Tensor, counts: torch.Tensor,
                      resolution, tile_hw, reps: int = 0) -> List[Dict[str, object]]:
    """K9 forward and backward against their plain versions on the same
    inputs: ids, win and rows exactly equal; d_bin under a seeded normal
    d_rows at rtol 2e-4, atol 1e-6 plus 1e-6 of the slot's sum of |d_rows|.
    The forward's bound reads lanes 0-13 of each row the tiles hold once per
    hypothesis and the 32 lanes of each won slot, and writes ids, win and
    rows; its operations are K8's, over the tests inside the boxes.
    The backward reads win and d_rows at the foreground and writes the
    whole d_bin (B, tiles, K, 32): the op's output is defined at every
    entry (+0 past a tile's count and in an empty tile, in the TPU kernel,
    the plain twin and the kernel alike), so ``bound`` counts every slot of
    the table; ``bound_held`` counts the slots the tiles hold only, the
    write an output of held slots alone would need (17% of the bytes at
    the bench shapes).  With ``reps``, ms over ``reps`` launches after one
    warm-up, and plain_ms: the plain forward's one call that the check
    makes (timed), the plain backward's over two; the backward's library_ms is
    :func:`bwd_library` on the same winner-slot map (the slots' sums lane
    by lane, (B, 32, tiles x K), where K9 writes them (B, tiles, K, 32))."""
    b, k = packed.shape[0], tile_idx.shape[1]
    (h, w), (th, tw) = resolution, tile_hw
    nt = tile_idx.shape[0]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ids, rows, win = gather_rows.gather_rows_fwd(packed, tile_idx, counts, resolution,
                                                 tile_hw)
    torch.cuda.synchronize()
    start.record()
    ids_p, rows_p, win_p = gather_rows.gather_rows_fwd_plain(packed, tile_idx, counts,
                                                             resolution, tile_hw)
    end.record()
    torch.cuda.synchronize()
    n = counts.long().clamp(max=k)
    held = torch.arange(k, device=n.device)[None, :] < n[:, None]
    slots = int(n.sum())
    n_rows = int(torch.unique(tile_idx[held]).numel())
    frame_px = b * ids.shape[1] * ids.shape[2]
    fg = int((ids > 0).sum())
    tests, pairs = bin_box_tests(packed, tile_idx, counts, resolution, tile_hw)
    fwd = dict(name="K9_gather_rows_fwd",
               ok=bool(torch.equal(ids, ids_p) and torch.equal(win, win_p)
                       and torch.equal(rows, rows_p)),
               max_abs_err=float((rows - rows_p).abs().max()),
               tolerance="ids, slots and rows exactly equal",
               id_mismatches=int((ids != ids_p).sum()), slots=slots,
               table_slots=tile_idx.numel(), fg_pixels=fg, k=k, fullest=int(n.max()),
               range_tests=tests, tested_pairs=pairs,
               bound=bound(4 * (b * 14 * n_rows + slots + nt + 18 * _won(win, nt * k)
                                + frame_px * (2 + 32)), _OPS["K8"] * tests))

    gen = torch.Generator(device=packed.device).manual_seed(0)
    d_rows = torch.randn(rows.shape, generator=gen, device=packed.device)
    d_bin = gather_rows.gather_rows_bwd(d_rows, win, counts, k, tile_hw)
    d_bin_p = gather_rows.gather_rows_bwd_plain(d_rows, win, nt, k)
    scale = gather_rows.gather_rows_bwd_plain(d_rows.abs(), win, nt, k)
    bwd = dict(name="K9_gather_rows_bwd", ok=_close(d_bin, d_bin_p, 2e-4, 1e-6, scale),
               max_abs_err=float((d_bin - d_bin_p).abs().max()),
               tolerance="rtol 2e-4, atol 1e-6 + 1e-6 x sum |d_rows|, per slot",
               worst=_worst(d_bin, d_bin_p, 2e-4, 1e-6, scale), slots=slots,
               table_slots=tile_idx.numel(),
               bound=bound(4 * (frame_px + 32 * fg + b * 32 * tile_idx.numel()),
                           _OPS["K4"] * 32 * fg),
               bound_held=bound(4 * (frame_px + 32 * fg + b * 32 * slots),
                                _OPS["K4"] * 32 * fg))
    if reps:
        fwd["ms"] = _time_ms(lambda: gather_rows.gather_rows_fwd(
            packed, tile_idx, counts, resolution, tile_hw), reps)
        fwd["plain_ms"] = start.elapsed_time(end)
        bwd["ms"] = _time_ms(lambda: gather_rows.gather_rows_bwd(
            d_rows, win, counts, k, tile_hw), reps)
        bwd["plain_ms"] = _time_ms(lambda: gather_rows.gather_rows_bwd_plain(
            d_rows, win, nt, k), 2)
        bwd["library_ms"] = _time_ms(lambda: bwd_library(d_rows, win, nt * k), reps)
    return [fwd, bwd]


def check_sliver(device="cuda") -> List[Dict[str, object]]:
    """K3, K7, K8 and K9's forward against their plain versions on the
    sliver of ``testing.SLIVER_LANES`` (960x540; B = 2, in both windings),
    whose f32 planes cover one pixel 8 rows past its vertex bounds: K3 on a
    compact table of a 16x128 window of 16x16 tiles at (96, 256), the
    sliver in its tile; K7 on the frame's uniform table, one slot a tile;
    K8 and K9 on its setup (packed) row binned in its 32x128 tile.  Each
    row: ok when every output equals the plain twin's bit for bit and the
    sliver wins that pixel, and only it, in both hypotheses."""
    from diffdope_tpu_torch.testing import SLIVER_FRAME, SLIVER_PIXEL, sliver_rows

    (h, w), (py, px) = SLIVER_FRAME, SLIVER_PIXEL
    rows = torch.as_tensor(sliver_rows(2), device=device)  # (2, 32)
    out = []

    def row(name, got, want, pixel_of):
        fg = torch.nonzero(got[0]).tolist()
        out.append(dict(name=name, ok=all(torch.equal(a, c) for a, c in zip(got, want))
                        and fg == [[b, *pixel_of] for b in range(2)], covered=fg,
                        tolerance="outputs exactly equal; the sliver's pixel covered"))

    # K3: a window at (96, 256) of 16x128, its 8 tiles of 16x16
    oy, ox = 96, 256
    table = torch.zeros((2, 32, 128), device=device)
    table[:, :, 0] = rows
    zero = torch.zeros(8, dtype=torch.int32, device=device)
    held = zero.clone()
    held[(px - ox) // 16] = 1
    args = (table, held, zero, held, 128, (16, 128), (16, 16), (oy, ox, h, w))
    row("K3_raster_fwd", raster_fwd(*args), raster_fwd_plain(*args), (py - oy, px - ox))
    # K7: the frame's uniform table at 16x16, one slot a tile
    nty, ntx = -(-h // 16), -(-w // 16)
    uni = torch.zeros((2, 32, nty * ntx), device=device)
    t = (py // 16) * ntx + px // 16
    uni[:, :, t] = rows
    counts = torch.zeros(nty * ntx, dtype=torch.int32, device=device)
    counts[t] = 1
    row("K7_raster_uniform_fwd", raster_uniform_fwd(uni, counts, (h, w), (16, 16)),
        raster_uniform_fwd_plain(uni, counts, (h, w), (16, 16)), (py, px))
    # K8 and K9: the row binned in its 32x128 tile
    tile = (32, 128)
    nty, ntx = -(-h // tile[0]), -(-w // tile[1])
    idx = torch.zeros((nty * ntx, 128), dtype=torch.int32, device=device)
    counts = torch.zeros(nty * ntx, dtype=torch.int32, device=device)
    counts[(py // tile[0]) * ntx + px // tile[1]] = 1
    coef = rows[:, None, :16].contiguous()
    row("K8_raster_ids", (raster_ids(coef, idx, counts, (h, w), tile),),
        (raster_ids_binned_plain(coef, idx, counts, (h, w), tile),), (py, px))
    packed = rows[:, None, :].contiguous()
    row("K9_gather_rows_fwd", gather_rows.gather_rows_fwd(packed, idx, counts, (h, w), tile),
        gather_rows.gather_rows_fwd_plain(packed, idx, counts, (h, w), tile), (py, px))
    return out


@contextlib.contextmanager
def plain_render():
    """Within the block, a render's forward takes the plain twins of K1
    (``planar.pack_binned``), K3 and K7 (``raster_fwd_plain``,
    ``raster_uniform_fwd_plain``) on every device, and launches neither
    kernel: the render to hold a kernel-route render against, bit for bit.
    Only for such checks; the backwards keep their kernels."""
    from diffdope_tpu_torch.render import raster

    saved = (pipeline.pack_binned_auto, raster.raster_fwd, raster.raster_uniform_fwd)

    def pack(pos_c, mvp, mtx, flat, *rest, order=None):
        return planar.pack_binned(pos_c, mvp, mtx, flat.reshape(-1), *rest)

    pipeline.pack_binned_auto = pack
    raster.raster_fwd = raster_fwd_plain
    raster.raster_uniform_fwd = raster_uniform_fwd_plain
    try:
        yield
    finally:
        pipeline.pack_binned_auto, raster.raster_fwd, raster.raster_uniform_fwd = saved
