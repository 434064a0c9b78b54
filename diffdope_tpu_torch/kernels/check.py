"""Kernel-versus-plain checks and timings on the card.

Used by ``chip_smoke.py`` and the CUDA tests: hold each of K3-K6 against
its plain torch version on the same inputs (the table of a fused loss
from ``make_fused_loss`` at given poses), and time both.

Tolerances: K3's ids, slots and rows must be exactly equal (same f32
operation order, no FMA); K5's sums rtol 1e-5, atol 1e-7; K6's d_rows and
K4's d_bins (also reduced per triangle) rtol 2e-4, atol 1e-6 against the
plain autograd, plus 1e-6 of a local scale.  That term is there because
both gradients are sums of terms that can cancel: a pixel's lane sums the
rgb term (three channels through s) and up to four pair terms, a slot sums
its pixels; a cancelled sum keeps the f32 rounding of its largest term, so
its error is measured against that term, not against the small result.
The scale is the pixel's largest lane (K6) and the slot's sum of |d_rows|
(K4).
"""

from __future__ import annotations

from typing import Dict, List

import torch

from diffdope_tpu_torch.render.fused_loss import (
    loss_bwd,
    loss_bwd_plain,
    loss_sums,
    loss_sums_plain,
)
from diffdope_tpu_torch.render.pipeline import K_CHUNK, TILE_HW
from diffdope_tpu_torch.render.raster import (
    raster_bwd,
    raster_bwd_plain,
    raster_fwd,
    raster_fwd_plain,
)

#: which TPU kernel each port kernel replaces, and where it lives
KERNELS = {
    "K3_raster_fwd": (
        "diffdope_tpu_torch/csrc/raster.cu",
        "diffdope_tpu/render/raster_v2.py:178",
    ),
    "K4_raster_bwd": (
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
}
#: launch counter of each kernel's wrapper (diffdope_tpu_torch.kernels)
COUNTERS = {
    "K3_raster_fwd": "raster_fwd",
    "K4_raster_bwd": "raster_bwd",
    "K5_loss_fwd": "loss_fwd",
    "K6_loss_bwd": "loss_bwd",
}


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


def check_kernels(fn, mtx: torch.Tensor, d_sums: torch.Tensor,
                  reps: int = 0) -> List[Dict[str, object]]:
    """Each of K3-K6 against its plain version on the table of ``mtx``.

    Returns one dict per kernel: name, ok, max_abs_err, tolerance, and,
    when ``reps`` > 0, ms and plain_ms (CUDA events over ``reps`` launches
    after one warm-up)."""
    with torch.no_grad():
        packed, counts, off_c, used, _ = fn.table(mtx)
    args = (packed, counts, off_c, used, K_CHUNK, fn.frame_hw, TILE_HW, fn.roi)
    n_slots = packed.shape[2]
    out = []

    ids, rows, win = raster_fwd(*args)
    ids_p, rows_p, win_p = raster_fwd_plain(*args)
    err = float((rows - rows_p).abs().max())
    ok = bool(torch.equal(ids, ids_p) and torch.equal(win, win_p)
              and torch.equal(rows, rows_p))
    out.append(dict(name="K3_raster_fwd", ok=ok, max_abs_err=err,
                    tolerance="ids, slots and rows exactly equal",
                    fg_pixels=int((ids > 0).sum()),
                    id_mismatches=int((ids != ids_p).sum())))

    sums = loss_sums(rows, ids, fn.gt6, fn.roi)
    sums_p = loss_sums_plain(rows, ids, fn.gt6, fn.roi)
    out.append(dict(name="K5_loss_fwd", ok=_close(sums, sums_p, 1e-5, 1e-7),
                    max_abs_err=float((sums - sums_p).abs().max()),
                    tolerance="rtol 1e-5, atol 1e-7"))

    d_rows = loss_bwd(rows, ids, fn.gt6, fn.roi, d_sums)
    d_rows_p = loss_bwd_plain(rows, ids, fn.gt6, fn.roi, d_sums)
    px_scale = d_rows_p.abs().amax(dim=1, keepdim=True)
    out.append(dict(name="K6_loss_bwd",
                    ok=_close(d_rows, d_rows_p, 2e-4, 1e-6, px_scale),
                    max_abs_err=float((d_rows - d_rows_p).abs().max()),
                    tolerance="rtol 2e-4, atol 1e-6 + 1e-6 x pixel's largest lane",
                    worst=_worst(d_rows, d_rows_p, 2e-4, 1e-6, px_scale)))

    d_bins = raster_bwd(d_rows, win, n_slots, TILE_HW)
    d_bins_p = raster_bwd_plain(d_rows, win, n_slots)
    tri = packed[0, 13].long()  # triangle of each slot (sentinel: T)

    def per_triangle(d):
        acc = d.new_zeros((d.shape[0], d.shape[1], int(tri.max()) + 1))
        return acc.index_add_(2, tri, d)

    slot_scale = raster_bwd_plain(d_rows.abs(), win, n_slots)
    ok4 = _close(d_bins, d_bins_p, 2e-4, 1e-6, slot_scale) and _close(
        per_triangle(d_bins), per_triangle(d_bins_p), 2e-4, 1e-6,
        per_triangle(slot_scale))
    out.append(dict(name="K4_raster_bwd", ok=ok4,
                    max_abs_err=float((d_bins - d_bins_p).abs().max()),
                    tolerance="rtol 2e-4, atol 1e-6 + 1e-6 x sum |d_rows|, "
                              "per slot and per triangle",
                    worst=_worst(d_bins, d_bins_p, 2e-4, 1e-6, slot_scale)))

    if reps:
        timed = {
            "K3_raster_fwd": (lambda: raster_fwd(*args),
                              lambda: raster_fwd_plain(*args)),
            "K5_loss_fwd": (lambda: loss_sums(rows, ids, fn.gt6, fn.roi),
                            lambda: loss_sums_plain(rows, ids, fn.gt6, fn.roi)),
            "K6_loss_bwd": (
                lambda: loss_bwd(rows, ids, fn.gt6, fn.roi, d_sums),
                lambda: loss_bwd_plain(rows, ids, fn.gt6, fn.roi, d_sums)),
            "K4_raster_bwd": (lambda: raster_bwd(d_rows, win, n_slots, TILE_HW),
                              lambda: raster_bwd_plain(d_rows, win, n_slots)),
        }
        for row in out:
            kern, plain = timed[row["name"]]
            row["ms"] = _time_ms(kern, reps)
            row["plain_ms"] = _time_ms(plain, max(1, reps // 10))
    return out
