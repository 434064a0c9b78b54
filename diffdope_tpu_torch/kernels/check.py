"""Kernel-versus-plain checks, timings and bounds on the card.

Used by ``chip_smoke.py`` and the CUDA tests: hold each of K1-K6 against
its plain torch version on the same inputs (the pack inputs and the table
of a fused loss from ``make_fused_loss`` at given poses), and time both.

Tolerances: K1's table must equal ``planar.pack_binned``'s bit for bit in
all 32 lanes, and K3's ids, slots and rows exactly (same f32 operation
order, no FMA); K5's sums rtol 1e-5, atol 1e-7; K2's (d_mvp, d_mtx row 2),
K6's d_rows and K4's d_bins (also reduced per triangle) rtol 2e-4, atol
1e-6 against the plain autograd, plus 1e-6 of a local scale.  That term is
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
gradient.  The per-element operation counts are counted from the
CUDA sources, as estimates; every kernel here is bound by bytes.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from diffdope_tpu_torch.render import planar
from diffdope_tpu_torch.render.fused_loss import (
    loss_bwd,
    loss_bwd_plain,
    loss_sums,
    loss_sums_plain,
)
from diffdope_tpu_torch.render.pack_kernel import (
    _mvpm,
    _static_table,
    pack_bwd,
    pack_fwd,
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
    "K1_pack_fwd": "pack_fwd",
    "K2_pack_bwd": "pack_bwd",
    "K3_raster_fwd": "raster_fwd",
    "K4_raster_bwd": "raster_bwd",
    "K5_loss_fwd": "loss_fwd",
    "K6_loss_bwd": "loss_bwd",
}


#: one H100 SXM's published peaks (NVIDIA's data sheet, at 700 W): HBM3
#: bytes/s and FP32 (non-tensor-core) operations/s
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
#: FP32 operations per element, counted from the CUDA sources (estimates):
#: K1/K2 per (hypothesis, slot) at n_ch colour channels, K3 per
#: (pixel, slot) edge test, K4 per (foreground pixel, lane), K5/K6 per pixel
_OPS = {"K1": lambda n_ch: 195 + 15 * n_ch, "K2": lambda n_ch: 330 + 18 * n_ch,
        "K3": 25, "K4": 1, "K5": 450, "K6": 900}


#: lanes of a foreground pixel's rows that K5 and K6 read: the edge planes
#: and z (0-12), the silhouette bit (14) and the colour planes (16-24)
ROW_LANES_READ = 13 + 1 + 9


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


def check_kernels(fn, mtx: torch.Tensor, d_sums: Optional[torch.Tensor] = None,
                  reps: int = 0) -> List[Dict[str, object]]:
    """Each of K3-K6 against its plain version on the table of ``mtx``.

    ``fn`` is a fused loss (``make_fused_loss``: K3, K5, K6, then K4 under
    K6's d_rows for the cotangent ``d_sums``) or a render function
    (``DiffDope._make_render_fn``, the unfused route: K3, then K4 under a
    seeded normal d_rows on every lane).  Returns one dict per kernel:
    name, ok, max_abs_err, tolerance, bound, and, when ``reps`` > 0, ms and
    plain_ms (CUDA events over ``reps`` launches after one warm-up)."""
    fused = getattr(fn, "gt6", None) is not None
    with torch.no_grad():
        packed, counts, off_c, used, _ = fn.table(mtx)
    args = (packed, counts, off_c, used, K_CHUNK, fn.frame_hw, TILE_HW, fn.roi)
    b, _, n_slots = packed.shape
    hc, wc = fn.frame_hw
    npx = b * hc * wc
    n_read = int(torch.minimum(counts, used * K_CHUNK).sum())  # slots the tiles hold
    tested = b * n_read * TILE_HW[0] * TILE_HW[1]
    out = []

    ids, rows, win = raster_fwd(*args)
    ids_p, rows_p, win_p = raster_fwd_plain(*args)
    err = float((rows - rows_p).abs().max())
    ok = bool(torch.equal(ids, ids_p) and torch.equal(win, win_p)
              and torch.equal(rows, rows_p))
    fg = int((ids > 0).sum())
    # K3 reads 14 lanes of every slot its tiles hold, the other 18 lanes of
    # each won slot, and writes ids, win and every pixel's 32 lanes
    w = win.reshape(b, -1).long()
    w = w + n_slots * torch.arange(b, device=w.device)[:, None]
    won = int(torch.unique(w[win.reshape(b, -1) >= 0]).numel())
    out.append(dict(name="K3_raster_fwd", ok=ok, max_abs_err=err,
                    tolerance="ids, slots and rows exactly equal",
                    fg_pixels=fg, id_mismatches=int((ids != ids_p).sum()),
                    bound=bound(4 * (b * 14 * n_read + 18 * won + 3 * counts.numel())
                                + npx * (4 + 4 + 4 * 32), _OPS["K3"] * tested)))

    if fused:
        # K5/K6 read ids everywhere and, where ids > 0 only (a background
        # pixel shades to 0; a mask pair reads its foreground side), the
        # ROW_LANES_READ lanes of rows
        sums = loss_sums(rows, ids, fn.gt6, fn.roi)
        sums_p = loss_sums_plain(rows, ids, fn.gt6, fn.roi)
        out.append(dict(name="K5_loss_fwd", ok=_close(sums, sums_p, 1e-5, 1e-7),
                        max_abs_err=float((sums - sums_p).abs().max()),
                        tolerance="rtol 1e-5, atol 1e-7",
                        bound=bound(4 * npx + 4 * ROW_LANES_READ * fg
                                    + 4 * fn.gt6.numel() + 4 * b * 3, _OPS["K5"] * npx)))

        d_rows = loss_bwd(rows, ids, fn.gt6, fn.roi, d_sums)
        d_rows_p = loss_bwd_plain(rows, ids, fn.gt6, fn.roi, d_sums)
        px_scale = d_rows_p.abs().amax(dim=1, keepdim=True)
        out.append(dict(name="K6_loss_bwd",
                        ok=_close(d_rows, d_rows_p, 2e-4, 1e-6, px_scale),
                        max_abs_err=float((d_rows - d_rows_p).abs().max()),
                        tolerance="rtol 2e-4, atol 1e-6 + 1e-6 x pixel's largest lane",
                        worst=_worst(d_rows, d_rows_p, 2e-4, 1e-6, px_scale),
                        bound=bound(4 * npx + 4 * ROW_LANES_READ * fg + 4 * fn.gt6.numel()
                                    + 4 * b * 3 + 4 * 32 * npx, _OPS["K6"] * npx)))
    else:
        gen = torch.Generator(device=rows.device).manual_seed(0)
        d_rows = torch.randn(rows.shape, generator=gen, device=rows.device)

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
    # K4 reads win everywhere and d_rows only at foreground pixels, and
    # writes all of d_bins
    out.append(dict(name="K4_raster_bwd", ok=ok4,
                    max_abs_err=float((d_bins - d_bins_p).abs().max()),
                    tolerance="rtol 2e-4, atol 1e-6 + 1e-6 x sum |d_rows|, "
                              "per slot and per triangle",
                    worst=_worst(d_bins, d_bins_p, 2e-4, 1e-6, slot_scale),
                    bound=bound(4 * npx + 4 * 32 * fg + 4 * d_bins.numel(),
                                _OPS["K4"] * 32 * fg)))

    if reps:
        timed = {
            "K3_raster_fwd": (lambda: raster_fwd(*args),
                              lambda: raster_fwd_plain(*args)),
            "K4_raster_bwd": (lambda: raster_bwd(d_rows, win, n_slots, TILE_HW),
                              lambda: raster_bwd_plain(d_rows, win, n_slots)),
        }
        if fused:
            timed["K5_loss_fwd"] = (lambda: loss_sums(rows, ids, fn.gt6, fn.roi),
                                    lambda: loss_sums_plain(rows, ids, fn.gt6, fn.roi))
            timed["K6_loss_bwd"] = (
                lambda: loss_bwd(rows, ids, fn.gt6, fn.roi, d_sums),
                lambda: loss_bwd_plain(rows, ids, fn.gt6, fn.roi, d_sums))
        for row in out:
            kern, plain = timed[row["name"]]
            row["ms"] = _time_ms(kern, reps)
            row["plain_ms"] = _time_ms(plain, max(1, reps // 10))
    return out


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


def check_pack(fn, mtx: torch.Tensor, reps: int = 0) -> List[Dict[str, object]]:
    """K1 and K2 against ``planar.pack_binned`` and its autograd, on the
    pack inputs of ``fn`` at poses ``mtx``; K2 under a seeded normal
    cotangent on every lane.

    Returns one dict per kernel, as :func:`check_kernels` does."""
    mesh = fn.mesh
    with torch.no_grad():
        bn = fn.binned(mtx)
    t_count = mesh.t_count
    tab, n_ch = _static_table(bn.flat, t_count, mesh.static)
    tab = tab.contiguous()
    sil_b = bn.sil[:, bn.flat.clamp(max=t_count - 1)].to(torch.float32).contiguous()
    mvpm = _mvpm(bn.mvp, mtx)
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
    d = pack_bwd(mvpm, tab, g, n_ch)
    leaves = (bn.mvp.detach().requires_grad_(True), mtx.detach().requires_grad_(True))
    with torch.enable_grad():
        packed_p = plain(*leaves)
        d_mvp, d_mtx = torch.autograd.grad(packed_p, leaves, g, retain_graph=True)
    want2 = torch.cat([d_mvp.reshape(b, 16), d_mtx[:, 2, :3]], dim=1)
    rest = d_mtx.clone()
    rest[:, 2, :3] = 0.0
    scale = _pack_term_scale(fn, bn, mtx, g)
    ok2 = _close(d, want2, 2e-4, 1e-6, scale) and not bool(rest.any())
    out.append(dict(name="K2_pack_bwd", ok=ok2,
                    max_abs_err=float((d - want2).abs().max()),
                    tolerance="rtol 2e-4, atol 1e-6 + 1e-6 x the hypothesis' "
                              "sum of |terms|",
                    worst=_worst(d, want2, 2e-4, 1e-6, scale),
                    # K2 reads every table row but the triangle ids, and
                    # the 16 + 3 n_ch lanes of g that carry a gradient
                    bound=bound(4 * (mvpm.numel() + (tab.shape[0] - 1) * n
                                     + b * n * (16 + 3 * n_ch) + d.numel()),
                                _OPS["K2"](n_ch) * b * n)))
    if reps:
        with torch.no_grad():
            out[0]["ms"] = _time_ms(lambda: pack_fwd(mvpm, tab, sil_b, n_ch), reps)
            out[0]["plain_ms"] = _time_ms(lambda: plain(bn.mvp, mtx), max(1, reps // 10))
            out[1]["ms"] = _time_ms(lambda: pack_bwd(mvpm, tab, g, n_ch), reps)
        out[1]["plain_ms"] = _time_ms(
            lambda: torch.autograd.grad(packed_p, leaves, g, retain_graph=True),
            max(1, reps // 10))
    return out
