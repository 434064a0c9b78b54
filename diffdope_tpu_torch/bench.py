"""The port's headline benchmark: pose refinements per second on one GPU.

    python -m diffdope_tpu_torch.bench

The root ``bench.py``'s protocol (``bench.py:282-422``): B = 64 pose
hypotheses, 100 Adam steps (base lr 0.02, decay 0.1) at 400x400, rgb+mask
L1 losses (weights 0.7 / 1.0), per-hypothesis loss scales — here
``np.random.default_rng(0).uniform(0.5, 4, B)``, since torch cannot draw
``jax.random``'s.  The mesh is the bench's synthetic fallback,
icosphere(5) (20,480 triangles; the AlphabetSoup scan is not in the
repo).  The gt images are the port's own render at the gt pose.

Needs a CUDA card and fails without one.  Prints exactly one JSON line on
stdout (the root bench's metric line); progress goes to stderr.  One
``optimize.CapturedRefine`` serves the warm-up and the three timed runs,
as the root bench's ``jit_refine`` does (``bench.py:348-403``): the
warm-up pays the kernels' build, step 0 (eager) and the step's capture
as a CUDA graph, and every step of a timed run is a replay of it.
``DD_PROFILE=N`` also traces N steps with ``torch.profiler`` after the
timed runs, as replays of a kept graph and as the eager loop
(``cuda_graph=False``) side by side, and prints the device time by
kernel and the device busy share of each to stderr.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

from typing import Dict, Optional

import numpy as np
import torch

from diffdope_tpu_torch.losses import select_losses
from diffdope_tpu_torch.optimize import CapturedRefine, pose_matrix, pose_params, refine
from diffdope_tpu_torch.render.pipeline import (
    compact_capacity,
    make_fused_loss,
    render_rgb_mask,
)
from diffdope_tpu_torch.testing import bench_scene, quantize8, spherical_uv

BATCH = 64
STEPS = 100
RES = (400, 400)
#: the texture of ``bench_problem(texture=True)`` (pixels a side)
TEXTURE_SIZE = 1024


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def card() -> str:
    """'name, power limit' of GPU 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


#: the environment that selects each raster route (``pipeline.raster_route``)
ROUTE_ENV = {None: {}, "v3": {"DD_RASTER": "v3"}, "v2": {"DD_BINNED": "0"}}


@contextlib.contextmanager
def _environ(names, values: Dict[str, str]):
    """``names`` unset but for ``values`` inside; the previous values come
    back on exit."""
    saved = {name: os.environ.pop(name, None) for name in names}
    os.environ.update(values)
    try:
        yield
    finally:
        for name, value in saved.items():
            os.environ.pop(name, None)
            if value is not None:
                os.environ[name] = value


def raster_env(route: Optional[str]):
    """Select the raster ``route`` (None, 'v3' or 'v2') for what is built
    or run inside, as the reference's users do (``DD_RASTER`` and
    ``DD_BINNED``)."""
    return _environ(("DD_RASTER", "DD_BINNED"), ROUTE_ENV[route])


def drows_env(bf16: bool):
    """Select the spanning op's d_rows lane for a loss built inside:
    ``DD_DROWS_BF16`` "1" (bf16, the default) or "0" (f32)."""
    return _environ(("DD_DROWS_BF16",), {"DD_DROWS_BF16": "1" if bf16 else "0"})


def bench_problem(resolution=RES, subdiv=5, batch=BATCH, device="cuda",
                  depth: bool = False, uniform: bool = False,
                  route: Optional[str] = None, texture: bool = False) -> Dict[str, object]:
    """The bench protocol's problem on ``device``: the icosphere scene, gt
    images rendered by the port at the gt pose, loss scales
    ``np.random.default_rng(0).uniform(0.5, 4, B)``, rgb+mask weights
    (mask 1.0, rgb 0.7), the compact capacity from the gt probe, the fused
    loss and the initial params (every hypothesis at the initial pose).

    Variants for the kernel checks, off the bench protocol: ``depth`` adds
    the depth L1 (weight 1.0) against the gt render's depth; ``uniform``
    runs the uniform-K table (full frame, no crop) in place of the compact
    one; ``route`` 'v3' or 'v2' builds the loss on that planar route (the
    gt render stays on the default one); ``texture`` colours the sphere by
    a ``TEXTURE_SIZE``-square 8-bit texture at spherical uv
    (``testing.spherical_uv``), in the gt render and in the loss, which
    then takes the exact-texture route (K5/K6's colour lane)."""
    s = bench_scene(resolution, subdiv)
    colors = dict(vtx_color=s["vtx_color"])
    if texture:
        rng = np.random.default_rng(3)
        colors = dict(tex=quantize8(rng.uniform(0.1, 0.9, (TEXTURE_SIZE,) * 2 + (3,))),
                      uv=spherical_uv(s["pos"]), uv_idx=s["tri"])
    mtx_gt, _, _ = pose_matrix(pose_params(s["q_gt"], s["t_gt"], 1, device))
    gt = render_rgb_mask(
        s["proj"], mtx_gt, s["pos"], s["tri"], resolution,
        edge_adj=s["edge_adj"], device=device, **colors,
    )
    gt_np = {"rgb": gt["rgb"][0].cpu().numpy(),
             "segmentation": gt["mask"][0].cpu().numpy(),
             "depth": gt["depth"][0].cpu().numpy()}
    lrs = np.random.default_rng(0).uniform(0.5, 4.0, batch).astype(np.float32)
    _, weights = select_losses(
        {"l1_mask": True, "weight_mask": 1.0,
         "l1_rgb_with_mask": True, "weight_rgb": 0.7,
         "l1_depth_with_mask": depth, "weight_depth": 1.0}
    )
    total = compact_capacity(s["proj"], s["pos"], s["tri"], mtx_gt, resolution,
                             device=device)
    with raster_env(route):
        fn = make_fused_loss(
            s["proj"], s["pos"], s["tri"], resolution, gt_np, lrs, weights,
            use_rgb=True, use_depth=depth, use_mask=True, edge_adj=s["edge_adj"],
            compact_total=None if uniform else total, device=device, **colors,
        )
    params0 = pose_params(s["q0"], s["t0"], batch, device)
    return dict(scene=s, gt=gt_np, lrs=lrs, weights=weights, fn=fn,
                params0=params0, compact_total=total, mtx_gt=mtx_gt)


def distinct_poses(params, step: float):
    """``params`` with hypothesis i offset by i * step in every pose
    parameter: distinct poses, for checks that must tell the hypotheses
    apart."""
    return {k: v + step * torch.arange(v.shape[0], dtype=v.dtype, device=v.device)
            for k, v in params.items()}


def bench_refine(problem, steps: int = STEPS, **kw) -> CapturedRefine:
    """The bench protocol's refinement of the problem's fused loss (Adam,
    base lr 0.02, decay 0.1), captured once and kept across calls;
    ``kw`` go to :class:`CapturedRefine` (``cuda_graph=False`` for the
    eager loop)."""
    return CapturedRefine(fused_loss_fn=problem["fn"], nb_iterations=steps - 1,
                          base_lr=0.02, lr_decay=0.1, optimizer="adam", **kw)


def run_refinement(problem, steps: int = STEPS, jit_refine=None, **refine_kw):
    """One refinement of the problem's hypotheses on the card; returns the
    RefineResult and its wall time (synchronized).  With ``jit_refine``
    (:func:`bench_refine`'s object) the run is a call of it, else a
    ``refine`` call of its own, which captures its step anew;
    ``refine_kw`` go to either (``cuda_graph=False`` for ``refine``'s
    eager loop, a ``step_callback``)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if jit_refine is not None:
        res = jit_refine(problem["params0"], **refine_kw)
    else:
        res = refine(
            problem["params0"], fused_loss_fn=problem["fn"], nb_iterations=steps - 1,
            base_lr=0.02, lr_decay=0.1, optimizer="adam", **refine_kw,
        )
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def device_busy(run):
    """(the profiler's key averages, device busy ms, traced wall s) of
    ``run()``, a refinement that returns (result, wall s)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run()
    events = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return events, busy_us / 1e3, wall


def profile(problem, steps: int) -> None:
    """Trace ``steps`` refinement steps as replays of a kept graph (warmed
    and captured by an untraced run first) and as the eager loop: for
    each, the device time by kernel (top 25), the share of the traced
    window that the device was busy, and the device time per step over an
    untraced run's step (the tracer slows the host, not the kernels)."""
    for graph in (True, False):
        label = "graph" if graph else "eager"
        jit_refine = bench_refine(problem, steps, cuda_graph=graph)
        run_refinement(problem, jit_refine=jit_refine)
        _, step_s = run_refinement(problem, jit_refine=jit_refine)
        step_s /= steps
        events, busy_ms, wall = device_busy(
            lambda: run_refinement(problem, jit_refine=jit_refine))
        log(f"profile ({label}):")
        log(events.table(sort_by="self_device_time_total", row_limit=25))
        log(f"profile ({label}): {steps} steps, wall {wall * 1e3:.3f} ms, device busy "
            f"{busy_ms:.3f} ms ({100 * busy_ms / (wall * 1e3):.1f}%)")
        per_step_ms = busy_ms / steps
        log(f"profile ({label}): device busy per step {per_step_ms:.3f} ms of an "
            f"untraced step's {step_s * 1e3:.3f} ms "
            f"({100 * per_step_ms / (step_s * 1e3):.1f}%)")


def main() -> int:
    if not torch.cuda.is_available():
        log("no CUDA device: the port's bench measures the card only")
        return 2
    log(f"card: {card()}")
    log("mesh: synthetic icosphere(5), 20480 tris")
    problem = bench_problem()
    log(f"compact table capacity: {problem['compact_total']} slots; "
        f"crop {problem['fn'].crop}")
    jit_refine = bench_refine(problem)
    _, first = run_refinement(problem, jit_refine=jit_refine)
    log(f"first run (incl. kernel build, step 0 and the capture): {first:.3f}s")
    times = []
    for _ in range(3):
        res, dt = run_refinement(problem, jit_refine=jit_refine)
        times.append(dt)
    dt = min(times)
    log(f"steady-state refinement times: {[f'{t:.3f}' for t in times]}")
    log(f"final loss: {float(res.total_loss[-1]):.5f}")
    for key in ("_bin_overflow", "_crop_leak"):
        v = (res.telemetry or {}).get(key)
        if v is not None and int(v.max()) > 0:
            log(f"WARNING {key}: up to {int(v.max())}/step")
    n_prof = int(os.environ.get("DD_PROFILE", "0"))
    if n_prof:
        profile(problem, n_prof)
    value = 1.0 / dt
    print(json.dumps({
        "metric": "pose_refinements_per_sec",
        "value": round(value, 3),
        "unit": f"refinements/s (B={BATCH}, {STEPS} adam steps, {RES[0]}x{RES[1]})",
        "vs_baseline": round(value / 1.0, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
