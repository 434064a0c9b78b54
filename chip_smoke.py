"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Checks, in order, and exits nonzero at the first failure (printing no
result line):

1. the card (nvidia-smi name and power limit) and the torch, CUDA, nvcc
   and Triton versions;
2. builds the hand kernels from ``diffdope_tpu_torch/csrc`` (nvcc, sm_90a)
   and reports the build time;
3. holds each kernel (K3 raster fwd, K4 raster bwd, K5 loss fwd, K6 loss
   bwd) against its plain torch version on the card, at the test scene and
   at the bench shapes, each hypothesis at a pose of its own, and times
   both at the bench shapes;
4. drives the main path: the bench protocol (B=64, 400x400, icosphere(5),
   rgb+mask, 100 Adam steps) through ``make_fused_loss`` + ``refine``, with
   every launch counter reset just before and read just after; the loss
   must be finite and fall, the best hypothesis must end closer to the gt
   pose (ADD) than it started, and no step may drop bin slots or leak out
   of the ROI crop.

The line before the last is the card; before it, one JSON object with a
row per kernel.  The last line is ``{"ok": true, "device": {...}}``.
Needs a CUDA device: it does not fall back to the CPU.
"""

import json
import subprocess
import sys
import time


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def versions() -> str:
    import torch

    try:
        from torch.utils.cpp_extension import CUDA_HOME

        nvcc_bin = f"{CUDA_HOME}/bin/nvcc" if CUDA_HOME else "nvcc"
        nvcc = subprocess.run([nvcc_bin, "--version"], capture_output=True,
                              text=True).stdout.strip().splitlines()[-1]
    except (OSError, IndexError):
        nvcc = "not found"
    try:
        import triton

        tri = triton.__version__
    except ImportError:
        tri = "not installed"
    return (f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"nvcc {nvcc}, triton {tri}")


def add_error(pos, mtx_a, mtx_b) -> "torch.Tensor":
    """ADD: mean distance between the model's vertices under two poses."""
    import torch

    p = torch.as_tensor(pos, device=mtx_a.device)
    pa = p @ mtx_a[..., :3, :3].transpose(-1, -2) + mtx_a[..., None, :3, 3]
    pb = p @ mtx_b[..., :3, :3].transpose(-1, -2) + mtx_b[..., None, :3, 3]
    return (pa - pb).norm(dim=-1).mean(dim=-1)


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (this smoke run needs one GPU; no CPU fallback)")
    from diffdope_tpu_torch import kernels
    from diffdope_tpu_torch.bench import (
        bench_problem,
        card,
        distinct_poses,
        run_refinement,
    )
    from diffdope_tpu_torch.kernels.check import COUNTERS, KERNELS, check_kernels
    from diffdope_tpu_torch.optimize import argmin_hypothesis, pose_matrix

    gpu = card()
    print(f"card: {gpu}", flush=True)
    print(f"versions: {versions()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{' '.join(kernels.NVCC_FLAGS)})", flush=True)

    # ---- kernels against their plain versions --------------------------------
    # every check runs on distinct poses, so a kernel that reads another
    # hypothesis's inputs disagrees with its plain version
    small = bench_problem((64, 96), subdiv=2, batch=3, device="cuda")
    mtx, _, _ = pose_matrix(distinct_poses(small["params0"], 0.01))
    d_small = torch.tensor([[1.0, 0.7, 0.0], [0.5, 1.3, 0.0], [2.0, 0.2, 0.0]],
                           device="cuda")
    for row in check_kernels(small["fn"], mtx, d_small):
        print(f"test scene {row['name']}: ok={row['ok']} "
              f"max_abs_err={row['max_abs_err']:.3e} ({row['tolerance']})", flush=True)
        if not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version at the test scene: {row}")

    problem = bench_problem((400, 400), subdiv=5, batch=64, device="cuda")
    print(f"bench problem: compact capacity {problem['compact_total']} slots, "
          f"ROI crop {problem['fn'].crop}", flush=True)
    mtx, _, _ = pose_matrix(distinct_poses(problem["params0"], 1e-3))
    d_sums = torch.as_tensor(
        np.random.default_rng(1).uniform(0.5, 2.0, (64, 3)),
        dtype=torch.float32, device="cuda",
    )
    bench_rows = {}
    for row in check_kernels(problem["fn"], mtx, d_sums, reps=20):
        print(f"bench shapes {row['name']}: ok={row['ok']} "
              f"max_abs_err={row['max_abs_err']:.3e} kernel {row['ms']:.4f} ms, "
              f"plain {row['plain_ms']:.4f} ms [{gpu}]", flush=True)
        if not row["ok"]:
            fail(f"{row['name']} disagrees with its plain version at bench shapes: {row}")
        bench_rows[row["name"]] = row

    # ---- the main path ------------------------------------------------------
    run_refinement(problem)  # warm-up: allocator, caches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    res, seconds = run_refinement(problem)
    launches = dict(kernels.launches)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = res.total_loss.shape[0]
    print(f"main path: {steps} steps, B=64, 400x400: {seconds:.4f} s, "
          f"{1e3 * seconds / steps:.3f} ms/step, {1.0 / seconds:.4f} refinements/s, "
          f"peak {peak_gib:.2f} GiB [{gpu}]", flush=True)
    print(f"launches in the main path: {launches}", flush=True)
    for name, counter in COUNTERS.items():
        if launches[counter] <= 0:
            fail(f"{name} was not launched by the main path")

    total = res.total_loss.cpu()
    if not bool(torch.isfinite(total).all()):
        fail(f"non-finite loss: {total}")
    print(f"loss: first {float(total[0]):.6f}, last {float(total[-1]):.6f}", flush=True)
    if not float(total[-1]) < float(total[0]):
        fail("the loss did not fall")
    if problem["fn"].crop is None:
        fail("the bench problem runs without its ROI crop")
    for key in ("_bin_overflow", "_crop_leak"):
        worst = int(res.telemetry[key].max())
        print(f"{key}: max {worst} per step", flush=True)
        if worst != 0:
            fail(f"{key} is {worst}")
    best = int(argmin_hypothesis(res.losses_values))
    final, _, _ = pose_matrix(res.params)
    pos = problem["scene"]["pos"]
    mtx_gt = problem["mtx_gt"][0]
    start, _, _ = pose_matrix(problem["params0"])
    add0 = float(add_error(pos, start[best], mtx_gt))
    add1 = float(add_error(pos, final[best], mtx_gt))
    print(f"best hypothesis {best}: ADD {add0:.6f} -> {add1:.6f} (object units)",
          flush=True)
    if not add1 < add0:
        fail("the best hypothesis did not end closer to the gt pose")

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = bench_rows[name]
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[COUNTERS[name]], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(gpu, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
