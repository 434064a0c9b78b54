"""How far the JAX package's sharded refinement parts from its own
unsharded run when the shards' bins differ.

``diffdope_tpu.parallel.refine_sharded`` runs ``refine`` on each device's
B/n hypotheses under ``shard_map``, so each shard bins and culls the
union of its own hypotheses only.  The unsharded run bins the union of
all B: a triangle that faces the camera in any hypothesis is kept for
every one, and its slots sit in every hypothesis's bins.  This script
refines one problem both ways and prints the gap, step by step, in the
units of the reference's own tolerances (``tests/test_parallel.py``:
mtx rtol 2e-4, atol 2e-5; total rtol 2e-4, atol 1e-6; a gap above 1
fails them).

The problem: ``examples/multichip_refine.py``'s icosphere(3) at a small
frame, the default camera's near and far planes (0.01, 200), the fused
rgb + mask loss with back-face culling (``DiffDope``'s route), Adam.
Half the hypotheses start near the gt pose; the other half start turned
half a revolution about y, so the first shard's cull keeps the faces its
own hypotheses see, and the unsharded cull keeps nearly every face.  A
control run has every hypothesis near the gt pose (the shards' culls
alike).  A run with no cull shows the bins alone; the last two runs
(near the gt pose, then spread) bin once, at the initial poses of all B
(``precompute_bins``, margin 24 px), and hand both refinements that one
table, so only the bins' batch is taken away.  CPU only, with the devices XLA is told to make:

    env PYTHONPATH= JAX_PLATFORMS=cpu \\
        XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tools/jax_shard_bin_gap.py [--steps 6] [--shards 2] [--res 48x64]
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

#: above the mesh's 1,280 triangles, so no bin drops a pair
MAX_TRIS = 2048


def problem(res, batch, spread, cull, fixed_bins):
    import jax
    import jax.numpy as jnp

    from diffdope_tpu import geometry as geo
    from diffdope_tpu.losses import select_losses
    from diffdope_tpu.mesh import build_edge_adjacency
    from diffdope_tpu.optimize import draw_learning_rates, pose_matrix, pose_params
    from diffdope_tpu.render.pipeline import make_fused_loss, precompute_bins, render_batch
    from diffdope_tpu.testing import icosphere

    h, w = res
    f = 1.2 * max(h, w)
    proj = jnp.asarray(geo.projection_from_intrinsics(f, f, w / 2, h / 2, w, h, 0.01, 200.0),
                       jnp.float32)
    v, fc = icosphere(3)
    pos = jnp.asarray(v.astype(np.float32) * 0.4)
    tri = jnp.asarray(fc.astype(np.int32))
    adj = jnp.asarray(build_edge_adjacency(fc))
    col = jnp.asarray((v * 0.5 + 0.5).astype(np.float32))

    q_gt = np.asarray(geo.quat_from_axis_angle(np.array([0.2, 1.0, 0.1]), 0.8), np.float32)
    t_gt = np.array([0.0, 0.0, -3.0], np.float32)
    gtr = jax.jit(lambda m: render_batch(proj, m, pos, tri, res, vtx_color=col, edge_adj=adj,
                                         raster_impl="pallas", layout="stacked",
                                         max_tris_per_tile=MAX_TRIS))(
        pose_matrix(pose_params(q_gt, t_gt, 1))[0])
    gt = {"rgb": gtr["rgb"][0], "segmentation": gtr["mask"][0]}

    rng = np.random.default_rng(0)
    qs, ts = [], []
    for i in range(batch):
        dq = geo.quat_from_axis_angle(rng.normal(size=3), np.deg2rad(6.0))
        q = np.asarray(geo.quat_multiply(jnp.asarray(dq), jnp.asarray(q_gt)))
        if spread and i >= batch // 2:
            turn = geo.quat_from_axis_angle(np.array([0.0, 1.0, 0.0]), np.pi)
            q = np.asarray(geo.quat_multiply(jnp.asarray(turn), jnp.asarray(q)))
        qs.append(q)
        ts.append(t_gt + rng.normal(size=3).astype(np.float32) * 0.02)
    qs, ts = np.asarray(qs, np.float32), np.asarray(ts, np.float32)
    params0 = {k: jnp.asarray(a) for k, a in zip(
        ("qx", "qy", "qz", "qw", "x", "y", "z"),
        (qs[:, 0], qs[:, 1], qs[:, 2], qs[:, 3], ts[:, 0], ts[:, 1], ts[:, 2]))}

    loss_fns, weights = select_losses({"l1_mask": True, "weight_mask": 1.0,
                                       "l1_rgb_with_mask": True, "weight_rgb": 0.7})
    lrs = draw_learning_rates(jax.random.PRNGKey(1), batch, (0.5, 2.0))
    bins = (precompute_bins(proj, pose_matrix(params0)[0], pos, tri, res,
                            max_tris_per_tile=MAX_TRIS, cull_backfaces=cull)
            if fixed_bins else None)
    fused = make_fused_loss(proj, pos, tri, res, gt, lrs, weights, use_rgb=True,
                            use_mask=True, edge_adj=adj, vtx_color=col,
                            max_tris_per_tile=MAX_TRIS, cull_backfaces=cull, bins=bins)

    def render_fn(mtx, layout="channels"):
        return render_batch(proj, mtx, pos, tri, res, vtx_color=col, edge_adj=adj,
                            raster_impl="pallas", layout=layout, max_tris_per_tile=MAX_TRIS,
                            cull_backfaces=cull)

    return params0, render_fn, loss_fns, gt, lrs, weights, fused


def gap(res, batch, shards, steps, spread, cull, fixed_bins=False):
    import jax

    from diffdope_tpu.optimize import refine
    from diffdope_tpu.parallel import hypothesis_mesh, refine_sharded

    params0, render_fn, loss_fns, gt, lrs, weights, fused = problem(res, batch, spread, cull,
                                                                    fixed_bins)
    kw = dict(nb_iterations=steps - 1, base_lr=0.02, lr_decay=0.1, optimizer="adam",
              fused_loss_fn=fused)
    t0 = time.perf_counter()
    whole = jax.jit(lambda p: refine(p, render_fn, loss_fns, gt, lrs, weights, **kw))(params0)
    sharded = refine_sharded(params0, render_fn, loss_fns, gt, lrs, weights,
                             hypothesis_mesh(shards), **kw)
    want, got = np.asarray(whole.mtx_history), np.asarray(sharded.mtx_history)
    want_t, got_t = np.asarray(whole.total_loss), np.asarray(sharded.total_loss)
    per_step = np.abs(got - want).reshape(steps, batch, -1).max(axis=-1)  # (S, B)
    rel = (np.abs(got - want) / (2e-5 + 2e-4 * np.abs(want))).reshape(steps, -1).max(-1)
    rel_t = np.abs(got_t - want_t) / (1e-6 + 2e-4 * np.abs(want_t))
    first = int(np.argmax(per_step.max(axis=1) > 0)) if per_step.max() > 0 else None
    return {
        "spread": spread, "cull": cull, "fixed_bins": fixed_bins, "res": list(res),
        "batch": batch, "shards": shards, "steps": steps,
        "seconds": round(time.perf_counter() - t0, 1),
        "first_step_apart": first,
        "max_abs_mtx_gap": float(per_step.max()),
        "max_abs_mtx_gap_by_hypothesis": [float(x) for x in per_step.max(axis=0)],
        "mtx_gap_over_allowance": float(rel.max()),
        "mtx_gap_over_allowance_by_step": [float(x) for x in rel],
        "total_gap_over_allowance": float(rel_t.max()),
        "total_gap_over_allowance_by_step": [float(x) for x in rel_t],
        "bit_identical": bool(np.array_equal(got, want)),
        "bin_overflow": [float(np.max((r.telemetry or {}).get("_bin_overflow", 0)))
                         for r in (whole, sharded)],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--res", default="48x64")
    args = ap.parse_args(argv)
    res = tuple(int(x) for x in args.res.split("x"))
    for spread, cull, fixed in ((True, True, False), (False, True, False),
                                (True, False, False), (False, True, True),
                                (True, True, True)):
        print(json.dumps(gap(res, args.batch, args.shards, args.steps, spread, cull, fixed)),
              flush=True)


if __name__ == "__main__":
    main()
