"""The hypotheses sharded over ranks (``parallel.refine_sharded``,
``DiffDope`` under ``tpu.mesh_axis``) against the JAX package's
``refine_sharded`` on conftest's virtual CPU devices and against the
port's unsharded run: the counterparts of ``tests/test_parallel.py``.

The port's ranks are processes: four gloo ranks on the CPU, spawned with
a ``file://`` rendezvous under ``tmp_path`` and a timeout, so a dead rank
fails the run instead of hanging it.  One spawn runs every check of the
module: the worker functions live here, and this module imports jax only
inside its test functions, so no spawned rank imports jax.  Each rank
writes what it got to ``tmp_path``; the test holds every rank's result
to the others', to the port's unsharded run and to the reference's, at
the reference's tolerances (mtx rtol 2e-4, atol 2e-5; total rtol 2e-4,
atol 1e-6); the fused runs, whose ranks bin over the group's union
(``planar.union_over``), take the unsharded poses bit for bit.  After the
four-rank checks, ranks 0 and 1 join a two-rank
group and run ``DiffDope`` with ``tpu.mesh_axis: 2``.
"""

import copy
import datetime
import tempfile
import time

import numpy as np
import pytest
import torch

from diffdope_tpu_torch.losses import select_losses
from diffdope_tpu_torch.optimize import pose_matrix, pose_params, refine
from torch_scene import one_torch_thread  # noqa: F401

B = 8
N = 4
RES = (32, 32)
TIMEOUT_S = 120
#: the whole spawn's deadline (the ranks' start, every check, their exit)
SPAWN_DEADLINE_S = 600
#: the sharded-against-unsharded run (tests/test_parallel.py:21-54)
ADAM = dict(nb_iterations=3, base_lr=0.1, lr_decay=0.1, optimizer="adam")
#: the fused loss's run (:61-131)
FUSED = dict(nb_iterations=2, base_lr=0.1, lr_decay=0.1, optimizer="adam")
#: the appearance run (:219-288): SGD, whose updates are linear in the
#: gradients
SGD = dict(nb_iterations=2, base_lr=0.5, lr_decay=0.5, optimizer="sgd")
MASK = {"l1_mask": True, "weight_mask": 1.0}
MASK_RGB = {"l1_mask": True, "weight_mask": 1.0, "l1_rgb_with_mask": True, "weight_rgb": 0.7}
#: DiffDope's session: icosphere(2) on a 48x64 frame, B=4, 4 SGD steps
DD_RES = (48, 64)
DD_CFG = {
    "losses": {"l1_mask": True, "weight_mask": 1.0,
               "l1_rgb_with_mask": True, "weight_rgb": 0.7},
    "hyperparameters": {"batchsize": 4, "nb_iterations": 3, "base_lr": 20.0,
                        "lr_decay": 0.1, "learning_rates_bound": [0.5, 2.0]},
    "tpu": {"seed": 1, "raster_impl": "pallas", "compact_total": 2048,
            "progress": False},
}


def _proj(res):
    from diffdope_tpu_torch.geometry import projection_from_intrinsics

    h, w = res
    f = 1.2 * max(h, w)
    return torch.as_tensor(projection_from_intrinsics(f, f, w / 2, h / 2, w, h, 0.01, 100.0),
                           dtype=torch.float32)


def _sphere(subdiv):
    from diffdope_tpu_torch.mesh import build_edge_adjacency
    from diffdope_tpu_torch.testing import icosphere

    v, fc = icosphere(subdiv)
    return (torch.as_tensor(v * 0.4), torch.as_tensor(fc),
            torch.as_tensor(build_edge_adjacency(fc)),
            torch.as_tensor((v * 0.5 + 0.5).astype(np.float32)))


def _gt_pose():
    return pose_matrix(pose_params(np.array([0, 0, 0, 1.0], np.float32),
                                   np.array([0.0, 0.0, -2.0], np.float32), 1, "cpu"))[0]


def _unfused_problem():
    """tests/test_parallel.py:21-54's problem on the port: the synthetic
    scene on the brute-force raster, mask L1."""
    from diffdope_tpu_torch.testing import synthetic_scene

    scene = synthetic_scene(subdiv=1, resolution=RES, batchsize=B, seed=3,
                            raster_impl="reference", device="cpu")
    return scene["params0"], scene["render_fn"], scene["gt"]


def _fused_problem(lrs, record=None):
    """:61-131's problem: icosphere(2), rgb + mask through
    ``make_fused_loss`` (the uniform-K table, K 512); ``record`` collects
    the batch extent of every loss call and every raster call (the raster
    spied on in ``pipeline`` until the caller puts it back)."""
    from diffdope_tpu_torch.render import pipeline

    pos, tri, adj, col = _sphere(2)
    proj = _proj(RES)
    gtr = pipeline.render_batch(proj, _gt_pose(), pos, tri, RES, vtx_color=col,
                                edge_adj=adj, raster_impl="pallas", max_tris_per_tile=512,
                                device="cpu")
    gt = {"rgb": gtr["rgb"][0], "segmentation": gtr["mask"][0]}
    _, weights = select_losses(MASK_RGB)
    fused = pipeline.make_fused_loss(proj, pos, tri, RES, gt, lrs, weights, use_rgb=True,
                                     use_mask=True, edge_adj=adj, vtx_color=col,
                                     max_tris_per_tile=512, device="cpu")
    if record is not None:
        inner = fused

        def fused(mtx, learning_rates=None):
            record["loss"].append((int(mtx.shape[0]), learning_rates))
            return inner(mtx, learning_rates=learning_rates)

        raster = pipeline.raster_gather_rows_binned

        def spy(packed, *args, **kwargs):
            record["raster"].append(int(packed.shape[0]))
            return raster(packed, *args, **kwargs)

        pipeline.raster_gather_rows_binned = spy
    params0 = pose_params(np.array([0.05, 0, 0, 1.0], np.float32),
                          np.array([0.02, 0.0, -2.0], np.float32), B, "cpu")
    return params0, fused, gt


def _appearance_problem():
    """:219-288's problem: icosphere(1), its vertex colours refined from
    a flat 0.3 with the pose, rgb L1 on the brute-force raster."""
    from diffdope_tpu_torch.render.pipeline import render_batch

    pos, tri, _, col_gt = _sphere(1)
    proj = _proj(RES)

    def render_fn(mtx, vtx_color=None):
        return render_batch(proj, mtx, pos, tri, RES,
                            vtx_color=col_gt if vtx_color is None else vtx_color,
                            raster_impl="reference", layout="channels", device="cpu")

    with torch.no_grad():
        gtr = render_fn(_gt_pose())
    gt = {"rgb": torch.stack(gtr["rgb"], -1)[0],
          "segmentation": gtr["mask"][0][..., None].expand(RES + (3,))}
    params0 = pose_params(np.array([0, 0, 0, 1.0], np.float32),
                          np.array([0, 0, -2.0], np.float32), B, "cpu")
    return params0, render_fn, gt, {"vtx_color": torch.full_like(col_gt, 0.3)}


def _numpy(res):
    out = {"params": {k: v.numpy() for k, v in res.params.items()},
           "mtx": res.mtx_history.numpy(), "total": res.total_loss.numpy(),
           "losses": {k: v.numpy() for k, v in res.losses_values.items()}}
    if res.opt_state is not None and "mu" in res.opt_state:
        out["mu"] = {k: v.numpy() for k, v in res.opt_state["mu"].items()}
    return out


def _dd_session(mesh_axis=1):
    """A port DiffDope on the CPU (icosphere(2), 48x64, B=4, the fused
    compact route on the plain twins), the gt the port's render."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.mesh import build_edge_adjacency
    from diffdope_tpu_torch.render.pipeline import render_batch
    from diffdope_tpu_torch.testing import icosphere

    h, w = DD_RES
    camera = tdd.Camera(fx=60.0, fy=60.0, cx=w / 2, cy=h / 2, im_width=w, im_height=h)
    verts, faces = icosphere(2)
    mesh = tdd.Mesh(pos=verts * 0.4, pos_idx=faces, vtx_normals=verts,
                    num_vertices=len(verts), num_triangles=len(faces),
                    vtx_color=(verts * 0.5 + 0.5).astype(np.float32),
                    edge_adj=build_edge_adjacency(faces))
    mtx_gt = pose_matrix(pose_params(np.array([0, 0, 0, 1.0], np.float32),
                                     np.array([0.05, 0.0, -3.0], np.float32), 1, "cpu"))[0]
    gtr = render_batch(camera.cam_proj, mtx_gt, mesh.pos, mesh.pos_idx, DD_RES,
                       vtx_color=mesh.vtx_color, edge_adj=mesh.edge_adj,
                       raster_impl="pallas", max_tris_per_tile=512, device="cpu")
    scene = tdd.Scene(tensor_rgb=tdd.Image(img_tensor=gtr["rgb"][0].numpy()),
                      tensor_segmentation=tdd.Image(img_tensor=gtr["mask"][0].numpy()))
    obj = tdd.Object3D(position=[0.013, -0.021, 3.0], rotation=[0.01, -0.02, 0.015, 1.0],
                       batchsize=4, mesh=mesh)
    cfg = copy.deepcopy(DD_CFG)
    cfg["tpu"]["mesh_axis"] = mesh_axis
    return tdd.DiffDope(cfg=tdd.ConfigNode(cfg), camera=camera, object3d=obj, scene=scene,
                        device="cpu")


def _worker(rank, root, lrs, lrs_app):
    """One rank of the spawn: every four-rank check, then (ranks 0 and 1)
    DiffDope in a two-rank group; results to ``root/rank<r>.pt``."""
    import torch.distributed as dist

    from diffdope_tpu_torch import parallel

    torch.set_num_threads(1)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group("gloo", init_method=f"file://{root}/rdv4", rank=rank,
                            world_size=N, timeout=timeout)
    out = {}
    mesh = parallel.hypothesis_mesh(n_devices=N, device="cpu")
    out["mesh"] = (mesh.rank, mesh.size, str(mesh.device))
    out["replicated"] = str(parallel.replicate({"a": np.zeros(2)}, mesh)["a"].device)
    with pytest.raises(ValueError, match="not 2"):
        parallel.hypothesis_mesh(n_devices=2, device="cpu")

    loss_fns, weights = select_losses(MASK)
    params0, render_fn, gt = _unfused_problem()
    lrs_t = torch.as_tensor(lrs)
    out["unfused"] = _numpy(parallel.refine_sharded(params0, render_fn, loss_fns, gt, lrs_t,
                                                    weights, mesh, **ADAM))
    with pytest.raises(ValueError, match="not divisible"):
        parallel.refine_sharded({k: v[:6] for k, v in params0.items()}, render_fn, loss_fns,
                                gt, lrs_t[:6], weights, mesh, **ADAM)
    with pytest.raises(NotImplementedError, match="opt_state"):
        parallel.refine_sharded(params0, render_fn, loss_fns, gt, lrs_t, weights, mesh,
                                opt_state={"count": 0}, **ADAM)

    from diffdope_tpu_torch.render import pipeline

    record = {"loss": [], "raster": []}
    raster = pipeline.raster_gather_rows_binned
    params0, fused, gt = _fused_problem(lrs_t, record)
    loss_fns, weights = select_losses(MASK_RGB)
    out["fused"] = _numpy(parallel.refine_sharded(params0, None, loss_fns, gt, lrs_t,
                                                  weights, mesh, fused_loss_fn=fused, **FUSED))
    pipeline.raster_gather_rows_binned = raster
    out["loss_batches"] = [b for b, _ in record["loss"]]
    out["loss_lrs"] = [None if x is None else x.numpy() for _, x in record["loss"]]
    out["raster_batches"] = record["raster"]

    params0, render_fn, gt, extra = _appearance_problem()
    loss_fns, weights = select_losses({"l1_rgb_with_mask": True, "weight_rgb": 1.0})
    out["appearance"] = _numpy(parallel.refine_sharded(
        params0, render_fn, loss_fns, gt, torch.as_tensor(lrs_app), weights, mesh,
        extra_params=extra, **SGD))
    dist.destroy_process_group()

    if rank < 2:
        dist.init_process_group("gloo", init_method=f"file://{root}/rdv2", rank=rank,
                                world_size=2, timeout=timeout)
        dd = _dd_session(mesh_axis=2)
        dd.run_optimization()
        out["dd"] = {"mtx": dd.mtx_history, "losses": dd.losses_values,
                     "telemetry": {k: v.numpy() for k, v in dd._result.telemetry.items()},
                     "total": dd._result.total_loss.numpy(), "argmin": dd.get_argmin(),
                     "pose": dd.get_pose(), "device": str(dd.device)}
        dist.destroy_process_group()
    torch.save(out, f"{root}/rank{rank}.pt")


def _assert_traj(got, want, rtol_mtx=2e-4, atol_mtx=2e-5):
    np.testing.assert_allclose(got["mtx"], want["mtx"], rtol=rtol_mtx, atol=atol_mtx)
    np.testing.assert_allclose(got["total"], want["total"], rtol=2e-4, atol=1e-6)


def _jax(res):
    return {"mtx": np.asarray(res.mtx_history), "total": np.asarray(res.total_loss),
            "params": {k: np.asarray(v) for k, v in res.params.items()}}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The spawn's per-rank results, and the loss scales it was given (the
    reference's draws)."""
    import jax

    import torch.multiprocessing as mp
    from diffdope_tpu.optimize import draw_learning_rates

    root = tmp_path_factory.mktemp("ranks")
    lrs = np.array(draw_learning_rates(jax.random.PRNGKey(1), B, (0.5, 2.0)))
    lrs_app = np.array(draw_learning_rates(jax.random.PRNGKey(0), B, (0.5, 2.0)))
    ctx = mp.spawn(_worker, args=(str(root), lrs, lrs_app), nprocs=N, join=False)
    deadline = time.monotonic() + SPAWN_DEADLINE_S
    while not ctx.join(timeout=5):  # raises when a rank fails
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.terminate()
            pytest.fail(f"the ranks did not finish within {SPAWN_DEADLINE_S} s")
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(N)]
    return ranks, lrs, lrs_app


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        for name in ("mtx", "total"):
            np.testing.assert_array_equal(r[key][name], first[name], err_msg=f"{key} {name}")
        for k, v in first["params"].items():
            np.testing.assert_array_equal(r[key]["params"][k], v, err_msg=f"{key} {k}")


def test_torch_sharded_matches_unsharded(spawned):
    """The counterpart of test_sharded_matches_unsharded: four ranks against
    the port's unsharded run and the reference's refine_sharded over four
    devices (the brute-force raster in both)."""
    import jax

    from diffdope_tpu.losses import select_losses as ref_losses
    from diffdope_tpu.parallel import hypothesis_mesh
    from diffdope_tpu.parallel import refine_sharded as ref_sharded
    from diffdope_tpu.testing import synthetic_scene as ref_scene

    ranks, lrs, _ = spawned
    for r, got in enumerate(ranks):
        assert got["mesh"] == (r, N, "cpu") and got["replicated"] == "cpu"
    _same_on_every_rank(ranks, "unfused")
    got = ranks[0]["unfused"]
    assert got["mtx"].shape == (ADAM["nb_iterations"] + 1, B, 4, 4)

    params0, render_fn, gt = _unfused_problem()
    loss_fns, weights = select_losses(MASK)
    whole = _numpy(refine(params0, render_fn, loss_fns, gt, torch.as_tensor(lrs), weights,
                          **ADAM))
    _assert_traj(got, whole)
    for k, v in whole["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=2e-4, atol=1e-6, err_msg=k)
    # Adam's first moments, reassembled from the ranks' slices
    for k, v in whole["mu"].items():
        np.testing.assert_allclose(got["mu"][k], v, rtol=2e-4, atol=1e-7, err_msg=k)

    scene = ref_scene(subdiv=1, resolution=RES, batchsize=B, seed=3, raster_impl="reference")
    ref_fns, ref_weights = ref_losses(MASK)
    ref = ref_sharded(scene["params0"], scene["render_fn"], ref_fns, scene["gt"], lrs,
                      ref_weights, hypothesis_mesh(N), **ADAM)
    assert len(jax.devices()) >= N
    _assert_traj(got, _jax(ref))


def test_torch_sharded_fused_loss_per_call_learning_rates(spawned):
    """The counterpart of test_sharded_fused_loss_matches_unsharded and
    test_shard_map_runs_local_batch: the fused loss takes each rank's own
    slice of the loss scales per call, each rank's raster sees B/n
    hypotheses, and the run equals the unsharded one."""
    ranks, lrs, _ = spawned
    _same_on_every_rank(ranks, "fused")
    steps = FUSED["nb_iterations"] + 1
    for r, got in enumerate(ranks):
        assert got["loss_batches"] == [B // N] * steps
        assert got["raster_batches"] == [B // N] * steps
        for x in got["loss_lrs"]:
            np.testing.assert_array_equal(x, lrs[r * (B // N):(r + 1) * (B // N)])

    params0, fused, gt = _fused_problem(torch.as_tensor(lrs))
    loss_fns, weights = select_losses(MASK_RGB)
    whole = _numpy(refine(params0, None, loss_fns, gt, torch.as_tensor(lrs), weights,
                          fused_loss_fn=fused, **FUSED))
    _assert_traj(ranks[0]["fused"], whole)
    # the ranks bin over the group's union, so every hypothesis takes the
    # unsharded run's steps bit for bit
    np.testing.assert_array_equal(ranks[0]["fused"]["mtx"], whole["mtx"])


def test_torch_sharded_appearance_sums_gradients(spawned):
    """The counterpart of test_sharded_appearance_matches_unsharded: the
    shared vertex colours' gradients are summed over the ranks, so the
    sharded run refines them as the unsharded one does, in the port and
    against the reference's unsharded refine."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.losses import select_losses as ref_losses
    from diffdope_tpu.optimize import refine as ref_refine
    from diffdope_tpu.render.pipeline import render_batch as ref_render

    ranks, _, lrs_app = spawned
    _same_on_every_rank(ranks, "appearance")
    got = ranks[0]["appearance"]

    params0, render_fn, gt, extra = _appearance_problem()
    loss_fns, weights = select_losses({"l1_rgb_with_mask": True, "weight_rgb": 1.0})
    whole = _numpy(refine(params0, render_fn, loss_fns, gt, torch.as_tensor(lrs_app),
                          weights, extra_params=extra, **SGD))
    np.testing.assert_allclose(got["params"]["vtx_color"], whole["params"]["vtx_color"],
                               rtol=2e-4, atol=1e-5)
    _assert_traj(got, whole)
    assert not np.allclose(got["params"]["vtx_color"], 0.3)

    pos, tri, _, col = (np.asarray(t) for t in _sphere(1))
    proj = jnp.asarray(_proj(RES).numpy())

    def ref_fn(mtx, vtx_color=None):
        return ref_render(proj, mtx, jnp.asarray(pos), jnp.asarray(tri), RES,
                          vtx_color=jnp.asarray(col) if vtx_color is None else vtx_color,
                          raster_impl="reference", layout="channels")

    ref_gt = {k: jnp.asarray(v.numpy()) for k, v in gt.items()}
    ref_fns, ref_weights = ref_losses({"l1_rgb_with_mask": True, "weight_rgb": 1.0})
    ref = jax.jit(lambda p, e: ref_refine(p, ref_fn, ref_fns, ref_gt, jnp.asarray(lrs_app),
                                          ref_weights, extra_params=e, **SGD))(
        {k: jnp.asarray(v.numpy()) for k, v in params0.items()},
        {"vtx_color": jnp.full(col.shape, 0.3, jnp.float32)})
    np.testing.assert_allclose(got["params"]["vtx_color"], np.asarray(ref.params["vtx_color"]),
                               rtol=2e-4, atol=1e-5)
    _assert_traj(got, _jax(ref))


def test_torch_diffdope_mesh_axis_matches_unsharded(spawned):
    """DiffDope with tpu.mesh_axis 2 on two ranks: every rank returns the
    global history, the same argmin and pose as the unsharded session."""
    ranks, _, _ = spawned
    whole = _dd_session()
    whole.run_optimization()
    for got in ranks[:2]:
        d = got["dd"]
        assert d["device"] == "cpu"
        assert d["mtx"].shape == whole.mtx_history.shape == (4, 4, 4, 4)
        np.testing.assert_allclose(d["mtx"], whole.mtx_history, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(d["total"], whole._result.total_loss.numpy(), rtol=2e-4,
                                   atol=1e-6)
        for k, v in whole.losses_values.items():
            np.testing.assert_allclose(d["losses"][k], v, rtol=2e-4, atol=1e-6, err_msg=k)
        assert d["argmin"] == whole.get_argmin()
        np.testing.assert_allclose(d["pose"], whole.get_pose(), rtol=2e-4, atol=2e-5)
    for key in ("mtx", "total"):
        np.testing.assert_array_equal(ranks[0]["dd"][key], ranks[1]["dd"][key])
    np.testing.assert_array_equal(ranks[0]["dd"]["mtx"], whole.mtx_history)
    # the table's counters, the same on every rank (the union's table) and
    # reduced by MAX: the unsharded run's (the 48x64 frame takes no crop)
    telemetry = {k: v.numpy() for k, v in whole._result.telemetry.items()}
    assert set(ranks[0]["dd"]["telemetry"]) == set(telemetry) == {
        "_bin_max", "_bin_need", "_bin_overflow"}
    for k, v in telemetry.items():
        np.testing.assert_array_equal(ranks[0]["dd"]["telemetry"][k], v, err_msg=k)
    assert "dd" not in ranks[2] and "dd" not in ranks[3]


def test_torch_rank_device_never_picks_the_cpu_unasked(monkeypatch):
    """With no card, ``rank_device()`` and ``rank_device("cuda")`` raise,
    naming the missing card, and so does ``hypothesis_mesh()`` on a group:
    only ``device="cpu"`` gives the CPU."""
    import torch.distributed as dist

    from diffdope_tpu_torch import parallel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            parallel.rank_device(device)
    assert parallel.rank_device("cpu") == torch.device("cpu")
    assert parallel.rank_device(torch.device("cpu")) == torch.device("cpu")
    with tempfile.TemporaryDirectory() as root:
        dist.init_process_group("gloo", init_method=f"file://{root}/rdv", rank=0,
                                world_size=1)
        try:
            with pytest.raises(RuntimeError, match="no CUDA card"):
                parallel.hypothesis_mesh(n_devices=1)
            assert parallel.hypothesis_mesh(n_devices=1, device="cpu").device == \
                torch.device("cpu")
        finally:
            dist.destroy_process_group()


def test_torch_hypothesis_mesh_refuses_without_a_group(monkeypatch):
    """No process group and no torchrun environment: hypothesis_mesh, and
    so DiffDope's sharded run, raise by name."""
    import torch.distributed as dist

    from diffdope_tpu_torch import parallel

    assert not dist.is_initialized()
    for key in parallel.TORCHRUN_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(RuntimeError, match="no process group"):
        parallel.hypothesis_mesh(n_devices=2)
    dd = _dd_session(mesh_axis=2)
    with pytest.raises(RuntimeError, match="torchrun"):
        dd.run_optimization()
