"""Port parity for DiffDope as a whole: a reference session and a port
session (device="cpu") on the reference test's synthetic scene
(tests/test_diffdope.py: icosphere(2), 48x64, B=3, 4 steps), the port
session built from the reference's state (convert.diffdope_state), its
loss scales included.  Both run the compact table with the spanning op's
d_rows cotangent in f32 (DD_DROWS_BF16=0, set for both), and the reference bins on
8-row tiles (tpu.tile_h, which the port does not read): on 16- and 32-row
tiles its compact raster drops the object's bottom two pixel rows on this
scene, where its uniform-K raster and the port do not (ROADMAP queue 3).

The initial pose is the reference test's, moved off the optical axis
(INIT_POSITION, INIT_ROTATION): centred, the sphere's silhouette lies on
exact pixel-centre ties, where the two packages take different
subgradients in the pose components that cancel by symmetry (y, qx, z:
up to 8e-5 apart on gradients of 9e-5); off-centre they agree to ~1e-7."""

import copy

import numpy as np
import pytest
import torch

from diffdope_tpu_torch import convert
from diffdope_tpu_torch.bench import drows_env
from torch_scene import one_torch_thread  # noqa: F401

RES = (48, 64)
B = 3
STEPS = 4
COMPACT_TOTAL = 2048
INIT_POSITION = [0.013, -0.021, 3.0]  # OpenCV frame: +z in front of the camera
INIT_ROTATION = [0.01, -0.02, 0.015, 1.0]
SGD_LR = 20.0
BASE_CFG = {
    "losses": {"l1_mask": True, "weight_mask": 1.0,
               "l1_rgb_with_mask": True, "weight_rgb": 0.7},
    "hyperparameters": {"batchsize": B, "nb_iterations": STEPS - 1,
                        "base_lr": 0.3, "lr_decay": 0.1,
                        "learning_rates_bound": [0.5, 2.0]},
    "tpu": {"seed": 1, "raster_impl": "pallas", "compact_total": COMPACT_TOTAL,
            "tile_h": 8, "progress": False},
}


def _cfg(optimizer, **tpu):
    """The session's config; SGD takes the default config's base_lr."""
    cfg = copy.deepcopy(BASE_CFG)
    cfg["tpu"]["optimizer"] = optimizer
    if optimizer == "sgd":
        cfg["hyperparameters"]["base_lr"] = SGD_LR
    cfg["tpu"].update(tpu)
    return cfg


def _camera_args():
    h, w = RES
    return dict(fx=60.0, fy=60.0, cx=w / 2, cy=h / 2, im_width=w, im_height=h)


def _reference_session(optimizer, monkeypatch, cfg=None, with_depth=False):
    import diffdope_tpu as dd
    import jax
    import jax.numpy as jnp
    from diffdope_tpu.mesh import Mesh, build_edge_adjacency
    from diffdope_tpu.optimize import pose_matrix, pose_params
    from diffdope_tpu.render.pipeline import render_batch
    from diffdope_tpu.testing import icosphere

    monkeypatch.setenv("DD_DROWS_BF16", "0")
    camera = dd.Camera(**_camera_args())
    verts, faces = icosphere(2)
    mesh = Mesh(
        pos=verts * 0.4, pos_idx=faces, vtx_normals=verts,
        num_vertices=len(verts), num_triangles=len(faces),
        vtx_color=(verts * 0.5 + 0.5).astype(np.float32),
        edge_adj=build_edge_adjacency(faces),
    )
    mtx_gt, _, _ = pose_matrix(pose_params(
        np.array([0, 0, 0, 1.0], np.float32), np.array([0.05, 0.0, -3.0], np.float32), 1))
    gtr = jax.jit(lambda m: render_batch(
        jnp.asarray(camera.cam_proj), m, jnp.asarray(mesh.pos), jnp.asarray(mesh.pos_idx),
        RES, vtx_color=jnp.asarray(mesh.vtx_color), edge_adj=jnp.asarray(mesh.edge_adj),
        raster_impl="pallas", max_tris_per_tile=512,
    ))(mtx_gt)
    scene = dd.Scene(
        tensor_rgb=dd.Image(img_tensor=np.asarray(gtr["rgb"][0])),
        tensor_segmentation=dd.Image(img_tensor=np.asarray(gtr["mask"][0])),
        tensor_depth=(dd.Image(img_tensor=np.asarray(gtr["depth"][0]), depth=True)
                      if with_depth else None),
    )
    obj = dd.Object3D(position=INIT_POSITION, rotation=INIT_ROTATION,
                      batchsize=B, mesh=mesh)
    d = dd.DiffDope(cfg=dd.ConfigNode(cfg or _cfg(optimizer)), camera=camera,
                    object3d=obj, scene=scene)
    d.run_optimization()
    return d


def _port_session(state, cfg):
    import diffdope_tpu_torch as tdd

    n, t = len(state["pos"]), len(state["pos_idx"])
    colors = {k: state.get(k) for k in ("vtx_color", "corner_colors", "tex", "uv", "uv_idx")}
    mesh = tdd.Mesh(pos=state["pos"], pos_idx=state["pos_idx"], vtx_normals=state["pos"],
                    num_vertices=n, num_triangles=t, edge_adj=state["edge_adj"],
                    is_closed=state["is_closed"], is_oriented=state["is_oriented"],
                    **colors)
    obj = tdd.Object3D(position=INIT_POSITION, rotation=INIT_ROTATION,
                       batchsize=B, mesh=mesh)
    depth = state["gt"].get("depth")
    scene = tdd.Scene(
        tensor_rgb=tdd.Image(img_tensor=state["gt"]["rgb"]),
        tensor_segmentation=tdd.Image(img_tensor=state["gt"]["segmentation"]),
        tensor_depth=None if depth is None else tdd.Image(img_tensor=depth, depth=True),
    )
    d = tdd.DiffDope(cfg=tdd.ConfigNode(cfg), camera=tdd.Camera(**_camera_args()),
                     object3d=obj, scene=scene, device="cpu")
    np.testing.assert_allclose(d.camera.cam_proj, state["proj"])
    for k, v in d.object3d.initial_params(B, "cpu").items():
        np.testing.assert_array_equal(v.numpy(), state["params0"][k], err_msg=k)
    d.learning_rates = torch.tensor(state["learning_rates"])
    return d


@pytest.fixture(scope="module")
def references():
    """The reference session under each optimizer."""
    with pytest.MonkeyPatch.context() as mp:
        return {opt: _reference_session(opt, mp) for opt in ("sgd", "adam")}


@pytest.fixture(scope="module")
def state(references):
    return convert.diffdope_state(references["sgd"])


@pytest.fixture(scope="module", params=["sgd", "adam"])
def sessions(request, references):
    ref = references[request.param]
    state = convert.diffdope_state(ref)
    port = _port_session(state, _cfg(request.param))
    with drows_env(False):  # the reference's DD_DROWS_BF16=0
        port.run_optimization()
    return request.param, ref, port, state


def test_torch_diffdope_matches_reference(sessions):
    optimizer, ref, port, _ = sessions
    assert port.mtx_history.shape == ref.mtx_history.shape == (STEPS, B, 4, 4)
    assert set(port.losses_values) == set(ref.losses_values) == {"rgb", "mask_selection"}
    for k, v in ref.losses_values.items():
        np.testing.assert_allclose(port.losses_values[k][0], v[0], rtol=1e-5, err_msg=k)
        if optimizer == "sgd":
            np.testing.assert_allclose(port.losses_values[k], v, rtol=2e-4, err_msg=k)
    if optimizer == "sgd":
        np.testing.assert_allclose(port.mtx_history, ref.mtx_history, atol=1e-5)
        assert port.get_argmin() == ref.get_argmin()
        np.testing.assert_allclose(port.get_pose(), ref.get_pose(), atol=1e-5)
        np.testing.assert_allclose(port.get_pose_opencv(), ref.get_pose_opencv(),
                                   atol=1e-5)
    else:
        # Adam divides each gradient by its rms, so a 1-ulp difference in a
        # near-zero component becomes an lr-sized step (tests/test_diffdope.py:
        # 246-252): later steps are not compared pointwise
        np.testing.assert_allclose(port.mtx_history[0], ref.mtx_history[0], atol=1e-5)
    assert port._telemetry_max(port._result, "_bin_overflow") == 0
    mask = port.losses_values["mask_selection"]
    assert mask[-1].mean() < mask[0].mean()


def test_torch_diffdope_fused_matches_unfused(sessions):
    """The port's unfused route (render_batch + loss functions) scores the
    same step-0 losses as its fused route."""
    optimizer, _, port, state = sessions
    unfused = _port_session(state, _cfg(optimizer, fused_loss=False))
    unfused.run_optimization()
    for k, v in port.losses_values.items():
        np.testing.assert_allclose(unfused.losses_values[k][0], v[0], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(unfused.mtx_history[0], port.mtx_history[0], atol=1e-7)
    mask = unfused.losses_values["mask_selection"]
    assert mask[-1].mean() < mask[0].mean()
    entry = unfused.renders
    assert entry["rgb"].shape == (B,) + RES + (3,)
    assert entry["mask"].shape == (B,) + RES + (3,)
    assert entry["depth"].shape == (B,) + RES
    np.testing.assert_array_equal(entry["mtx"], unfused.mtx_history[-1])


def test_torch_diffdope_overflow_recovery(state):
    """An undersized per-tile capacity (150, where the fullest 16x16 tile
    holds 195 triangles) drops (tile, triangle) pairs; the recovery grows
    it and re-runs, and the kept run is overflow-free (the port's
    counterpart of test_overflow_auto_recovery)."""
    cfg = _cfg("adam")
    cfg["hyperparameters"]["nb_iterations"] = 1
    d = _port_session(state, cfg)
    d.max_tris_per_tile = 150
    d.run_optimization()
    assert getattr(d, "_capacity_boost", 1.0) > 1.0
    assert d._telemetry_max(d._result, "_bin_overflow") == 0
    assert np.isfinite(d._result.total_loss.numpy()).all()

    cfg["tpu"]["overflow_recovery"] = False
    d = _port_session(state, cfg)
    d.max_tris_per_tile = 150
    d.run_optimization()
    assert getattr(d, "_capacity_boost", 1.0) == 1.0
    assert d._telemetry_max(d._result, "_bin_overflow") > 0


def test_torch_diffdope_recovery_sizes_table_from_need(state, monkeypatch):
    """A compact table probed far too small (two chunks) drops pairs on
    every step; the one re-run is sized from the slots the failed run
    needed ('_bin_need'), not by the x1.5 boost alone, and is clean."""
    import diffdope_tpu_torch.diffdope as port_dd

    monkeypatch.setattr(port_dd, "compact_capacity", lambda *a, **k: 64)
    cfg = _cfg("adam", compact_total=None)
    cfg["hyperparameters"]["nb_iterations"] = 1
    d = _port_session(state, cfg)
    d.run_optimization()
    assert d.last_run_stats["recovery_reruns"] == 1
    assert d._slots_seen > 64 * 1.5
    assert d._telemetry_max(d._result, "_bin_overflow") == 0
    assert d._telemetry_max(d._result, "_bin_need") <= d._slots_seen * 1.35


def test_torch_diffdope_set_batchsize_redraws(state):
    """set_batchsize redraws the loss scales from the seed: a new count
    gets new scales, and the same count the same scales again."""
    d = _port_session(state, _cfg("sgd"))
    d.set_batchsize(B)
    first = d.learning_rates.clone()
    assert not torch.equal(first, torch.tensor(state["learning_rates"]))
    d.set_batchsize(5)
    assert d.learning_rates.shape == (5,)
    d.set_batchsize(B)
    assert torch.equal(d.learning_rates, first)
    lo, hi = BASE_CFG["hyperparameters"]["learning_rates_bound"]
    assert bool(((first >= lo) & (first <= hi)).all())
