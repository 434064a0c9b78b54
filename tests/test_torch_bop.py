"""The port's real-BOP branch (``bop.refine_bop_frame``, ``_sweep_real_frame``
and ``examples/run_bop_scene.py``) on a BOP scene written under
``tmp_path`` with the recipe of ``tests/test_bop.py:_make_dataset``: a
vertex-coloured icosphere(1) model in millimetres (the port's
``save_ply``), rgb / 16-bit depth / mask_visib PNGs of the JAX package's
brute-force render at a known OpenCV pose (the port's ``write_png``), and
scene_camera.json.

- Both packages refine a perturbed init for 3 Adam steps on the brute
  force (the reference's loss scales fed to the port): the refined poses
  agree at rtol 2e-4 (atol 1e-6), the kept hypothesis exactly, the final
  loss at rtol 1e-4, and ADD, ADD-S and the diameter at rtol 1e-4.
- The port alone at 40 steps meets ``tests/test_bop.py:85``'s bar: ADD
  below half the init's and below 15% of the diameter.
- A missing mask raises; the camera comes from cam_K at the full size;
  the sweep's real branch and the scene script run end to end on the
  CPU."""

import json

import numpy as np
import pytest
import torch
from torch_scene import one_torch_thread  # noqa: F401

RES = (64, 64)
F = 70.0
CFG = {
    "scene": {"image_resize": 1.0},
    "losses": {"l1_mask": True, "weight_mask": 1.0,
               "l1_rgb_with_mask": True, "weight_rgb": 1.0},
    "hyperparameters": {"batchsize": 2, "nb_iterations": 40, "base_lr": 0.15,
                        "lr_decay": 0.3, "learning_rates_bound": [0.8, 1.5]},
    "tpu": {"seed": 0, "optimizer": "adam", "raster_impl": "reference", "progress": False},
}


def _make_dataset(root, scene_rel="scene/000001", models_rel="models"):
    """The reference test's synthesized scene, its files written by the
    port: (scene_dir, models_dir, gt object, model points in units)."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu import geometry as jgeo
    from diffdope_tpu.optimize import pose_matrix, pose_params
    from diffdope_tpu.render.pipeline import render_batch

    from diffdope_tpu_torch.mesh import save_ply
    from diffdope_tpu_torch.testing import icosphere, write_png

    h, w = RES
    verts, faces = icosphere(1)
    colors = (verts * 0.5 + 0.5).astype(np.float32)
    models = root / models_rel
    models.mkdir(parents=True)
    save_ply(models / "obj_000001.ply", verts * 0.4 * 100.0, faces, colors=colors)

    r_gt = np.asarray(jgeo.matrix33_from_quat(
        jnp.asarray(jgeo.quat_from_axis_angle(np.array([0.2, 1, 0.1]), 0.6))))
    t_gt_cv = np.array([0.05, -0.03, 2.5])
    p_gl, q_gl = jgeo.opencv_to_opengl(t_gt_cv, r_gt)
    mtx, _, _ = pose_matrix(pose_params(q_gl, p_gl, 1))
    proj = jnp.asarray(jgeo.projection_from_intrinsics(F, F, w / 2, h / 2, w, h, 0.01, 100.0),
                       jnp.float32)
    out = jax.jit(lambda m: render_batch(
        proj, m, jnp.asarray(verts * 0.4), jnp.asarray(faces), RES,
        vtx_color=jnp.asarray(colors), raster_impl="reference"))(mtx)

    scene_dir = root / scene_rel
    for sub in ("rgb", "depth", "mask_visib"):
        (scene_dir / sub).mkdir(parents=True)
    rgb = (np.asarray(out["rgb"][0])[::-1] * 255).clip(0, 255).astype(np.uint8)
    write_png(scene_dir / "rgb" / "000000.png", rgb)
    depth = np.asarray(out["depth"][0])[::-1]
    write_png(scene_dir / "depth" / "000000.png",
              (depth * 100.0).clip(0, 65535).astype(np.uint16))
    mask = (np.asarray(out["mask"][0, ..., 0])[::-1] > 0.5).astype(np.uint8) * 255
    write_png(scene_dir / "mask_visib" / "000000_000000.png", mask)
    with open(scene_dir / "scene_camera.json", "w") as f:
        json.dump({"0": {"cam_K": [F, 0, w / 2, 0, F, h / 2, 0, 0, 1]}}, f)
    gt_obj = {"obj_id": 1, "cam_R_m2c": r_gt.reshape(-1).tolist(),
              "cam_t_m2c": (t_gt_cv / 0.01).tolist()}
    return scene_dir, models, gt_obj, verts * 0.4


def _perturbed(gt_obj, deg=10.0, dt_mm=(12.0, -9.0, 20.0)):
    from diffdope_tpu_torch import geometry as geo

    r_gt = np.asarray(gt_obj["cam_R_m2c"], float).reshape(3, 3)
    dq = geo.quat_from_axis_angle(np.array([1.0, 0.2, 0.1]), np.deg2rad(deg))
    r0 = geo.matrix33_from_quat(torch.tensor(dq)).numpy() @ r_gt
    t0 = np.asarray(gt_obj["cam_t_m2c"], float) + np.asarray(dt_mm)
    return {"obj_id": 1, "cam_R_m2c": r0.reshape(-1).tolist(), "cam_t_m2c": t0.tolist()}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return _make_dataset(tmp_path_factory.mktemp("bop"))


def _reference_lrs(batch, bounds):
    import jax

    from diffdope_tpu.optimize import draw_learning_rates

    return torch.tensor(np.asarray(draw_learning_rates(jax.random.PRNGKey(0), batch, bounds)))


def test_torch_refine_bop_frame_matches_reference(dataset, monkeypatch):
    import diffdope_tpu as jdd
    from diffdope_tpu.bop import refine_bop_frame as ref_refine

    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch import diffdope as port_diffdope
    from diffdope_tpu_torch.bop import refine_bop_frame

    scene_dir, models, gt_obj, _ = dataset
    init = _perturbed(gt_obj)
    cfg = json.loads(json.dumps(CFG))
    cfg["hyperparameters"]["nb_iterations"] = 3
    want = ref_refine(jdd.ConfigNode(cfg), scene_dir, models, [init], frame="0",
                      obj_scale=0.01, gt_objs=[gt_obj])["0"]
    lrs = _reference_lrs(2, [0.8, 1.5])
    monkeypatch.setattr(port_diffdope, "draw_learning_rates", lambda *a, **k: lrs)
    got = refine_bop_frame(tdd.ConfigNode(cfg), scene_dir, models, [init], frame="0",
                           obj_scale=0.01, gt_objs=[gt_obj], device="cpu")["0"]
    assert set(got) == set(want)
    assert got["obj_id"] == want["obj_id"] == 1
    assert got["argmin"] == want["argmin"]
    for key in ("cam_R_m2c", "cam_t_m2c"):
        np.testing.assert_allclose(got[key], want[key], rtol=2e-4, atol=1e-6, err_msg=key)
    for key in ("final_loss", "add", "adds", "diameter"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert not np.allclose(got["cam_t_m2c"], init["cam_t_m2c"])


def test_torch_bop_frame_refinement_recovers_pose(dataset):
    """The port alone at 40 steps: the bar of ``tests/test_bop.py:85``."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.bop import refine_bop_frame
    from diffdope_tpu_torch.metrics import add_metric

    scene_dir, models, gt_obj, pts = dataset
    init = _perturbed(gt_obj)
    entry = refine_bop_frame(tdd.ConfigNode(CFG), scene_dir, models, [init], frame="0",
                             obj_scale=0.01, gt_objs=[gt_obj], device="cpu")["0"]
    assert np.isfinite(entry["final_loss"])
    f32 = torch.float32

    def rt(obj):
        return (torch.tensor(obj["cam_R_m2c"], dtype=f32).reshape(3, 3),
                torch.tensor(obj["cam_t_m2c"], dtype=f32) * 0.01)

    add_init = float(add_metric(pts.astype(np.float32), *rt(init), *rt(gt_obj)))
    assert entry["add"] < add_init * 0.5, (add_init, entry["add"])
    assert entry["add"] < 0.15 * entry["diameter"], (entry["add"], entry["diameter"])


def test_torch_bop_frame_refuses_missing_mask_and_reads_camera(dataset, tmp_path):
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.bop import load_bop_camera, refine_bop_frame

    scene_dir, models, gt_obj, _ = dataset
    cam = load_bop_camera(scene_dir, "0", (32, 32), 0.5)
    assert (cam.fx, cam.fy, cam.cx, cam.cy, cam.im_width, cam.im_height) == (
        F, F, RES[1] / 2, RES[0] / 2, 64, 64)
    assert load_bop_camera(tmp_path, "0", RES) is None
    # object 0 is refined (one step) before object 1's mask is looked up
    cfg = json.loads(json.dumps(CFG))
    cfg["hyperparameters"]["nb_iterations"] = 1
    two = [_perturbed(gt_obj), _perturbed(gt_obj, 5.0)]
    with pytest.raises(FileNotFoundError, match="000000_000001"):
        refine_bop_frame(tdd.ConfigNode(cfg), scene_dir, models, two, frame="0",
                         device="cpu")


def test_torch_bop_real_sweep_and_scene_script(tmp_path, capsys):
    """The sweep's real branch (init from the error JSON, ground truth
    from scene_gt.json) and ``run_bop_scene.main`` with dotted overrides
    and ``--device cpu``: refined poses written, one line per object."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch import bop
    from diffdope_tpu_torch.examples import run_bop_scene

    scene_dir, _, gt_obj, _ = _make_dataset(tmp_path, "bop/val/000001", "bop/models")
    with open(scene_dir / "scene_gt.json", "w") as f:
        json.dump({"0": [gt_obj]}, f)
    init = _perturbed(gt_obj, 8.0, (10.0, -8.0, 15.0))
    err_dir = tmp_path / "data" / "hope" / "val" / "000001"
    err_dir.mkdir(parents=True)
    err_json = err_dir / "scene_error_deg_001_trans_001.json"
    with open(err_json, "w") as f:
        json.dump({"0": [init]}, f)
    cfg = json.loads(json.dumps(CFG))
    cfg["hyperparameters"]["nb_iterations"] = 3
    res = bop.sweep_perturbation_levels(
        str(tmp_path / "data"), dataset="hope", levels=["deg_001_trans_001"],
        bop_root=str(tmp_path / "bop"), cfg=tdd.ConfigNode(cfg), log_fn=lambda *a: None,
        device="cpu")["deg_001_trans_001"]
    assert res["mode"] == "real" and res["n"] == 1
    entry = res["per_object"][0]
    assert entry["scene"] == "val/000001" and entry["i_obj"] == 0 and entry["obj_id"] == 1
    assert np.isfinite(entry["add"]) and np.isfinite(res["auc_01d"])
    assert res["acc_01d_init"] is None  # the real branch scores no init

    out_dir = tmp_path / "out"
    out_dir.mkdir()
    got = run_bop_scene.main([
        f"bop.scene_dir={scene_dir}", f"bop.models_dir={tmp_path / 'bop' / 'models'}",
        f"bop.error_json={err_json}", "bop.frame=0", f"bop.out_dir={out_dir}",
        f"bop.gt_json={scene_dir / 'scene_gt.json'}", "scene.image_resize=1.0",
        "hyperparameters.nb_iterations=2", "hyperparameters.batchsize=2",
        "--device", "cpu"])
    written = json.loads((out_dir / "refined_poses.json").read_text())
    assert set(written) == set(got) == {"0"}
    assert written["0"]["obj_id"] == 1 and len(written["0"]["cam_R_m2c"]) == 9
    printed = capsys.readouterr().out
    assert "object 0 (obj_id 1): loss" in printed and "ADD" in printed
