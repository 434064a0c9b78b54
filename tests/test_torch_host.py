"""Port parity for the host layer: config, mesh loading, camera, initial
pose, the OpenCV/OpenGL conversions, the unfused losses and backface
culling, each against the JAX package's counterpart on the same inputs."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from torch_scene import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
STANDINS = ("standin_asym.ply", "standin_sym.ply")


def _chip_smoke_config():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.DEFAULT_CONFIG


def _without_paths(cfg):
    cfg = {k: dict(v) if isinstance(v, dict) else v for k, v in cfg.items()}
    cfg["object3d"].pop("model_path")
    for k in ("path_img", "path_depth", "path_segmentation"):
        cfg["scene"].pop(k, None)
    return cfg


def test_torch_load_config_matches_reference():
    from diffdope_tpu.config import load_config as j_load
    from diffdope_tpu_torch.config import ConfigNode, load_config

    overrides = ["hyperparameters.batchsize=4", "tpu.optimizer=adam", "losses.l1_rgb_with_mask=true"]
    cfg = load_config(ROOT / "configs" / "diffdope.yaml", overrides)
    ref = j_load(ROOT / "configs" / "diffdope.yaml", overrides)
    assert isinstance(cfg.camera, ConfigNode)
    assert cfg == ref.to_dict()
    assert cfg.get_dotted("tpu.optimizer") == "adam" and cfg.hyperparameters.batchsize == 4
    assert cfg.get_dotted("tpu.missing", 7) == 7
    cfg.set_dotted("tpu.new.key", 1)
    assert cfg.tpu.new.key == 1
    assert cfg.merge({"camera": {"fx": 1.0}}).camera.fy == ref.camera.fy
    # chip_smoke.py's default-configuration phase holds the same values
    assert _without_paths(load_config()) == _without_paths(_chip_smoke_config())


@pytest.mark.parametrize("name", STANDINS)
def test_torch_load_mesh_matches_reference(name):
    from diffdope_tpu.mesh import load_mesh as j_load
    from diffdope_tpu_torch.mesh import load_mesh

    path = ROOT / "data" / "standins" / name
    got, ref = load_mesh(path, scale=0.01), j_load(path, scale=0.01)
    for key in ("pos", "pos_idx", "vtx_color", "edge_adj", "vtx_normals"):
        assert getattr(got, key).shape == getattr(ref, key).shape, key
        np.testing.assert_allclose(getattr(got, key), getattr(ref, key), rtol=1e-6,
                                   atol=1e-7, err_msg=key)
    np.testing.assert_array_equal(got.pos_idx, ref.pos_idx)
    np.testing.assert_array_equal(got.edge_adj, ref.edge_adj)
    for key in ("num_vertices", "num_triangles", "is_closed", "is_oriented", "n_rewound"):
        assert getattr(got, key) == getattr(ref, key), key
    assert got.is_closed and got.is_oriented
    assert got.pos.shape[0] % 8 == 0 and got.pos_idx.shape[0] % 8 == 0


def test_torch_obj_and_winding_match_reference(tmp_path):
    """An .obj with a rewound face: the loader, the winding repair and the
    normals match the reference's."""
    from diffdope_tpu.mesh import load_mesh as j_load
    from diffdope_tpu_torch.mesh import load_mesh
    from diffdope_tpu_torch.testing import icosphere

    v, f = icosphere(1)
    f = f.copy()
    f[3] = f[3, [0, 2, 1]]
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in f]
    path = tmp_path / "sphere.obj"
    path.write_text("\n".join(lines) + "\n")
    got, ref = load_mesh(path), j_load(path)
    np.testing.assert_array_equal(got.pos_idx, ref.pos_idx)
    np.testing.assert_allclose(got.pos, ref.pos)
    np.testing.assert_allclose(got.vtx_normals, ref.vtx_normals, rtol=1e-5, atol=1e-6)
    assert got.n_rewound == ref.n_rewound == 1


def test_torch_camera_pose_and_frames_match_reference():
    import diffdope_tpu as jdd
    from diffdope_tpu import geometry as jgeo
    from diffdope_tpu_torch import Camera, Object3D, geometry
    from diffdope_tpu_torch.config import load_config

    cfg = load_config()
    cam, j_cam = Camera(**cfg.camera), jdd.Camera(**cfg.camera)
    cam.resize(cfg.scene.image_resize)
    j_cam.resize(cfg.scene.image_resize)
    assert (cam.im_width, cam.im_height) == (960, 540)
    np.testing.assert_array_equal(cam.cam_proj, j_cam.cam_proj)

    pose = {k: cfg.object3d[k] for k in ("position", "rotation", "scale")}
    for rotation in (pose["rotation"], [0.1, -0.3, 0.2, 0.9]):
        args = dict(position=pose["position"], rotation=rotation, scale=pose["scale"])
        obj, j_obj = Object3D(batchsize=5, **args), jdd.Object3D(batchsize=5, **args)
        for k, v in obj.initial_params(device="cpu").items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(j_obj.initial_params()[k]),
                                          err_msg=k)
        np.testing.assert_allclose(obj.initial_matrix(), j_obj.initial_matrix(), atol=1e-7)
        p, q = geometry.opencv_to_opengl(args["position"], rotation)
        jp, jq = jgeo.opencv_to_opengl(args["position"], rotation)
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_allclose(q, jq, rtol=1e-7, atol=1e-8)
        m = obj.initial_matrix()
        np.testing.assert_allclose(geometry.opengl_to_opencv(m), jgeo.opengl_to_opencv(m))
    np.testing.assert_allclose(
        geometry.quat_from_matrix33(np.diag([1.0, -1.0, -1.0])),
        jgeo.quat_from_matrix33(np.diag([1.0, -1.0, -1.0])))


def test_torch_unfused_losses_match_reference():
    """The three losses on the same renders and gt: values, logs and the
    gradient w.r.t. the renders (|x| differentiates as +1 at 0 in both)."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu import losses as jl
    from diffdope_tpu_torch import losses as tl

    rng = np.random.default_rng(4)
    b, h, w = 3, 16, 24
    renders = {"mask": rng.uniform(size=(b, h, w)).astype(np.float32),
               "rgb": rng.uniform(size=(b, h, w, 3)).astype(np.float32),
               "depth": rng.uniform(1, 2, size=(b, h, w)).astype(np.float32)}
    renders["mask"][:, :4] = 0.0  # exact zeros against a zero gt
    gt = {"segmentation": (rng.uniform(size=(h, w, 3)) > 0.5).astype(np.float32),
          "rgb": rng.uniform(size=(h, w, 3)).astype(np.float32),
          "depth": rng.uniform(1, 2, size=(h, w)).astype(np.float32)}
    gt["segmentation"][:4] = 0.0
    lrs = np.asarray([0.5, 1.0, 2.0], np.float32)
    weights = {"rgb": 0.7, "depth": 1.3, "mask": 1.0}
    for name in ("l1_rgb_with_mask", "l1_depth_with_mask", "l1_mask"):
        def j_loss(r, name=name):
            return jl.LOSS_REGISTRY[name](r, {k: jnp.asarray(v) for k, v in gt.items()},
                                          jnp.asarray(lrs), weights)
        (j_val, (j_key, j_log)), j_grad = jax.value_and_grad(
            lambda r: (j_loss(r)[0], j_loss(r)[1]), has_aux=True)(
            {k: jnp.asarray(v) for k, v in renders.items()})
        t_r = {k: torch.tensor(v, requires_grad=True) for k, v in renders.items()}
        val, (key, log) = tl.LOSS_REGISTRY[name](
            t_r, {k: torch.tensor(v) for k, v in gt.items()}, torch.tensor(lrs), weights)
        grads = torch.autograd.grad(val, list(t_r.values()), allow_unused=True)
        assert key == j_key
        np.testing.assert_allclose(val.item(), float(j_val), rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(log.detach().numpy(), np.asarray(j_log), rtol=1e-6)
        for k, g in zip(t_r, grads):
            want = np.asarray(j_grad[k])
            got = np.zeros_like(want) if g is None else g.numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9, err_msg=f"{name} {k}")
    fns, _ = tl.select_losses({"l1_mask": True, "l1_depth_with_mask": True})
    assert [f.__name__ for f in fns] == ["l1_depth_with_mask", "l1_mask"]


def test_torch_backface_culling_matches_reference():
    """bin_triangles_planar(cull_backfaces=True) on the torch_scene's poses
    and the reference's tiles: the same per-tile sets, and culling drops
    about half the (tile, triangle) pairs of this closed mesh."""
    from torch_scene import JAX_TILE_HW, MAX_K, RES, jax_compact_table, jax_scene

    import jax.numpy as jnp

    from diffdope_tpu.render import planar as jp
    from diffdope_tpu_torch.render import planar as tp

    sc, ref = jax_scene(), jax_compact_table()
    t_count = sc["tri"].shape[0]
    pos_c = sc["pos"][sc["tri"].reshape(-1)]
    j_cp = jp.corner_planes(jnp.asarray(pos_c), jnp.asarray(ref["mvp"]))
    j_idx, j_counts, _ = jp.bin_triangles_planar(
        j_cp, jnp.asarray(ref["det"]), RES, JAX_TILE_HW, MAX_K, cull_backfaces=True)
    cp = tp.corner_planes(torch.tensor(pos_c), torch.tensor(ref["mvp"]))
    idx, counts, ovf = tp.bin_triangles_planar(
        cp, torch.tensor(ref["det"]), RES, JAX_TILE_HW, MAX_K, cull_backfaces=True)
    assert int(ovf) == 0
    np.testing.assert_array_equal(counts.numpy(), np.asarray(j_counts))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert counts.sum() < 0.7 * ref["counts"].sum()
    assert t_count in set(idx.reshape(-1).tolist())  # sentinel padding
