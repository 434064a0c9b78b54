"""The reference's last public surface, held against the JAX package on the
same inputs: ``ConfigNode``'s ``to_dict``, ``copy`` (F8: a deep copy that
is itself a ConfigNode), ``yaml`` and ``del cfg.key``; ``Mesh.scaled``;
``Object3D``'s ``forward``, ``reset_pose``, ``cuda`` and ``repr``, and the
no-op ``Camera`` methods; the conversions under ``conjugate_flip`` (atol
1e-12, float64); ``xfm_points(use_python=)``; ``pixel_ndc(dtype=)``;
``precompute_bins(cull_backfaces=)`` (the same triangles per tile).  Then
the slice as a whole on the port: ``DiffDope`` from a copied config with a
key deleted, on a ``Mesh.scaled`` mesh, after every ``cuda()``."""

import pathlib

import numpy as np
import pytest
import torch
from torch_scene import PORT_TILE_HW, RES, jax_scene, one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG = ROOT / "configs" / "diffdope.yaml"
STANDIN = ROOT / "data" / "standins" / "standin_asym.ply"
#: plain dicts through both ConfigNodes: nesting, a list of mappings, a
#: tuple, scalars of every YAML kind
DICTS = [
    {"a": {"b": 1, "c": {"d": [1, 2.5, "x"]}}, "s": "text", "n": None},
    {"runs": [{"lr": 0.1, "opt": {"name": "adam"}}, 3, [4, 5]], "flag": True,
     "pair": (1, 2)},
]


def _configs(data):
    from diffdope_tpu.config import ConfigNode as RefNode
    from diffdope_tpu.config import load_config as ref_load
    from diffdope_tpu_torch.config import ConfigNode, load_config

    if data is None:
        return load_config(CONFIG), ref_load(CONFIG)
    return ConfigNode(data), RefNode(data)


@pytest.mark.parametrize("case", [0, 1, "file"])
def test_torch_config_to_dict_and_yaml_match_reference(case):
    cfg, ref = _configs(None if case == "file" else DICTS[case])
    got = cfg.to_dict()
    assert got == ref.to_dict()
    assert type(got) is dict
    assert all(type(v) is not type(cfg) for v in got.values())
    assert cfg.yaml() == ref.yaml()


@pytest.mark.parametrize("case", [0, 1, "file"])
def test_torch_config_copy_is_a_deep_config_node(case):
    """F8: ``copy()`` is a ConfigNode, deep: changing the copy at any depth
    leaves the original as the reference's original is."""
    from diffdope_tpu_torch.config import ConfigNode

    cfg, ref = _configs(None if case == "file" else DICTS[case])
    dup = cfg.copy()
    assert isinstance(dup, ConfigNode) and dup == cfg and dup is not cfg
    if case == "file":
        dup.tpu.optimizer = "adam"
        dup.object3d.position[0] = 0.0
        key = "tpu"
    elif case == 0:
        dup.a.c.d.append(7)
        dup.a.b = 2
        key = "a"
    else:
        dup.runs[0].opt.name = "sgd"
        dup.runs[2].append(6)
        key = "runs"
    assert dup[key] != cfg[key]
    assert cfg.to_dict() == ref.to_dict()
    ref_dup = ref.copy()
    assert type(ref_dup).__name__ == "ConfigNode" and ref_dup.to_dict() == cfg.to_dict()


def test_torch_config_delattr_matches_reference():
    cfg, ref = _configs(None)
    for node in (cfg, ref):
        del node.tpu.roi_crop
        del node.scene
        with pytest.raises(AttributeError, match="missing"):
            del node.missing
        with pytest.raises(AttributeError):
            node.scene  # noqa: B018
    assert "roi_crop" not in cfg.tpu and "scene" not in cfg
    assert cfg.to_dict() == ref.to_dict()
    assert cfg.get_dotted("tpu.roi_crop", "auto") == "auto"


def test_torch_mesh_scaled_matches_reference():
    from diffdope_tpu.mesh import load_mesh as ref_load
    from diffdope_tpu_torch.mesh import load_mesh

    mesh, ref = load_mesh(STANDIN), ref_load(STANDIN)
    pos_before = mesh.pos.copy()
    got, want = mesh.scaled(0.001), ref.scaled(0.001)
    # every row scaled, the padding rows too; the original untouched
    assert got.pos.shape == mesh.pos.shape and got.num_vertices < len(got.pos)
    np.testing.assert_array_equal(got.pos, mesh.pos * 0.001)
    np.testing.assert_array_equal(mesh.pos, pos_before)
    np.testing.assert_allclose(got.pos, want.pos, rtol=1e-6, atol=1e-9)
    bv = np.stack([mesh.pos[: mesh.num_vertices].min(0),
                   mesh.pos[: mesh.num_vertices].max(0)]) * 0.001
    np.testing.assert_array_equal(got.bounding_volume, bv)
    np.testing.assert_allclose(got.bounding_volume, want.bounding_volume, rtol=1e-6,
                               atol=1e-9)
    # dimensions and centre are kept as they were, in both packages
    assert got.dimensions == mesh.dimensions and want.dimensions == ref.dimensions
    assert got.center_point == mesh.center_point
    np.testing.assert_allclose(got.dimensions, want.dimensions, rtol=1e-6)
    for key in ("pos_idx", "vtx_normals", "vtx_color", "edge_adj"):
        assert getattr(got, key) is getattr(mesh, key), key


def _objects():
    from diffdope_tpu.object3d import Object3D as RefObject
    from diffdope_tpu_torch.config import load_config
    from diffdope_tpu_torch.object3d import Object3D

    o3 = load_config(CONFIG).object3d.to_dict()
    o3["model_path"] = str(STANDIN)
    return Object3D(batchsize=4, **o3), RefObject(batchsize=4, **o3)


def test_torch_object3d_forward_and_repr_match_reference():
    obj, ref = _objects()
    got, want = obj.forward(), ref.forward()
    assert list(got) == list(want)
    assert {"pos", "pos_idx", "vtx_color", "vtx_normals", "quat", "trans"} <= set(got)
    for key, value in want.items():
        assert isinstance(got[key], np.ndarray), key
        assert got[key].shape == value.shape, key
        if key in ("quat", "trans"):
            np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-12, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], value, rtol=1e-6, atol=1e-7, err_msg=key)
    # copies of the pose: changing them changes nothing
    got["quat"][:] = 0.0
    assert np.abs(obj.forward()["quat"]).sum() > 0
    assert obj().keys() == got.keys()
    assert repr(obj) == repr(ref)
    assert repr(obj).startswith("Object3D(pos=[") and "batch=4" in repr(obj)


def test_torch_compatibility_methods_are_no_ops():
    """``reset_pose`` and every ``cuda`` change nothing and place nothing;
    ``Camera.set_batchsize`` keeps the one projection, as the reference's."""
    from diffdope_tpu.camera import Camera as RefCamera
    from diffdope_tpu_torch.camera import Camera

    obj, ref = _objects()
    before = obj.forward()
    assert obj.reset_pose() is None and obj.cuda() is None
    assert ref.reset_pose() is None and ref.cuda() is None
    after = obj.forward()
    for key, value in before.items():
        np.testing.assert_array_equal(after[key], value, err_msg=key)
    cam = Camera(fx=60.0, fy=61.0, cx=30.0, cy=20.0, im_width=64, im_height=48)
    ref_cam = RefCamera(fx=60.0, fy=61.0, cx=30.0, cy=20.0, im_width=64, im_height=48)
    proj = cam.cam_proj.copy()
    for c in (cam, ref_cam):
        assert c.set_batchsize(8) is None and c.cuda() is None
    np.testing.assert_array_equal(cam.cam_proj, proj)
    np.testing.assert_array_equal(cam.cam_proj, ref_cam.cam_proj)
    assert isinstance(cam.cam_proj, np.ndarray)


def _rotations(n=6, seed=3):
    """Seeded rotation matrices, float64."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        out.append(q * np.sign(np.linalg.det(q)))
    return out


@pytest.mark.parametrize("flip", [True, False])
def test_torch_conversions_conjugate_flip_match_reference(flip):
    from diffdope_tpu import geometry as jgeo
    from diffdope_tpu_torch import geometry as tgeo

    mats = _rotations()
    rng = np.random.default_rng(4)
    for r in mats:
        t = rng.normal(size=3) * 100.0
        for rot in (r, r.reshape(-1)):
            p_got, q_got = tgeo.opencv_to_opengl(t, rot, conjugate_flip=flip)
            p_want, q_want = jgeo.opencv_to_opengl(t, rot, conjugate_flip=flip)
            np.testing.assert_allclose(p_got, p_want, rtol=0, atol=1e-12)
            np.testing.assert_allclose(q_got, q_want, rtol=0, atol=1e-12)
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = r, t
        got = tgeo.opengl_to_opencv(m, conjugate_flip=flip)
        np.testing.assert_allclose(got, jgeo.opengl_to_opencv(m, conjugate_flip=flip),
                                   rtol=0, atol=1e-12)
        # the round trip gives the input back
        p_gl, q_gl = tgeo.opencv_to_opengl(t, r, conjugate_flip=flip)
        m_gl = np.eye(4)
        m_gl[:3, :3] = tgeo.matrix33_from_quat(torch.as_tensor(q_gl)).numpy()
        m_gl[:3, 3] = p_gl
        back = tgeo.opengl_to_opencv(m_gl, conjugate_flip=flip)
        np.testing.assert_allclose(back[:3, :3], r, rtol=0, atol=1e-12)
        np.testing.assert_allclose(back[:3, 3], t, rtol=0, atol=1e-12)
    # the two branches differ: F R F against F R
    r = mats[0]
    f = tgeo.CV_TO_GL_FLIP
    m = np.eye(4)
    m[:3, :3] = r
    np.testing.assert_allclose(tgeo.opengl_to_opencv(m, conjugate_flip=flip)[:3, :3],
                               f @ r @ f if flip else f.T @ r, rtol=0, atol=1e-15)


def test_torch_xfm_use_python_is_ignored_as_in_reference():
    import jax.numpy as jnp

    from diffdope_tpu import geometry as jgeo
    from diffdope_tpu_torch import geometry as tgeo

    rng = np.random.default_rng(5)
    pts = rng.normal(size=(2, 7, 3)).astype(np.float32)
    mtx = rng.normal(size=(2, 4, 4)).astype(np.float32)
    p, m = torch.as_tensor(pts), torch.as_tensor(mtx)
    for fn, ref in ((tgeo.xfm_points, jgeo.xfm_points), (tgeo.xfm_vectors, jgeo.xfm_vectors)):
        got = fn(p, m, use_python=True)
        assert torch.equal(got, fn(p, m))
        want = np.asarray(ref(jnp.asarray(pts), jnp.asarray(mtx), use_python=True))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_torch_pixel_ndc_dtype_matches_reference(dtype):
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render import setup_tris as j_setup
    from diffdope_tpu_torch.render import setup_tris as t_setup

    res = (37, 53)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in j_setup.pixel_ndc(res, dtype=getattr(jnp, dtype))]
    got = t_setup.pixel_ndc(res, dtype=getattr(torch, dtype))
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype) and w.dtype == np.dtype(dtype)
        assert tuple(g.shape) == res
        np.testing.assert_array_equal(g.numpy(), w)


def test_torch_precompute_bins_cull_matches_reference():
    """``precompute_bins(cull_backfaces=True)``: the reference's triangles
    in every tile, at the port's 16x16 tile, fewer than without the cull."""
    from diffdope_tpu.render.pipeline import precompute_bins as j_precompute
    from diffdope_tpu_torch import convert
    from diffdope_tpu_torch.render.pipeline import precompute_bins

    sc = jax_scene()
    st = convert.state(sc, "cpu")
    t_count = len(sc["tri"])
    got = precompute_bins(st["proj"], st["mtx0"], st["pos"], st["tri"], RES, t_count,
                          cull_backfaces=True, device="cpu")
    loose = precompute_bins(st["proj"], st["mtx0"], st["pos"], st["tri"], RES, t_count,
                            device="cpu")
    idx, counts, _, _ = (np.asarray(a) for a in j_precompute(
        sc["proj"], sc["mtx0"], sc["pos"], sc["tri"], RES, tile_hw=PORT_TILE_HW,
        max_tris_per_tile=t_count, margin_px=24.0, cull_backfaces=True))
    # the reference's tile grid runs on past the frame to whole 128-lane
    # rows (its padding tiles); the port's stops at the frame's last tile
    rows, cols = -(-RES[0] // PORT_TILE_HW[0]), -(-RES[1] // PORT_TILE_HW[1])
    keep = np.arange(len(counts)).reshape(rows, -1)[:, :cols].reshape(-1)
    np.testing.assert_array_equal(got.counts.numpy(), counts[keep])
    g_idx = got.idx.numpy()
    for t, r in enumerate(keep):
        assert set(g_idx[t, :counts[r]].tolist()) == set(idx[r, :counts[r]].tolist()), t
    assert 0 < int(got.counts.sum()) < int(loose.counts.sum())
    assert got.inv_pos.shape[0] == t_count


DD_OVERRIDES = ["hyperparameters.batchsize=4", "hyperparameters.nb_iterations=3",
                "hyperparameters.learning_rates_bound=[0.5, 2.0]", "tpu.seed=1",
                "tpu.raster_impl=pallas", "tpu.compact_total=2048", "tpu.progress=false",
                "losses.l1_rgb_with_mask=true"]


def _dd(cfg, mesh, device="cpu"):
    """A port DiffDope on the CPU from ``cfg`` (icosphere(2) through
    ``Mesh.scaled``, 48x64, B=4, the gt the port's render at a pose near
    the init)."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.optimize import pose_matrix, pose_params
    from diffdope_tpu_torch.render.pipeline import render_batch

    h, w = 48, 64
    camera = tdd.Camera(fx=60.0, fy=60.0, cx=w / 2, cy=h / 2, im_width=w, im_height=h)
    mtx_gt = pose_matrix(pose_params(np.array([0, 0, 0, 1.0], np.float32),
                                     np.array([0.05, 0.0, -3.0], np.float32), 1, device))[0]
    gtr = render_batch(camera.cam_proj, mtx_gt, mesh.pos, mesh.pos_idx, (h, w),
                       vtx_color=mesh.vtx_color, edge_adj=mesh.edge_adj,
                       raster_impl="pallas", max_tris_per_tile=512, device=device)
    scene = tdd.Scene(tensor_rgb=tdd.Image(img_tensor=gtr["rgb"][0].numpy()),
                      tensor_segmentation=tdd.Image(img_tensor=gtr["mask"][0].numpy()))
    obj = tdd.Object3D(position=[0.013, -0.021, 3.0], rotation=[0.01, -0.02, 0.015, 1.0],
                       batchsize=4, mesh=mesh)
    return tdd.DiffDope(cfg=cfg, camera=camera, object3d=obj, scene=scene, device=device)


def test_torch_diffdope_from_copied_config_and_scaled_mesh():
    """The slice on the port: a DiffDope from ``load_config().copy()`` with
    ``tpu.roi_crop`` deleted (its default, 'auto', applies) refines a
    ``Mesh.scaled`` mesh after every ``cuda()`` on the CPU, bit for bit as
    from the whole config; the source config is untouched, ``forward()``
    returns the scaled arrays, and the loss falls."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.mesh import build_edge_adjacency
    from diffdope_tpu_torch.testing import icosphere

    verts, faces = icosphere(2)
    unit = tdd.Mesh(pos=verts.astype(np.float32), pos_idx=faces, vtx_normals=verts,
                    num_vertices=len(verts), num_triangles=len(faces),
                    vtx_color=(verts * 0.5 + 0.5).astype(np.float32),
                    edge_adj=build_edge_adjacency(faces))
    mesh = unit.scaled(0.4)
    src = tdd.load_config(CONFIG, DD_OVERRIDES)
    text = src.yaml()
    cfg = src.copy()
    del cfg.tpu.roi_crop
    dd = _dd(cfg, mesh)
    for part in (dd, dd.camera, dd.object3d):
        part.cuda()
    dd.run_optimization()
    assert src.yaml() == text and "roi_crop" in src.tpu and "roi_crop" not in cfg.tpu
    assert dd.device == torch.device("cpu")
    out = dd.object3d.forward()
    np.testing.assert_array_equal(out["pos"], unit.pos * np.float32(0.4))
    whole = _dd(src, mesh)
    whole.run_optimization()
    np.testing.assert_array_equal(dd.mtx_history, whole.mtx_history)
    total = dd._result.total_loss.numpy()
    assert np.isfinite(total).all() and total[-1] < total[0]
