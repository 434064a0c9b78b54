"""The port's ``viz`` and ``DiffDope``'s pictures against the JAX
package's.

Every ``viz`` function fed the same seeded arrays gives the same bytes in
both packages: ``find_crop`` (and its ValueError on an empty image),
``depth_to_rgb``, ``im_resize``, ``make_grid`` (``normalize``,
``value_range``, ``scale_each``), ``make_grid_image`` (rgb and depth),
``make_grid_overlay_batch`` and ``plot_losses_image`` (one process:
matplotlib's Agg PNG); ``write_animation``'s mp4 reads back with its
frame count and size.

``DiffDope``'s methods on a small scene (icosphere(1) on the brute-force
raster, B=2, 3 steps; the port's session built from the reference's,
``convert.diffdope_state``): the port's renders of the reference's poses
(over the reference's triangle setup values, which XLA rounds with FMAs)
against the reference's renders at the contract (mask and rgb rtol 1e-5,
atol 1e-4; depth rtol 1e-5, atol 1e-6), and ``_compose_overlay`` fed the
reference's renders equal, byte for byte, to the reference's
``render_img`` for each selection (the port's renders differ from the
reference's by rounding, so its own composites are not compared byte
for byte); ``plot_losses`` and ``make_animation`` in both.  Then the
``simple_scene`` and ``appearance_refinement`` examples' ``main(argv)``
at a tiny size (an icosphere(2) on a 192x108 frame), in ``tmp_path``.
"""

import copy

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from diffdope_tpu_torch import convert, viz  # noqa: E402

RES = (48, 64)
B = 2
STEPS = 3
RENDER_IMAGES = {"nrow": 2, "final_width_batch": 256, "crop_around_mask": True,
                 "alpha_overlay": 0.7, "add_background": True, "add_countour": True,
                 "color_countour": [0.46, 0.73, 0], "flip_result": True}
CFG = {
    "losses": {"l1_mask": True, "weight_mask": 1.0},
    "hyperparameters": {"batchsize": B, "nb_iterations": STEPS - 1, "base_lr": 0.3,
                        "lr_decay": 0.1, "learning_rates_bound": [0.5, 2.0]},
    "render_images": RENDER_IMAGES,
    "tpu": {"seed": 1, "optimizer": "adam", "raster_impl": "reference", "progress": False},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch and one cv2 thread for this module: the tier-1 command runs
    six test workers on the CPU, and the plain twins' many small parallel
    regions ran up to 100x slower when every worker's threads
    oversubscribed it."""
    threads, cv2_threads = torch.get_num_threads(), cv2.getNumThreads()
    torch.set_num_threads(1)
    cv2.setNumThreads(1)
    yield
    torch.set_num_threads(threads)
    cv2.setNumThreads(cv2_threads)


def _images(seed, shape, low=0.0, high=1.0):
    return np.random.default_rng(seed).uniform(low, high, shape).astype(np.float32)


def _blob(h, w, cy, cx, r, batch=None):
    y, x = np.mgrid[0:h, 0:w]
    m = (((y - cy) ** 2 + (x - cx) ** 2) < r * r).astype(np.float32)
    return m if batch is None else np.stack([np.roll(m, 3 * i, axis=1) for i in range(batch)])


def test_torch_viz_find_crop_and_depth():
    import diffdope_tpu.viz as ref

    for seed, (h, w, cy, cx, r) in enumerate([(48, 64, 20, 30, 9), (40, 40, 2, 3, 5),
                                              (33, 71, 30, 68, 12)]):
        m = _blob(h, w, cy, cx, r)
        for img in (m, np.repeat(m[..., None], 3, -1) * _images(seed, (h, w, 3))):
            for pct in (0.1, 0.0, 0.3):
                assert viz.find_crop(img, pct) == ref.find_crop(img, pct)
    for mod in (viz, ref):
        with pytest.raises(ValueError, match="no nonzero pixels"):
            mod.find_crop(np.zeros((8, 8, 3)))
    depth = _images(1, (3, 20, 24), -0.5, 4.0)
    for d in depth:
        got, want = viz.depth_to_rgb(d), ref.depth_to_rgb(d)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        got, want = viz.depth_to_rgb(d, 5.0), ref.depth_to_rgb(d, 5.0)
        assert got.tobytes() == want.tobytes()


def test_torch_viz_resize_and_grids():
    import diffdope_tpu.viz as ref

    img8 = (_images(2, (30, 50, 3)) * 255).astype(np.uint8)
    for kw in (dict(width=80), dict(height=17), dict()):
        assert viz.im_resize(img8, **kw).tobytes() == ref.im_resize(img8, **kw).tobytes()
    batch = _images(3, (5, 12, 10, 3), -0.5, 1.5)
    for kw in (dict(), dict(nrow=2, padding=1, pad_value=0.5), dict(nrow=3, normalize=True),
               dict(normalize=True, value_range=(0.0, 1.0)),
               dict(normalize=True, scale_each=True),
               dict(normalize=True, scale_each=True, value_range=(-0.2, 0.9))):
        got, want = viz.make_grid(batch, **kw), ref.make_grid(batch, **kw)
        assert got.shape == want.shape and got.dtype == want.dtype, kw
        assert got.tobytes() == want.tobytes(), kw
    single = viz.make_grid(batch[0])
    assert single.tobytes() == ref.make_grid(batch[0]).tobytes()
    for mod in (viz, ref):
        with pytest.raises(ValueError, match="value_range"):
            mod.make_grid(batch, normalize=True, value_range=(0.0, 0.5, 1.0))
    rgb = _images(4, (4, 16, 20, 3))
    for row, width in ((2, 90), (4, 200), (3, 64)):
        got = viz.make_grid_image(rgb, row, width)
        assert got.tobytes() == ref.make_grid_image(rgb, row, width).tobytes()
    depth = _images(5, (4, 16, 20), -0.2, 3.5)
    got = viz.make_grid_image(depth, 2, 120, depth=True)
    assert got.tobytes() == ref.make_grid_image(depth, 2, 120, depth=True).tobytes()


@pytest.mark.parametrize("kw", [dict(), dict(add_background=False, flip_result=False),
                                dict(add_contour=False, alpha=0.3, row=1, final_width=77),
                                dict(color_contour=(1.0, 0.2, 0.0), row=3)])
def test_torch_viz_overlay_matches_reference(kw):
    import diffdope_tpu.viz as ref

    fg = _blob(24, 32, 12, 14, 7, batch=3)[..., None] * _images(6, (3, 24, 32, 3))
    bg = _images(7, (3, 24, 32, 3))
    args = dict(foreground=fg, background=bg, final_width=kw.pop("final_width", 150), **kw)
    got, want = viz.make_grid_overlay_batch(**args), ref.make_grid_overlay_batch(**args)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    no_bg = dict(args, background=None)
    assert (viz.make_grid_overlay_batch(**no_bg).tobytes()
            == ref.make_grid_overlay_batch(**no_bg).tobytes())


def test_torch_viz_plot_and_animation(tmp_path):
    pytest.importorskip("matplotlib")
    import diffdope_tpu.viz as ref

    rng = np.random.default_rng(8)
    losses = {"mask_selection": rng.uniform(0, 1, (6, 3)).astype(np.float32),
              "rgb": rng.uniform(0, 1, (6, 3)).astype(np.float32)}
    got = viz.plot_losses_image(losses, 1)
    assert got is not None and got.ndim == 3 and got.dtype == np.uint8
    assert got.tobytes() == viz.plot_losses_image(losses, 1).tobytes()
    assert got.tobytes() == ref.plot_losses_image(losses, 1).tobytes()
    assert viz.plot_losses_image({}, 0) is None

    frames = [(_images(9 + i, (40, 48, 3)) * 255).astype(np.uint8) for i in range(7)]
    out = tmp_path / "frames.mp4"
    viz.write_animation(iter(frames), str(out), frame_rate=5)
    assert _frames(out) == (7, 40, 48)


def _frames(path):
    """(frame count, height, width) of an mp4, read back with cv2."""
    cap = cv2.VideoCapture(str(path))
    n, shape = 0, None
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        n, shape = n + 1, frame.shape[:2]
    cap.release()
    return (n,) + tuple(shape or (0, 0))


def _reference_session():
    import diffdope_tpu as dd
    import jax
    import jax.numpy as jnp
    from diffdope_tpu.mesh import Mesh, build_edge_adjacency
    from diffdope_tpu.optimize import pose_matrix, pose_params
    from diffdope_tpu.render.pipeline import render_batch
    from diffdope_tpu.testing import icosphere

    h, w = RES
    camera = dd.Camera(fx=60.0, fy=60.0, cx=w / 2, cy=h / 2, im_width=w, im_height=h)
    verts, faces = icosphere(1)
    mesh = Mesh(pos=verts * 0.4, pos_idx=faces, vtx_normals=verts, num_vertices=len(verts),
                num_triangles=len(faces), vtx_color=(verts * 0.5 + 0.5).astype(np.float32),
                edge_adj=build_edge_adjacency(faces))
    mtx_gt, _, _ = pose_matrix(pose_params(np.array([0, 0, 0, 1.0], np.float32),
                                           np.array([0.05, 0.0, -3.0], np.float32), 1))
    gtr = jax.jit(lambda m: render_batch(
        jnp.asarray(camera.cam_proj), m, jnp.asarray(mesh.pos), jnp.asarray(mesh.pos_idx),
        RES, vtx_color=jnp.asarray(mesh.vtx_color), raster_impl="reference"))(mtx_gt)
    scene = dd.Scene(tensor_rgb=dd.Image(img_tensor=np.asarray(gtr["rgb"][0])),
                     tensor_depth=dd.Image(img_tensor=np.asarray(gtr["depth"][0]), depth=True),
                     tensor_segmentation=dd.Image(img_tensor=np.asarray(gtr["mask"][0])))
    obj = dd.Object3D(position=[0.013, -0.021, 3.0], rotation=[0.01, -0.02, 0.015, 1.0],
                      batchsize=B, mesh=mesh)
    d = dd.DiffDope(cfg=dd.ConfigNode(copy.deepcopy(CFG)), camera=camera, object3d=obj,
                    scene=scene)
    d.run_optimization()
    return d


def _port_session(state):
    import diffdope_tpu_torch as tdd

    n, t = len(state["pos"]), len(state["pos_idx"])
    mesh = tdd.Mesh(pos=state["pos"], pos_idx=state["pos_idx"], vtx_normals=state["pos"],
                    num_vertices=n, num_triangles=t, edge_adj=state["edge_adj"],
                    vtx_color=state["vtx_color"])
    h, w = RES
    obj = tdd.Object3D(position=[0.013, -0.021, 3.0], rotation=[0.01, -0.02, 0.015, 1.0],
                       batchsize=B, mesh=mesh)
    gt = state["gt"]
    scene = tdd.Scene(tensor_rgb=tdd.Image(img_tensor=gt["rgb"]),
                      tensor_depth=tdd.Image(img_tensor=gt["depth"], depth=True),
                      tensor_segmentation=tdd.Image(img_tensor=gt["segmentation"]))
    d = tdd.DiffDope(cfg=tdd.ConfigNode(copy.deepcopy(CFG)),
                     camera=tdd.Camera(fx=60.0, fy=60.0, cx=w / 2, cy=h / 2, im_width=w,
                                       im_height=h),
                     object3d=obj, scene=scene, device="cpu")
    d.learning_rates = torch.tensor(state["learning_rates"])
    d.run_optimization()
    return d


@pytest.fixture(scope="module")
def sessions():
    ref = _reference_session()
    return ref, _port_session(convert.diffdope_state(ref))


def _jax_coef(ref, mtx):
    """The reference's triangle setup values at poses ``mtx``: fed to the
    port's brute force (as tests/test_torch_render_reference.py does),
    since XLA contracts the jitted setup into FMAs, which flips the z
    winner of a pixel here."""
    import jax
    import jax.numpy as jnp
    from diffdope_tpu.geometry import xfm_points
    from diffdope_tpu.render.setup_tris import triangle_setup_from_corners

    mesh = ref.object3d.mesh
    tri = np.asarray(mesh.pos_idx)
    pos_c = jnp.asarray(mesh.pos)[tri.reshape(-1)][None]

    def coef(m):
        mvp = jnp.einsum("...ij,...jk->...ik", jnp.asarray(ref.camera.cam_proj)[None], m,
                         precision="highest")
        corners = xfm_points(pos_c, mvp).reshape(m.shape[0], len(tri), 3, 4)
        return triangle_setup_from_corners(corners).coef

    return torch.tensor(np.asarray(jax.jit(coef)(jnp.asarray(mtx))))


def test_torch_diffdope_render_img_matches_reference(sessions, monkeypatch):
    from diffdope_tpu_torch.render import pipeline

    ref, port = sessions
    assert port.mtx_history.shape == ref.mtx_history.shape == (STEPS, B, 4, 4)
    own = pipeline.triangle_setup_from_corners
    for index in (-1, 0):
        want = ref.optimization_results[index]
        coef_ref = _jax_coef(ref, want["mtx"])
        monkeypatch.setattr(pipeline, "triangle_setup_from_corners",
                            lambda c, d=None: own(c, d)._replace(coef=coef_ref))
        port._render_fn = None
        with torch.no_grad():
            got = port._render(torch.as_tensor(np.array(want["mtx"])))
        monkeypatch.setattr(pipeline, "triangle_setup_from_corners", own)
        port._render_fn = None
        for key, atol in (("rgb", 1e-4), ("mask", 1e-4), ("depth", 1e-6)):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                       atol=atol, err_msg=key)
        for sel in ("rgb", "depth", "mask"):
            for batch_index in (None, 1):
                composite = port._compose_overlay(np.asarray(want[sel]), batch_index, sel)
                expect = ref.render_img(index=index, batch_index=batch_index,
                                        render_selection=sel)
                assert composite.dtype == np.uint8 and composite.shape == expect.shape
                assert composite.tobytes() == expect.tobytes(), (index, sel, batch_index)
    img = port.render_img()
    assert img.dtype == np.uint8 and img.shape == ref.render_img().shape
    assert port.render_img(index=0, batch_index=0).ndim == 3


def test_torch_diffdope_plot_and_animation(sessions, tmp_path):
    pytest.importorskip("matplotlib")
    ref, port = sessions
    plot = port.plot_losses()
    assert plot is not None and plot.ndim == 3 and plot.dtype == np.uint8
    want = viz.plot_losses_image(ref.losses_values, ref.get_argmin())
    assert ref.plot_losses().tobytes() == want.tobytes()
    for d, name in ((port, "port.mp4"), (ref, "ref.mp4")):
        d.make_animation(str(tmp_path / name), frame_rate=5, chunk=2, final_width=128)
    got, want = _frames(tmp_path / "port.mp4"), _frames(tmp_path / "ref.mp4")
    assert got == want and got[0] == STEPS and got[2] == 128


def _write_files(root, mesh_path, camera, cfg_object3d):
    """The scene at the configured pose, rendered by the port and written as
    the loaders read it (flipped rows; depth in metres x 100, 16-bit)."""
    from diffdope_tpu_torch.camera import Camera
    from diffdope_tpu_torch.mesh import load_mesh
    from diffdope_tpu_torch.object3d import Object3D
    from diffdope_tpu_torch.optimize import pose_matrix
    from diffdope_tpu_torch.render.pipeline import compact_capacity, render_batch

    cam = Camera(**camera)
    mesh = load_mesh(mesh_path, scale=cfg_object3d["scale"])
    obj = Object3D(position=cfg_object3d["position"], rotation=cfg_object3d["rotation"],
                   scale=cfg_object3d["scale"], mesh=mesh, batchsize=1)
    mtx = pose_matrix(obj.initial_params(1, "cpu"))[0]
    h, w = camera["im_height"], camera["im_width"]
    # every triangle a tile touches binned: none dropped
    t_all = len(mesh.pos_idx)
    cap = compact_capacity(cam.cam_proj, mesh.pos, mesh.pos_idx, mtx, (h, w), t_all,
                           device="cpu")
    with torch.no_grad():
        gt = render_batch(cam.cam_proj, mtx, mesh.pos, mesh.pos_idx, (h, w),
                          edge_adj=mesh.edge_adj, vtx_color=mesh.vtx_color,
                          corner_colors=mesh.corner_colors, max_tris_per_tile=t_all,
                          compact_total=cap, device="cpu")
    assert int(gt["_bin_overflow"]) == 0
    rgb = np.round(gt["rgb"][0].numpy()[::-1] * 255).astype(np.uint8)
    paths = {k: root / f"{k}.png" for k in ("rgb", "depth", "seg")}
    cv2.imwrite(str(paths["rgb"]), rgb[..., ::-1])
    cv2.imwrite(str(paths["depth"]),
                np.round(gt["depth"][0].numpy()[::-1] * 100.0).astype(np.uint16))
    cv2.imwrite(str(paths["seg"]),
                np.round(gt["mask"][0, ..., 0].numpy()[::-1] * 255).astype(np.uint8))
    return paths


def _overrides(root, paths, mesh_path, camera, position):
    out = [f"camera.{k}={v}" for k, v in camera.items()]
    out += [f"scene.path_img={paths['rgb']}", f"scene.path_depth={paths['depth']}",
            f"scene.path_segmentation={paths['seg']}", "scene.image_resize=1.0",
            f"object3d.model_path={mesh_path}",
            f"object3d.position=[{position[0]},{position[1]},{position[2]}]",
            "hyperparameters.nb_iterations=2", "hyperparameters.batchsize=2",
            "hyperparameters.learning_rates_bound=[0.5,2.0]",
            "render_images.final_width_batch=160", "tpu.progress=false", "--device", "cpu"]
    return out


#: the default camera cut to a tenth (192x108)
SMALL_CAMERA = {"fx": 139.053, "fy": 138.699, "cx": 96.4957, "cy": 52.2586,
                "im_width": 192, "im_height": 108}


def _sphere_ply(root, textured=False):
    """An icosphere(2) of radius 60 mm (320 triangles: the examples run on
    the CPU's plain twins), with vertex colours, or planar uv and a 64x64
    checker texture beside it (``tools/make_standins.py``'s writers)."""
    from diffdope_tpu_torch.mesh import save_ply
    from diffdope_tpu_torch.testing import icosphere
    from tools.make_standins import make_texture, write_ply_textured

    v, f = icosphere(2)
    path = root / "sphere.ply"
    if not textured:
        save_ply(path, v * 60.0, f, colors=v * 0.5 + 0.5)
        return path
    uv = (v[:, :2] - v[:, :2].min(0)) / (v[:, :2].max(0) - v[:, :2].min(0))
    write_ply_textured(path, v * 60.0, f, uv, "checker.png")
    cv2.imwrite(str(root / "checker.png"),
                np.round(make_texture("checker", size=64) * 255).astype(np.uint8)[..., ::-1])
    return path


def test_torch_simple_scene_example(tmp_path, monkeypatch, capsys):
    pytest.importorskip("matplotlib")
    from diffdope_tpu_torch.config import load_config
    from diffdope_tpu_torch.examples import simple_scene

    mesh_path = _sphere_ply(tmp_path)
    o3 = dict(load_config().object3d)
    paths = _write_files(tmp_path, mesh_path, SMALL_CAMERA, o3)
    monkeypatch.chdir(tmp_path)
    position = np.asarray(o3["position"]) + [4.0, -3.0, 0.0]
    dd = simple_scene.main(_overrides(tmp_path, paths, mesh_path, SMALL_CAMERA, position))
    out = capsys.readouterr().out
    for line in ("argmin:", "saved loss plot to plot.png", "saved final overlay to overlay.png",
                 "saved animation to simple_scene.mp4"):
        assert line in out, line
    assert dd.mtx_history.shape == (3, 2, 4, 4)
    assert cv2.imread("plot.png").ndim == 3
    assert cv2.imread("overlay.png").shape[1] == 160
    assert _frames(tmp_path / "simple_scene.mp4")[:1] == (3,)


def test_torch_appearance_refinement_example(tmp_path, monkeypatch, capsys):
    from diffdope_tpu_torch.config import load_config
    from diffdope_tpu_torch.examples import appearance_refinement

    from diffdope_tpu_torch.mesh import load_mesh

    mesh_path = _sphere_ply(tmp_path, textured=True)
    assert load_mesh(mesh_path, scale=0.01).has_textured_map
    o3 = dict(load_config().object3d)
    paths = _write_files(tmp_path, mesh_path, SMALL_CAMERA, o3)
    monkeypatch.chdir(tmp_path)
    dd = appearance_refinement.main(
        _overrides(tmp_path, paths, mesh_path, SMALL_CAMERA, o3["position"]))
    out = capsys.readouterr().out
    assert "rgb loss (best hypothesis)" in out and "saved appearance_overlay.png" in out
    assert not np.allclose(np.asarray(dd.object3d.mesh.corner_colors), 0.5)
    assert cv2.imread("appearance_overlay.png").ndim == 3
