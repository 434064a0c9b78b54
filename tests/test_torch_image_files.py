"""The port's ``Image`` / ``Scene`` read from files against the reference's
(``diffdope_tpu/image.py:55-80``, cv2) on the same cv2-written PNGs: an
8-bit rgb, a 16-bit depth and an 8-bit segmentation, at ``image_resize``
1.0 and 0.5, on a frame whose halving is exact (cv2's INTER_AREA path)
and on an odd one (its bilinear path).  The gt arrays must be equal: the
resizes agree with cv2's within 1e-12 in float64 and exactly after the
cast to float32 (``tests/test_torch_png.py``), nearest for depth
exactly.  Then ``DiffDope(cfg)`` is built from paths (scene PNGs and a
PLY) in both packages, and the step-0 logs must agree at rtol 1e-5.
"""

import copy

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from diffdope_tpu_torch.bench import drows_env  # noqa: E402
from torch_scene import one_torch_thread  # noqa: F401

DEPTH_SCALE = 100.0


def _write_scene(tmp_path, h, w, seed=0, rgb=None, seg=None, depth=None):
    """rgb.png (8-bit BGR), depth.png (16-bit grey, metres x DEPTH_SCALE)
    and seg.png (8-bit grey) with cv2, from the given float arrays or from
    seeded smooth noise; returns the paths."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    if rgb is None:
        rgb = np.stack([np.sin(x / 7.0 + c) * np.cos(y / 5.0) * 0.4 + 0.5
                        for c in range(3)], -1) + rng.uniform(0, 0.05, (h, w, 3))
    if seg is None:
        seg = ((x - w / 2) ** 2 + (y - h / 2) ** 2 < (min(h, w) / 3) ** 2).astype(float)
    if depth is None:
        depth = 2.5 + np.sin(x / 11.0) * 0.3 + rng.uniform(0, 0.01, (h, w))
    paths = {k: tmp_path / f"{k}.png" for k in ("rgb", "depth", "seg")}
    q8 = np.clip(np.round(np.asarray(rgb) * 255), 0, 255).astype(np.uint8)
    cv2.imwrite(str(paths["rgb"]), q8[..., ::-1])
    cv2.imwrite(str(paths["depth"]),
                np.clip(np.round(np.asarray(depth) * DEPTH_SCALE), 0, 65535).astype(np.uint16))
    cv2.imwrite(str(paths["seg"]), np.clip(np.round(np.asarray(seg) * 255), 0, 255)
                .astype(np.uint8))
    return paths


@pytest.mark.parametrize("resize", [1.0, 0.5])
@pytest.mark.parametrize("size", [(96, 128), (97, 131)])
def test_torch_scene_from_files_matches_reference(tmp_path, size, resize):
    import diffdope_tpu.image as ref

    import diffdope_tpu_torch.image as port

    paths = _write_scene(tmp_path, *size)
    args = dict(path_img=str(paths["rgb"]), path_depth=str(paths["depth"]),
                path_segmentation=str(paths["seg"]), image_resize=resize)
    got, want = port.Scene(**args).gt_arrays(), ref.Scene(**args).gt_arrays()
    assert set(got) == set(want) == {"rgb", "depth", "segmentation"}
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    h, w = (int(size[0] * resize), int(size[1] * resize))
    assert port.Scene(**args).get_resolution() == [h, w]


def test_torch_image_from_file_flags(tmp_path):
    """``flip_img`` false and a depth scale of its own, both packages."""
    import diffdope_tpu.image as ref

    import diffdope_tpu_torch.image as port

    paths = _write_scene(tmp_path, 41, 57, seed=1)
    for kw in (dict(img_path=str(paths["rgb"]), flip_img=False, img_resize=0.75),
               dict(img_path=str(paths["depth"]), depth=True, depth_scale=1000.0,
                    flip_img=False, img_resize=0.3),
               dict(img_path=str(paths["seg"]), img_resize=0.3)):
        got, want = port.Image(**kw), ref.Image(**kw)
        np.testing.assert_array_equal(got.img_tensor, want.img_tensor, err_msg=str(kw))
        assert repr(got) == repr(want)


def test_torch_image_missing_file_raises(tmp_path):
    import diffdope_tpu_torch.image as port

    with pytest.raises(FileNotFoundError):
        port.Image(img_path=str(tmp_path / "absent.png"))
    with pytest.raises(FileNotFoundError):
        port.Scene(path_img=str(tmp_path / "absent.png"))


#: the DiffDope test's scene (tests/test_torch_diffdope.py), its files at
#: twice the resolution, read at image_resize 0.5
RES = (48, 64)
B = 3
INIT_POSITION = [0.013, -0.021, 3.0]
INIT_ROTATION = [0.01, -0.02, 0.015, 1.0]
CFG = {
    "camera": {"fx": 120.0, "fy": 120.0, "cx": 64.0, "cy": 48.0, "im_width": 128,
               "im_height": 96},
    "scene": {"image_resize": 0.5},
    "object3d": {"position": INIT_POSITION, "rotation": INIT_ROTATION, "scale": 1.0},
    "losses": {"l1_mask": True, "weight_mask": 1.0, "l1_rgb_with_mask": True,
               "weight_rgb": 0.7, "l1_depth_with_mask": True, "weight_depth": 1.0},
    "hyperparameters": {"batchsize": B, "nb_iterations": 1, "base_lr": 20.0,
                        "lr_decay": 0.1, "learning_rates_bound": [0.5, 2.0]},
    "tpu": {"seed": 1, "raster_impl": "pallas", "tile_h": 8, "progress": False},
}


def test_torch_diffdope_from_files_matches_reference(tmp_path, monkeypatch):
    import diffdope_tpu as dd
    import jax
    import jax.numpy as jnp
    from diffdope_tpu.mesh import save_ply
    from diffdope_tpu.optimize import pose_matrix, pose_params
    from diffdope_tpu.render.pipeline import render_batch
    from diffdope_tpu.testing import icosphere

    import diffdope_tpu_torch as tdd

    monkeypatch.setenv("DD_DROWS_BF16", "0")
    verts, faces = icosphere(2)
    ply = tmp_path / "sphere.ply"
    save_ply(ply, verts * 0.4, faces, colors=verts * 0.5 + 0.5)
    camera = dd.Camera(**CFG["camera"])
    mesh = dd.load_mesh(ply)
    mtx_gt, _, _ = pose_matrix(pose_params(
        np.array([0, 0, 0, 1.0], np.float32), np.array([0.05, 0.0, -3.0], np.float32), 1))
    gtr = jax.jit(lambda m: render_batch(
        jnp.asarray(camera.cam_proj), m, jnp.asarray(mesh.pos), jnp.asarray(mesh.pos_idx),
        (96, 128), vtx_color=jnp.asarray(mesh.vtx_color), edge_adj=jnp.asarray(mesh.edge_adj),
        raster_impl="pallas", max_tris_per_tile=512))(mtx_gt)
    # the render is flipped (the loaders flip the files back)
    paths = _write_scene(tmp_path, 96, 128, rgb=np.asarray(gtr["rgb"][0])[::-1],
                         seg=np.asarray(gtr["mask"][0, ..., 0])[::-1],
                         depth=np.asarray(gtr["depth"][0])[::-1])
    cfg = copy.deepcopy(CFG)
    cfg["scene"].update(path_img=str(paths["rgb"]), path_depth=str(paths["depth"]),
                        path_segmentation=str(paths["seg"]))
    cfg["object3d"]["model_path"] = str(ply)
    ref = dd.DiffDope(cfg=dd.ConfigNode(copy.deepcopy(cfg)))
    ref.run_optimization()
    port = tdd.DiffDope(cfg=tdd.ConfigNode(copy.deepcopy(cfg)), device="cpu")
    assert port.resolution == ref.resolution == list(RES)
    for key, value in ref.gt_tensors.items():
        np.testing.assert_array_equal(port.gt_tensors[key], value, err_msg=key)
    np.testing.assert_array_equal(port.object3d.mesh.pos, ref.object3d.mesh.pos)
    np.testing.assert_array_equal(port.object3d.mesh.vtx_color, ref.object3d.mesh.vtx_color)
    import torch

    port.learning_rates = torch.tensor(np.asarray(ref.learning_rates))
    with drows_env(False):
        port.run_optimization()
    assert set(port.losses_values) == set(ref.losses_values) == {
        "rgb", "depth", "mask_selection"}
    for key, value in ref.losses_values.items():
        assert value[0].min() > 0, key
        np.testing.assert_allclose(port.losses_values[key][0], value[0], rtol=1e-5,
                                   err_msg=key)
