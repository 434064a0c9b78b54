"""Appearance refinement on the port: ``refine(extra_params=)`` against the
JAX refine on the unfused render (a texture leaf sampled at each pixel,
and a vertex-colour leaf, whose table the plain pack builds), the port's
counterparts of the JAX tests' appearance write-backs
(tests/test_diffdope.py:276-330).

The refinements: 3 SGD steps (base lr 2, decay 0.1) from the torch_scene's
initial poses and loss scales, rgb + mask L1, the uniform-K table on both
sides; on the texture run the port reads the reference's packed table
(``torch_scene.feed_reference_pack``).  Pose history rtol 1e-4, atol
1e-5 (tests/test_torch_refine.py's trajectory tolerance); the
per-hypothesis loss curves and the final leaves (pose and appearance,
after the last step's update) rtol 5e-4, atol 1e-6: where each package
packs its own table, XLA's FMAs put the reference's ~1e-6 off the
port's, which flips the z winner of a silhouette pixel now and then.  The
appearance leaf's update (final minus start) rtol 1e-3, atol 1e-3 of its
largest element."""

import functools

import numpy as np
import pytest
import torch

from torch_scene import LRS, MAX_K, RES, WEIGHTS, feed_reference_pack, jax_scene, scene_texture

from diffdope_tpu_torch import convert
from diffdope_tpu_torch.optimize import refine
from torch_scene import one_torch_thread  # noqa: F401

STEPS = 3
LEAVES = ("tex", "vtx_color")
SGD = dict(nb_iterations=STEPS - 1, base_lr=2.0, lr_decay=0.1, optimizer="sgd")


def _leaf(name):
    """The leaf's start: the scene's texture (f32, so the reference samples
    it as the port does) or its vertex colours, shifted."""
    if name == "tex":
        return scene_texture(quantized=False)["tex"]
    return (jax_scene()["vtx_color"] * 0.8 + 0.1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(name):
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.losses import select_losses
    from diffdope_tpu.optimize import refine as j_refine
    from diffdope_tpu.render.pipeline import render_batch

    sc, tx = jax_scene(), scene_texture()
    loss_fns, weights = select_losses({"l1_mask": True, "weight_mask": WEIGHTS["mask"],
                                       "l1_rgb_with_mask": True,
                                       "weight_rgb": WEIGHTS["rgb"]})
    colors = (dict(uv=tx["uv"], uv_idx=tx["uv_idx"]) if name == "tex"
              else dict(vtx_color=sc["vtx_color"]))

    def render_fn(mtx, **leaf):
        return render_batch(sc["proj"], mtx, sc["pos"], sc["tri"], RES,
                            edge_adj=sc["edge_adj"], raster_impl="pallas",
                            layout="channels", max_tris_per_tile=MAX_K,
                            **{**colors, **leaf})

    res = jax.jit(functools.partial(
        j_refine, render_fn=render_fn, loss_fns=tuple(loss_fns), weights=weights, **SGD))(
        {k: jnp.asarray(v) for k, v in sc["params0"].items()}, gt=sc["gt"],
        learning_rates=jnp.asarray(LRS), extra_params={name: jnp.asarray(_leaf(name))})
    return jax.tree.map(np.asarray, res._replace(opt_state=None))


@pytest.mark.parametrize("name", LEAVES)
def test_torch_refine_extra_params_matches_reference(name, monkeypatch):
    from diffdope_tpu_torch import kernels
    from diffdope_tpu_torch.losses import select_losses
    from diffdope_tpu_torch.render.pipeline import render_batch

    ref = _reference(name)
    sc, tx = convert.state(jax_scene(), "cpu"), scene_texture()
    loss_fns, weights = select_losses({"l1_mask": True, "weight_mask": WEIGHTS["mask"],
                                       "l1_rgb_with_mask": True,
                                       "weight_rgb": WEIGHTS["rgb"]})
    colors = (dict(uv=tx["uv"], uv_idx=tx["uv_idx"]) if name == "tex"
              else dict(vtx_color=sc["vtx_color"]))

    def render_fn(mtx, **leaf):
        return render_batch(sc["proj"], mtx, sc["pos"], sc["tri"], RES,
                            edge_adj=sc["edge_adj"], layout="channels",
                            max_tris_per_tile=MAX_K, device="cpu", **{**colors, **leaf})

    if name == "tex":
        # the reference packs the static uv with its Pallas kernel: read its
        # values (the traced colours' XLA pack has no eager twin to read)
        feed_reference_pack(monkeypatch)
    kernels.reset_launches()
    res = refine(sc["params0"], render_fn, loss_fns, sc["gt"], torch.tensor(LRS), weights,
                 extra_params={name: torch.tensor(_leaf(name))}, **SGD)
    # the reference's eligibility rule: a traced colour takes the plain
    # pack, a texture leaf (static uv) the pack kernel's
    assert kernels.launches["pack_plain"] == (STEPS if name == "vtx_color" else 0)
    np.testing.assert_allclose(res.total_loss.numpy(), ref.total_loss, rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(res.mtx_history.numpy(), ref.mtx_history, rtol=1e-4,
                               atol=1e-5)
    for k, v in ref.losses_values.items():
        np.testing.assert_allclose(res.losses_values[k].numpy(), v, rtol=5e-4, atol=1e-6,
                                   err_msg=k)
    assert sorted(res.params) == sorted(ref.params)
    for k, v in ref.params.items():
        np.testing.assert_allclose(res.params[k].numpy(), v, rtol=5e-4, atol=1e-6,
                                   err_msg=k)
    # the leaf's own update: it moves ~1e-4, under the value's tolerance
    # above, so a port that never updated it would pass there; the updates
    # agree to 1e-3 of the largest (f32 rounding of start + update: ~6e-8)
    start = _leaf(name)
    want = ref.params[name] - start
    moved = np.abs(want).max()
    assert moved > 1e-5, "the leaf did not move"
    np.testing.assert_allclose(res.params[name].numpy() - start, want, rtol=1e-3,
                               atol=1e-3 * moved, err_msg=f"{name} update")


def test_torch_refine_extra_params_segmented_and_refused():
    """Segments carry the leaves: two segments give the one run's leaves;
    the fused loss refuses extra leaves, as the reference does."""
    from diffdope_tpu_torch.losses import select_losses
    from diffdope_tpu_torch.optimize import refine_segmented
    from diffdope_tpu_torch.render.pipeline import render_batch

    sc = convert.state(jax_scene(), "cpu")
    loss_fns, weights = select_losses({"l1_rgb_with_mask": True, "weight_rgb": 1.0})

    def render_fn(mtx, vtx_color):
        return render_batch(sc["proj"], mtx, sc["pos"], sc["tri"], RES,
                            edge_adj=sc["edge_adj"], layout="channels",
                            vtx_color=vtx_color, raster_impl="reference", device="cpu")

    args = (sc["params0"], render_fn, loss_fns, sc["gt"], torch.tensor(LRS), weights)
    extra = {"vtx_color": torch.tensor(_leaf("vtx_color"))}
    one = refine(*args, extra_params=extra, **SGD)
    two = refine_segmented(*args, extra_params=extra, segment_steps=2, **SGD)
    assert len(two.segment_times) == 2
    for k, v in one.params.items():
        assert torch.equal(two.params[k], v), k
    with pytest.raises(ValueError, match="extra_params"):
        refine(sc["params0"], fused_loss_fn=lambda m: None, extra_params=extra)


def _port_ddope(mesh, batchsize=2, nb_iterations=3, **tpu):
    """The JAX test's DiffDope (tests/test_diffdope.py:14-76) on the port,
    on the CPU: a 48x64 frame, the scene the port's brute-force render of
    ``mesh`` 0.05 off the init, the brute-force rasterizer, Adam."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.optimize import pose_matrix, pose_params
    from diffdope_tpu_torch.render.pipeline import render_batch

    h, w = 48, 64
    camera = tdd.Camera(fx=60.0, fy=60.0, cx=w / 2, cy=h / 2, im_width=w, im_height=h)
    mtx_gt, _, _ = pose_matrix(pose_params([0, 0, 0, 1.0], [0.05, 0.0, -3.0], 1, "cpu"))
    gtr = render_batch(camera.cam_proj, mtx_gt, mesh.pos, mesh.pos_idx, (h, w),
                       vtx_color=mesh.vtx_color, corner_colors=mesh.corner_colors,
                       raster_impl="reference", device="cpu")
    scene = tdd.Scene(tensor_rgb=tdd.Image(img_tensor=gtr["rgb"][0].numpy()),
                      tensor_depth=tdd.Image(img_tensor=gtr["depth"][0].numpy(), depth=True),
                      tensor_segmentation=tdd.Image(img_tensor=gtr["mask"][0].numpy()))
    obj = tdd.Object3D(position=[0.0, 0.0, 3.0], rotation=[0.0, 0.0, 0.0, 1.0],
                       batchsize=batchsize, mesh=mesh)
    cfg = tdd.ConfigNode({
        "losses": {"l1_mask": True, "weight_mask": 1.0, "l1_rgb_with_mask": True,
                   "weight_rgb": 1.0},
        "hyperparameters": {"batchsize": batchsize, "nb_iterations": nb_iterations,
                            "base_lr": 0.3, "lr_decay": 0.1,
                            "learning_rates_bound": [0.5, 2.0]},
        "tpu": {"seed": 1, "optimizer": "adam", "raster_impl": "reference",
                "progress": False, **tpu},
    })
    return tdd.DiffDope(cfg=cfg, camera=camera, object3d=obj, scene=scene, device="cpu")


def _sphere():
    import diffdope_tpu_torch as tdd

    verts, faces = tdd.icosphere(1)
    return verts, faces, tdd.Mesh(pos=verts * 0.4, pos_idx=faces, vtx_normals=verts,
                                  num_vertices=len(verts), num_triangles=len(faces),
                                  vtx_color=(verts * 0.5 + 0.5).astype(np.float32),
                                  edge_adj=tdd.build_edge_adjacency(faces))


def test_torch_appearance_writeback():
    """enable_gradients_texture on a vertex-coloured mesh: the colours are
    refined with the pose and written back; later renders use them."""
    _, _, mesh = _sphere()
    d = _port_ddope(mesh)
    before = mesh.vtx_color.copy()
    mesh.vtx_color = np.full_like(before, 0.35)
    mesh.enable_gradients_texture()
    d.run_optimization()
    after = np.asarray(mesh.vtx_color)
    assert after.shape == before.shape
    assert np.abs(after - 0.35).max() > 1e-5, "colours did not move"
    entry = d.optimization_results[-1]
    assert entry["rgb"].shape[0] == 2


def test_torch_texture_appearance_writeback():
    """enable_gradients_texture on a textured mesh under texture_mode exact:
    the texture map is the refined leaf and is written back; under baked
    the corner colours are."""
    from diffdope_tpu_torch.testing import spherical_uv, textured_mesh

    verts, faces, _ = _sphere()
    uv = spherical_uv(verts)
    uv[:, 1] = 1.0 - uv[:, 1]  # the file convention, which the builder flips back
    tex = np.full((16, 16, 3), 0.4, np.float32)
    mesh = textured_mesh(verts * 0.4, faces, uv, tex)
    d = _port_ddope(mesh, texture_mode="exact")
    mesh.enable_gradients_texture()
    d.run_optimization()
    assert mesh.tex.shape == tex.shape
    assert np.abs(mesh.tex - 0.4).max() > 1e-5, "texture did not move"
    baked = mesh.corner_colors.copy()
    d.cfg.tpu.texture_mode = "baked"
    d.run_optimization()
    assert np.abs(mesh.corner_colors - baked).max() > 1e-5, "corner colours did not move"
