"""Port parity for the exact-texture fused loss: the colour lane of K5/K6
(``fused_loss.loss_sums`` / ``loss_bwd`` with colour planes, plain
versions) against the JAX fused loss with ``colors`` (interpret mode),
and the semi-fused texture route of ``make_fused_loss(tex=)`` (table,
raster, uv shade and sampler on the gt crop, the colour lane) against the
JAX one, on the torch_scene's sphere with spherical uv and a 32x32
texture, 8-bit (the packed sampler) and not (the f32 sampler).

Tolerances: sums, totals and logs rtol 1e-5, atol 1e-7; foreground
d_colors, d_dplane and pose gradients rtol 2e-4, atol 1e-6; d_rows rtol
2e-4, atol 1e-6 plus 1e-6 of the pixel's largest lane, as
tests/test_torch_fused_loss.py holds it (a lane that sums cancelling
pair terms keeps the f32 rounding of its largest term, which the two
autodiffs order differently).
The reference writes d_colors on background pixels of slabs that hold
foreground (``fused_loss.py:346-356``), the port 0 past the foreground's
need; the caller's foreground factor removes both, so d_colors is held on
the foreground only."""

import numpy as np
import pytest
import torch

from torch_scene import (
    LRS,
    RES,
    WEIGHTS,
    jax_fused_texture_loss,
    jax_scene,
    port_fused_texture_loss,
    scene_texture,
)

from test_torch_fused_loss import _assert_rows_close

from diffdope_tpu_torch import convert
from diffdope_tpu_torch.optimize import pose_matrix
from diffdope_tpu_torch.render import fused_loss as tf
from torch_scene import one_torch_thread  # noqa: F401

D_SUMS = np.asarray([[1.0, 0.7, 0.9], [0.5, 1.3, 1.1], [2.0, 0.2, 0.4]], np.float32)


def _lane_inputs():
    """The textured scene's rows and ids (the port's plain compact raster
    at the initial poses: both packages then read the same values), its
    gt planes, depth plane and foreground-masked random colour planes."""
    from diffdope_tpu_torch.render.pipeline import _raster

    sc = jax_scene()
    fn = port_fused_texture_loss(scene_texture()["tex"])
    with torch.no_grad():
        ids, rows = _raster(fn.table(torch.tensor(sc["mtx0"])), fn.frame_hw, fn.roi)
    ids, rows = ids.numpy(), rows.numpy()
    gt6 = fn.gt6.numpy()
    h, w = RES
    gtd = np.zeros(ids.shape[1:], np.float32)
    gtd[:h, :w] = sc["gt"]["depth"]
    dplane = gtd[None] + sc["mtx0"][:, 2, 3][:, None, None]
    fg = (ids > 0)[:, None]
    colors = np.random.default_rng(8).uniform(0.0, 1.0, (ids.shape[0], 3) + ids.shape[1:])
    colors = (colors * fg).astype(np.float32)
    return rows, ids, gt6, dplane, colors


@pytest.mark.parametrize("depth", [False, True], ids=["rgb", "depth"])
def test_torch_colour_lane_matches_reference(depth):
    import jax.numpy as jnp

    from diffdope_tpu.render.fused_loss import backward_pass, fused_loss_sums

    rows, ids, gt6, dplane, colors = _lane_inputs()
    assert (ids > 0).sum() > 0
    dpl = dplane if depth else None
    d_sums = D_SUMS if depth else D_SUMS * np.asarray([1.0, 1.0, 0.0], np.float32)
    args = (jnp.asarray(rows), jnp.asarray(ids), jnp.asarray(gt6),
            None if dpl is None else jnp.asarray(dpl), jnp.asarray(colors), RES, 3)
    want = np.asarray(fused_loss_sums(*args, True, None))
    j_rows, j_dpl, j_cols = backward_pass(*args, True, jnp.asarray(d_sums))

    t = [torch.tensor(a) for a in (rows, ids, gt6)]
    roi = (0, 0) + RES
    tdpl = None if dpl is None else torch.tensor(dpl)
    got = tf.loss_sums(*t, roi, tdpl, torch.tensor(colors))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    assert want[:, 1].min() > 0 and (want[:, 2].min() > 0) == depth
    d_rows, d_dpl, d_cols = tf.loss_bwd(*t, roi, torch.tensor(d_sums), tdpl,
                                        torch.tensor(colors))
    _assert_rows_close(d_rows.numpy(), np.asarray(j_rows))
    # the rows carry no rgb cotangent: the uv lanes stay 0 (the sampler's
    # cotangent reaches them outside)
    assert not d_rows[:, 16:22].any()
    fg = np.broadcast_to((ids > 0)[:, None], colors.shape)
    assert np.abs(d_cols.numpy()[fg]).max() > 0
    np.testing.assert_allclose(d_cols.numpy()[fg], np.asarray(j_cols)[fg], rtol=2e-4,
                               atol=1e-6)
    if depth:
        np.testing.assert_allclose(d_dpl.numpy(), np.asarray(j_dpl), rtol=2e-4, atol=1e-6)
    else:
        assert d_dpl is None


def _port_step(tex, fn=None):
    fn = fn or port_fused_texture_loss(tex)
    p = {k: v.requires_grad_(True)
         for k, v in convert.state(jax_scene()["params0"], "cpu").items()}
    total, logs = fn(pose_matrix(p)[0])
    g = torch.autograd.grad(total, list(p.values()))
    return fn, total.detach().numpy(), logs, {k: v.numpy() for k, v in zip(p, g)}


def reference_step(tex, use_depth=False):
    """The reference's texture-route value, logs and pose gradients at the
    scene's initial poses."""
    import jax

    from diffdope_tpu.optimize import pose_matrix as j_pose_matrix

    params = {k: jax.numpy.asarray(v) for k, v in jax_scene()["params0"].items()}
    with pytest.MonkeyPatch.context() as mp:
        fn = jax_fused_texture_loss(mp, tex, use_depth)
        (total, logs), grads = jax.jit(jax.value_and_grad(
            lambda p: fn(j_pose_matrix(p)[0]), has_aux=True))(params)
    return dict(total=np.asarray(total), logs={k: np.asarray(v) for k, v in logs.items()},
                grads={k: np.asarray(v) for k, v in grads.items()})


def assert_step_matches(port, ref, keys=("rgb", "mask_selection")):
    """Totals and logs rtol 1e-5, atol 1e-7; pose gradients rtol 2e-4,
    atol 1e-6."""
    np.testing.assert_allclose(port["total"], ref["total"], rtol=1e-5, atol=1e-7)
    for k in keys:
        np.testing.assert_allclose(port["logs"][k].detach().numpy(), ref["logs"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    for k, g in ref["grads"].items():
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(port["grads"][k], g, rtol=2e-4, atol=1e-6,
                                   err_msg=f"grad {k}")


@pytest.fixture(scope="module")
def step():
    """The reference's and the port's texture-route step on the 8-bit
    texture (the packed sampler)."""
    tex = scene_texture()["tex"]
    fn, total, logs, grads = _port_step(tex)
    return reference_step(tex), dict(fn=fn, total=total, logs=logs, grads=grads, tex=tex)


def test_torch_fused_texture_loss_matches_reference(step):
    ref, port = step
    fn = port["fn"]
    assert fn.crop is None and fn.sample.packed
    assert fn.sample.crop != (0, 0) + tuple(fn.frame_hw)  # the gt-seg crop is on
    assert int(port["logs"]["_bin_overflow"]) == 0
    assert_step_matches(port, ref)


def test_torch_tex_crop_is_exact(step, monkeypatch):
    """DD_TEX_CROP=0 samples the whole frame: the same losses bit for bit,
    the same pose gradients."""
    _, port = step
    monkeypatch.setenv("DD_TEX_CROP", "0")
    fn, total, logs, grads = _port_step(port["tex"])
    assert fn.sample.crop == (0, 0) + tuple(fn.frame_hw)
    assert total == port["total"]
    for k in ("rgb", "mask_selection"):
        assert torch.equal(logs[k], port["logs"][k]), k
    for k, g in grads.items():
        np.testing.assert_allclose(g, port["grads"][k], rtol=1e-6, atol=1e-9, err_msg=k)


def test_torch_fused_texture_matches_unfused(step):
    """The port's fused texture route against its unfused render_batch(tex=)
    + the loss functions (the reference's test_fused_texture_matches_unfused
    on the port)."""
    from diffdope_tpu_torch.losses import select_losses
    from diffdope_tpu_torch.render.pipeline import render_batch

    _, port = step
    sc = convert.state(jax_scene(), "cpu")
    tx = scene_texture()
    loss_fns, weights = select_losses({"l1_mask": True, "weight_mask": WEIGHTS["mask"],
                                       "l1_rgb_with_mask": True,
                                       "weight_rgb": WEIGHTS["rgb"]})
    p = {k: v.requires_grad_(True)
         for k, v in convert.state(jax_scene()["params0"], "cpu").items()}
    renders = render_batch(sc["proj"], pose_matrix(p)[0], sc["pos"], sc["tri"], RES,
                           edge_adj=sc["edge_adj"], layout="channels",
                           tex=port["tex"], uv=tx["uv"], uv_idx=tx["uv_idx"], device="cpu")
    total = torch.zeros(())
    logs = {}
    for fn in loss_fns:
        term, (key, vals) = fn(renders, sc["gt"], torch.tensor(LRS), weights)
        total = total + term
        logs[key] = vals
    g = torch.autograd.grad(total, list(p.values()))
    np.testing.assert_allclose(total.detach().numpy(), port["total"], rtol=1e-5, atol=1e-7)
    for k in ("rgb", "mask_selection"):
        np.testing.assert_allclose(logs[k].detach().numpy(),
                                   port["logs"][k].detach().numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for k, gk in zip(p, g):
        np.testing.assert_allclose(gk.numpy(), port["grads"][k], rtol=2e-4, atol=1e-6,
                                   err_msg=f"grad {k}")


@pytest.mark.parametrize("depth", [False, True])
def test_torch_loss_bounds_count_each_lanes_body(depth):
    """The K5/K6 bounds count the operations of the launch's own body: the
    colour lane shades no colour channel (the rgb + mask lane shades three
    and divides them, at a foreground pixel in K5, at every real pixel in
    K6) and writes d_colors at every real pixel in place of the rgb
    cotangent of a foreground pixel; a pair's crossing search (and K6's g
    and pair backward) counts only where the pair is on the silhouette,
    once (the counts are the same with the foreground ids collapsed to
    one); nothing past the real frame counts."""
    from diffdope_tpu_torch.kernels.check import _LOSS_OPS as c
    from diffdope_tpu_torch.kernels.check import _loss_ops

    ids = torch.zeros((2, 12, 16), dtype=torch.int32)
    ids[:, 3:7, 4:9] = 5
    ids[1, 3:7, 6:9] = 6
    roi = (0, 0, 10, 14)  # 2 rows and 2 columns past the frame
    n_px, n_fg = 2 * 10 * 14, int((ids > 0).sum())
    rgb5, rgb6 = _loss_ops(ids, roi, depth, colors=False)
    col5, col6 = _loss_ops(ids, roi, depth, colors=True)
    assert rgb5 - col5 == n_fg * (3 * (c["channel"] + 1) + (0 if depth else c["shade"]))
    assert _loss_ops((ids > 0).to(ids.dtype), roi, depth, colors=True) == (col5, col6)
    assert rgb6 - col6 == n_fg * (3 * (c["channel"] + 1 + c["channel_bwd"]) + c["rgb_bwd"]
                                  + (0 if depth else c["shade"] + c["edge_bwd"])) \
        - n_px * c["rgb_bwd"]
    empty5, empty6 = _loss_ops(torch.zeros_like(ids), roi, depth, colors=True)
    assert empty5 == n_px * (5 + c["terms"] + (c["depth"] + 3 if depth else 2))
    assert empty6 == n_px * (c["rgb_bwd"] + (c["depth_bwd"] if depth else 0))
    # a 4 x 5 block: 18 silhouette pairs, 14 foreground and 18 background
    # pixels on them, per hypothesis
    n_sil, n_sil_px = 2 * 18, 2 * (14 + 18)
    assert col6 - empty6 == (c["search"] + c["pair_bwd"]) * n_sil + c["g"] * n_sil_px \
        + (n_fg * (c["shade"] + c["channel"] + 1 + c["channel_bwd"] + c["edge_bwd"])
           if depth else 0)
    past = ids.clone()
    past[:, 10:, :] = 7
    past[:, :, 14:] = 7
    assert _loss_ops(past, roi, depth, colors=True) == (col5, col6)
