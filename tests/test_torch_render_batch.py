"""Port parity for the unfused render: the JAX render_batch on its pallas +
compact branch (interpret mode, DD_PACK=pallas) against the port's
render_batch (K1 -> K3, plain shade and antialiasing; backward K4 -> K2,
here the plain versions) on the torch_scene at its initial poses, in both
layouts: ids exactly equal, rgb and depth rtol 1e-5, atol 1e-6, the
antialiased mask rtol 1e-5, atol 1e-4, and the gradient of a weighted
mask + rgb sum w.r.t. the poses rtol 2e-4, atol 1e-6.  The mask's atol:
antialiasing divides an edge's crossing point by the pixel spacing (2/W,
x48 here), and XLA evaluates the crossing with FMAs, so a few ulps of it
are up to ~5e-5 of a silhouette pixel's mask (measured 5.1e-5 at 34 of
18,432 pixels).

The port renders the reference's table values: its pack's output is
replaced by the reference's Pallas pack of the same slots (value + (ref -
value).detach(), so the port's own pack autograd carries the gradient).
XLA's CPU fusions contract the pack's multiply-adds into FMAs, which puts
the two tables ~1e-6 apart (tests/test_torch_pack_kernel.py holds the
packs to each other at that tolerance); on this scene that flips the
z-test winner of 1-2 pixels per render, and a flipped pixel moves the
pose gradient by ~0.3%."""

import numpy as np
import pytest
import torch

from torch_scene import COMPACT_TOTAL, JAX_TILE_HW, MAX_K, RES, feed_reference_pack, jax_scene

from diffdope_tpu_torch.render.pipeline import render_batch
from torch_scene import one_torch_thread  # noqa: F401


def _weights():
    rng = np.random.default_rng(3)
    b = jax_scene()["mtx0"].shape[0]
    return (rng.uniform(0.5, 1.5, (b,) + RES).astype(np.float32),
            rng.uniform(0.5, 1.5, (b,) + RES + (3,)).astype(np.float32))


@pytest.fixture(scope="module", params=["stacked", "channels"])
def renders(request):
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.pipeline import render_batch as j_render_batch

    layout = request.param
    sc = jax_scene()
    w_mask, w_rgb = _weights()

    def stack(out):
        if layout == "channels":
            return out["mask"], jnp.stack(out["rgb"], axis=-1)
        return out["mask"][..., 0], out["rgb"]

    def j_render(mtx):
        return j_render_batch(
            sc["proj"], mtx, sc["pos"], sc["tri"], RES, vtx_color=sc["vtx_color"],
            edge_adj=sc["edge_adj"], raster_impl="pallas", tile_hw=JAX_TILE_HW,
            max_tris_per_tile=MAX_K, layout=layout, compact_total=COMPACT_TOTAL,
        )

    def j_objective(mtx):
        mask, rgb = stack(j_render(mtx))
        return jnp.sum(mask * w_mask) + jnp.sum(rgb * w_rgb)

    mtx0 = jnp.asarray(sc["mtx0"])
    ref = {k: v for k, v in jax.jit(j_render)(mtx0).items() if v is not None}
    ref["grad"] = jax.jit(jax.grad(j_objective))(mtx0)

    mtx = torch.tensor(sc["mtx0"], requires_grad=True)
    with pytest.MonkeyPatch.context() as mp:
        feed_reference_pack(mp)
        got = render_batch(sc["proj"], mtx, sc["pos"], sc["tri"], RES,
                           vtx_color=sc["vtx_color"], edge_adj=sc["edge_adj"],
                           layout=layout, compact_total=COMPACT_TOTAL, device="cpu")
    if layout == "channels":
        mask, rgb = got["mask"], torch.stack(got["rgb"], dim=-1)
    else:
        mask, rgb = got["mask"][..., 0], got["rgb"]
    objective = (mask * torch.tensor(w_mask)).sum() + (rgb * torch.tensor(w_rgb)).sum()
    (grad,) = torch.autograd.grad(objective, mtx)
    got["grad"] = grad
    return layout, jax.tree.map(np.asarray, ref), got


def _planes(out, layout):
    if layout == "channels":
        rgb = np.stack([np.asarray(c.detach() if isinstance(c, torch.Tensor) else c)
                        for c in out["rgb"]], -1)
        return out["mask"], rgb, out["depth"]
    return out["mask"], out["rgb"], out["depth"]


def test_torch_render_batch_images(renders):
    layout, ref, got = renders
    assert got["rast_out"] is None  # not asked for
    got = {k: (tuple(c.detach().numpy() for c in v) if isinstance(v, tuple)
               else v.detach().numpy()) for k, v in got.items() if v is not None}
    assert int(got["_bin_overflow"]) == 0 == int(ref["_bin_overflow"])
    if layout == "channels":
        np.testing.assert_array_equal(got["ids"], ref["ids"])
        assert int((got["ids"] > 0).sum()) > 1000  # the sphere is on screen
    for name, g, r in zip(("mask", "rgb", "depth"), _planes(got, layout),
                          _planes(ref, layout)):
        assert g.shape == np.asarray(r).shape, name
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4 if name == "mask" else 1e-6,
                                   err_msg=name)
    if layout == "stacked":
        assert got["mask"].shape == (3,) + RES + (3,)
        assert got["rgb"].shape == (3,) + RES + (3,)


def test_torch_render_batch_pose_gradient(renders):
    _, ref, got = renders
    assert np.abs(ref["grad"]).max() > 0
    np.testing.assert_allclose(got["grad"].numpy(), ref["grad"], rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module")
def uniform_renders():
    """The channels layout on the uniform-K table (compact_total None): the
    reference's on its 32x128 super-tiles, the port's through K7 on 16x16
    tiles, the port fed the reference's table values as above."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.pipeline import render_batch as j_render_batch

    sc = jax_scene()
    w_mask, w_rgb = _weights()

    def j_render(mtx):
        return j_render_batch(
            sc["proj"], mtx, sc["pos"], sc["tri"], RES, vtx_color=sc["vtx_color"],
            edge_adj=sc["edge_adj"], raster_impl="pallas", tile_hw=JAX_TILE_HW,
            max_tris_per_tile=MAX_K, layout="channels", compact_total=None,
        )

    def j_objective(mtx):
        out = j_render(mtx)
        return (jnp.sum(out["mask"] * w_mask)
                + jnp.sum(jnp.stack(out["rgb"], axis=-1) * w_rgb)
                + jnp.sum(out["depth"] * w_mask))

    mtx0 = jnp.asarray(sc["mtx0"])
    ref = {k: v for k, v in jax.jit(j_render)(mtx0).items() if v is not None}
    ref["grad"] = jax.jit(jax.grad(j_objective))(mtx0)

    mtx = torch.tensor(sc["mtx0"], requires_grad=True)
    with pytest.MonkeyPatch.context() as mp:
        feed_reference_pack(mp)
        got = render_batch(sc["proj"], mtx, sc["pos"], sc["tri"], RES,
                           vtx_color=sc["vtx_color"], edge_adj=sc["edge_adj"],
                           layout="channels", compact_total=None, device="cpu")
    objective = ((got["mask"] * torch.tensor(w_mask)).sum()
                 + (torch.stack(got["rgb"], dim=-1) * torch.tensor(w_rgb)).sum()
                 + (got["depth"] * torch.tensor(w_mask)).sum())
    (got["grad"],) = torch.autograd.grad(objective, mtx)
    return jax.tree.map(np.asarray, ref), got


def test_torch_render_batch_uniform_matches_reference(uniform_renders):
    """render_batch(compact_total=None): ids exactly, mask / rgb / depth and
    the pose gradient (of a weighted mask + rgb + depth sum) at the
    tolerances above."""
    ref, got = uniform_renders
    assert int(got["_bin_overflow"]) == 0 == int(ref["_bin_overflow"])
    np.testing.assert_array_equal(got["ids"].numpy(), ref["ids"])
    assert int((got["ids"] > 0).sum()) > 1000
    for name, g, r in zip(("mask", "rgb", "depth"), _planes(got, "channels"),
                          _planes(ref, "channels")):
        g = np.asarray(g.detach()) if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-4 if name == "mask" else 1e-6,
                                   err_msg=name)
    assert np.abs(ref["grad"]).max() > 0
    np.testing.assert_allclose(got["grad"].numpy(), ref["grad"], rtol=2e-4, atol=1e-6)


def test_torch_render_batch_unported_paths_raise():
    """What render_batch still refuses: an unknown layout and a compact
    capacity off the chunk."""
    sc = jax_scene()
    args = (sc["proj"], sc["mtx0"], sc["pos"], sc["tri"], RES)
    with pytest.raises(ValueError, match="layout"):
        render_batch(*args, vtx_color=sc["vtx_color"], layout="planar",
                     compact_total=COMPACT_TOTAL, device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        render_batch(*args, vtx_color=sc["vtx_color"], compact_total=COMPACT_TOTAL + 8,
                     device="cpu")
