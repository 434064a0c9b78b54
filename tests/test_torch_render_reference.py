"""Port parity for the reference rasterizer route: ``render_batch`` on its
brute-force branch (``raster_impl='reference'``, with ``return_rast_out``
and ``antialias_rgb``) against the JAX package's, and a ``DiffDope``
session with ``tpu.raster_impl: reference`` against the JAX session it is
built from (``convert.diffdope_state``), as tests/test_torch_diffdope.py
does for the kernel route.

render_batch: the port renders the JAX side's setup values (its own setup
carries the gradient: value + (jax - value).detach()), because XLA
contracts the jitted cross products into FMAs and that flips the z-test
winner of one pixel of the 18,432 here.  ids exactly equal; depth rtol
1e-5, atol 1e-6; the antialiased mask and rgb rtol 1e-5, atol 1e-4
(antialiasing divides an edge crossing by the pixel spacing, x48 here, as
in tests/test_torch_render_batch.py); rast's (u, v, z/w) rtol 1e-5, atol
1e-4: the jitted JAX side also evaluates the edge and depth planes with
FMAs, and where their terms cancel that moves u, v and z/w by up to
1.6e-5 here (the rasterize op itself, eager, holds atol 1e-6 in
tests/test_torch_rasterize.py); the pose and the vertex colours'
gradients of a weighted sum rtol 2e-4, atol 1e-6.
"""

import copy

import numpy as np
import pytest
import torch

from test_torch_diffdope import B, STEPS, _cfg, _port_session, _reference_session
from torch_scene import RES, jax_scene

import jax
import jax.numpy as jnp

from diffdope_tpu_torch import convert
from diffdope_tpu_torch import kernels
from diffdope_tpu_torch.render import pipeline
from diffdope_tpu_torch.render.pipeline import render_batch
from torch_scene import one_torch_thread  # noqa: F401

RENDER_KW = dict(raster_impl="reference", return_rast_out=True, antialias_rgb=True)


def _weights():
    rng = np.random.default_rng(7)
    b = jax_scene()["mtx0"].shape[0]
    return (rng.uniform(0.5, 1.5, (b,) + RES).astype(np.float32),
            rng.uniform(0.5, 1.5, (b,) + RES + (3,)).astype(np.float32),
            rng.uniform(0.5, 1.5, (b,) + RES + (4,)).astype(np.float32))


def _jax_coef(sc):
    """The setup values of the JAX reference branch at the scene's poses."""
    from diffdope_tpu.geometry import xfm_points
    from diffdope_tpu.render.setup_tris import triangle_setup_from_corners

    tri = sc["tri"]
    pos_c = jnp.asarray(sc["pos"])[tri.reshape(-1)][None]

    def coef(mtx):
        mvp = jnp.einsum("...ij,...jk->...ik", jnp.asarray(sc["proj"])[None], mtx,
                         precision="highest")
        corners = xfm_points(pos_c, mvp).reshape(mtx.shape[0], len(tri), 3, 4)
        return triangle_setup_from_corners(corners).coef

    return np.asarray(jax.jit(coef)(jnp.asarray(sc["mtx0"])))


@pytest.fixture(scope="module", params=["stacked", "channels"])
def renders(request):
    from diffdope_tpu.render.pipeline import render_batch as j_render_batch

    layout = request.param
    sc = jax_scene()
    w_mask, w_rgb, w_rast = _weights()

    def planes(out):
        if layout == "channels":
            return out["mask"], jnp.stack(out["rgb"], axis=-1)
        return out["mask"][..., 0], out["rgb"]

    def j_objective(mtx, vtx_color):
        out = j_render_batch(sc["proj"], mtx, sc["pos"], sc["tri"], RES,
                             vtx_color=vtx_color, edge_adj=sc["edge_adj"],
                             layout=layout, **RENDER_KW)
        mask, rgb = planes(out)
        total = (jnp.sum(mask * w_mask) + jnp.sum(rgb * w_rgb)
                 + jnp.sum(out["rast_out"] * w_rast))
        return total, out

    (_, ref), (grad, grad_color) = jax.jit(jax.value_and_grad(
        j_objective, argnums=(0, 1), has_aux=True))(jnp.asarray(sc["mtx0"]),
                                                     jnp.asarray(sc["vtx_color"]))
    ref = jax.tree.map(np.asarray, ref)
    ref["grad"], ref["grad_color"] = np.asarray(grad), np.asarray(grad_color)

    coef_ref = torch.tensor(_jax_coef(sc))
    own = pipeline.triangle_setup_from_corners

    def swapped(corners, degenerate=None):
        setup = own(corners, degenerate)
        return setup._replace(coef=setup.coef + (coef_ref - setup.coef).detach())

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "triangle_setup_from_corners", swapped)
        mtx = torch.tensor(sc["mtx0"], requires_grad=True)
        color = torch.tensor(sc["vtx_color"], requires_grad=True)
        kernels.reset_launches()
        got = render_batch(sc["proj"], mtx, sc["pos"], sc["tri"], RES,
                           vtx_color=color, edge_adj=sc["edge_adj"],
                           layout=layout, device="cpu", **RENDER_KW)
    assert not any(kernels.launches.values())
    if layout == "channels":
        mask, rgb = got["mask"], torch.stack(got["rgb"], dim=-1)
    else:
        mask, rgb = got["mask"][..., 0], got["rgb"]
    total = ((mask * torch.tensor(w_mask)).sum() + (rgb * torch.tensor(w_rgb)).sum()
             + (got["rast_out"] * torch.tensor(w_rast)).sum())
    got["grad"], got["grad_color"] = torch.autograd.grad(total, (mtx, color))
    return layout, ref, got


def _np(v):
    if isinstance(v, tuple):
        return np.stack([c.detach().numpy() for c in v], axis=-1)
    return v.detach().numpy()


def test_torch_render_reference_images(renders):
    layout, ref, got = renders
    assert not any(k.startswith("_") for k in got)  # no bins, no telemetry
    ids, ids_ref = got["rast_out"][..., 3].detach().numpy(), ref["rast_out"][..., 3]
    np.testing.assert_array_equal(ids, ids_ref)
    assert (ids > 0).sum() > 1000
    if layout == "channels":
        np.testing.assert_array_equal(got["ids"].numpy(), ids_ref.astype(np.int32))
    np.testing.assert_allclose(_np(got["rast_out"]), ref["rast_out"], rtol=1e-5, atol=1e-4)
    rgb_ref = np.stack(ref["rgb"], -1) if layout == "channels" else ref["rgb"]
    for name, g, r, atol in (("mask", _np(got["mask"]), ref["mask"], 1e-4),
                             ("rgb", _np(got["rgb"]), rgb_ref, 1e-4),
                             ("depth", _np(got["depth"]), ref["depth"], 1e-6)):
        assert g.shape == np.asarray(r).shape, name
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=atol, err_msg=name)


def test_torch_render_reference_pose_gradient(renders):
    _, ref, got = renders
    assert np.abs(ref["grad"]).max() > 0
    np.testing.assert_allclose(got["grad"].numpy(), ref["grad"], rtol=2e-4, atol=1e-6)


def test_torch_render_reference_color_gradient(renders):
    """The vertex colours' gradient: through the colours' corner gather and
    the brute force's row gather (``shade_rows``), each summed in a fixed
    order (``rasterize.IndexRows``)."""
    _, ref, got = renders
    assert np.abs(ref["grad_color"]).max() > 0
    np.testing.assert_allclose(got["grad_color"].numpy(), ref["grad_color"], rtol=2e-4,
                               atol=1e-6)


def test_torch_render_batch_auto_rule():
    """'auto' is the brute force at <= 256 triangles and the kernel route
    (its telemetry shows) above; an unknown impl raises."""
    sc = jax_scene()  # 320 triangles
    kw = dict(vtx_color=sc["vtx_color"], device="cpu")
    out = render_batch(sc["proj"], sc["mtx0"], sc["pos"], sc["tri"], RES, **kw)
    assert "_bin_overflow" in out and out["rast_out"] is None
    small = sc["tri"][:256]
    out = render_batch(sc["proj"], sc["mtx0"], sc["pos"], small, RES, **kw)
    ref = render_batch(sc["proj"], sc["mtx0"], sc["pos"], small, RES,
                       raster_impl="reference", **kw)
    assert "_bin_overflow" not in out
    for k in ("rgb", "depth", "mask"):
        assert torch.equal(out[k], ref[k]), k
    with pytest.raises(ValueError, match="unknown raster_impl"):
        render_batch(sc["proj"], sc["mtx0"], sc["pos"], small, RES, raster_impl="v3", **kw)


# ---- DiffDope on the reference rasterizer ----------------------------------


@pytest.fixture(scope="module")
def sessions():
    cfg = _cfg("sgd")
    cfg["tpu"]["raster_impl"] = "reference"
    with pytest.MonkeyPatch.context() as mp:
        ref = _reference_session("sgd", mp, cfg=copy.deepcopy(cfg))
    state = convert.diffdope_state(ref)
    port = _port_session(state, cfg)
    kernels.reset_launches()
    port.run_optimization()
    return ref, port, state


def test_torch_diffdope_reference_route_matches_reference(sessions):
    """4 SGD steps: step-0 losses rtol 1e-5, the losses rtol 2e-4 and the
    poses atol 1e-5 at every step (the ROADMAP contract); no kernel runs,
    and no bins, so no telemetry."""
    ref, port, _ = sessions
    assert not any(kernels.launches.values()), kernels.launches
    assert port._make_fused_loss_fn(port.gt_tensors) is None  # the unfused route
    assert port._result.telemetry is None
    assert port.mtx_history.shape == ref.mtx_history.shape == (STEPS, B, 4, 4)
    for k, v in ref.losses_values.items():
        np.testing.assert_allclose(port.losses_values[k][0], v[0], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(port.losses_values[k], v, rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(port.mtx_history, ref.mtx_history, atol=1e-5)
    assert port.get_argmin() == ref.get_argmin()
    mask = port.losses_values["mask_selection"]
    assert mask[-1].mean() < mask[0].mean()
    assert port.renders["rgb"].shape == (B,) + tuple(port.resolution) + (3,)


def test_torch_diffdope_auto_follows_the_triangle_count(sessions):
    """tpu.raster_impl auto: the brute force at <= 256 triangles, the
    kernels above (diffdope.py:372-374); 'pallas' stays the kernel route."""
    _, _, state = sessions
    cfg = _cfg("sgd")
    arrays = {"pos_idx": state["pos_idx"]}  # 320 triangles
    for impl, t, want in (("auto", 320, "pallas"), ("auto", 256, "reference"),
                          ("auto", 80, "reference"), ("pallas", 80, "pallas"),
                          ("reference", 320, "reference")):
        cfg["tpu"]["raster_impl"] = impl
        d = _port_session(state, cfg)
        assert d._impl({"pos_idx": arrays["pos_idx"][:t]}) == want, (impl, t)
    cfg["tpu"]["raster_impl"] = "v3"
    with pytest.raises(ValueError, match="raster_impl"):
        _port_session(state, cfg)
