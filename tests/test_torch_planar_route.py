"""Port parity for the planar route that ``DD_RASTER=v3`` and
``DD_BINNED=0`` select, in both packages (the environment set with
``monkeypatch`` while each side builds or traces): ``render_batch`` on the
torch_scene (64x96, B=3, icosphere(2)) at its initial poses
(tests/test_torch_planar_fused_loss.py holds ``make_fused_loss`` and a
``DiffDope`` run), the gt render and the route switch.

On 'v3' the reference runs K10's Pallas kernels (interpret mode) on 32x128
tiles, the port K10's plain twin on 16x16 tiles; on 'v2' the reference
bins on 32x128 tiles, the port on 16x16 tiles (K7's plain twin over the
gathered bins), both inverting the bins at max_occ 16.  The port renders
the reference's table values: XLA's CPU fusions contract the planar pack's
multiply-adds into FMAs, ~1e-6 off the port's plain pack, which flips a
few z-test winners; so the table the reference's raster consumed is
captured (``jax.debug.callback``) and swapped into the port's
(value + (ref - value).detach(): the port's autograd carries the
gradient).  Then ids are exact; losses and pose gradients are held at the
loss parity tests' tolerances (rtol 1e-5, atol 1e-7; rtol 2e-4, atol
1e-6), the images at tests/test_torch_render_batch.py's but for an atol of
2e-5 on rgb and depth: the reference's shade after this raster is fused by
XLA with FMAs too and rounds up to ~1.3e-5 apart at a pixel (1 of 55,296
rgb values on 'v2')."""

import numpy as np
import pytest
import torch

from torch_scene import MAX_K, RES, ROUTES, feed_planar_table, jax_scene, planar_capture, \
    set_route

from diffdope_tpu_torch.render import pipeline
from diffdope_tpu_torch.render.pipeline import render_batch
from torch_scene import one_torch_thread  # noqa: F401


def _weights():
    rng = np.random.default_rng(3)
    b = jax_scene()["mtx0"].shape[0]
    return (rng.uniform(0.5, 1.5, (b,) + RES).astype(np.float32),
            rng.uniform(0.5, 1.5, (b,) + RES + (3,)).astype(np.float32))


@pytest.fixture(scope="module", params=sorted(ROUTES))
def renders(request):
    """render_batch (channels layout) under the route, both packages: the
    images, the ids and the gradient of a weighted mask + rgb + depth sum
    w.r.t. the poses."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.pipeline import render_batch as j_render_batch

    route = request.param
    sc = jax_scene()
    w_mask, w_rgb = _weights()

    def j_objective(mtx):
        out = j_render_batch(sc["proj"], mtx, sc["pos"], sc["tri"], RES,
                             vtx_color=sc["vtx_color"], edge_adj=sc["edge_adj"],
                             raster_impl="pallas", max_tris_per_tile=MAX_K,
                             layout="channels")
        total = (jnp.sum(out["mask"] * w_mask) + jnp.sum(jnp.stack(out["rgb"], -1) * w_rgb)
                 + jnp.sum(out["depth"] * w_mask))
        return total, out

    store = []
    with pytest.MonkeyPatch.context() as mp:
        set_route(mp, route)
        planar_capture(mp, route, store)
        (_, ref), grad = jax.jit(jax.value_and_grad(j_objective, has_aux=True))(
            jnp.asarray(sc["mtx0"]))
        jax.effects_barrier()
    ref = {k: v for k, v in ref.items() if v is not None}
    ref["grad"] = grad
    assert store, "the reference did not run its planar raster"

    mtx = torch.tensor(sc["mtx0"], requires_grad=True)
    with pytest.MonkeyPatch.context() as mp:
        set_route(mp, route)
        feed_planar_table(mp, store[0])
        got = render_batch(sc["proj"], mtx, sc["pos"], sc["tri"], RES,
                           vtx_color=sc["vtx_color"], edge_adj=sc["edge_adj"],
                           layout="channels", max_tris_per_tile=MAX_K, device="cpu")
    objective = ((got["mask"] * torch.tensor(w_mask)).sum()
                 + (torch.stack(got["rgb"], dim=-1) * torch.tensor(w_rgb)).sum()
                 + (got["depth"] * torch.tensor(w_mask)).sum())
    (got["grad"],) = torch.autograd.grad(objective, mtx)
    return route, jax.tree.map(np.asarray, ref), got


def test_torch_planar_render_batch_matches_reference(renders):
    route, ref, got = renders
    np.testing.assert_array_equal(got["ids"].numpy(), ref["ids"])
    assert int((got["ids"] > 0).sum()) > 1000
    planes = {"mask": (got["mask"], ref["mask"]),
              "rgb": (torch.stack(got["rgb"], -1), np.stack(ref["rgb"], -1)),
              "depth": (got["depth"], ref["depth"])}
    for name, (g, r) in planes.items():
        np.testing.assert_allclose(g.detach().numpy(), r, rtol=1e-5,
                                   atol=1e-4 if name == "mask" else 2e-5, err_msg=name)
    assert np.abs(ref["grad"]).max() > 0
    np.testing.assert_allclose(got["grad"].numpy(), ref["grad"], rtol=2e-4, atol=1e-6)
    if route == "v3":  # bins nothing: no binning telemetry on either side
        assert "_bin_overflow" not in got and "_bin_overflow" not in ref
    else:
        assert int(got["_bin_overflow"]) == 0 == int(ref["_bin_overflow"])
        # the inverted map is as wide as the most tiles a triangle occupies
        assert pipeline.MAX_OCC == "auto" and int(got["_bin_occupancy"]) > 0


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_torch_planar_render_rgb_mask_equals_binned_route(route, monkeypatch):
    """The gt render on a planar route (which on 'v3' carries no overflow
    count to check) equals the default route's: the port's planar and
    bin-ordered packs compute the same values, and K10, K7 and K3 the same
    (z, id) minimum."""
    sc = jax_scene()
    args = (sc["proj"], sc["mtx0"], sc["pos"], sc["tri"], RES)
    kw = dict(edge_adj=sc["edge_adj"], vtx_color=sc["vtx_color"], device="cpu")
    want = pipeline.render_rgb_mask(*args, **kw)
    set_route(monkeypatch, route)
    got = pipeline.render_rgb_mask(*args, **kw)
    for key in ("rgb", "mask", "depth"):
        assert torch.equal(got[key], want[key]), key
    assert float(got["mask"].sum()) > 1000


def test_torch_raster_route_reads_the_environment(monkeypatch):
    for env, want in (({}, None), ({"DD_RASTER": "v3"}, "v3"), ({"DD_BINNED": "0"}, "v2"),
                      ({"DD_BINNED": "0", "DD_RASTER": "v3"}, "v3"),
                      ({"DD_RASTER": "v2"}, None)):
        for name in ("DD_RASTER", "DD_BINNED"):
            monkeypatch.delenv(name, raising=False)
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        assert pipeline.raster_route() == want, env


def test_torch_v2_gradient_of_a_triangle_past_16_tiles(monkeypatch):
    """A triangle that covers more than 16 of the port's 16x16 tiles keeps
    its whole gradient on the ``DD_BINNED=0`` route: its inverted bin map
    is as wide as the bins need (a fixed width of 16, the reference's for
    its 32x128 tiles, dropped the rest).  The pose gradient equals the
    compact route's (its spanning op with f32 d_rows, as the planar
    route's chained ops), which has no inverted map, at rtol 2e-4, atol
    1e-6."""
    from diffdope_tpu_torch import geometry as geo
    from diffdope_tpu_torch.optimize import pose_matrix, pose_params
    from diffdope_tpu_torch.render.pipeline import compact_capacity, make_fused_loss

    res = (96, 128)
    f = 1.2 * max(res)
    proj = geo.projection_from_intrinsics(f, f, res[1] / 2, res[0] / 2, res[1], res[0],
                                          0.01, 100.0).astype(np.float32)
    pos = np.asarray([[-0.5, -0.4, 0.0], [0.55, -0.3, 0.05], [0.05, 0.5, -0.05],
                      [0.6, 0.3, 0.1], [0.7, 0.4, 0.1], [0.65, 0.45, 0.12]], np.float32)
    tri = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    colors = np.random.default_rng(9).uniform(0.2, 0.9, (6, 3)).astype(np.float32)
    q = np.asarray(geo.quat_from_axis_angle(np.array([0.3, 1.0, 0.2]), 0.3), np.float32)
    gt_mtx, _, _ = pose_matrix(pose_params(q, [0.02, -0.01, -2.0], 1, "cpu"))
    gt = pipeline.render_rgb_mask(proj, gt_mtx, pos, tri, res, vtx_color=colors, device="cpu")
    gt = {"rgb": gt["rgb"][0].numpy(), "segmentation": gt["mask"][0].numpy()}
    weights = {"rgb": 0.7, "mask": 1.0}

    def step(route_env):
        for name in ("DD_RASTER", "DD_BINNED"):
            monkeypatch.delenv(name, raising=False)
        for name, value in route_env.items():
            monkeypatch.setenv(name, value)
        cap = 2 * compact_capacity(proj, pos, tri, gt_mtx, res, device="cpu")
        fn = make_fused_loss(proj, pos, tri, res, gt, np.ones(2, np.float32), weights,
                             use_rgb=True, use_mask=True, vtx_color=colors,
                             compact_total=cap, device="cpu")
        p = {k: (v + 0.01 * torch.arange(2)).requires_grad_(True)
             for k, v in pose_params(q, [0.0, 0.0, -2.0], 2, "cpu").items()}
        total, logs = fn(pose_matrix(p)[0])
        return logs, dict(zip(p, torch.autograd.grad(total, list(p.values()))))

    logs_v2, g_v2 = step(ROUTES["v2"])
    assert int(logs_v2["_bin_occupancy"]) > 16 and int(logs_v2["_bin_overflow"]) == 0
    _, g_compact = step({"DD_DROWS_BF16": "0"})  # the spanning op's f32 lane
    for k, g in g_compact.items():
        assert g.abs().max() > 0, k
        np.testing.assert_allclose(g_v2[k].numpy(), g.numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=k)
