"""Port parity for the ``rasterize`` op: the triangle-id search (K8's plain
twin ``raster_ids_binned_plain`` and the brute force
``raster_ids_reference``) against the JAX package's ``raster_ids_pallas``
(interpret mode) and ``raster_ids_reference``, and the differentiable
re-evaluation ``rast_from_ids`` against its JAX counterpart.

The ids are held bit for bit on the JAX side's coefficients, at tiles
(16, 32) and (32, 128) over a frame that is a multiple of neither, and
with a K that overflows (both drop the same pairs).  ``rast``/``rast_db``
(rtol 1e-5, atol 1e-6) and the gradient of a weighted sum of both with
respect to ``pos_clip`` (rtol 2e-4, atol 1e-6, against ``jax.grad``) take
the JAX ids and the JAX coefficient values, with the port's own setup
carrying the gradient (value + (jax - value).detach()): ``jnp.cross`` is
jitted and XLA contracts its a*b - c*d into an FMA, which leaves the two
setups a few ulps apart, and where a coefficient cancels (0.22 relative
on this scene) that moves u by ~2e-5 near an edge.  The gradient also
allows 1e-6 of the vertex's largest component (see the test).  The whole
op is held to the JAX id search run on the port's own coefficients.

The setup rows' gather has a backward of its own (``SetupRows``): each
triangle's row sums its pixels in ascending pixel order, on the card by
a stable sort and a segmented sum; here it is held to autograd's gather
gradient and to itself from call to call, and the sort's segments to the
pixels they must hold.
"""

import numpy as np
import pytest
import torch

from torch_scene import RES as SCENE_RES
from torch_scene import jax_scene, random_clip_scene

import jax
import jax.numpy as jnp

from diffdope_tpu.render import setup_tris as j_setup
from diffdope_tpu.render.rasterize import (
    rast_from_ids as j_rast_from_ids,
    raster_ids_pallas as j_raster_ids_pallas,
    raster_ids_reference as j_raster_ids_reference,
    rasterize as j_rasterize,
)
from diffdope_tpu_torch.render import setup_tris as t_setup
from diffdope_tpu_torch.render.rasterize import (
    rast_from_ids,
    raster_ids,
    raster_ids_binned_plain,
    raster_ids_reference,
    rasterize,
    segments,
    setup_rows,
)
from torch_scene import one_torch_thread  # noqa: F401

RES = (40, 150)  # a multiple of neither tile


def _jax_setup(pos, tri):
    return j_setup.triangle_setup(jnp.asarray(pos), jnp.asarray(tri))


@pytest.mark.parametrize("tile,k", [((16, 32), 64), ((32, 128), 64), ((32, 128), 8)])
def test_torch_raster_ids_match_reference(tile, k):
    pos, tri = random_clip_scene(behind=True)
    setup = _jax_setup(pos, tri)
    idx, counts, overflow = j_setup.bin_triangles(jnp.asarray(pos)[:, tri], setup.det,
                                                  RES, tile, k)
    assert (int(overflow) > 0) == (k == 8)
    want = np.asarray(j_raster_ids_pallas(setup.coef, idx, counts, RES, tile,
                                             interpret=True))
    coef = torch.tensor(np.asarray(setup.coef))
    args = (coef, torch.tensor(np.asarray(idx)), torch.tensor(np.asarray(counts)), RES, tile)
    got = raster_ids(*args)  # a CPU tensor: the plain twin
    assert got.shape == (2,) + RES and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(raster_ids_binned_plain(*args).numpy(), want)
    if k > 8:  # nothing dropped: the binned search is the brute force's
        np.testing.assert_array_equal(
            raster_ids_reference(coef, RES).numpy(),
            np.asarray(j_raster_ids_reference(setup.coef, RES)))
        np.testing.assert_array_equal(want, np.asarray(j_raster_ids_reference(setup.coef, RES)))
    assert (want > 0).sum() > 500


def _port_setup(pos_t, tri, coef_ref):
    """The port's setup of ``pos_t`` holding the JAX coefficient values."""
    own = t_setup.triangle_setup(pos_t, torch.tensor(tri)).coef
    return t_setup.TriangleSetup(own + (torch.tensor(coef_ref) - own).detach())


def _weights(shape, seed):
    return np.random.default_rng(seed).uniform(0.5, 1.5, shape).astype(np.float32)


@pytest.mark.parametrize("with_db", [True, False])
def test_torch_rast_from_ids_matches_reference(with_db):
    pos, tri = random_clip_scene()
    setup = _jax_setup(pos, tri)
    ids = j_raster_ids_reference(setup.coef, RES)
    want = j_rast_from_ids(ids, setup, RES, with_db=with_db)
    got = rast_from_ids(torch.tensor(np.asarray(ids)),
                             _port_setup(torch.tensor(pos), tri, np.asarray(setup.coef)),
                             RES, with_db=with_db)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    if with_db:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-6)
    else:
        assert got[1] is None and want[1] is None


def test_torch_rast_pos_grad_matches_reference():
    pos, tri = random_clip_scene(seed=7)
    setup = _jax_setup(pos, tri)
    ids = j_raster_ids_reference(setup.coef, RES)
    w_r, w_d = _weights((2,) + RES + (3,), 1), _weights((2,) + RES + (4,), 2)

    def j_loss(p):
        rast, db = j_rast_from_ids(ids, j_setup.triangle_setup(p, jnp.asarray(tri)), RES)
        return jnp.sum(rast[..., :3] * w_r) + 1e-3 * jnp.sum(db * w_d)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(pos)))
    p = torch.tensor(pos, requires_grad=True)
    rast, db = rast_from_ids(torch.tensor(np.asarray(ids)),
                                  _port_setup(p, tri, np.asarray(setup.coef)), RES)
    loss = (rast[..., :3] * torch.tensor(w_r)).sum() + 1e-3 * (db * torch.tensor(w_d)).sum()
    (got,) = torch.autograd.grad(loss, p)
    assert np.abs(want).max() > 1.0
    # rtol 2e-4, atol 1e-6, plus 1e-6 of the vertex's largest component, as
    # tests/test_torch_fused_loss.py allows 1e-6 of a pixel's largest lane:
    # a component sums per-pixel terms of the vertex's gradient's size, and
    # where they cancel it keeps their f32 rounding (vertex 9's x: -8e-4
    # from terms of ~40, 7.4e-6 apart without the allowance)
    scale = np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(got.numpy() - want)
    assert np.all(err <= 1e-6 + 2e-4 * np.abs(want) + 1e-6 * scale), err.max()


@pytest.mark.parametrize("impl", ["pallas", "reference", "auto"])
def test_torch_rasterize_op_ids_match_reference(impl):
    """The whole op on the shared test scene (icosphere(2), 320 triangles,
    so 'auto' is 'pallas'; 64x96, three poses): its ids are the JAX id
    search's (interpret-mode K8 on the JAX binning, or the brute force) on
    the port's own coefficients, and its rast is rast_from_ids of them.
    (The JAX op, on its FMA-contracted setup, flips 2 of 18,432 pixels.)"""
    sc = jax_scene()
    mvp = np.einsum("ij,bjk->bik", sc["proj"], sc["mtx0"]).astype(np.float32)
    pos = np.concatenate([sc["pos"], np.ones((len(sc["pos"]), 1), np.float32)], 1)
    pos_clip = np.einsum("bij,nj->bni", mvp, pos).astype(np.float32)
    got, db = rasterize(torch.tensor(pos_clip), sc["tri"], SCENE_RES, impl=impl)
    setup = t_setup.triangle_setup(torch.tensor(pos_clip), torch.tensor(sc["tri"]))
    coef = jnp.asarray(setup.coef.numpy())
    if impl == "reference":
        want = j_raster_ids_reference(coef, SCENE_RES)
    else:
        tile = (32, 128)
        idx, counts, _ = j_setup.bin_triangles(jnp.asarray(pos_clip)[:, sc["tri"]],
                                               coef[..., 12], SCENE_RES, tile, 1024)
        want = j_raster_ids_pallas(coef, idx, counts, SCENE_RES, tile, interpret=True)
    np.testing.assert_array_equal(got[..., 3].numpy(), np.asarray(want))
    again, db_again = rast_from_ids(got[..., 3].to(torch.int32), setup, SCENE_RES)
    assert torch.equal(got, again) and torch.equal(db, db_again)
    assert (got[..., 3] > 0).sum() > 1000


def test_torch_rasterize_takes_numpy_and_corners():
    """numpy inputs go to the given device; corner input rasterizes as the
    indexed input; an unknown impl raises."""
    pos, tri = random_clip_scene(n_tri=12)
    rast, db = rasterize(pos, tri, RES, impl="pallas", tile_hw=(16, 32), device="cpu")
    rc, dbc = rasterize(None, tri, RES, impl="pallas", tile_hw=(16, 32),
                             corners_clip=torch.tensor(pos)[:, torch.tensor(tri).long()])
    assert rast.device.type == "cpu"
    np.testing.assert_array_equal(rc[..., 3].numpy(), rast[..., 3].numpy())
    assert db is not None and dbc is not None
    assert rasterize(torch.tensor(pos), tri, RES, with_db=False)[1] is None
    auto, _ = rasterize(torch.tensor(pos), tri, RES)  # 12 triangles: the brute force
    assert torch.equal(auto, rasterize(torch.tensor(pos), tri, RES, impl="reference")[0])
    with pytest.raises(ValueError, match="unknown rasterize impl"):
        rasterize(torch.tensor(pos), tri, RES, impl="v3")


def _gather_grads(coef, ids, weights, own: bool):
    """d(sum(rows * weights))/d coef through SetupRows (``own``) or
    through autograd's gather of the same rows."""
    c = coef.detach().clone().requires_grad_(True)
    flat = ids.reshape(ids.shape[0], -1)
    if own:
        rows = setup_rows(c, ids)
    else:
        idx = (flat.long() - 1).clamp(min=0)[..., None].expand(-1, -1, c.shape[2])
        rows = torch.where((flat > 0)[..., None], c.gather(1, idx), 0.0)
    (g,) = torch.autograd.grad((rows * weights).sum(), c)
    return g


def test_torch_setup_rows_backward_matches_gather_and_repeats():
    """SetupRows' backward (the deterministic sum rasterize's gradient goes
    through) against autograd's gather gradient on the CPU, rtol 2e-4,
    atol 1e-6, and bit for bit from call to call; through rast_from_ids
    too, its pos_clip gradient repeats bit for bit."""
    pos, tri = random_clip_scene(seed=3, n_tri=60, batch=3)
    p = torch.tensor(pos, requires_grad=True)
    setup = t_setup.triangle_setup(p, torch.tensor(tri))
    ids = raster_ids_reference(setup.coef.detach(), RES)
    assert (ids > 0).sum() > 1000 and len(torch.unique(ids)) > 40
    weights = torch.tensor(np.random.default_rng(4).normal(
        size=(3, RES[0] * RES[1], setup.coef.shape[2])).astype(np.float32))
    got = _gather_grads(setup.coef, ids, weights, own=True)
    want = _gather_grads(setup.coef, ids, weights, own=False)
    assert torch.equal(got, _gather_grads(setup.coef, ids, weights, own=True))
    assert float(want.abs().max()) > 1.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=1e-6)

    def pos_grad():
        rast, db = rast_from_ids(ids, t_setup.triangle_setup(p, torch.tensor(tri)), RES)
        (g,) = torch.autograd.grad(rast[..., :3].sum() + 1e-3 * db.sum(), p)
        return g

    first = pos_grad()
    assert torch.equal(first, pos_grad()) and float(first.abs().max()) > 0


def test_torch_setup_rows_segments_hold_each_triangles_pixels():
    """The card's ordering of the backward (``segments``): segment b*T + t
    holds exactly the pixels of hypothesis b whose id is t + 1, in
    ascending order; background pixels are in no segment."""
    pos, tri = random_clip_scene(seed=5, n_tri=30, batch=2)
    coef = t_setup.triangle_setup(torch.tensor(pos), torch.tensor(tri)).coef
    ids = raster_ids_reference(coef, RES).reshape(2, -1)
    t_count = len(tri)
    order, start = segments(ids, t_count)
    assert order.dtype == start.dtype == torch.int32
    assert start.shape == (2 * t_count + 1,) and int(start[-1]) == int((ids > 0).sum())
    flat = ids.reshape(-1)
    for s in range(2 * t_count):
        b, t = divmod(s, t_count)
        want = torch.nonzero(flat == t + 1).reshape(-1)
        want = want[(want >= b * ids.shape[1]) & (want < (b + 1) * ids.shape[1])]
        assert torch.equal(order[start[s]:start[s + 1]].long(), want), s
