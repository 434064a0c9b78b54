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
)

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
