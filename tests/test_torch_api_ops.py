"""Port parity for the nvdiffrast-style ``interpolate`` and ``antialias``
ops, and for the API path that chains them after ``rasterize``, on
icosphere(2) at 48x64 under three poses (the JAX side eager, so XLA fuses
nothing across ops).

Both packages take the same numpy clip positions, and the ops' ``rast``
and ``rast_db`` inputs are the JAX ``rasterize``'s.  Outputs rtol 1e-5,
atol 1e-6; gradients rtol 2e-4, atol 1e-6.  A clip-position gradient sums
per-pixel terms, so it also allows 1e-6 of the vertex's largest component
(tests/test_torch_rasterize.py says why).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffdope_tpu.geometry import projection_from_intrinsics, quat_from_axis_angle
from diffdope_tpu.mesh import build_edge_adjacency
from diffdope_tpu.render.antialias import antialias as j_antialias
from diffdope_tpu.render.interpolate import interpolate as j_interpolate
from diffdope_tpu.render.rasterize import rasterize as j_rasterize
from diffdope_tpu.testing import icosphere
from diffdope_tpu_torch.render.antialias import antialias
from diffdope_tpu_torch.render.interpolate import interpolate
from diffdope_tpu_torch.render.rasterize import rasterize
from torch_scene import one_torch_thread  # noqa: F401

RES = (48, 64)
B = 3


def _scene():
    """(pos_clip (B, N, 4), tri, edge_adj, vertex colours) as numpy."""
    h, w = RES
    verts, faces = icosphere(2)
    proj = np.asarray(projection_from_intrinsics(60.0, 60.0, w / 2, h / 2, w, h), np.float64)
    pos = np.concatenate([verts * 0.4, np.ones((len(verts), 1))], axis=1)
    clips = []
    for i in range(B):
        q = np.asarray(quat_from_axis_angle(np.array([0.3, 1.0, 0.2]), 0.3 + 0.2 * i))
        x, y, z, qw = q
        rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * qw), 2 * (x * z + y * qw)],
                        [2 * (x * y + z * qw), 1 - 2 * (x * x + z * z), 2 * (y * z - x * qw)],
                        [2 * (x * z - y * qw), 2 * (y * z + x * qw), 1 - 2 * (x * x + y * y)]])
        mtx = np.eye(4)
        mtx[:3, :3] = rot
        mtx[:3, 3] = [0.07 * i - 0.05, 0.03, -3.0]
        clips.append(pos @ (proj @ mtx).T)
    return (np.stack(clips).astype(np.float32), faces.astype(np.int32),
            np.asarray(build_edge_adjacency(faces)), (verts * 0.5 + 0.5).astype(np.float32))


SCENE = _scene()


def _jax_rast():
    pos_clip, tri, _, _ = SCENE
    rast, db = j_rasterize(jnp.asarray(pos_clip), jnp.asarray(tri), RES, impl="reference")
    return np.asarray(rast), np.asarray(db)


RAST, RAST_DB = _jax_rast()


def _weights(shape, seed):
    return np.random.default_rng(seed).uniform(0.5, 1.5, shape).astype(np.float32)


def _close_pos_grad(got, want):
    scale = np.abs(want).max(axis=-1, keepdims=True)
    err = np.abs(got - want)
    assert np.all(err <= 1e-6 + 2e-4 * np.abs(want) + 1e-6 * scale), err.max()


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("diff_attrs", [None, "all", [0, 2]])
def test_torch_interpolate_matches_reference(batched, diff_attrs):
    _, tri, _, colors = SCENE
    attr = np.broadcast_to(colors, (B,) + colors.shape) * np.float32(1.1) if batched else colors
    attr = np.ascontiguousarray(attr, np.float32)
    n_da = 0 if diff_attrs is None else 2 * (3 if diff_attrs == "all" else len(diff_attrs))
    w_out = _weights((B,) + RES + (3,), 1)
    w_da = _weights((B,) + RES + (n_da,), 2)

    def j_loss(a, r, d):
        out, da = j_interpolate(a, r, jnp.asarray(tri), d, diff_attrs)
        total = jnp.sum(out * w_out)
        return total if da is None else total + jnp.sum(da * w_da)

    args = (jnp.asarray(attr), jnp.asarray(RAST), jnp.asarray(RAST_DB))
    j_out, j_da = j_interpolate(args[0], args[1], jnp.asarray(tri), args[2], diff_attrs)
    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(*args)

    leaves = [torch.tensor(a, requires_grad=True) for a in (attr, RAST, RAST_DB)]
    out, da = interpolate(leaves[0], leaves[1], tri, leaves[2], diff_attrs)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-6)
    total = (out * torch.tensor(w_out)).sum()
    if diff_attrs is None:
        assert da is None and j_da is None
    else:
        assert da.shape == (B,) + RES + (n_da,)
        np.testing.assert_allclose(da.detach().numpy(), np.asarray(j_da), rtol=1e-5, atol=1e-6)
        total = total + (da * torch.tensor(w_da)).sum()
    grads = torch.autograd.grad(total, leaves, allow_unused=True)
    for name, g, jg in zip(("attr", "rast", "rast_db"), grads, j_grads):
        g = np.zeros(jg.shape, np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(jg), rtol=2e-4, atol=1e-6, err_msg=name)


def test_torch_interpolate_refuses_bad_diff_attrs():
    _, tri, _, colors = SCENE
    with pytest.raises(ValueError, match="rast_db"):
        interpolate(colors, torch.tensor(RAST), tri, None, "all")
    with pytest.raises(ValueError, match="'all'"):
        interpolate(colors, torch.tensor(RAST), tri, torch.tensor(RAST_DB), "some")


@pytest.mark.parametrize("use_adj", [False, True])
@pytest.mark.parametrize("boost", [1.0, 2.0])
def test_torch_antialias_matches_reference(use_adj, boost):
    pos_clip, tri, adj, colors = SCENE
    edge_adj = adj if use_adj else None
    color, _ = j_interpolate(jnp.asarray(colors), jnp.asarray(RAST), jnp.asarray(tri))
    color = np.asarray(color)
    w = _weights((B,) + RES + (3,), 3)

    def j_loss(c, p):
        out = j_antialias(c, jnp.asarray(RAST), p, jnp.asarray(tri), boost,
                          None if edge_adj is None else jnp.asarray(edge_adj))
        return jnp.sum(out * w), out

    (_, j_out), j_grads = jax.value_and_grad(j_loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(color), jnp.asarray(pos_clip))

    c, p = (torch.tensor(a, requires_grad=True) for a in (color, pos_clip))
    out = antialias(c, torch.tensor(RAST), p, tri, boost, edge_adj)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=1e-5, atol=1e-6)
    assert (out.detach().numpy() != color).sum() > 50  # edges blended
    g_c, g_p = torch.autograd.grad((out * torch.tensor(w)).sum(), (c, p))
    np.testing.assert_allclose(g_c.numpy(), np.asarray(j_grads[0]), rtol=2e-4, atol=1e-6)
    assert np.abs(np.asarray(j_grads[1])).max() > 0.1
    _close_pos_grad(g_p.numpy(), np.asarray(j_grads[1]))


def test_torch_antialias_boost_scales_only_the_position_gradient():
    pos_clip, tri, adj, colors = SCENE
    color, _ = interpolate(colors, torch.tensor(RAST), tri)
    grads = {}
    for boost in (1.0, 2.0):
        c, p = (torch.tensor(a, requires_grad=True) for a in (color.numpy(), pos_clip))
        out = antialias(c, torch.tensor(RAST), p, tri, boost, adj)
        grads[boost] = torch.autograd.grad(out.sum(), (c, p))
    assert torch.equal(grads[1.0][0], grads[2.0][0])
    torch.testing.assert_close(grads[2.0][1], 2.0 * grads[1.0][1])


def test_torch_api_path_matches_reference():
    """rasterize (the binned route: K8's plain twin) -> interpolate with
    rast_db -> antialias of the mask with edge_adj -> L1 against a target,
    and its gradient to the clip positions, against the JAX package's."""
    pos_clip, tri, adj, colors = SCENE
    target = _weights((B,) + RES + (3,), 4) - 0.5
    tile = (16, 32)

    def j_path(p):
        rast, db = j_rasterize(p, jnp.asarray(tri), RES, impl="pallas", tile_hw=tile,
                               interpret=True)
        rgb, da = j_interpolate(jnp.asarray(colors), rast, jnp.asarray(tri), db, "all")
        mask = j_antialias((rast[..., 3:4] > 0).astype(jnp.float32), rast, p,
                           jnp.asarray(tri), edge_adj=jnp.asarray(adj))
        loss = jnp.mean(jnp.abs(rgb - target)) + jnp.mean(jnp.abs(mask - target[..., :1]))
        return loss + 1e-3 * jnp.mean(jnp.abs(da)), rast

    (j_val, j_rast), j_grad = jax.value_and_grad(j_path, has_aux=True)(jnp.asarray(pos_clip))

    p = torch.tensor(pos_clip, requires_grad=True)
    rast, db = rasterize(p, tri, RES, impl="pallas", tile_hw=tile)
    rgb, da = interpolate(colors, rast, tri, db, "all")
    mask = antialias((rast[..., 3:4] > 0).float(), rast, p, tri, edge_adj=adj)
    t = torch.tensor(target)
    loss = (rgb - t).abs().mean() + (mask - t[..., :1]).abs().mean() + 1e-3 * da.abs().mean()
    (g,) = torch.autograd.grad(loss, p)
    np.testing.assert_array_equal(rast[..., 3].detach().numpy(), np.asarray(j_rast[..., 3]))
    np.testing.assert_allclose(float(loss.detach()), float(j_val), rtol=1e-5)
    _close_pos_grad(g.numpy(), np.asarray(j_grad))
