"""The triangle-indexed gathers of ``interpolate`` and ``antialias``
(``rasterize.IndexRows``): their backward sums each row's cotangents in
ascending entry order, over the entries the op does not mask, with the
segmented sum on the card and ``index_add_`` on the CPU, so the card's
gradient repeats bit for bit.  Held here, on the CPU:

- ``IndexRows``' gradient is the sum in ascending order, bit for bit, of
  the valid entries' cotangents, and equals autograd's gather backward
  bit for bit when the other entries' cotangents are zero;
- interpolate's and antialias's gradients through the new gathers, in one
  chain (rasterize's brute force -> interpolate of per-vertex colours
  that take a gradient -> antialias with edge adjacency and a position
  boost -> L1), against the JAX package's at rtol 2e-4, atol 1e-6 (the
  clip positions' plus 1e-6 of the vertex's largest component, as in
  tests/test_torch_api_ops.py), on icosphere(2) at 48x64 under three poses
  and on the same mesh at batched (B, N, C) colours.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_api_ops import RES, SCENE, _close_pos_grad, _weights

from diffdope_tpu.render.antialias import antialias as j_antialias
from diffdope_tpu.render.interpolate import interpolate as j_interpolate
from diffdope_tpu.render.rasterize import rasterize as j_rasterize
from diffdope_tpu_torch.render.antialias import antialias
from diffdope_tpu_torch.render.interpolate import interpolate
from diffdope_tpu_torch.render.rasterize import IndexRows, rasterize
from torch_scene import one_torch_thread  # noqa: F401


def test_torch_index_rows_sums_valid_entries_in_order():
    rng = np.random.default_rng(0)
    b, n, p, w = 3, 7, 200, 5
    src = torch.tensor(rng.normal(size=(b, n, w)).astype(np.float32), requires_grad=True)
    idx = torch.tensor(rng.integers(0, n, size=(b, p)))
    valid = torch.tensor(rng.uniform(size=(b, p)) < 0.7)
    d = torch.tensor(rng.normal(size=(b, p, w)).astype(np.float32))
    out = IndexRows.apply(src, idx, valid)
    assert torch.equal(out, src.gather(1, idx[..., None].expand(-1, -1, w)))
    (g,) = torch.autograd.grad(out, src, d)
    want = torch.zeros((b, n, w))
    for bi in range(b):
        for q in range(p):  # ascending entries, one f32 add each
            if valid[bi, q]:
                want[bi, idx[bi, q]] = want[bi, idx[bi, q]] + d[bi, q]
    assert torch.equal(g, want)
    # with the masked entries' cotangents zero: autograd's gather backward
    dz = torch.where(valid[..., None], d, 0.0)
    (g_gather,) = torch.autograd.grad(src.gather(1, idx[..., None].expand(-1, -1, w)), src, dz)
    assert torch.equal(g, g_gather)


@pytest.mark.parametrize("batched", [False, True])
def test_torch_api_chain_gradients_through_the_gathers_match_reference(batched):
    pos_clip, tri, adj, colors = SCENE
    b = pos_clip.shape[0]
    attr = (np.broadcast_to(colors, (b,) + colors.shape) * np.float32(0.9) if batched
            else colors)
    attr = np.ascontiguousarray(attr, np.float32)
    w = _weights((b,) + RES + (3,), 7)

    def j_chain(p, a):
        rast, db = j_rasterize(p, jnp.asarray(tri), RES, impl="reference")
        rgb, da = j_interpolate(a, rast, jnp.asarray(tri), db, "all")
        out = j_antialias(rgb, rast, p, jnp.asarray(tri), 1.5, jnp.asarray(adj))
        return jnp.sum(jnp.abs(out - 0.5) * w) + 1e-3 * jnp.sum(jnp.abs(da))

    j_val, j_grads = jax.value_and_grad(j_chain, argnums=(0, 1))(jnp.asarray(pos_clip),
                                                                 jnp.asarray(attr))
    p, a = (torch.tensor(v, requires_grad=True) for v in (pos_clip, attr))
    rast, db = rasterize(p, tri, RES, impl="reference")
    rgb, da = interpolate(a, rast, tri, db, "all")
    out = antialias(rgb, rast, p, tri, 1.5, adj)
    val = ((out - 0.5).abs() * torch.tensor(w)).sum() + 1e-3 * da.abs().sum()
    g_p, g_a = torch.autograd.grad(val, (p, a))
    np.testing.assert_allclose(float(val.detach()), float(j_val), rtol=1e-5)
    assert np.abs(np.asarray(j_grads[1])).max() > 0.1
    np.testing.assert_allclose(g_a.numpy(), np.asarray(j_grads[1]), rtol=2e-4, atol=1e-6)
    _close_pos_grad(g_p.numpy(), np.asarray(j_grads[0]))
