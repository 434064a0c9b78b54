"""Port parity for K10, the sorted-range raster of ``DD_RASTER=v3``:
``diffdope_tpu.render.raster_v3`` (its Pallas kernels in interpret mode)
against ``diffdope_tpu_torch.render.raster_v3`` (the plain versions, which
CPU tensors take), on the reference test's scene (tests/test_raster_v3.py:
icosphere(2), 320 triangles padded to 384 with degenerate ones, 64x96,
B = 2 poses 1% apart) and the JAX planar table fed to both.

The reference runs 32x128 tiles and 256-slot chunks, the port 16x16 tiles
and 128-slot chunks; the outputs do not depend on either, so ids and rows
are held bit for bit; d_packed at rtol 2e-4, atol 1e-6 plus 1e-6 of the
summed terms (the reference sums a slot's pixels by one-hot matmuls per
tile, the port in pixel order).  ``_prepare``'s sort and gating tables are
held to the reference's at the port's tile and chunk, and the port's v3
to its own v2 (K7 over the gathered bins) on the same table."""

import functools

import numpy as np
import pytest
import torch

from diffdope_tpu_torch.render import raster_v3 as port
from diffdope_tpu_torch.render.gather_rows import invert_bins
from diffdope_tpu_torch.render.planar import bin_triangles_planar
from diffdope_tpu_torch.render.raster import raster_bwd_plain, raster_gather_rows_v2
from torch_scene import one_torch_thread  # noqa: F401

RES = (64, 96)
B = 2
T_PAD = 384
TILE = (16, 16)
JAX_TILE = (32, 128)


@functools.lru_cache(maxsize=None)
def _scene():
    """The reference test's planar table (B, 32, 384) and its corner
    planes and determinants, as numpy."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu import geometry as geo
    from diffdope_tpu.mesh import build_edge_adjacency
    from diffdope_tpu.optimize import pose_matrix, pose_params
    from diffdope_tpu.render.planar import corner_planes, packed_planar
    from diffdope_tpu.testing import icosphere

    v, fc = icosphere(2)
    pad = T_PAD - fc.shape[0]
    fc = np.concatenate([fc, np.zeros((pad, 3), fc.dtype)])
    pos = jnp.asarray(v.astype(np.float32) * 0.4)
    tri = jnp.asarray(fc.astype(np.int32))
    edge_adj = jnp.asarray(np.concatenate(
        [build_edge_adjacency(np.asarray(fc[:320])), -np.ones((pad, 3), np.int32)]))
    vtx_color = jnp.asarray((v * 0.5 + 0.5).astype(np.float32))
    h, w = RES
    f = 1.2 * max(h, w)
    proj = jnp.asarray(geo.projection_from_intrinsics(f, f, w / 2, h / 2, w, h, 0.01, 100.0),
                       jnp.float32)
    q = geo.quat_from_axis_angle(np.array([0.2, 1.0, 0.1]), 0.8)
    params = pose_params(np.asarray(q, np.float32), np.array([0.0, 0.0, -2.0], np.float32), B)
    params = {k: val + jnp.arange(B) * 0.01 for k, val in params.items()}
    mtx, _, _ = pose_matrix(params)

    @jax.jit
    def table(mtx):
        mvp = jnp.einsum("ij,bjk->bik", proj, mtx, precision="highest")
        pos_c = pos[tri.reshape(-1)][None]
        cp = corner_planes(pos_c, mvp)
        degen = (tri[:, 0] == tri[:, 1]) | (tri[:, 1] == tri[:, 2]) | (tri[:, 2] == tri[:, 0])
        zrot = jnp.einsum("bj,bnj->bn", mtx[:, 2, :3],
                          jnp.broadcast_to(pos_c, (B,) + pos_c.shape[1:]),
                          precision="highest")
        attrs = vtx_color[tri.reshape(-1)].reshape(T_PAD, 3, 3)
        packed, det = packed_planar(cp, attrs, zrot, edge_adj, degen)
        return packed, cp, det

    packed, cp, det = table(mtx)
    return (np.asarray(packed), {k: np.asarray(c) for k, c in cp.items()},
            np.asarray(det))


def _weights():
    return np.random.default_rng(11).normal(size=(B, 32) + RES).astype(np.float32)


def test_torch_raster_v3_prepare_matches_reference():
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.raster_v3 import _prepare

    packed, _, _ = _scene()
    kc, t_pad = port._sizes(T_PAD)
    assert (kc, t_pad) == (128, T_PAD)
    want = jax.jit(lambda p: _prepare(p, RES, TILE, kc, t_pad))(jnp.asarray(packed))
    got = port._prepare(torch.tensor(packed), RES, TILE, kc, t_pad)
    names = ("order", "rank", "clo", "chi", "rlo_tc", "rhi_tc")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    tables = port.prepare(torch.tensor(packed), RES, TILE)
    assert bool(port._gate(tables, 4, 6, TILE[0]).any())


def test_torch_raster_v3_forward_matches_reference():
    import jax.numpy as jnp

    from diffdope_tpu.render.raster_v3 import raster_gather_rows_v3

    packed, _, _ = _scene()
    want_ids, want_rows = raster_gather_rows_v3(jnp.asarray(packed), RES, JAX_TILE, True,
                                                False)
    ids, rows = port.raster_gather_rows_v3(torch.tensor(packed), RES, TILE)
    assert int((ids > 0).sum()) > 500
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))


def _grad(op, packed, weights):
    p = torch.tensor(packed, requires_grad=True)
    _, rows = op(p)
    (g,) = torch.autograd.grad((rows * torch.tensor(weights)).sum(), p)
    return g.numpy()


def _scale(packed, weights):
    """Per triangle and lane, the sum of |weights| over the pixels it wins."""
    t = torch.tensor(packed)
    tables = port.prepare(t, RES, TILE)
    _, _, win = port.raster_v3_fwd_plain(port.sorted_table(t, tables), tables, RES, TILE)
    hp, wp = win.shape[1:]
    w = torch.nn.functional.pad(torch.tensor(weights).abs(),
                                (0, wp - RES[1], 0, hp - RES[0]))
    d = raster_bwd_plain(w, win, tables.t_pad)
    return d[:, :, :T_PAD].index_select(2, tables.rank).numpy()


def test_torch_raster_v3_backward_matches_reference():
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.raster_v3 import raster_gather_rows_v3

    packed, _, _ = _scene()
    weights = _weights()

    def j_loss(p):
        _, rows = raster_gather_rows_v3(p, RES, JAX_TILE, True, False)
        return jnp.sum(rows * weights)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(packed)))
    got = _grad(lambda p: port.raster_gather_rows_v3(p, RES, TILE), packed, weights)
    assert np.abs(want).max() > 0
    scale = _scale(packed, weights)
    assert np.all(np.abs(got - want) <= 1e-6 + 2e-4 * np.abs(want) + 1e-6 * scale)


def test_torch_raster_v3_equals_v2_on_the_same_table():
    """The port's v3 against its v2 route (bins of the same table at the
    port's tile, K7 over the gathered table, culling off): ids and rows bit
    for bit, d_packed at the tolerance above."""
    packed, cp, det = _scene()
    cp_t = {k: torch.tensor(c) for k, c in cp.items()}
    idx, counts, overflow = bin_triangles_planar(cp_t, torch.tensor(det), RES, TILE, T_PAD)
    assert int(overflow) == 0
    inv_pos, inv_valid = invert_bins(idx, T_PAD, "auto")

    def v2(p):
        return raster_gather_rows_v2(p, idx, counts, inv_pos, inv_valid, RES, TILE)

    def v3(p):
        return port.raster_gather_rows_v3(p, RES, TILE)

    t = torch.tensor(packed)
    for padded in (False, True):
        ids2, rows2 = raster_gather_rows_v2(t, idx, counts, inv_pos, inv_valid, RES, TILE,
                                            padded)
        ids3, rows3 = port.raster_gather_rows_v3(t, RES, TILE, padded)
        assert torch.equal(ids2, ids3) and torch.equal(rows2, rows3)
    weights = _weights()
    g2, g3 = _grad(v2, packed, weights), _grad(v3, packed, weights)
    assert np.all(np.abs(g3 - g2) <= 1e-6 + 2e-4 * np.abs(g2)
                  + 1e-6 * _scale(packed, weights))


def test_torch_raster_v3_refuses_bad_tables():
    packed, _, _ = _scene()
    t = torch.tensor(packed)
    tables = port.prepare(t, RES, TILE)
    with pytest.raises(ValueError, match="expected"):
        port.raster_v3_fwd(t[:, :, :256].contiguous(), tables, RES, TILE)
    with pytest.raises(ValueError, match="shape"):
        port.raster_v3_fwd(port.sorted_table(t, tables), tables, RES, (32, 32))
