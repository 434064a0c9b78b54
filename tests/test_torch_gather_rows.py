"""Port parity for K9 (the v1 raster + row gather) and the inverted bin
map: ``diffdope_tpu.render.gather_rows`` (its Pallas kernels in interpret
mode) against ``diffdope_tpu_torch.render.gather_rows`` (the plain
versions, which CPU tensors take) on the reference tests' scenes
(tests/test_gather_rows.py): random clip-space triangles over a 32x128
frame, 8x128 tiles, K = 64, the JAX bins and packed rows fed to both.

ids and rows are held exactly (the same f32 operation order, the same
bins); d_packed at rtol 2e-4, atol 1e-6 plus 1e-6 of the summed terms (the
reference sums a slot's pixels by one-hot matmuls row by row, the port in
pixel order, then both add a triangle's slots); ``invert_bins`` and
``bin_occupancy`` array for array."""

import numpy as np
import pytest
import torch

from diffdope_tpu_torch.render import gather_rows as port
from torch_scene import one_torch_thread  # noqa: F401

RES = (32, 128)
TILE = (8, 128)


def _scene(seed, b_extra=False):
    """The reference test's scene, with the packed rows' lanes 14-31 made
    random so that the row gather moves real values."""
    from tests.test_gather_rows import _setup_scene

    pos, tri, setup, packed, idx, counts, _, _ = _setup_scene(seed=seed, b_extra=b_extra)
    packed = np.array(packed)
    rng = np.random.default_rng(seed)
    packed[..., 14:] = rng.normal(size=packed[..., 14:].shape).astype(np.float32)
    return (tri.shape[0], np.asarray(setup.coef), packed, np.asarray(idx, np.int32),
            np.asarray(counts, np.int32))


def _port_inputs(packed, idx, counts, t_count, max_occ=16):
    idx_t = torch.tensor(idx)
    inv_pos, inv_valid = port.invert_bins(idx_t, t_count, max_occ)
    return torch.tensor(packed), idx_t, torch.tensor(counts), inv_pos, inv_valid


@pytest.mark.parametrize("max_occ", [16, 1, "auto"])
def test_torch_invert_bins_matches_reference(max_occ):
    import jax.numpy as jnp

    from diffdope_tpu.render.gather_rows import bin_occupancy, invert_bins

    t_count, _, _, idx, _ = _scene(2)
    want_pos, want_valid = invert_bins(jnp.asarray(idx), t_count, max_occ)
    got_pos, got_valid = port.invert_bins(torch.tensor(idx), t_count, max_occ)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert int(port.bin_occupancy(torch.tensor(idx), t_count)) == int(
        bin_occupancy(jnp.asarray(idx), t_count))
    if max_occ == 1:
        assert int(port.bin_occupancy(torch.tensor(idx), t_count)) > 1  # truncates


@pytest.mark.parametrize("seed,b_extra", [(0, False), (1, True)])
def test_torch_gather_rows_forward_matches_reference(seed, b_extra):
    import jax.numpy as jnp

    from diffdope_tpu.render.gather_rows import invert_bins, raster_gather_rows
    from diffdope_tpu.render.rasterize import raster_ids_reference

    t_count, coef, packed, idx, counts = _scene(seed, b_extra)
    inv = invert_bins(jnp.asarray(idx), t_count)
    want_ids, want_rows = raster_gather_rows(jnp.asarray(packed), jnp.asarray(idx),
                                             jnp.asarray(counts), *inv, RES, TILE, True)
    ids, rows = port.raster_gather_rows(*_port_inputs(packed, idx, counts, t_count),
                                        RES, TILE)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    # the reference's own check: the brute force finds the same ids
    np.testing.assert_array_equal(ids.numpy(), np.asarray(raster_ids_reference(
        jnp.asarray(coef), RES)))
    fg = ids.numpy() > 0
    assert fg.sum() > 200
    if b_extra:
        assert (ids[0] != ids[1]).any()


def _scale(d_rows, win, num_tiles, k, inv_pos, inv_valid):
    """Per triangle and lane, the sum of |d_rows| over the pixels it wins."""
    d_bin = port.gather_rows_bwd_plain(d_rows.abs(), win, num_tiles, k)
    return port.inverted_sum(d_bin.reshape(d_bin.shape[0], -1, 32), inv_pos, inv_valid)


def test_torch_gather_rows_backward_matches_reference():
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.gather_rows import invert_bins, raster_gather_rows

    t_count, _, packed, idx, counts = _scene(3, b_extra=True)
    b = packed.shape[0]
    weights = np.random.default_rng(5).normal(size=(b, 32) + RES).astype(np.float32)
    inv = invert_bins(jnp.asarray(idx), t_count)

    def j_loss(p):
        _, rows = raster_gather_rows(p, jnp.asarray(idx), jnp.asarray(counts), *inv,
                                     RES, TILE, True)
        return jnp.sum(rows * weights)

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(packed)))
    packed_t, idx_t, counts_t, inv_pos, inv_valid = _port_inputs(packed, idx, counts,
                                                                 t_count)
    p = packed_t.clone().requires_grad_(True)
    _, rows = port.raster_gather_rows(p, idx_t, counts_t, inv_pos, inv_valid, RES, TILE)
    (got,) = torch.autograd.grad((rows * torch.tensor(weights)).sum(), p)
    assert np.abs(want).max() > 0
    _, _, win = port.gather_rows_fwd_plain(packed_t, idx_t, counts_t, RES, TILE)
    scale = _scale(torch.tensor(weights), win, idx.shape[0], idx.shape[1], inv_pos,
                   inv_valid).numpy()
    assert np.all(np.abs(got.numpy() - want) <= 1e-6 + 2e-4 * np.abs(want) + 1e-6 * scale)


def test_torch_gather_rows_truncates_past_max_occ():
    """The reference's sizing case (tests/test_gather_rows.py:105-163): one
    triangle over 16 tiles; 'auto' keeps every tile's contribution to the
    det lane's gradient (the covered pixel count), a fixed M = 4 loses
    some, and both equal the reference's."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.gather_rows import invert_bins, raster_gather_rows
    from diffdope_tpu.render.setup_tris import bin_triangles, triangle_setup
    from diffdope_tpu.render.shade import pack_rows, silhouette_bits

    pos = jnp.asarray([[-3.0, -3.0, 0.2, 1.0], [3.0, -1.0, 0.2, 1.0],
                       [0.0, 3.0, 0.2, 1.0]], jnp.float32)[None]
    tri = jnp.asarray([[0, 1, 2]], jnp.int32)
    setup = triangle_setup(pos, tri)
    res, tile = (32, 512), (8, 128)
    idx, counts, _ = bin_triangles(pos[:, tri], setup.det, res, tile, 8)
    packed = pack_rows(setup, silhouette_bits(setup.det, None),
                       jnp.zeros(setup.det.shape + (4, 3)))
    assert int(port.bin_occupancy(torch.tensor(np.asarray(idx)), 1)) == 16
    for m in ("auto", 4):
        def j_total(p):
            _, rows = raster_gather_rows(p, idx, counts, *invert_bins(idx, 1, m), res,
                                         tile, True)
            return jnp.sum(rows[:, 12])

        want = float(jax.grad(j_total)(packed)[0, 0, 12])
        inputs = _port_inputs(np.asarray(packed), np.asarray(idx, np.int32),
                              np.asarray(counts, np.int32), 1, m)
        p = inputs[0].clone().requires_grad_(True)
        ids, rows = port.raster_gather_rows(p, *inputs[1:], res, tile)
        (got,) = torch.autograd.grad(rows[:, 12].sum(), p)
        n_fg = float((ids > 0).sum())
        assert float(got[0, 0, 12]) == want
        if m == "auto":
            assert want == n_fg > 0
        else:
            assert want < n_fg
