"""Port parity: the uniform-K raster (K7) forward and backward plain
versions against the JAX uniform raster (raster_v2.raster_gather_rows_binned,
interpret mode) on the same packed table, at the port's 16x16 tile.

The JAX binning at a 16-wide tile splits the frame into 128-wide
super-tiles of eight sub-tiles, the width padded to 128 (96 -> 128 here):
its tiles are the port's in the same row-major order, with two padding
columns of tiles per tile row added.  The first test holds the two binnings
to that map; the others feed the port the reference's table with the
padding tiles dropped."""

import numpy as np
import pytest
import torch

from torch_scene import B, MAX_K, PORT_TILE_HW, RES, jax_uniform_table

from diffdope_tpu_torch.render import planar as tp
from diffdope_tpu_torch.render import raster as tr
from torch_scene import one_torch_thread  # noqa: F401

NTY, NTX = -(-RES[0] // 16), -(-RES[1] // 16)  # the port's tile grid, 4 x 6


def _to_port(a, k):
    """A reference per-tile array (..., nty * ntx_ref * k) -> the port's
    tiles (..., nty * ntx * k), and what it held in the padding tiles."""
    lead = a.shape[:-1]
    a = a.reshape(lead + (NTY, -1, k))
    return (np.ascontiguousarray(a[..., :NTX, :]).reshape(lead + (-1,)),
            a[..., NTX:, :])


def _port_table():
    ref = jax_uniform_table()
    k = ref["idx"].shape[1]
    packed, _ = _to_port(ref["packed"], k)
    counts, _ = _to_port(ref["counts"], 1)
    return ref, k, torch.tensor(packed), torch.tensor(counts)


def test_torch_uniform_tiles_map_to_reference():
    """The port's 16x16 bins from the reference's corner planes equal the
    reference's sub-tile bins in row-major order, its padding tiles
    dropped, slot for slot."""
    ref = jax_uniform_table()
    cp = {n: torch.tensor(v) for n, v in ref["cp"].items()}
    idx, counts, ovf = tp.bin_triangles_planar(cp, torch.tensor(ref["det"]), RES,
                                               PORT_TILE_HW, MAX_K)
    k = ref["idx"].shape[1]
    assert idx.shape == (NTY * NTX, k)
    assert int(ovf) == 0 == int(ref["overflow"])
    want_idx, _ = _to_port(ref["idx"].reshape(-1), k)
    want_counts, _ = _to_port(ref["counts"], 1)
    np.testing.assert_array_equal(idx.numpy().reshape(-1), want_idx)
    np.testing.assert_array_equal(counts.numpy(), want_counts)


def test_torch_raster_uniform_fwd_ids_and_rows_exact():
    """The reference's table in, exactly the reference's ids and rows out,
    and the winner slot holds the winner triangle."""
    ref, _, packed, counts = _port_table()
    ids, rows, win = tr.raster_uniform_fwd(packed, counts, RES, PORT_TILE_HW)
    assert ids.shape == (B,) + RES
    assert int((ref["ids"] > 0).sum()) > 1000  # the sphere is on screen
    np.testing.assert_array_equal(ids.numpy(), ref["ids"])
    np.testing.assert_array_equal(rows.numpy(), ref["rows"])
    fg = win >= 0
    got = torch.gather(packed[:, 13], 1, win.clamp(min=0).reshape(B, -1)).reshape(win.shape)
    np.testing.assert_array_equal((got[fg] + 1).numpy(), ids[fg].numpy())
    assert torch.equal(fg, ids > 0)


def test_torch_raster_uniform_bwd_matches_reference():
    """d_bins of the plain K7 backward against the reference's (its
    custom VJP, zero_tail) under a seeded cotangent: rtol 2e-4, atol 1e-6;
    the reference's padding tiles get nothing."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.raster_v2 import raster_gather_rows_binned

    ref, k, packed, counts = _port_table()
    _, _, win = tr.raster_uniform_fwd(packed, counts, RES, PORT_TILE_HW)
    d_rows = np.random.default_rng(6).normal(size=(B, 32) + RES).astype(np.float32)

    def rows_of(bins):
        return raster_gather_rows_binned(bins, jnp.asarray(ref["counts"]), RES,
                                         PORT_TILE_HW, True)[1]

    _, pull = jax.vjp(rows_of, jnp.asarray(ref["packed"]))
    d_ref, d_pad = _to_port(np.asarray(pull(jnp.asarray(d_rows))[0]), k)
    d_port = tr.raster_uniform_bwd(torch.tensor(d_rows), win, packed.shape[2],
                                   PORT_TILE_HW).numpy()
    assert np.abs(d_ref).max() > 0
    assert not d_pad.any()
    np.testing.assert_allclose(d_port, d_ref, rtol=2e-4, atol=1e-6)
    # every slot past its tile's count stays zero (the zero tail)
    slot = np.arange(packed.shape[2]) % k
    held = slot < np.repeat(counts.numpy(), k)
    assert not d_port[..., ~held].any()


def test_torch_raster_binned_autograd_and_checks():
    """RasterBinned carries the cotangent to the table through the K7
    backward, and the wrappers refuse what is no uniform table."""
    _, _, packed, counts = _port_table()
    bins = packed.clone().requires_grad_(True)
    ids, rows = tr.raster_gather_rows_binned(bins, counts, RES, PORT_TILE_HW)
    (rows * rows.detach()).sum().backward()  # the cotangent of rows is rows
    _, _, win = tr.raster_uniform_fwd(packed, counts, RES, PORT_TILE_HW)
    want = tr.raster_bwd_plain(rows.detach(), win, packed.shape[2])
    assert bins.grad.abs().max() > 0
    assert torch.equal(bins.grad, want)
    with pytest.raises(ValueError, match="uniform table"):
        tr.raster_uniform_fwd(packed[..., :-1].contiguous(), counts, RES, PORT_TILE_HW)
    with pytest.raises(ValueError, match="tiles"):
        tr.raster_uniform_fwd(packed, counts[:-1], RES, PORT_TILE_HW)
    meta = (packed.to("meta"), counts.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        tr.raster_uniform_fwd(*meta, RES, PORT_TILE_HW)


def test_torch_raster_binned_padded_frame():
    """``raster_gather_rows_binned`` returns the (h, w) frame, as the
    reference's does by default, and with ``padded=True`` the frame padded
    to whole tiles, as the raster leaves it."""
    _, _, packed, counts = _port_table()
    frame = (RES[0] - 4, RES[1] - 6)  # the same 16x16 tiles as RES
    ids, rows = tr.raster_gather_rows_binned(packed, tile_counts=counts, resolution=frame,
                                             tile_hw=PORT_TILE_HW)
    ids_p, rows_p = tr.raster_gather_rows_binned(packed, counts, frame, PORT_TILE_HW,
                                                 padded=True)
    assert tuple(ids.shape[1:]) == frame and tuple(rows.shape[2:]) == frame
    assert tuple(ids_p.shape[1:]) == RES
    assert torch.equal(ids, ids_p[:, :frame[0], :frame[1]])
    assert torch.equal(rows, rows_p[:, :, :frame[0], :frame[1]])
