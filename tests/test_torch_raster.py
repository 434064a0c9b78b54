"""Port parity: the compact raster forward (K3) and backward (K4) plain
versions against the JAX compact raster (raster_v2._fwd_from_bins_compact
/ _compact_dbins, interpret mode) on the same packed table."""

import numpy as np
import pytest
import torch

from torch_scene import B, JAX_TILE_HW, RES, jax_compact_table

from diffdope_tpu_torch.render import raster as tr
from torch_scene import one_torch_thread  # noqa: F401


def _port_fwd(ref):
    hp, wp = ref["ids"].shape[1:]
    return tr.raster_fwd(
        torch.tensor(ref["packed"]), torch.tensor(ref["counts"]),
        torch.tensor(ref["off_c"]), torch.tensor(ref["used"]), ref["k_chunk"],
        (hp, wp), JAX_TILE_HW, (0, 0) + RES,
    )


def test_torch_raster_fwd_ids_and_rows_exact():
    """Same table in, exactly the same ids and rows out: the coverage, z and
    tie-break arithmetic is the reference's, operation for operation."""
    ref = jax_compact_table()
    ids, rows, win = _port_fwd(ref)
    h, w = RES
    assert int((ref["ids"] > 0).sum()) > 1000  # the sphere is on screen
    np.testing.assert_array_equal(ids.numpy()[:, :h, :w], ref["ids"][:, :h, :w])
    np.testing.assert_array_equal(rows.numpy()[..., :h, :w], ref["rows"][..., :h, :w])
    # the winner slot holds the winner triangle
    lane13 = torch.tensor(ref["packed"])[:, 13]
    fg = win >= 0
    got = torch.gather(lane13, 1, win.clamp(min=0).reshape(B, -1)).reshape(win.shape)
    np.testing.assert_array_equal((got[fg] + 1).numpy(), ids[fg].numpy())
    assert torch.equal(fg, ids > 0)


def test_torch_raster_bwd_per_triangle():
    """d_bins of the plain K4 against the JAX compact backward, reduced per
    triangle via lane 13 (the slot order of the two tables may differ in
    general; here both are per slot too)."""
    import jax.numpy as jnp

    from diffdope_tpu.render.raster_v2 import _compact_dbins

    ref = jax_compact_table()
    ids, rows, win = _port_fwd(ref)
    hp, wp = ids.shape[1:]
    d_rows = np.random.default_rng(5).normal(size=(B, 32, hp, wp)).astype(np.float32)
    tot = ref["packed"].shape[2]
    tids = jnp.broadcast_to(jnp.asarray(ref["packed"][0:1, 13:14, :]), (1, 8, tot))
    d_ref = np.asarray(_compact_dbins(
        jnp.asarray(d_rows), jnp.asarray(ref["ids_cm"]), tids,
        jnp.asarray(ref["counts"]), jnp.asarray(ref["off_c"]),
        jnp.asarray(ref["used"]), jnp.asarray(ref["bounds"]), RES, JAX_TILE_HW,
        True, True,
    ))
    d_port = tr.raster_bwd(torch.tensor(d_rows), win, tot, JAX_TILE_HW,
                           torch.tensor(ref["off_c"]), torch.tensor(ref["used"]),
                           ref["k_chunk"]).numpy()

    tri = ref["packed"][0, 13].astype(np.int64)
    n = tri.max() + 1

    def per_triangle(d):
        out = np.zeros(d.shape[:2] + (n,), np.float64)
        for b in range(d.shape[0]):
            for k in range(d.shape[1]):
                np.add.at(out[b, k], tri, d[b, k])
        return out

    np.testing.assert_allclose(per_triangle(d_port), per_triangle(d_ref),
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(d_port, d_ref, rtol=2e-4, atol=1e-6)


def test_torch_raster_wrappers_check_inputs():
    ref = jax_compact_table()
    hp, wp = ref["ids"].shape[1:]
    args = [torch.tensor(ref[k]) for k in ("packed", "counts", "off_c", "used")]
    with pytest.raises(ValueError, match="multiple of tile"):
        tr.raster_fwd(*args, ref["k_chunk"], (hp, wp - 8), JAX_TILE_HW, (0, 0) + RES)
    with pytest.raises(TypeError):
        tr.raster_fwd(args[0].double(), *args[1:], ref["k_chunk"], (hp, wp),
                      JAX_TILE_HW, (0, 0) + RES)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tr.raster_fwd(*meta, ref["k_chunk"], (hp, wp), JAX_TILE_HW, (0, 0) + RES)
