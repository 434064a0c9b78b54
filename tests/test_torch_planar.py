"""Port parity: planar setup, binning, compaction and the bin-ordered pack
(diffdope_tpu/render/planar.py against diffdope_tpu_torch/render/planar.py)
on the JAX tests' small scene, from the same poses."""

import numpy as np
import torch

from torch_scene import COMPACT_TOTAL, JAX_TILE_HW, MAX_K, RES, jax_compact_table, jax_scene

from diffdope_tpu_torch.render import planar as tp
from torch_scene import one_torch_thread  # noqa: F401


def _port_setup():
    sc = jax_scene()
    ref = jax_compact_table()
    tri = torch.as_tensor(sc["tri"]).long()
    pos_c = torch.as_tensor(sc["pos"])[tri.reshape(-1)]
    mvp = torch.tensor(ref["mvp"])
    cp = tp.corner_planes(pos_c, mvp)
    det = tp.det_planar(cp, torch.zeros(tri.shape[0], dtype=torch.bool))
    return sc, ref, tri, pos_c, mvp, cp, det


def test_torch_binning_per_tile_sets():
    sc, ref, tri, pos_c, mvp, cp, det = _port_setup()
    # XLA's CPU fusions contract a*b + c into FMAs and its einsum sums in
    # another order; torch rounds every product.  The determinant is a sum
    # of cancelling cross products, so agreement is absolute (~1e-7 on
    # values ~0.1), not relative.
    np.testing.assert_allclose(det.numpy(), ref["det"], rtol=1e-5, atol=1e-6)
    idx, counts, ovf = tp.bin_triangles_planar(cp, det, RES, JAX_TILE_HW, MAX_K)
    np.testing.assert_array_equal(counts.numpy(), ref["counts"])
    assert int(ovf) == 0
    for t in range(counts.shape[0]):
        n = int(counts[t])
        assert set(idx[t, :n].tolist()) == set(ref["idx"][t, :n].tolist()), t
    # the y-sorted order itself is the reference's (same keys)
    np.testing.assert_array_equal(idx.numpy(), ref["idx"])


def test_torch_silhouette_and_compaction_exact():
    sc, ref, tri, pos_c, mvp, cp, det = _port_setup()
    sil = tp._silhouette_planar(det, torch.as_tensor(sc["edge_adj"]).long())
    np.testing.assert_array_equal(sil.numpy(), ref["sil"])
    flat, off_c, used, ovf = tp.compact_bins(
        torch.as_tensor(ref["idx"]), torch.as_tensor(ref["counts"]),
        tri.shape[0], ref["k_chunk"], COMPACT_TOTAL,
    )
    np.testing.assert_array_equal(flat.numpy(), ref["flat"])
    np.testing.assert_array_equal(off_c.numpy(), ref["off_c"])
    np.testing.assert_array_equal(used.numpy(), ref["used"])
    assert int(ovf) == int(ref["overflow"]) == 0


def test_torch_compaction_overflow_counts_drops():
    """A capacity below the need drops whole chunks and counts the real
    slots it dropped, as the reference does."""
    rng = np.random.default_rng(0)
    nt, k, t_count, kc, total = 5, 16, 40, 4, 32
    counts = rng.integers(0, k + 1, size=nt).astype(np.int32)
    idx = np.full((nt, k), t_count, np.int32)
    for t in range(nt):
        idx[t, : counts[t]] = rng.integers(0, t_count, size=counts[t])
    flat, off_c, used, ovf = tp.compact_bins(
        torch.as_tensor(idx), torch.as_tensor(counts), t_count, kc, total
    )
    dropped = 0
    for t in range(nt):
        want = idx[t, : -(-counts[t] // kc) * kc]
        got = flat[off_c[t] * kc : off_c[t] * kc + used[t] * kc].numpy()
        np.testing.assert_array_equal(got, want[: len(got)])
        dropped += max(int(counts[t]) - len(got), 0)
    assert int(ovf) == dropped > 0


def test_torch_packed_rows_per_slot():
    sc, ref, tri, pos_c, mvp, cp, det = _port_setup()
    t_count = tri.shape[0]
    attrs = torch.as_tensor(sc["vtx_color"])[tri.reshape(-1)].reshape(t_count, 3, 3)
    packed = tp.pack_binned(
        pos_c, mvp, torch.as_tensor(sc["mtx0"]), torch.as_tensor(ref["flat"]),
        attrs, torch.as_tensor(ref["sil"]),
        torch.zeros(t_count, dtype=torch.bool), t_count,
    )
    # same mvp and slot map on both sides; the lanes are cancelling sums of
    # products (cross products, planes), which XLA evaluates with FMAs:
    # absolute agreement ~1e-6 on O(1) lanes
    np.testing.assert_allclose(packed.numpy(), ref["packed"], rtol=1e-6, atol=2e-6)
