"""The two premises the pack backward (K2) and the fused loss forward (K5)
rely on to skip work, held in both packages on the CPU, and the bytes
their bounds count (``kernels/check.py``).

(a) K2 skips the slots whose degenerate flag is set (sentinel slots,
degenerate triangles): their keep factor is 0, so each of their terms is
+-0.  The pose gradient of the pack must then be the same, bit for bit,
whatever finite cotangent those slots carry: the port's plain pack
autograd (``pack_binned_auto`` on CPU tensors) and the JAX Pallas pack
(``pack_binned_pallas``, interpret mode), on the test scene's uniform-K
table and on the random problem of ``test_torch_pack_kernel``.

(b) K5 evaluates only silhouette pairs (one pixel foreground, the other
not): on a pair of two foreground pixels the mask colour is 1 on both
sides, so its deltas are +-0 and the antialiased mask does not change.
The sums must then be the same, bit for bit, with every foreground id
replaced by 1 (which turns every such pair inactive): the port's
``loss_sums_plain`` and the JAX ``fused_loss_sums`` (interpret mode), on
the windows of ``test_torch_fused_loss`` and on one whose rows and columns
run past the real frame and whose width is no multiple of K5's tile,
without and with the depth plane.
"""

import numpy as np
import pytest
import torch

from test_torch_fused_loss import WINDOWS, _inputs
from test_torch_pack_kernel import _inputs_random, _port_pack
from torch_scene import RES, jax_scene, jax_uniform_table

from diffdope_tpu_torch.kernels.check import pack_bwd_bytes
from diffdope_tpu_torch.render import fused_loss as tf
from diffdope_tpu_torch.render import pack_kernel as tpk
from diffdope_tpu_torch.render.planar import static_pack_rows
from torch_scene import one_torch_thread  # noqa: F401

#: a window of the padded frame whose last 8 rows and 8 columns lie past
#: the real (64, 96) frame; 84 columns, no multiple of K5's 16-pixel tile
#: (the JAX kernel's slab height, 48 rows, stays a multiple of 8)
PAST_FRAME = (24, 20, 48, 84)


def _inputs_uniform():
    """The pack inputs of the test scene's uniform-K table (16x16 tiles)
    at its initial poses: mostly sentinel slots past each tile's count."""
    import jax.numpy as jnp

    from diffdope_tpu.render.planar import _silhouette_planar

    sc, ref = jax_scene(), jax_uniform_table()
    t_count = sc["tri"].shape[0]
    mvp = jnp.einsum("ij,bjk->bik", sc["proj"], jnp.asarray(sc["mtx0"]),
                     precision="highest")
    return dict(pos_c=sc["pos"][sc["tri"].reshape(-1)], mvp=np.asarray(mvp),
                mtx=sc["mtx0"], flat=ref["idx"].reshape(-1).astype(np.int32),
                attrs=sc["vtx_color"][sc["tri"].reshape(-1)].reshape(t_count, 3, 3),
                sil=np.asarray(_silhouette_planar(jnp.asarray(ref["det"]), sc["edge_adj"]),
                               np.float32),
                degen=np.zeros(t_count, bool), t_count=t_count)


def _dead(x):
    """The slots whose degenerate flag is set: sentinels and degenerate
    triangles."""
    flat, t = x["flat"], x["t_count"]
    return (flat >= t) | x["degen"][np.minimum(flat, t - 1)]


@pytest.mark.parametrize("case", ["uniform", "random_rgb", "random_no_attrs"])
def test_k2_premise_degenerate_slots_add_nothing(case):
    x = {"uniform": _inputs_uniform,
         "random_rgb": lambda: _inputs_random(3),
         "random_no_attrs": lambda: _inputs_random(0)}[case]()
    b, n = x["mvp"].shape[0], x["flat"].shape[0]
    dead = _dead(x)
    assert 0 < dead.sum() < n
    if case.startswith("random"):
        assert (x["flat"] < x["t_count"])[dead].any()  # degenerate triangles too
    g = np.random.default_rng(11).normal(size=(b, 32, n)).astype(np.float32)
    g0 = g.copy()
    g0[:, :, dead] = 0.0
    for run in (_port_grads, _jax_grads):
        full, zeroed = run(x, (g, g0))
        assert np.abs(full[0]).max() > 0
        for got, want in zip(zeroed, full):
            np.testing.assert_array_equal(got, want, err_msg=run.__name__)


def _port_grads(x, gs):
    """The port's (d_mvp, d_mtx) under each cotangent of ``gs``."""
    return [(r["d_mvp"], r["d_mtx"]) for r in (_port_pack(x, g) for g in gs)]


def _jax_grads(x, gs):
    """The reference's (d_mvp, d_mtx) of one Pallas pack forward under each
    cotangent of ``gs``."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render import pack_kernel as jpk

    t_count, flat = x["t_count"], jnp.asarray(x["flat"])
    tab, n_ch = jpk._static_table(
        jnp.asarray(x["pos_c"]), None if x["attrs"] is None else jnp.asarray(x["attrs"]),
        jnp.asarray(x["degen"]), flat, t_count)
    sil_b = jnp.take(jnp.asarray(x["sil"]), jnp.minimum(flat, t_count - 1),
                     axis=1).astype(jnp.float32)
    _, vjp = jax.vjp(lambda m, p: jpk.pack_binned_pallas(m, p, tab, sil_b, n_ch, True),
                     jnp.asarray(x["mvp"]), jnp.asarray(x["mtx"]))
    return [tuple(np.asarray(d) for d in vjp(jnp.asarray(g))) for g in gs]


def _windowed(window):
    """_inputs of a window; PAST_FRAME pads the padded frame with zeros
    (ids 0) below, as the raster leaves the window past the frame."""
    if window != PAST_FRAME:
        return _inputs(window)
    rows, ids, gt6, dplane, _, _, _ = _inputs(None)
    oy, ox, hc, wc = window
    pad = oy + hc - rows.shape[2]
    rows, ids, gt6, dplane = (
        np.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, pad), (0, 0)]) for a in (rows, ids, gt6, dplane))
    crop = np.s_[..., oy: oy + hc, ox: ox + wc]
    roi = (oy, ox) + RES
    return (np.ascontiguousarray(rows[crop]), np.ascontiguousarray(ids[crop]),
            np.ascontiguousarray(gt6[crop]), np.ascontiguousarray(dplane[crop]),
            (hc, wc), roi, roi)


@pytest.mark.parametrize("depth", [False, True], ids=["mask_rgb", "depth"])
@pytest.mark.parametrize("window", sorted(WINDOWS) + ["past_frame"])
def test_k5_premise_foreground_pairs_add_nothing(window, depth):
    import jax.numpy as jnp

    from diffdope_tpu.render.fused_loss import fused_loss_sums

    rows, ids, gt6, dplane, res, jroi, troi = _windowed(
        PAST_FRAME if window == "past_frame" else WINDOWS[window])
    if window == "past_frame":
        vh, vw = RES[0] - troi[0], RES[1] - troi[1]
        assert vh < ids.shape[1] and vw < ids.shape[2] and ids.shape[2] % 16
        assert (ids[:, :vh, :vw] > 0).any()
    one = np.where(ids > 0, 1, 0).astype(ids.dtype)
    # pairs of two foreground pixels on different triangles: what changes
    fg = ids > 0
    assert ((fg[:, :, 1:] & fg[:, :, :-1]) & (ids[:, :, 1:] != ids[:, :, :-1])).any()
    dpl = dplane if depth else None
    port = [tf.loss_sums_plain(torch.tensor(rows), torch.tensor(i), torch.tensor(gt6), troi,
                               None if dpl is None else torch.tensor(dpl)).numpy()
            for i in (ids, one)]
    ref = [np.asarray(fused_loss_sums(jnp.asarray(rows), jnp.asarray(i), jnp.asarray(gt6),
                                      None if dpl is None else jnp.asarray(dpl), None,
                                      res, 4, True, jroi))
           for i in (ids, one)]
    assert port[0][:, 0].min() > 1.0
    np.testing.assert_array_equal(port[0], port[1])
    np.testing.assert_array_equal(ref[0], ref[1])
    np.testing.assert_allclose(port[0], ref[0], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("n_ch", [3, 2])
def test_k2_bound_counts_the_live_slots(n_ch):
    """K2's bytes: the degenerate row of every slot; the static rows and,
    per hypothesis, the 16 + 3 n_ch cotangent lanes of the slots whose
    flag is clear; the scalars in and the sums out — counted here from
    the pack inputs, not from the table's flag row."""
    x = _inputs_random(n_ch, n=1000)
    b, n = x["mvp"].shape[0], x["flat"].shape[0]
    pos_c, attrs = torch.tensor(x["pos_c"]), torch.tensor(x["attrs"])
    degen = torch.tensor(x["degen"])
    tab, got_ch = tpk._static_table(torch.tensor(x["flat"]), x["t_count"],
                                    static_pack_rows(pos_c, attrs, degen))
    assert got_ch == n_ch
    live = n - int(_dead(x).sum())
    assert 0 < live < n
    want = 4 * n + 4 * live * (3 * 3 + 3 * n_ch) + 4 * b * live * (13 + 3 * n_ch + 3) \
        + 4 * b * (20 + 19)
    assert pack_bwd_bytes(tab, b, n_ch) == want


@pytest.mark.parametrize("depth", [False, True])
@pytest.mark.parametrize("colors", [False, True])
def test_k5_bound_counts_the_lanes_it_reads(depth, colors):
    """K5's row lanes: the edge planes and the shaded channels (3 lanes
    each) at every real foreground pixel, lanes 12 and 14 (and the edge
    planes where the lane shades nothing) at the foreground pixels of
    silhouette pairs; nothing past the real frame."""
    from diffdope_tpu_torch.kernels.check import k5_row_lanes

    ids = torch.zeros((2, 12, 16), dtype=torch.int32)
    ids[0, 3:7, 4:9] = 5  # a 4 x 5 block: 14 of its 20 pixels on its edge
    ids[1, 3:7, 4:9] = 6
    ids[1, 3:7, 6:9] = 7  # two triangles, the same silhouette
    ids[:, 10:, :] = 9  # past the frame
    ids[:, :, 14:] = 9
    roi = (0, 0, 10, 14)
    n_fg, n_edge = 2 * 20, 2 * 14
    shaded = (0 if colors else 3) + (1 if depth else 0)
    want = n_fg * (9 + 3 * shaded if shaded else 0) + n_edge * (2 + (0 if shaded else 9))
    assert k5_row_lanes(ids, roi, depth, colors) == want
