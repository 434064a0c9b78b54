"""Port parity: the fused loss forward (K5) and backward (K6) plain
versions against the JAX fused loss (fused_loss_sums / backward_pass,
interpret mode) on the same rows and ids, full frame and ROI crop, without
and with the depth lane.  The depth plane is the scene's: gt depth + t_z
of each initial pose, nowhere exactly 0 where seg0 > 0 (where the two
packages' d|v|/dv rules at v = 0 could differ, ROADMAP queue 3)."""

import numpy as np
import pytest
import torch

from torch_scene import RES, jax_compact_table, jax_scene

from diffdope_tpu_torch.render import fused_loss as tf
from torch_scene import one_torch_thread  # noqa: F401

D_SUMS = np.asarray([[1.0, 0.7, 0.0], [0.5, 1.3, 0.0], [2.0, 0.2, 0.0]], np.float32)
D_SUMS_DEPTH = np.asarray([[1.0, 0.7, 0.9], [0.5, 1.3, 1.1], [2.0, 0.2, 0.4]], np.float32)
#: (oy, ox, hc, wc) crop windows of the padded (64, 128) frame
WINDOWS = {"full": None, "crop": (8, 16, 48, 80)}


def _inputs(window):
    ref = jax_compact_table()
    sc = jax_scene()
    h, w = RES
    hp, wp = ref["ids"].shape[1:]
    gt6 = np.zeros((6, hp, wp), np.float32)
    gt6[0:3, :h, :w] = np.moveaxis(sc["gt"]["segmentation"], -1, 0)
    gt6[3:6, :h, :w] = np.moveaxis(sc["gt"]["rgb"], -1, 0)
    gtd = np.zeros((hp, wp), np.float32)
    gtd[:h, :w] = sc["gt"]["depth"]
    dplane = gtd[None] + sc["mtx0"][:, 2, 3][:, None, None]
    rows, ids = ref["rows"], ref["ids"]
    if window is None:
        return rows, ids, gt6, dplane, RES, None, (0, 0, h, w)
    oy, ox, hc, wc = window
    crop = np.s_[..., oy : oy + hc, ox : ox + wc]
    roi = (oy, ox, h, w)
    return (np.ascontiguousarray(rows[crop]), np.ascontiguousarray(ids[crop]),
            np.ascontiguousarray(gt6[crop]), np.ascontiguousarray(dplane[crop]),
            (hc, wc), roi, roi)


@pytest.fixture(scope="module", params=sorted(WINDOWS))
def case(request):
    """JAX reference sums and gradients, computed once per window, without
    and with the depth plane."""
    import jax.numpy as jnp

    from diffdope_tpu.render.fused_loss import backward_pass, fused_loss_sums

    rows, ids, gt6, dplane, res, jroi, troi = _inputs(WINDOWS[request.param])
    seg0 = gt6[0][None] > 0
    assert np.abs(dplane[np.broadcast_to(seg0, dplane.shape)]).min() > 1e-3
    out = dict(rows=rows, ids=ids, gt6=gt6, dplane=dplane, roi=troi)
    for sfx, dpl, d_sums in (("", None, D_SUMS), ("_depth", jnp.asarray(dplane),
                                                   D_SUMS_DEPTH)):
        args = (jnp.asarray(rows), jnp.asarray(ids), jnp.asarray(gt6), dpl, None, res, 4)
        sums = fused_loss_sums(*args, True, jroi)
        d_rows, d_dpl, _ = backward_pass(*args, True, jnp.asarray(d_sums), roi=jroi)
        out["sums" + sfx], out["d_rows" + sfx] = np.asarray(sums), np.asarray(d_rows)
        if dpl is not None:
            out["d_dplane"] = np.asarray(d_dpl)
    return out


def _assert_rows_close(got, ref):
    # rtol 2e-4, atol 1e-6, plus 1e-6 of the pixel's largest lane: a lane
    # that sums cancelling terms (the rgb term through s and the pair terms,
    # up to ~1e3 here) keeps the f32 rounding of its largest term, which is
    # what the two autodiffs order differently
    scale = np.abs(ref).max(axis=1, keepdims=True)
    err = np.abs(got - ref)
    assert np.all(err <= 1e-6 + 2e-4 * np.abs(ref) + 1e-6 * scale), err.max()


def test_torch_loss_sums_match(case):
    sums = tf.loss_sums(torch.tensor(case["rows"]), torch.tensor(case["ids"]),
                        torch.tensor(case["gt6"]), case["roi"])
    assert case["sums"][:, 0].min() > 10.0  # silhouettes disagree: real terms
    np.testing.assert_allclose(sums.numpy(), case["sums"], rtol=1e-5, atol=1e-7)


def test_torch_loss_rows_gradient_match(case):
    d_rows, d_dplane, _ = tf.loss_bwd(torch.tensor(case["rows"]),
                                      torch.tensor(case["ids"]),
                                      torch.tensor(case["gt6"]), case["roi"],
                                      torch.tensor(D_SUMS))
    assert d_dplane is None
    ref = case["d_rows"]
    assert np.abs(ref[:, :9]).max() > 0 and np.abs(ref[:, 16:25]).max() > 0
    _assert_rows_close(d_rows.numpy(), ref)


def test_torch_loss_sums_depth_match(case):
    """The depth lane of K5's plain version: all three sums rtol 1e-5,
    atol 1e-7, the depth sum a real term."""
    sums = tf.loss_sums(torch.tensor(case["rows"]), torch.tensor(case["ids"]),
                        torch.tensor(case["gt6"]), case["roi"],
                        torch.tensor(case["dplane"]))
    assert case["sums_depth"][:, 2].min() > 1.0
    np.testing.assert_array_equal(case["sums_depth"][:, :2], case["sums"][:, :2])
    np.testing.assert_allclose(sums.numpy(), case["sums_depth"], rtol=1e-5, atol=1e-7)


def test_torch_loss_depth_gradient_match(case):
    """The depth lane of K6's plain version: d_rows as without it (its
    rotated-z lanes 25-27 now carry the depth term), d_dplane rtol 2e-4,
    atol 1e-6, on background pixels too."""
    d_rows, d_dplane, _ = tf.loss_bwd(torch.tensor(case["rows"]),
                                      torch.tensor(case["ids"]),
                                      torch.tensor(case["gt6"]), case["roi"],
                                      torch.tensor(D_SUMS_DEPTH),
                                      torch.tensor(case["dplane"]))
    ref = case["d_rows_depth"]
    assert np.abs(ref[:, 25:28]).max() > 0
    _assert_rows_close(d_rows.numpy(), ref)
    ref_dpl = case["d_dplane"]
    bg = (case["ids"] == 0) & (case["gt6"][0][None] > 0)
    assert np.abs(ref_dpl[bg]).max() > 0
    np.testing.assert_allclose(d_dplane.numpy(), ref_dpl, rtol=2e-4, atol=1e-6)
