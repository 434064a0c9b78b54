"""Port parity: the fused loss forward (K5) and backward (K6) plain
versions against the JAX fused loss (fused_loss_sums / backward_pass,
interpret mode) on the same rows and ids, full frame and ROI crop."""

import numpy as np
import pytest
import torch

from torch_scene import RES, jax_compact_table, jax_scene

from diffdope_tpu_torch.render import fused_loss as tf

D_SUMS = np.asarray([[1.0, 0.7, 0.0], [0.5, 1.3, 0.0], [2.0, 0.2, 0.0]], np.float32)
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
    rows, ids = ref["rows"], ref["ids"]
    if window is None:
        return rows, ids, gt6, RES, None, (0, 0, h, w)
    oy, ox, hc, wc = window
    crop = np.s_[..., oy : oy + hc, ox : ox + wc]
    roi = (oy, ox, h, w)
    return (np.ascontiguousarray(rows[crop]), np.ascontiguousarray(ids[crop]),
            np.ascontiguousarray(gt6[crop]), (hc, wc), roi, roi)


@pytest.fixture(scope="module", params=sorted(WINDOWS))
def case(request):
    """JAX reference sums and d_rows, computed once per window."""
    import jax.numpy as jnp

    from diffdope_tpu.render.fused_loss import backward_pass, fused_loss_sums

    rows, ids, gt6, res, jroi, troi = _inputs(WINDOWS[request.param])
    args = (jnp.asarray(rows), jnp.asarray(ids), jnp.asarray(gt6), None, None,
            res, 4)
    sums = fused_loss_sums(*args, True, jroi)
    d_rows, _, _ = backward_pass(*args, True, jnp.asarray(D_SUMS), roi=jroi)
    return dict(rows=rows, ids=ids, gt6=gt6, roi=troi,
                sums=np.asarray(sums), d_rows=np.asarray(d_rows))


def test_torch_loss_sums_match(case):
    sums = tf.loss_sums(torch.tensor(case["rows"]), torch.tensor(case["ids"]),
                        torch.tensor(case["gt6"]), case["roi"])
    assert case["sums"][:, 0].min() > 10.0  # silhouettes disagree: real terms
    np.testing.assert_allclose(sums.numpy(), case["sums"], rtol=1e-5, atol=1e-7)


def test_torch_loss_rows_gradient_match(case):
    d_rows = tf.loss_bwd(torch.tensor(case["rows"]), torch.tensor(case["ids"]),
                         torch.tensor(case["gt6"]), case["roi"],
                         torch.tensor(D_SUMS))
    ref = case["d_rows"]
    assert np.abs(ref[:, :9]).max() > 0 and np.abs(ref[:, 16:25]).max() > 0
    # rtol 2e-4, atol 1e-6, plus 1e-6 of the pixel's largest lane: a lane
    # that sums cancelling terms (the rgb term through s and the pair terms,
    # up to ~1e3 here) keeps the f32 rounding of its largest term, which is
    # what the two autodiffs order differently
    scale = np.abs(ref).max(axis=1, keepdims=True)
    err = np.abs(d_rows.numpy() - ref)
    assert np.all(err <= 1e-6 + 2e-4 * np.abs(ref) + 1e-6 * scale), err.max()
