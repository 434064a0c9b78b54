"""Port parity for the spanning op's bf16 d_rows lane: under
DD_DROWS_BF16=1 (the reference's default, read when the loss is built)
K6 writes the d_rows cotangent in bf16, each f32 value rounded once to
nearest even, and K4 sums it in f32 (``fused_loss.RasterLossCompact``).

On the shared test scene (tests/torch_scene.py: the compact table, the
JAX side packing in XLA) the port's fused loss with the bf16 lane against
the reference's with its own: the loss rtol 1e-5, atol 1e-7; the pose
gradients within the contract's bf16 clause (atol 2e-2 of the
component's scale) and, since both round the same f32 values once, at
rtol 2e-4, atol 1e-6 (the gap is printed).  The lane's d_rows are the
plain f32 d_rows rounded to nearest even bit for bit; the lane changes
the pose gradients; DD_DROWS_BF16=0 gives the chained ops' bin gradient
bit for bit, and the variable is read only when the loss is built.
"""

import numpy as np
import pytest
import torch

from torch_scene import jax_fused_loss, jax_scene, port_fused_loss

from diffdope_tpu_torch import convert
from diffdope_tpu_torch.bench import drows_env
from diffdope_tpu_torch.optimize import pose_matrix
from diffdope_tpu_torch.render.fused_loss import (
    fused_loss_sums,
    loss_bwd,
    loss_bwd_plain,
    raster_loss_compact,
)
from diffdope_tpu_torch.render.pipeline import K_CHUNK, TILE_HW
from diffdope_tpu_torch.render.raster import raster_compact, raster_fwd
from torch_scene import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def reference():
    """The reference's value and pose gradients with its bf16 lane."""
    import jax

    from diffdope_tpu.optimize import pose_matrix as j_pose_matrix

    params = {k: jax.numpy.asarray(v) for k, v in jax_scene()["params0"].items()}
    with pytest.MonkeyPatch.context() as mp:
        fn = jax_fused_loss(mp, drows_bf16=True)
        (total, _), grads = jax.jit(jax.value_and_grad(
            lambda p: fn(j_pose_matrix(p)[0]), has_aux=True))(params)
    return np.asarray(total), {k: np.asarray(v) for k, v in grads.items()}


def _value_and_grad(fn):
    params = convert.state(jax_scene()["params0"], "cpu")
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    total, _ = fn(pose_matrix(params)[0])
    grads = torch.autograd.grad(total, list(params.values()))
    return total.detach().numpy(), {k: g.numpy() for k, g in zip(params, grads)}


@pytest.fixture(scope="module")
def port():
    """The port's fused loss under each lane, and its value and pose
    gradients."""
    fns = {lane: port_fused_loss(drows_bf16=lane) for lane in (True, False)}
    return fns, {lane: _value_and_grad(fn) for lane, fn in fns.items()}


def test_torch_drows_bf16_loss_and_grads_match_reference(reference, port):
    fns, runs = port
    assert fns[True].drows_bf16 and not fns[False].drows_bf16
    total, grads = runs[True]
    want_total, want = reference
    np.testing.assert_allclose(total, want_total, rtol=1e-5, atol=1e-7)
    gap = 0.0
    for k, g in want.items():
        scale = np.abs(g).max()
        assert scale > 0, k
        np.testing.assert_allclose(grads[k], g, rtol=0, atol=2e-2 * scale, err_msg=k)
        gap = max(gap, float(np.max(np.abs(grads[k] - g) / (1e-6 + 2e-4 * np.abs(g)))))
    print(f"bf16 lane: largest |port - reference| / (1e-6 + 2e-4 |reference|) {gap:.3e}")
    assert gap <= 1.0


def test_torch_drows_bf16_lane_changes_the_gradient(port):
    """The bf16 and the f32 lane's pose gradients differ (the lane is
    taken), within the bf16 clause of each other."""
    _, runs = port
    g16, g32 = runs[True][1], runs[False][1]
    assert any(not np.array_equal(g16[k], g32[k]) for k in g16)
    for k, g in g32.items():
        np.testing.assert_allclose(g16[k], g, rtol=0, atol=2e-2 * np.abs(g).max(),
                                   err_msg=k)


def _table(fn):
    mtx = pose_matrix(convert.state(jax_scene()["params0"], "cpu"))[0]
    with torch.no_grad():
        tab = fn.table(mtx)
    return tab, (tab.counts, tab.off_c, tab.used)


def test_torch_drows_bf16_rows_round_to_nearest_even(port):
    """K6's bf16 lane (its plain twin here) is the f32 d_rows rounded to
    nearest even, bit for bit: the bits of (f32 + 0x7fff + the kept
    mantissa's last bit) >> 16."""
    fns, _ = port
    fn = fns[True]
    tab, rest = _table(fn)
    ids, rows, _ = raster_fwd(tab.packed, *rest, K_CHUNK, fn.frame_hw, TILE_HW, fn.roi)
    d_sums = torch.tensor(np.random.default_rng(0).uniform(0.5, 2.0, (rows.shape[0], 3)),
                          dtype=torch.float32)
    d16, _, _ = loss_bwd(rows, ids, fn.gt6, fn.roi, d_sums, d_rows_dtype=torch.bfloat16)
    d32, _, _ = loss_bwd_plain(rows, ids, fn.gt6, fn.roi, d_sums)
    bits = d32.numpy().view(np.uint32).astype(np.uint64)
    rne = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    assert d16.dtype == torch.bfloat16 and (rne != 0).sum() > 1000
    np.testing.assert_array_equal(d16.view(torch.int16).numpy().view(np.uint16), rne)


def test_torch_drows_f32_lane_is_the_chained_ops(port):
    """DD_DROWS_BF16=0: the spanning op's bin gradient is the chained
    raster + fused loss's bit for bit; the bf16 lane's is not.  The
    variable is read when the loss is built: a loss built under "1" keeps
    its bf16 lane after it changes."""
    fns, runs = port
    fn = fns[False]
    tab, rest = _table(fn)
    d_sums = torch.tensor(np.random.default_rng(1).uniform(0.5, 2.0, (tab.packed.shape[0], 3)),
                          dtype=torch.float32)

    def d_bins(spanning, bf16=False):
        bins = tab.packed.detach().clone().requires_grad_(True)
        if spanning:
            sums = raster_loss_compact(bins, *rest, fn.gt6, K_CHUNK, fn.frame_hw, TILE_HW,
                                       fn.roi, bf16)
        else:
            ids, rows = raster_compact(bins, *rest, K_CHUNK, fn.frame_hw, TILE_HW, fn.roi)
            sums = fused_loss_sums(rows, ids, fn.gt6, None, None, fn.frame_hw, fn.roi)
        (g,) = torch.autograd.grad(sums, bins, d_sums)
        return g

    chained = d_bins(False)
    assert torch.equal(d_bins(True), chained)
    assert not torch.equal(d_bins(True, bf16=True), chained)
    with drows_env(False):
        _, grads = _value_and_grad(fns[True])
    for k, g in runs[True][1].items():
        np.testing.assert_array_equal(grads[k], g, err_msg=k)
