"""Port parity for the fused loss with the depth term, on both bin tables:
the whole step (table, raster, fused loss with the depth plane, totals and
logs) and its pose gradients against the JAX make_fused_loss in the same
configuration.  The compact table chains the raster and the fused loss, as
the reference does with depth (on this scene the ROI crop would be the
whole frame; tests/test_torch_pipeline.py crops), the uniform-K table runs
the full frame (the reference's 32x128 super-tiles against the port's
16x16 tiles: the raster is per pixel, so the tiling does not show)."""

import numpy as np
import pytest
import torch

from torch_scene import COMPACT_TOTAL, jax_fused_loss, jax_scene, port_fused_loss

from diffdope_tpu_torch import convert
from diffdope_tpu_torch.optimize import pose_matrix
from torch_scene import one_torch_thread  # noqa: F401

TABLES = {"compact": COMPACT_TOTAL, "uniform": None}


@pytest.fixture(scope="module", params=sorted(TABLES))
def step(request):
    """The reference's and the port's value, logs and pose gradients."""
    import jax

    from diffdope_tpu.optimize import pose_matrix as j_pose_matrix

    params = {k: jax.numpy.asarray(v) for k, v in jax_scene()["params0"].items()}
    with pytest.MonkeyPatch.context() as mp:
        fn = jax_fused_loss(mp, use_depth=True, compact_total=TABLES[request.param])
        (total, logs), grads = jax.jit(jax.value_and_grad(
            lambda p: fn(j_pose_matrix(p)[0]), has_aux=True))(params)
    ref = dict(total=np.asarray(total), logs={k: np.asarray(v) for k, v in logs.items()},
               grads={k: np.asarray(v) for k, v in grads.items()})

    port_fn = port_fused_loss(use_depth=True, uniform=request.param == "uniform")
    p = {k: v.requires_grad_(True)
         for k, v in convert.state(jax_scene()["params0"], "cpu").items()}
    total, logs = port_fn(pose_matrix(p)[0])
    g = torch.autograd.grad(total, list(p.values()))
    port = dict(total=total.detach().numpy(), logs=logs, fn=port_fn,
                grads={k: v.numpy() for k, v in zip(p, g)})
    return request.param, ref, port


def test_torch_fused_depth_loss_and_logs(step):
    table, ref, port = step
    if table == "uniform":
        assert port["fn"].crop is None
    assert list(port["logs"])[:3] == ["rgb", "depth", "mask_selection"]
    np.testing.assert_allclose(port["total"], ref["total"], rtol=1e-5, atol=1e-7)
    assert ref["logs"]["depth"].min() > 0
    for k in ("rgb", "depth", "mask_selection"):
        np.testing.assert_allclose(port["logs"][k].detach().numpy(), ref["logs"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert int(port["logs"]["_bin_overflow"]) == 0 == int(ref["logs"]["_bin_overflow"])


def test_torch_fused_depth_pose_grads(step):
    """Pose gradients rtol 2e-4, atol 1e-6; the depth term reaches t_z
    through dplane = gt depth + t_z, and the rotation through the rotated-z
    lanes."""
    _, ref, port = step
    for k, g in ref["grads"].items():
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(port["grads"][k], g, rtol=2e-4, atol=1e-6,
                                   err_msg=f"grad {k}")
