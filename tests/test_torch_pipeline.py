"""Port parity for the slice as a whole: the fused refinement loss (table,
compact raster + fused loss, totals and logs) and its pose gradients,
against the JAX make_fused_loss in the same configuration."""

import numpy as np
import pytest
import torch

from torch_scene import B, jax_fused_loss, jax_scene, port_fused_loss

from diffdope_tpu_torch import convert
from diffdope_tpu_torch.optimize import pose_matrix
from torch_scene import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def reference():
    import jax

    from diffdope_tpu.optimize import pose_matrix as j_pose_matrix

    params = {k: jax.numpy.asarray(v) for k, v in jax_scene()["params0"].items()}
    with pytest.MonkeyPatch.context() as mp:
        fn = jax_fused_loss(mp)

        def loss(p):
            total, logs = fn(j_pose_matrix(p)[0])
            return total, logs

        (total, logs), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return dict(total=np.asarray(total),
                logs={k: np.asarray(v) for k, v in logs.items()},
                grads={k: np.asarray(v) for k, v in grads.items()})


def _port_value_and_grad(fn, params0=None):
    params = convert.state(params0 or jax_scene()["params0"], "cpu")
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    total, logs = fn(pose_matrix(params)[0])
    grads = torch.autograd.grad(total, list(params.values()))
    return total.detach(), logs, dict(zip(params, grads))


def test_torch_fused_loss_and_pose_grads(reference):
    total, logs, grads = _port_value_and_grad(port_fused_loss())
    np.testing.assert_allclose(total.numpy(), reference["total"], rtol=1e-5, atol=1e-7)
    for k in ("rgb", "mask_selection"):
        np.testing.assert_allclose(logs[k].detach().numpy(), reference["logs"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert int(logs["_bin_overflow"]) == 0 == int(reference["logs"]["_bin_overflow"])
    for k, g in reference["grads"].items():
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(grads[k].numpy(), g, rtol=2e-4, atol=1e-6,
                                   err_msg=f"grad {k}")


def test_torch_roi_crop_is_loss_exact():
    """The tile-aligned ROI crop around the gt support (here narrower than
    the 96x160 frame) gives the full frame's loss and gradients while no
    triangle leaks out of it."""
    from diffdope_tpu_torch.bench import bench_problem, distinct_poses
    from diffdope_tpu_torch.render.pipeline import make_fused_loss

    pb = bench_problem((96, 160), subdiv=2, batch=2, device="cpu")
    s = pb["scene"]
    fn_full = make_fused_loss(
        s["proj"], s["pos"], s["tri"], (96, 160), pb["gt"], pb["lrs"],
        pb["weights"], use_rgb=True, use_mask=True, edge_adj=s["edge_adj"],
        vtx_color=s["vtx_color"], compact_total=pb["compact_total"],
        roi_crop="off", device="cpu",
    )
    assert pb["fn"].crop is not None and fn_full.crop is None
    params0 = {k: v.numpy() for k, v in distinct_poses(pb["params0"], 0.01).items()}
    t_c, logs_c, g_c = _port_value_and_grad(pb["fn"], params0)
    t_f, _, g_f = _port_value_and_grad(fn_full, params0)
    assert int(logs_c["_crop_leak"]) == 0
    np.testing.assert_allclose(t_c.numpy(), t_f.numpy(), rtol=1e-6)
    for k in g_f:
        np.testing.assert_allclose(g_c[k].numpy(), g_f[k].numpy(), rtol=1e-5,
                                   atol=1e-8, err_msg=k)


def test_torch_roi_crop_is_loss_exact_with_depth():
    """The same with the depth term, where the crop also cuts the depth
    plane and the raster and the fused loss are chained: the crop's loss,
    depth log and pose gradients are the full frame's."""
    from diffdope_tpu_torch.bench import bench_problem, distinct_poses
    from diffdope_tpu_torch.render.pipeline import make_fused_loss

    pb = bench_problem((96, 160), subdiv=2, batch=2, device="cpu", depth=True)
    s = pb["scene"]
    fn_full = make_fused_loss(
        s["proj"], s["pos"], s["tri"], (96, 160), pb["gt"], pb["lrs"],
        pb["weights"], use_rgb=True, use_depth=True, use_mask=True,
        edge_adj=s["edge_adj"], vtx_color=s["vtx_color"],
        compact_total=pb["compact_total"], roi_crop="off", device="cpu",
    )
    assert pb["fn"].crop is not None and fn_full.crop is None
    params0 = {k: v.numpy() for k, v in distinct_poses(pb["params0"], 0.01).items()}
    t_c, logs_c, g_c = _port_value_and_grad(pb["fn"], params0)
    t_f, logs_f, g_f = _port_value_and_grad(fn_full, params0)
    assert int(logs_c["_crop_leak"]) == 0
    assert float(logs_f["depth"].detach().min()) > 0
    np.testing.assert_allclose(t_c.numpy(), t_f.numpy(), rtol=1e-6)
    np.testing.assert_allclose(logs_c["depth"].detach().numpy(),
                               logs_f["depth"].detach().numpy(), rtol=1e-6)
    for k in g_f:
        np.testing.assert_allclose(g_c[k].numpy(), g_f[k].numpy(), rtol=1e-5,
                                   atol=1e-8, err_msg=k)


def test_torch_unported_paths_raise():
    """What the port refuses: a compact capacity off the chunk, and the
    depth loss without a gt depth image, given at build time or, to a
    deferred loss, with a call; a deferred call without a segmentation."""
    sc = jax_scene()
    args = (sc["proj"], sc["pos"], sc["tri"], (64, 96), sc["gt"], np.ones(B), {})
    from diffdope_tpu_torch.render.pipeline import make_fused_loss

    kw = dict(vtx_color=sc["vtx_color"], device="cpu")
    with pytest.raises(ValueError, match="multiple of"):
        make_fused_loss(*args, compact_total=1000, **kw)
    no_depth = {k: v for k, v in sc["gt"].items() if k != "depth"}
    with pytest.raises(ValueError, match="depth"):
        make_fused_loss(*args[:4], no_depth, *args[5:], use_depth=True, **kw)
    deferred = make_fused_loss(*args[:4], None, *args[5:], use_depth=True, **kw)
    mtx = torch.tensor(sc["mtx0"])
    with pytest.raises(ValueError, match="depth"):
        deferred(mtx, no_depth)
    with pytest.raises(ValueError, match="segmentation"):
        deferred(mtx, {"rgb": sc["gt"]["rgb"], "depth": sc["gt"]["depth"]})
