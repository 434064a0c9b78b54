"""Port parity for the planar route's loss: ``make_fused_loss`` under
``DD_RASTER=v3`` and ``DD_BINNED=0`` in both packages, on the torch_scene at
its initial poses, the reference's planar table fed to the port (see
tests/test_torch_planar_route.py for why and how); and a 4-step SGD
``DiffDope`` under ``DD_RASTER=v3`` at tests/test_torch_diffdope.py's
tolerances."""

import numpy as np
import pytest
import torch

from torch_scene import LRS, MAX_K, RES, ROUTES, WEIGHTS, feed_planar_table, jax_scene, \
    planar_capture, set_route

from diffdope_tpu_torch.render import pipeline
from diffdope_tpu_torch.render.pipeline import make_fused_loss
from torch_scene import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_torch_planar_fused_loss_matches_reference(route):
    """make_fused_loss (rgb + mask) under the route: per-hypothesis logs at
    rtol 1e-5, atol 1e-7; the total's pose gradient at rtol 2e-4, atol
    1e-6."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.pipeline import make_fused_loss as j_make_fused_loss

    sc = jax_scene()
    store = []
    with pytest.MonkeyPatch.context() as mp:
        set_route(mp, route)
        mp.setenv("DD_DROWS_BF16", "0")
        planar_capture(mp, route, store)
        j_fn = j_make_fused_loss(sc["proj"], sc["pos"], sc["tri"], RES, sc["gt"], LRS,
                                 WEIGHTS, use_rgb=True, use_mask=True,
                                 edge_adj=sc["edge_adj"], vtx_color=sc["vtx_color"],
                                 max_tris_per_tile=MAX_K)
        (_, j_logs), j_grad = jax.jit(jax.value_and_grad(j_fn, has_aux=True))(
            jnp.asarray(sc["mtx0"]))
        jax.effects_barrier()
    assert store

    with pytest.MonkeyPatch.context() as mp:
        set_route(mp, route)
        fn = make_fused_loss(sc["proj"], sc["pos"], sc["tri"], RES, sc["gt"], LRS, WEIGHTS,
                             use_rgb=True, use_mask=True, edge_adj=sc["edge_adj"],
                             vtx_color=sc["vtx_color"], max_tris_per_tile=MAX_K,
                             device="cpu")
        feed_planar_table(mp, store[0])
        mtx = torch.tensor(sc["mtx0"], requires_grad=True)
        total, logs = fn(mtx)
    assert fn.route == route and fn.crop is None
    (grad,) = torch.autograd.grad(total, mtx)
    for key in ("rgb", "mask_selection"):
        np.testing.assert_allclose(logs[key].detach().numpy(), np.asarray(j_logs[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=2e-4, atol=1e-6)
    if route == "v3":
        assert not any(k.startswith("_bin") for k in logs)
    else:
        assert int(logs["_bin_overflow"]) == 0 == int(j_logs["_bin_overflow"])
        # the inverted map is as wide as the most tiles a triangle occupies
        assert pipeline.MAX_OCC == "auto" and int(logs["_bin_occupancy"]) > 0


def test_torch_planar_diffdope_matches_reference():
    """A 4-step SGD DiffDope under DD_RASTER=v3, the port session built
    from the reference's state, at tests/test_torch_diffdope.py's
    tolerances; the route binned nothing, so nothing was re-run."""
    from test_torch_diffdope import STEPS, _cfg, _port_session, _reference_session

    from diffdope_tpu_torch import convert

    with pytest.MonkeyPatch.context() as mp:
        set_route(mp, "v3")
        ref = _reference_session("sgd", mp)
        port = _port_session(convert.diffdope_state(ref), _cfg("sgd"))
        port.run_optimization()
    assert port.mtx_history.shape == ref.mtx_history.shape == (STEPS, 3, 4, 4)
    for k, v in ref.losses_values.items():
        np.testing.assert_allclose(port.losses_values[k][0], v[0], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(port.losses_values[k], v, rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(port.mtx_history, ref.mtx_history, atol=1e-5)
    assert port.get_argmin() == ref.get_argmin()
    assert port.last_run_stats["recovery_reruns"] == 0
    assert "_bin_overflow" not in (port._result.telemetry or {})
    mask = port.losses_values["mask_selection"]
    assert mask[-1].mean() < mask[0].mean()
