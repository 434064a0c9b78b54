"""Port parity for the slice as a whole: four Adam steps of the port's
refine on its fused loss against the JAX refine with fused_loss_fn, from
the same initial poses and loss scales (the trajectory tolerance of
tests/test_fused_loss.py:174-187)."""

import functools

import numpy as np
import pytest

from torch_scene import LRS, WEIGHTS, jax_fused_loss, jax_scene, port_fused_loss

from diffdope_tpu_torch import convert
from diffdope_tpu_torch.optimize import argmin_hypothesis, refine
from torch_scene import one_torch_thread  # noqa: F401

STEPS = 4


@pytest.fixture(scope="module")
def reference():
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.optimize import refine as j_refine

    sc = jax_scene()
    with pytest.MonkeyPatch.context() as mp:
        fn = jax_fused_loss(mp)
        res = jax.jit(
            functools.partial(
                j_refine, render_fn=None, loss_fns=(), weights=WEIGHTS,
                nb_iterations=STEPS - 1, base_lr=0.02, lr_decay=0.1,
                optimizer="adam", fused_loss_fn=fn,
            ),
            static_argnames=("num_steps",),
        )(
            {k: jnp.asarray(v) for k, v in sc["params0"].items()},
            gt=sc["gt"], learning_rates=jnp.asarray(LRS), opt_state=None,
            num_steps=STEPS,
        )
    return jax.tree.map(np.asarray, res._replace(opt_state=None))


def test_torch_refine_trajectory(reference):
    res = refine(
        convert.state(jax_scene()["params0"], "cpu"), fused_loss_fn=port_fused_loss(),
        nb_iterations=STEPS - 1, base_lr=0.02, lr_decay=0.1, optimizer="adam",
    )
    total = res.total_loss.numpy()
    assert total.shape == (STEPS,) and total[-1] < total[0]
    np.testing.assert_allclose(total, reference.total_loss, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res.mtx_history.numpy(), reference.mtx_history,
                               rtol=1e-4, atol=1e-5)
    for k, v in reference.losses_values.items():
        np.testing.assert_allclose(res.losses_values[k].numpy(), v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for k, v in reference.params.items():
        np.testing.assert_allclose(res.params[k].numpy(), v, rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert res.telemetry["_bin_overflow"].max() == 0
    from diffdope_tpu.optimize import argmin_hypothesis as j_argmin

    assert int(argmin_hypothesis(res.losses_values)) == int(
        j_argmin(reference.losses_values))


def test_torch_select_losses_matches():
    from diffdope_tpu.losses import select_losses as j_select
    from diffdope_tpu_torch.losses import select_losses as t_select

    cfg = {"l1_mask": True, "weight_mask": 1.0, "l1_rgb_with_mask": True,
           "weight_rgb": 0.7}
    j_fns, j_weights = j_select(cfg)
    fns, weights = t_select(cfg)
    assert weights == j_weights
    assert [f.__name__ for f in fns] == [f.__name__ for f in j_fns]
