"""Port parity for DiffDope with the depth loss on the uniform-K table: a
reference session and a port session (device="cpu") on the DiffDope test
scene (tests/test_torch_diffdope.py: icosphere(2), 48x64, B=3, 4 SGD
steps) with mask, rgb and depth L1 and ``tpu.compact_bins: false``, the
port session built from the reference's state (``convert.diffdope_state``:
the mesh, the init, the loss scales, the gt images with the depth, and
the loss and table settings).  Both take the fused route: the reference
rasterizes the uniform table and runs ``fused_loss_sums`` with the depth
plane, the port K7 and K5/K6 (here their plain versions)."""

import copy

import numpy as np
import pytest

from test_torch_diffdope import BASE_CFG, STEPS, _port_session, _reference_session

from diffdope_tpu_torch import convert
from torch_scene import one_torch_thread  # noqa: F401

DEPTH_CFG = copy.deepcopy(BASE_CFG)
DEPTH_CFG["losses"].update({"l1_depth_with_mask": True, "weight_depth": 1.0})
DEPTH_CFG["hyperparameters"]["base_lr"] = 20.0
DEPTH_CFG["tpu"].update({"optimizer": "sgd", "compact_bins": False})
DEPTH_CFG["tpu"].pop("compact_total")


@pytest.fixture(scope="module")
def sessions():
    with pytest.MonkeyPatch.context() as mp:
        ref = _reference_session("sgd", mp, cfg=DEPTH_CFG, with_depth=True)
    state = convert.diffdope_state(ref)
    cfg = {"losses": state["losses"], "tpu": state["tpu"],
           "hyperparameters": copy.deepcopy(DEPTH_CFG["hyperparameters"])}
    port = _port_session(state, cfg)
    port.run_optimization()
    return ref, port, state


def test_torch_diffdope_state_carries_depth_and_settings(sessions):
    ref, port, state = sessions
    np.testing.assert_array_equal(state["gt"]["depth"], ref.gt_tensors["depth"])
    assert state["losses"]["l1_depth_with_mask"] is True
    assert state["tpu"]["compact_bins"] is False
    assert port._resolve_compact_total(None, None, None, None) is None
    assert port._make_fused_loss_fn(port.gt_tensors).crop is None


def test_torch_diffdope_depth_uniform_matches_reference(sessions):
    """Step-0 logs rtol 1e-5 and the whole SGD trajectory: logs rtol 2e-4,
    poses atol 1e-5, the same selected pose."""
    ref, port, _ = sessions
    assert port.mtx_history.shape == ref.mtx_history.shape == (STEPS, 3, 4, 4)
    assert set(port.losses_values) == set(ref.losses_values) == {
        "rgb", "depth", "mask_selection"}
    assert ref.losses_values["depth"][0].min() > 0
    for k, v in ref.losses_values.items():
        np.testing.assert_allclose(port.losses_values[k][0], v[0], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(port.losses_values[k], v, rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(port.mtx_history, ref.mtx_history, atol=1e-5)
    assert port.get_argmin() == ref.get_argmin()
    np.testing.assert_allclose(port.get_pose(), ref.get_pose(), atol=1e-5)
    assert port._telemetry_max(port._result, "_bin_overflow") == 0
