"""Reading a trace: busy time as the union of device intervals, device time
by name, and idle gaps named by what the host was doing."""

import pytest

from portbench.trace import Summary, summarize


def test_busy_is_the_union_and_gaps_are_named():
    dev = [("raster_fwd_kernel(float const*)", 0, 100), ("void at::add", 50, 150),
           ("loss_fwd_kernel", 400, 500), ("loss_bwd_kernel", 1000, 1100)]
    cpu = [("portbench.request", 0, 2000), ("aten::copy_", 160, 390),
           ("DiffDope.probe", 600, 990)]
    s = summarize(dev, cpu, 2e-6)
    assert s.busy_s == pytest.approx(350e-9)
    assert s.device_s["loss_fwd_kernel"] == pytest.approx(100e-9)
    assert [g[0] for g in s.gaps] == ["portbench.request / DiffDope.probe",
                                      "portbench.request / aten::copy_"]
    assert s.gaps[0][1] == pytest.approx(500e-9)
    assert s.time_of(["raster_fwd_kernel", "loss_bwd_kernel"]) == pytest.approx(200e-9)
    assert s.time_of(["loss_fwd"]) == 0.0  # a whole symbol, not a prefix
    bd = s.breakdown()
    assert bd["device_ops"][0][1] >= bd["device_ops"][-1][1]
    assert len(bd["idle_gaps"]) == 2


def test_no_device_activity_reads_no_busy_time():
    assert summarize([], [], 1.0).busy_s == 0.0
    assert isinstance(summarize([], [], 1.0), Summary)
