"""The readers of the program's own spans and stamps
(``portbench/metrics/_spans.py`` and the six metrics on it), on a fake
recorder: the window is the last calls, one a request; the stages are the
stamps' differences over the steps that reached every point; a program
without ``diffdope_tpu_torch.trace`` reads nothing."""

import sys
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import run

STAGES = ["table_ms_per_step", "forward_ms_per_step", "backward_ms_per_step",
          "update_ms_per_step"]
MS = 1_000_000  # ns


def _span(name, sid, parent, call, start, end, attrs=None, stamps=None):
    return SimpleNamespace(name=name, id=sid, parent=parent, call=call, start_ns=start,
                           end_ns=end, attrs=attrs or {}, stamps=stamps)


def _call(call, t0, stage_ms, steps=3, capture=False, lead_ms=2.0, sid=None):
    """One ``dd.refine`` call at ``t0`` (ns) whose steps take ``stage_ms``
    a stage, its first replay launched ``lead_ms`` after it started."""
    sid = call * 10 if sid is None else sid
    row = np.cumsum([0] + [int(ms * MS) for ms in stage_ms])
    stamps = np.stack([t0 + 5 * MS + i * 20 * MS + row for i in range(steps)])
    spans = [_span("dd.refine", sid, None, call, t0, t0 + 100 * MS, {"steps": steps},
                   stamps),
             _span("dd.refine.load", sid + 1, sid, call, t0 + 10, t0 + 20),
             _span("dd.refine.replay", sid + 3, sid, call, t0 + 30, t0 + 90 * MS,
                   {"replays": steps, "first_launch_end_ns": t0 + int(lead_ms * MS)}),
             _span("dd.refine.result", sid + 4, sid, call, t0 + 91 * MS, t0 + 92 * MS)]
    if capture:
        spans.append(_span("dd.refine.capture", sid + 2, sid, call, t0 + 25, t0 + 29))
    return spans


@pytest.fixture
def recorder(monkeypatch):
    from diffdope_tpu_torch import trace

    spans = []
    monkeypatch.setattr(trace, "records", lambda: list(spans))
    return spans


def _read(name, requests):
    return run.metric_reader(name).read(SimpleNamespace(records=[None] * requests))


def test_stages_are_the_stamps_differences_over_the_window(recorder):
    # a set-up call (captured, slow steps), then the window's two calls
    recorder += _call(1, 0, [9.0, 9.0, 9.0, 9.0], capture=True, lead_ms=50.0)
    recorder += _call(2, 200 * MS, [0.5, 1.5, 1.25, 0.25])
    recorder += _call(3, 400 * MS, [0.75, 1.5, 1.25, 0.25], lead_ms=4.0)
    recorder[-4].stamps[1, 3] = 0  # a point not reached: the step is left out
    got = [_read(name, 2) for name in STAGES]
    assert got == pytest.approx([(3 * 0.5 + 2 * 0.75) / 5, 1.5, 1.25, 0.25])
    assert _read("refine_lead_ms", 2) == pytest.approx(3.0)
    assert _read("captures_per_refine", 2) == 0.0
    # the set-up call inside the window: its capture counts
    assert _read("captures_per_refine", 3) == pytest.approx(1 / 3)
    assert _read("table_ms_per_step", 3) == pytest.approx((3 * 9 + 3 * 0.5 + 2 * 0.75) / 8)


def test_a_diffdope_call_is_one_request(recorder):
    """A request of ``DiffDope`` is one ``dd.run``, its refinements (one a
    segment) inside: the lead is its first refinement's."""
    segments = (_call(7, 10 * MS, [1.0, 2.0, 3.0, 4.0], lead_ms=1.0, sid=20)
                + _call(7, 200 * MS, [1.0, 2.0, 3.0, 4.0], lead_ms=7.0, sid=30))
    for s in segments:
        if s.parent is None:
            s.parent = 1
    recorder += [_span("dd.run", 1, None, 7, 0, 500 * MS)] + segments
    assert _read("refine_lead_ms", 1) == pytest.approx(1.0)
    assert _read("forward_ms_per_step", 1) == pytest.approx(2.0)
    assert _read("captures_per_refine", 1) == 0.0


def test_nothing_to_read(recorder, monkeypatch):
    assert all(_read(name, 1) is None for name in STAGES + ["refine_lead_ms",
                                                           "captures_per_refine"])
    recorder += _call(1, 0, [1.0, 1.0, 1.0, 1.0])
    assert _read("table_ms_per_step", 2) is None  # fewer calls than requests
    assert _read("table_ms_per_step", 0) is None
    recorder[0].stamps = None  # traced with no card: no stamps
    assert _read("update_ms_per_step", 1) is None
    assert _read("captures_per_refine", 1) == 0.0
    # a program without the module (the parent of the tracing change)
    import diffdope_tpu_torch

    monkeypatch.delattr(diffdope_tpu_torch, "trace")
    monkeypatch.setitem(sys.modules, "diffdope_tpu_torch.trace", None)
    assert all(_read(name, 1) is None for name in STAGES + ["refine_lead_ms",
                                                           "captures_per_refine"])
