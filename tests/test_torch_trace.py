"""The port's tracing (``diffdope_tpu_torch.trace``) on the CPU: off, a span
records nothing and enters no ``record_function``; under ``torch.profiler``
or ``DD_TRACE=1`` the spans of ``CapturedRefine`` and ``DiffDope`` nest,
with parents and call ids, each starting within 50 us of the profiler's own
event for it; ``CapturedRefine``'s counters and ``DiffDope``'s re-run
reasons.  The device stamps need a card (``tests/test_torch_cuda.py``)."""

import os
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import pytest
import torch

from diffdope_tpu_torch import trace
from diffdope_tpu_torch.bench import bench_problem
from diffdope_tpu_torch.optimize import CapturedRefine
from torch_scene import one_torch_thread  # noqa: F401

import test_torch_refine_options as opts

ROOT = Path(__file__).resolve().parent.parent
RES = (32, 48)
B = 2
NB = 2
#: the in-memory start of a span against the profiler's event of it
CLOCK_US = 50.0
#: the same, whatever the scheduler does (another clock is days away)
SAME_CLOCK_US = 100_000.0
#: traced runs of the clock check
ATTEMPTS = 3


@pytest.fixture(scope="module")
def problem():
    return bench_problem(RES, subdiv=1, batch=B, device="cpu")


@pytest.fixture(autouse=True)
def fresh():
    """No span of an earlier test, tracing forced off."""
    trace.take()
    saved = trace.FORCED
    trace.FORCED = False
    yield
    trace.FORCED = saved
    trace.take()


def _refine(problem):
    return CapturedRefine(fused_loss_fn=problem["fn"], nb_iterations=NB, base_lr=0.02,
                          optimizer="adam")


def _work(problem):
    """A DiffDope run, then two calls of one CapturedRefine."""
    opts._port_session(nb_iterations=1).run_optimization()
    jit_refine = _refine(problem)
    for _ in range(2):
        jit_refine(problem["params0"])
    return jit_refine


def test_off_records_nothing_and_enters_no_profiler_span(problem, monkeypatch):
    def refused(*args, **kwargs):
        raise AssertionError("entered while tracing is off")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(trace, "clock_ns", refused)
    assert not trace.enabled()
    _work(problem)
    assert trace.take() == []
    with trace.span("refine") as sp:
        assert not sp
        sp.set(steps=1)
    assert trace.records() == []


def _by_id(spans):
    return {s.id: s for s in spans}


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id), key=lambda s: s.start_ns)


def _check_nesting(spans):
    """The spans of one DiffDope run and two CapturedRefine calls."""
    ids = _by_id(spans)
    for s in spans:
        assert s.name.startswith("dd.") and s.start_ns <= s.end_ns, s
        if s.parent is not None:
            outer = ids[s.parent]
            assert outer.call == s.call, (s, outer)
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns, (s, outer)
    tops = sorted((s for s in spans if s.parent is None and s.name != "dd.kernels.load"),
                  key=lambda s: s.start_ns)
    assert [s.name for s in tops] == ["dd.run", "dd.refine", "dd.refine"]
    assert len({s.call for s in tops}) == 3
    run, first, second = tops
    assert [s.name for s in _children(spans, run)] == [
        "dd.run.gt", "dd.run.loss", "dd.run.dispatch", "dd.run.host"]
    loss, dispatch = _children(spans, run)[1:3]
    assert {s.name for s in _children(spans, loss)} == {"dd.probe"}
    assert {s.attrs["what"] for s in _children(spans, loss)} == {"max_tile_count",
                                                                 "compact_capacity"}
    assert dispatch.attrs == {"attempt": 0, "reason": "first"}
    (refine,) = _children(spans, dispatch)
    assert refine.name == "dd.refine"
    for call, new in ((refine, True), (first, True), (second, False)):
        # on the CPU the eager loop: no step 0, capture or replay
        assert [s.name for s in _children(spans, call)] == ["dd.refine.load",
                                                            "dd.refine.result"]
        assert call.attrs["new_trace"] is new and call.stamps is None
    assert first.attrs["steps"] == NB + 1


def test_spans_nest_under_dd_trace(problem):
    trace.FORCED = True
    assert trace.enabled()
    _work(problem)
    spans = trace.records()
    assert spans and trace.records() == spans  # kept until taken
    _check_nesting(spans)
    assert trace.take() == spans and trace.records() == []


def _profiled(problem):
    """The spans of :func:`_work` under the profiler (CPU activity), and
    the profiler's start of each of its events of them, by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.enabled()
        # torch sets up the profiler's buffers and its record_function op at
        # their first use (~1 ms here), inside the enter: not in a span's
        with torch.profiler.record_function("warm-up"):
            torch.ones(1).add_(1)
        _work(problem)
    assert not trace.enabled()
    events = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("dd."):
            events[e.name()].append(e.start_ns())
    return trace.take(), events


def test_spans_nest_under_the_profiler_on_its_clock(problem):
    """The spans nest as under ``DD_TRACE``, one profiler event each, and
    each in-memory start lies within 50 us of its event's.  A thread
    descheduled inside ``record_function``'s enter (the test workers share
    the cores) moves the profiler's stamp by milliseconds, so up to
    ``ATTEMPTS`` traced runs are made, every span of one of them within
    50 us; every run's within ``SAME_CLOCK_US``, which another clock
    (monotonic, boot time) misses by days."""
    worst = []
    for _ in range(ATTEMPTS):
        spans, events = _profiled(problem)
        _check_nesting(spans)
        ours = defaultdict(list)
        for s in spans:
            ours[s.name].append(s.start_ns)
        assert set(events) == set(ours)
        offsets = []
        for name, starts in ours.items():
            theirs = sorted(events[name])
            assert len(theirs) == len(starts), name
            offsets += [abs(mine - its) for mine, its in zip(sorted(starts), theirs)]
        worst.append(max(offsets) * 1e-3)
        assert worst[-1] <= SAME_CLOCK_US, worst
        if worst[-1] <= CLOCK_US:
            break
    assert min(worst) <= CLOCK_US, worst


@pytest.mark.parametrize("value,on", [("1", True), ("0", False)])
def test_dd_trace_turns_tracing_on(value, on):
    env = dict(os.environ, DD_TRACE=value, PYTHONPATH=str(ROOT))
    out = subprocess.run(
        [sys.executable, "-c", "from diffdope_tpu_torch import trace; "
                               "print(trace.FORCED, trace.enabled())"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [str(on), str(on)]


def test_counters_of_same_layout_calls(problem):
    jit_refine = _refine(problem)
    for _ in range(2):
        jit_refine(problem["params0"])
    assert (jit_refine.traces, jit_refine.calls, jit_refine.captures,
            jit_refine.replays) == (1, 2, 0, 0)
    assert jit_refine.step0_s == jit_refine.capture_s == 0.0  # no graph on the CPU
    assert jit_refine.pool_bytes == 0


def test_overflow_rerun_logs_its_reason(monkeypatch):
    """A compact table probed far too small (two chunks, as in
    ``test_torch_diffdope_recovery_sizes_table_from_need``) drops pairs:
    the one re-run's reason is 'overflow', in the run's stats and in its
    dispatch span."""
    import diffdope_tpu_torch.diffdope as port_dd

    monkeypatch.setattr(port_dd, "compact_capacity", lambda *a, **k: 64)
    trace.FORCED = True
    dd = opts._port_session(nb_iterations=1)
    dd.run_optimization()
    stats = dd.last_run_stats
    assert stats["recovery_reruns"] == 1 and stats["rerun_reasons"] == ["overflow"]
    assert stats["compile_s"] == 0.0 and stats["steady_steps_per_sec"] is None
    dispatches = sorted((s for s in trace.take() if s.name == "dd.run.dispatch"),
                        key=lambda s: s.start_ns)
    assert [(s.attrs["attempt"], s.attrs["reason"]) for s in dispatches] == [
        (0, "first"), (1, "overflow")]
