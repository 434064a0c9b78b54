"""What the program recorded of the traced window (``diffdope_tpu_torch.trace``):
the spans of its calls, one call a request, and the device stamps of their
refinement steps.  Where the program has no such module, or recorded
fewer calls than the window made requests, the readers find nothing
(None)."""

import numpy as np

#: the outermost span of a request: a ``CapturedRefine`` call or a
#: ``DiffDope.run_optimization``
CALLS = ("dd.refine", "dd.run")
#: the stamped points' stages, in the order of the stamps' columns
STAGES = ("table", "forward", "backward", "update")


def window(run):
    """The spans of each of the window's calls, in the order of the calls:
    the last ``len(run.records)`` calls the program recorded (any set-up
    calls traced under ``DD_TRACE=1`` come before them)."""
    try:
        from diffdope_tpu_torch import trace
    except ImportError:
        return None
    spans = trace.records()
    outer = sorted((s for s in spans if s.parent is None and s.name in CALLS),
                   key=lambda s: s.start_ns)
    n = len(run.records)
    if not n or len(outer) < n:
        return None
    calls = {s.call: [] for s in outer[-n:]}
    for s in spans:
        if s.call in calls:
            calls[s.call].append(s)
    return list(calls.values())


def stage_ms(run, stage: str):
    """A stage's device ms (the difference of its two stamps), mean over
    the window's stamped steps."""
    calls = window(run)
    if calls is None:
        return None
    rows = [s.stamps for spans in calls for s in spans
            if s.name == "dd.refine" and s.stamps is not None and len(s.stamps)]
    if not rows:
        return None
    stamps = np.concatenate(rows).astype(np.int64)
    stamps = stamps[(stamps > 0).all(axis=1)]  # every point reached
    if not len(stamps):
        return None
    k = STAGES.index(stage)
    return float((stamps[:, k + 1] - stamps[:, k]).mean()) * 1e-6
