"""What the profiler's trace of the measured window says: the device's busy
time, each operation's device time by name, and the longest idle gaps with
what the host was doing in each."""

from __future__ import annotations

import re
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

#: the prefix of the spans the harness records around its calls
SPAN = "portbench."


@dataclass
class Summary:
    window_s: float
    busy_s: float
    device_s: Dict[str, float] = field(default_factory=dict)     # by operation name
    gaps: List[Tuple[str, float]] = field(default_factory=list)  # longest first

    def time_of(self, symbols: Iterable[str]) -> float:
        """Device seconds of the operations whose names hold one of the
        kernel ``symbols`` as a whole word."""
        pat = re.compile(r"\b(" + "|".join(map(re.escape, symbols)) + r")\b")
        return sum(s for name, s in self.device_s.items() if pat.search(name))

    def breakdown(self) -> Dict[str, List]:
        ops = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:10]]}


class Tracer:
    """``torch.profiler`` over the window, CPU and CUDA activities."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.t0 = self.window_s = 0.0

    def __enter__(self):
        torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()
        return False

    def summary(self) -> Summary:
        cuda = torch.autograd.DeviceType.CUDA
        dev: List[Tuple[str, int, int]] = []
        cpu: List[Tuple[str, int, int]] = []
        for e in self.prof.profiler.kineto_results.events():
            start = e.start_ns()
            item = (e.name(), start, start + e.duration_ns())
            if e.device_type() != cuda:
                cpu.append(item)
            elif not (e.is_user_annotation() or item[0].startswith(SPAN)):
                # a span's copy on the device timeline is no device work
                dev.append(item)
        return summarize(dev, cpu, self.window_s)


def summarize(dev: List[Tuple[str, int, int]], cpu: List[Tuple[str, int, int]],
              window_s: float) -> Summary:
    """Busy time (the union of the device intervals), device time by name,
    and the idle gaps between device intervals, each named by the
    innermost harness span and the innermost host operation around its
    middle."""
    by_name: Dict[str, float] = defaultdict(float)
    for name, s, e in dev:
        by_name[name] += (e - s) * 1e-9
    if not dev:
        return Summary(window_s, 0.0, dict(by_name))
    iv = np.array([(s, e) for _, s, e in dev], np.int64)
    iv = iv[np.argsort(iv[:, 0])]
    merged = []
    cur_s, cur_e = iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            merged.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    merged.append((cur_s, cur_e))
    busy = sum(e - s for s, e in merged)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    if cpu:
        names = [n for n, _, _ in cpu]
        cs = np.array([s for _, s, _ in cpu], np.int64)
        ce = np.array([e for _, _, e in cpu], np.int64)
        spans = np.array([n.startswith(SPAN) for n in names])
        for g0, g1 in gaps[:10]:
            mid = (g0 + g1) // 2
            inside = (cs <= mid) & (ce >= mid)
            named.append((_innermost(names, cs, inside & spans) + " / "
                          + _innermost(names, cs, inside & ~spans), (g1 - g0) * 1e-9))
    else:
        named = [("host", (g1 - g0) * 1e-9) for g0, g1 in gaps[:10]]
    return Summary(window_s, busy * 1e-9, dict(by_name), named)


def _innermost(names, starts, mask) -> str:
    idx = np.flatnonzero(mask)
    if len(idx) == 0:
        return "-"
    return names[int(idx[np.argmax(starts[idx])])]


def span(name: str):
    """A harness span in the trace (a no-op cost when no profiler runs)."""
    return torch.profiler.record_function(SPAN + name)

