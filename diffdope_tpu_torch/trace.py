"""Spans and device stamps of the refinement.

Tracing is on while a ``torch.profiler`` session records (the profiler's
own enabled flag) or in a process started with ``DD_TRACE=1``, which gives
the spans without CUPTI's cost.  When it is off a span costs one flag
check: it enters no ``record_function`` and reads no clock.

A host span (:func:`span`) enters ``torch.profiler.record_function("dd." +
name)`` while the profiler records, so it sits in the profiler's trace, and
keeps an in-memory :class:`Span`: name, start and end on the profiler's CPU
clock (:func:`clock_ns`: ``CLOCK_REALTIME``, the clock torch's profiler
converts its events to), parent, call id (a span opened with no span open
starts a call; its children share its id) and attributes.  The records stay
in memory until read (:func:`records`, :func:`take`).

Device stamps split a step of ``optimize.CapturedRefine`` into stages: a
one-thread kernel (``csrc/trace.cu``) writes the device's ``%globaltimer``
(ns) into the step's row of a ``(horizon, POINTS)`` int64 buffer at five
points, ``STEP`` (the step's entry), ``TABLE`` (the table laid out, before
the pack or the raster), ``OBJECTIVE`` (the objective returned), ``GRAD``
(the gradients returned) and ``END`` (after the update and the counters).
The step captures them whatever the switch says, so every replay writes
them; the host reads them only while tracing is on, as the ``stamps`` of
the call's ``dd.refine`` span (copied on the device, brought to the host
when read).  Outside a step (:func:`stamping`) and on the CPU a stamp does
nothing.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

import torch

#: the process traces without a profiler
FORCED = os.environ.get("DD_TRACE", "0") == "1"
#: the prefix of every span's name
PREFIX = "dd."
#: the stamped points of a step, the columns of the stamp buffer
STEP, TABLE, OBJECTIVE, GRAD, END = range(5)
POINTS = 5
#: finished spans kept (the oldest go first)
KEEP = 1 << 16

_profiling = torch.autograd._profiler_enabled
#: the profiler's CPU clock, in ns
clock_ns = time.time_ns


def enabled() -> bool:
    """Whether spans are recorded and stamps read now."""
    return FORCED or _profiling()


class Span:
    """One finished span: ``name`` (with the prefix), ``start_ns`` and
    ``end_ns`` on :func:`clock_ns`, ``id``, ``parent`` (the id of the span
    open around it, or None), ``call`` (the id shared by the spans of one
    outermost span), ``attrs``, and for ``dd.refine`` the call's
    ``stamps``: (steps, POINTS) int64 on the host once read."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "call", "attrs", "stamps",
                 "_fn")

    def __init__(self, name: str, attrs: Dict[str, Any]):
        self.name, self.attrs, self.stamps, self._fn = name, attrs, None, None
        self.start_ns = self.end_ns = 0

    def __enter__(self) -> "Span":
        stack = _stack()
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if outer is None else outer.id
        self.call = next(_calls) if outer is None else outer.call
        self.start_ns = clock_ns()
        if _profiling():
            # the profiler stamps its event inside the enter, which can take
            # tens of us: the middle of the enter is the nearest guess
            self._fn = torch.profiler.record_function(self.name)
            self._fn.__enter__()
            self.start_ns = (self.start_ns + clock_ns()) // 2
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        self.end_ns = clock_ns()
        if self._fn is not None:
            self._fn.__exit__(*exc)
            self._fn = None
            self.end_ns = (self.end_ns + clock_ns()) // 2
        _done.append(self)
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, id={self.id}, "
                f"parent={self.parent}, call={self.call}, attrs={self.attrs})")


class _Off:
    """The span of tracing off: enters nothing, keeps nothing, is false."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()
_done: deque = deque(maxlen=KEEP)
_ids = itertools.count(1)
_calls = itertools.count(1)
_local = threading.local()
#: (stamps, row counter) of the step running now, or None
_target: Optional[tuple] = None


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs):
    """A span named ``"dd." + name`` with ``attrs`` while tracing is on
    (:class:`Span`, a context manager; ``set`` adds attributes), else a
    context that does nothing and is false."""
    if not (FORCED or _profiling()):
        return _OFF
    return Span(PREFIX + name, attrs)


def _host(spans: List[Span]) -> List[Span]:
    for s in spans:
        if isinstance(s.stamps, torch.Tensor):
            s.stamps = s.stamps.cpu().numpy()
    return spans


def records() -> List[Span]:
    """The finished spans in the order they ended, kept; their stamps on
    the host (this waits for the device)."""
    return _host(list(_done))


def take() -> List[Span]:
    """:func:`records`, and forget them."""
    out = list(_done)
    _done.clear()
    return _host(out)


@contextlib.contextmanager
def stamping(stamps: Optional[torch.Tensor], row: torch.Tensor) -> Iterator[None]:
    """Inside, :func:`stamp` writes into ``stamps`` (rows, POINTS) int64 on
    the card at the row that the (1,) int64 counter ``row`` holds on the
    device; ``stamps`` None (the CPU) stamps nothing."""
    global _target
    outer, _target = _target, None if stamps is None else (stamps, row)
    try:
        yield
    finally:
        _target = outer


def stamp(point: int) -> None:
    """Write the device's clock at ``point`` of the step running now, on the
    current stream; ``END`` comes after the row counter's increment, so it
    writes one row back.  Nothing outside :func:`stamping`."""
    if _target is None:
        return
    from diffdope_tpu_torch import kernels

    stamps, row = _target
    err = kernels.library()["dd_stamp"](
        stamps.data_ptr(), row.data_ptr(), -1 if point == END else 0, point, POINTS,
        stamps.shape[0], torch.cuda.current_stream(stamps.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dd_stamp: CUDA error {err}")
