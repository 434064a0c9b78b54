"""Faults planted in the program, for the checks that ``correct`` must fail:
each breaks the timed path underneath the harness while it is in force.

- ``state_unchanged``: the optimizer's update does nothing, so every step
  returns its state as it found it.
- ``half_batch``: the loss is the mean over the first half of the
  hypotheses alone, so the rest take no gradient.
- ``answer_altered``: every pose the refinement returns is moved 5 cm
  along x where it is produced.

One chip runs each cell, so no exchange between chips can be left out.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, List, Tuple

import torch

NAMES = ("state_unchanged", "half_batch", "answer_altered")


def _patches(name: str) -> List[Tuple[object, str, object]]:
    from diffdope_tpu_torch import diffdope, optimize
    from diffdope_tpu_torch.render import pipeline

    if name == "state_unchanged":
        return [(optimize.Adam, "update", lambda *a, **k: None),
                (optimize.SGD, "update", lambda *a, **k: None)]
    if name == "half_batch":
        orig = pipeline.make_fused_loss

        def make(*args, **kw):
            fn = orig(*args, **kw)
            # on the loss's device when it is built: a captured step copies
            # no host data
            scales = torch.as_tensor(kw.get("learning_rates", args[5]), dtype=torch.float32,
                                     device=torch.device(kw.get("device", "cuda")))

            @functools.wraps(fn)
            def halved(mtx, *rest, **kw2):
                total, logs = fn(mtx, *rest, **kw2)
                h = mtx.shape[0] // 2
                s = scales[:h]
                return sum((v[:h] * s).mean() for k, v in logs.items()
                           if not k.startswith("_")), logs

            return halved

        return [(pipeline, "make_fused_loss", make), (diffdope, "make_fused_loss", make)]
    if name == "answer_altered":
        orig_call = optimize.CapturedRefine.__call__

        def call(self, *args, **kw):
            res = orig_call(self, *args, **kw)
            res.mtx_history[1:, :, 0, 3] += 0.05
            return res

        return [(optimize.CapturedRefine, "__call__", call)]
    raise ValueError(f"unknown fault {name!r}")


@contextlib.contextmanager
def planted(name: str) -> Iterator[None]:
    """The program with fault ``name`` in force inside."""
    patches = _patches(name)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, new in patches:
            setattr(obj, attr, new)
        yield
    finally:
        for obj, attr, old in saved:
            setattr(obj, attr, old)
