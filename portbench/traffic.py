"""The one generator of every traffic mix: a pool of frames and a closed-loop
stream of refinement requests, drawn from the seed.

A mix is a JSON file of parameters (``portbench/traffic/<mix>.json``):

- ``pool``: the number of distinct frames, made once in set-up.
- ``gt``: each frame's true pose.  ``rotation`` is ``"uniform"`` (a rotation
  drawn uniformly, composed with the configuration's) or a number of
  degrees (the configuration's rotation turned by an angle uniform in [0,
  that] about a uniformly drawn axis); ``z`` replaces the configuration's
  depth when given; ``xy`` moves x and y each by a uniform draw in [-xy, xy].
- ``init``: each request's initial pose, its frame's true pose turned by
  exactly ``degrees`` about a drawn axis and moved by exactly
  ``translation`` (scene units) along a drawn direction.
- ``warmup``: the requests that set-up sends before the window (default
  1), from a stream of their own.  A session that keeps what its recovery
  learned (``DiffDope``: the crop switched off after a leak, the
  capacities grown after an overflow) reaches the state it serves in only
  after it has seen the pool.

Requests visit the pool in a drawn order, a new order each pass, so every
seed makes the same number of frames of the same kinds and sizes, in
another order, with other draws.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np

from portbench.reference.geometry import (
    quat_from_axis_angle,
    quat_multiply,
    random_quat,
    random_unit,
)

HERE = Path(__file__).resolve().parent


@dataclass
class Request:
    index: int
    frame: int
    q0: np.ndarray  # (4,) float32, unit
    t0: np.ndarray  # (3,) float32


def load(name: str, root: Path = HERE) -> Dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def pool_poses(mix: Dict, q_base, t_base, rng: np.random.Generator):
    """The pool's true poses: (P, 4) float64 unit quaternions, (P, 3) float64."""
    gt = mix["gt"]
    qs, ts = [], []
    for _ in range(int(mix["pool"])):
        if gt["rotation"] == "uniform":
            dq = random_quat(rng)
        else:
            dq = quat_from_axis_angle(random_unit(rng),
                                      np.deg2rad(rng.uniform(0.0, float(gt["rotation"]))))
        q = quat_multiply(dq, q_base)
        t = np.array(t_base, np.float64)
        if gt.get("z") is not None:
            t[2] = float(gt["z"])
        xy = float(gt.get("xy", 0.0))
        t[:2] += rng.uniform(-xy, xy, size=2)
        qs.append(q / np.linalg.norm(q))
        ts.append(t)
    return np.asarray(qs), np.asarray(ts)


def requests(mix: Dict, q_gt: np.ndarray, t_gt: np.ndarray,
             rng: np.random.Generator) -> Iterator[Request]:
    """The endless request stream over the pool whose true poses are
    ``q_gt`` (P, 4) and ``t_gt`` (P, 3)."""
    init = mix["init"]
    angle = np.deg2rad(float(init["degrees"]))
    dist = float(init["translation"])
    pool = len(q_gt)
    j = 0
    while True:
        for frame in rng.permutation(pool):
            dq = quat_from_axis_angle(random_unit(rng), angle)
            q0 = quat_multiply(dq, q_gt[frame])
            t0 = t_gt[frame] + dist * random_unit(rng)
            yield Request(j, int(frame), (q0 / np.linalg.norm(q0)).astype(np.float32),
                          t0.astype(np.float32))
            j += 1


def first(stream: Iterator[Request], n: int) -> List[Request]:
    return [next(stream) for _ in range(n)]
