"""Shared helpers of the benchmark's tests: tiny configurations that the CPU
runs in seconds, and the plans that drive the harness with them."""

import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"


def tiny_config(name: str) -> dict:
    return json.loads((DATA / f"{name}.json").read_text())


def tiny_plan(config: str, mix: str, pool: int = 2, limits=None) -> dict:
    from portbench import traffic

    return {"cell": {"name": f"{config}.{mix}", "chips": 1}, "config": tiny_config(config),
            "mix": dict(traffic.load(mix), pool=pool, warmup=1), "limits": limits,
            "end_to_end": [], "per_layer": []}


def tiny_problem():
    """The tiny icosphere problem and its first frame, on the CPU."""
    from portbench import traffic
    from portbench.entries import problem_of, render_pool

    p = problem_of(tiny_config("tiny-ico"))
    q, t = traffic.pool_poses(dict(traffic.load("near"), pool=1), p.q_base, p.t_base,
                              np.random.default_rng(5))
    return p, render_pool(p, q, t, "cpu")
