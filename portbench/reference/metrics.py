"""ADD, its AUC and the object diameter, in float64 numpy (the BOP /
YCB-Video arithmetic)."""

from __future__ import annotations

import numpy as np


def add(points: np.ndarray, m_est: np.ndarray, m_gt: np.ndarray) -> float:
    """The mean distance between the model points (N, 3) under the
    estimated and the true 4 x 4 pose."""
    p = np.asarray(points, np.float64)
    pe = p @ np.asarray(m_est, np.float64)[:3, :3].T + np.asarray(m_est, np.float64)[:3, 3]
    pg = p @ np.asarray(m_gt, np.float64)[:3, :3].T + np.asarray(m_gt, np.float64)[:3, 3]
    return float(np.linalg.norm(pe - pg, axis=-1).mean())


def auc(adds, max_threshold: float) -> float:
    """Area under the accuracy-threshold curve of ADD values over [0,
    max_threshold], normalized to 1: each value adds max(0, max_threshold -
    value)."""
    a = np.asarray(adds, np.float64).reshape(-1)
    if a.size == 0:
        return 0.0
    return float(np.clip(max_threshold - a, 0.0, max_threshold).mean() / max_threshold)


def diameter(points, sample: int = 2048, seed: int = 0) -> float:
    """The largest pairwise distance of the points, over a
    ``default_rng(seed)`` sample of ``sample`` of them when there are more."""
    pts = np.asarray(points, np.float64)
    if len(pts) > sample:
        pts = pts[np.random.default_rng(seed).choice(len(pts), sample, replace=False)]
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    return float(np.sqrt(d2.max()))
