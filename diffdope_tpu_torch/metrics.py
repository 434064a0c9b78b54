"""Pose-accuracy metrics (counterpart of ``diffdope_tpu/metrics.py``).

ADD (Hinterstoisser et al.) and ADD-S (nearest model point, for symmetric
objects) in torch on the caller's device; the AUC, the object diameter,
the geodesic rotation angle and the stride subsample in numpy, with the
reference's seeds and strides, so both packages score the same points.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["add_metric", "adds_metric", "add_auc", "object_diameter", "rotation_angle_deg",
           "subsample_points"]


def _transform(points, rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """(N, 3) points by (..., 3, 3) + (..., 3) -> (..., N, 3)."""
    p = torch.as_tensor(points, dtype=rot.dtype, device=rot.device)
    return p @ rot.transpose(-1, -2) + trans[..., None, :]


def add_metric(points, r_est: torch.Tensor, t_est: torch.Tensor,
               r_gt: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """ADD: the mean distance between the model points (N, 3) under the
    estimated and the true pose, (..., 3, 3) rotations and (..., 3)
    translations -> (...,) (``metrics.py:37-48``)."""
    pe = _transform(points, r_est, t_est)
    pg = _transform(points, r_gt, t_gt)
    return (pe - pg).norm(dim=-1).mean(dim=-1)


def adds_metric(points, r_est: torch.Tensor, t_est: torch.Tensor, r_gt: torch.Tensor,
                t_gt: torch.Tensor, max_points=2000) -> torch.Tensor:
    """ADD-S: the mean distance from each estimated model point to the
    nearest true one (``metrics.py:51-70``).  Above ``max_points`` points
    the set is stride-subsampled (every ``N // max_points``-th point), so
    the (N, N) distance matrix stays bounded; None keeps every point."""
    n = points.shape[-2]
    if max_points is not None and n > max_points:
        points = points[..., :: n // max_points, :]
    pe = _transform(points, r_est, t_est)
    pg = _transform(points, r_gt, t_gt)
    d2 = ((pe[..., :, None, :] - pg[..., None, :, :]) ** 2).sum(dim=-1)
    return torch.sqrt(d2.min(dim=-1).values).mean(dim=-1)


def add_auc(adds, max_threshold: float) -> float:
    """Area under the accuracy-threshold curve of ADD(-S) values over
    [0, max_threshold], normalized to 1 (the YCB-Video protocol): each
    value adds max(0, max_threshold - value) exactly."""
    adds = np.asarray(adds, dtype=np.float64).reshape(-1)
    if adds.size == 0:
        return 0.0
    contrib = np.clip(max_threshold - adds, 0.0, max_threshold)
    return float(contrib.mean() / max_threshold)


def object_diameter(points, sample: int = 2048, seed: int = 0) -> float:
    """The largest pairwise distance of the model points, over a
    ``default_rng(seed)`` sample of ``sample`` of them when there are
    more."""
    pts = np.asarray(points)
    if len(pts) > sample:
        rng = np.random.default_rng(seed)
        pts = pts[rng.choice(len(pts), sample, replace=False)]
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    return float(np.sqrt(d2.max()))


def rotation_angle_deg(r_a, r_b) -> float:
    """The geodesic angle between two rotations, in degrees."""
    c = (np.trace(np.asarray(r_a).T @ np.asarray(r_b)) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def subsample_points(points, target: int = 1000) -> np.ndarray:
    """Every ``len // target``-th point when there are more than
    ``target`` (the BOP sweep scores both of its branches on these)."""
    pts = np.asarray(points)
    if len(pts) > target:
        pts = pts[:: len(pts) // target]
    return pts
