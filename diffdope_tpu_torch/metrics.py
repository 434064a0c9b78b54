"""Pose-accuracy metrics (counterpart of ``diffdope_tpu/metrics.py``)."""

from __future__ import annotations

import torch


def add_metric(points, r_est: torch.Tensor, t_est: torch.Tensor,
               r_gt: torch.Tensor, t_gt: torch.Tensor) -> torch.Tensor:
    """ADD: the mean distance between the model points (N, 3) under the
    estimated and the true pose, (..., 3, 3) rotations and (..., 3)
    translations -> (...,) (``metrics.py:37-48``)."""
    p = torch.as_tensor(points, dtype=r_est.dtype, device=r_est.device)
    pe = p @ r_est.transpose(-1, -2) + t_est[..., None, :]
    pg = p @ r_gt.transpose(-1, -2) + t_gt[..., None, :]
    return (pe - pg).norm(dim=-1).mean(dim=-1)
