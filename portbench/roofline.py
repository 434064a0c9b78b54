"""The yardstick of the roofline shares: each job's least bytes and
operations, counted from the problem (the frame, the mesh, the batch and
the pool's coverage) and never from what a kernel of the program touches,
and the chips' published peaks.

Each count is a lower bound on what any implementation of the job must do
at these inputs: every input byte read once, every output byte written
once, and only the arithmetic that the result depends on, a fused
multiply-add counted as two operations (the peaks count them so).

- The raster job (the pack and the rasterizer, forward and backward):
  project the mesh's vertices (24 operations a vertex), set up each
  triangle (47), test each covered pixel against its triangle's three edge
  planes and its z plane (16), and in the backward carry each covered
  pixel's gradient to its triangle's planes (24) and each triangle's and
  vertex's back to the pose (47 and 24).  It reads the mesh and the poses
  and hands the shading one id a covered pixel (4 bytes), which the
  backward reads again with three gradients a covered pixel (12 bytes),
  and writes the pose's gradient.
- The loss job (shade, antialias, L1, forward and backward): interpolate
  each colour channel at each covered pixel (5 a channel), blend each
  silhouette pair of pixels (10), take the L1 of each covered pixel's
  channels (3 a channel and the mask's 3), and the same again backward.
  It reads the ground truth where the object covers it (16 bytes a pixel),
  the ids of the covered pixels, and writes their three gradients.
- The whole step: both jobs' operations and the optimizer's (12 a
  parameter for Adam, 2 for SGD), and only the step's own inputs and
  outputs: the ground truth where covered, the mesh, the poses.

The pool's coverage is its frames' covered pixels and silhouette pairs,
the hypotheses' own at the true pose, which the refinement approaches.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

#: published peaks of a chip, by ``torch.cuda.get_device_name()``: bytes/s
#: of device memory and float32 operations/s outside the tensor cores
#: (NVIDIA's H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s)
PEAKS: Dict[str, Tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (3.35e12, 67e12),
}


@dataclass
class Work:
    """The problem's sizes that the counts read."""

    batch: int
    vertices: int
    triangles: int
    covered: float        # pixels the object covers in a frame, mean over the pool
    silhouette: float     # adjacent pixel pairs across the silhouette, mean over the pool
    channels: int         # colour channels the loss compares (0 or 3)
    optimizer: str


def coverage(seg: torch.Tensor) -> Tuple[float, float]:
    """(covered pixels, silhouette pairs), each the mean over the frames of
    the pool's masks ``seg`` (P, 3, H, W)."""
    fg = seg[:, 0] > 0
    pairs = (fg[:, :, 1:] != fg[:, :, :-1]).sum(dim=(1, 2)) \
        + (fg[:, 1:, :] != fg[:, :-1, :]).sum(dim=(1, 2))
    return float(fg.sum(dim=(1, 2)).double().mean()), float(pairs.double().mean())


def _mesh_bytes(w: Work) -> float:
    # positions and colours (N x 3 float32 each), triangles (T x 3 int32),
    # the poses (B x 7 float32) in, their gradient out
    return 24.0 * w.vertices + 12.0 * w.triangles + 2 * 28.0 * w.batch


def raster(w: Work) -> Tuple[float, float]:
    """(bytes, operations) of one step's raster job."""
    ops = w.batch * ((24 + 24) * w.vertices + (47 + 47) * w.triangles + (16 + 24) * w.covered)
    bytes_ = _mesh_bytes(w) + w.batch * w.covered * (4 + 4 + 12)
    return bytes_, float(ops)


def loss(w: Work) -> Tuple[float, float]:
    """(bytes, operations) of one step's loss job."""
    per_px = 5 * w.channels + 3 * w.channels + 3
    ops = 2 * w.batch * (per_px * w.covered + 10 * w.silhouette)
    bytes_ = 16.0 * w.covered + w.batch * w.covered * (4 + 12)
    return bytes_, float(ops)


def step(w: Work) -> Tuple[float, float]:
    """(bytes, operations) of one whole step."""
    opt = (12 if w.optimizer == "adam" else 2) * 7 * w.batch
    ops = raster(w)[1] + loss(w)[1] + opt
    return 16.0 * w.covered + _mesh_bytes(w), float(ops)


def least_seconds(counts: Tuple[float, float], device: str) -> Optional[float]:
    """The least time of (bytes, operations) at the chip's published
    peaks, or None for a chip the table lacks."""
    if device not in PEAKS:
        return None
    bw, flops = PEAKS[device]
    return max(counts[0] / bw, counts[1] / flops)
