"""Pose, quaternion and projection math.

Counterpart of ``diffdope_tpu/geometry.py:59-180, 245``.  The tensor
functions are plain torch and differentiable; the host helpers
(axis-angle, projection) are numpy, as in the reference.  Quaternion
layout everywhere: (x, y, z, w).
"""

from __future__ import annotations

import numpy as np
import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) to unit length, gradients intact.  The norm
    is summed in a fixed order, so CPU and GPU give the same bits."""
    x, y, z, w = q.unbind(-1)
    n = torch.sqrt(((x * x + y * y) + z * z) + w * w)[..., None]
    return q / torch.maximum(n, n.new_tensor(eps))


def matmul44(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) @ (..., 4, 4) as elementwise products summed in a fixed
    order: the same bits on every device (a BLAS product may fuse or
    reorder), so the CPU and the card raster the same table."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, 4):
        out = out + a[..., :, k : k + 1] * b[..., k : k + 1, :]
    return out


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 (x) q2, so R(q1 (x) q2) = R(q1) @ R(q2)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + w2 * x1 + (y1 * z2 - z1 * y2),
            w1 * y2 + w2 * y1 + (z1 * x2 - x1 * z2),
            w1 * z2 + w2 * z1 + (x1 * y2 - y1 * x2),
            w1 * w2 - (x1 * x2 + y1 * y2 + z1 * z2),
        ],
        dim=-1,
    )


def quat_multiply_np(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Host (float64) Hamilton product, for building initial poses."""
    return quat_multiply(
        torch.as_tensor(np.asarray(q1, np.float64)),
        torch.as_tensor(np.asarray(q2, np.float64)),
    ).numpy()


def matrix33_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Column-vector rotation matrix from unit quaternion (...,4)->(...,3,3)."""
    x, y, z, w = q.unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - z * w)
    r02 = 2.0 * (x * z + y * w)
    r10 = 2.0 * (x * y + z * w)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - x * w)
    r20 = 2.0 * (x * z - y * w)
    r21 = 2.0 * (y * z + x * w)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def matrix44_from_quat_trans(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B,4) quat + (B,3) translation -> (B,4,4) homogeneous transform."""
    r = matrix33_from_quat(q)
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = r.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([r, t[..., :, None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device
    ).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def quat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """Axis-angle -> unit quaternion (x,y,z,w). Host-side numpy."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    half = 0.5 * angle
    return np.concatenate([axis * np.sin(half), [np.cos(half)]])


def projection_from_intrinsics(
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    im_width: int,
    im_height: int,
    znear: float = 0.01,
    zfar: float = 200.0,
    window_coords: str = "y_down",
    skew: float = 0.0,
) -> np.ndarray:
    """Hartley-Zisserman intrinsics -> 4x4 OpenGL projection (float64)."""
    w, h, nc, fc = float(im_width), float(im_height), float(znear), float(zfar)
    depth = fc - nc
    q = -(fc + nc) / depth
    qn = -2.0 * fc * nc / depth
    if window_coords == "y_up":
        row1 = [0.0, -2.0 * fy / h, (-2.0 * cy + h) / h, 0.0]
    elif window_coords == "y_down":
        row1 = [0.0, 2.0 * fy / h, (2.0 * cy - h) / h, 0.0]
    else:
        raise ValueError(f"window_coords must be y_up or y_down, got {window_coords}")
    return np.array(
        [
            [2.0 * fx / w, -2.0 * skew / w, (-2.0 * cx + w) / w, 0.0],
            row1,
            [0.0, 0.0, q, qn],
            [0.0, 0.0, -1.0, 0.0],
        ],
        dtype=np.float64,
    )
