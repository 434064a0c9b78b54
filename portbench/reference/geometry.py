"""Pose and projection arithmetic of the plain reference.

Quaternions are (x, y, z, w).  Products and sums are written out in a
fixed order, so that the card and the CPU give the same bits, as the
configurations' f32 contract asks of the program.
"""

from __future__ import annotations

import numpy as np
import torch


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    n = torch.sqrt(((x * x + y * y) + z * z) + w * w)[..., None]
    return q / n.clamp(min=eps)


def matrix33_from_quat(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    rows = [
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - z * w), 2.0 * (x * z + y * w)],
        [2.0 * (x * y + z * w), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - x * w)],
        [2.0 * (x * z - y * w), 2.0 * (y * z + x * w), 1.0 - 2.0 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def pose_matrix(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, 4) quaternions, normalized here, and (B, 3) translations ->
    (B, 4, 4) poses."""
    r = matrix33_from_quat(quat_normalize(q))
    top = torch.cat([r, t[..., :, None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype, device=top.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def matmul44(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, 4):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def xfm_points(points: torch.Tensor, matrix: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) points by (..., 4, 4) matrices -> (..., N, 4)."""
    p = [points[..., c] for c in range(3)]

    def m(r, c):
        return matrix[..., r, c, None]

    return torch.stack([((m(r, 0) * p[0] + m(r, 1) * p[1]) + m(r, 2) * p[2]) + m(r, 3)
                        for r in range(4)], dim=-1)


def projection(fx: float, fy: float, cx: float, cy: float, width: float, height: float,
               znear: float, zfar: float) -> np.ndarray:
    """Pinhole intrinsics -> the OpenGL projection (y down), float64."""
    w, h = float(width), float(height)
    depth = zfar - znear
    return np.array([
        [2.0 * fx / w, 0.0, (-2.0 * cx + w) / w, 0.0],
        [0.0, 2.0 * fy / h, (2.0 * cy - h) / h, 0.0],
        [0.0, 0.0, -(zfar + znear) / depth, -2.0 * zfar * znear / depth],
        [0.0, 0.0, -1.0, 0.0],
    ], dtype=np.float64)


def quat_from_axis_angle(axis, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([axis * np.sin(0.5 * angle), [np.cos(0.5 * angle)]])


def quat_multiply(q1, q2) -> np.ndarray:
    """Hamilton product in float64: R(q1 q2) = R(q1) R(q2)."""
    x1, y1, z1, w1 = np.asarray(q1, np.float64)
    x2, y2, z2, w2 = np.asarray(q2, np.float64)
    return np.array([w1 * x2 + w2 * x1 + (y1 * z2 - z1 * y2),
                     w1 * y2 + w2 * y1 + (z1 * x2 - x1 * z2),
                     w1 * z2 + w2 * z1 + (x1 * y2 - y1 * x2),
                     w1 * w2 - (x1 * x2 + y1 * y2 + z1 * z2)])


def quat_from_matrix(m) -> np.ndarray:
    """(3, 3) rotation -> unit quaternion, float64 (Shepperd's method)."""
    m = np.asarray(m, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        q = [(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s,
             0.25 * s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        q = [0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s,
             (m[2, 1] - m[1, 2]) / s]
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        q = [(m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s,
             (m[0, 2] - m[2, 0]) / s]
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        q = [(m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s,
             (m[1, 0] - m[0, 1]) / s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def random_unit(rng: np.random.Generator) -> np.ndarray:
    v = rng.normal(size=3)
    return v / np.linalg.norm(v)


def random_quat(rng: np.random.Generator) -> np.ndarray:
    """A rotation drawn uniformly (a normalized 4-d normal draw)."""
    q = rng.normal(size=4)
    return q / np.linalg.norm(q)
