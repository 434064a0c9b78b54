"""Pose, quaternion and projection math.

Counterpart of ``diffdope_tpu/geometry.py:59-245``.  The tensor
functions are plain torch and differentiable; the host helpers
(axis-angle, matrix -> quaternion, the OpenCV/OpenGL pose conversions,
projection) are numpy, as in the reference.  Quaternion layout
everywhere: (x, y, z, w).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

#: diag(1, -1, -1): flips the Y and Z axes between the OpenCV camera frame
#: (x right, y down, z forward) and OpenGL's (x right, y up, z backward)
CV_TO_GL_FLIP = np.diag([1.0, -1.0, -1.0]).astype(np.float64)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize quaternion(s) to unit length, gradients intact.  The norm
    is summed in a fixed order, so CPU and GPU give the same bits."""
    x, y, z, w = q.unbind(-1)
    n = torch.sqrt(((x * x + y * y) + z * z) + w * w)[..., None]
    return q / n.clamp(min=eps)


def matmul44(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) @ (..., 4, 4) as elementwise products summed in a fixed
    order: the same bits on every device (a BLAS product may fuse or
    reorder), so the CPU and the card raster the same table."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, 4):
        out = out + a[..., :, k : k + 1] * b[..., k : k + 1, :]
    return out


def xfm_points(points: torch.Tensor, matrix: torch.Tensor,
               use_python: bool = False) -> torch.Tensor:
    """Transform (..., N, 3) points by (..., 4, 4) matrices -> (..., N, 4),
    the homogeneous w kept (``geometry.py:289-312``, the reference's
    ``dd.xfm_points``).  True float32 (the reference's
    ``precision="highest"``): products summed in a fixed order, never a
    BLAS product, so TF32 cannot apply and every device gives the same
    bits.  Differentiable in both arguments.  ``use_python`` is accepted
    and ignored, as in the reference: this is the only path."""
    del use_python
    p = [points[..., c] for c in range(3)]  # (..., N) each

    def m(r, c):  # (..., 1): broadcasts against (..., N)
        return matrix[..., r, c, None]

    out = [((m(r, 0) * p[0] + m(r, 1) * p[1]) + m(r, 2) * p[2]) + m(r, 3)
           for r in range(4)]
    return torch.stack(out, dim=-1)


def xfm_vectors(vectors: torch.Tensor, matrix: torch.Tensor,
                use_python: bool = False) -> torch.Tensor:
    """Transform (..., N, 3) direction vectors by the rotation part of
    (..., 4, 4) matrices -> (..., N, 3) (``geometry.py:315-324``), in the
    fixed order of :func:`xfm_points`; ``use_python`` is ignored."""
    del use_python
    v = [vectors[..., c] for c in range(3)]
    out = [(matrix[..., r, 0, None] * v[0] + matrix[..., r, 1, None] * v[1])
           + matrix[..., r, 2, None] * v[2] for r in range(3)]
    return torch.stack(out, dim=-1)


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


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q (active rotation), in
    the reference's operation order (``geometry.py:83-88``)."""
    shape = torch.broadcast_shapes(q.shape[:-1] + (3,), v.shape)
    qv = q[..., :3].expand(shape)  # torch's cross does not broadcast ranks
    v = v.expand(shape)
    w = q[..., 3:4]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + w * t + torch.linalg.cross(qv, t, dim=-1)


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
    # (0, 0, 0, 1) made on the device: no host data enters a captured step
    bottom = top.new_zeros(batch + (1, 4))
    bottom[..., 3].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def quat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    """Axis-angle -> unit quaternion (x,y,z,w). Host-side numpy."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    half = 0.5 * angle
    return np.concatenate([axis * np.sin(half), [np.cos(half)]])


def quat_from_matrix33(m) -> np.ndarray:
    """Rotation matrix (3, 3) -> unit quaternion (x, y, z, w), host numpy
    float64, by Shepperd's method (``geometry.py:133-167``)."""
    m = np.asarray(m, dtype=np.float64).reshape(3, 3)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([x, y, z, w], dtype=np.float64)
    return q / np.linalg.norm(q)


def _rotation_from_any(rotation) -> np.ndarray:
    """A quaternion (4), a flat 3x3 (9) or a (3, 3) matrix -> (3, 3)
    float64, as the reference accepts rotations (``geometry.py:182-192``).
    A quaternion becomes a matrix in float32, as the reference's does
    (jax without 64-bit mode)."""
    rot = np.asarray(rotation, dtype=np.float64)
    if rot.shape == (4,):
        q = torch.as_tensor(rot, dtype=torch.float32)
        return matrix33_from_quat(q).numpy().astype(np.float64)
    if rot.shape == (9,):
        return rot.reshape(3, 3)
    if rot.shape == (3, 3):
        return rot
    raise ValueError(f"rotation must be quat(4), flat 3x3(9) or (3,3); got {rot.shape}")


def opencv_to_opengl(position, rotation,
                     conjugate_flip: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """An object pose in the OpenCV camera frame -> (position (3,), quat
    (4,)) in the OpenGL frame, float64 (``geometry.py:195-220``):
    ``t_gl = F t`` with F = diag(1, -1, -1), and ``R_gl = F R_cv F`` (the
    conjugate flip, the default) or, with ``conjugate_flip=False``, the
    single-sided ``R_gl = F R_cv``."""
    p = np.asarray(position, dtype=np.float64).reshape(3)
    f = CV_TO_GL_FLIP
    r_cv = _rotation_from_any(rotation)
    return f @ p, quat_from_matrix33(f @ r_cv @ f if conjugate_flip else f @ r_cv)


def opengl_to_opencv(matrix44, conjugate_flip: bool = True) -> np.ndarray:
    """Inverse of :func:`opencv_to_opengl` on a 4x4 OpenGL-frame pose ->
    the 4x4 OpenCV/BOP-frame pose (``geometry.py:223-238``): ``F R F``, or
    ``F.T R`` with ``conjugate_flip=False``."""
    m = np.asarray(matrix44, dtype=np.float64)
    f = CV_TO_GL_FLIP
    out = np.eye(4)
    out[:3, :3] = f @ m[:3, :3] @ f if conjugate_flip else f.T @ m[:3, :3]
    out[:3, 3] = f @ m[:3, 3]
    return out


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
