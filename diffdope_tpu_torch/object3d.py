"""Object3D: the initial pose and the mesh (counterpart of
``diffdope_tpu/object3d.py``).

The optimized state is a fresh dict of seven (B,) pose tensors built for
each run (:meth:`Object3D.initial_params`).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from diffdope_tpu_torch.geometry import (
    matrix33_from_quat,
    opencv_to_opengl,
    quat_from_matrix33,
)
from diffdope_tpu_torch.mesh import Mesh, load_mesh
from diffdope_tpu_torch.optimize import pose_params

log = logging.getLogger(__name__)


class Object3D:
    """Pose + mesh container.

    Args:
        position: 3-list object position.
        rotation: quaternion (x, y, z, w), flat 3x3 or nested 3x3.
        batchsize: number of pose hypotheses.
        opencv2opengl: convert the pose from the OpenCV to the OpenGL frame.
        model_path: mesh file (.ply / .obj); a Mesh may be given instead.
        scale: applied to the mesh vertices and the position.
    """

    def __init__(self, position, rotation, batchsize: int = 32,
                 opencv2opengl: bool = True, model_path: Optional[str] = None,
                 scale: float = 1, mesh: Optional[Mesh] = None):
        self.mesh: Optional[Mesh] = mesh
        if model_path is not None and mesh is None:
            self.mesh = load_mesh(model_path, scale=scale)
        self.batchsize = batchsize
        self.set_pose(position, rotation, batchsize, opencv2opengl=opencv2opengl,
                      scale=scale)

    def set_pose(self, position, rotation, batchsize: Optional[int] = None,
                 opencv2opengl: bool = True, scale: float = 1) -> None:
        """Set a new initial pose (``object3d.py:55-78``)."""
        if batchsize is not None:
            self.batchsize = batchsize
        position = np.asarray(position, dtype=np.float64) * scale
        if opencv2opengl:
            position, quat = opencv_to_opengl(position, rotation)
        else:
            rot = np.asarray(rotation, dtype=np.float64)
            if rot.shape == (4,):
                quat = rot / np.linalg.norm(rot)
            else:
                quat = quat_from_matrix33(rot.reshape(3, 3))
        self._position = np.asarray(position, np.float64)
        self._rotation = np.asarray(quat, np.float64)
        log.info("translation loaded: %s", self._position)
        log.info("rotation loaded as quaternion: %s", self._rotation)

    def initial_params(self, batchsize: Optional[int] = None, device="cuda"):
        """Seven (B,) float32 tensors, every hypothesis at the initial pose."""
        b = batchsize if batchsize is not None else self.batchsize
        return pose_params(self._rotation, self._position, b, device)

    def initial_matrix(self) -> np.ndarray:
        """The initial pose as a 4x4 float64 matrix (OpenGL frame)."""
        m = np.eye(4, dtype=np.float64)
        m[:3, :3] = matrix33_from_quat(torch.as_tensor(self._rotation)).numpy()
        m[:3, 3] = self._position
        return m

    def set_batchsize(self, batchsize: int) -> None:
        self.batchsize = batchsize

    def reset_pose(self) -> None:
        """No-op: ``run_optimization`` builds the parameters from the stored
        pose on every run (``object3d.py:96-98``)."""

    def cuda(self) -> None:
        """No-op: each tensor goes to the device of the entry point that
        uses it (its ``device=``, the card by default)."""

    def forward(self) -> dict:
        """The mesh's arrays (``pos``, ``pos_idx``, ``vtx_color``, ``tex``,
        ``uv``, ``uv_idx``, ``vtx_normals``, where present) and copies of
        the initial ``quat`` and ``trans``, all numpy (``object3d.py:103-114``),
        for user code that inspects the object."""
        out = {}
        if self.mesh is not None:
            for key in ("pos", "pos_idx", "vtx_color", "tex", "uv", "uv_idx", "vtx_normals"):
                val = getattr(self.mesh, key, None)
                if val is not None:
                    out[key] = val
        out["quat"] = self._rotation.copy()
        out["trans"] = self._position.copy()
        return out

    __call__ = forward

    def __repr__(self):
        return (f"Object3D(pos={self._position}, quat={self._rotation}, "
                f"batch={self.batchsize}, mesh={getattr(self.mesh, 'path_model', None)})")
