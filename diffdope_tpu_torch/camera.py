"""Camera model (counterpart of ``diffdope_tpu/camera.py``).

Pinhole intrinsics and the OpenGL projection they give; one (4, 4)
projection serves every hypothesis.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from diffdope_tpu_torch.geometry import projection_from_intrinsics


@dataclass
class Camera:
    """Pinhole intrinsics -> OpenGL projection (``cam_proj``, (4, 4)
    float32, the y_down convention)."""

    fx: float
    fy: float
    cx: float
    cy: float
    im_width: int
    im_height: int
    znear: float = 0.01
    zfar: float = 200.0

    def __post_init__(self):
        self.cam_proj = self.get_projection_matrix()

    def get_projection_matrix(self) -> np.ndarray:
        return projection_from_intrinsics(
            self.fx, self.fy, self.cx, self.cy,
            self.im_width, self.im_height, self.znear, self.zfar,
        ).astype(np.float32)

    def resize(self, percentage: float) -> None:
        """Scale the intrinsics for resized images, with the reference's int
        truncation of cx, cy, width and height (``camera.py:47-56``)."""
        self.fx *= percentage
        self.fy *= percentage
        self.cx = int(percentage * self.cx)
        self.cy = int(percentage * self.cy)
        self.im_width = int(percentage * self.im_width)
        self.im_height = int(percentage * self.im_height)
        self.cam_proj = self.get_projection_matrix()

    def set_batchsize(self, batchsize: int) -> None:  # noqa: ARG002
        """No-op: one projection serves every hypothesis."""

    def cuda(self) -> None:
        """No-op: the projection goes to the device of the entry point that
        uses it (its ``device=``, the card by default)."""
