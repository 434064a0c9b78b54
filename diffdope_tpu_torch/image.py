"""Image and Scene containers (counterpart of ``diffdope_tpu/image.py``).

Images come from arrays (``img_tensor=``): one (H, W[, C]) float32 array
each, shared by every hypothesis.  Reading image files needs cv2, which
the port does not depend on: a path raises (ROADMAP queue 1, item 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Image:
    """One image (rgb, depth or segmentation) as a float32 numpy array."""

    img_path: Optional[str] = None
    img_tensor: Optional[np.ndarray] = None
    img_resize: float = 1.0
    flip_img: bool = True
    depth: bool = False
    depth_scale: float = 100.0

    def __post_init__(self):
        if self.img_path is not None:
            raise NotImplementedError(
                "reading images from files needs cv2 and is not ported yet: "
                "pass img_tensor= (ROADMAP queue 1, item 1)"
            )
        if self.img_tensor is not None:
            self.img_tensor = np.asarray(self.img_tensor, dtype=np.float32)

    @property
    def shape(self):
        return self.img_tensor.shape


@dataclass
class Scene:
    """The rgb / depth / segmentation images of one optimization."""

    path_img: Optional[str] = None
    path_depth: Optional[str] = None
    path_segmentation: Optional[str] = None
    image_resize: Optional[float] = 1.0

    tensor_rgb: Optional[Image] = None
    tensor_depth: Optional[Image] = None
    tensor_segmentation: Optional[Image] = None

    def __post_init__(self):
        resize = 1.0 if self.image_resize is None else self.image_resize
        if self.path_img is not None and self.tensor_rgb is None:
            self.tensor_rgb = Image(self.path_img, img_resize=resize)
        if self.path_depth is not None and self.tensor_depth is None:
            self.tensor_depth = Image(self.path_depth, img_resize=resize, depth=True)
        if self.path_segmentation is not None and self.tensor_segmentation is None:
            self.tensor_segmentation = Image(self.path_segmentation, img_resize=resize)

    def get_resolution(self):
        """[H, W] of the optimization images."""
        for img in (self.tensor_rgb, self.tensor_segmentation, self.tensor_depth):
            if img is not None and img.img_tensor is not None:
                return [img.img_tensor.shape[0], img.img_tensor.shape[1]]
        raise ValueError("Scene has no images")

    def gt_arrays(self) -> dict:
        """{'rgb', 'depth', 'segmentation'} arrays, those present.  The
        segmentation stays the normalized float mask, a single-channel one
        repeated to 3 channels (``image.py:128-145``)."""
        out = {}
        if self.tensor_rgb is not None:
            out["rgb"] = self.tensor_rgb.img_tensor
        if self.tensor_depth is not None:
            out["depth"] = self.tensor_depth.img_tensor
        if self.tensor_segmentation is not None:
            seg = self.tensor_segmentation.img_tensor
            if seg.ndim == 2:
                seg = np.repeat(seg[..., None], 3, axis=-1)
            out["segmentation"] = seg
        return out
