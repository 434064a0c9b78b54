"""Image and Scene containers (counterpart of ``diffdope_tpu/image.py``).

An image is one (H, W[, C]) float32 array, shared by every hypothesis,
given as an array (``img_tensor=``) or read from a file (``img_path=``)
the way the reference reads it with cv2 (``image.py:55-80``): colour as
RGB / 255 with the orientation applied, depth unchanged / depth_scale,
both in float64, flipped vertically, resized below a resize factor of 1
(linear for colour, nearest for depth), then cast to float32.  The port
reads PNG, JPEG, TIFF (16-bit, integer and float depth too), BMP, the
Netpbm family (PGM/PPM/PAM/PFM), WebP, GIF, Sun Raster, Radiance HDR and
OpenEXR (half, float and UINT depth; the gate ``OPENCV_IO_ENABLE_OPENEXR``
as cv2 4.13 has it) as cv2 does (``png.py`` and the decoders it hands
them to); a file cv2 reads no image from (a float32 TIFF as colour, a
TIFF whose orientation transposes it, a truncated EXR) raises
``FileNotFoundError`` as the reference does, other formats and the
variants the decoders refuse raise ``ValueError``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Optional

import numpy as np

from diffdope_tpu_torch.png import imread_color, imread_unchanged, resize_linear, \
    resize_nearest

log = logging.getLogger(__name__)


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
            if self.depth:
                im = imread_unchanged(self.img_path)
                if im is None:
                    raise FileNotFoundError(self.img_path)
                im = im.astype(np.float64) / self.depth_scale
            else:
                im = imread_color(self.img_path)
                if im is None:
                    raise FileNotFoundError(self.img_path)
                im = im / 255.0
            if self.flip_img:
                im = im[::-1]
            if self.img_resize is not None and self.img_resize < 1.0:
                size = (int(im.shape[1] * self.img_resize), int(im.shape[0] * self.img_resize))
                im = (resize_nearest if self.depth else resize_linear)(im, size)
            self.img_tensor = np.ascontiguousarray(im, dtype=np.float32)
            log.info("Loaded image %s, shape %s", self.img_path, self.img_tensor.shape)
        elif self.img_tensor is not None:
            self.img_tensor = np.asarray(self.img_tensor, dtype=np.float32)

    @property
    def shape(self):
        return self.img_tensor.shape

    def __repr__(self):
        shape = None if self.img_tensor is None else self.img_tensor.shape
        return f"Image({shape} @ {self.img_path})"


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
