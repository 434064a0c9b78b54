"""Host-side visualization utilities (numpy/cv2, no autograd).

Counterpart of ``diffdope_tpu/viz.py``, copied function for function (the
port imports nothing of the JAX package), with the same contracts as the
original diff-dope's image stack (its diffdope.py:242-528 and the
render_img/make_animation/plot_losses methods):

* :func:`find_crop` — square crop around the nonzero region (+margin);
* :func:`make_grid` — tile a batch of images into one grid;
* :func:`make_grid_image` — grid -> uint8 BGR at a target width;
* :func:`make_grid_overlay_batch` — alpha-blend renders over the gt image
  with silhouette contours;
* :func:`depth_to_rgb` — depth map -> displayable 3-channel image;
* :func:`plot_losses_image` — loss curves -> ndarray (matplotlib Agg);
* :func:`write_animation` — frame iterator -> mp4 (imageio/libx264, else
  cv2.VideoWriter).

Plain numpy; cv2, matplotlib and imageio are imported inside the
functions that use them, never at module level, so importing the package
needs none of them.
"""

from __future__ import annotations

import io
from typing import Iterable, List, Optional, Sequence

import numpy as np


def find_crop(img: np.ndarray, percentage: float = 0.1) -> List[int]:
    """Square crop [top, left, size] around nonzero pixels (+margin).

    Contract matches the reference `find_crop` (diffdope.py:242-274),
    including growing the box by `percentage` of its extent per side and
    returning a square of the larger side.  Raises ValueError on an empty
    image (the reference crashes with an unhelpful min() error there).
    """
    img = np.asarray(img)
    if img.ndim == 3:
        img = img[..., 0]
    rows, cols = np.nonzero(img > 0)
    if rows.size == 0:
        raise ValueError("find_crop: image has no nonzero pixels")
    top, bottom = int(rows.min()), int(rows.max())
    left, right = int(cols.min()), int(cols.max())
    wiggle_r = int((bottom - top + 1) * percentage)
    wiggle_c = int((right - left + 1) * percentage)
    top = max(0, top - wiggle_r)
    left = max(0, left - wiggle_c)
    bottom = min(img.shape[0] - 1, bottom + wiggle_r)
    right = min(img.shape[1] - 1, right + wiggle_c)
    size = max(bottom - top, right - left)
    return [top, left, size]


def depth_to_rgb(depth: np.ndarray, depth_max: float = 3.0) -> np.ndarray:
    """Depth (H,W) -> (H,W,3) in [0,1] (reference getimg_stack depth branch,
    diffdope.py:277-292: negatives clamp to depth_max, then normalize)."""
    d = np.asarray(depth, np.float32).copy()
    d[d < 0] = depth_max
    d = d / depth_max
    return np.repeat(d[..., None], 3, axis=-1)


def im_resize(image: np.ndarray, width: Optional[int] = None, height: Optional[int] = None) -> np.ndarray:
    """Aspect-preserving resize by target width or height (reference
    diffdope.py:312-333)."""
    import cv2

    h, w = image.shape[:2]
    if width is None and height is None:
        return image
    if width is None:
        r = height / float(h)
        dim = (int(w * r), height)
    else:
        r = width / float(w)
        dim = (width, int(h * r))
    return cv2.resize(image, dim)


def _norm_ip(img: np.ndarray, low: float, high: float) -> np.ndarray:
    """Clamp to [low, high] then affinely map to [0, 1] (the reference's
    vendored torchvision norm_ip, diffdope.py:336-442)."""
    img = np.clip(img, low, high)
    return (img - low) / max(high - low, 1e-5)


def make_grid(
    images: np.ndarray,
    nrow: int = 8,
    padding: int = 2,
    pad_value: float = 0.0,
    normalize: bool = False,
    value_range: Optional[Sequence[float]] = None,
    scale_each: bool = False,
) -> np.ndarray:
    """Tile (B,H,W,C) images into a grid of `nrow` columns.

    Fresh numpy implementation of the torchvision-style grid the reference
    vendors (diffdope.py:336-442); channels-last throughout.  `normalize`
    shifts/scales into [0, 1] using `value_range` (low, high) when given,
    else each image's own min/max (`scale_each=True`) or the batch-wide
    min/max — same semantics as the reference's norm_ip/norm_range pair.
    """
    images = np.asarray(images)
    if images.ndim == 3:
        images = images[None]
    if normalize:
        if value_range is not None and len(value_range) != 2:
            raise ValueError(
                "value_range must be (low, high), got "
                f"{value_range!r}"
            )
        images = np.asarray(images, np.float32)
        if scale_each:
            images = np.stack(
                [
                    _norm_ip(
                        im,
                        *(value_range or (float(im.min()), float(im.max()))),
                    )
                    for im in images
                ]
            )
        else:
            lo, hi = value_range or (
                float(images.min()),
                float(images.max()),
            )
            images = _norm_ip(images, lo, hi)
    b, h, w, c = images.shape
    ncol = min(nrow, b)
    nrows = -(-b // ncol)
    grid = np.full(
        (padding + nrows * (h + padding), padding + ncol * (w + padding), c),
        pad_value,
        images.dtype,
    )
    for k in range(b):
        r, col = divmod(k, ncol)
        y = padding + r * (h + padding)
        x = padding + col * (w + padding)
        grid[y : y + h, x : x + w] = images[k]
    return grid


def make_grid_image(
    img_batch: np.ndarray,
    row: int,
    final_width: int,
    depth: bool = False,
) -> np.ndarray:
    """(B,H,W,C) [0,1] -> uint8 BGR grid resized to `final_width`
    (reference make_grid_image, diffdope.py:445-460)."""
    import cv2

    img_batch = np.asarray(img_batch)
    if depth and img_batch.ndim == 3:
        img_batch = np.stack([depth_to_rgb(d) for d in img_batch])
    grid = make_grid(img_batch, nrow=row)
    grid8 = np.clip(grid * 255.0, 0, 255).astype(np.uint8)
    grid8 = cv2.cvtColor(grid8, cv2.COLOR_RGB2BGR)
    if depth:
        grid8 = cv2.applyColorMap(grid8, cv2.COLORMAP_JET)
    return im_resize(grid8, width=final_width)


def make_grid_overlay_batch(
    foreground: np.ndarray,
    background: Optional[np.ndarray] = None,
    alpha: float = 0.5,
    row: int = 2,
    final_width: int = 2000,
    add_background: bool = True,
    add_contour: bool = True,
    color_contour: Sequence[float] = (0.14, 1.0, 0.05),
    flip_result: bool = True,
) -> np.ndarray:
    """Overlay rendered images on the gt image as a grid with contours.

    Contract matches reference make_grid_overlay_batch (diffdope.py:463-528):
    the foreground is alpha-blended only where it is non-black, silhouette
    contours are drawn, and the result is vertically flipped back to normal
    orientation by default (the pipeline works on flipped images).
    Difference: `color_contour` (normalized RGB) is honored — the reference
    accepts the argument but draws a hard-coded green.
    """
    import cv2

    fg = make_grid_image(foreground, row, final_width)
    if background is not None and add_background:
        bg = make_grid_image(background, row, final_width)
    else:
        bg = np.zeros_like(fg)

    gray = cv2.cvtColor(fg, cv2.COLOR_BGR2GRAY)
    alpha_img = np.where(gray > 0, alpha, 0.0)[..., None]
    blended = (alpha_img * fg + (1.0 - alpha_img) * bg).astype(np.uint8)

    if add_contour:
        cnts, _ = cv2.findContours(
            (gray > 0).astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
        )
        col = tuple(int(c * 255) for c in reversed(list(color_contour)))  # RGB->BGR
        cv2.drawContours(blended, cnts, -1, col, thickness=1, lineType=cv2.LINE_AA)

    if flip_result:
        blended = cv2.flip(blended, 0)
    return blended


def plot_losses_image(losses_values: dict, batch_index: int) -> Optional[np.ndarray]:
    """Loss curves for one hypothesis -> BGR ndarray (reference plot_losses,
    diffdope.py:1573-1616)."""
    if not losses_values:
        return None
    import cv2
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 6))
    for key, values in losses_values.items():
        plt.plot(np.asarray(values)[..., batch_index], marker="o", label=key)
    plt.legend()
    plt.xlabel("iteration")
    plt.ylabel("loss")
    buf = io.BytesIO()
    plt.savefig(buf, format="png", bbox_inches="tight")
    plt.close()
    buf.seek(0)
    data = np.frombuffer(buf.getvalue(), np.uint8)
    img = cv2.imdecode(data, cv2.IMREAD_COLOR)
    return img


def write_animation(
    frames: Iterable[np.ndarray],
    output_file_path: str,
    frame_rate: int = 10,
) -> None:
    """Write BGR frames to an mp4 (reference make_animation,
    diffdope.py:1515-1552).  Uses imageio/libx264 when an ffmpeg backend is
    available, falling back to cv2.VideoWriter (mp4v) otherwise."""
    import cv2

    frames = iter(frames)
    try:
        import imageio

        writer = imageio.get_writer(
            output_file_path, mode="I", fps=frame_rate, codec="libx264",
            bitrate="16M",
        )
        use_imageio = True
    except Exception:
        writer = None
        use_imageio = False

    if use_imageio:
        try:
            for frame in frames:
                writer.append_data(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            writer.close()
            return
        except ValueError:
            # imageio present but no ffmpeg backend: fall through to cv2
            writer.close()

    vw = None
    for frame in frames:
        if vw is None:
            h, w = frame.shape[:2]
            vw = cv2.VideoWriter(
                str(output_file_path), cv2.VideoWriter_fourcc(*"mp4v"),
                frame_rate, (w, h),
            )
        vw.write(frame)
    if vw is not None:
        vw.release()
