"""Sun Raster decoding in numpy, as cv2 reads it (``grfmt_sunras.cpp``).

The reference reads its images through cv2 (``diffdope_tpu/image.py:59``,
``image.py:64``, ``mesh.py:435``, ``mesh.py:1033``).  cv2 takes a Sun
Raster file of the old (0) or standard (1) type at 1, 8, 24 or 32 bits a
pixel, with no colour map or an RGB one (its planes R, G, B) of at most
``3 << depth`` bytes for 1 and 8 bits; every other header gives None,
the byte-encoded (2) and RGB-ordered (3) types included (its header check
compares those against the image's OpenCV type, not the file's).  Rows
are padded to 16 bits.  What it gives:

- 24 and 32 bits: BGR (the stored B, G, R; a 32-bit pixel's first byte
  skipped), in both modes;
- 1 and 8 bits with a colour map that is not grey: BGR of the map's
  entries (those past the map black), in both modes;
- 1 and 8 bits otherwise: ``IMREAD_COLOR`` gives the map's entries, or
  the grey ramp (0, 255 at 1 bit) without a map; ``IMREAD_UNCHANGED``
  gives (H, W) grey, each entry's ``(R 4899 + G 9617 + B 1868 + 2**13)
  >> 14``, and 0 everywhere without a map (cv2 fills its grey table from
  the colour map only).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional

import numpy as np

SIGNATURE = b"\x59\xa6\x6a\x95"


def _where(source: Optional[str]) -> str:
    return str(source) if source is not None else "<bytes>"


def _header(data: bytes, source: Optional[str]) -> Optional[Dict]:
    """The header and colour map, or None where cv2's header check fails."""
    if len(data) < 32 or not data.startswith(SIGNATURE):
        raise ValueError(f"{_where(source)}: not a Sun Raster file")
    _, w, h, depth, _, kind, maptype, maplength = struct.unpack(">8I", data[:32])
    pal_size = 3 << depth if 0 < depth <= 8 else 0
    if not (w and h and depth in (1, 8, 24, 32) and kind in (0, 1)
            and ((maptype == 0 and maplength == 0)
                 or (maptype == 1 and 0 < maplength <= pal_size))):
        return None
    palette = None
    if maplength:
        raw = data[32:32 + maplength]
        if len(raw) != maplength:
            raise ValueError(f"{_where(source)}: Sun Raster colour map past the end")
        n = maplength // 3
        palette = np.zeros((1 << depth, 3), np.uint8)  # RGB, black past the map
        palette[:n] = np.frombuffer(raw[:3 * n], np.uint8).reshape(3, n).T
    return dict(width=w, height=h, depth=depth, palette=palette, offset=32 + maplength)


def _rows(data: bytes, head: Dict, source: Optional[str]) -> np.ndarray:
    """The pixel rows, (H, row bytes) uint8, their 16-bit padding cut."""
    w, h, depth = head["width"], head["height"], head["depth"]
    used = (w * depth + 7) // 8
    pitch = (used + 1) & ~1
    body = np.frombuffer(data, np.uint8)[head["offset"]:head["offset"] + pitch * h]
    if body.size < pitch * h:
        raise ValueError(f"{_where(source)}: truncated Sun Raster data ({body.size} of "
                         f"{pitch * h} bytes)")
    return body.reshape(h, pitch)[:, :used]


def _indices(rows: np.ndarray, head: Dict) -> np.ndarray:
    if head["depth"] == 8:
        return rows
    return np.unpackbits(rows, axis=1)[:, :head["width"]]


def _colour(data: bytes, head: Dict, source: Optional[str]) -> np.ndarray:
    """BGR (H, W, 3)."""
    rows = _rows(data, head, source)
    depth = head["depth"]
    if depth > 8:
        size = depth // 8
        return np.ascontiguousarray(
            rows.reshape(head["height"], head["width"], size)[..., size - 3:])
    palette = head["palette"]
    if palette is None:  # cv2's grey ramp
        palette = np.repeat((np.arange(1 << depth) * 255 // ((1 << depth) - 1)
                             ).astype(np.uint8)[:, None], 3, axis=1)
    return np.ascontiguousarray(palette[_indices(rows, head)][..., ::-1])


def _grey_palette(palette: np.ndarray) -> bool:
    return bool((palette == palette[:, :1]).all())


def decode_unchanged(data: bytes, source: Optional[str] = None) -> Optional[np.ndarray]:
    """``cv2.imdecode(data, IMREAD_UNCHANGED)`` of Sun Raster bytes: (H, W,
    3) BGR, or (H, W) grey for 1 and 8 bits without a colour map or with a
    grey one; None where cv2's header check fails."""
    head = _header(data, source)
    if head is None:
        return None
    palette = head["palette"]
    if head["depth"] > 8 or (palette is not None and not _grey_palette(palette)):
        return _colour(data, head, source)
    indices = _indices(_rows(data, head, source), head)
    if palette is None:
        return np.zeros(indices.shape, np.uint8)
    v = palette.astype(np.int32)
    grey = ((v[:, 0] * 4899 + v[:, 1] * 9617 + v[:, 2] * 1868 + 8192) >> 14).astype(np.uint8)
    return grey[indices]


def decode_color(data: bytes, source: Optional[str] = None) -> Optional[np.ndarray]:
    """``cv2.imdecode(data, IMREAD_COLOR)`` of Sun Raster bytes, then RGB:
    (H, W, 3) uint8, or None where cv2's header check fails."""
    head = _header(data, source)
    if head is None:
        return None
    return np.ascontiguousarray(_colour(data, head, source)[..., ::-1])
