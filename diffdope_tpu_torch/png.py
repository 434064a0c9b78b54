"""Image reading in numpy and zlib (PNG here; JPEG, TIFF, BMP, the
Netpbm family, WebP, GIF, Sun Raster, Radiance HDR and OpenEXR in
``jpeg.py``, ``tiff.py``, ``bmp.py``, ``netpbm.py``, ``webp.py``,
``gif.py``, ``sunras.py``, ``hdr.py`` and ``exr.py``), and the image
resizes of the reference.

The reference reads its images with cv2 (``diffdope_tpu/image.py:55-80``,
``mesh.py:1030``, ``mesh.py:417``), which the port does not depend on.
This module decodes PNG files itself, hands the other formats (told by
their signature, whatever the file's name) to their decoders, and returns
what cv2 returns:

- :func:`imread_color` is ``cv2.imread(path)`` (``IMREAD_COLOR``) then
  ``COLOR_BGR2RGB``: RGB uint8 (H, W, 3), grey replicated, alpha dropped,
  a palette expanded, 16 bits reduced to their high byte (a PNG's), and
  the EXIF orientation (a JPEG's APP1, a PNG's ``eXIf``, a TIFF's tag, a
  WebP's EXIF chunk) applied as cv2 applies it (``tiff.orient``); None
  where cv2 gives None (a TIFF of 32- or 64-bit samples, a WebP libwebp
  rejects, a file a decoder's header check refuses, an OpenEXR file
  OpenEXR 2.3 fails on, and from a file a TIFF whose orientation
  transposes it or a one-channel PFM);
  :func:`decode_color` is the same for bytes (``cv2.imdecode``, which
  returns the transposed TIFF);
- :func:`imread_unchanged` is ``cv2.imread(path, IMREAD_UNCHANGED)``: the
  file's depth (uint8, uint16, float32 for a PFM, a Radiance HDR or an
  OpenEXR file, and a TIFF's sample type: int8 to 64-bit integers,
  float32, float64), (H, W) for grey, else cv2's BGR or BGRA channel
  order (an OpenEXR file's grey and alpha as two channels); a PNG's or
  JPEG's
  orientation ignored (a TIFF's applied, as cv2 does);
  :func:`decode_unchanged` is the same for bytes.

Every PNG colour type, every bit depth and Adam7 interlacing are read;
the five row filters are undone along the image's anti-diagonals, so a
step is one vectorised update of every row (:func:`_unfilter`).  Other
formats (JPEG 2000, AVIF; anything else as "unknown") and the variants
the other decoders refuse (OpenEXR deep data, for one) raise
``ValueError`` naming the format and the file: cv2 would read them, the
port cannot read them the way it does.  An OpenEXR read raises
``exr.CodecDisabled`` (a ``ValueError``) unless ``OPENCV_IO_ENABLE_OPENEXR``
is 1 or true, as cv2 4.13 raises.

:func:`resize_linear` and :func:`resize_nearest` are ``cv2.resize`` with
``INTER_LINEAR`` and ``INTER_NEAREST`` on float64 images, down to their
rounding: an exact 2x downscale takes cv2's ``INTER_AREA`` 2x2 mean.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from diffdope_tpu_torch import bmp, exr, gif, hdr, jpeg, netpbm, sunras, tiff, webp

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: samples per pixel of each colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
#: Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
#: the signatures of the formats cv2 reads and the port does not
_OTHER_FORMATS = {b"\x00\x00\x00\x0cjP  ": "JPEG 2000", b"\xffO\xffQ": "JPEG 2000"}
#: ISO-BMFF brands of AVIF (the ftyp box's major or a compatible brand)
_AVIF_BRANDS = (b"avif", b"avis")


def _format_name(data: bytes) -> str:
    for magic, name in _OTHER_FORMATS.items():
        if data.startswith(magic):
            return name
    if data[4:8] == b"ftyp" and len(data) >= 16:
        (size,) = struct.unpack(">I", data[:4])
        brands = [data[at:at + 4] for at in range(8, min(size, len(data)) - 3, 4) if at != 12]
        if any(b in _AVIF_BRANDS for b in brands):
            return "AVIF"
    return "unknown"


def _exif_orientation(exif: bytes) -> int:
    """The TIFF orientation tag (0x0112) of a PNG ``eXIf`` chunk or a JPEG
    APP1 EXIF block, 1 if absent."""
    if len(exif) < 8 or exif[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if exif[:2] == b"II" else ">"
    (ifd,) = struct.unpack(end + "I", exif[4:8])
    if ifd + 2 > len(exif):
        return 1
    (n,) = struct.unpack(end + "H", exif[ifd:ifd + 2])
    for i in range(n):
        at = ifd + 2 + 12 * i
        if at + 12 > len(exif):
            break
        tag, typ = struct.unpack(end + "HH", exif[at:at + 4])
        if tag == 0x0112 and typ == 3:
            return struct.unpack(end + "H", exif[at + 8:at + 10])[0]
    return 1


def _chunks(data: bytes):
    """(type, body) of every chunk up to IEND, each CRC checked."""
    at = len(SIGNATURE)
    while at + 12 <= len(data):
        (length,) = struct.unpack(">I", data[at:at + 4])
        kind = data[at + 4:at + 8]
        body = data[at + 8:at + 8 + length]
        if len(body) != length or at + 12 + length > len(data):
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[at + 8 + length:at + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        if kind == b"IEND":
            return
        at += 12 + length
    raise ValueError("PNG without IEND")


def _unfilter(raw: np.ndarray, rows: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the row filters of ``rows`` scanlines of ``stride`` bytes (each
    after its filter byte) -> (rows, stride) uint8.

    Filter units are ``bpp`` bytes (a pixel, or a byte below 8 bits).  A
    unit depends on its left, upper and upper-left units only, which lie
    on the two earlier anti-diagonals, so the units are undone one
    anti-diagonal at a time, every row at once, each row's filter chosen
    by a mask: rows + stride / bpp steps."""
    lines = raw[: rows * (stride + 1)].reshape(rows, stride + 1)
    kinds = lines[:, 0].astype(np.int64)
    if (kinds > 4).any():
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    units = stride // bpp
    filt = lines[:, 1:].reshape(rows, units, bpp).astype(np.int32)
    if not kinds.any():
        return lines[:, 1:].copy()
    if (kinds <= 1).all():  # None and Sub only: a cumulative sum per row
        sub = kinds == 1
        out = filt.copy()
        out[sub] = np.cumsum(filt[sub], axis=1)
        return (out & 255).astype(np.uint8).reshape(rows, stride)
    # the decoded units with a zero row above and a zero unit left, flat:
    # unit (y, x) of the image sits at y * units + d + units + 2 when x =
    # d - y, so an anti-diagonal is a strided slice, and so are its left
    # (-1), upper (-(units + 1)) and upper-left (-(units + 2)) neighbours
    dec = np.zeros(((rows + 1) * (units + 1), bpp), np.int16)
    flat = filt.reshape(rows * units, bpp).astype(np.int16)
    sel = kinds[:, None]
    for d in range(rows + units - 1):
        y0, y1 = max(0, d - units + 1), min(rows, d + 1)
        at = y0 * units + d + units + 2
        end = at + units * (y1 - y0 - 1) + 1
        a = dec[at - 1:end - 1:units]
        b = dec[at - units - 1:end - units - 1:units]
        c = dec[at - units - 2:end - units - 2:units]
        pa, pb = np.abs(b - c), np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(sel[y0:y1], (np.zeros_like(a), a, b, (a + b) >> 1, paeth))
        f0 = y0 * (units - 1) + d
        step = max(units - 1, 1)  # one unit a diagonal when units is 1
        dec[at:end:units] = (flat[f0:f0 + step * (y1 - y0 - 1) + 1:step] + pred) & 255
    dec = dec.reshape(rows + 1, units + 1, bpp)
    return dec[1:, 1:].astype(np.uint8).reshape(rows, stride)


def _samples(raw: np.ndarray, h: int, w: int, ch: int, depth: int) -> np.ndarray:
    """One non-interlaced image's samples (h, w, ch), uint8 or uint16, the
    values below 8 bits unscaled."""
    bits = w * ch * depth
    stride = -(-bits // 8)
    bpp = max(1, ch * depth // 8)
    rows = _unfilter(raw, h, stride, bpp)
    if depth == 16:
        out = (rows[:, 0::2].astype(np.uint16) << 8) | rows[:, 1::2]
    elif depth == 8:
        out = rows
    else:
        bit = np.unpackbits(rows, axis=1)[:, : bits]
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        out = (bit.reshape(h, w * ch, depth) * weights).sum(axis=-1, dtype=np.uint8)
    return out.reshape(h, w, ch)


def decode_png(data: bytes, source: Optional[str] = None) -> Tuple[np.ndarray, Dict]:
    """Decode PNG bytes -> (samples (H, W, C) uint8 or uint16, header).

    The samples are as stored: palette indices for colour type 3, values
    below 8 bits unscaled.  The header holds 'width', 'height',
    'bit_depth', 'color_type', 'interlace', 'palette' ((n, 3) uint8 or
    None), 'trns' (the tRNS body or None) and 'orientation' (the eXIf
    chunk's, 1 without one).  ``source`` (a path) names the file in the
    errors."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{source or '<bytes>'}: not a PNG file (format: "
                         f"{format_name(data)}): the port reads PNG, JPEG, TIFF, BMP, "
                         "PBM/PGM/PPM, PAM, PFM, WebP, GIF, Sun Raster, Radiance HDR and "
                         "OpenEXR images only")
    head, idat, palette, trns, orientation = None, [], None, None, 1
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            w, h, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB", body)
            if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
                raise ValueError(f"PNG colour type {ctype} at {depth} bits is invalid")
            if comp or filt or inter > 1 or not w or not h:
                raise ValueError("PNG header: unknown compression, filter or interlace")
            head = dict(width=w, height=h, bit_depth=depth, color_type=ctype,
                        interlace=inter)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            orientation = _exif_orientation(body)
    if head is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    if head["color_type"] == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    head.update(palette=palette, trns=trns, orientation=orientation)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    h, w, depth = head["height"], head["width"], head["bit_depth"]
    ch = _CHANNELS[head["color_type"]]
    if not head["interlace"]:
        return _samples(raw, h, w, ch, depth), head
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in _ADAM7:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        size = ph * (1 + -(-pw * ch * depth // 8))
        out[y0::dy, x0::dx] = _samples(raw[at:at + size], ph, pw, ch, depth)
        at += size
    return out, head


def _read(path) -> bytes:
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(str(path))
    return path.read_bytes()


def _to8(samples: np.ndarray, depth: int) -> np.ndarray:
    """Samples -> uint8: 16 bits keep their high byte, 1/2/4-bit grey is
    scaled to 0..255 (libpng's strip_16 and expand_gray_1_2_4_to_8)."""
    if depth == 16:
        return (samples >> 8).astype(np.uint8)
    if depth < 8:
        return (samples * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return samples


def _rgba(samples: np.ndarray, head: Dict, keep16: bool) -> np.ndarray:
    """The samples as RGB or RGBA (palette expanded, its tRNS as alpha),
    grey channels left as they are; 8 bits unless ``keep16``."""
    depth, ctype = head["bit_depth"], head["color_type"]
    if ctype == 3:
        idx = samples[..., 0]
        pal = head["palette"]
        if int(idx.max()) >= len(pal):
            raise ValueError("palette index past the PLTE")
        if head["trns"] is not None:
            alpha = np.full(len(pal), 255, np.uint8)
            t = np.frombuffer(head["trns"], np.uint8)[: len(pal)]
            alpha[: len(t)] = t
            return np.concatenate([pal, alpha[:, None]], axis=1)[idx]
        return pal[idx]
    if depth == 16 and keep16:
        return samples
    if ctype in (0, 4):
        grey = _to8(samples[..., :1], depth)
        return grey if ctype == 0 else np.concatenate(
            [grey, _to8(samples[..., 1:], depth)], axis=-1)
    return _to8(samples, depth)


def imread_color(path) -> Optional[np.ndarray]:
    """``cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)``: (H, W, 3)
    uint8 RGB; grey replicated, alpha dropped (never blended), 16 bits
    reduced to the high byte, the orientation applied; None where
    ``cv2.imread`` gives None (a float32 TIFF, a TIFF whose orientation
    transposes it, a one-channel PFM).  ``FileNotFoundError`` for a
    missing file, ``ValueError`` for any other format or a variant the
    decoders refuse."""
    return _decode_color(_read(path), str(path), True)


def decode_color(data: bytes) -> Optional[np.ndarray]:
    """:func:`imread_color` of bytes (``cv2.imdecode`` with
    ``IMREAD_COLOR``, then RGB).  ``cv2.imdecode`` differs from
    ``cv2.imread`` where a decoder replaces the image it was handed: a
    TIFF whose orientation transposes it is returned transposed, a
    one-channel PFM raises (cv2 returns one channel)."""
    return _decode_color(data, None, False)


def _decode_color(data: bytes, source: Optional[str], from_file: bool
                  ) -> Optional[np.ndarray]:
    if data.startswith(jpeg.SIGNATURE):
        img = jpeg.decode_jpeg(data, source)
        img = np.repeat(img[..., None], 3, axis=-1) if img.ndim == 2 else img[..., ::-1]
        return tiff.orient(img, _exif_orientation(jpeg.exif(data)))
    if data[:4] in tiff.SIGNATURES + tiff.BIGTIFF:
        return tiff.decode_color(data, source, from_file)
    if data.startswith(bmp.SIGNATURE):
        return bmp.decode_color(data, source)
    if netpbm.matches(data):
        return netpbm.decode_color(data, source, from_file)
    if webp.matches(data):
        out = webp.decode_webp(data, source)
        if out is None:
            return None
        img, exif = out
        return tiff.orient(img[..., 2::-1], _exif_orientation(exif))
    if gif.matches(data):
        img = gif.decode_gif(data, source)
        return None if img is None else np.ascontiguousarray(img[..., 2::-1])
    if data.startswith(sunras.SIGNATURE):
        return sunras.decode_color(data, source)
    if hdr.matches(data):
        return hdr.decode_color(data, source)
    if exr.matches(data):
        return exr.decode_color(data, source)
    samples, head = decode_png(data, source)
    return tiff.orient(_color(samples, head), head["orientation"])


def format_name(data: bytes) -> str:
    """'PNG', 'JPEG', 'TIFF', 'BMP', 'PNM', 'PAM', 'PFM', 'WebP', 'GIF',
    'Sun Raster', 'Radiance HDR', 'OpenEXR', or the name of another image
    format by its signature ('JPEG 2000', 'AVIF', else 'unknown')."""
    if data.startswith(SIGNATURE):
        return "PNG"
    if data.startswith(jpeg.SIGNATURE):
        return "JPEG"
    if data[:4] in tiff.SIGNATURES + tiff.BIGTIFF:
        return "TIFF"
    if data.startswith(bmp.SIGNATURE):
        return "BMP"
    if netpbm.matches(data):
        return netpbm.format_name(data)
    if webp.matches(data):
        return "WebP"
    if gif.matches(data):
        return "GIF"
    if data.startswith(sunras.SIGNATURE):
        return "Sun Raster"
    if hdr.matches(data):
        return "Radiance HDR"
    if exr.matches(data):
        return "OpenEXR"
    return _format_name(data)


def _color(samples: np.ndarray, head: Dict) -> np.ndarray:
    img = _rgba(samples, head, keep16=False)
    if img.shape[-1] in (1, 2):
        img = np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def imread_unchanged(path) -> Optional[np.ndarray]:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``, None where cv2 gives
    None (a TIFF whose orientation transposes it).  A JPEG is (H, W) uint8
    grey or (H, W, 3) BGR, its EXIF orientation ignored as cv2 ignores it
    in this mode.  A PNG keeps its depth (uint16 at 16 bits, else uint8,
    values below 8 bits scaled to 0..255 for grey); (H, W) for grey,
    (H, W, 3) BGR or (H, W, 4) BGRA in cv2's channel order for colour, a
    palette expanded, a tRNS as alpha (on a palette or an RGB image; a
    grey one's is ignored), grey with alpha as BGRA.  TIFF, BMP and the
    Netpbm family as ``tiff.py``, ``bmp.py`` and ``netpbm.py`` say; a WebP
    is BGR, or BGRA when its header declares alpha, its orientation
    ignored; None where libwebp rejects the file, as cv2 gives.  An
    OpenEXR file is float32 as ``exr.py`` says."""
    return _decode_unchanged(_read(path), str(path), True)


def decode_unchanged(data: bytes) -> np.ndarray:
    """:func:`imread_unchanged` of bytes (``cv2.imdecode`` with
    ``IMREAD_UNCHANGED``): a TIFF whose orientation transposes it is
    returned transposed."""
    return _decode_unchanged(data, None, False)


def _decode_unchanged(data: bytes, source: Optional[str], from_file: bool
                      ) -> Optional[np.ndarray]:
    if data.startswith(jpeg.SIGNATURE):
        return jpeg.decode_jpeg(data, source)
    if data[:4] in tiff.SIGNATURES + tiff.BIGTIFF:
        return tiff.decode_unchanged(data, source, from_file)
    if data.startswith(bmp.SIGNATURE):
        return bmp.decode_unchanged(data, source)
    if netpbm.matches(data):
        return netpbm.decode_unchanged(data, source)
    if webp.matches(data):
        out = webp.decode_webp(data, source)
        return None if out is None else out[0]
    if gif.matches(data):
        return gif.decode_gif(data, source)
    if data.startswith(sunras.SIGNATURE):
        return sunras.decode_unchanged(data, source)
    if hdr.matches(data):
        return hdr.decode_unchanged(data, source)
    if exr.matches(data):
        return exr.decode_unchanged(data, source)
    samples, head = decode_png(data, source)
    img = _rgba(samples, head, keep16=True)
    if head["color_type"] == 0:
        if head["bit_depth"] < 8:
            img = _to8(samples, head["bit_depth"])
        return np.ascontiguousarray(img[..., 0])
    if img.shape[-1] == 2:  # grey + alpha
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], axis=-1)
    elif head["color_type"] == 2 and head["trns"] is not None:
        # RGB with a transparent colour: alpha 0 there, opaque elsewhere
        key = np.asarray(struct.unpack(">HHH", head["trns"][:6]))
        opaque = np.iinfo(img.dtype).max
        alpha = np.where((samples == key).all(axis=-1), 0, opaque).astype(img.dtype)
        img = np.concatenate([img, alpha[..., None]], axis=-1)
    order = [2, 1, 0, 3][: img.shape[-1]]
    return np.ascontiguousarray(img[..., order])


# ---------------------------------------------------------------------------
# resizes
# ---------------------------------------------------------------------------

def _linear_taps(dst: int, src: int, clamp_weight: bool):
    """cv2's INTER_LINEAR source indices and weights per output index, in
    float64: f = (d + 0.5) * src / dst - 0.5, s = floor(f), weights 1 -
    (f - s) and f - s; the columns (``clamp_weight``) put a tap before the
    first or on the last source index at weight 0 on that index, the rows
    keep f and clamp the second row index."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if clamp_weight:
        low = s < 0
        high = s >= src - 1
        f[low | high] = 0.0
        s[low] = 0
        s[high] = src - 1
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), 1.0 - f, f


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`` for a
    float64 (H, W) or (H, W, C) image, ``size`` = (width, height).

    An exact 2x downscale in both axes is cv2's ``INTER_AREA`` fast path:
    each output the mean of its 2x2 block, (top + bottom) row pairs'
    sums times 0.25, within an ulp of cv2's (2.2e-16 on values in [0,
    1]; no order of a plain sum of the four gives cv2's bits).
    Otherwise the separable bilinear filter with float64 weights: the
    columns first, then the rows, each tap pair a0 * s0 + a1 * s1.  Held
    to cv2 5.0 at random sizes and factors: within 1e-13 in float64, equal
    after a cast to float32.  (cv2 takes float32 positions for a source of
    a single row or column: such images are not matched.)"""
    img = np.asarray(img, np.float64)
    w_out, h_out = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if w == 2 * w_out and h == 2 * h_out:
        tl, tr = img[0::2, 0::2], img[0::2, 1::2]
        bl, br = img[1::2, 0::2], img[1::2, 1::2]
        return ((tl + tr) + (bl + br)) * 0.25
    xs0, xs1, xa0, xa1 = _linear_taps(w_out, w, clamp_weight=True)
    ys0, ys1, yb0, yb1 = _linear_taps(h_out, h, clamp_weight=False)
    extra = (None,) * (img.ndim - 2)
    cols = img[:, xs0] * xa0[(None, slice(None)) + extra] \
        + img[:, xs1] * xa1[(None, slice(None)) + extra]
    return cols[ys0] * yb0[(slice(None), None) + extra] \
        + cols[ys1] * yb1[(slice(None), None) + extra]


def resize_nearest(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_NEAREST)``: output
    (x, y) takes source (floor(x * src_w / dst_w), floor(y * src_h /
    dst_h)), the scales as cv2 computes them in float64."""
    img = np.asarray(img)
    w_out, h_out = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    xs = np.minimum(np.floor(np.arange(w_out) * (1.0 / (w_out / w))).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(h_out) * (1.0 / (h_out / h))).astype(np.int64), h - 1)
    return img[ys][:, xs]
