"""TIFF decoding in numpy and zlib, as cv2 reads TIFF through libtiff.

The reference reads every image through cv2 (``diffdope_tpu/image.py:59``,
``image.py:64``, ``mesh.py:1030``, ``mesh.py:417``).  cv2 reads the first
page of a TIFF file along one of two paths, and :func:`decode_unchanged`
and :func:`decode_color` repeat both bit for bit:

- 8-bit results (``IMREAD_COLOR``, and ``IMREAD_UNCHANGED`` of an 8-bit
  file or of 16-bit grey with alpha) go through libtiff's RGBA reader
  (``tif_getimage.c``): grey keeps the high byte of 16 bits and is
  inverted for WhiteIsZero, 16-bit RGB becomes ``(v + 128) // 257``, a
  colormap is taken as 8-bit when no entry reaches 256 and shifted right
  by 8 otherwise, and an unassociated alpha (ExtraSamples 2) premultiplies
  the colour, ``(c * a + 127) // 255``.  ``IMREAD_UNCHANGED`` then gives
  (H, W) for grey (its alpha dropped), BGR for a palette or RGB and BGRA
  for RGB with an extra sample.  A float32 file gives None here, as cv2
  does (libtiff's RGBA reader takes no 32-bit samples).
- Other ``IMREAD_UNCHANGED`` results (16-bit and float32 files) are the
  samples as stored: (H, W), BGR or BGRA, WhiteIsZero not inverted.

The orientation tag (274) is applied as cv2 (5.0 and 4.13) applies it in
both modes: the EXIF transform of :func:`orient`, except that on a tiled
file read through the RGBA reader an orientation that flips left-right
(2, 3, 6, 7) reverses the order of the tiles in each row and not the
columns inside a tile (libtiff flips each tile, cv2 the whole row).
``cv2.imread`` of a file whose orientation transposes it (5-8) gives None
in both modes, ``cv2.imdecode`` the transposed image (``from_file``).

Layout: classic TIFF in either byte order, strips or tiles,
PlanarConfiguration 1 or 2, compression none, LZW (new style), deflate
(8 and 32946) and PackBits, predictor 2 (horizontal, per sample at 8, 16
and 32 bits) and 3 (floating point) where libtiff runs one (LZW and
deflate), 8- and 16-bit unsigned and 32-bit float samples, photometric
WhiteIsZero, BlackIsZero, RGB (with or without an extra sample) and
palette.  Everything else that cv2 reads raises ``ValueError`` naming the
variant and the file: BigTIFF, JPEG and CCITT compression, old-style LZW,
YCbCr, CMYK and CIE Lab colour, 1/2/4-bit, signed, 32-bit integer, 16- and
64-bit float samples, and, under ``IMREAD_UNCHANGED``, planar samples at
16 or 32 bits (cv2 reads those planes as interleaved samples).

LZW is the one Python loop: the code-by-code string table
(:func:`_lzw_decode`); the variable-width codes are cut from the bits in
numpy, one run of a width at a time.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURES = (b"II*\x00", b"MM\x00*")
BIGTIFF = (b"II+\x00", b"MM\x00+")

#: field type -> (struct code, bytes)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4)}
_COMPRESSION = {2: "CCITT modified Huffman RLE", 3: "CCITT Group 3 fax",
                4: "CCITT Group 4 fax", 32771: "CCITT RLE (word aligned)",
                6: "JPEG (old-style JPEG-in-TIFF)", 7: "JPEG (JPEG-in-TIFF)",
                34712: "JPEG 2000", 50000: "ZSTD", 34925: "LZMA", 50001: "WebP",
                32809: "ThunderScan", 32908: "PixarLog", 32909: "PixarLog"}
_PHOTOMETRIC = {4: "transparency mask", 5: "CMYK (separated)", 6: "YCbCr",
                8: "CIE L*a*b*", 9: "ICC L*a*b*", 10: "ITU L*a*b*", 32844: "LogL",
                32845: "LogLuv", 32803: "CFA"}
#: LZW: codes read after a Clear at 9, 10 and 11 bits (then 12)
_LZW_RUNS = ((254, 9), (766, 10), (1790, 11))
_LZW_ROOTS = [bytes((i,)) for i in range(256)]
_LZW_CSIZE = 4095 + 1024


def _where(source: Optional[str]) -> str:
    return str(source) if source is not None else "<bytes>"


def _refuse(source: Optional[str], variant: str):
    raise ValueError(f"{_where(source)}: TIFF {variant}: cv2 reads it, the port does not")


# ---------------------------------------------------------------------------
# the directory
# ---------------------------------------------------------------------------

def _ifd(data: bytes, source: Optional[str]) -> Tuple[str, Dict[int, list]]:
    """The byte order and the first IFD's fields: tag -> values."""
    if data[:4] in BIGTIFF:
        _refuse(source, "BigTIFF (64-bit offsets)")
    if data[:4] not in SIGNATURES:
        raise ValueError(f"{_where(source)}: not a TIFF file")
    end = "<" if data[:2] == b"II" else ">"
    (at,) = struct.unpack(end + "I", data[4:8])
    if at + 2 > len(data):
        raise ValueError(f"{_where(source)}: TIFF directory past the end of the file")
    (n,) = struct.unpack(end + "H", data[at:at + 2])
    fields = {}
    for i in range(n):
        entry = data[at + 2 + 12 * i:at + 14 + 12 * i]
        if len(entry) < 12:
            raise ValueError(f"{_where(source)}: truncated TIFF directory")
        tag, kind, count = struct.unpack(end + "HHI", entry[:8])
        if kind not in _TYPES:
            continue
        code, size = _TYPES[kind]
        nbytes = size * count
        if nbytes <= 4:
            raw = entry[8:8 + nbytes]
        else:
            (off,) = struct.unpack(end + "I", entry[8:12])
            raw = data[off:off + nbytes]
            if len(raw) < nbytes:
                raise ValueError(f"{_where(source)}: TIFF field {tag} past the end")
        fields[tag] = list(struct.unpack(end + code * count, raw)) if count else []
    return end, fields


def _one(fields, tag: int, default: int) -> int:
    vals = fields.get(tag)
    return int(vals[0]) if vals else default


def _header(data: bytes, source: Optional[str]) -> Dict:
    """The first page's geometry and sample format, every variant the port
    does not decode refused by name."""
    end, f = _ifd(data, source)
    if 256 not in f or 257 not in f:
        raise ValueError(f"{_where(source)}: TIFF without ImageWidth or ImageLength")
    w, h = _one(f, 256, 0), _one(f, 257, 0)
    spp = _one(f, 277, 1)
    bits = f.get(258) or [1]
    if len(set(bits)) != 1:
        _refuse(source, f"with mixed bits per sample {bits}")
    bits = int(bits[0])
    fmt = f.get(339) or [1]
    fmt = int(fmt[0])
    comp = _one(f, 259, 1)
    if 262 not in f:
        raise ValueError(f"{_where(source)}: TIFF without PhotometricInterpretation")
    photo = _one(f, 262, 1)
    planar = _one(f, 284, 1)
    predictor = _one(f, 317, 1)
    if comp not in (1, 5, 8, 32773, 32946):
        _refuse(source, f"compression {comp} ({_COMPRESSION.get(comp, 'unknown')})")
    if photo in _PHOTOMETRIC or photo not in (0, 1, 2, 3):
        _refuse(source, f"photometric {photo} ({_PHOTOMETRIC.get(photo, 'unknown')})")
    if _one(f, 266, 1) != 1:
        _refuse(source, "FillOrder 2 (bits least significant first)")
    if bits in (1, 2, 4):
        _refuse(source, f"{bits}-bit samples")
    if fmt == 2:
        _refuse(source, f"signed {bits}-bit samples")
    if fmt == 3 and bits != 32:
        _refuse(source, f"{bits}-bit float samples")
    if fmt not in (1, 3) or bits not in (8, 16, 32) or (fmt == 1 and bits == 32):
        _refuse(source, f"{bits}-bit samples of SampleFormat {fmt}")
    extra = tuple(int(v) for v in f.get(338, []))
    colours = 3 if photo == 2 else 1
    if spp not in (colours, colours + 1) or (fmt == 3 and spp == 2):
        _refuse(source, f"{spp} samples per pixel with photometric {photo}")
    if photo == 3 and (bits != 8 or spp != 1 or 320 not in f):
        _refuse(source, f"palette at {bits} bits and {spp} samples (or no ColorMap)")
    if planar not in (1, 2):
        raise ValueError(f"{_where(source)}: TIFF PlanarConfiguration {planar}")
    if predictor not in (1, 2, 3):
        _refuse(source, f"predictor {predictor}")
    if comp not in (5, 8, 32946):
        predictor = 1  # libtiff registers the predictor with LZW and deflate only
    if predictor == 3 and fmt != 3:
        _refuse(source, f"floating-point predictor on {bits}-bit integer samples")
    tiled = 322 in f
    if tiled:
        tw, th = _one(f, 322, 0), _one(f, 323, 0)
        offsets, counts = f.get(324), f.get(325)
        if not tw or not th or tw % 16 or th % 16:
            raise ValueError(f"{_where(source)}: TIFF tiles of {tw}x{th}")
    else:
        tw, th = w, min(_one(f, 278, 2 ** 32 - 1), h)
        offsets, counts = f.get(273), f.get(279)
    if not w or not h or not offsets or counts is None:
        raise ValueError(f"{_where(source)}: TIFF without image data")
    cmap = None
    if photo == 3:
        cmap = np.asarray(f[320], np.uint16)
        if cmap.size != 3 * 256:
            raise ValueError(f"{_where(source)}: TIFF ColorMap of {cmap.size} entries")
        cmap = cmap.reshape(3, 256)
    return dict(end=end, width=w, height=h, spp=spp, bits=bits, float=fmt == 3,
                compression=comp, photometric=photo, planar=planar, predictor=predictor,
                tiled=tiled, block=(tw, th), offsets=offsets, counts=counts,
                extra=extra, colormap=cmap, orientation=_one(f, 274, 1))


# ---------------------------------------------------------------------------
# decompression
# ---------------------------------------------------------------------------

def _lzw_codes(win: np.ndarray, pos: int, width: int, n: int) -> List[int]:
    """``n`` codes of ``width`` bits from bit ``pos`` on, most significant
    bit first; ``win`` holds the 32 bits from each byte on."""
    at = pos + width * np.arange(n, dtype=np.int64)
    shift = (32 - width - (at & 7)).astype(np.uint32)
    return ((win[at >> 3] >> shift) & ((1 << width) - 1)).tolist()


def _lzw_decode(raw: bytes, size: int, source: Optional[str]) -> bytes:
    """TIFF LZW (new style, as libtiff's ``LZWDecode``): up to ``size``
    bytes.  After a Clear, 254 codes are 9 bits wide, the next 512 are
    10, the next 1024 11, and the rest 12 (libtiff widens one entry
    early), so the codes are cut a run of equal width at a time and the
    string table is the only per-code loop."""
    if len(raw) >= 2 and raw[0] == 0 and raw[1] & 1:
        _refuse(source, "old-style LZW (pre-6.0 bit order)")
    buf = np.frombuffer(raw + b"\0\0\0\0", np.uint8).astype(np.uint32)
    win = (buf[:-3] << 24) | (buf[1:-2] << 16) | (buf[2:-1] << 8) | buf[3:]
    total = 8 * len(raw)
    out: List[bytes] = []
    produced, pos, since_clear = 0, 0, 0
    table: List[bytes] = _LZW_ROOTS + [b"", b""]
    prev: Optional[bytes] = None
    while produced < size:
        width, run_end = 12, since_clear + 4096
        for end_, w_ in _LZW_RUNS:
            if since_clear < end_:
                width, run_end = w_, end_
                break
        n = min(run_end - since_clear, (total - pos) // width)
        if n <= 0:
            break
        codes = _lzw_codes(win, pos, width, n)
        stop = False
        for k, code in enumerate(codes):
            if code == 256:  # Clear: the table restarts, the widths too
                table, prev = _LZW_ROOTS + [b"", b""], None
                pos += (k + 1) * width
                since_clear = 0
                break
            if code == 257:
                stop = True
                break
            if prev is None:
                if code > 255:
                    raise ValueError(f"{_where(source)}: corrupt TIFF LZW data")
                entry = table[code]
            elif code < len(table):
                entry = table[code]
                table.append(prev + entry[:1])
            elif code == len(table):
                entry = prev + prev[:1]
                table.append(entry)
            else:
                raise ValueError(f"{_where(source)}: corrupt TIFF LZW data")
            out.append(entry)
            produced += len(entry)
            prev = entry
            if produced >= size:
                stop = True
                break
        else:
            pos += n * width
            since_clear += n
            if len(table) > _LZW_CSIZE:
                raise ValueError(f"{_where(source)}: corrupt TIFF LZW table")
            continue
        if stop:
            break
    return b"".join(out)


def _unpackbits(raw: bytes, size: int) -> bytes:
    """PackBits (libtiff's ``PackBitsDecode``): up to ``size`` bytes."""
    out = bytearray()
    i, n = 0, len(raw)
    while i < n and len(out) < size:
        c = raw[i]
        i += 1
        if c < 128:
            out += raw[i:i + c + 1]
            i += c + 1
        elif c > 128:
            if i < n:
                out += raw[i:i + 1] * (257 - c)
            i += 1
    return bytes(out)


def _decompress(raw: bytes, comp: int, size: int, source: Optional[str]) -> bytes:
    if comp == 5:
        data = _lzw_decode(raw, size, source)
    elif comp in (8, 32946):
        try:
            data = zlib.decompressobj().decompress(raw, size)
        except zlib.error as err:
            raise ValueError(f"{_where(source)}: corrupt TIFF deflate data ({err})") from None
    elif comp == 32773:
        data = _unpackbits(raw, size)
    else:
        data = raw
    if len(data) < size:
        raise ValueError(f"{_where(source)}: truncated TIFF data ({len(data)} of {size} "
                         "bytes)")
    return data[:size]


def _block(data: bytes, head: Dict, index: int, rows: int, cols: int, ch: int,
           source: Optional[str]) -> np.ndarray:
    """Strip or tile ``index``: (rows, cols, ch) samples, native order,
    the predictor undone."""
    bits = head["bits"]
    size = rows * cols * ch * bits // 8
    off, count = int(head["offsets"][index]), int(head["counts"][index])
    raw = _decompress(data[off:off + count], head["compression"], size, source)
    kind = "f" if head["float"] else "u"
    if head["predictor"] == 3:
        planes = np.frombuffer(raw, np.uint8).reshape(rows, cols * 4, ch)
        planes = np.cumsum(planes, axis=1, dtype=np.uint8).reshape(rows, 4, cols * ch)
        samples = np.ascontiguousarray(planes.transpose(0, 2, 1)).view(">f4")
        return samples.astype(np.float32).reshape(rows, cols, ch)
    dtype = np.dtype(head["end"] + kind + str(bits // 8))
    samples = np.frombuffer(raw, dtype).reshape(rows, cols, ch)
    samples = samples.astype(dtype.newbyteorder("="))
    if head["predictor"] == 2:
        ints = samples.view(f"u{bits // 8}")
        samples = np.cumsum(ints, axis=1, dtype=ints.dtype).view(samples.dtype)
    return samples


def _samples(data: bytes, head: Dict, source: Optional[str]) -> np.ndarray:
    """The page's samples (H, W, spp) as stored, in native byte order."""
    h, w, spp = head["height"], head["width"], head["spp"]
    bw, bh = head["block"]
    planes = spp if head["planar"] == 2 else 1
    ch = spp // planes
    across, down = (-(-w // bw), -(-h // bh)) if head["tiled"] else (1, -(-h // bh))
    if len(head["offsets"]) < planes * across * down or \
            len(head["counts"]) < planes * across * down:
        raise ValueError(f"{_where(source)}: TIFF with too few strips or tiles")
    dtype = np.float32 if head["float"] else np.dtype(f"u{head['bits'] // 8}")
    out = np.empty((h, w, spp), dtype)
    index = 0
    for plane in range(planes):
        for by in range(down):
            for bx in range(across):
                y0, x0 = by * bh, bx * bw
                rows = bh if head["tiled"] else min(bh, h - y0)
                block = _block(data, head, index, rows, bw, ch, source)
                index += 1
                y1, x1 = min(h, y0 + bh), min(w, x0 + bw)
                out[y0:y1, x0:x1, plane * ch:(plane + 1) * ch] = block[:y1 - y0, :x1 - x0]
    return out


# ---------------------------------------------------------------------------
# cv2's two paths
# ---------------------------------------------------------------------------

def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """An image as cv2 leaves it for a TIFF or EXIF orientation
    (``ExifTransform`` in ``loadsave.cpp``): 2 flips left-right, 3 turns
    180 degrees, 4 flips top-bottom, 5 transposes, 6, 7 and 8 transpose
    and then flip left-right, both ways or top-bottom; 1 and any other
    value leave it as it is."""
    if orientation in (5, 6, 7, 8):
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _orient_rgba(img: np.ndarray, head: Dict) -> np.ndarray:
    """The orientation on the RGBA reader's result: a tiled file whose
    orientation flips left-right first has its tiles' columns put back in
    order inside each tile (libtiff flipped each tile where cv2 flips the
    row)."""
    o = head["orientation"]
    if head["tiled"] and o in (2, 3, 6, 7):
        tw = head["block"][0]
        flipped = img.copy()
        for x0 in range(0, img.shape[1], tw):
            flipped[:, x0:x0 + tw] = img[:, x0:x0 + tw][:, ::-1]
        img = flipped[:, ::-1]
    return orient(img, o)


def _rgba8(samples: np.ndarray, head: Dict) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """libtiff's RGBA reader on the samples: (RGB (H, W, 3) uint8, alpha
    (H, W) uint8 or None)."""
    photo, bits = head["photometric"], head["bits"]
    if photo == 3:
        cmap = head["colormap"]
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return cmap.astype(np.uint8).T[samples[..., 0]], None
    if photo in (0, 1):
        grey = samples[..., 0]
        grey = (grey >> 8).astype(np.uint8) if bits == 16 else grey
        if photo == 0:
            grey = 255 - grey
        return np.repeat(grey[..., None], 3, axis=-1), None
    vals = samples.astype(np.int32)
    if bits == 16:
        vals = (vals + 128) // 257
    rgb, alpha = vals[..., :3], None
    if head["spp"] == 4:
        alpha = vals[..., 3]
        if head["extra"][:1] == (2,):  # unassociated: premultiplied
            rgb = (rgb * alpha[..., None] + 127) // 255
    return rgb.astype(np.uint8), None if alpha is None else alpha.astype(np.uint8)


def _through_rgba(head: Dict) -> bool:
    """Whether ``IMREAD_UNCHANGED`` takes libtiff's RGBA reader (8-bit
    samples, and 16-bit grey with alpha, which cv2 reads as 8-bit)."""
    return head["bits"] == 8 or (head["bits"] == 16 and head["photometric"] in (0, 1)
                                 and head["spp"] == 2)


def decode_unchanged(data: bytes, source: Optional[str] = None,
                     from_file: bool = False) -> Optional[np.ndarray]:
    """``cv2.imdecode(data, IMREAD_UNCHANGED)`` of TIFF bytes: uint8,
    uint16 or float32; (H, W) grey, BGR or BGRA.  ``from_file`` gives
    ``cv2.imread``'s result instead, None for an orientation that
    transposes the image (cv2's ``imread`` refuses the image its TIFF
    decoder reallocates)."""
    head = _header(data, source)
    if from_file and head["orientation"] in (5, 6, 7, 8):
        return None
    samples = _samples(data, head, source)
    if _through_rgba(head):
        rgb, alpha = _rgba8(samples, head)
        if head["photometric"] in (0, 1):
            img = rgb[..., 0]
        elif alpha is not None:
            img = np.concatenate([rgb[..., ::-1], alpha[..., None]], axis=-1)
        else:
            img = rgb[..., ::-1]
        return _orient_rgba(img, head)
    if head["planar"] == 2 and head["spp"] > 1:
        _refuse(source, f"planar configuration 2 at {head['bits']} bits under "
                "IMREAD_UNCHANGED (cv2 reads the planes as interleaved samples)")
    if head["spp"] == 1:
        img = samples[..., 0]
    else:
        img = samples[..., [2, 1, 0, 3][:head["spp"]]]
    return orient(img, head["orientation"])


def decode_color(data: bytes, source: Optional[str] = None,
                 from_file: bool = False) -> Optional[np.ndarray]:
    """``cv2.imdecode(data, IMREAD_COLOR)`` of TIFF bytes, then RGB: (H, W,
    3) uint8, or None for float32 samples, as cv2 gives (and, with
    ``from_file``, for an orientation that transposes the image, as
    ``cv2.imread`` gives)."""
    head = _header(data, source)
    if head["float"] or (from_file and head["orientation"] in (5, 6, 7, 8)):
        return None
    rgb, _ = _rgba8(_samples(data, head, source), head)
    return _orient_rgba(rgb, head)
