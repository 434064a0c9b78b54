"""The port's PNG reader and resizes (``diffdope_tpu_torch/png.py``) against
cv2, which the reference reads and resizes its images with.

cv2 writes PNGs of every colour type and depth it can (grey, BGR, BGRA at
8 and 16 bits) at several compression levels and row filters; the port's
own encoder (``testing.encode_png``) writes what cv2 cannot (palettes,
1/2/4-bit grey, grey with alpha, tRNS, Adam7 interlacing), with every row
filter.  Both read modes must equal ``cv2.imread`` exactly, a JPEG and a
PNG ``eXIf`` orientation included (``tests/test_torch_jpeg.py`` holds the
JPEG reader at length); a TIFF raises by name.  The resizes
are held to ``cv2.resize``: INTER_NEAREST exactly, INTER_LINEAR within
1e-12 in float64 (measured: 2.5e-14 at most; the exact 2x downscale, cv2's
INTER_AREA path, 2.2e-16, as cv2's sum of the four differs by an ulp
from every order of a plain sum) and exactly after the reference's cast
to float32.
"""

import struct
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from diffdope_tpu_torch import png  # noqa: E402
from diffdope_tpu_torch.testing import encode_png, write_png  # noqa: E402
from torch_scene import one_torch_thread  # noqa: E402, F401


def _smooth(shape, maxval, dtype, seed=0):
    """An image with smooth gradients and noise, so every filter wins rows."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    y, x = np.mgrid[0:h, 0:w]
    base = np.sin(x / 17.0) * np.cos(y / 13.0) * 0.4 + 0.5
    if len(shape) == 3:
        base = base[..., None] * np.linspace(0.6, 1.0, shape[2])
    noise = rng.integers(0, 6, shape)
    return np.clip(base * maxval + noise, 0, maxval).astype(dtype)


def _cv2_color(path):
    return cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_torch_png_reads_cv2_files(tmp_path, channels, dtype):
    shape = (37, 53) if channels == 1 else (37, 53, channels)
    img = _smooth(shape, np.iinfo(dtype).max, dtype)
    path = tmp_path / "a.png"
    for level in (0, 3, 9):
        for filt in (cv2.IMWRITE_PNG_FILTER_NONE, cv2.IMWRITE_PNG_FILTER_SUB,
                     cv2.IMWRITE_PNG_FILTER_UP, cv2.IMWRITE_PNG_FILTER_AVG,
                     cv2.IMWRITE_PNG_FILTER_PAETH, cv2.IMWRITE_PNG_ALL_FILTERS):
            assert cv2.imwrite(str(path), img, [cv2.IMWRITE_PNG_COMPRESSION, level,
                                                cv2.IMWRITE_PNG_FILTER, filt])
            _same(png.imread_unchanged(path), cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
            _same(png.imread_color(path), _cv2_color(path))


def test_torch_png_reads_a_full_hd_frame(tmp_path):
    img = _smooth((1080, 1920, 3), 255, np.uint8, seed=1)
    path = tmp_path / "rgb.png"
    cv2.imwrite(str(path), img)
    _same(png.imread_color(path), _cv2_color(path))
    depth = _smooth((1080, 1920), 65535, np.uint16, seed=2)
    cv2.imwrite(str(path), depth)
    _same(png.imread_unchanged(path), depth)


#: (colour type, bit depth) that cv2 does not write
OWN_TYPES = [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16),
             (0, 8), (2, 16), (6, 8)]


@pytest.mark.parametrize("ctype,depth", OWN_TYPES)
def test_torch_png_reads_every_colour_type(tmp_path, ctype, depth):
    rng = np.random.default_rng(ctype * 100 + depth)
    h, w = 23, 29
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for interlace in (False, True):
        for with_trns in (False, True):
            palette = trns = None
            if ctype == 3:
                n = min(1 << depth, 20)
                samples = rng.integers(0, n, (h, w, 1))
                palette = rng.integers(0, 256, (n, 3))
                if with_trns:
                    trns = bytes(rng.integers(0, 256, n // 2).astype(np.uint8))
            else:
                samples = rng.integers(0, 1 << depth, (h, w, ch))
                if with_trns and ctype in (0, 2):
                    trns = b"".join(int(v).to_bytes(2, "big") for v in samples[3, 4])
                elif with_trns:
                    continue
            samples = samples.astype(np.uint16 if depth == 16 else np.uint8)
            data = encode_png(samples, ctype, depth, "cycle", interlace, palette, trns,
                              idat_size=97)
            got, head = png.decode_png(data)
            _same(got, samples)
            assert head["interlace"] == int(interlace)
            path = tmp_path / "b.png"
            path.write_bytes(data)
            _same(png.imread_unchanged(path), cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
            _same(png.imread_color(path), _cv2_color(path))


@pytest.mark.parametrize("shape,dtype", [((31, 17), np.uint8), ((31, 17, 3), np.uint8),
                                         ((31, 17, 4), np.uint8), ((31, 17), np.uint16),
                                         ((31, 17, 3), np.uint16)])
def test_torch_write_png_cycle_round_trips(tmp_path, shape, dtype):
    img = _smooth(shape, np.iinfo(dtype).max, dtype, seed=3)
    path = tmp_path / "c.png"
    write_png(path, img, filters="cycle")
    kinds = set()
    raw = np.frombuffer(zlib.decompress(_idat(path.read_bytes())), np.uint8)
    stride = 1 + int(np.prod(shape[1:])) * np.dtype(dtype).itemsize
    kinds.update(raw[::stride].tolist())
    assert kinds == {0, 1, 2, 3, 4}
    want = img if img.ndim == 2 else img[..., [2, 1, 0, 3][: img.shape[-1]]]
    _same(png.imread_unchanged(path), want)
    _same(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), want)


def _idat(data: bytes) -> bytes:
    out, at = b"", 8
    while at < len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        if data[at + 4:at + 8] == b"IDAT":
            out += data[at + 8:at + 8 + n]
        at += 12 + n
    return out


@pytest.mark.parametrize("factor", [0.5, 0.3, 0.75])
@pytest.mark.parametrize("size", [(1080, 1920), (97, 131)])
def test_torch_resizes_match_cv2(factor, size):
    rng = np.random.default_rng(int(factor * 100) + size[0])
    h, w = size
    rgb = rng.integers(0, 256, (h, w, 3)).astype(np.float64) / 255.0
    depth = rng.integers(0, 65536, (h, w)).astype(np.float64) / 100.0
    out = (int(w * factor), int(h * factor))
    for img in (rgb, rgb[..., 0]):
        want = cv2.resize(img, out, interpolation=cv2.INTER_LINEAR)
        got = png.resize_linear(img, out)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(got.astype(np.float32), want.astype(np.float32))
    _same(png.resize_nearest(depth, out),
          cv2.resize(depth, out, interpolation=cv2.INTER_NEAREST))


def test_torch_png_refuses_what_it_cannot_read(tmp_path):
    """A JPEG, a GIF and a PNG with an ``eXIf`` orientation of 6 read as
    cv2 reads them; a PNG with a bad CRC and an AVIF raise by name, the
    file's path in the message; a missing file raises
    ``FileNotFoundError``."""
    img = _smooth((16, 16, 3), 255, np.uint8)
    jpg = tmp_path / "a.jpg"
    cv2.imwrite(str(jpg), img)
    _same(png.imread_color(jpg), _cv2_color(jpg))
    _same(png.imread_unchanged(jpg), cv2.imread(str(jpg), cv2.IMREAD_UNCHANGED))
    data = bytearray(encode_png(img, 2, 8))
    data[40] ^= 0xFF  # inside the first IDAT
    bad = tmp_path / "bad.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        png.imread_color(bad)
    gif = tmp_path / "a.gif"
    assert cv2.imwrite(str(gif), img)
    assert gif.read_bytes().startswith(b"GIF8")
    _same(png.imread_color(gif), _cv2_color(gif))
    _same(png.imread_unchanged(gif), cv2.imread(str(gif), cv2.IMREAD_UNCHANGED))
    avif = tmp_path / "a.avif"
    assert cv2.imwrite(str(avif), img)
    for read in (png.imread_color, png.imread_unchanged):
        with pytest.raises(ValueError, match="AVIF") as err:
            read(avif)
        assert str(avif) in str(err.value)
    with pytest.raises(FileNotFoundError):
        png.imread_color(tmp_path / "missing.png")
    # an eXIf orientation of 6 (rotate 90): cv2 rotates the image, so does the port
    exif = b"MM\x00*\x00\x00\x00\x08\x00\x01" + struct.pack(">HHIHH", 0x0112, 3, 1, 6, 0) \
        + b"\x00\x00\x00\x00"
    good = encode_png(img, 2, 8)
    chunk = struct.pack(">I", len(exif)) + b"eXIf" + exif \
        + struct.pack(">I", zlib.crc32(b"eXIf" + exif) & 0xFFFFFFFF)
    rotated = tmp_path / "rot.png"
    rotated.write_bytes(good[:33] + chunk + good[33:])
    _same(png.imread_color(rotated), _cv2_color(rotated))
    assert png.imread_color(rotated).shape == (16, 16, 3)
    _same(png.imread_unchanged(rotated), cv2.imread(str(rotated), cv2.IMREAD_UNCHANGED))
