"""The port's JPEG reader (``diffdope_tpu_torch/jpeg.py``, reached through
``png.imread_color``, ``png.imread_unchanged`` and ``png.decode_color``)
against cv2, which the reference reads its images with.

cv2 writes every file: the five chroma samplings, grey, progressive,
restart intervals, qualities 10 to 100, odd sizes, a saturated
high-contrast image; a few files are then edited byte for byte to reach
what cv2 does not write (an EXIF APP1 segment with each orientation, an
SOF1 extended-sequential frame, fill bytes before markers, an Adobe RGB
file, quantisation tables scaled until libjpeg-turbo's 16-bit IDCT lanes
wrap and saturate, a progressive file missing its refinement scans).
Every read must equal ``cv2.imread`` / ``cv2.imdecode`` exactly, dtype
and shape included (``IMREAD_COLOR`` with the orientation applied,
``IMREAD_UNCHANGED`` without).  Then the JAX package's ``Image``,
``_load_texture`` and ``load_mesh`` on JPEG files must give the port's
float32 arrays exactly, and the variants the port refuses raise by name.
"""

import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from diffdope_tpu_torch import jpeg, png  # noqa: E402
from torch_scene import one_torch_thread  # noqa: E402, F401

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
#: odd sizes (h, w), none a multiple of an MCU, one of a single row
SIZES = ((13, 17), (31, 33), (48, 64), (1, 9))


def _image(h, w, channels=3, seed=0):
    """Smooth colour gradients with noise, so every coefficient is used."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.sin(x / 7.0) * np.cos(y / 5.0) * 0.4 + 0.5
    if channels:
        base = base[..., None] * np.linspace(0.3, 1.0, channels)
    noise = rng.integers(-30, 30, base.shape)
    return np.clip(base * 255 + noise, 0, 255).astype(np.uint8)


def _encode(img, quality=90, sampling="420", progressive=False, restart=0) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, enc = cv2.imencode(".jpg", img, params)
    assert ok
    return enc.tobytes()


def _same(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _check(tmp_path, data: bytes, name="a.jpg"):
    """The three readers against cv2 on one file."""
    path = tmp_path / name
    path.write_bytes(data)
    buf = np.frombuffer(data, np.uint8)
    color = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert color is not None
    _same(png.imread_color(path), cv2.cvtColor(color, cv2.COLOR_BGR2RGB))
    _same(png.imread_unchanged(path), cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    _same(png.decode_color(data),
          cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))
    _same(jpeg.decode_jpeg(data), cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))


def _markers(data: bytes):
    """(marker, start, end) of each segment up to the first SOS, the
    segment's two marker bytes included."""
    at = 2
    while at < len(data):
        marker = data[at + 1]
        (length,) = struct.unpack(">H", data[at + 2:at + 4])
        yield marker, at, at + 2 + length
        if marker == 0xDA:
            return
        at += 2 + length


def _exif_app1(orientation: int, big_endian: bool) -> bytes:
    end = ">" if big_endian else "<"
    tiff = (b"MM" if big_endian else b"II") + struct.pack(end + "HI", 42, 8) \
        + struct.pack(end + "H", 1) \
        + struct.pack(end + "HHIHH", 0x0112, 3, 1, orientation, 0) + b"\x00" * 4
    body = b"Exif\x00\x00" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(body) + 2) + body


@pytest.mark.parametrize("quality", [10, 75, 100])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
def test_torch_jpeg_sampling_matches_cv2(tmp_path, sampling, quality):
    for i, (h, w) in enumerate(SIZES):
        _check(tmp_path, _encode(_image(h, w, seed=i + quality), quality, sampling))


@pytest.mark.parametrize("quality", [10, 75, 100])
def test_torch_jpeg_grey_matches_cv2(tmp_path, quality):
    for i, (h, w) in enumerate(SIZES):
        data = _encode(_image(h, w, channels=0, seed=i), quality)
        _check(tmp_path, data)
        assert png.imread_unchanged(tmp_path / "a.jpg").shape == (h, w)


@pytest.mark.parametrize("sampling", sorted(SAMPLING) + ["grey"])
def test_torch_jpeg_progressive_matches_cv2(tmp_path, sampling):
    """cv2 writes libjpeg's simple progression: spectral selection, DC and
    AC successive approximation, EOB runs.  The file is complete, so
    libjpeg does not smooth its blocks, and the port's read is exact."""
    for i, (h, w) in enumerate(SIZES[:3]):
        img = _image(h, w, channels=0 if sampling == "grey" else 3, seed=i)
        for quality in (30, 95):
            data = _encode(img, quality, "420" if sampling == "grey" else sampling,
                           progressive=True)
            assert b"\xff\xc2" in data
            _check(tmp_path, data)


@pytest.mark.parametrize("restart", [1, 3])
@pytest.mark.parametrize("progressive", [False, True])
def test_torch_jpeg_restart_intervals_match_cv2(tmp_path, restart, progressive):
    for sampling in ("444", "420"):
        data = _encode(_image(40, 56, seed=restart), 80, sampling, progressive, restart)
        assert b"\xff\xdd" in data and b"\xff\xd1" in data
        _check(tmp_path, data)
        # fill bytes (extra 0xFF) before every marker after the first scan
        at = data.index(b"\xff\xda")
        tail = data[at + 2:]
        for m in list(range(0xD0, 0xD8)) + [0xD9, 0xC4, 0xDA]:
            tail = tail.replace(bytes([0xFF, m]), bytes([0xFF, 0xFF, 0xFF, m]))
        filled = data[:at + 2] + tail
        assert len(filled) > len(data)
        _check(tmp_path, filled)


@pytest.mark.parametrize("quality", [10, 100])
def test_torch_jpeg_saturated_image_matches_cv2(tmp_path, quality):
    """A checker of 0 and 255 in opposed channels: the IDCT rings past both
    ends of the sample range and is clamped."""
    y, x = np.mgrid[0:48, 0:40]
    checker = (((x // 3 + y // 3) % 2) * 255).astype(np.uint8)
    img = np.stack([checker, 255 - checker, ((x // 5) % 2 * 255).astype(np.uint8)], -1)
    for sampling in ("444", "420", "411"):
        _check(tmp_path, _encode(img, quality, sampling))


def test_torch_jpeg_scaled_tables_match_cv2(tmp_path):
    """Quantisation tables scaled after encoding, so the dequantised
    coefficients leave the range an encoder produces: libjpeg-turbo's SIMD
    IDCT (what cv2 runs) wraps its 16-bit sums and saturates its passes
    and samples where jidctint.c's table would wrap; the port follows
    cv2.  A white block at DC quantiser 9 reads 0 in cv2, at 5 it reads
    255."""
    white = _encode(np.full((16, 16, 3), 255, np.uint8), 100, "444")
    at = white.index(b"\xff\xdb") + 5  # the first table's DC entry
    for q, want in ((5, 255), (9, 0), (20, 255), (31, 0)):
        data = white[:at] + bytes([q]) + white[at + 1:]
        _check(tmp_path, data)
        assert (png.imread_unchanged(tmp_path / "a.jpg") == want).all()
    rng = np.random.default_rng(5)
    for trial in range(12):
        img = rng.integers(0, 256, (24, 40, 3)).astype(np.uint8)
        data = bytearray(_encode(img, (50, 90, 100)[trial % 3], ("444", "420")[trial % 2],
                                 progressive=trial % 4 == 0))
        for marker, start, end in list(_markers(bytes(data))):
            if marker != 0xDB:
                continue
            for t in range(start + 4, end, 65):
                vals = np.frombuffer(bytes(data[t + 1:t + 65]), np.uint8).astype(int)
                vals = vals * int(rng.integers(2, 60)) + int(rng.integers(0, 40))
                data[t + 1:t + 65] = np.clip(vals, 1, 255).astype(np.uint8).tobytes()
        _check(tmp_path, bytes(data))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_torch_jpeg_exif_orientation_matches_cv2(tmp_path, orientation):
    """An APP1 Exif segment (either byte order, before or after the JFIF
    APP0): applied by ``IMREAD_COLOR`` and ``imdecode``, ignored by
    ``IMREAD_UNCHANGED``."""
    for i, sampling in enumerate(("420", "444")):
        data = _encode(_image(13, 22, seed=orientation), 85, sampling)
        app1 = _exif_app1(orientation, big_endian=bool(i))
        at = 2 if i else data.index(b"\xff\xdb")
        data = data[:at] + app1 + data[at:]
        _check(tmp_path, data)
        color = png.imread_color(tmp_path / "a.jpg")
        assert color.shape[:2] == ((22, 13) if orientation >= 5 else (13, 22))
    grey = _encode(_image(9, 14, channels=0), 85)
    _check(tmp_path, grey[:2] + _exif_app1(orientation, True) + grey[2:])


@pytest.mark.parametrize("orientation", range(1, 9))
def test_torch_png_exif_orientation_matches_cv2(tmp_path, orientation):
    """A PNG ``eXIf`` chunk, which cv2 applies too; the same helper."""
    import zlib

    from diffdope_tpu_torch.testing import encode_png

    img = _image(11, 19, seed=orientation)
    tiff = _exif_app1(orientation, big_endian=orientation % 2 == 0)[10:]
    chunk = struct.pack(">I", len(tiff)) + b"eXIf" + tiff \
        + struct.pack(">I", zlib.crc32(b"eXIf" + tiff) & 0xFFFFFFFF)
    good = encode_png(img, 2, 8)
    path = tmp_path / "o.png"
    path.write_bytes(good[:33] + chunk + good[33:])
    _same(png.imread_color(path),
          cv2.cvtColor(cv2.imread(str(path), cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB))
    _same(png.imread_unchanged(path), cv2.imread(str(path), cv2.IMREAD_UNCHANGED))


def test_torch_jpeg_extended_and_adobe_rgb_match_cv2(tmp_path):
    """An SOF1 (extended sequential) frame reads as the baseline one; an
    Adobe APP14 with transform 0 in place of the JFIF APP0 makes the three
    components RGB as stored, with no colour conversion."""
    data = _encode(_image(21, 30), 90, "422")
    at = data.index(b"\xff\xc0")
    _check(tmp_path, data[:at + 1] + b"\xc1" + data[at + 2:])
    app0 = next((s, e) for m, s, e in _markers(data) if m == 0xE0)
    adobe = b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0)
    rgb = data[:app0[0]] + b"\xff\xee" + struct.pack(">H", len(adobe) + 2) + adobe \
        + data[app0[1]:]
    _check(tmp_path, rgb)


def test_torch_jpeg_full_frame_matches_cv2(tmp_path):
    """One frame at 960x540, 4:2:0, quality 95, as phase 16's rgb (half
    its size)."""
    img = _image(540, 960, seed=3)
    _check(tmp_path, _encode(img, 95, "420"))


def test_torch_jpeg_unsmoothed_progressive_raises(tmp_path):
    """A progressive file whose AC refinement scans are cut out: libjpeg
    would smooth its blocks (``jdcoefct.c``), so the port refuses it."""
    data = _encode(_image(32, 32), 80, "444", progressive=True)
    out, at = bytearray(data[:2]), 2
    while at < len(data):
        marker = data[at + 1]
        if marker == 0xD9:
            out += data[at:]
            break
        (length,) = struct.unpack(">H", data[at + 2:at + 4])
        end = at + 2 + length
        if marker == 0xDA:  # the scan's data runs to the next marker but RSTn
            nxt = end
            while not (data[nxt] == 0xFF and data[nxt + 1] not in
                       (0x00, *range(0xD0, 0xD8))):
                nxt += 1
            ss, ah = data[end - 3], data[end - 1] >> 4
            if not (ss > 0 and ah > 0):
                out += data[at:nxt]
            end = nxt
        else:
            out += data[at:end]
        at = end
    path = tmp_path / "cut.jpg"
    path.write_bytes(bytes(out))
    assert cv2.imread(str(path)) is not None
    with pytest.raises(ValueError, match="smooth") as err:
        png.imread_color(path)
    assert str(path) in str(err.value)


def test_torch_jpeg_truncated_or_corrupt_raises(tmp_path):
    """A file cut inside its scan or inside a table, and a Huffman table
    with more codes than its lengths allow, raise ``ValueError`` naming
    the file (libjpeg would pad the scan with zeros and cv2 return a
    partial image; the port refuses)."""
    data = _encode(_image(64, 64), 90, "420")
    sos = data.index(b"\xff\xda")
    dht = data.index(b"\xff\xc4")
    bad_table = bytearray(data)
    bad_table[dht + 5:dht + 21] = bytes([0, 16] + [0] * 14)  # 16 codes of 2 bits
    for name, broken in (("cut_scan.jpg", data[:sos + 200]),
                         ("cut_table.jpg", data[:dht + 10]),
                         ("bad_table.jpg", bytes(bad_table))):
        path = tmp_path / name
        path.write_bytes(broken)
        with pytest.raises(ValueError, match="corrupt or truncated JPEG") as err:
            png.imread_color(path)
        assert str(path) in str(err.value)


def _frame_edit(data: bytes, marker: int, precision=None, components=None) -> bytes:
    """A cv2 file with its SOF0 changed: another frame marker, precision or
    component count (what follows is no longer valid, but the port refuses
    at the frame)."""
    at = data.index(b"\xff\xc0")
    (length,) = struct.unpack(">H", data[at + 2:at + 4])
    body = bytearray(data[at + 4:at + 2 + length])
    if precision is not None:
        body[0] = precision
    if components is not None:
        body = body[:5] + bytes([components]) + b"".join(
            bytes([i + 1, 0x11, 0]) for i in range(components))
    return data[:at] + bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) \
        + bytes(body) + data[at + 2 + length:]


@pytest.mark.parametrize("variant,edit", [
    ("arithmetic coding", dict(marker=0xC9)),
    ("arithmetic coding \\(progressive\\)", dict(marker=0xCA)),
    ("lossless", dict(marker=0xC3)),
    ("hierarchical", dict(marker=0xC5)),
    ("12-bit", dict(marker=0xC0, precision=12)),
    ("CMYK/YCCK", dict(marker=0xC0, components=4)),
])
def test_torch_jpeg_refused_variants_raise_by_name(tmp_path, variant, edit):
    data = _frame_edit(_encode(_image(16, 16), 90, "444"), **edit)
    path = tmp_path / "v.jpg"
    path.write_bytes(data)
    for read in (png.imread_color, png.imread_unchanged):
        with pytest.raises(ValueError, match=variant) as err:
            read(path)
        assert str(path) in str(err.value)
    with pytest.raises(ValueError, match=variant):
        png.decode_color(data)


@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_torch_image_from_jpeg_matches_reference(tmp_path, resize):
    """``Image(img_path=...jpg)`` and a JPEG scene, the reference's read by
    cv2: the float32 arrays are equal."""
    import diffdope_tpu.image as ref

    import diffdope_tpu_torch.image as port

    rgb = tmp_path / "rgb.jpg"
    rgb.write_bytes(_encode(_image(60, 82, seed=1), 92, "420")[:2]
                    + _exif_app1(6, True) + _encode(_image(60, 82, seed=1), 92, "420")[2:])
    seg = tmp_path / "seg.jpg"
    y, x = np.mgrid[0:60, 0:82]
    mask = (((x - 40) ** 2 + (y - 30) ** 2) < 400).astype(np.uint8) * 255
    seg.write_bytes(_encode(mask, 95))
    for kw in (dict(img_path=str(rgb), img_resize=resize),
               dict(img_path=str(seg), img_resize=resize, flip_img=False)):
        got, want = port.Image(**kw), ref.Image(**kw)
        assert got.img_tensor.dtype == want.img_tensor.dtype == np.float32
        _same(got.img_tensor, want.img_tensor)
    args = dict(path_img=str(rgb), path_segmentation=str(seg), image_resize=resize)
    got, want = port.Scene(**args).gt_arrays(), ref.Scene(**args).gt_arrays()
    assert set(got) == set(want)
    for key in want:
        _same(got[key], want[key])


def test_torch_jpeg_texture_matches_reference(tmp_path):
    """``_load_texture`` of a JPEG, and a textured PLY whose TextureFile is
    a JPEG through both packages' ``load_mesh``."""
    from pathlib import Path

    from diffdope_tpu.mesh import _load_texture as ref_load_texture
    from diffdope_tpu.mesh import load_mesh as ref_load_mesh

    from diffdope_tpu_torch import mesh as port

    tex = tmp_path / "tex.jpg"
    tex.write_bytes(_encode(_image(64, 64, seed=7), 90, "420"))
    _same(port._load_texture(tex), ref_load_texture(tex))
    src = Path(__file__).resolve().parent.parent / "data/standins/standin_tex_checker.ply"
    text = src.read_bytes()
    assert b"TextureFile" in text
    lines = [b"comment TextureFile tex.jpg" if b"TextureFile" in ln else ln
             for ln in text.split(b"\n")]
    ply = tmp_path / "m.ply"
    ply.write_bytes(b"\n".join(lines))
    got, want = port.load_mesh(ply, scale=0.01), ref_load_mesh(ply, scale=0.01)
    _same(np.asarray(got.tex), np.asarray(want.tex))
    np.testing.assert_allclose(got.corner_colors, want.corner_colors, rtol=0, atol=1e-6)
