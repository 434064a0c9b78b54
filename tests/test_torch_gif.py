"""The port's GIF reader (``diffdope_tpu_torch/gif.py``, reached through
``png.imread_color``, ``png.imread_unchanged``, ``png.decode_color`` and
``png.decode_unchanged``) against cv2, which the reference reads its
images with.

``testing.encode_gif`` writes what neither cv2's nor Pillow's writers
emit (interlaced frames, frames off the screen's corner, local colour
tables alone, no colour table, LZW Clear codes mid-frame, a transparent
index that is the background) and is held to cv2 on its own indices
first; Pillow and cv2 write their defaults.  Every read, from bytes and
from a file, in both cv2 modes, must equal ``cv2.imdecode`` /
``cv2.imread`` exactly, dtype and shape included, or be None where cv2's
is.  Then the JAX package's ``Image`` and ``_load_texture`` on GIF files
must give the port's arrays.
"""

import io

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from diffdope_tpu_torch import gif, png, testing  # noqa: E402
from diffdope_tpu_torch.testing import encode_gif  # noqa: E402
from torch_scene import one_torch_thread  # noqa: E402, F401

VARIANTS = testing.format_variants()
GIFS = sorted(k for k in VARIANTS if k.startswith("gif_"))


def _same(got, want):
    assert got is not None and want is not None
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _check(data: bytes, tmp_path=None):
    """The port's reads of ``data`` against cv2's in both modes, from bytes
    and (with ``tmp_path``) from a file; None where cv2 gives None."""
    buf = np.frombuffer(data, np.uint8)
    pairs = [(cv2.imdecode(buf, cv2.IMREAD_UNCHANGED), png.decode_unchanged(data)),
             (cv2.imdecode(buf, cv2.IMREAD_COLOR), png.decode_color(data))]
    if tmp_path is not None:
        path = tmp_path / "a.gif"
        path.write_bytes(data)
        pairs += [(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), png.imread_unchanged(path)),
                  (cv2.imread(str(path), cv2.IMREAD_COLOR), png.imread_color(path))]
    for k, (want, got) in enumerate(pairs):
        assert (got is None) == (want is None), k
        if want is not None:
            _same(got, cv2.cvtColor(want, cv2.COLOR_BGR2RGB) if k % 2 else want)


def _frame(h, w, seed=0):
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([128 + 100 * np.sin(x / 9.0 + c) * np.cos(y / 7.0) for c in range(3)], -1)
    rgb = rgb + np.random.default_rng(seed).normal(0, 3, rgb.shape)
    return np.clip(rgb, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("name", GIFS)
def test_torch_gif_variant_matches_cv2(name, tmp_path):
    """Global and local colour tables, none at all, the transparent index
    (BGRA under ``IMREAD_UNCHANGED``, in the first frame's extension or a
    later one's), frames smaller than the screen at an offset with each
    disposal, interlaced frames of 1 to 19 rows, animations (the first
    frame), LZW at every minimum code size with Clear codes and a full
    table, and the files cv2 reads no image from (``gif_none_*``)."""
    data, _ = VARIANTS[name]
    _check(data, tmp_path)
    if "_none_" in name:
        assert png.decode_unchanged(data) is None


def test_torch_gif_writer_round_trips_through_cv2():
    """``testing.encode_gif``'s indices come back from cv2 as their
    colours (BGR), with the widths' boundaries of a 256-colour frame and
    Clear codes mid-frame: a writer bug cannot make a reader test pass."""
    rng = np.random.default_rng(3)
    pal = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    idx = rng.integers(0, 256, (40, 70)).astype(np.uint8)
    idx[:, 20:50] = 9
    for kw in ({}, {"clear_every": 100}, {"min_size": 8}):
        data = encode_gif([idx], pal, **kw)
        _same(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED),
              pal[idx][..., ::-1])
        _check(data)


@pytest.mark.parametrize("mode,kw", [("P", {}), ("P", {"interlace": True}), ("L", {}),
                                     ("RGB", {}), ("1", {}), ("P", {"transparency": 3}),
                                     ("P", {"optimize": True})])
def test_torch_gif_pillow_files_match_cv2(tmp_path, mode, kw):
    """GIFs as Pillow writes them (palette, grey, RGB quantised, bilevel,
    interlaced, a transparent index, an optimised palette)."""
    Image = pytest.importorskip("PIL.Image")
    im = Image.fromarray(_frame(37, 53)).convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="GIF", **kw)
    _check(buf.getvalue(), tmp_path)


def test_torch_gif_pillow_animation_and_mask_match_cv2(tmp_path):
    """A Pillow animation (cv2 reads its first frame) and a bool mask as
    Pillow saves it (1-bit, two colours), and cv2's own GIF of a frame."""
    Image = pytest.importorskip("PIL.Image")
    frames = [Image.fromarray(_frame(37, 53, seed=k)) for k in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:], duration=40,
                   loop=0)
    _check(buf.getvalue(), tmp_path)
    y, x = np.mgrid[0:60, 0:80]
    buf = io.BytesIO()
    Image.fromarray((x - 40) ** 2 + (y - 30) ** 2 < 400).save(buf, format="GIF")
    _check(buf.getvalue(), tmp_path)
    path = tmp_path / "cv2.gif"
    assert cv2.imwrite(str(path), _frame(37, 53)[..., ::-1])
    _check(path.read_bytes(), tmp_path)


def test_torch_gif_corrupt_files_raise_by_name(tmp_path):
    """An LZW code past the table and data cut short raise ``ValueError``
    naming GIF and the file."""
    pal = np.random.default_rng(0).integers(0, 256, (16, 3)).astype(np.uint8)
    data = bytearray(encode_gif([np.zeros((8, 8), np.uint8)], pal))
    at = 13 + 3 * 16 + 10 + 2  # header, global table, descriptor, code size, block size
    data[at] = 0xFF  # a first code past the table
    cut = bytes(encode_gif([np.arange(64, dtype=np.uint8).reshape(8, 8) % 16], pal)[:-12])
    for bad in (bytes(data), cut):
        path = tmp_path / "bad.gif"
        path.write_bytes(bad)
        for read in (png.imread_color, png.imread_unchanged):
            with pytest.raises(ValueError, match="GIF") as err:
                read(path)
            assert str(path) in str(err.value)


def test_torch_gif_mask_frame_read_time(tmp_path):
    """A 640x480 binary mask as a GIF (long LZW strings, as a segmentation
    mask gives): both modes as cv2; prints the read's time on this CPU."""
    import time

    y, x = np.mgrid[0:480, 0:640]
    mask = (((x - 300) / 180.0) ** 2 + ((y - 250) / 140.0) ** 2 < 1).astype(np.uint8)
    data = encode_gif([mask], np.array([[0, 0, 0], [255, 255, 255]], np.uint8))
    _check(data, tmp_path)
    t0 = time.perf_counter()
    gif.decode_gif(data)
    print(f"640x480 mask GIF ({len(data)} bytes) read in {time.perf_counter() - t0:.4f} s "
          "on this CPU")


@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_torch_image_from_gif_matches_reference(tmp_path, resize):
    """``Image`` of a GIF rgb frame (Pillow's palette) and a GIF seg mask
    (two colours, with a transparent index): the port's float32 arrays
    equal the JAX package's (cv2's reads), and ``_load_texture`` of the
    frame equals the JAX package's."""
    Image = pytest.importorskip("PIL.Image")
    import diffdope_tpu.image as ref
    from diffdope_tpu.mesh import _load_texture as ref_load_texture

    import diffdope_tpu_torch.image as port
    from diffdope_tpu_torch.mesh import _load_texture

    rgb, seg = tmp_path / "rgb.gif", tmp_path / "seg.gif"
    Image.fromarray(_frame(48, 64)).convert("P").save(rgb)
    y, x = np.mgrid[0:48, 0:64]
    mask = ((x - 30) ** 2 + (y - 22) ** 2 < 225).astype(np.uint8)
    seg.write_bytes(encode_gif([{"indices": mask, "transparent": 0}],
                               np.array([[0, 0, 0], [255, 255, 255]], np.uint8)))
    for kw in (dict(img_path=str(rgb), img_resize=resize),
               dict(img_path=str(seg), img_resize=resize, flip_img=False),
               dict(img_path=str(seg), img_resize=resize, depth=True)):
        _same(port.Image(**kw).img_tensor, ref.Image(**kw).img_tensor)
    _same(_load_texture(rgb), ref_load_texture(rgb))
