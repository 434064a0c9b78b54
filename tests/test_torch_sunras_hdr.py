"""The port's Sun Raster and Radiance HDR readers
(``diffdope_tpu_torch/sunras.py``, ``hdr.py``, reached through
``png.imread_color``, ``png.imread_unchanged``, ``png.decode_color`` and
``png.decode_unchanged``) against cv2, which the reference reads its
images with, and the formats the port still names and refuses.

``testing.encode_sunras`` and ``testing.encode_hdr`` write what cv2's
writers do not (old-type and 32-bit rasters, colour maps grey, short and
past the limit, the byte-encoded and RGB types cv2 reads no image from;
flat and old-style HDR scanlines, headers with comments, exposure lines
and other orientations) and are held to cv2 on their own pixels first.
Every read, from bytes and from a file, in both cv2 modes, must equal
``cv2.imdecode`` / ``cv2.imread`` exactly, dtype and shape included, or
be None where cv2's is.  Then the JAX package's ``Image`` and
``_load_texture`` on such files must give the port's arrays, and a CPU
``DiffDope`` from a Sun Raster rgb, a GIF seg and a signed 32-bit depth
TIFF must run exactly as from PNGs.  (OpenEXR is read since the port's
``exr.py``: ``test_torch_exr.py``.)
"""

import copy

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from diffdope_tpu_torch import png, testing  # noqa: E402
from diffdope_tpu_torch.testing import encode_hdr, encode_sunras  # noqa: E402
from torch_scene import one_torch_thread  # noqa: E402, F401

VARIANTS = testing.format_variants()
RASTERS = sorted(k for k in VARIANTS if k.startswith("sunras_"))
HDRS = sorted(k for k in VARIANTS if k.startswith("hdr_"))


def _same(got, want):
    assert got is not None and want is not None
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _check(data: bytes, tmp_path=None, name="a"):
    """The port's reads of ``data`` against cv2's in both modes, from bytes
    and (with ``tmp_path``) from a file; None where cv2 gives None."""
    buf = np.frombuffer(data, np.uint8)
    pairs = [(cv2.imdecode(buf, cv2.IMREAD_UNCHANGED), png.decode_unchanged(data)),
             (cv2.imdecode(buf, cv2.IMREAD_COLOR), png.decode_color(data))]
    if tmp_path is not None:
        path = tmp_path / name
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


@pytest.mark.parametrize("name", RASTERS)
def test_torch_sunras_variant_matches_cv2(name, tmp_path):
    """The old and standard types at 1, 8, 24 and 32 bits, without a
    colour map, with a grey, a colour and a short one, odd widths (rows
    padded to 16 bits), and the files cv2 reads no image from
    (``sunras_none_*``: byte-encoded and RGB types, 4 bits, colour maps
    past the limit or on 24 bits)."""
    data, _ = VARIANTS[name]
    _check(data, tmp_path)
    if "_none_" in name:
        assert png.decode_unchanged(data) is None


@pytest.mark.parametrize("name", HDRS)
def test_torch_hdr_variant_matches_cv2(name, tmp_path):
    """New-style run-length scanlines, flat ones (and widths below 8, which
    are always flat), a run-length file that turns flat, old-style runs
    (read as pixels), exponents 0 to 255 (the uint8 conversion's rounding,
    saturation and overflow), the header's magic, comment, exposure and
    long lines, the size line's spacing and signs, and the files cv2 reads
    no image from (``hdr_none_*``)."""
    data, _ = VARIANTS[name]
    _check(data, tmp_path)
    if "_none_" in name:
        assert png.decode_unchanged(data) is None


def test_torch_sunras_hdr_writers_round_trip_through_cv2():
    """``testing.encode_sunras``'s 24/32-bit and colour-mapped files give
    cv2 back their pixels, ``testing.encode_hdr``'s RGBE pixels come back
    as m * 2**(e - 136), BGR: a writer bug cannot make a reader test
    pass."""
    rgb = _frame(11, 13)
    for depth in (24, 32):
        for kind in (0, 1):
            got = cv2.imdecode(np.frombuffer(encode_sunras(rgb, depth, kind), np.uint8),
                               cv2.IMREAD_UNCHANGED)
            _same(got, rgb[..., ::-1])
    pal = np.random.default_rng(1).integers(0, 256, (256, 3)).astype(np.uint8)
    idx = _frame(11, 13)[..., 0]
    got = cv2.imdecode(np.frombuffer(encode_sunras(idx, 8, 1, pal), np.uint8),
                       cv2.IMREAD_UNCHANGED)
    _same(got, pal[idx][..., ::-1])
    px = np.random.default_rng(2).integers(0, 256, (6, 20, 4)).astype(np.uint8)
    px[..., 3] = np.random.default_rng(3).integers(100, 160, (6, 20))
    want = np.ldexp(px[..., 2::-1].astype(np.float32), px[..., 3:].astype(np.int32) - 136)
    for enc in ("rle", "flat"):
        got = cv2.imdecode(np.frombuffer(encode_hdr(px, enc), np.uint8), cv2.IMREAD_UNCHANGED)
        _same(got, want.astype(np.float32))


@pytest.mark.parametrize("kind", ["grey", "colour"])
def test_torch_sunras_cv2_written_matches_cv2(tmp_path, kind):
    """Sun Raster files as cv2 writes them (8-bit grey, 24-bit colour)."""
    frame = _frame(37, 53)
    path = tmp_path / "x.ras"
    assert cv2.imwrite(str(path), frame[..., 0] if kind == "grey" else frame)
    _check(path.read_bytes(), tmp_path, "a.ras")


@pytest.mark.parametrize("scale", [1.0, 1 / 255.0, 1e-3, 1e4])
def test_torch_hdr_cv2_written_matches_cv2(tmp_path, scale):
    """Radiance HDR files as cv2 writes float32 frames (new-style runs),
    at scales whose uint8 conversion saturates, rounds or underflows."""
    frame = (_frame(37, 53).astype(np.float32) * np.float32(scale))
    frame[0, :4, 0] = [0.0, 1e-30, 1e30, 0.5 / 255]
    path = tmp_path / "x.hdr"
    assert cv2.imwrite(str(path), frame)
    _check(path.read_bytes(), tmp_path, "a.hdr")


def test_torch_hdr_frame_read_time(tmp_path):
    """A 640x480 float frame as cv2 writes HDR: both modes as cv2; prints
    the read's time on this CPU."""
    import time

    frame = _frame(480, 640).astype(np.float32) / 255.0
    path = tmp_path / "frame.hdr"
    assert cv2.imwrite(str(path), frame)
    _check(path.read_bytes())
    t0 = time.perf_counter()
    png.imread_color(path)
    print(f"640x480 HDR ({path.stat().st_size} bytes) colour read in "
          f"{time.perf_counter() - t0:.4f} s on this CPU")


@pytest.mark.parametrize("name", ["AVIF", "JPEG 2000 (JP2)", "JPEG 2000 (codestream)"])
def test_torch_other_formats_raise_by_name(tmp_path, name):
    """An AVIF as cv2 writes it (its ftyp box's brand) and JPEG 2000
    headers raise ``ValueError`` naming the format and the file in both
    modes (an OpenEXR header is read as cv2 4.13 reads it:
    ``test_torch_exr.py``)."""
    path = tmp_path / "x.img"
    if name == "AVIF":
        ok, buf = cv2.imencode(".avif", _frame(16, 16))
        assert ok
        path.write_bytes(buf.tobytes())
    else:
        path.write_bytes({"JPEG 2000 (JP2)": b"\x00\x00\x00\x0cjP  \r\n\x87\n",
                          "JPEG 2000 (codestream)": b"\xffO\xffQ\x00\x2f"}[name]
                         + b"\0" * 64)
    fmt = name.split(" (")[0]
    for read in (png.imread_color, png.imread_unchanged):
        with pytest.raises(ValueError, match=f"format: {fmt}") as err:
            read(path)
        assert str(path) in str(err.value)
    assert png.format_name(path.read_bytes()) == fmt


def test_torch_no_cv2_format_is_unknown(tmp_path):
    """Every format this cv2 writes either reads as cv2 reads it or is
    refused by name: none is "format: unknown"."""
    frame = _frame(16, 24)
    names = {}
    for ext in (".png", ".jpg", ".tif", ".bmp", ".ppm", ".pgm", ".pbm", ".pam", ".pfm",
                ".webp", ".gif", ".ras", ".hdr", ".jp2", ".avif", ".exr", ".pxm", ".pnm",
                ".sr", ".dib", ".jpe", ".jpeg", ".tiff", ".pic"):
        path = tmp_path / f"x{ext}"
        img = frame.astype(np.float32) / 255.0 if ext in (".pfm", ".hdr", ".exr") else frame
        try:
            written = cv2.imwrite(str(path), img)
        except cv2.error:
            written = False
        if not written:
            continue
        data = path.read_bytes()
        names[ext] = png.format_name(data)
        assert names[ext] != "unknown", ext
        try:
            png.imread_color(path)
        except ValueError as err:
            assert "format: unknown" not in str(err), ext
            assert names[ext] in str(err), ext
        else:
            _check(data)
    assert {"GIF", "Sun Raster", "Radiance HDR"} <= set(names.values())


@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_torch_image_from_sunras_and_hdr_matches_reference(tmp_path, resize):
    """``Image`` of a Sun Raster rgb, an HDR rgb (cv2's uint8 conversion)
    and the same HDR as depth (``IMREAD_UNCHANGED``: three float32
    channels, divided by depth_scale in both packages): the port's arrays
    equal the JAX package's, and so does ``_load_texture`` of each."""
    import diffdope_tpu.image as ref
    from diffdope_tpu.mesh import _load_texture as ref_load_texture

    import diffdope_tpu_torch.image as port
    from diffdope_tpu_torch.mesh import _load_texture

    frame = _frame(48, 64)
    ras, hdr = tmp_path / "rgb.ras", tmp_path / "rgb.hdr"
    assert cv2.imwrite(str(ras), frame)
    assert cv2.imwrite(str(hdr), frame.astype(np.float32) / 255.0)
    for kw in (dict(img_path=str(ras), img_resize=resize),
               dict(img_path=str(hdr), img_resize=resize),
               dict(img_path=str(hdr), img_resize=resize, depth=True)):
        _same(port.Image(**kw).img_tensor, ref.Image(**kw).img_tensor)
    assert port.Image(img_path=str(hdr), depth=True).img_tensor.shape == (48, 64, 3)
    for path in (ras, hdr):
        _same(_load_texture(path), ref_load_texture(path))


def test_torch_diffdope_from_sunras_gif_int_tiff_equals_png(tmp_path):
    """A CPU ``DiffDope`` (rgb + mask + depth, 3 SGD steps) from a Sun
    Raster rgb, a 1-bit GIF seg and a signed 32-bit depth TIFF runs exactly
    as from PNGs of the same pixels: gt arrays, loss history, argmin and
    pose, bit for bit."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.mesh import save_ply
    from diffdope_tpu_torch.testing import encode_gif, encode_tiff, icosphere

    h, w = 48, 64
    frame = _frame(h, w, seed=2)
    y, x = np.mgrid[0:h, 0:w]
    inside = ((x - 30) ** 2 + (y - 24) ** 2) < 200
    depth = (2500 + 30 * np.sin(x / 9.0)).astype(np.int32)
    files = {"png": {k: tmp_path / f"{k}.png" for k in ("rgb", "seg", "depth")},
             "other": {"rgb": tmp_path / "rgb.ras", "seg": tmp_path / "seg.gif",
                       "depth": tmp_path / "depth.tif"}}
    assert cv2.imwrite(str(files["png"]["rgb"]), frame)
    assert cv2.imwrite(str(files["png"]["seg"]), inside.astype(np.uint8) * 255)
    assert cv2.imwrite(str(files["png"]["depth"]), depth.astype(np.uint16))
    assert cv2.imwrite(str(files["other"]["rgb"]), frame)
    files["other"]["seg"].write_bytes(encode_gif([inside.astype(np.uint8)],
                                                 np.array([[0, 0, 0], [255] * 3], np.uint8)))
    files["other"]["depth"].write_bytes(encode_tiff(depth, compression=8, predictor=2))
    verts, faces = icosphere(1)
    ply = tmp_path / "sphere.ply"
    save_ply(ply, verts * 0.4, faces, colors=verts * 0.5 + 0.5)
    runs = {}
    for kind, paths in files.items():
        cfg = {
            "camera": {"fx": 60.0, "fy": 60.0, "cx": 32.0, "cy": 24.0, "im_width": w,
                       "im_height": h},
            "scene": {"path_img": str(paths["rgb"]), "path_depth": str(paths["depth"]),
                      "path_segmentation": str(paths["seg"]), "image_resize": 1.0},
            "object3d": {"position": [0.02, -0.01, 3.0], "rotation": [0.01, 0.0, 0.0, 1.0],
                         "scale": 1.0, "model_path": str(ply)},
            "losses": {"l1_mask": True, "l1_rgb_with_mask": True, "l1_depth_with_mask": True},
            "hyperparameters": {"batchsize": 2, "nb_iterations": 3},
            "tpu": {"raster_impl": "reference", "progress": False},
        }
        dd = tdd.DiffDope(cfg=tdd.ConfigNode(copy.deepcopy(cfg)), device="cpu")
        dd.run_optimization()
        runs[kind] = dd
    a, b = runs["png"], runs["other"]
    assert set(a.gt_tensors) == set(b.gt_tensors) == {"rgb", "depth", "segmentation"}
    for key in a.gt_tensors:
        _same(np.asarray(b.gt_tensors[key]), np.asarray(a.gt_tensors[key]))
    assert set(a.losses_values) == set(b.losses_values)
    for key in a.losses_values:
        _same(np.asarray(b.losses_values[key]), np.asarray(a.losses_values[key]))
    assert a.get_argmin() == b.get_argmin()
    _same(np.asarray(b.get_pose()), np.asarray(a.get_pose()))


@pytest.mark.parametrize("kind", ["gif", "ras", "hdr"])
def test_torch_later_format_textures_match_reference(tmp_path, kind):
    """A textured PLY naming a GIF, Sun Raster or HDR texture and a .glb
    embedding it, through both packages' ``load_mesh``: the textures are
    equal, the baked corner colours within 1e-6; an embedded AVIF raises
    ``NotImplementedError`` by name in the port."""
    from pathlib import Path

    from diffdope_tpu.mesh import load_mesh as ref_load_mesh

    from diffdope_tpu_torch import mesh as port
    from diffdope_tpu_torch.mesh import load_ply

    tex = _frame(64, 48, seed=4)
    path = tmp_path / f"tex.{kind}"
    if kind == "gif":
        from diffdope_tpu_torch.testing import encode_gif

        pal = np.unique(tex.reshape(-1, 3) // 32 * 32, axis=0)[:256]
        idx = np.abs(tex[..., None, :].astype(int) - pal[None, None]).sum(-1).argmin(-1)
        path.write_bytes(encode_gif([idx.astype(np.uint8)], pal.astype(np.uint8)))
    else:
        img = tex[..., ::-1] if kind == "ras" else tex[..., ::-1].astype(np.float32) / 255.0
        assert cv2.imwrite(str(path), img)
    data = path.read_bytes()
    src = Path(__file__).resolve().parent.parent / "data/standins/standin_tex_checker.ply"
    lines = [f"comment TextureFile tex.{kind}".encode() if b"TextureFile" in ln else ln
             for ln in src.read_bytes().split(b"\n")]
    (tmp_path / "m.ply").write_bytes(b"\n".join(lines))
    ply_data = load_ply(src)
    testing.write_gltf(tmp_path / "m.glb", ply_data["vertices"], ply_data["faces"],
                       uv=ply_data["uv"], image=data)
    for mesh_path in (tmp_path / "m.ply", tmp_path / "m.glb"):
        got, want = port.load_mesh(mesh_path, scale=0.01), ref_load_mesh(mesh_path, scale=0.01)
        _same(np.asarray(got.tex), np.asarray(want.tex))
        np.testing.assert_allclose(got.corner_colors, want.corner_colors, rtol=0, atol=1e-6)
    ok, avif = cv2.imencode(".avif", tex)
    assert ok
    testing.write_gltf(tmp_path / "a.glb", ply_data["vertices"], ply_data["faces"],
                       uv=ply_data["uv"], image=avif.tobytes())
    with pytest.raises(NotImplementedError, match="AVIF"):
        port.load_mesh(tmp_path / "a.glb", scale=0.01)
