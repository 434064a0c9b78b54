"""The port's TIFF reader (``diffdope_tpu_torch/tiff.py``, reached through
``png.imread_color``, ``png.imread_unchanged``, ``png.decode_color`` and
``png.decode_unchanged``) against cv2, which the reference reads its
images with.

``testing.encode_tiff`` writes the variants cv2 cannot (tiles, big-endian
files, planar samples, palettes, the orientation tag, each refused
variant) and is itself held to cv2 on its own samples first; cv2 writes
its defaults (LZW with the horizontal predictor, a 1080p 16-bit depth
frame in 2-row strips, float32 with deflate and the floating-point
predictor).  Every read must equal ``cv2.imdecode`` / ``cv2.imread``
exactly, dtype and shape included, or be None where cv2's is.  Then the
JAX package's ``Image``, ``Scene``, ``DiffDope(cfg)``'s gt arrays,
``_load_texture`` and ``load_mesh`` (a PLY naming a TIFF, a .glb
embedding one) on TIFF files must give the port's arrays or outcome.
"""

import time

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from diffdope_tpu_torch import png, testing  # noqa: E402
from diffdope_tpu_torch.testing import encode_jpeg_tiff, encode_tiff  # noqa: E402
from torch_scene import one_torch_thread  # noqa: E402, F401

VARIANTS = testing.image_variants()
TIFFS = sorted(k for k in VARIANTS if k.startswith("tiff_"))


def _same(got, want):
    assert got is not None and want is not None
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _check(data: bytes, modes=testing.BOTH, tmp_path=None):
    """The port's reads of ``data`` against cv2's in each mode, from bytes
    and (with ``tmp_path``) from a file."""
    buf = np.frombuffer(data, np.uint8)
    path = None
    if tmp_path is not None:
        path = tmp_path / "a.tif"
        path.write_bytes(data)
    if "unchanged" in modes:
        want = cv2.imdecode(buf, cv2.IMREAD_UNCHANGED)
        got = png.decode_unchanged(data)
        assert (got is None) == (want is None)
        if want is not None:
            _same(got, want)
        if path is not None:
            want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
            got = png.imread_unchanged(path)
            assert (got is None) == (want is None)
            if want is not None:
                _same(got, want)
    if "color" in modes:
        want = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        got = png.decode_color(data)
        if want is None:
            assert got is None
        else:
            _same(got, cv2.cvtColor(want, cv2.COLOR_BGR2RGB))
        if path is not None:
            want = cv2.imread(str(path), cv2.IMREAD_COLOR)
            got = png.imread_color(path)
            assert (got is None) == (want is None)
            if want is not None:
                _same(got, cv2.cvtColor(want, cv2.COLOR_BGR2RGB))


@pytest.mark.parametrize("name", TIFFS)
def test_torch_tiff_variant_matches_cv2(name, tmp_path):
    """Every compression, predictor, byte order, strips and tiles, planar
    samples, WhiteIsZero, palettes, alpha, the orientation tag and odd
    sizes, in each cv2 mode (``testing.image_variants``), from bytes
    (``cv2.imdecode``) and from a file (``cv2.imread``, which gives None
    for an orientation that transposes the image)."""
    data, modes = VARIANTS[name]
    _check(data, modes, tmp_path)


@pytest.mark.parametrize("dtype,channels", [(np.uint8, 0), (np.uint8, 3), (np.uint8, 4),
                                            (np.uint16, 0), (np.uint16, 3),
                                            (np.float32, 0), (np.float32, 3)])
@pytest.mark.parametrize("layout", [
    dict(compression=1), dict(compression=5, predictor=2, big_endian=True),
    dict(compression=8, predictor=2, rows_per_strip=3), dict(compression=32773),
    dict(compression=5, tile=(16, 16)), dict(compression=8, planar=2, rows_per_strip=7)])
def test_torch_tiff_writer_round_trips_through_cv2(dtype, channels, layout):
    """``testing.encode_tiff``'s files read by cv2 give back its samples
    (BGR order), so a writer bug cannot make a reader test pass; layouts
    cv2 reads wrongly (planar 16/32-bit samples unchanged, 16-bit or
    uncompressed tiles in its 8-bit path) are only read unchanged or
    skipped where they do not apply."""
    arr = testing.variant_image(32, 48, channels, dtype, 21)
    if dtype == np.float32 and layout.get("predictor") == 2:
        layout = dict(layout, predictor=3)
    if layout.get("planar") == 2 and channels and dtype != np.uint8:
        layout = dict(layout, planar=1)
    data = encode_tiff(arr, **layout)
    got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    want = arr if not channels else arr[..., [2, 1, 0, 3][:channels]]
    _same(got, want)
    _check(data, testing.BOTH if not (layout.get("tile") and dtype == np.uint16) and
           not (layout.get("tile") and layout.get("compression") == 1) else testing.UNCHANGED)


def test_torch_tiff_lzw_writer_round_trips_through_cv2():
    """``testing.lzw_encode`` past a full table (Clear codes mid-strip) and
    the widths' boundaries: cv2 reads the samples back, so does the port."""
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 256, (64, 300), dtype=np.uint8)  # incompressible: many codes
    arr[:, 100:160] = 7
    data = encode_tiff(arr, compression=5)
    _same(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED), arr)
    _check(data)


def _depth_frame(h=1080, w=1920, seed=3):
    """A rendered-looking 16-bit depth frame: zero background, a smooth
    object in millimetres with a little noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    inside = ((x - w * 0.55) / (w * 0.2)) ** 2 + ((y - h * 0.45) / (h * 0.3)) ** 2 < 1
    depth = 700 + 80 * np.sin(x / 90.0) * np.cos(y / 70.0) + rng.normal(0, 0.5, (h, w))
    return np.where(inside, np.round(depth), 0).astype(np.uint16)


def test_torch_tiff_1080p_depth_frames_match_cv2(tmp_path):
    """cv2's default 16-bit TIFF of a 1920x1080 depth frame (LZW, the
    horizontal predictor, 540 strips of 2 rows) and a float32 one with
    deflate and the floating-point predictor: both modes bit for bit.
    Prints the reads' times on this CPU."""
    depth = _depth_frame()
    p16 = tmp_path / "depth16.tif"
    assert cv2.imwrite(str(p16), depth)
    head = png.tiff._header(p16.read_bytes(), None)
    assert (head["compression"], head["predictor"], head["block"]) == (5, 2, (1920, 2))
    assert len(head["offsets"]) == 540
    t0 = time.perf_counter()
    got = png.imread_unchanged(p16)
    seconds = time.perf_counter() - t0
    _same(got, cv2.imread(str(p16), cv2.IMREAD_UNCHANGED))
    _same(png.imread_color(p16), cv2.cvtColor(cv2.imread(str(p16)), cv2.COLOR_BGR2RGB))
    pf = tmp_path / "depth32.tif"
    assert cv2.imwrite(str(pf), depth.astype(np.float32) / 1000.0,
                       [cv2.IMWRITE_TIFF_COMPRESSION, 8, cv2.IMWRITE_TIFF_PREDICTOR, 3])
    assert png.tiff._header(pf.read_bytes(), None)["predictor"] == 3
    _same(png.imread_unchanged(pf), cv2.imread(str(pf), cv2.IMREAD_UNCHANGED))
    assert png.imread_color(pf) is None and cv2.imread(str(pf)) is None
    print(f"1920x1080 16-bit LZW depth TIFF ({p16.stat().st_size} bytes): read in "
          f"{seconds:.3f} s on this CPU")


#: the variants of the refusal list below that the port reads now: each
#: is held to cv2 instead (read as cv2 reads it, None where cv2 gives None)
READ_NOW = {"JPEG-in-TIFF", "4-bit samples", "1-bit samples", "signed 16-bit samples",
            "signed 8-bit samples", "64-bit float samples",
            "32-bit samples of SampleFormat 1", "16-bit float samples"}


@pytest.mark.parametrize("variant,kwargs", [
    ("BigTIFF", dict(bigtiff=True)),
    ("old-style LZW", dict(compression=5, old_lzw=True)),
    ("JPEG-in-TIFF", dict(compression=7)),
    ("CCITT Group 4", dict(compression=4)),
    ("YCbCr", dict(photometric=6)),
    ("CMYK", dict(photometric=5, channels=4)),
    ("CIE L", dict(photometric=8)),
    ("4-bit samples", dict(bits=4, photometric=1, channels=0)),
    ("1-bit samples", dict(bits=1, photometric=1, channels=0)),
    ("signed 16-bit samples", dict(dtype=np.int16, channels=0)),
    ("signed 8-bit samples", dict(dtype=np.int8, channels=0)),
    ("64-bit float samples", dict(dtype=np.float64, channels=0)),
    ("32-bit samples of SampleFormat 1", dict(dtype=np.uint32, channels=0)),
    ("16-bit float samples", dict(dtype=np.float16, channels=0)),
    ("planar configuration 2 at 16 bits", dict(dtype=np.uint16, planar=2, compression=5,
                                                modes=("unchanged",))),
    ("old-style JPEG", dict(compression=6)),
    ("CCITT Group 3", dict(compression=3)),
    ("CCITT modified Huffman", dict(compression=2)),
    ("ZSTD", dict(compression=50000)),
    ("LZMA", dict(compression=34925)),
    ("JPEG 2000", dict(compression=34712)),
    ("PixarLog", dict(compression=32909)),
    ("ICC L", dict(photometric=9)),
    ("LogLuv", dict(photometric=32845)),
    ("JPEG-in-TIFF at 16 bits", dict(compression=7, dtype=np.uint16)),
    ("JPEG-in-TIFF with planar configuration 2", dict(compression=7, planar=2)),
])
def test_torch_tiff_refused_variants_raise_by_name(tmp_path, variant, kwargs):
    """What the port does not decode raises ``ValueError`` naming the
    variant and the file, in each mode it would be read in.  The variants
    of ``READ_NOW`` (a JPEG-in-TIFF header over raw samples, 1- and 4-bit
    grey, signed, 32-bit unsigned, 16- and 64-bit float samples) were
    refused before and are read now: each gives cv2's reads (None where
    cv2 gives None, as for 4-bit grey and 16-bit float samples, and a
    JPEG-in-TIFF whose strips hold no JPEG stream raises as corrupt)."""
    kwargs = dict(kwargs)
    channels = kwargs.pop("channels", 3)
    dtype = kwargs.pop("dtype", np.uint8)
    modes = kwargs.pop("modes", testing.BOTH)
    if kwargs.get("bits"):
        arr = (testing.variant_image(9, 13, 0, np.uint8, 1) >> (8 - kwargs["bits"]))
    else:
        arr = testing.variant_image(9, 13, channels, np.uint8, 1).astype(dtype)
    data = encode_tiff(arr, **kwargs)
    path = tmp_path / "v.tif"
    path.write_bytes(data)
    if variant in READ_NOW and variant != "JPEG-in-TIFF":
        _check(data, modes, tmp_path)
        return
    readers = {"unchanged": (png.imread_unchanged, png.decode_unchanged),
               "color": (png.imread_color, png.decode_color)}
    match = "not a JPEG file" if variant in READ_NOW else variant
    for mode in modes:
        from_path, from_bytes = readers[mode]
        with pytest.raises(ValueError, match=match) as err:
            from_path(path)
        assert str(path) in str(err.value)
        with pytest.raises(ValueError, match=match):
            from_bytes(data)


def test_torch_tiff_refused_variants_are_read_by_cv2():
    """The refused variants cv2 reads (so refusing them is a gap of the
    port, listed in ROADMAP.md, not a file nobody reads)."""
    base = testing.variant_image(9, 13, 3, np.uint8, 1)
    for kwargs in (dict(bigtiff=True), dict(compression=5, old_lzw=True)):
        got = cv2.imdecode(np.frombuffer(encode_tiff(base, **kwargs), np.uint8),
                           cv2.IMREAD_UNCHANGED)
        _same(got, base[..., ::-1])
    for dtype in (np.int16, np.int8, np.float64):
        arr = testing.variant_image(9, 13, 0, np.uint8, 1).astype(dtype)
        _same(cv2.imdecode(np.frombuffer(encode_tiff(arr), np.uint8), cv2.IMREAD_UNCHANGED),
              arr)


def _tiff_scene(tmp_path, h=48, w=64, float_depth=False):
    """rgb.tif (8-bit, orientation 3, tiled), depth.tif (16-bit LZW, or
    float32 deflate + predictor 3 of the same values) and seg.tif (8-bit
    palette), from seeded smooth noise."""
    rng = np.random.default_rng(4)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([np.sin(x / 7.0 + c) * np.cos(y / 5.0) * 0.4 + 0.5 for c in range(3)], -1)
    rgb = np.clip(np.round((rgb + rng.uniform(0, 0.05, (h, w, 3))) * 255), 0, 255)
    seg = ((x - w / 2) ** 2 + (y - h / 2) ** 2 < (min(h, w) / 3) ** 2).astype(np.uint8)
    depth = np.round((2.5 + np.sin(x / 11.0) * 0.3) * 100).astype(np.uint16)
    paths = {k: tmp_path / f"{k}.tif" for k in ("rgb", "depth", "seg")}
    paths["rgb"].write_bytes(encode_tiff(rgb.astype(np.uint8)[::-1, ::-1], orientation=3,
                                         compression=5, predictor=2, tile=(16, 16)))
    pal = np.zeros((3, 256), np.uint16)
    pal[:, 1] = 65535
    paths["seg"].write_bytes(encode_tiff(seg, photometric=3, colormap=pal, compression=8))
    if float_depth:
        paths["depth"].write_bytes(encode_tiff(depth.astype(np.float32), compression=8,
                                               predictor=3, big_endian=True))
    else:
        paths["depth"].write_bytes(encode_tiff(depth, compression=5, predictor=2,
                                               rows_per_strip=2))
    return paths


@pytest.mark.parametrize("float_depth", [False, True])
@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_torch_scene_from_tiff_matches_reference(tmp_path, resize, float_depth):
    """``Image`` (rgb, depth, seg) and ``Scene`` from TIFF files: the
    port's float32 arrays equal the reference's (cv2's reads)."""
    import diffdope_tpu.image as ref

    import diffdope_tpu_torch.image as port

    paths = _tiff_scene(tmp_path, float_depth=float_depth)
    for kw in (dict(img_path=str(paths["rgb"]), img_resize=resize),
               dict(img_path=str(paths["depth"]), img_resize=resize, depth=True),
               dict(img_path=str(paths["seg"]), img_resize=resize, flip_img=False)):
        got, want = port.Image(**kw), ref.Image(**kw)
        _same(got.img_tensor, want.img_tensor)
    args = dict(path_img=str(paths["rgb"]), path_depth=str(paths["depth"]),
                path_segmentation=str(paths["seg"]), image_resize=resize)
    got, want = port.Scene(**args).gt_arrays(), ref.Scene(**args).gt_arrays()
    assert set(got) == set(want) == {"rgb", "depth", "segmentation"}
    for key in want:
        _same(got[key], want[key])


def test_torch_float_tiff_as_colour_gives_reference_outcome(tmp_path):
    """A float32 TIFF read as colour: cv2 gives None, so the reference's
    ``Image`` and ``_load_texture`` raise ``FileNotFoundError`` and its
    glTF decode returns None; the port does the same."""
    from diffdope_tpu.image import Image as RefImage
    from diffdope_tpu.mesh import _gltf_decode_image as ref_gltf
    from diffdope_tpu.mesh import _load_texture as ref_load_texture

    from diffdope_tpu_torch.image import Image
    from diffdope_tpu_torch.mesh import _gltf_decode_image, _load_texture

    data = encode_tiff(testing.variant_image(16, 16, 3, np.float32, 2), compression=8,
                       predictor=3)
    path = tmp_path / "f.tif"
    path.write_bytes(data)
    for image in (Image, RefImage):
        with pytest.raises(FileNotFoundError):
            image(img_path=str(path))
    for load in (_load_texture, ref_load_texture):
        with pytest.raises(FileNotFoundError):
            load(path)
    gltf = {"images": [{"bufferView": 0}], "bufferViews": [{"byteLength": len(data)}]}
    assert _gltf_decode_image(gltf, [data], 0) is None
    assert ref_gltf(gltf, [data], 0) is None


@pytest.mark.parametrize("orientation", [3, 6])
def test_torch_tiff_textures_match_reference(tmp_path, orientation):
    """``_load_texture`` of an 8-bit TIFF (RGB with unassociated alpha,
    the orientation tag), a textured PLY naming it and a .glb embedding
    it, through both packages' ``load_mesh``: the textures are equal, the
    baked corner colours within 1e-6.  Orientation 6 transposes the image:
    cv2's ``imread`` then reads nothing, so both packages' ``Image`` and
    ``_load_texture`` raise ``FileNotFoundError``, while the .glb
    (``cv2.imdecode``) gives the transposed texture in both."""
    from pathlib import Path

    from diffdope_tpu.mesh import _load_texture as ref_load_texture
    from diffdope_tpu.mesh import load_mesh as ref_load_mesh

    from diffdope_tpu_torch import mesh as port
    from diffdope_tpu_torch.mesh import load_ply

    from diffdope_tpu.image import Image as RefImage

    from diffdope_tpu_torch.image import Image

    tex = testing.variant_image(64, 48, 4, np.uint8, 7)
    data = encode_tiff(tex, orientation=orientation, extra_samples=(2,), compression=5,
                       predictor=2)
    path = tmp_path / "tex.tif"
    path.write_bytes(data)
    meshes = [tmp_path / "m.glb"]
    if orientation == 6:
        for load in (port._load_texture, ref_load_texture):
            with pytest.raises(FileNotFoundError):
                load(path)
        for image in (Image, RefImage):
            for depth in (False, True):
                with pytest.raises(FileNotFoundError):
                    image(img_path=str(path), depth=depth)
    else:
        _same(port._load_texture(path), ref_load_texture(path))
        meshes.append(tmp_path / "m.ply")
    src = Path(__file__).resolve().parent.parent / "data/standins/standin_tex_checker.ply"
    lines = [b"comment TextureFile tex.tif" if b"TextureFile" in ln else ln
             for ln in src.read_bytes().split(b"\n")]
    (tmp_path / "m.ply").write_bytes(b"\n".join(lines))
    ply_data = load_ply(src)
    testing.write_gltf(tmp_path / "m.glb", ply_data["vertices"], ply_data["faces"],
                       uv=ply_data["uv"], image=data)
    for mesh_path in meshes:
        got, want = port.load_mesh(mesh_path, scale=0.01), ref_load_mesh(mesh_path, scale=0.01)
        _same(np.asarray(got.tex), np.asarray(want.tex))
        np.testing.assert_allclose(got.corner_colors, want.corner_colors, rtol=0, atol=1e-6)


def test_torch_diffdope_gt_from_tiff_matches_reference(tmp_path):
    """``DiffDope(cfg)`` from a TIFF scene (float32 depth) and a PLY in
    both packages: the gt arrays are equal."""
    import copy

    import diffdope_tpu as dd
    from diffdope_tpu.mesh import save_ply
    from diffdope_tpu.testing import icosphere

    import diffdope_tpu_torch as tdd

    paths = _tiff_scene(tmp_path, 48, 64, float_depth=True)
    verts, faces = icosphere(1)
    ply = tmp_path / "sphere.ply"
    save_ply(ply, verts * 0.4, faces, colors=verts * 0.5 + 0.5)
    cfg = {
        "camera": {"fx": 60.0, "fy": 60.0, "cx": 32.0, "cy": 24.0, "im_width": 64,
                   "im_height": 48},
        "scene": {"path_img": str(paths["rgb"]), "path_depth": str(paths["depth"]),
                  "path_segmentation": str(paths["seg"]), "image_resize": 0.5},
        "object3d": {"position": [0.0, 0.0, -3.0], "rotation": [0.0, 0.0, 0.0, 1.0],
                     "scale": 1.0, "model_path": str(ply)},
        "losses": {"l1_mask": True, "l1_rgb_with_mask": True, "l1_depth_with_mask": True},
        "hyperparameters": {"batchsize": 2, "nb_iterations": 1},
        "tpu": {"raster_impl": "reference", "progress": False},
    }
    ref = dd.DiffDope(cfg=dd.ConfigNode(copy.deepcopy(cfg)))
    port = tdd.DiffDope(cfg=tdd.ConfigNode(copy.deepcopy(cfg)), device="cpu")
    assert set(port.gt_tensors) == set(ref.gt_tensors) == {"rgb", "depth", "segmentation"}
    for key, value in ref.gt_tensors.items():
        _same(np.asarray(port.gt_tensors[key]), np.asarray(value))


LATER = testing.format_variants()
LATER_TIFFS = sorted(k for k in LATER if k.startswith("tiff_"))


@pytest.mark.parametrize("name", LATER_TIFFS)
def test_torch_tiff_later_variant_matches_cv2(name, tmp_path):
    """Masks and depth: 1-bit bilevel (MinIsWhite and MinIsBlack), 1- and
    4-bit palettes, 10/12/14-bit, signed 8 to 64-bit, unsigned 32/64-bit
    and float64 samples under every compression, both predictors, tiles,
    the orientation tag and FillOrder 2; the variants cv2 reads no image
    from (2 bits, 4-bit grey, 16-bit float, a predictor libtiff refuses;
    ``tiff_none_*``); and the JPEG-in-TIFF corpus (``tiff_jpeg_*``: strips
    and tiles, shared JPEGTables and abbreviated streams, RGB, YCbCr at
    4:2:0, 4:2:2, 4:4:4 and grey), in both modes, from bytes and files."""
    data, modes = LATER[name]
    _check(data, modes, tmp_path)
    if name.startswith("tiff_none_"):
        assert png.decode_unchanged(data) is None and png.decode_color(data) is None


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.uint32, np.int64,
                                   np.uint64, np.float64])
@pytest.mark.parametrize("channels", [0, 3])
def test_torch_tiff_wide_writer_round_trips_through_cv2(dtype, channels):
    """``testing.encode_tiff``'s signed, 32/64-bit and float64 files read by
    cv2 give back their samples (BGR order) with the predictor each
    takes, and its 1- and 12-bit files the bits cv2 makes of them (0/255,
    the samples moved to the top of 16 bits): so a writer bug cannot
    make a reader test pass."""
    arr = testing.variant_image(17, 23, channels, np.uint16, 40).astype(np.int64) - 30000
    arr = arr.astype(dtype) if np.dtype(dtype).kind != "f" else (arr / 3.0).astype(dtype)
    want = arr if not channels else arr[..., ::-1]
    for pred in (1, 3 if np.dtype(dtype).kind == "f" else 2):
        data = encode_tiff(arr, compression=8, predictor=pred, big_endian=pred == 1)
        _same(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED), want)
        _check(data)
    mask = (testing.variant_image(17, 23, 0, np.uint8, 41) > 50).astype(np.uint8)
    data = encode_tiff(mask, bits=1, compression=5)
    _same(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED), mask * 255)
    vals = (testing.variant_image(17, 23, 0, np.uint16, 42) >> 4).astype(np.uint16)
    data = encode_tiff(vals, bits=12)
    _same(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED),
          (vals << 4).astype(np.uint16))


def _jpeg(sampling):
    def encode(arr):
        img = np.ascontiguousarray(arr[..., ::-1]) if arr.ndim == 3 else arr
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 92,
                                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling,
                                             cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
        assert ok
        return buf.tobytes()
    return encode


@pytest.mark.parametrize("layout", [dict(rows_per_strip=64), dict(tile=(64, 48)),
                                    dict(rows_per_strip=240, shared_tables=False)])
def test_torch_tiff_jpeg_photo_matches_cv2(tmp_path, layout):
    """A 320x240 photograph-like frame as JPEG-in-TIFF, YCbCr 4:2:0 with
    restart markers, coded by cv2's JPEG encoder (``testing.encode_jpeg_tiff``):
    strips with shared tables, tiles, and one strip with its own tables;
    both modes bit for bit, and within the JPEG's error of the frame."""
    h, w = 240, 320
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([128 + 100 * np.sin(x / 17.0 + c) * np.cos(y / 23.0) for c in range(3)], -1)
    rgb = np.clip(rgb + np.random.default_rng(7).normal(0, 6, rgb.shape), 0, 255)
    rgb = rgb.astype(np.uint8)
    data = encode_jpeg_tiff(rgb, _jpeg(cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420), **layout)
    _check(data, testing.BOTH, tmp_path)
    got = png.decode_color(data).astype(np.int64)
    assert np.abs(got - rgb).mean() < 8.0  # the JPEG's error on this noise is ~4.5


def _mask_depth_files(tmp_path):
    """seg as a 1-bit TIFF (Pillow's default for a bool mask: no
    BitsPerSample tag) and depth as a signed 32-bit and a signed 16-bit
    TIFF of the same millimetre values (0 background)."""
    from PIL import Image as PILImage

    h, w = 48, 64
    y, x = np.mgrid[0:h, 0:w]
    inside = (x - 30) ** 2 + (y - 22) ** 2 < 15 ** 2
    paths = {"seg": tmp_path / "seg.tif", "depth32": tmp_path / "depth32.tif",
             "depth16": tmp_path / "depth16.tif"}
    PILImage.fromarray(inside).save(paths["seg"])
    depth = np.where(inside, 700 + (x * 3 + y) % 50, 0)
    PILImage.fromarray(depth.astype(np.int32), "I").save(paths["depth32"])
    paths["depth16"].write_bytes(encode_tiff(depth.astype(np.int16), compression=5,
                                             predictor=2))
    return paths


@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_torch_mask_and_int_depth_tiffs_match_reference(tmp_path, resize):
    """The JAX package's ``Image`` (cv2's reads) and the port's on a 1-bit
    mask and signed 32- and 16-bit depth TIFFs: equal bit for bit, and the
    mask reads as cv2's 0/255."""
    import diffdope_tpu.image as ref

    import diffdope_tpu_torch.image as port

    paths = _mask_depth_files(tmp_path)
    _same(png.imread_unchanged(paths["seg"]),
          cv2.imread(str(paths["seg"]), cv2.IMREAD_UNCHANGED))
    assert set(np.unique(png.imread_unchanged(paths["seg"])).tolist()) == {0, 255}
    assert png.imread_unchanged(paths["depth32"]).dtype == np.int32
    for kw in (dict(img_path=str(paths["seg"]), img_resize=resize, flip_img=False),
               dict(img_path=str(paths["depth32"]), img_resize=resize, depth=True),
               dict(img_path=str(paths["depth16"]), img_resize=resize, depth=True)):
        _same(port.Image(**kw).img_tensor, ref.Image(**kw).img_tensor)
    depth32 = port.Image(img_path=str(paths["depth32"]), depth=True).img_tensor
    _same(port.Image(img_path=str(paths["depth16"]), depth=True).img_tensor, depth32)
