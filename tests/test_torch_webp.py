"""The port's WebP reader (``diffdope_tpu_torch/webp.py``, reached through
``png.imread_color``, ``png.imread_unchanged``, ``png.decode_color`` and
``png.decode_unchanged``) against cv2, which the reference reads its
images with.

The corpus is ``tests/torch_data/webp/`` (``tools/port_webp_corpus.py``
writes it with Pillow and cv2: lossy files at many qualities, methods and
sizes, alpha of every coding and filter, lossless files of every
transform, animations, EXIF orientations, ICC and XMP, truncated and
malformed files).  Every read, from bytes and from a file, in both cv2
modes, must equal ``cv2.imdecode`` / ``cv2.imread`` exactly, dtype and
shape included, or be None where cv2's is.  The features no writer
reaches raise by name; the constant tables equal the bytes of the
libwebp they were transcribed from.  Then the JAX package's ``Image``,
``_load_texture`` and ``load_mesh`` (a PLY naming a WebP, a .glb
embedding one) on WebP files must give the port's arrays, and a CPU
``DiffDope`` from lossless WebP files must run exactly as from PNGs.
"""

import copy
import importlib.util
import struct
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from diffdope_tpu_torch import png, testing, webp  # noqa: E402
from torch_scene import one_torch_thread  # noqa: E402, F401

ROOT = Path(__file__).resolve().parent.parent
VARIANTS = testing.webp_variants()


def _same(got, want):
    assert got is not None and want is not None
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _same_or_none(got, want):
    assert (got is None) == (want is None)
    if want is not None:
        _same(got, want)


def _check(data: bytes, tmp_path):
    """The port's reads of ``data`` against cv2's in both modes, from bytes
    and from a file."""
    buf = np.frombuffer(data, np.uint8)
    path = tmp_path / "a.webp"
    path.write_bytes(data)
    _same_or_none(png.decode_unchanged(data), cv2.imdecode(buf, cv2.IMREAD_UNCHANGED))
    _same_or_none(png.imread_unchanged(path), cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    for got, want in ((png.decode_color(data), cv2.imdecode(buf, cv2.IMREAD_COLOR)),
                      (png.imread_color(path), cv2.imread(str(path), cv2.IMREAD_COLOR))):
        _same_or_none(got, None if want is None else cv2.cvtColor(want, cv2.COLOR_BGR2RGB))


def test_torch_webp_corpus_is_whole():
    """The committed corpus: over 200 files, each under 7 KB, under 300 KB
    in all; its truncated and malformed files give None in cv2."""
    sizes = [len(d) for d, _ in VARIANTS.values()]
    assert len(sizes) > 200 and max(sizes) < 7000 and sum(sizes) < 300_000
    for name, (data, _) in VARIANTS.items():
        if name.startswith("webp_bad_"):
            assert cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED) is None


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_torch_webp_corpus_matches_cv2(name, tmp_path):
    """Every corpus file from bytes and from a file, in both modes: BGR or
    BGRA as the header says, the EXIF orientation applied in colour mode,
    an animation's first frame, None where cv2 gives None."""
    _check(VARIANTS[name][0], tmp_path)


def _scene_frame(w, h, seed=0):
    """A render-like frame: flat regions, sharp edges, smooth texture."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([60 + 40 * np.sin(x / 9 + c) * np.cos(y / 7) for c in range(3)], -1)
    disc = (x - 0.4 * w) ** 2 + (y - 0.5 * h) ** 2 < (0.3 * min(w, h)) ** 2
    img[disc] = [200, 120, 40] + rng.uniform(-20, 20, (int(disc.sum()), 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("quality", [5, 50, 90, 101])
def test_torch_webp_cv2_written_frames_match_cv2(tmp_path, quality):
    """Frames this host's cv2 writes (lossy at three qualities, lossless
    at 101), 256x160 and 97x61, read back as cv2 reads them."""
    for w, h in ((256, 160), (97, 61)):
        ok, data = cv2.imencode(".webp", _scene_frame(w, h), [cv2.IMWRITE_WEBP_QUALITY, quality])
        assert ok
        _check(data.tobytes(), tmp_path)


# ---------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------

def _tables_tool():
    spec = importlib.util.spec_from_file_location("port_webp_tables",
                                                  ROOT / "tools" / "port_webp_tables.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("name", sorted(_tables_tool().TABLES))
def test_torch_webp_tables_match_libwebp(name):
    """Each constant table of ``webp.py`` equals the bytes of the compiled
    libwebp it was transcribed from (``tools/port_webp_tables.py``)."""
    tool = _tables_tool()
    lib = tool.default_library()
    if lib is None:
        pytest.skip("no libwebp here (Pillow's bundled one is absent)")
    assert list(getattr(webp, "_" + name)) == tool.find_tables(lib)[name]


# ---------------------------------------------------------------------------
# the refused features: files written bit by bit
# ---------------------------------------------------------------------------

def _bool_encode(decisions) -> bytes:
    """RFC 6386 7.3's boolean encoder: (bit, probability) pairs -> bytes,
    the interval's low end at full precision, zero-padded."""
    low, rng, shifts = 0, 255, 0
    for bit, prob in decisions:
        split = 1 + (((rng - 1) * prob) >> 8)
        if bit:
            low, rng = low + split, rng - split
        else:
            rng = split
        while rng < 128:
            rng, low, shifts = rng << 1, low << 1, shifts + 1
    pad = -(8 + shifts) % 8
    return (low << pad).to_bytes((8 + shifts + pad) // 8, "big") + bytes(8)


def _value(v, n):
    return [((v >> k) & 1, 128) for k in range(n - 1, -1, -1)]


def _vp8_file(header) -> bytes:
    """A 16x16 key frame whose first partition opens with ``header``'s
    decisions (the rest zero bits), in a RIFF file."""
    first = _bool_encode([(0, 128), (0, 128)] + header + [(0, 128)] * 64)
    tag = (0 | 0 << 1 | 1 << 4 | len(first) << 5).to_bytes(3, "little")
    body = tag + b"\x9d\x01\x2a" + struct.pack("<HH", 16, 16) + first + bytes(32)
    chunk = b"VP8 " + struct.pack("<I", len(body)) + body
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def _filter_header(simple=0, level=20, sharpness=0, deltas=0, partitions=0):
    return (_value(simple, 1) + _value(level, 6) + _value(sharpness, 3) + _value(deltas, 1)
            + _value(partitions, 2))


class _LsbWriter:
    def __init__(self):
        self.bits = []

    def put(self, v, n):
        self.bits += [(v >> k) & 1 for k in range(n)]

    def simple_code(self, symbol):
        self.put(1, 1)  # simple
        self.put(0, 1)  # one symbol
        self.put(1, 1)  # of 8 bits
        self.put(symbol, 8)

    def data(self) -> bytes:
        bits = self.bits + [0] * (-len(self.bits) % 8 + 64)
        return np.packbits(np.array(bits, np.uint8), bitorder="little").tobytes()


def _vp8l_predictor_file(mode: int, w=8, h=8) -> bytes:
    """A lossless file whose predictor transform asks for ``mode``
    everywhere (single-symbol prefix codes: no pixel takes a bit)."""
    out = _LsbWriter()
    out.put(0x2F, 8)
    out.put(w - 1, 14)
    out.put(h - 1, 14)
    out.put(0, 4)
    out.put(1, 1)  # a transform
    out.put(0, 2)  # predictor
    out.put(0, 3)  # 4x4 blocks
    out.put(0, 1)  # the sub-image: no colour cache
    for symbol in (mode, 0, 0, 0, 0):  # green holds the mode
        out.simple_code(symbol)
    out.put(0, 1)  # no more transforms
    out.put(0, 1)  # no colour cache
    out.put(0, 1)  # no meta codes
    for symbol in (0, 0, 0, 0, 0):
        out.simple_code(symbol)
    body = out.data()
    chunk = b"VP8L" + struct.pack("<I", len(body)) + body
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


REFUSED = {
    "simple loop filter": _vp8_file(_value(0, 1) + _filter_header(simple=1)),
    "loop-filter sharpness 3": _vp8_file(_value(0, 1) + _filter_header(sharpness=3)),
    "loop-filter deltas": _vp8_file(_value(0, 1) + _filter_header(deltas=1)),
    "2 token partitions": _vp8_file(_value(0, 1) + _filter_header(partitions=1)),
    "8 token partitions": _vp8_file(_value(0, 1) + _filter_header(partitions=3)),
    "segment values relative": _vp8_file(_value(1, 1) + _value(1, 1) + _value(1, 1)
                                         + _value(0, 1)),
    "segment map kept": _vp8_file(_value(1, 1) + _value(0, 1) + _value(0, 1)),
    "lossless predictor mode 14": _vp8l_predictor_file(14),
    "lossless predictor mode 15": _vp8l_predictor_file(15),
}


@pytest.mark.parametrize("feature", sorted(REFUSED))
def test_torch_webp_refused_features_raise_by_name(tmp_path, feature):
    """The features no corpus file reaches (neither Pillow nor cv2 writes
    them) raise ``ValueError`` naming the feature and the file, in both
    modes, from a file and from bytes."""
    path = tmp_path / "refused.webp"
    path.write_bytes(REFUSED[feature])
    for read in (png.imread_color, png.imread_unchanged):
        with pytest.raises(ValueError, match=feature) as err:
            read(path)
        assert str(path) in str(err.value)
    with pytest.raises(ValueError, match=feature):
        png.decode_unchanged(REFUSED[feature])


def test_torch_webp_hand_written_streams_decode():
    """The writers above are sound: the boolean encoder's decisions come
    back from the port's decoder, and a lossless file whose predictor
    asks for mode 1 (left) decodes to cv2's image."""
    rng = np.random.default_rng(0)
    decisions = [(int(b), int(p)) for b, p in zip(rng.integers(0, 2, 500),
                                                  rng.integers(1, 256, 500))]
    br = webp._Bool(_bool_encode(decisions))
    assert [br.bit(p) for _, p in decisions] == [b for b, _ in decisions]
    data = _vp8l_predictor_file(1)
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    _same(png.decode_unchanged(data), want)


# ---------------------------------------------------------------------------
# the reference's readers on WebP files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quality", [60, 101])
@pytest.mark.parametrize("resize", [1.0, 0.5])
def test_torch_image_from_webp_matches_reference(tmp_path, resize, quality):
    """``Image`` of a WebP rgb (lossy or lossless) and seg: the port's
    float32 arrays equal the reference's (cv2's reads)."""
    import diffdope_tpu.image as ref

    import diffdope_tpu_torch.image as port

    rgb, seg = tmp_path / "rgb.webp", tmp_path / "seg.webp"
    frame = _scene_frame(64, 48)
    assert cv2.imwrite(str(rgb), frame, [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert cv2.imwrite(str(seg), ((frame[..., 0] > 150) * 255).astype(np.uint8),
                       [cv2.IMWRITE_WEBP_QUALITY, 101])
    for kw in (dict(img_path=str(rgb), img_resize=resize),
               dict(img_path=str(seg), img_resize=resize, flip_img=False)):
        _same(port.Image(**kw).img_tensor, ref.Image(**kw).img_tensor)


@pytest.mark.parametrize("name", ["lossy_render_130x70_q75_m6", "alpha_lossy_130x70_aq100",
                                  "lossless_alpha_exact1_130x70", "exif_orient6_lossy_12x20"])
def test_torch_webp_textures_match_reference(tmp_path, name):
    """``_load_texture`` of a WebP, a textured PLY naming it and a .glb
    embedding it, through both packages' ``load_mesh``: the textures are
    equal, the baked corner colours within 1e-6."""
    from diffdope_tpu.mesh import _load_texture as ref_load_texture
    from diffdope_tpu.mesh import load_mesh as ref_load_mesh

    from diffdope_tpu_torch import mesh as port
    from diffdope_tpu_torch.mesh import load_ply

    data = VARIANTS[f"webp_{name}"][0]
    path = tmp_path / "tex.webp"
    path.write_bytes(data)
    _same(port._load_texture(path), ref_load_texture(path))
    src = ROOT / "data/standins/standin_tex_checker.ply"
    lines = [b"comment TextureFile tex.webp" if b"TextureFile" in ln else ln
             for ln in src.read_bytes().split(b"\n")]
    (tmp_path / "m.ply").write_bytes(b"\n".join(lines))
    ply_data = load_ply(src)
    testing.write_gltf(tmp_path / "m.glb", ply_data["vertices"], ply_data["faces"],
                       uv=ply_data["uv"], image=data)
    for mesh_path in (tmp_path / "m.ply", tmp_path / "m.glb"):
        got, want = port.load_mesh(mesh_path, scale=0.01), ref_load_mesh(mesh_path, scale=0.01)
        _same(np.asarray(got.tex), np.asarray(want.tex))
        np.testing.assert_allclose(got.corner_colors, want.corner_colors, rtol=0, atol=1e-6)


def test_torch_diffdope_from_lossless_webp_equals_png(tmp_path):
    """A CPU ``DiffDope`` (rgb + mask + depth, 3 SGD steps) from lossless
    WebP rgb and seg files runs exactly as from PNGs of the same pixels:
    gt arrays, loss history, argmin and pose, bit for bit."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.mesh import save_ply
    from diffdope_tpu_torch.testing import icosphere

    h, w = 48, 64
    frame = _scene_frame(w, h, seed=2)
    y, x = np.mgrid[0:h, 0:w]
    seg = (((x - 30) ** 2 + (y - 24) ** 2) < 200).astype(np.uint8) * 255
    depth = (2500 + 30 * np.sin(x / 9.0)).astype(np.uint16)
    files = {}
    for ext, flags in (("png", []), ("webp", [cv2.IMWRITE_WEBP_QUALITY, 101])):
        files[ext] = {k: tmp_path / f"{k}.{ext}" for k in ("rgb", "seg")}
        assert cv2.imwrite(str(files[ext]["rgb"]), frame, flags)
        assert cv2.imwrite(str(files[ext]["seg"]), seg, flags)
    cv2.imwrite(str(tmp_path / "depth.png"), depth)
    for key in ("rgb", "seg"):
        _same(png.imread_color(files["webp"][key]), png.imread_color(files["png"][key]))
    verts, faces = icosphere(1)
    ply = tmp_path / "sphere.ply"
    save_ply(ply, verts * 0.4, faces, colors=verts * 0.5 + 0.5)
    runs = {}
    for ext in ("png", "webp"):
        cfg = {
            "camera": {"fx": 60.0, "fy": 60.0, "cx": 32.0, "cy": 24.0, "im_width": w,
                       "im_height": h},
            "scene": {"path_img": str(files[ext]["rgb"]), "path_depth": str(tmp_path / "depth.png"),
                      "path_segmentation": str(files[ext]["seg"]), "image_resize": 1.0},
            "object3d": {"position": [0.02, -0.01, 3.0], "rotation": [0.01, 0.0, 0.0, 1.0],
                         "scale": 1.0, "model_path": str(ply)},
            "losses": {"l1_mask": True, "l1_rgb_with_mask": True, "l1_depth_with_mask": True},
            "hyperparameters": {"batchsize": 2, "nb_iterations": 3},
            "tpu": {"raster_impl": "reference", "progress": False},
        }
        dd = tdd.DiffDope(cfg=tdd.ConfigNode(copy.deepcopy(cfg)), device="cpu")
        dd.run_optimization()
        runs[ext] = dd
    a, b = runs["png"], runs["webp"]
    assert set(a.gt_tensors) == set(b.gt_tensors) == {"rgb", "depth", "segmentation"}
    for key in a.gt_tensors:
        np.testing.assert_array_equal(np.asarray(b.gt_tensors[key]), np.asarray(a.gt_tensors[key]))
    assert set(a.losses_values) == set(b.losses_values)
    for key in a.losses_values:
        np.testing.assert_array_equal(b.losses_values[key], a.losses_values[key])
    assert a.get_argmin() == b.get_argmin()
    np.testing.assert_array_equal(b.get_pose(), a.get_pose())
