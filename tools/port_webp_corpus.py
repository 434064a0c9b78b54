"""Write the WebP corpus that ``tests/test_torch_webp.py`` and
``chip_smoke.py`` hold the port's reader to cv2 on: deterministic files
written with Pillow's WebP writer and cv2's ``imwrite``, plus files edited
here (raw and filtered alpha, EXIF orientations, truncated and malformed
files), into ``tests/torch_data/webp/``.

    python tools/port_webp_corpus.py [OUT_DIR]

The files are committed: the card's host may lack Pillow, and another
libwebp writes other bytes.  ``testing.webp_variants`` lists them.
"""

import io
import struct
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "torch_data" / "webp"

#: (width, height)
SIZES = ((1, 1), (7, 5), (16, 16), (17, 33), (130, 70))


def noise(w, h, seed, ch=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, ch), dtype=np.uint8)


def gradient(w, h, ch=3):
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    fx, fy = x / max(w - 1, 1), y / max(h - 1, 1)
    planes = [255 * fx, 255 * fy, 127 + 120 * np.sin(3 * fx + 2 * fy), 255 * (1 - fx * fy)]
    return np.stack(planes[:ch], -1).round().astype(np.uint8)


def flat(w, h, ch=3):
    return np.broadcast_to(np.array([40, 120, 200, 255][:ch], np.uint8), (h, w, ch)).copy()


def render(w, h, ch=3):
    """Sharp-edged shapes on a two-tone background."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.zeros((h, w, 4), np.uint8)
    img[...] = (30, 30, 60, 255)
    img[y > h // 2] = (200, 190, 170, 255)
    img[(x - 0.3 * w) ** 2 + (y - 0.4 * h) ** 2 < (0.25 * min(w, h)) ** 2] = (230, 40, 30, 255)
    img[(abs(x - 0.7 * w) < 0.15 * w) & (abs(y - 0.6 * h) < 0.2 * h)] = (20, 200, 60, 128)
    img[(x + 2 * y) % 23 == 0] = (250, 250, 250, 0)
    return img[..., :ch].copy()


def alpha_disc(w, h):
    """RGBA: the render, alpha a soft disc."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    r = np.hypot((x - w / 2) / max(w, 1), (y - h / 2) / max(h, 1))
    img = render(w, h, 4)
    img[..., 3] = np.clip(255 * (1.6 - 4 * r), 0, 255).astype(np.uint8)
    return img


def smooth(kind, w=96, h=64):
    """Smooth fields whose best VP8L predictors differ by kind."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    if kind == "blur":
        from scipy.ndimage import gaussian_filter

        rng = np.random.default_rng(3)
        v = gaussian_filter(rng.integers(0, 256, (h, w)).astype(np.float64), 4) * 3 - 250
    else:
        v = {"diag1": (x + y) * 2, "diag2": (x - y) * 2 + 128, "quad": x * x / 40 + y * y / 20,
             "rings": 128 + 120 * np.sin(np.hypot(x - w / 2, y - h / 2) / 3)}[kind]
    return np.clip(np.stack([v, v * 0.7 + 20, 255 - v], -1), 0, 255).astype(np.uint8)


def checker(w=64, h=48):
    """A gradient with opaque black squares (VP8L's black predictor)."""
    img = gradient(w, h, 4)
    img[..., 3] = 255
    y, x = np.mgrid[0:h, 0:w]
    img[(x // 8 + y // 8) % 2 == 1] = (0, 0, 0, 255)
    return img


def palette(w, h, n, seed):
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    idx = ((x // 3 + y // 2 + rng.integers(0, 2, (h, w))) % n)
    return pal[idx]


def tiles(w, h, seed):
    tile = noise(8, 8, seed)
    return np.tile(tile, (-(-h // 8), -(-w // 8), 1))[:h, :w]


def pil(img, **kw):
    from PIL import Image

    buf = io.BytesIO()
    mode = "RGBA" if img.shape[-1] == 4 else "RGB"
    frame = Image.fromarray(np.ascontiguousarray(img), mode)
    frame.save(buf, "WEBP", **kw)
    return buf.getvalue()


def cv2_write(img, quality):
    import cv2

    ok, data = cv2.imencode(".webp", np.ascontiguousarray(img[..., ::-1] if img.shape[-1] == 3
                                                          else img[..., [2, 1, 0, 3]]),
                            [cv2.IMWRITE_WEBP_QUALITY, quality])
    assert ok
    return data.tobytes()


# ---------------------------------------------------------------------------
# the container, for the edited files
# ---------------------------------------------------------------------------

def chunks(data):
    """[(fourcc, body)] of a RIFF WebP file."""
    out, at = [], 12
    while at + 8 <= len(data):
        kind, size = data[at:at + 4], struct.unpack("<I", data[at + 4:at + 8])[0]
        out.append((kind, data[at + 8:at + 8 + size]))
        at += 8 + size + (size & 1)
    return out


def riff(parts):
    body = b"WEBP" + b"".join(k + struct.pack("<I", len(b)) + b + b"\0" * (len(b) & 1)
                              for k, b in parts)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(w, h, flags):
    return b"VP8X", struct.pack("<I", flags) + (w - 1).to_bytes(3, "little") \
        + (h - 1).to_bytes(3, "little")


def filter_alpha(a, kind):
    """RFC 9649 2.7's forward alpha filters (the decoder undoes them)."""
    a = a.astype(np.int32)
    h, w = a.shape
    if kind == 0:
        return a.astype(np.uint8)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    pred[1:, 0] = a[:-1, 0]
    if kind == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif kind == 2:
        pred[1:, 1:] = a[:-1, 1:]
    else:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return ((a - pred) & 255).astype(np.uint8)


def with_raw_alpha(rgba, kind, quality=80):
    """A lossy file whose ALPH chunk is uncompressed, filtered by ``kind``."""
    h, w = rgba.shape[:2]
    lossy = dict(chunks(pil(np.ascontiguousarray(rgba[..., :3]), quality=quality)))[b"VP8 "]
    alph = bytes([kind << 2]) + filter_alpha(rgba[..., 3], kind).tobytes()
    return riff([vp8x(w, h, 0x10), (b"ALPH", alph), (b"VP8 ", lossy)])


def with_lossless_alpha(rgba, kind, quality=80):
    """A lossy file whose ALPH chunk is VP8L-coded (its image stream past
    the 5-byte header: Pillow's lossless write of the filtered alpha as
    green), filtered by ``kind``."""
    h, w = rgba.shape[:2]
    lossy = dict(chunks(pil(np.ascontiguousarray(rgba[..., :3]), quality=quality)))[b"VP8 "]
    green = np.zeros((h, w, 3), np.uint8)
    green[..., 1] = filter_alpha(rgba[..., 3], kind)
    stream = dict(chunks(pil(green, lossless=True, exact=True)))[b"VP8L"][5:]
    alph = bytes([1 | kind << 2]) + stream
    return riff([vp8x(w, h, 0x10), (b"ALPH", alph), (b"VP8 ", lossy)])


def exif_orientation(k):
    """A big-endian TIFF block with one orientation entry."""
    return b"MM\0*\0\0\0\x08\0\x01" + struct.pack(">HHIHH", 0x0112, 3, 1, k, 0) + b"\0" * 4


def corpus():
    out = {}
    # ---- lossy: qualities, methods, sizes, contents
    for w, h in SIZES:
        for name, img in (("gradient", gradient(w, h)), ("render", render(w, h)),
                          ("flat", flat(w, h))):
            for q in (0, 50, 90, 100):
                out[f"lossy_{name}_{w}x{h}_q{q}"] = pil(img, quality=q)
    for w, h in SIZES[:4]:
        for q in (0, 50, 100):
            for m in (0, 4, 6):
                out[f"lossy_noise_{w}x{h}_q{q}_m{m}"] = pil(noise(w, h, w * h + q), quality=q,
                                                           method=m)
    for m in (0, 6):
        for q in (20, 75):
            out[f"lossy_render_130x70_q{q}_m{m}"] = pil(render(130, 70), quality=q, method=m)
            out[f"lossy_gradient_130x70_q{q}_m{m}"] = pil(gradient(130, 70), quality=q, method=m)
    for q in (10, 60, 95):
        out[f"lossy_cv2_render_130x70_q{q}"] = cv2_write(render(130, 70), q)
    out["lossy_cv2_gradient_17x33_q80"] = cv2_write(gradient(17, 33), 80)
    out["lossy_flat_256x256_q50_m0"] = pil(flat(256, 256), quality=50, method=0)  # skip flags
    # ---- lossy with alpha
    for w, h in ((7, 5), (17, 33), (130, 70)):
        rgba = alpha_disc(w, h)
        for aq in (100, 30):
            out[f"alpha_lossy_{w}x{h}_aq{aq}"] = pil(rgba, quality=70, alpha_quality=aq)
        out[f"alpha_lossy_{w}x{h}_m6"] = pil(rgba, quality=40, method=6)
        for kind in range(4):
            if w * h < 4000:
                out[f"alpha_raw_{w}x{h}_f{kind}"] = with_raw_alpha(rgba, kind)
            out[f"alpha_vp8l_{w}x{h}_f{kind}"] = with_lossless_alpha(rgba, kind)
    out["alpha_lossy_cv2_130x70"] = cv2_write(alpha_disc(130, 70), 85)
    # ---- lossless
    for w, h in SIZES:
        out[f"lossless_gradient_{w}x{h}"] = pil(gradient(w, h), lossless=True)
        out[f"lossless_render_{w}x{h}"] = pil(render(w, h), lossless=True)
    for w, h in SIZES[:4]:
        out[f"lossless_noise_{w}x{h}"] = pil(noise(w, h, 7), lossless=True)
    for n in (2, 3, 4, 11, 16, 200, 256):
        out[f"lossless_palette{n}_61x29"] = pil(palette(61, 29, n, n), lossless=True)
    for q in (0, 50, 100):
        for m in (0, 3, 6):
            out[f"lossless_render_130x70_q{q}_m{m}"] = pil(render(130, 70), lossless=True,
                                                          quality=q, method=m)
    out["lossless_tiles_130x70"] = pil(tiles(130, 70, 3), lossless=True)
    for kind, m in (("diag1", 4), ("diag2", 4), ("quad", 4), ("rings", 4), ("blur", 6)):
        out[f"lossless_{kind}_96x64_m{m}"] = pil(smooth(kind), lossless=True, quality=100,
                                                 method=m)
    out["lossless_checker_64x48"] = pil(checker(), lossless=True, quality=100, method=6)
    out["lossless_tiles_palette_130x70"] = pil(palette(8, 8, 12, 5)[np.arange(70)[:, None] % 8,
                                                                   np.arange(130) % 8],
                                               lossless=True)
    big = np.concatenate([render(256, 96), gradient(256, 96), tiles(256, 64, 9)], axis=0)
    out["lossless_mixed_256x256"] = pil(big, lossless=True, quality=100, method=6)
    for exact in (False, True):
        out[f"lossless_alpha_exact{int(exact)}_130x70"] = pil(alpha_disc(130, 70),
                                                              lossless=True, exact=exact)
        out[f"lossless_alpha_exact{int(exact)}_17x33"] = pil(alpha_disc(17, 33),
                                                             lossless=True, exact=exact)
    out["lossless_cv2_render_130x70"] = cv2_write(render(130, 70), 101)
    out["lossless_cv2_alpha_17x33"] = cv2_write(alpha_disc(17, 33), 101)
    # ---- animations
    from PIL import Image

    for n, lossless in ((2, True), (3, False)):
        frames = [Image.fromarray(render(40, 24)), Image.fromarray(noise(40, 24, 5)),
                  Image.fromarray(gradient(40, 24))][:n]
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=40,
                       lossless=lossless, quality=60)
        out[f"anim_{n}frames_{'lossless' if lossless else 'lossy'}_40x24"] = buf.getvalue()
    frames = [Image.fromarray(alpha_disc(40, 24), "RGBA"), Image.fromarray(render(40, 24, 4),
                                                                            "RGBA")]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=40,
                   quality=70)
    out["anim_2frames_alpha_40x24"] = buf.getvalue()
    # ---- VP8X with EXIF, ICC, XMP
    for k in range(1, 9):
        out[f"exif_orient{k}_lossy_12x20"] = pil(render(12, 20), quality=80,
                                                 exif=exif_orientation(k))
    out["exif_orient6_lossless_12x20"] = pil(render(12, 20), lossless=True,
                                             exif=exif_orientation(6))
    out["exif_orient8_alpha_12x20"] = pil(alpha_disc(12, 20), quality=80,
                                          exif=exif_orientation(8))
    icc = b"\0\0\x01\x00fake icc profile" + bytes(range(100))
    xmp = b"<x:xmpmeta xmlns:x='adobe:ns:meta/'><rdf:RDF/></x:xmpmeta>"
    out["icc_lossy_17x33"] = pil(render(17, 33), quality=70, icc_profile=icc)
    out["xmp_lossless_17x33"] = pil(render(17, 33), lossless=True, xmp=xmp)
    out["icc_exif_xmp_alpha_17x33"] = pil(alpha_disc(17, 33), quality=70, icc_profile=icc,
                                          exif=exif_orientation(3), xmp=xmp)
    # ---- truncated and malformed
    lossy = out["lossy_render_130x70_q75_m0"]
    lossless = out["lossless_render_130x70_q50_m3"]
    alpha = out["alpha_lossy_130x70_aq100"]
    out["bad_truncated_lossy"] = lossy[:len(lossy) // 2]
    out["bad_truncated_lossless"] = lossless[:len(lossless) // 2]
    out["bad_truncated_alpha"] = alpha[:len(alpha) - 40]
    out["bad_truncated_header"] = lossy[:30]
    size = struct.unpack("<I", lossy[4:8])[0]
    out["bad_riff_size_large"] = lossy[:4] + struct.pack("<I", size + 10) + lossy[8:]
    out["odd_riff_size_small_trailing"] = lossy + b"trailing bytes"
    out["odd_riff_size_short"] = lossless[:4] + struct.pack("<I", len(lossless) - 8 - 2) \
        + lossless[8:]
    bad = bytearray(lossless)
    bad[40:60] = bytes(20)
    out["bad_lossless_zeroed"] = bytes(bad)
    bad = bytearray(lossy)
    bad[23:26] = b"\x9d\x01\x2b"
    out["bad_lossy_start_code"] = bytes(bad)
    body = dict(chunks(lossy))[b"VP8 "]
    first = (body[0] | body[1] << 8 | body[2] << 16) >> 5
    out["bad_lossy_tokens_short"] = riff([(b"VP8 ", body[:10 + first + (len(body) - first) // 3])])
    tag = (body[0] | body[1] << 8 | body[2] << 16) & 31 | 12 << 5
    out["bad_lossy_first_partition_short"] = riff([(b"VP8 ", tag.to_bytes(3, "little")
                                                    + body[3:])])
    bad = bytearray(body)
    bad[10 + first + 40:10 + first + 48] = bytes(range(8))
    out["odd_lossy_tokens_altered"] = riff([(b"VP8 ", bytes(bad))])
    w, h = 130, 70
    parts = chunks(alpha)
    out["bad_vp8x_canvas"] = riff([vp8x(w + 1, h, 0x10)] + parts[1:])
    out["odd_vp8x_no_alpha_flag"] = riff([vp8x(w, h, 0)] + parts[1:])
    out["odd_unknown_chunk"] = riff(parts[:1] + [(b"ZZZZ", b"abc")] + parts[1:])
    return out


def main(argv):
    out_dir = Path(argv[0]) if argv else OUT
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in out_dir.glob("*.webp"):
        old.unlink()
    files = corpus()
    total = 0
    for name, data in files.items():
        (out_dir / f"{name}.webp").write_bytes(data)
        total += len(data)
    print(f"{len(files)} files, {total} bytes, largest "
          f"{max(len(d) for d in files.values())} bytes, in {out_dir}")


if __name__ == "__main__":
    main(sys.argv[1:])
