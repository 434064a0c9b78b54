"""The image variants of ``testing.image_variants``, the WebP corpus of
``testing.webp_variants``, the later formats' variants of
``testing.format_variants`` and the OpenEXR corpus of
``testing.exr_variants`` through this host's cv2 and through the
port's readers: one JSON line each with the variant, its size and, per
cv2 mode it is held in (``IMREAD_UNCHANGED`` and ``IMREAD_COLOR``),
``cv2.imdecode``'s dtype, shape and SHA-1 (or None), ``cv2.imread``'s of
the bytes written to a file where it differs (``<mode>_imread``), and
whether the port's reads of the bytes and of the file are equal bit for
bit (``--cv2-only`` skips the port).  A cv2 read that raises is
recorded as "raised" (cv2 4.13 raises on every OpenEXR read unless
``OPENCV_IO_ENABLE_OPENEXR`` is 1 or true), and the port's read is equal
to it when it raises ``exr.CodecDisabled``.  The last line counts the
variants and the reads that differ.

    python tools/port_cv2_formats.py [--cv2-only] [name-substring ...]
    python tools/port_cv2_formats.py --record [CV2_ONLY_LINES]
    python tools/port_cv2_formats.py --gate
    python tools/port_cv2_formats.py --record-exr SET_LINES UNSET_LINES GATE_LINES

``--record`` (with the cv2 the tests run against, 5.0) writes
``tests/torch_data/format_variants_cv2.json``: each ``format_variants``
file's SHA-1 and that cv2's reads of it, the yardstick where another
host's cv2 lacks the format; given the ``--cv2-only`` lines of another
cv2 (the card host's 4.13), it also records the variants that cv2 reads
otherwise, with both reads, in ``differs``.

The OpenEXR record, ``tests/torch_data/exr_cv2.json``, is cv2 4.13.0's
on the card's host (its cv2 is built over OpenEXR 2.3.0; the tests'
cv2 5.0 has no OpenEXR codec).  There, run ``OPENCV_IO_ENABLE_OPENEXR=1
python tools/port_cv2_formats.py --cv2-only exr_ > SET_LINES``, the same
without the variable ``> UNSET_LINES``, and ``python
tools/port_cv2_formats.py --gate > GATE_LINES`` (cv2's reads under each
value of the variable, a process each); then ``--record-exr`` with the
three files, on any host, writes the record: each corpus file's SHA-1
and cv2 4.13's reads of it with the gate set and unset, and the gate's
values.
"""

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from diffdope_tpu_torch.exr import CodecDisabled  # noqa: E402
from diffdope_tpu_torch.testing import (  # noqa: E402
    exr_variants,
    format_variants,
    image_variants,
    webp_variants,
)

#: cv2 5.0's reads of ``format_variants`` (``--record`` writes it)
RECORDED = ROOT / "tests" / "torch_data" / "format_variants_cv2.json"
#: the card host's cv2 4.13 reads of ``exr_variants`` (``--record-exr``)
EXR_RECORDED = ROOT / "tests" / "torch_data" / "exr_cv2.json"
#: the values of ``OPENCV_IO_ENABLE_OPENEXR`` ``--gate`` tries (None: unset)
GATE_VALUES = (None, "1", "true", "True", "TRUE", "0", "false", "False", "FALSE", "ON",
               "yes", "", "2")
#: the formats of ``format_variants`` by name prefix, as cv2's build
#: information names them
FORMATS = {"gif_": "GIF", "sunras_": "SUNRASTER", "hdr_": "HDR", "tiff_": "TIFF"}


def summary(img):
    if img is None:
        return None
    return [img.dtype.name, list(img.shape), hashlib.sha1(img.tobytes()).hexdigest()[:12]]


def cv2_oddities():
    """Files on which cv2 5.0 gives no image or a damaged one, read in both
    modes, to compare cv2 versions (the port is not held to these)."""
    from diffdope_tpu_torch.testing import (BOTH, variant_image, encode_pam, encode_pfm,
                                            encode_tiff)

    c8 = variant_image(19, 27, 3, np.uint8, 2)
    g16 = variant_image(19, 27, 0, np.uint16, 4)
    c16 = variant_image(19, 27, 3, np.uint16, 5)
    mask = (variant_image(19, 27, 0, np.uint8, 1) > 50).astype(np.uint8)
    ga8 = variant_image(19, 27, 2, np.uint8, 14)
    return {
        "odd_tiff_tiles_c8_c1": (encode_tiff(c8, tile=(16, 16)), BOTH),
        "odd_tiff_tiles_g16_partial": (encode_tiff(g16, compression=5, tile=(16, 16)), BOTH),
        "odd_tiff_planar2_c16": (encode_tiff(c16, compression=5, planar=2), BOTH),
        "odd_pfm_Pf": (encode_pfm(variant_image(19, 27, 0, np.float32, 7)), BOTH),
        "odd_pam_rgb_alpha": (encode_pam(variant_image(19, 27, 4, np.uint8, 3),
                                         tupltype="RGB_ALPHA"), BOTH),
        # cv2.imdecode gives None, cv2.imread the image
        "odd_tiff_b1_tiles_c1": (encode_tiff(mask, bits=1, tile=(16, 16)), BOTH),
        # partial tiles of grey with alpha: cv2 leaves pixels unwritten
        "odd_tiff_grey_alpha8_tiles_partial": (encode_tiff(ga8, compression=5,
                                                           tile=(16, 16)), BOTH),
        # signed 12-bit colour: cv2 shifts the samples across pixels
        "odd_tiff_b12_c_signed": (encode_tiff((c16 >> 4).astype(np.uint16), bits=12,
                                              sample_format=2, compression=8), BOTH),
    }


def _cv2_summary(read):
    """cv2's read as :func:`summary` gives it, "raised" where cv2 raises."""
    try:
        img = read()
    except Exception:  # cv2.error, whatever its module calls it
        return "raised"
    return summary(img)


def _read(path_or_data, mode: str, how: str):
    from diffdope_tpu_torch import png

    fn = getattr(png, f"decode_{mode}" if how == "decode" else f"imread_{mode}")
    got = fn(path_or_data)
    if mode == "color" and got is not None:
        got = np.ascontiguousarray(got[..., ::-1])
    return got


def compare(variants, port: bool = True, recorded=None):
    """Yield one row (a dict, as printed) per variant: cv2's reads of its
    bytes (``imdecode``) and of a file of them (``imread``) in each of its
    modes, and with ``port`` whether the port's reads equal them; the
    count of differing port reads is in each row's ``differ``.  Where
    ``recorded`` (name -> a row of another cv2, as ``--record`` keeps
    them) holds a variant, the port is held to that row instead (the row
    gets ``yardstick``: that cv2's version) and the row keeps this cv2's
    own reads as they are."""
    import cv2

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "variant"
        for name, (data, modes) in variants.items():
            buf = np.frombuffer(data, np.uint8)
            path.write_bytes(data)
            row = {"variant": name, "bytes": len(data), "cv2": cv2.__version__, "differ": 0}
            other = (recorded or {}).get(name)
            if other is not None:
                row["yardstick"] = other["cv2"]
                if other["sha1"] != hashlib.sha1(data).hexdigest():
                    row["differ"] += 1
                    row["bytes_differ_from_recorded"] = True
            for mode in modes:
                flag = cv2.IMREAD_UNCHANGED if mode == "unchanged" else cv2.IMREAD_COLOR
                want = {"decode": _cv2_summary(lambda: cv2.imdecode(buf, flag)),
                        "read": _cv2_summary(lambda: cv2.imread(str(path), flag))}
                row[mode] = want["decode"]
                if want["read"] != want["decode"]:
                    row[f"{mode}_imread"] = want["read"]
                if other is not None:
                    want = {"decode": other[mode], "read": other.get(f"{mode}_imread",
                                                                     other[mode])}
                if not port:
                    continue
                for how, arg in (("decode", data), ("read", path)):
                    try:
                        same = summary(_read(arg, mode, how)) == want[how]
                    except CodecDisabled as err:
                        same = True if want[how] == "raised" else f"raised: {err}"
                    except ValueError as err:
                        same = f"raised: {err}"
                    row[f"{mode}_{how}_port_equal"] = same
                    row["differ"] += same is not True
            yield row


def load_recorded():
    """The committed record: {"cv2": version, "variants": {name: row},
    "differs": {name: {"<version>": row, ...}}}."""
    return json.loads(RECORDED.read_text())


def cv2_formats():
    """The formats of ``FORMATS`` this host's cv2 was built to read
    (``getBuildInformation``'s Media I/O lines)."""
    import cv2

    info = cv2.getBuildInformation()
    have = set()
    for name in FORMATS.values():
        for line in info.splitlines():
            key, _, value = line.strip().partition(":")
            if key.strip() == name:
                if value.strip() and not value.strip().upper().startswith("NO"):
                    have.add(name)
                break
    return have


def format_of(name: str) -> str:
    return next(fmt for prefix, fmt in FORMATS.items() if name.startswith(prefix))


def record(argv):
    """``--record``: write RECORDED from this host's cv2, and the variants
    another cv2's ``--cv2-only`` lines (``argv[0]``, if given) read
    otherwise."""
    import cv2

    variants = format_variants()
    rows = {}
    for row in compare(variants, port=False):
        name = row.pop("variant")
        row.pop("differ")
        row.pop("bytes")
        row["sha1"] = hashlib.sha1(variants[name][0]).hexdigest()
        rows[name] = row
    differs = {}
    if argv:
        for line in Path(argv[0]).read_text().splitlines():
            other = json.loads(line)
            name = other.get("variant")
            if name not in rows:
                continue
            keys = [k for k in rows[name] if k not in ("cv2", "sha1")]
            if any(other.get(k) != rows[name].get(k) for k in keys) or \
                    any(k not in rows[name] for k in other if k.startswith(("unchanged",
                                                                            "color"))):
                differs[name] = {rows[name]["cv2"]: {k: rows[name][k] for k in keys},
                                 other["cv2"]: {k: v for k, v in other.items()
                                                if k.startswith(("unchanged", "color"))}}
    RECORDED.write_text(json.dumps({"cv2": cv2.__version__, "variants": rows,
                                    "differs": differs}, indent=1, sort_keys=True) + "\n")
    print(json.dumps({"recorded": len(rows), "cv2": cv2.__version__,
                      "differs": sorted(differs)}))


def gate_lines():
    """``--gate``: cv2's reads of one OpenEXR file under each value of
    ``OPENCV_IO_ENABLE_OPENEXR`` (a process each: cv2 reads it once), a
    JSON line a value."""
    import os
    import subprocess

    path = sorted(p for p in exr_variants() if "zip_float_c3" in p)[0]
    code = ("import sys, json; sys.path.insert(0, {root!r}); import numpy as np; "
            "from tools.port_cv2_formats import _cv2_summary, exr_variants; import cv2; "
            "d = np.frombuffer(exr_variants()[{name!r}][0], np.uint8); "
            "print(json.dumps([_cv2_summary(lambda: cv2.imdecode(d, f)) "
            "for f in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_COLOR)]))")
    for value in GATE_VALUES:
        env = {k: v for k, v in os.environ.items() if k != "OPENCV_IO_ENABLE_OPENEXR"}
        if value is not None:
            env["OPENCV_IO_ENABLE_OPENEXR"] = value
        out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT), name=path)],
                             env=env, capture_output=True, text=True, check=True).stdout
        reads = json.loads(out)
        state = "raised" if reads == ["raised"] * 2 else "reads"
        print(json.dumps({"value": value, "cv2_reads": state}), flush=True)


def record_exr(set_lines, unset_lines, gate_file):
    """``--record-exr``: EXR_RECORDED from the card host's lines."""
    variants = exr_variants()

    def rows(path):
        out, last = {}, None
        for line in Path(path).read_text().splitlines():
            row = json.loads(line)
            if "variant" not in row:
                last = row
                continue
            name = row.pop("variant")
            if name in variants:
                out[name] = {k: v for k, v in row.items() if k.startswith(("unchanged",
                                                                          "color"))}
        return out, last

    gate_set, last = rows(set_lines)
    gate_unset, _ = rows(unset_lines)
    missing = sorted(set(variants) - set(gate_set) - set(gate_unset))
    if missing:
        raise SystemExit(f"no line for {missing}")
    for name, row in gate_set.items():
        row["sha1"] = hashlib.sha1(variants[name][0]).hexdigest()
        row["gate_unset"] = gate_unset[name]
    gate = [json.loads(line) for line in Path(gate_file).read_text().splitlines()]
    EXR_RECORDED.write_text(json.dumps({
        "cv2": last["cv2"], "openexr": last.get("openexr"),
        "host": "the H100 card's host, cv2 of opencv-python", "gate": gate,
        "variants": gate_set}, indent=1, sort_keys=True) + "\n")
    print(json.dumps({"recorded": len(gate_set), "cv2": last["cv2"]}))


def load_exr_recorded():
    """The committed OpenEXR record (see the module's docstring)."""
    return json.loads(EXR_RECORDED.read_text())


def main(argv):
    import cv2

    if "--record" in argv:
        record([a for a in argv if not a.startswith("--")])
        return
    if "--record-exr" in argv:
        record_exr(*[a for a in argv if not a.startswith("--")])
        return
    if "--gate" in argv:
        gate_lines()
        return
    cv2_only = "--cv2-only" in argv
    keys = [a for a in argv if not a.startswith("--")]
    variants = {**image_variants(), **webp_variants(), **format_variants(),
                **exr_variants()}
    if cv2_only:
        variants.update(cv2_oddities())
    variants = {k: v for k, v in variants.items() if not keys or any(s in k for s in keys)}
    differ = 0
    for row in compare(variants, port=not cv2_only):
        differ += row.pop("differ")
        print(json.dumps(row), flush=True)
    openexr = [line.split(":", 1)[1].strip() for line in
               cv2.getBuildInformation().splitlines() if line.strip().startswith("OpenEXR:")]
    print(json.dumps({"variants": len(variants), "cv2": cv2.__version__,
                      "openexr": openexr[0] if openexr else None,
                      "formats": sorted(cv2_formats()),
                      "port_differs": None if cv2_only else differ}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
