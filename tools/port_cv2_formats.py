"""The image variants of ``testing.image_variants`` and the WebP corpus of
``testing.webp_variants`` through this host's
cv2 and through the port's readers: one JSON line each with the variant,
its size and, per cv2 mode it is held in (``IMREAD_UNCHANGED`` and
``IMREAD_COLOR``), ``cv2.imdecode``'s dtype, shape and SHA-1 (or None),
``cv2.imread``'s of the bytes written to a file where it differs
(``<mode>_imread``), and whether the port's reads of the bytes and of the
file are equal bit for bit (``--cv2-only`` skips the port).  The last
line counts the variants and the reads that differ.

    python tools/port_cv2_formats.py [--cv2-only] [name-substring ...]
"""

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from diffdope_tpu_torch.testing import image_variants, webp_variants  # noqa: E402


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
    return {
        "odd_tiff_tiles_c8_c1": (encode_tiff(c8, tile=(16, 16)), BOTH),
        "odd_tiff_tiles_g16_partial": (encode_tiff(g16, compression=5, tile=(16, 16)), BOTH),
        "odd_tiff_planar2_c16": (encode_tiff(c16, compression=5, planar=2), BOTH),
        "odd_pfm_Pf": (encode_pfm(variant_image(19, 27, 0, np.float32, 7)), BOTH),
        "odd_pam_rgb_alpha": (encode_pam(variant_image(19, 27, 4, np.uint8, 3),
                                         tupltype="RGB_ALPHA"), BOTH),
    }


def compare(variants, port: bool = True):
    """Yield one row (a dict, as printed) per variant: cv2's reads of its
    bytes (``imdecode``) and of a file of them (``imread``) in each of its
    modes, and with ``port`` whether the port's reads equal them; the
    count of differing port reads is in each row's ``differ``."""
    import cv2

    from diffdope_tpu_torch import png

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "variant"
        for name, (data, modes) in variants.items():
            buf = np.frombuffer(data, np.uint8)
            path.write_bytes(data)
            row = {"variant": name, "bytes": len(data), "cv2": cv2.__version__, "differ": 0}
            for mode in modes:
                flag = cv2.IMREAD_UNCHANGED if mode == "unchanged" else cv2.IMREAD_COLOR
                want = {"decode": summary(cv2.imdecode(buf, flag)),
                        "read": summary(cv2.imread(str(path), flag))}
                row[mode] = want["decode"]
                if want["read"] != want["decode"]:
                    row[f"{mode}_imread"] = want["read"]
                if not port:
                    continue
                for how, arg in (("decode", data), ("read", path)):
                    fn = getattr(png, f"decode_{mode}" if how == "decode" else f"imread_{mode}")
                    try:
                        got = fn(arg)
                        if mode == "color" and got is not None:
                            got = np.ascontiguousarray(got[..., ::-1])
                        same = summary(got) == want[how]
                    except ValueError as err:
                        same = f"raised: {err}"
                    row[f"{mode}_{how}_port_equal"] = same
                    row["differ"] += same is not True
            yield row


def main(argv):
    import cv2

    cv2_only = "--cv2-only" in argv
    keys = [a for a in argv if not a.startswith("--")]
    variants = {**image_variants(), **webp_variants()}
    if cv2_only:
        variants.update(cv2_oddities())
    variants = {k: v for k, v in variants.items() if not keys or any(s in k for s in keys)}
    differ = 0
    for row in compare(variants, port=not cv2_only):
        differ += row.pop("differ")
        print(json.dumps(row), flush=True)
    print(json.dumps({"variants": len(variants), "cv2": cv2.__version__,
                      "port_differs": None if cv2_only else differ}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
