"""Read times of the port's WebP decoder on this host's CPU: the corpus
(``testing.webp_variants``) held to cv2 from bytes and from files in
both modes, as ``chip_smoke.py`` phase 23 sweeps it, and 1920x1080
frames written by this host's cv2, each read in colour best of three:

- ``flat``: black with a disc of the checker texture (a frame like phase
  16's render, mostly background), lossless, quality 50 and 90;
- ``dense``: sharp shapes under smooth noise over the whole frame,
  quality 90 (the tokens' worst case here).

One JSON line each.

    python tools/port_webp_read_times.py
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def frames():
    from scipy.ndimage import gaussian_filter

    from make_standins import make_texture
    from port_webp_corpus import render

    tex = np.round(make_texture("checker") * 255).astype(np.uint8)
    flat = np.zeros((1080, 1920, 3), np.uint8)
    y, x = np.mgrid[0:1080, 0:1920]
    disc = (x - 700) ** 2 + (y - 900) ** 2 < 100 ** 2
    flat[disc] = tex[(y[disc] * 3) % 1024, (x[disc] * 3) % 1024]
    noise = gaussian_filter(np.random.default_rng(0).integers(0, 256, (1080, 1920))
                            .astype(np.float64), 3)
    dense = np.clip(render(1920, 1080).astype(np.float64) + (noise - 128)[..., None] * 0.8,
                    0, 255).astype(np.uint8)
    return {"flat": (flat, (101, 50, 90)), "dense": (dense, (90,))}


def main():
    import cv2

    from diffdope_tpu_torch import png
    from diffdope_tpu_torch.testing import webp_variants
    from port_cv2_formats import compare

    t0 = time.perf_counter()
    variants = webp_variants()
    differ = sum(row["differ"] for row in compare(variants))
    print(json.dumps({"corpus": len(variants), "differ": differ,
                      "seconds": time.perf_counter() - t0, "cv2": cv2.__version__}),
          flush=True)
    for name, (rgb, qualities) in frames().items():
        for quality in qualities:
            ok, data = cv2.imencode(".webp", np.ascontiguousarray(rgb[..., ::-1]),
                                    [cv2.IMWRITE_WEBP_QUALITY, quality])
            data = data.tobytes()
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                got = png.decode_color(data)
                best = min(best, time.perf_counter() - t0)
            want = cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                                cv2.COLOR_BGR2RGB)
            print(json.dumps({"frame": name, "quality": quality, "bytes": len(data),
                              "kind": data[12:16].decode(), "seconds": best,
                              "equal": bool(np.array_equal(got, want))}), flush=True)


if __name__ == "__main__":
    main()
