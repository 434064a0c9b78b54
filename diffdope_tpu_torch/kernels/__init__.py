"""Build, load and count the hand-written Hopper kernels.

The CUDA sources in ``diffdope_tpu_torch/csrc`` have a plain C interface.
Each is compiled with ``nvcc`` into a shared library of its own at first
use, all sources at once in parallel, and bound with ctypes; nothing here
runs at import time, so the CPU tests can import every module on a machine
without ``nvcc`` or a card.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/<source>_<hash>.so csrc/<source>.cu

``-fmad=false`` (and no ``--use_fast_math``) is part of the numeric
contract: coverage, z, pixel NDC and the packed table keep the reference's
f32 operation order, without FMA contraction.  Each library name carries a
hash of its source and the flags, so an edited source rebuilds.  The build
directory is ``build/`` beside the package, or ``$DD_TORCH_BUILD_DIR``.

``launches`` counts kernel launches per wrapper (a plain int each): a
wrapper adds one where it launches its kernel and nowhere else.  While a
CUDA graph is captured (:func:`recording`) a launch only records itself,
as the capture runs no kernel; each replay of the graph then adds what
was recorded (:func:`add_launches`, ``optimize.CapturedRefine``), so the counts
are the launches the card ran.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterator, List, Optional

from diffdope_tpu_torch import trace

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("pack.cu", "raster.cu", "fused_loss.cu", "rasterize.cu", "raster_v3.cu", "trace.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

#: launches per wrapper: the fused loss counts its depth- and colour-lane
#: launches apart, K6 and K4 their bf16 d_rows lane ('_bf16'); 'pack_plain'
#: counts the bin-ordered tables that the reference's eligibility rule
#: sends to the plain pack (traced attributes); 'setup_rows_bwd' the
#: segmented sum of rasterize's setup-row gather, 'index_rows_bwd' the same
#: kernel under the port's other gathers (``rasterize.IndexRows``: the
#: shaded rows, the texels, the clip positions' corners, the colours) and
#: under the ``DD_BINNED=0`` route's bins (``rasterize.slot_sums``, once a
#: backward for every hypothesis)
launches = {"pack_fwd": 0, "pack_bwd": 0, "pack_plain": 0, "raster_fwd": 0,
            "raster_bwd": 0, "raster_bwd_bf16": 0, "raster_uniform_fwd": 0,
            "raster_uniform_bwd": 0, "loss_fwd": 0, "loss_bwd": 0, "loss_bwd_bf16": 0,
            "loss_fwd_depth": 0, "loss_bwd_depth": 0, "loss_fwd_color": 0,
            "loss_bwd_color": 0, "loss_fwd_color_depth": 0, "loss_bwd_color_depth": 0,
            "raster_ids": 0, "gather_rows_fwd": 0, "gather_rows_bwd": 0,
            "raster_v3_fwd": 0, "raster_v3_bwd": 0, "setup_rows_bwd": 0,
            "index_rows_bwd": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # (mvpm, tab, sil, B, n, n_ch, out, stream)
    "dd_pack_fwd": [_P] * 3 + [_I] * 3 + [_P] * 2,
    # (mvpm, tab, g, order, B, n, n_ch, partial, out, stream)
    "dd_pack_bwd": [_P] * 4 + [_I] * 3 + [_P] * 3,
    # (bins, counts, off_c, used, B, tot, k_chunk, nty, ntx, th, tw,
    #  oy, ox, fh, fw, ids, win, rows, stream)
    "dd_raster_fwd": [_P] * 4 + [_I] * 11 + [_P] * 4,
    # (d_rows, win, off_c, used, B, tot, k_chunk, nty, ntx, th, tw, d_bins,
    #  stream); the same for bf16 d_rows
    "dd_raster_bwd": [_P] * 4 + [_I] * 7 + [_P] * 2,
    "dd_raster_bwd_bf16": [_P] * 4 + [_I] * 7 + [_P] * 2,
    # (bins, counts, B, k, nty, ntx, th, tw, fh, fw, ids, win, rows, stream)
    "dd_raster_uniform_fwd": [_P] * 2 + [_I] * 8 + [_P] * 4,
    # (d_rows, win, B, k, nty, ntx, th, tw, d_bins, stream)
    "dd_raster_uniform_bwd": [_P] * 2 + [_I] * 6 + [_P] * 2,
    # (rows, ids, gt6, dplane | null, colors | null, B, hc, wc, oy, ox, fh,
    #  fw, partials, sums, stream)
    "dd_loss_fwd": [_P] * 5 + [_I] * 7 + [_P] * 3,
    # (rows, ids, gt6, dplane | null, colors | null, d_sums, B, hc, wc, oy, ox,
    #  fh, fw, g (unused: null), d_rows, d_dplane | null, d_colors | null,
    #  stream)
    "dd_loss_bwd": [_P] * 6 + [_I] * 7 + [_P] * 5,
    # (rows, ids, gt6, d_sums, B, hc, wc, oy, ox, fh, fw, g (unused: null),
    #  d_rows bf16, stream)
    "dd_loss_bwd_bf16": [_P] * 4 + [_I] * 7 + [_P] * 3,
    # (coef, tile_idx, counts, B, T, K, nty, ntx, th, tw, fh, fw, ids,
    #  boxes (scratch), stream)
    "dd_raster_ids": [_P] * 3 + [_I] * 9 + [_P] * 3,
    # (packed, tile_idx, counts, B, T, K, nty, ntx, th, tw, fh, fw, ids, win,
    #  rows, boxes (scratch), stream)
    "dd_gather_rows_fwd": [_P] * 3 + [_I] * 9 + [_P] * 5,
    # (d_rows, win, counts, B, K, nty, ntx, th, tw, d_bin, stream)
    "dd_gather_rows_bwd": [_P] * 3 + [_I] * 6 + [_P] * 2,
    # (packed_s, clo, chi, rlo_tc, rhi_tc, B, tp, nty, ntx, th, tw, fh, fw,
    #  ids, win, rows, boxes (scratch), stream)
    "dd_raster_v3_fwd": [_P] * 5 + [_I] * 8 + [_P] * 5,
    # (d_rows, win, clo, chi, rlo_tc, rhi_tc, B, tp, nty, ntx, th, tw,
    #  d_packed_s, stream)
    "dd_raster_v3_bwd": [_P] * 6 + [_I] * 6 + [_P] * 2,
    # (src, order, start, n_hyp, nseg, width, hyp_stride, row_stride,
    #  lane_stride, out, stream)
    "dd_segment_sum": [_P] * 3 + [_I] * 3 + [_L] * 3 + [_P] * 2,
    # (stamps, row, delta, point, points, rows, stream): trace.stamp, counted
    # nowhere
    "dd_stamp": [_P] * 2 + [_I] * 4 + [_P],
}

_fns: Optional[Dict[str, object]] = None
#: the launches recorded by the capture under way (:func:`recording`), or
#: None; a plain global, as the autograd engine's thread launches the
#: backward's kernels
_recorded: Optional[Dict[str, int]] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def count(counter: str) -> None:
    """Add one to ``counter``, or record it while a graph is captured."""
    if _recorded is None:
        launches[counter] += 1
    else:
        _recorded[counter] = _recorded.get(counter, 0) + 1


@contextlib.contextmanager
def recording() -> Iterator[Dict[str, int]]:
    """Inside, every :func:`count` is recorded in the dict this yields
    instead of counted: the launches of a CUDA graph being captured."""
    global _recorded
    outer, _recorded = _recorded, {}
    try:
        yield _recorded
    finally:
        _recorded = outer


def add_launches(recorded: Dict[str, int], times: int = 1) -> None:
    """Count ``times`` replays of a graph whose capture recorded ``recorded``."""
    for k, n in recorded.items():
        launches[k] += n * times


def build_dir() -> Path:
    return Path(os.environ.get("DD_TORCH_BUILD_DIR", str(_PKG.parent / "build")))


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(source: str) -> Path:
    """Where the library of one source goes: its name carries a hash of the
    source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / source).read_bytes())
    for extra in sorted(CSRC.glob("*.cuh")):
        h.update(extra.read_bytes())
    return build_dir() / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build() -> List[Path]:
    """Compile every source not yet built (one nvcc each, all started
    together) and return the libraries' paths, in ``SOURCES`` order."""
    outs = [library_path(s) for s in SOURCES]
    jobs = []
    for source, out in zip(SOURCES, outs):
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, proc, tmp, out))
    failed = []
    for cmd, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def library() -> Dict[str, object]:
    """The C entry points of the loaded kernel libraries by name (built on
    first use)."""
    global _fns
    if _fns is None:
        fns = {}
        with trace.span("kernels.load"):
            for path in build():
                lib = ctypes.CDLL(str(path))
                for name, argtypes in _SIGNATURES.items():
                    if hasattr(lib, name):
                        fn = getattr(lib, name)
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                        fns[name] = fn
        missing = set(_SIGNATURES) - set(fns)
        if missing:
            raise RuntimeError(f"kernel entry points not found: {sorted(missing)}")
        _fns = fns
    return _fns


def launch(name: str, counter: str, *args) -> None:
    """Call C entry point ``name`` on the current CUDA stream; raise on a
    nonzero ``cudaGetLastError`` and count the launch under ``counter``."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = library()[name](*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    count(counter)
