"""Build, load and count the hand-written Hopper kernels.

The CUDA sources in ``diffdope_tpu_torch/csrc`` have a plain C interface.
They are compiled with ``nvcc`` into one shared library at first use and
bound with ctypes; nothing here runs at import time, so the CPU tests can
import every module on a machine without ``nvcc`` or a card.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o build/libdiffdope_kernels_<hash>.so csrc/*.cu

``-fmad=false`` (and no ``--use_fast_math``) is part of the numeric
contract: coverage, z and pixel NDC keep the reference's f32 operation
order, without FMA contraction.  The library name carries a hash of the
sources and flags, so an edited source rebuilds.  The build directory is
``build/`` beside the package, or ``$DD_TORCH_BUILD_DIR``.

``launches`` counts kernel launches per wrapper (a plain int each): a
wrapper adds one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("raster.cu", "fused_loss.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

launches = {"raster_fwd": 0, "raster_bwd": 0, "loss_fwd": 0, "loss_bwd": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # (bins, counts, off_c, used, B, tot, k_chunk, nty, ntx, th, tw,
    #  oy, ox, fh, fw, ids, win, rows, stream)
    "dd_raster_fwd": [_P] * 4 + [_I] * 11 + [_P] * 4,
    # (d_rows, win, B, tot, nty, ntx, th, tw, d_bins, stream)
    "dd_raster_bwd": [_P] * 2 + [_I] * 6 + [_P] * 2,
    # (rows, ids, gt6, B, hc, wc, oy, ox, fh, fw, partials, sums, stream)
    "dd_loss_fwd": [_P] * 3 + [_I] * 7 + [_P] * 3,
    # (rows, ids, gt6, d_sums, B, hc, wc, oy, ox, fh, fw, g, d_rows, stream)
    "dd_loss_bwd": [_P] * 4 + [_I] * 7 + [_P] * 3,
}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    for extra in sorted(CSRC.glob("*.cuh")):
        h.update(extra.read_bytes())
    return build_dir() / f"libdiffdope_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels (once per source hash) and return the .so path."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, counter: str, *args) -> None:
    """Call C entry point ``name`` on the current CUDA stream; raise on a
    nonzero ``cudaGetLastError`` and count the launch under ``counter``."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    launches[counter] += 1
