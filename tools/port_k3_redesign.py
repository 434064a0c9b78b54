"""The K3/K7 raster forward of several trees of the repo, side by side on
the card: per tree, the instructions of the kernel's loops (SASS) and its
time at the bench shapes, with every tree's outputs held to the first's.

    python tools/port_k3_redesign.py ROOT [ROOT ...] [--sass-dir DIR]

Each ROOT is a checkout of the repo (this one, or the parent unpacked with
``git archive`` into the gitignored ``chip_proof/``).  Its
``diffdope_tpu_torch/csrc/raster.cu`` is built with the port's nvcc flags
into a library of its own; ``cuobjdump -sass`` of it gives, for each
instantiation of ``raster_fwd_kernel`` (CompactRange: K3, UniformRange:
K7), every loop (a backward branch) with its instruction count and the
count of each opcode class (shared loads, FP32, integer, branches ...);
with ``--sass-dir`` the whole SASS goes there too.  Then the bench
problem of this checkout (``bench_problem()``: B=64, 400x400,
icosphere(5), 64 distinct poses; compact table and its 272x272 crop for
K3, the uniform-K table over the full frame for K7) runs through each
tree's ``dd_raster_fwd`` and ``dd_raster_uniform_fwd`` (the C interface is
the same in every tree), 20 launches after a warm-up, timed by CUDA
events, in turns A B ... B A, twice.  Prints one JSON line per tree and
kernel, with the card's name and power limit.
"""

import argparse
import collections
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))


def build(root: Path, out_dir: Path, tag: str):
    """(library, {kernel: ptxas' registers / spill line}) of ROOT's
    raster.cu, built with the port's flags and -Xptxas=-v."""
    from diffdope_tpu_torch import kernels

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"raster_{tag}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas=-v", "-o", str(lib),
           str(root / "diffdope_tpu_torch/csrc/raster.cu")]
    log = subprocess.run(cmd, check=True, capture_output=True, text=True).stderr
    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and "raster_fwd_kernel" in name and ("Used" in line or "spill" in line):
            kind = "K3" if "CompactRange" in name else "K7"
            usage[kind] = (usage.get(kind, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return lib, usage


def _cuobjdump() -> str:
    from diffdope_tpu_torch import kernels

    return str(Path(kernels._nvcc()).with_name("cuobjdump"))


#: opcode classes, by the SASS mnemonic's first word
CLASSES = {
    "shared loads": ("LDS",), "global loads": ("LDG",), "stores": ("STG", "STS"),
    "FP32": ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FRND", "MUFU", "FCHK"),
    "integer": ("IADD3", "IMAD", "LOP3", "ISETP", "SHF", "LEA", "SEL", "IMNMX", "PRMT",
                "IABS", "I2F", "F2I", "MOV", "S2R", "SHL", "SHR"),
    "branches": ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "BAR", "WARPSYNC"),
}


def sass_loops(lib: Path, sass_dir=None):
    """{kernel instantiation: [loop, ...]}, each loop a dict of its
    instruction count and its opcode classes, innermost (fewest
    instructions) first."""
    text = subprocess.run([_cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    if sass_dir:
        Path(sass_dir).mkdir(parents=True, exist_ok=True)
        (Path(sass_dir) / f"{lib.stem}.sass").write_text(text)
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "raster_fwd_kernel" not in name:
            continue
        kind = "K3" if "CompactRange" in name else "K7"
        inst = []  # (address, opcode, branch target)
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);",
                             part):
            target = re.search(r"0x([0-9a-f]+)", m.group(4)) if m.group(3).startswith(
                "BRA") else None
            inst.append((int(m.group(1), 16), m.group(3),
                         int(target.group(1), 16) if target else None))
        loops = []
        for addr, op, target in inst:
            if target is not None and target < addr:
                body = [o for a, o, _ in inst if target <= a <= addr]
                count = collections.Counter(
                    next((c for c, ops in CLASSES.items() if o.split(".")[0] in ops),
                         "other") for o in body)
                loops.append(dict(start=hex(target), end=hex(addr),
                                  instructions=len(body), classes=dict(count)))
        out[kind] = sorted(loops, key=lambda lp: lp["instructions"])
    return out


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--sass-dir")
    args = parser.parse_args()
    import torch

    from diffdope_tpu_torch.bench import bench_problem, card, distinct_poses
    from diffdope_tpu_torch.optimize import pose_matrix
    from diffdope_tpu_torch.render.pipeline import K_CHUNK, TILE_HW

    if not torch.cuda.is_available():
        print("no CUDA device: this measures the card only", file=sys.stderr)
        return 2
    gpu = card()
    roots = [Path(r).resolve() for r in args.roots]
    built = [build(r, HERE / "build" / "k3_redesign", str(i)) for i, r in enumerate(roots)]
    libs = [lib for lib, _ in built]
    sass = [sass_loops(lib, args.sass_dir) for lib in libs]

    problem = bench_problem(device="cuda")
    mtx, _, _ = pose_matrix(distinct_poses(problem["params0"], 1e-3))
    uniform = bench_problem(device="cuda", uniform=True)
    with torch.no_grad():
        tab = problem["fn"].table(mtx)
        utab = uniform["fn"].table(mtx)
    b = mtx.shape[0]
    (th, tw), (hc, wc), (oy, ox, fh, fw) = TILE_HW, problem["fn"].frame_hw, problem["fn"].roi
    nty, ntx = hc // th, wc // tw
    uh, uw = -(-fh // th) * th, -(-fw // tw) * tw
    unt = (uh // th) * (uw // tw)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def outputs(h, w):
        return (torch.empty((b, h, w), dtype=torch.int32, device="cuda"),
                torch.empty((b, h, w), dtype=torch.int32, device="cuda"),
                torch.empty((b, 32, h, w), dtype=torch.float32, device="cuda"))

    calls = []
    for lib_path in libs:
        lib = ctypes.CDLL(str(lib_path))
        f3, f7 = lib.dd_raster_fwd, lib.dd_raster_uniform_fwd
        f3.argtypes = [P] * 4 + [I] * 11 + [P] * 4
        f7.argtypes = [P] * 2 + [I] * 8 + [P] * 4
        o3, o7 = outputs(hc, wc), outputs(uh, uw)

        def k3(f3=f3, o3=o3):
            err = f3(tab.packed.data_ptr(), tab.counts.data_ptr(), tab.off_c.data_ptr(),
                     tab.used.data_ptr(), b, tab.packed.shape[2], K_CHUNK, nty, ntx, th,
                     tw, oy, ox, fh, fw, *(o.data_ptr() for o in o3), stream)
            assert err == 0, err
            return o3

        def k7(f7=f7, o7=o7):
            err = f7(utab.packed.data_ptr(), utab.counts.data_ptr(), b,
                     utab.packed.shape[2] // unt, uh // th, uw // tw, th, tw, fh, fw,
                     *(o.data_ptr() for o in o7), stream)
            assert err == 0, err
            return o7

        calls.append({"K3": k3, "K7": k7})

    def time_ms(f, reps=20):
        f()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            f()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    order = list(range(len(roots)))
    turns = order + order[::-1]
    for kind in ("K3", "K7"):
        first = [o.clone() for o in calls[0][kind]()]
        same = [all(torch.equal(a, c) for a, c in zip(first, calls[i][kind]()))
                for i in order]
        ms = {i: [] for i in order}
        for _ in range(2):
            for i in turns:
                ms[i].append(time_ms(calls[i][kind]))
        for i in order:
            print(json.dumps({"tree": str(roots[i]), "kernel": kind, "card": gpu,
                              "ms": ms[i], "equal_to_first_tree": same[i],
                              "fg_pixels": int((first[0] > 0).sum()),
                              "ptxas": built[i][1].get(kind),
                              "loops": sass[i].get(kind, [])[:4]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
