"""Hand kernels of several trees of the repo, side by side on the card: per
tree, ptxas' registers and spills and the SASS loops of each kernel, and
its time at the bench shapes, with every tree's outputs held to the first
tree's.

    python tools/port_kernel_ab.py ROOT [ROOT ...]
        [--kernels K2,K5,K3,K4,K6,K10,K8,K9,K9bwd] [--sass-dir DIR] [--out FILE]
        [--reps N]

Each ROOT is a checkout of the repo (this one, or the parent unpacked with
``git archive`` into the gitignored ``chip_proof/``), or any directory
that holds ``diffdope_tpu_torch/csrc/`` (a variant of a kernel).  For each kernel
asked for, ROOT's source (``pack.cu`` for K2, ``fused_loss.cu`` for K5 and
K6, ``raster.cu`` for K3/K7's forward and K4/K7's backward, ``raster_v3.cu``
and ``raster.cu`` for K10, ``rasterize.cu`` for K8 and K9) is
built with the port's nvcc flags and
``-Xptxas=-v`` into a library of its own.
``cuobjdump -sass`` of it gives, for each of the kernel's functions, every
loop (a backward branch) with its instruction count and the count of each
opcode class; with ``--sass-dir`` the whole SASS goes there too.  Each
tree's entry point runs on the same inputs, made in this checkout at the
bench shapes (``bench_problem()``: B=64, 400x400, icosphere(5), 64
distinct poses):

- K2 (``dd_pack_bwd``) on the compact table, the uniform-K table and the
  textured problem's uv table (n_ch 2), under a seeded normal cotangent
  (a tree whose K2 takes its places' order gets this checkout's);
  printed with the table's slots whose degenerate flag is clear, and the
  32-slot groups that are all degenerate;
- K5 (``dd_loss_fwd``) in its four lanes: rgb + mask on the compact crop,
  with depth, the colour lane on the textured problem's full frame, and
  the colour lane with depth;
- K3 and K7's forward (``dd_raster_fwd``, ``dd_raster_uniform_fwd``) on
  the compact and the uniform-K table;
- K6 (``dd_loss_bwd``, ``dd_loss_bwd_bf16``) in its five lanes, K5's four
  and the rgb + mask lane's bf16 d_rows, under a seeded cotangent of the
  sums;
- K4 (``dd_raster_bwd`` and its bf16 lane) on the compact table and K7's
  backward (``dd_raster_uniform_bwd``) on the uniform-K table, under K6's
  d_rows of the same raster; a tree whose K4 takes no held chunks
  (``off_c``, ``used``) writes only the won slots, so its call zero-fills
  d_bins first, as its wrapper did;
- K10 (``dd_raster_v3_fwd``, ``dd_raster_v3_bwd``) on the sorted table of
  the bench problem's 'v3' variant at the same poses and of
  ``chip_smoke.py``'s phase 11 at its last poses (the default
  configuration run under ``DD_RASTER=v3``: 960x540, B=8, the stand-in),
  the backward under K6's d_rows of this tree's forward; printed with the
  gated (tile, chunk) pairs, the slots they walk and the exact bins';
- K8 (``dd_raster_ids``) and K9's forward (``dd_gather_rows_fwd``) at tile
  (32, 128) on the bench scene's setup (or packed) rows and bins at its
  64 poses, and at ``chip_smoke.py``'s phase 9 and 13 inputs (960x540,
  B=8 distinct poses around the default configuration's init, the
  stand-in); printed with the held bin entries, the tests inside the
  boxes and the TPU kernel's all-pairs tests;
- K9's backward (``dd_gather_rows_bwd``) on the same problems' bins, under
  one seeded normal d_rows and the winner map of this checkout's K9
  forward; printed with the held and the table's slots and the empty
  tiles.

K3/K7's, K8's and K9's forward outputs are also held to their plain twins:
each tree's row counts the (hypothesis, pixel) pairs at which any output
differs from the twin's (``pixels_off_the_plain_twin``); K9's backward is
held to its twin at ``check_gather_rows``' tolerance
(``agrees_with_plain_twin``).

Each case is timed by CUDA events over ``--reps`` launches after a warm-up,
in turns A B ... B A, twice.  K2's sums are held to the first tree's at
rtol 2e-4, atol 1e-6 plus 1e-6 of the hypothesis' sum of |terms|, K5's at
rtol 1e-5, atol 1e-7, K3/K7's outputs exactly, K4's, K6's, K7's and K9's
backward and K10's bit for bit (every output starts as NaN, so an unwritten value
shows), and each tree's output is said to equal the first's bit for bit or
not; each tree's output is also compared with its own second launch, bit
for bit.  Prints one JSON line per tree and case, with the card's name and
power limit; with ``--out`` the same lines, with each tree's ptxas lines
and SASS loops, go to FILE.
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

#: per kernel: its sources and the substrings naming its device functions
#: (K10's forward lives in raster_v3.cu or, as K3's body over the sorted
#: table, in raster.cu: both are built and the entry point is looked up in
#: either)
SOURCES = {"K8": (("rasterize.cu",), ("raster_ids_kernel", "row_boxes")),
           "K9": (("rasterize.cu",), ("raster_ids_kernel", "row_boxes")),
           "K9bwd": (("rasterize.cu",), ("gather_rows_bwd",)),
           "K2": (("pack.cu",), ("pack_bwd",)),
           "K5": (("fused_loss.cu",), ("loss_fwd", "loss_reduce")),
           "K3": (("raster.cu",), ("raster_fwd_kernel",)),
           "K4": (("raster.cu",), ("raster_bwd_kernel",)),
           "K6": (("fused_loss.cu",), ("loss_bwd",)),
           "K10": (("raster_v3.cu", "raster.cu"), ("raster_v3", "SortedRange"))}
#: opcode classes, by the SASS mnemonic's first word
CLASSES = {
    "shared loads": ("LDS",), "global loads": ("LDG",), "stores": ("STG", "STS"),
    "FP32": ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FRND", "MUFU", "FCHK"),
    "integer": ("IADD3", "IMAD", "LOP3", "ISETP", "SHF", "LEA", "SEL", "IMNMX", "PRMT",
                "IABS", "I2F", "F2I", "MOV", "S2R", "SHL", "SHR"),
    "shuffles": ("SHFL",),
    "branches": ("BRA", "BSSY", "BSYNC", "EXIT", "CALL", "RET", "BAR", "WARPSYNC",
                 "VOTE"),
}


def build(root: Path, kernel: str, out_dir: Path, tag: str):
    """([library, ...], {function: ptxas' registers / spill lines}) of
    ROOT's sources of ``kernel``, built with the port's flags and
    -Xptxas=-v."""
    from diffdope_tpu_torch import kernels

    sources, names = SOURCES[kernel]
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, usage = [], {}
    for source in sources:
        lib = out_dir / f"{Path(source).stem}_{tag}.so"
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas=-v", "-o", str(lib),
               str(root / "diffdope_tpu_torch/csrc" / source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {root}:\n{proc.stdout}{proc.stderr}")
        name = None
        for line in proc.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
            elif name and any(k in name for k in names) and ("Used" in line
                                                              or "spill" in line):
                usage[name] = (usage.get(name, "") + " "
                               + line.split(":", 1)[-1].strip()).strip()
        libs.append(lib)
    return libs, usage


def sass_loops(lib: Path, names, sass_dir=None):
    """{function: [loop, ...]} for the functions whose name holds one of
    ``names``, each loop a dict of its instruction count and its opcode
    classes, innermost (fewest instructions) first."""
    from diffdope_tpu_torch import kernels

    cuobjdump = str(Path(kernels._nvcc()).with_name("cuobjdump"))
    text = subprocess.run([cuobjdump, "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    if sass_dir:
        Path(sass_dir).mkdir(parents=True, exist_ok=True)
        (Path(sass_dir) / f"{lib.stem}.sass").write_text(text)
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if not any(k in name for k in names):
            continue
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
        out[name] = dict(instructions=len(inst),
                         loops=sorted(loops, key=lambda lp: lp["instructions"])[:4])
    return out


def time_ms(f, reps: int) -> float:
    import torch

    f()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        f()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


P, I = ctypes.c_void_p, ctypes.c_int


def k2_cases(problems, mtx):
    """{case: (make_call(lib) -> call() -> output, compare(a, b), info)} for
    K2 on each problem's table."""
    import torch

    from diffdope_tpu_torch.kernels.check import _pack_term_scale, _close, pack_inputs

    cases = {}
    for case, fn in problems.items():
        bn, mvpm, tab, _, n_ch, order = pack_inputs(fn, mtx)
        b, n = mvpm.shape[0], tab.shape[1]
        gen = torch.Generator(device="cuda").manual_seed(0)
        g = torch.randn((b, 32, n), generator=gen, device="cuda")
        scale = _pack_term_scale(fn, bn, mtx, g)
        live = tab[-1] <= 0.5
        groups = torch.nn.functional.pad(live, (0, -n % 32)).reshape(-1, 32)
        # scratch for chunks as small as 32 slots: every tree's fits
        partial = torch.empty(b * -(-n // 32) * 19, device="cuda")

        def make(lib, mvpm=mvpm, tab=tab, g=g, n_ch=n_ch, b=b, n=n, partial=partial,
                 order=order):
            f = lib.dd_pack_bwd
            # 10 parameters: the sums at K2's places (order); 9: by position
            by_place = _params(lib.root, "dd_pack_bwd", ("pack.cu",)) == 10
            f.argtypes = [P] * (4 if by_place else 3) + [I] * 3 + [P] * 3
            lists = (None if order is None else order.data_ptr(),) if by_place else ()
            out = torch.empty((b, 19), device="cuda")

            def call():
                err = f(mvpm.data_ptr(), tab.data_ptr(), g.data_ptr(), *lists, b, n, n_ch,
                        partial.data_ptr(), out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return (out,)
            return call

        cases[f"K2 {case}"] = (
            make, lambda a, c, scale=scale: _close(c[0], a[0], 2e-4, 1e-6, scale),
            dict(slots=n, live_slots=int(live.sum()),
                 all_degenerate_groups=int((~groups.any(dim=1)).sum()),
                 groups=groups.shape[0]))
    return cases


def k5_cases(problems, mtx):
    """K5's four lanes on the rows and ids of each problem's raster."""
    import torch

    from diffdope_tpu_torch.kernels.check import _binned_spec, _close

    cases = {}
    for case, fn in problems.items():
        b = mtx.shape[0]
        hc, wc = fn.frame_hw
        with torch.no_grad():
            ids, rows, _ = _binned_spec(fn, mtx, b * hc * wc).fwd()
            dplane = fn.dplane(mtx)
            colors = fn.sample(rows, ids) if getattr(fn, "sample", None) else None
        oy, ox, fh, fw = fn.roi
        # scratch for blocks as small as 64 pixels: every tree's fits
        partials = torch.empty(b * (-(-hc // 8) * -(-wc // 8)) * 3, device="cuda")

        def make(lib, rows=rows, ids=ids, gt6=fn.gt6, dplane=dplane, colors=colors,
                 b=b, hc=hc, wc=wc, roi=(oy, ox, fh, fw), partials=partials):
            f = lib.dd_loss_fwd
            f.argtypes = [P] * 5 + [I] * 7 + [P] * 3
            sums = torch.empty((b, 3), device="cuda")

            def call():
                err = f(rows.data_ptr(), ids.data_ptr(), gt6.data_ptr(),
                        None if dplane is None else dplane.data_ptr(),
                        None if colors is None else colors.data_ptr(), b, hc, wc, *roi,
                        partials.data_ptr(), sums.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return (sums,)
            return call

        fg = ids > 0
        cases[f"K5 {case}"] = (make, lambda a, c: _close(c[0], a[0], 1e-5, 1e-7),
                               dict(frame=[hc, wc], fg_pixels=int(fg.sum()),
                                    silhouette_pairs=int(
                                        (fg[:, :, 1:] != fg[:, :, :-1]).sum()
                                        + (fg[:, 1:] != fg[:, :-1]).sum())))
    return cases


def k3_cases(problems, mtx):
    """K3 on the compact table and K7's forward on the uniform-K table."""
    import torch

    from diffdope_tpu_torch.render.pipeline import K_CHUNK, TILE_HW

    cases = {}
    b = mtx.shape[0]
    (th, tw) = TILE_HW
    for case, fn in problems.items():
        with torch.no_grad():
            tab = fn.table(mtx)
        (hc, wc), (oy, ox, fh, fw) = fn.frame_hw, fn.roi
        uniform = tab.off_c is None
        h, w = (-(-fh // th) * th, -(-fw // tw) * tw) if uniform else (hc, wc)
        nty, ntx = h // th, w // tw

        def make(lib, tab=tab, uniform=uniform, h=h, w=w, nty=nty, ntx=ntx,
                 roi=(oy, ox, fh, fw)):
            outs = (torch.empty((b, h, w), dtype=torch.int32, device="cuda"),
                    torch.empty((b, h, w), dtype=torch.int32, device="cuda"),
                    torch.empty((b, 32, h, w), device="cuda"))
            if uniform:
                f = lib.dd_raster_uniform_fwd
                f.argtypes = [P] * 2 + [I] * 8 + [P] * 4
                args = (tab.packed.data_ptr(), tab.counts.data_ptr(), b,
                        tab.packed.shape[2] // (nty * ntx), nty, ntx, th, tw, *roi[2:])
            else:
                f = lib.dd_raster_fwd
                f.argtypes = [P] * 4 + [I] * 11 + [P] * 4
                args = (tab.packed.data_ptr(), tab.counts.data_ptr(),
                        tab.off_c.data_ptr(), tab.used.data_ptr(), b,
                        tab.packed.shape[2], K_CHUNK, nty, ntx, th, tw, *roi)

            def call():
                err = f(*args, *(o.data_ptr() for o in outs),
                        torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return outs
            return call

        def twin(tab=tab, uniform=uniform, fn=fn, roi=(oy, ox, fh, fw)):
            from diffdope_tpu_torch.render.raster import (
                raster_fwd_plain,
                raster_uniform_fwd_plain,
            )

            with torch.no_grad():
                ids, rows, win = (
                    raster_uniform_fwd_plain(tab.packed, tab.counts, roi[2:], TILE_HW)
                    if uniform else
                    raster_fwd_plain(tab.packed, tab.counts, tab.off_c, tab.used, K_CHUNK,
                                     fn.frame_hw, TILE_HW, roi))
            return ids, win, rows

        cases[("K7 " if uniform else "K3 ") + case] = (
            make, lambda a, c: all(torch.equal(x, y) for x, y in zip(a, c)),
            dict(slots=tab.packed.shape[2]), twin)
    return cases


def _bits(x):
    import torch

    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(torch.int32)


def _diffs(a, c):
    """Per output that differs in its bits: how many values, the first
    one's index and both values."""
    import torch

    out = []
    for k, (x, y) in enumerate(zip(a, c)):
        bad = _bits(x) != _bits(y)
        if bool(bad.any()):
            i = tuple(int(v) for v in bad.nonzero()[0])
            out.append(dict(output=k, n=int(bad.sum()), at=i, first=float(x[i]),
                            this=float(y[i]), nan_first=int(torch.isnan(x.float()).sum()),
                            nan_this=int(torch.isnan(y.float()).sum())))
    return out


def _bit_equal(a, c) -> bool:
    import torch

    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, c))


def k6_inputs(fn, mtx):
    """(rows, ids, dplane, colors, d_sums) of a fused loss' raster at poses
    ``mtx``, the cotangent of its sums drawn from a seeded uniform [0.5, 2)."""
    import torch

    from diffdope_tpu_torch.kernels.check import _binned_spec

    b = mtx.shape[0]
    hc, wc = fn.frame_hw
    with torch.no_grad():
        ids, rows, win = _binned_spec(fn, mtx, b * hc * wc).fwd()
        dplane = fn.dplane(mtx)
        colors = fn.sample(rows, ids) if getattr(fn, "sample", None) else None
    gen = torch.Generator(device="cuda").manual_seed(1)
    d_sums = 0.5 + 1.5 * torch.rand((b, 3), generator=gen, device="cuda")
    return rows, ids, win, dplane, colors, d_sums


def k6_cases(problems, mtx):
    """K6 in its five lanes: rgb + mask on the compact crop in f32 and bf16,
    with depth, the colour lane on the textured problem's full frame, and
    the colour lane with depth.  Outputs are held bit for bit."""
    import torch

    cases = {}
    for case, fn in problems.items():
        rows, ids, _, dplane, colors, d_sums = k6_inputs(fn, mtx)
        b, _, hc, wc = rows.shape
        bf16 = case == "bf16"

        # the two-launch K6's g: shared by the trees, alive with the case
        g = torch.empty((b, hc, wc), device="cuda")

        def make(lib, rows=rows, ids=ids, gt6=fn.gt6, dplane=dplane, colors=colors,
                 d_sums=d_sums, roi=tuple(fn.roi), bf16=bf16, g=g):
            b, _, hc, wc = rows.shape
            outs = [torch.full(rows.shape, float("nan"), device="cuda",
                               dtype=torch.bfloat16 if bf16 else torch.float32)]
            outs += [torch.full_like(x, float("nan")) for x in (dplane, colors)
                     if x is not None]
            if bf16:
                f = lib.dd_loss_bwd_bf16
                f.argtypes = [P] * 4 + [I] * 7 + [P] * 3
                args = (rows.data_ptr(), ids.data_ptr(), gt6.data_ptr(), d_sums.data_ptr(),
                        b, hc, wc, *roi, g.data_ptr(), outs[0].data_ptr())
            else:
                f = lib.dd_loss_bwd
                f.argtypes = [P] * 6 + [I] * 7 + [P] * 5
                it = iter(outs[1:])
                d_dplane = next(it) if dplane is not None else None
                d_colors = next(it) if colors is not None else None
                args = (rows.data_ptr(), ids.data_ptr(), gt6.data_ptr(),
                        None if dplane is None else dplane.data_ptr(),
                        None if colors is None else colors.data_ptr(), d_sums.data_ptr(),
                        b, hc, wc, *roi, g.data_ptr(), outs[0].data_ptr(),
                        None if d_dplane is None else d_dplane.data_ptr(),
                        None if d_colors is None else d_colors.data_ptr())

            def call():
                err = f(*args, torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return outs
            return call

        fg = ids > 0
        cases[f"K6 {case}"] = (make, _bit_equal,
                               dict(frame=[hc, wc], fg_pixels=int(fg.sum()),
                                    silhouette_pairs=int(
                                        (fg[:, :, 1:] != fg[:, :, :-1]).sum()
                                        + (fg[:, 1:] != fg[:, :-1]).sum())))
    return cases


def _params(root: Path, name: str, sources=("raster.cu",)) -> int:
    """The number of parameters of C entry point ``name`` in the first of
    ROOT's ``sources`` that defines it: K4's interface with the held chunks
    (off_c, used, k_chunk) has 13 and writes every slot, the earlier one 10;
    K10's forward with its boxes pre-pass 18, the earlier one 17."""
    for source in sources:
        text = (root / "diffdope_tpu_torch/csrc" / source).read_text()
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
        if m:
            return m.group(1).count(",") + 1
    raise ValueError(f"{name} is in none of {sources} under {root}")


def k4_cases(problems, mtx):
    """K4 on the compact table in f32 and bf16 and K7's backward on the
    uniform-K table, each under K6's own d_rows at the problem's raster.
    A tree whose K4 takes no held chunks writes the won slots only: its
    call zero-fills d_bins first (as its wrapper did), so its time includes
    the fill.  Outputs are held bit for bit."""
    import torch

    from diffdope_tpu_torch.render.fused_loss import loss_bwd
    from diffdope_tpu_torch.render.pipeline import K_CHUNK, TILE_HW

    (th, tw) = TILE_HW
    cases = {}
    for case, fn in problems.items():
        rows, ids, win, dplane, colors, d_sums = k6_inputs(fn, mtx)
        with torch.no_grad():
            tab = fn.table(mtx)
            d32, _, _ = loss_bwd(rows, ids, fn.gt6, fn.roi, d_sums, dplane, colors)
        b, _, hc, wc = rows.shape
        nty, ntx = hc // th, wc // tw
        tot = tab.packed.shape[2]
        uniform = tab.off_c is None
        for dtype in ((torch.float32,) if uniform else (torch.float32, torch.bfloat16)):
            d_rows = d32.to(dtype).contiguous()

            def make(lib, d_rows=d_rows, win=win, tab=tab, tot=tot, nty=nty, ntx=ntx,
                     uniform=uniform, b=b):
                out = torch.full((b, 32, tot), float("nan"), device="cuda")
                held = _params(lib.root, "dd_raster_bwd")
                if uniform:
                    f = lib.dd_raster_uniform_bwd
                    f.argtypes = [P] * 2 + [I] * 6 + [P] * 2
                    args = (d_rows.data_ptr(), win.data_ptr(), b, tot // (nty * ntx), nty,
                            ntx, th, tw, out.data_ptr())
                else:
                    f = lib.dd_raster_bwd if d_rows.dtype == torch.float32 \
                        else lib.dd_raster_bwd_bf16
                    if held == 13:
                        f.argtypes = [P] * 4 + [I] * 7 + [P] * 2
                        args = (d_rows.data_ptr(), win.data_ptr(), tab.off_c.data_ptr(),
                                tab.used.data_ptr(), b, tot, K_CHUNK, nty, ntx, th, tw,
                                out.data_ptr())
                    else:
                        f.argtypes = [P] * 2 + [I] * 6 + [P] * 2
                        args = (d_rows.data_ptr(), win.data_ptr(), b, tot, nty, ntx, th, tw,
                                out.data_ptr())
                fill = held != 13

                def call():
                    if fill:
                        out.zero_()
                    err = f(*args, torch.cuda.current_stream().cuda_stream)
                    assert err == 0, err
                    return (out,)
                return call

            name = ("K7 bwd " if uniform else "K4 ") + case + (
                " bf16" if dtype == torch.bfloat16 else "")
            end = tot if uniform else int(((tab.off_c + tab.used) * K_CHUNK).max())
            cases[name] = (make, _bit_equal,
                           dict(slots=tot, tail_slots=tot - end,
                                fg_pixels=int((win >= 0).sum())))
    return cases


def k10_inputs(fn, mtx):
    """The sorted table and tables of a 'v3' fused loss at poses ``mtx``,
    the forward's outputs (this tree's K10) and K6's d_rows there under a
    seeded cotangent of the sums."""
    import torch

    from diffdope_tpu_torch.render import raster_v3
    from diffdope_tpu_torch.render.fused_loss import loss_bwd
    from diffdope_tpu_torch.render.pipeline import TILE_HW

    res = fn.roi[2:]
    with torch.no_grad():
        pl = fn.planar(mtx)
        tables = raster_v3.prepare(pl.packed, res, TILE_HW)
        packed = raster_v3.sorted_table(pl.packed, tables)
        ids, rows, win = raster_v3.raster_v3_fwd(packed, tables, res, TILE_HW)
        gen = torch.Generator(device=mtx.device).manual_seed(1)
        d_sums = 0.5 + 1.5 * torch.rand((mtx.shape[0], 3), generator=gen, device=mtx.device)
        d_rows, _, _ = loss_bwd(rows, ids, fn.gt6, fn.roi, d_sums)
    return packed, tables, win, d_rows.contiguous()


def k10_cases(problems):
    """K10's forward and backward on each problem's 'v3' sorted table at its
    poses (``problems``: {case: (fn, mtx)}), the backward under K6's d_rows
    of the forward.  Outputs are held bit for bit (every output starts as
    NaN, or -7 for the int maps, so an unwritten value shows)."""
    import torch

    from diffdope_tpu_torch.kernels.check import exact_bin_slots
    from diffdope_tpu_torch.render import raster_v3
    from diffdope_tpu_torch.render.pipeline import TILE_HW

    (th, tw) = TILE_HW
    cases = {}
    for case, (fn, mtx) in problems.items():
        packed, tables, win, d_rows = k10_inputs(fn, mtx)
        b, _, tp = packed.shape
        h, w = fn.roi[2:]
        nty, ntx = -(-h // th), -(-w // tw)
        tabs = (tables.clo, tables.chi, tables.rlo_tc, tables.rhi_tc)
        gate = raster_v3._gate(tables, nty, ntx, th)

        def make_fwd(lib, packed=packed, tabs=tabs, b=b, tp=tp, h=h, w=w, nty=nty,
                     ntx=ntx):
            f = lib.dd_raster_v3_fwd
            # a tree whose K10 forward has the boxes pre-pass takes its scratch
            boxes = (torch.empty((b, tp, 2), dtype=torch.int32, device="cuda"),) if _params(
                lib.root, "dd_raster_v3_fwd", ("raster.cu", "raster_v3.cu")) == 18 else ()
            f.argtypes = [P] * 5 + [I] * 8 + [P] * (4 + len(boxes))
            outs = (torch.full((b, nty * th, ntx * tw), -7, dtype=torch.int32,
                               device="cuda"),
                    torch.full((b, nty * th, ntx * tw), -7, dtype=torch.int32,
                               device="cuda"),
                    torch.full((b, 32, nty * th, ntx * tw), float("nan"), device="cuda"))

            def call():
                err = f(packed.data_ptr(), *(t.data_ptr() for t in tabs), b, tp, nty, ntx,
                        th, tw, h, w, *(o.data_ptr() for o in outs + boxes),
                        torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return outs
            return call

        def make_bwd(lib, d_rows=d_rows, win=win, tabs=tabs, b=b, tp=tp, nty=nty,
                     ntx=ntx):
            f = lib.dd_raster_v3_bwd
            f.argtypes = [P] * 6 + [I] * 6 + [P] * 2
            out = torch.full((b, 32, tp), float("nan"), device="cuda")

            def call():
                err = f(d_rows.data_ptr(), win.data_ptr(), *(t.data_ptr() for t in tabs),
                        b, tp, nty, ntx, th, tw, out.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return (out,)
            return call

        info = dict(frame=[nty * th, ntx * tw], batch=b, slots=tp,
                    gated_pairs=int(gate.sum()), walked_slots=int(gate.sum()) * tables.k_chunk,
                    exact_slots=exact_bin_slots(fn.mesh, mtx, (h, w)),
                    fg_pixels=int((win >= 0).sum()))
        cases[f"K10 fwd {case}"] = (make_fwd, _bit_equal, info)
        cases[f"K10 bwd {case}"] = (make_bwd, _bit_equal, info)
    return cases


def k8_cases(problems, rows: bool):
    """K8 (``dd_raster_ids``) or, with ``rows``, K9's forward
    (``dd_gather_rows_fwd``) on each problem's setup rows (or packed rows)
    and bins at tile (32, 128), K from the fullest tile (``problems``:
    {case: (pos_clip, tri, colors, edge_adj, resolution)}).  A tree whose
    forward has the box pre-pass takes its scratch.  Outputs start as -7
    and NaN, are held bit for bit, and each tree's ids (K9: ids, win and
    rows) are compared with the plain twin's at every pixel of the frame."""
    import torch

    from diffdope_tpu_torch.kernels.check import (
        bin_box_tests,
        gather_rows_inputs,
        raster_ids_inputs,
    )
    from diffdope_tpu_torch.render.gather_rows import gather_rows_fwd_plain
    from diffdope_tpu_torch.render.rasterize import raster_ids_binned_plain

    tile = (32, 128)
    (th, tw) = tile
    name = "dd_gather_rows_fwd" if rows else "dd_raster_ids"
    cases = {}
    for case, (pos_clip, tri, colors, adj, res) in problems.items():
        with torch.no_grad():
            inputs = (gather_rows_inputs(pos_clip, tri, res, tile, colors, adj) if rows
                      else raster_ids_inputs(pos_clip, tri, res, tile))
        src, idx, counts = inputs
        b, t_count, _ = src.shape
        nty, ntx = -(-res[0] // th), -(-res[1] // tw)
        hp, wp = nty * th, ntx * tw

        def make(lib, src=src, idx=idx, counts=counts, b=b, t_count=t_count, nty=nty,
                 ntx=ntx, hp=hp, wp=wp, res=res):
            f = getattr(lib, name)
            n_out = 3 if rows else 1
            boxes = (torch.empty((b, t_count, 2), dtype=torch.int32, device="cuda"),) if (
                _params(lib.root, name, ("rasterize.cu",)) == (17 if rows else 15)) else ()
            f.argtypes = [P] * 3 + [I] * 9 + [P] * (n_out + len(boxes) + 1)
            outs = (torch.full((b, hp, wp), -7, dtype=torch.int32, device="cuda"),)
            if rows:
                outs += (torch.full((b, hp, wp), -7, dtype=torch.int32, device="cuda"),
                         torch.full((b, 32, hp, wp), float("nan"), device="cuda"))

            def call():
                err = f(src.data_ptr(), idx.data_ptr(), counts.data_ptr(), b, t_count,
                        idx.shape[1], nty, ntx, th, tw, *res,
                        *(o.data_ptr() for o in outs + boxes),
                        torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return outs
            return call

        def twin(src=src, idx=idx, counts=counts, res=res):
            with torch.no_grad():
                if rows:  # (ids, rows, win) -> the kernel's order
                    ids, rws, win = gather_rows_fwd_plain(src, idx, counts, res, tile)
                    return ids, win, rws
                return (raster_ids_binned_plain(src, idx, counts, res, tile),)

        tests, pairs = bin_box_tests(src, idx, counts, res, tile)
        n = counts.long().clamp(max=idx.shape[1])
        cases[("K9 fwd " if rows else "K8 ") + case] = (
            make, _bit_equal,
            dict(frame=[hp, wp], batch=b, k=idx.shape[1], held_slots=int(n.sum()),
                 box_tests=tests, tested_pairs=pairs), twin)
    return cases


def k9bwd_cases(problems):
    """K9's backward (``dd_gather_rows_bwd``) at tile (32, 128) on each
    problem's packed rows and bins (``problems`` as :func:`k8_cases`'),
    under one seeded normal d_rows and the winner map of this checkout's
    K9 forward.  d_bin starts as NaN and is held bit for bit, and each
    tree's to the plain twin at ``check_gather_rows``' tolerance."""
    import torch

    from diffdope_tpu_torch.kernels.check import _close, gather_rows_inputs
    from diffdope_tpu_torch.render.gather_rows import gather_rows_bwd_plain, gather_rows_fwd

    tile = (32, 128)
    (th, tw) = tile
    cases = {}
    for case, (pos_clip, tri, colors, adj, res) in problems.items():
        with torch.no_grad():
            packed, idx, counts = gather_rows_inputs(pos_clip, tri, res, tile, colors, adj)
            _, rows, win = gather_rows_fwd(packed, idx, counts, res, tile)
        gen = torch.Generator(device="cuda").manual_seed(0)
        d_rows = torch.randn(rows.shape, generator=gen, device="cuda")
        del rows, packed
        b, _, hp, wp = d_rows.shape
        nty, ntx, k = hp // th, wp // tw, idx.shape[1]

        def make(lib, d_rows=d_rows, win=win, counts=counts, b=b, nty=nty, ntx=ntx, k=k):
            f = lib.dd_gather_rows_bwd
            f.argtypes = [P] * 3 + [I] * 6 + [P] * 2
            out = torch.full((b, nty * ntx, k, 32), float("nan"), device="cuda")

            def call():
                err = f(d_rows.data_ptr(), win.data_ptr(), counts.data_ptr(), b, k, nty, ntx,
                        th, tw, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                assert err == 0, err
                return (out,)
            return call

        def twin(d_rows=d_rows, win=win, nt=nty * ntx, k=k):
            return (gather_rows_bwd_plain(d_rows, win, nt, k),
                    gather_rows_bwd_plain(d_rows.abs(), win, nt, k))  # the sums' scale

        n = counts.long().clamp(max=k)
        cases[f"K9 bwd {case}"] = (
            make, _bit_equal,
            dict(frame=[hp, wp], batch=b, k=k, held_slots=int(n.sum()),
                 table_slots=idx.numel(), empty_tiles=int((n == 0).sum()),
                 fg_pixels=int((win >= 0).sum())),
            twin, lambda outs, want: _close(outs[0], want[0], 2e-4, 1e-6, want[1]))
    return cases


def api_problems(base_scene, mtx):
    """{case: (pos_clip, tri, colors, edge_adj, resolution)}: the bench
    scene at its 64 poses, and ``chip_smoke.py``'s phase 9 (and 13) inputs:
    the default configuration's 960x540 frame, its 8 distinct poses
    around the init, the stand-in mesh."""
    import numpy as np
    import torch

    import chip_smoke
    from diffdope_tpu_torch.bench import distinct_poses
    from diffdope_tpu_torch.geometry import matmul44, xfm_points
    from diffdope_tpu_torch.optimize import pose_matrix

    def case(proj, pos, tri, colors, adj, mtx, res):
        with torch.no_grad():
            clip = xfm_points(torch.as_tensor(pos, device="cuda"),
                              matmul44(torch.as_tensor(np.asarray(proj, np.float32),
                                                       device="cuda"), mtx))
        return (clip, torch.as_tensor(tri, device="cuda").long(),
                torch.as_tensor(colors, device="cuda"),
                torch.as_tensor(adj, device="cuda").long(), res)

    sc = base_scene
    dd, _, _ = chip_smoke.diffdope_session(True)
    mesh = dd.object3d.mesh
    params = distinct_poses(dd.object3d.initial_params(dd.batchsize, "cuda"), 1e-3)
    with torch.no_grad():
        mtx9, _, _ = pose_matrix(params)
    return {"bench": case(sc["proj"], sc["pos"], sc["tri"], sc["vtx_color"], sc["edge_adj"],
                          mtx, (400, 400)),
            "phase9_13": case(dd.camera.cam_proj, mesh.pos, mesh.pos_idx, mesh.vtx_color,
                              mesh.edge_adj, mtx9, tuple(dd.resolution))}


def _twin_pixels(outs, want) -> int:
    """The (hypothesis, pixel) pairs of the twin's frame at which any
    output of a kernel (ids (B, H, W), win, rows (B, 32, H, W), padded
    frames cut to the twin's) differs from the twin's, bit for bit."""
    import torch

    bad = None
    for x, y in zip(outs, want):
        x = x[..., :y.shape[-2], :y.shape[-1]]
        d = _bits(x) != _bits(y)
        d = d.any(dim=1) if d.dim() == 4 else d
        bad = d if bad is None else bad | d
    return int(bad.sum()) if bad is not None else 0


def phase11_problem():
    """(fused loss, poses) of ``chip_smoke.py``'s phase 11: the default
    configuration (960x540, B=8, the stand-in) run under ``DD_RASTER=v3``,
    its loss built on that route, at the run's last poses."""
    import torch

    import chip_smoke
    from diffdope_tpu_torch.bench import raster_env

    dd, _, _ = chip_smoke.diffdope_session(True)
    with raster_env("v3"):
        dd.run_optimization()
        fn = dd._make_fused_loss_fn(dd.gt_tensors)
    return fn, torch.as_tensor(dd.mtx_history[-1], device="cuda")


class _Libs:
    """A tree's libraries of one kernel: an entry point is looked up in
    each in turn; ``root`` is the tree they were built from."""

    def __init__(self, libs, root: Path):
        self.cdlls = [ctypes.CDLL(str(lib)) for lib in libs]
        self.root = root

    def __getattr__(self, name):
        for cdll in self.cdlls:
            if hasattr(cdll, name):
                return getattr(cdll, name)
        raise AttributeError(name)


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("roots", nargs="+")
    parser.add_argument("--kernels", default="K2,K5")
    parser.add_argument("--sass-dir")
    parser.add_argument("--out")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    import torch

    from diffdope_tpu_torch.bench import bench_problem, card, distinct_poses
    from diffdope_tpu_torch.optimize import pose_matrix

    if not torch.cuda.is_available():
        print("no CUDA device: this measures the card only", file=sys.stderr)
        return 2
    gpu = card()
    roots = [Path(r).resolve() for r in args.roots]
    kinds = args.kernels.split(",")
    base = bench_problem(device="cuda")
    mtx, _, _ = pose_matrix(distinct_poses(base["params0"], 1e-3))
    variants = {"compact": base["fn"]}

    def variant(name, **kw):
        if name not in variants:
            variants[name] = bench_problem(device="cuda", **kw)["fn"]
        return variants[name]

    makers = {
        "K2": lambda: k2_cases({"compact": base["fn"],
                                "uniform": variant("uniform", uniform=True),
                                "uv": variant("texture", texture=True)}, mtx),
        "K5": lambda: k5_cases({"rgb": base["fn"],
                                "depth": variant("depth", depth=True),
                                "color": variant("texture", texture=True),
                                "color_depth": variant("texture_depth", texture=True,
                                                       depth=True)}, mtx),
        "K3": lambda: k3_cases({"compact": base["fn"],
                                "uniform": variant("uniform", uniform=True)}, mtx),
        "K6": lambda: k6_cases({"rgb": base["fn"], "bf16": base["fn"],
                                "depth": variant("depth", depth=True),
                                "color": variant("texture", texture=True),
                                "color_depth": variant("texture_depth", texture=True,
                                                       depth=True)}, mtx),
        "K4": lambda: k4_cases({"compact": base["fn"],
                                "uniform": variant("uniform", uniform=True)}, mtx),
        "K10": lambda: k10_cases({"bench": (variant("v3", route="v3"), mtx),
                                  "phase11": phase11_problem()}),
        "K8": lambda: k8_cases(api(), rows=False),
        "K9": lambda: k8_cases(api(), rows=True),
        "K9bwd": lambda: k9bwd_cases(api()),
    }
    api_cache = {}

    def api():
        if not api_cache:
            api_cache.update(api_problems(base["scene"], mtx))
        return api_cache
    order = list(range(len(roots)))
    turns = order + order[::-1]
    out = open(args.out, "w") if args.out else None
    for kind in kinds:
        built = [build(r, kind, HERE / "build" / "kernel_ab", f"{kind}_{i}")
                 for i, r in enumerate(roots)]
        sass = [{k: v for lib in libs for k, v in
                 sass_loops(lib, SOURCES[kind][1], args.sass_dir).items()}
                for libs, _ in built]
        for case, (make, close, info, *twin) in makers[kind]().items():
            calls = [make(_Libs(libs, root)) for (libs, _), root in zip(built, roots)]
            first = [o.clone() for o in calls[0]()]
            want = twin[0]() if twin else None
            near = twin[1] if len(twin) > 1 else None  # a twin held at a tolerance
            agree, equal, repeats, diffs, off_twin = [], [], [], [], []
            for call in calls:
                once = [o.clone() for o in call()]
                agree.append(bool(close(first, once)))
                equal.append(_bit_equal(first, once))
                repeats.append(_bit_equal(once, call()))
                diffs.append(_diffs(first, once))
                off_twin.append(None if want is None else near(once, want) if near
                                else _twin_pixels(once, want))
            ms = {i: [] for i in order}
            for _ in range(2):
                for i in turns:
                    ms[i].append(time_ms(calls[i], args.reps))
            for i in order:
                row = {"tree": str(roots[i]), "case": case, "card": gpu, "ms": ms[i],
                       "agrees_with_first_tree": agree[i],
                       "bit_equal_to_first_tree": equal[i],
                       "repeats_bit_for_bit": repeats[i], **info}
                if diffs[i]:
                    row["differs_from_first_tree"] = diffs[i]
                if off_twin[i] is not None:
                    row["agrees_with_plain_twin" if near else
                        "pixels_off_the_plain_twin"] = off_twin[i]
                print(json.dumps(row), flush=True)
                if out:
                    out.write(json.dumps(dict(row, ptxas=built[i][1], sass=sass[i])) + "\n")
                    out.flush()
            del calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
