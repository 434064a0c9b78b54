"""K10 of two trees along the whole of ``chip_smoke.py``'s phase 11, on the
card: the default configuration (960x540, B=8, the stand-in) run under
``DD_RASTER=v3`` with this checkout, then at every step's poses K10's
forward and backward of each tree, held bit for bit to the first's.

    python tools/port_k10_trajectory.py ROOT_A ROOT_B

Each ROOT is a checkout of the repo (the parent unpacked with ``git
archive`` into the gitignored ``chip_proof/``, or this one).  Prints the
steps and, for each step where an output differs, which and where; for
the first differing forward, each differing pixel's winners in the two
trees with their lanes 0-12 and 28-31 (where a slot's vertex bounds miss
a pixel that its f32 edge planes cover, this shows it).  The inputs of a
step are made by this checkout (``port_kernel_ab.k10_inputs``).
"""

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("roots", nargs=2)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this compares kernels on the card only", file=sys.stderr)
        return 2
    import chip_smoke
    import port_kernel_ab as ab
    from diffdope_tpu_torch.bench import card, raster_env

    dd, _, _ = chip_smoke.diffdope_session(True)
    with raster_env("v3"):
        dd.run_optimization()
        fn = dd._make_fused_loss_fn(dd.gt_tensors)
    libs = []
    for i, root in enumerate(args.roots):
        built, _ = ab.build(Path(root).resolve(), "K10", HERE / "build" / "k10_trajectory",
                            f"K10_{i}")
        libs.append(ab._Libs(built, Path(root).resolve()))
    print(f"{len(dd.mtx_history)} steps [{card()}]", flush=True)
    shown = False
    differing = 0
    for step, m in enumerate(dd.mtx_history):
        mtx = torch.as_tensor(m, device="cuda")
        for case, (make, _, _) in ab.k10_cases({"phase11": (fn, mtx)}).items():
            outs = [[o.clone() for o in make(lib)()] for lib in libs]
            if ab._bit_equal(*outs):
                continue
            differing += 1
            print(f"step {step} {case}: {ab._diffs(*outs)}", flush=True)
            if case.startswith("K10 fwd") and not shown:
                shown = True
                packed, _, _, _ = ab.k10_inputs(fn, mtx)
                (_, win_a, _), (_, win_b, _) = outs
                for bi, r, c in torch.nonzero(win_a != win_b)[:8].tolist():
                    print(f"  pixel {(bi, r, c)}", flush=True)
                    for s in {int(win_a[bi, r, c]), int(win_b[bi, r, c])} - {-1}:
                        lanes = packed[bi, list(range(13)) + [28, 29, 30, 31], s].tolist()
                        print(f"    slot {s}: lanes 0-12, 28-31 {lanes}", flush=True)
    print(f"{differing} differing (step, kernel) pairs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
