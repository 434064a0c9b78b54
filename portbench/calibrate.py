"""Read the two ends of each limit of a cell: the program's gaps over many
seeds (the lower readings) and the control's, the plain reference in
bfloat16 in the program's place on the same requests (the upper readings).

    python3 -m portbench.calibrate --workload <cell> --seeds 11,12,... \\
        --control-seeds 11,12,13 --seconds 4 --out <file>.jsonl

Each seed is one run of the cell at its own sizes, set up anew in this
process, with a short window; one JSON line a seed goes to ``--out`` and
to standard output.  ``--fault`` plants one of ``portbench.faults`` in the
program for every seed.  The benchmark's own runs never run the control
or a fault.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import numpy as np
import torch

from portbench import check, faults, run
from portbench.entries import ref_mesh_of


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None, choices=faults.NAMES,
                    help="plant this fault in the program for every seed")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        run.log("calibrate needs a CUDA card")
        return 3
    plan = run.cell_plan(run.load_benchmark(), args.workload)
    plan["limits"] = None
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
                out = run.run_cell(plan, seed, args.seconds, False)
            line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                    "program": {k: v for k, v, _ in out["rows"]},
                    "end_to_end": run.end_to_end(out), "failed": sum(
                        r.failed for r in out["records"]) + len(out["errors"]),
                    "attempted": len(out["records"]) + len(out["errors"]),
                    "kind": torch.cuda.get_device_name(0)}
            if seed in controls:
                low = ref_mesh_of(out["problem"], out["proj"].device, torch.bfloat16)
                line["control"] = check.control(
                    out["problem"], out["mesh"], out["proj"], low,
                    out["proj"].to(torch.bfloat16), out["frames"], out["items"],
                    np.random.default_rng([seed, 3]))
            text = json.dumps(line)
            print(text, flush=True)
            if sink:
                sink.write(text + "\n")
                sink.flush()
            del out
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
