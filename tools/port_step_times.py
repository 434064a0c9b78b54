"""Wall time and host syncs of a PyTorch-port DiffDope step, on the card,
for the tree at ROOT (this checkout, or another one of the repo: run two
trees in one call, alternating, to compare them on the same card).

    python tools/port_step_times.py ROOT [setting ...]   # default: all

The settings: ``bench``, the bench main path (``ROOT/chip_smoke.py``'s
phase 4: the bench protocol's 64 hypotheses, 100 Adam steps at 400x400
through ``run_refinement``), and ``ROOT/chip_smoke.py``'s
default-configuration DiffDope session (960x540, B=8, 61 SGD steps, the
stand-in mesh, fused): mask L1 on the compact table (``mask_compact``,
phase 5) and under ``DD_BINNED=0`` (``mask_v2``, phase 12).  Each runs
once to warm up (recovery re-runs included), three times untimed by a
tracer, then once with ``torch.cuda.set_sync_debug_mode('warn')`` to
count the operations that wait for the card.  Prints one JSON line per
setting: the (kept) run's wall ms per step of the three runs, and host
syncs per step.
"""

import json
import sys
import warnings
from pathlib import Path

#: name: (the planar route, or None for the compact table); 'bench' runs
#: the bench main path
SETTINGS = {"bench": None, "mask_compact": None, "mask_v2": "v2"}


def bench_runs():
    """(ms a step of three bench refinements, steps, the untimed run's
    callable) after a warm-up."""
    from diffdope_tpu_torch.bench import bench_problem, run_refinement

    problem = bench_problem(device="cuda")
    run_refinement(problem)
    ms = []
    for _ in range(3):
        res, seconds = run_refinement(problem)
        steps = res.total_loss.shape[0]
        ms.append(1e3 * seconds / steps)
    return ms, steps, lambda: run_refinement(problem)


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    from diffdope_tpu_torch.bench import card, raster_env

    if not torch.cuda.is_available():
        print("no CUDA device: this measures the card only", file=sys.stderr)
        return 2
    gpu = card()
    for name in sys.argv[2:] or SETTINGS:
        route = SETTINGS[name]
        with raster_env(route):
            if name == "bench":
                ms, steps, again = bench_runs()
                reruns = 0
            else:
                dd, _, _ = chip_smoke.diffdope_session(True)
                dd.run_optimization()  # warm-up, and the recovery's capacities
                steps = dd.last_run_stats["steps"]
                ms = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    dd.run_optimization()
                    torch.cuda.synchronize()
                    ms.append(1e3 * dd.last_run_stats["wall_time_s"] / steps)
                reruns = dd.last_run_stats["recovery_reruns"]
                again = dd.run_optimization
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    again()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        print(json.dumps({
            "tree": str(root), "setting": name, "card": gpu, "steps": steps,
            "reruns": reruns, "ms_per_step": ms, "host_syncs_per_step": syncs / steps,
        }), flush=True)
        again = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
