"""Wall time and host syncs of a PyTorch-port DiffDope step, on the card,
for the tree at ROOT (this checkout, or another one of the repo: run two
trees in one call, alternating, to compare them on the same card).

    python tools/port_step_times.py ROOT [setting ...]   # default: all

Each setting is ``ROOT/chip_smoke.py``'s default-configuration DiffDope
session (960x540, B=8, 61 SGD steps, the stand-in mesh, fused): mask L1
on the compact table (``mask_compact``, phase 5) and under
``DD_BINNED=0`` (``mask_v2``, phase 12).  It runs once to warm up
(recovery re-runs included), three times untimed by a tracer, then once
with ``torch.cuda.set_sync_debug_mode('warn')`` to count the operations
that wait for the card.  Prints one JSON line per setting: the kept
run's wall ms per step of the three runs, and host syncs per step.
"""

import json
import sys
import warnings
from pathlib import Path

#: name: (the planar route, or None for the compact table)
SETTINGS = {"mask_compact": None, "mask_v2": "v2"}


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
        dd, _, _ = chip_smoke.diffdope_session(True)
        with raster_env(route):
            dd.run_optimization()  # warm-up, and the recovery's capacities
            steps = dd.last_run_stats["steps"]
            ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                dd.run_optimization()
                torch.cuda.synchronize()
                ms.append(1e3 * dd.last_run_stats["wall_time_s"] / steps)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    dd.run_optimization()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        print(json.dumps({
            "tree": str(root), "setting": name, "card": gpu, "steps": steps,
            "reruns": dd.last_run_stats["recovery_reruns"], "ms_per_step": ms,
            "host_syncs_per_step": syncs / steps,
        }), flush=True)
        del dd
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
