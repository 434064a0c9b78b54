"""Wall time and host syncs of a PyTorch-port refinement step, on the card,
as graph replays and as the eager loop side by side, for the tree at ROOT
(this checkout, or another one of the repo: run two trees in one call,
alternating, to compare them on the same card).

    python tools/port_step_times.py ROOT [setting ...]   # default: all

The settings: ``bench``, the bench main path (``ROOT/chip_smoke.py``'s
phase 4: the bench protocol's 64 hypotheses, 100 Adam steps at 400x400
through ``run_refinement``), and ``ROOT/chip_smoke.py``'s
default-configuration DiffDope session (960x540, B=8, 61 SGD steps, the
stand-in mesh, fused): mask L1 on the compact table (``mask_compact``,
phase 5) and under ``DD_BINNED=0`` (``mask_v2``, phase 12), the
session's refinement driven by ``chip_smoke.session_refine`` on the
capacities its first run kept.  Each runs, for ``refine``'s
``cuda_graph`` True then False, once to warm up, three times untimed by a
tracer, then once with ``torch.cuda.set_sync_debug_mode('warn')`` to
count the operations that wait for the card (step 0 of a graph run sets
'error' for itself).  Prints one JSON line per setting and mode: the
wall ms per step of the three runs, their peak device memory, host
syncs per step, and a SHA-256 of the last run's poses, totals, logs and
params (``digest``: equal digests across trees and modes are runs equal
bit for bit).  A tree whose ``refine`` has no ``cuda_graph`` runs its
own loop, once.
"""

import hashlib
import inspect
import json
import sys
import time
import warnings
from pathlib import Path

#: name: (the planar route, or None for the compact table); 'bench' runs
#: the bench main path
SETTINGS = {"bench": None, "mask_compact": None, "mask_v2": "v2"}


def digest(res) -> str:
    """SHA-256 of a RefineResult's poses, totals, logs and params, bytes
    in a fixed order."""
    h = hashlib.sha256()
    fields = [("mtx_history", res.mtx_history), ("total_loss", res.total_loss)]
    for group in ("losses_values", "params"):
        fields += [(f"{group}[{k}]", v) for k, v in sorted((getattr(res, group) or {}).items())]
    for name, value in fields:
        h.update(name.encode())
        h.update(value.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def main() -> int:
    root = Path(sys.argv[1]).resolve()
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke
    from diffdope_tpu_torch.bench import bench_problem, card, raster_env, run_refinement
    from diffdope_tpu_torch.optimize import refine

    if not torch.cuda.is_available():
        print("no CUDA device: this measures the card only", file=sys.stderr)
        return 2
    gpu = card()
    modes = ((True, False) if "cuda_graph" in inspect.signature(refine).parameters
             else (None,))
    for name in sys.argv[2:] or SETTINGS:
        with raster_env(SETTINGS[name]):
            if name == "bench":
                problem = bench_problem(device="cuda")
            else:
                dd, _, _ = chip_smoke.diffdope_session(True)
                dd.run_optimization()  # the recovery's capacities
            for graph in modes:
                kw = {} if graph is None else {"cuda_graph": graph}

                def again():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = (run_refinement(problem, **kw)[0] if name == "bench"
                           else chip_smoke.session_refine(dd, **kw) if kw
                           else dd.run_optimization() or dd._result)
                    torch.cuda.synchronize()
                    return res, time.perf_counter() - t0

                again()  # warm-up
                torch.cuda.reset_peak_memory_stats()
                ms = []
                for _ in range(3):
                    res, seconds = again()
                    steps = res.total_loss.shape[0]
                    ms.append(1e3 * seconds / steps)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.cuda.set_sync_debug_mode("warn")
                    try:
                        again()
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                syncs = sum("synchroniz" in str(w.message) for w in caught)
                print(json.dumps({
                    "tree": str(root), "setting": name, "cuda_graph": graph, "card": gpu,
                    "steps": steps, "ms_per_step": ms, "peak_gib": peak,
                    "host_syncs_per_step": syncs / steps, "digest": digest(res),
                }), flush=True)
        problem = dd = None
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
