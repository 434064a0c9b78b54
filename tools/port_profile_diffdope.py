"""Where the device time of a PyTorch-port DiffDope step goes, on the card.

Runs ``chip_smoke.py``'s default-configuration DiffDope session (960x540,
B=8, 61 SGD steps, stand-in mesh) in five settings: mask L1 on the
compact table (``chip_smoke`` phase 5), mask + depth L1 on the compact
table (phase 7), mask + depth L1 on the uniform-K table (phase 8), mask
+ rgb L1 with exact texture on the textured stand-in (phase 14), and
mask L1 on the sorted-range raster under ``DD_RASTER=v3`` (phase 11: K10,
no ROI crop, the padded 960x544 frame).  Each setting runs
``run_optimization`` once (its recovery re-runs fix the capacities and
the crop), then its refinement (``chip_smoke.session_refine``) as graph
replays and as the eager loop (``refine(cuda_graph=False)``), each once
to warm up, once untraced for the step's wall time, and once under
``torch.profiler``.

    python tools/port_profile_diffdope.py [setting ...]   # default: all

Prints, per setting and mode, one JSON line: the untraced wall time per
step, the device busy time per step (sum of the CUDA kernels' self time
over the traced run, divided by its steps) and its share of the untraced
step, and the kernels with the most device time per step.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: name: (tpu overrides, loss overrides, the textured stand-in or the
#: configured mesh, the raster route)
SETTINGS = {
    "mask_compact": ({}, {}, False, None),
    "depth_compact": ({}, {"l1_depth_with_mask": True}, False, None),
    "depth_uniform": ({"compact_bins": False}, {"l1_depth_with_mask": True}, False, None),
    "texture_exact": ({"texture_mode": "exact"}, {"l1_rgb_with_mask": True}, True, None),
    "v3": ({}, {}, False, "v3"),
}
TOP = 12


def main() -> int:
    import torch

    import chip_smoke
    from diffdope_tpu_torch.bench import card, device_busy, raster_env

    if not torch.cuda.is_available():
        print("no CUDA device: this profile measures the card only", file=sys.stderr)
        return 2
    gpu = card()
    for name in sys.argv[1:] or SETTINGS:
        tpu, losses, textured, route = SETTINGS[name]
        mesh = chip_smoke.texture_mesh() if textured else None
        dd, _, _ = chip_smoke.diffdope_session(True, tpu=tpu, losses=losses, mesh=mesh)
        with raster_env(route):
            dd.run_optimization()  # the recovery's capacities and crop
            for graph in (True, False):
                def run():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = chip_smoke.session_refine(dd, graph)
                    torch.cuda.synchronize()
                    return res, time.perf_counter() - t0

                run()  # warm-up
                res, wall = run()
                steps = res.total_loss.shape[0]
                step_ms = 1e3 * wall / steps
                events, busy_ms, _ = device_busy(run)
                busy_ms /= steps
                cuda = sorted((e for e in events
                               if e.device_type == torch.autograd.DeviceType.CUDA),
                              key=lambda e: -e.self_device_time_total)
                print(json.dumps({
                    "setting": name, "cuda_graph": graph, "card": gpu, "steps": steps,
                    "reruns": dd.last_run_stats["recovery_reruns"],
                    "untraced_ms_per_step": step_ms, "device_busy_ms_per_step": busy_ms,
                    "busy_share_of_untraced_step": busy_ms / step_ms,
                    "top_kernels_ms_per_step": [
                        [e.key[:80], e.self_device_time_total / 1e3 / steps,
                         e.count // steps] for e in cuda[:TOP]],
                }), flush=True)
        del dd
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
