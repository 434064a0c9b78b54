"""DiffDope on the textured stand-in at the default configuration: how the
hypotheses move with the exact texture, fused and unfused, against the
baked corner colours and a smooth texture.

    python tools/port_texture_trajectories.py

Needs the card.  The runs are ``chip_smoke.texture_phase``'s sessions
(960x540, B=8, 61 SGD steps at base lr 20, mask + rgb L1, the textured
stand-in, the init ``chip_smoke.INIT_OFFSET`` off, the scene the port's
render of the same mesh at the configured pose); prints one JSON line per
run: the loss scales, each hypothesis' summed loss at the first and last
step and its largest, how many fell, the distance of each hypothesis'
last pose from the camera against the gt pose's, the most slots a step
needed, the recovery re-runs, and the ADD of the init and of
``get_pose()``.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

#: label: (fused, texture kind, tpu overrides)
RUNS = {
    "exact, fused, checker": (True, "checker", {"texture_mode": "exact"}),
    "exact, unfused, checker": (False, "checker", {"texture_mode": "exact"}),
    "baked, fused, checker": (True, "checker", {"texture_mode": "baked"}),
    "exact, fused, smooth": (True, "smooth", {"texture_mode": "exact"}),
}


def main() -> None:
    import numpy as np
    import torch

    from diffdope_tpu_torch.bench import card

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    gpu = card()
    for label in sys.argv[1:] or RUNS:
        fused, kind, tpu = RUNS[label]
        dd, points, mtx_gt = chip_smoke.diffdope_session(
            fused, tpu=tpu, losses=chip_smoke.TEXTURE_LOSSES,
            mesh=chip_smoke.texture_mesh(kind))
        dd.run_optimization()
        per_hyp = sum(v for v in dd.losses_values.values())  # (steps, B)
        telem = dd._result.telemetry or {}
        need = telem["_bin_need"].cpu().numpy() if "_bin_need" in telem else np.zeros(1)
        dist = np.linalg.norm(dd.mtx_history[-1][:, :3, 3], axis=-1)
        print(json.dumps({
            "run": label, "card": gpu,
            "loss_scales": dd.learning_rates.cpu().numpy().round(4).tolist(),
            "loss_first": per_hyp[0].tolist(), "loss_last": per_hyp[-1].tolist(),
            "loss_max": per_hyp.max(axis=0).tolist(),
            "fell": int((per_hyp[-1] < per_hyp[0]).sum()),
            "camera_distance_last": dist.round(4).tolist(),
            "camera_distance_gt": float(mtx_gt[:3, 3].double().norm()),
            "slots_needed_most": int(need.max()),
            "reruns": dd.last_run_stats["recovery_reruns"],
            "add_init": chip_smoke.add_to(points, mtx_gt, dd.object3d.initial_matrix()),
            "add_pose": chip_smoke.add_to(points, mtx_gt, dd.get_pose()),
        }), flush=True)


if __name__ == "__main__":
    main()
