"""What holds an object back in ``chip_smoke.py``'s BOP scene (phase 17 (b)).

The scene is phase 17 (b)'s: the two stand-ins at 1920x1080, each init 10
degrees and 40 mm off its true pose.  The default configuration (B=8, 60
SGD steps at base_lr 20, the mask loss alone, image_resize 0.5) is run
through ``examples.run_bop_scene.main`` as the phase runs it, then again
with one thing changed at a time:

- ``exact``: a table that drops no pair (compact capacity 2^19 slots, a
  per-tile cap of every triangle), no ROI crop, no recovery re-run;
- ``exact+rgb``: the same with the rgb loss on beside the mask;
- ``exact+depth``: the same with the depth loss on beside the mask;
- ``exact+240``: the same with 240 steps.

On the card (it writes the scene with the port's renderer):

    python tools/port_bop_scene_ablation.py

Prints one JSON line per variant: each object's ADD at the init and
after, its ADD-S, its diameter and the kept hypothesis, and the wall time.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: a table that holds every (tile, triangle) pair of the stand-ins' 5,120
#: triangles, and no crop or re-run ('off' quoted: bare, YAML reads it as
#: false, which both packages take for "auto")
EXACT = ("tpu.compact_total=524288", "tpu.max_tris_per_tile=5120", "tpu.roi_crop='off'",
         "tpu.overflow_recovery=false")
VARIANTS = {
    "default": (),
    "exact": EXACT,
    "exact+rgb": EXACT + ("losses.l1_rgb_with_mask=true",),
    "exact+depth": EXACT + ("losses.l1_depth_with_mask=true",),
    "exact+240": EXACT + ("hyperparameters.nb_iterations=240",),
}


def main() -> None:
    import torch

    import chip_smoke
    from diffdope_tpu_torch.bench import card
    from diffdope_tpu_torch.examples import run_bop_scene
    from diffdope_tpu_torch.mesh import load_mesh
    from diffdope_tpu_torch.metrics import add_metric, subsample_points

    gpu = card()
    print(f"card: {gpu}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        scene, models, gt_objs, init_objs = chip_smoke.write_bop_scene(root)
        meshes = [load_mesh(models / f"obj_{o['obj_id']:06d}.ply", scale=0.01)
                  for o in gt_objs]

        def rt(o):
            return (torch.tensor(o["cam_R_m2c"], dtype=torch.float32).reshape(3, 3),
                    torch.tensor(o["cam_t_m2c"], dtype=torch.float32) * 0.01)

        add_init = [float(add_metric(subsample_points(m.pos[: m.num_vertices]),
                                     *rt(init_objs[i]), *rt(gt_objs[i])))
                    for i, m in enumerate(meshes)]
        for name, overrides in VARIANTS.items():
            argv = [f"bop.scene_dir={scene}", f"bop.models_dir={models}",
                    f"bop.error_json={scene / 'scene_error.json'}", "bop.frame=0",
                    f"bop.out_dir={root}", f"bop.gt_json={scene / 'scene_gt.json'}",
                    *overrides, "--device", "cuda"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = run_bop_scene.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            row = {"variant": name, "overrides": list(overrides), "wall_s": wall,
                   "card": gpu, "objects": [
                       {"object": int(k), "add_init": add_init[int(k)], "add": e["add"],
                        "adds": e["adds"], "diameter": e["diameter"],
                        "argmin": e["argmin"], "final_loss": e["final_loss"]}
                       for k, e in results.items()]}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
