"""Refine every object of a BOP scene frame from a perturbed-pose JSON.

Counterpart of ``examples/run_bop_scene.py``: loads the frame's perturbed
poses ({frame: [{cam_R_m2c (9), cam_t_m2c (3), obj_id}]}), refines each
object against the frame's rgb / depth / mask_visib images
(:func:`diffdope_tpu_torch.bop.refine_bop_frame`), writes the refined
poses in the OpenCV/BOP frame to ``<bop.out_dir>/refined_poses.json`` and
prints one line per object.  The paths come as dotted overrides of the
configuration (``configs/diffdope.yaml``):

    python -m diffdope_tpu_torch.examples.run_bop_scene \\
        bop.scene_dir=/data/hope/val/000001 bop.models_dir=/data/hope/models \\
        bop.error_json=/data/hope/val/000001/scene_error_deg_040_trans_016.json \\
        bop.frame=0 [bop.gt_json=/data/hope/val/000001/scene_gt.json] [--device cpu]

With ``bop.gt_json`` each object's ADD is printed too.  The refinement
runs on the card unless ``--device`` names another.
"""

import argparse
import json
import sys
from pathlib import Path

from diffdope_tpu_torch.bop import refine_bop_frame
from diffdope_tpu_torch.config import ConfigNode, cli_overrides, load_config


def main(argv=None):
    """Run the scene; returns the refined poses by object index."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    cfg = load_config(overrides=cli_overrides(rest))
    bop = cfg.get("bop", ConfigNode())
    scene_dir = Path(bop.get("scene_dir", ""))
    models_dir = Path(bop.get("models_dir", ""))
    error_json = Path(bop.get("error_json", ""))
    frame = str(bop.get("frame", "0"))
    out_dir = Path(bop.get("out_dir", "."))
    obj_scale = float(bop.get("scale", 0.01))

    if not error_json.is_file():
        sys.exit(f"bop.error_json not found: {error_json}")
    if not scene_dir.is_dir():
        sys.exit(f"bop.scene_dir not found: {scene_dir}")
    with open(error_json) as f:
        frame_objs = json.load(f)[frame]
    gt_objs = None
    gt_json = Path(bop.get("gt_json", ""))
    if gt_json.is_file():
        with open(gt_json) as f:
            gt_objs = json.load(f)[frame]

    results = refine_bop_frame(cfg, scene_dir, models_dir, frame_objs, frame=frame,
                               obj_scale=obj_scale, gt_objs=gt_objs, device=args.device)
    with open(out_dir / "refined_poses.json", "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {out_dir / 'refined_poses.json'}")
    for k, v in results.items():
        line = f"object {k} (obj_id {v['obj_id']}): loss {v['final_loss']:.5f}"
        if "add" in v:
            line += f", ADD {v['add']:.4f} ({100*v['add']/v['diameter']:.1f}% of diameter)"
        print(line)
    return results


if __name__ == "__main__":
    main()
