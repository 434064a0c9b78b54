"""BOP perturbation-level sweep with aggregate ADD(-S)/AUC reporting.

Counterpart of ``examples/run_bop_sweep.py``: walks the perturbed-pose
JSONs under ``--data-root`` (``<dataset>/<split>/<scene>/
scene_error_<level>.json``, three levels a scene) and prints a table per
level (:func:`diffdope_tpu_torch.bop.sweep_perturbation_levels`).

Without ``--bop-root`` the protocol is synthesized: the JSON pose is the
ground truth, its image rendered with the stand-in ``--mesh``, and the
init perturbed by the level's own magnitudes.  With ``--bop-root`` (a real
BOP split: rgb/, mask_visib/, scene_gt.json and models/) the JSON pose is
the init and scene_gt.json scores the result.  ``--data-root`` and, for
the synthesized protocol, ``--mesh`` must be given.  ``--shard i/n`` runs
every n-th scene from the i-th; ``--out`` writes the full results as JSON.
The sweep runs on the card unless ``--device`` names another.

    python -m diffdope_tpu_torch.examples.run_bop_sweep --data-root DATA \\
        --mesh data/standins/standin_asym.ply --dataset hope --max-objects 2
"""

import argparse
import json
import sys

from diffdope_tpu_torch.bop import PERTURBATION_LEVELS, sweep_perturbation_levels


def _floats(text: str):
    return tuple(float(v) for v in text.split(","))


def main(argv=None):
    """Run the sweep; returns its per-level results."""
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-root", required=True,
                    help="root of <dataset>/<split>/<scene>/scene_error_<level>.json")
    ap.add_argument("--dataset", default="hope", choices=["hope", "ycbv", "tless"])
    ap.add_argument("--levels", default="all",
                    help="comma list, e.g. deg_010_trans_004 (default all 3)")
    ap.add_argument("--max-scenes", type=int, default=1)
    ap.add_argument("--max-frames", type=int, default=1)
    ap.add_argument("--max-objects", type=int, default=3)
    ap.add_argument("--batchsize", type=int, default=16)
    ap.add_argument("--iterations", type=int, default=40)
    ap.add_argument("--resolution", default="160x160")
    ap.add_argument("--bop-root", default=None,
                    help="real BOP split dir (enables the real protocol)")
    ap.add_argument("--models-dir", default=None)
    ap.add_argument("--mesh", dest="mesh_path", default=None,
                    help="stand-in mesh for the synthesized protocol")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--optimizer", default="adam", choices=["adam", "sgd"])
    ap.add_argument("--base-lr", type=float, default=0.02)
    ap.add_argument("--lr-bounds", default="0.5,4.0",
                    help="per-hypothesis loss-scale bounds (sgd only: adam is "
                         "invariant to gradient scale)")
    ap.add_argument("--loss-weights", default="0.7,0,1",
                    help="rgb,depth,mask term weights; 0 disables a term")
    ap.add_argument("--init-jitter", default="0,0",
                    help="deg,trans per-hypothesis init jitter (hypothesis 0 "
                         "unjittered); 0,0 keeps every hypothesis at the init")
    ap.add_argument("--restarts", type=int, default=0,
                    help="re-seed all hypotheses at the running best between "
                         "N+1 equal segments")
    ap.add_argument("--restart-jitter", default="10,0.02",
                    help="deg,trans jitter applied at each restart")
    ap.add_argument("--argmin-rule", default="best_step",
                    choices=["best_step", "last_step"],
                    help="pose selection: the best (step, hypothesis) of the "
                         "whole history, or the last step's best")
    ap.add_argument("--shard", default="0/1", help="i/n per-host scene shard")
    ap.add_argument("--out", default=None, help="write full results JSON here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.bop_root is None and args.mesh_path is None:
        ap.error("the synthesized protocol needs --mesh (or give --bop-root)")

    levels = list(PERTURBATION_LEVELS) if args.levels == "all" else args.levels.split(",")
    h, w = (int(v) for v in args.resolution.split("x"))
    i, n = (int(v) for v in args.shard.split("/"))
    results = sweep_perturbation_levels(
        data_root=args.data_root, dataset=args.dataset, levels=levels,
        max_scenes=args.max_scenes, max_frames=args.max_frames,
        max_objects=args.max_objects, batchsize=args.batchsize,
        nb_iterations=args.iterations, resolution=(h, w), mesh_path=args.mesh_path,
        bop_root=args.bop_root, models_dir=args.models_dir, seed=args.seed,
        shard=(i, n), optimizer=args.optimizer, base_lr=args.base_lr,
        lr_bounds=_floats(args.lr_bounds), loss_weights=_floats(args.loss_weights),
        init_jitter=_floats(args.init_jitter), restarts=args.restarts,
        restart_jitter=_floats(args.restart_jitter), argmin_rule=args.argmin_rule,
        device=args.device,
    )

    print()
    print(f"{'level':24s} {'n':>4s} {'ADD mean':>10s} {'ADD med':>10s} "
          f"{'acc@0.1d':>9s} {'AUC@0.1d':>9s} {'S-acc@0.1d':>10s} "
          f"{'init-acc':>9s}  mode")
    for level, r in results.items():
        init_acc = r.get("acc_01d_init")
        print(f"{level:24s} {r['n']:4d} {r['add_mean']:10.4f} "
              f"{r['add_med']:10.4f} {r['acc_01d']:9.3f} {r['auc_01d']:9.3f}"
              f" {r.get('adds_acc_01d', float('nan')):10.3f}"
              f" {init_acc if init_acc is None else format(init_acc, '9.3f')}"
              f"  {r['mode']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"\nwrote {args.out}")
    return results


if __name__ == "__main__":
    main()
