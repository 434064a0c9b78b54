"""Refine a pose with the hypothesis batch sharded over ranks.

Counterpart of ``examples/multichip_refine.py``: B hypotheses spread over
N ranks (``parallel.refine_sharded``), no traffic between them inside a
step but the all-reduces of the bins' union and of the logged loss.  One
process a rank, launched
by torchrun:

    torchrun --nproc-per-node N -m diffdope_tpu_torch.examples.multichip_refine \\
        [--batchsize 64] [--iterations 50] [--resolution 400x400] [--mesh-path MESH] \\
        [--out RESULT.npz]

(``python -m torch.distributed.run`` is the same launcher).  Each rank
takes the card of its local rank when there are N cards (NCCL), else the
ranks share the card, or run on the CPU with ``--device cpu`` (gloo).
The problem is the JAX script's: the mesh at ``--mesh-path`` (scale 0.01),
else an icosphere(3) of radius 0.4; the gt pose 0.8 rad about (0.2, 1,
0.1), 2 units in front of the camera; the init 8 degrees and (0.02,
-0.015, 0.04) away; rgb + mask L1, loss scales in [0.5, 4], Adam at base
lr 0.02.  Rank 0 prints the result, and with ``--out`` writes the
global loss and pose histories at full precision.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batchsize", type=int, default=64)
    ap.add_argument("--iterations", type=int, default=50)
    ap.add_argument("--resolution", default="400x400")
    ap.add_argument("--devices", type=int, default=None,
                    help="number of ranks (default: the launcher's world size)")
    ap.add_argument("--mesh-path", default=None,
                    help="PLY/OBJ/STL/glTF path (default: a synthetic icosphere)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (each rank's card) or 'cpu'")
    ap.add_argument("--out", default=None,
                    help="rank 0 writes total_loss, mtx_history and the best "
                         "hypothesis here (.npz)")
    return ap.parse_args(argv)


def build_problem(args, device):
    """The JAX script's problem on ``device``: (params0, render_fn,
    loss_fns, gt, learning_rates, weights)."""
    from diffdope_tpu_torch import geometry as geo
    from diffdope_tpu_torch.convert import tensor
    from diffdope_tpu_torch.losses import select_losses
    from diffdope_tpu_torch.optimize import draw_learning_rates, pose_matrix, pose_params
    from diffdope_tpu_torch.render.pipeline import render_batch

    h, w = (int(x) for x in args.resolution.split("x"))
    f = 1.2 * max(h, w)
    proj = geo.projection_from_intrinsics(f, f, w / 2, h / 2, w, h, 0.01, 100.0)
    if args.mesh_path and Path(args.mesh_path).exists():
        from diffdope_tpu_torch.mesh import load_mesh

        m = load_mesh(args.mesh_path, scale=0.01, vertex_pad=128, triangle_pad=128)
        pos, tri, edge_adj = m.pos, m.pos_idx, m.edge_adj
        color_kw = (dict(corner_colors=m.corner_colors) if m.corner_colors is not None
                    else dict(vtx_color=m.vtx_color))
        cull = bool(m.is_closed and m.is_oriented)
    else:
        from diffdope_tpu_torch.mesh import build_edge_adjacency
        from diffdope_tpu_torch.testing import icosphere

        v, fc = icosphere(3)
        pos, tri, edge_adj = v * 0.4, fc, build_edge_adjacency(fc)
        color_kw = dict(vtx_color=(v * 0.5 + 0.5).astype(np.float32))
        cull = True

    # the mesh on the device once: a step then copies no host data (a step
    # that does cannot be captured as a CUDA graph)
    proj, pos = tensor(proj, device), tensor(pos, device)
    tri, edge_adj = tensor(tri, device, torch.int64), tensor(edge_adj, device, torch.int64)
    color_kw = {k: tensor(v, device) for k, v in color_kw.items()}

    def render_fn(mtx):
        return render_batch(proj, mtx, pos, tri, (h, w), edge_adj=edge_adj,
                            raster_impl="pallas", cull_backfaces=cull, device=device,
                            **color_kw)

    rng = np.random.default_rng(0)
    q_gt = geo.quat_from_axis_angle(np.array([0.2, 1.0, 0.1]), 0.8)
    t_gt = np.array([0.0, 0.0, -2.0], np.float32)
    with torch.no_grad():
        r = render_fn(pose_matrix(pose_params(q_gt, t_gt, 1, device))[0])
    gt = {"rgb": r["rgb"][0], "segmentation": r["mask"][0], "depth": r["depth"][0]}

    dq = geo.quat_from_axis_angle(rng.normal(size=3), np.deg2rad(8.0))
    q0 = geo.quat_multiply(torch.as_tensor(dq, dtype=torch.float32),
                           torch.as_tensor(q_gt, dtype=torch.float32)).numpy()
    t0 = t_gt + np.array([0.02, -0.015, 0.04], np.float32)
    params0 = pose_params(q0, t0, args.batchsize, device)
    loss_fns, weights = select_losses({"l1_mask": True, "weight_mask": 1.0,
                                       "l1_rgb_with_mask": True, "weight_rgb": 0.7})
    lrs = draw_learning_rates(0, args.batchsize, (0.5, 4.0), device)
    return params0, render_fn, loss_fns, gt, lrs, weights


#: the refinement's settings (the JAX script's)
REFINE_KW = dict(base_lr=0.02, lr_decay=0.1, optimizer="adam")


def main(argv=None):
    """Run on this rank; returns the (global) RefineResult and the wall
    seconds of the refinement."""
    args = parse_args(sys.argv[1:] if argv is None else list(argv))
    import torch.distributed as dist

    from diffdope_tpu_torch.optimize import argmin_hypothesis, pose_matrix
    from diffdope_tpu_torch.parallel import hypothesis_mesh, refine_sharded

    mesh = hypothesis_mesh(n_devices=args.devices, device=args.device)
    n = mesh.size
    problem = build_problem(args, mesh.device)
    if mesh.rank == 0:
        print(f"mesh: {n} rank(s) x {args.batchsize // n} hypotheses/rank "
              f"({mesh.device}, {dist.get_backend()})", flush=True)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    sync()
    t0 = time.perf_counter()
    result = refine_sharded(*problem, mesh, nb_iterations=args.iterations, **REFINE_KW)
    sync()
    wall = time.perf_counter() - t0

    if mesh.rank == 0:
        best = int(argmin_hypothesis(result.losses_values))
        final = float(result.total_loss[-1])
        print(f"{args.iterations} steps on {n} rank(s): {wall:.4f}s (kernel build "
              "excluded, first launches included)", flush=True)
        print(f"best hypothesis {best}, final loss {final:.5f}", flush=True)
        mtx, _, _ = pose_matrix(result.params)
        print("refined pose (OpenGL frame):")
        print(mtx[best].cpu().numpy(), flush=True)
        if args.out:
            np.savez(args.out, total_loss=result.total_loss.cpu().numpy(),
                     mtx_history=result.mtx_history.cpu().numpy(), best=best)
    return result, wall


if __name__ == "__main__":
    main()
    import torch.distributed as dist

    dist.destroy_process_group()
