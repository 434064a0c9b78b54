"""DiffDope at the default configuration on each raster route, with and
without the back-face cull: per-hypothesis losses at the first and last
step, the loss scales, and the ADD of the init and of ``get_pose()``;
and what the cull changes in a render of the stand-in at the gt pose.

    python tools/port_planar_trajectories.py

Needs the card.  The runs are ``chip_smoke.diffdope_phase``'s sessions
(960x540, B=8, 61 SGD steps, mask L1, the stand-in mesh, the init
``chip_smoke.INIT_OFFSET`` off); prints one JSON line per run, then one
for the render (``cull_setting`` is the session's; the v3 route applies
no cull whatever it says).  It shows how far the cull (``tpu.cull_backfaces: auto``,
on for the closed, oriented stand-in) moves a run from the cull-free
planar route of ``DD_RASTER=v3``, whose scene is rendered without a cull
too.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def main() -> None:
    import torch

    from diffdope_tpu_torch.bench import card, raster_env

    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device")
    gpu = card()
    runs = (("compact", None, {}), ("compact, no cull", None, {"cull_backfaces": False}),
            ("uniform, no cull", None, {"compact_bins": False, "cull_backfaces": False}),
            ("v3", "v3", {}), ("v2", "v2", {}), ("v2, no cull", "v2", {"cull_backfaces": False}))
    for label, route, tpu in runs:
        dd, points, mtx_gt = chip_smoke.diffdope_session(True, tpu=tpu)
        with raster_env(route):
            dd.run_optimization()
        mask = dd.losses_values["mask_selection"]
        total = dd._result.total_loss.cpu().numpy()
        print(json.dumps({
            "run": label, "card": gpu, "cull_setting": dd._resolve_cull(),
            "loss_scales": dd.learning_rates.cpu().numpy().round(4).tolist(),
            "total_first": float(total[0]), "total_last": float(total[-1]),
            "mask_first": mask[0].tolist(), "mask_last": mask[-1].tolist(),
            "argmin": dd.get_argmin(),
            "add_init": chip_smoke.add_to(points, mtx_gt, dd.object3d.initial_matrix()),
            "add_pose": chip_smoke.add_to(points, mtx_gt, dd.get_pose()),
        }), flush=True)
    print(json.dumps(cull_effect(dd, mtx_gt, gpu)), flush=True)


def cull_effect(dd, mtx_gt, gpu) -> dict:
    """The stand-in rendered at the gt pose with and without the cull
    (``render_batch``, compact table, every pair binned): foreground
    pixels, ids that differ, and the share of the unculled render's
    winning triangles whose determinant is not positive (back-facing by
    the cull's rule)."""
    import torch

    from diffdope_tpu_torch.geometry import matmul44
    from diffdope_tpu_torch.render.pipeline import compact_capacity, render_batch
    from diffdope_tpu_torch.render.planar import corner_planes, det_planar

    mesh = dd.object3d.mesh
    res, t_all = tuple(dd.resolution), len(mesh.pos_idx)
    proj = torch.as_tensor(dd.camera.cam_proj, device="cuda")
    cap = compact_capacity(proj, mesh.pos, mesh.pos_idx, mtx_gt, res, t_all)
    with torch.no_grad():
        ids = [render_batch(proj, mtx_gt, mesh.pos, mesh.pos_idx, res,
                            vtx_color=mesh.vtx_color, edge_adj=mesh.edge_adj,
                            max_tris_per_tile=t_all, compact_total=cap, cull_backfaces=cull,
                            layout="channels")["ids"] for cull in (False, True)]
        pos_c = torch.as_tensor(mesh.pos, device="cuda")[
            torch.as_tensor(mesh.pos_idx, device="cuda").long().reshape(-1)]
        det = det_planar(corner_planes(pos_c, matmul44(proj, mtx_gt.cuda().reshape(1, 4, 4))))
    won = ids[0][ids[0] > 0].long() - 1
    return {"render": "gt pose, with and without the cull", "card": gpu,
            "closed": bool(mesh.is_closed), "oriented": bool(mesh.is_oriented),
            "fg_px": [int((i > 0).sum()) for i in ids],
            "ids_differ": int((ids[0] != ids[1]).sum()),
            "won_det_not_positive": float((det[0, won] <= 0).float().mean())}


if __name__ == "__main__":
    main()
