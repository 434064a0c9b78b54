#!/usr/bin/env python3
"""What the back-face cull changes in the port's renders (the counterpart
of ``tools/cull_ab.py``).

    python tools/port_cull_ab.py

Needs the card.  For each mesh, B=8 poses at 400x400 (the gt pose, 0.8
rad about (0.2, 1, 0.1) two units in front of the camera, and seven
bench-style perturbations of 8 degrees and 2 cm, ``default_rng(0)``, as
``tools/cull_ab.py`` draws them) are rendered through ``render_batch``
(the uniform-K table, K7, no pair dropped) with ``cull_backfaces`` False
and True.  Per pose it prints the foreground pixels, the pixels whose ids
differ, the pixels whose rgb differs by more than 1e-6, and the largest
rgb difference; then one JSON line a mesh.

The meshes: the four ``data/standins/*.ply`` (closed and oriented: a
back face never wins the f64 depth test there, so a difference is the
f32 z test's misorder, F1), each centred, scaled to a radius of 0.4 and
coloured by position; and an icosphere(4) with the faces of a polar cap
(z > 0.7 on the unit sphere) removed, where a ray through the hole hits
the inside: a back face that is the nearest surface and that the cull
drops (the change it makes on a mesh that is not closed).
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

RES = (400, 400)
B = 8
#: bins as wide as the fullest tile can need at these poses
MAX_TRIS_PER_TILE = 2048


def meshes():
    """(label, Mesh) of each stand-in and of the open icosphere."""
    from diffdope_tpu_torch.mesh import load_ply, mesh_from_arrays
    from diffdope_tpu_torch.testing import icosphere

    root = Path(__file__).resolve().parent.parent / "data" / "standins"
    out = []
    for path in sorted(root.glob("*.ply")):
        data = load_ply(path)
        v = data["vertices"].astype(np.float64)
        v = v - 0.5 * (v.min(0) + v.max(0))
        v = (0.4 * v / np.linalg.norm(v, axis=1).max()).astype(np.float32)
        out.append((path.name, mesh_from_arrays(v, data["faces"], colors=v / 0.8 + 0.5)))
    v, f = icosphere(4)
    keep = ~(v[f][:, :, 2] > 0.7).all(axis=1)
    out.append(("icosphere(4), cap z > 0.7 removed",
                mesh_from_arrays(v * 0.4, f[keep], colors=v * 0.5 + 0.5)))
    return out


def poses():
    """(B, 4, 4) float32: the gt pose and seven perturbations of it."""
    import torch

    from diffdope_tpu_torch import geometry as geo

    rng = np.random.default_rng(0)
    q_gt = geo.quat_from_axis_angle(np.array([0.2, 1.0, 0.1]), 0.8)
    t_gt = np.array([0.0, 0.0, -2.0], np.float32)
    qs, ts = [q_gt], [t_gt]
    for _ in range(B - 1):
        dq = geo.quat_from_axis_angle(rng.normal(size=3), np.deg2rad(8.0))
        qs.append(geo.quat_multiply_np(dq, q_gt))
        ts.append(t_gt + rng.normal(size=3).astype(np.float32) * 0.02)
    q = torch.as_tensor(np.stack(qs), dtype=torch.float32)
    t = torch.as_tensor(np.stack(ts), dtype=torch.float32)
    return geo.matrix44_from_quat_trans(geo.quat_normalize(q), t)


def measure(mesh, mtx, resolution=RES, device="cuda") -> dict:
    """The culled render against the unculled one, per pose."""
    import torch

    from diffdope_tpu_torch import geometry as geo
    from diffdope_tpu_torch.render.pipeline import render_batch

    h, w = resolution
    f = 1.2 * max(h, w)
    proj = geo.projection_from_intrinsics(f, f, w / 2, h / 2, w, h, 0.01, 100.0)
    out = {}
    for cull in (False, True):
        with torch.no_grad():
            r = render_batch(proj, mtx.to(device), mesh.pos, mesh.pos_idx, resolution,
                             vtx_color=mesh.vtx_color, edge_adj=mesh.edge_adj,
                             max_tris_per_tile=MAX_TRIS_PER_TILE, cull_backfaces=cull,
                             raster_impl="pallas", return_rast_out=True, device=device)
        if int(r["_bin_overflow"]):
            raise RuntimeError(f"{int(r['_bin_overflow'])} (tile, triangle) pairs dropped")
        # rast_out's last channel is the winning triangle's id + 1 (0: none)
        out[cull] = {"ids": r["rast_out"][..., 3].cpu().numpy(),
                     "rgb": r["rgb"].cpu().numpy()}
    a, b = out[False], out[True]
    drgb = np.abs(a["rgb"] - b["rgb"]).max(axis=-1)
    return {
        "closed": bool(mesh.is_closed), "oriented": bool(mesh.is_oriented),
        "triangles": int(mesh.num_triangles),
        "fg_px": (a["ids"] > 0).sum(axis=(1, 2)).tolist(),
        "ids_diff_px": (a["ids"] != b["ids"]).sum(axis=(1, 2)).tolist(),
        "rgb_diff_px": (drgb > 1e-6).sum(axis=(1, 2)).tolist(),
        "max_rgb_diff": drgb.max(axis=(1, 2)).astype(float).tolist(),
    }


def main() -> None:
    import torch

    from diffdope_tpu_torch.bench import card

    if not torch.cuda.is_available():
        sys.exit("port_cull_ab: no CUDA device (the renders run on the card)")
    gpu = card()
    mtx = poses()
    print(f"card: {gpu}", flush=True)
    for label, mesh in meshes():
        row = measure(mesh, mtx)
        print(f"{label}: closed={row['closed']} oriented={row['oriented']} "
              f"triangles={row['triangles']}")
        print("pose  fg_px  ids_diff_px  rgb_diff_px  max|drgb|")
        for i in range(B):
            print(f"{i:4d} {row['fg_px'][i]:6d} {row['ids_diff_px'][i]:12d} "
                  f"{row['rgb_diff_px'][i]:12d}  {row['max_rgb_diff'][i]:.6g}")
        print(json.dumps({"mesh": label, "card": gpu, "resolution": list(RES), **row}),
              flush=True)


if __name__ == "__main__":
    main()
