"""Bin capacities of the PyTorch port's DiffDope on the default configuration.

The capacities (per-tile K, compact table size) are probed at the init;
the batch's bins are a union over the hypotheses, so they grow as the
hypotheses spread.  This study asks, for a few inits of ``chip_smoke.py``'s
default-configuration scene, how far they grow, and whether the JAX
reference's own rules (its tiles, chunk, probe and ROI crop) would drop
pairs or leak out of the crop on the same trajectory.

    # on the card (the port only): the exact trajectory of each init (no
    # capacity to drop, no crop), then the default-rule run
    python tools/port_capacity_study.py trajectories build/capacity

    # on the CPU (the reference, JAX): both packages' rules along each
    # saved trajectory, binning only
    JAX_PLATFORMS=cpu python tools/port_capacity_study.py rules build/capacity

The exact trajectory stands for the reference's: both compute the same
loss, so their trajectories agree until a capacity drops pairs (tests/
test_torch_diffdope.py holds them together on a small scene).  Each part
prints one JSON line per init.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: inits, as chip_smoke.INIT_OFFSET: OpenCV-frame translation (mm) and a
#: rotation about an axis
INITS = {
    "rot4y": {"translation_mm": [0.0, 0.0, 0.0], "degrees": 4.0, "axis": [0.0, 1.0, 0.0]},
    "x5mm": {"translation_mm": [5.0, 0.0, 0.0], "degrees": 0.0, "axis": [0.0, 1.0, 0.0]},
    "x5mm_rot4y": {"translation_mm": [5.0, 0.0, 0.0], "degrees": 4.0,
                   "axis": [0.0, 1.0, 0.0]},
    "xy5mm_rot4y": {"translation_mm": [5.0, -5.0, 0.0], "degrees": 4.0,
                    "axis": [0.0, 1.0, 0.0]},
}
#: the exact run's table: more slots than any step needs (checked)
EXACT_TOTAL = 1 << 19


def trajectories(out: Path) -> None:
    import numpy as np
    import torch

    import chip_smoke
    from diffdope_tpu_torch.render.pipeline import CAPACITY_SLACK

    out.mkdir(parents=True, exist_ok=True)
    for name, offset in INITS.items():
        row = {"init": name, "offset": offset}
        exact = {"compact_total": EXACT_TOTAL, "roi_crop": "off",
                 "overflow_recovery": False}
        dd, points, mtx_gt = chip_smoke.diffdope_session(True, offset, exact)
        dd.max_tris_per_tile = len(dd.object3d.mesh.pos_idx)
        dd.run_optimization()
        tel = {k: v.cpu().numpy() for k, v in dd._result.telemetry.items()}
        if tel["_bin_overflow"].max() != 0:
            raise SystemExit(f"{name}: the exact run dropped pairs")
        gt_mask = dd.gt_tensors["segmentation"][..., 0] > 0
        np.savez(out / f"{name}.npz", mtx_history=dd.mtx_history,
                 need=tel["_bin_need"], tile_max=tel["_bin_max"],
                 total_loss=dd._result.total_loss.cpu().numpy(),
                 proj=np.asarray(dd.camera.cam_proj, np.float32),
                 pos=np.asarray(dd.object3d.mesh.pos),
                 pos_idx=np.asarray(dd.object3d.mesh.pos_idx), gt_mask=gt_mask,
                 resolution=np.asarray(dd.resolution))
        row["exact"] = {
            "need_step0": int(tel["_bin_need"][0]), "need_max": int(tel["_bin_need"].max()),
            "tile_max_step0": int(tel["_bin_max"][0]),
            "tile_max": int(tel["_bin_max"].max()),
            "loss": [float(dd._result.total_loss[0]), float(dd._result.total_loss[-1])],
            "add": [chip_smoke.add_to(points, mtx_gt, dd.object3d.initial_matrix()),
                    chip_smoke.add_to(points, mtx_gt, dd.get_pose())],
        }
        for label, tpu in (("first_run", {"overflow_recovery": False}), ("default", {})):
            dd, points, mtx_gt = chip_smoke.diffdope_session(True, offset, tpu)
            dd.run_optimization()
            tel = {k: v.cpu().numpy() for k, v in dd._result.telemetry.items()}
            row[label] = {
                "reruns": dd.last_run_stats["recovery_reruns"],
                "overflow_max": int(tel["_bin_overflow"].max()),
                "overflow_steps": int((tel["_bin_overflow"] > 0).sum()),
                "leak_max": int(tel.get("_crop_leak", np.zeros(1)).max()),
                "need_max": int(tel["_bin_need"].max()),
                "slots_seen": getattr(dd, "_slots_seen", 0),
                "crop_disabled": getattr(dd, "_crop_disable", False),
                "add": chip_smoke.add_to(points, mtx_gt, dd.get_pose()),
                "loss": [float(dd._result.total_loss[0]), float(dd._result.total_loss[-1])],
            }
        row["capacity_slack"] = CAPACITY_SLACK
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()


def _reference_rules(z, tile_hw=(32, 128), margin=24):
    """The reference's rules (diffdope.py:222-316, pipeline.py:548-579 and
    :650-695) at its default tiles, along the saved trajectory."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from diffdope_tpu.render.planar import (
        _xbounds_ndc,
        _ybounds_ndc,
        bin_triangles_planar,
        compact_bins,
        corner_planes,
        det_planar,
    )
    from diffdope_tpu.render.raster_v2 import _pick_chunk

    h, w = (int(v) for v in z["resolution"])
    th, tw = tile_hw
    pos_idx = z["pos_idx"]
    t_count = len(pos_idx)
    pos_c = jnp.asarray(z["pos"][pos_idx.reshape(-1)])
    proj = jnp.asarray(z["proj"])
    degenerate = jnp.asarray((pos_idx[:, 0] == pos_idx[:, 1]) | (pos_idx[:, 1] == pos_idx[:, 2])
                             | (pos_idx[:, 2] == pos_idx[:, 0]))

    def planes(mtx):
        mvp = jnp.einsum("...ij,...jk->...ik", proj[None], jnp.asarray(mtx),
                         precision="highest")
        return corner_planes(pos_c, mvp)

    # the probe at the init (no culling, as _resolve_max_tris measures)
    cp0 = planes(z["mtx_history"][0][:1])
    _, c0, _ = bin_triangles_planar(cp0, det_planar(cp0), (h, w), tile_hw, t_count)
    probe_max = int(c0.max())
    k = min(t_count, max(512, -(-int(probe_max * 1.5) // 128) * 128))
    kc = _pick_chunk(k)
    _, c0, _ = bin_triangles_planar(cp0, det_planar(cp0), (h, w), tile_hw, k)
    tot0 = int(jnp.sum(-(-c0 // kc) * kc))
    total = -(-int(tot0 * 1.35 + kc) // kc) * kc

    # the crop window from the gt mask, aligned to the reference's tiles
    hp, wp = -(-h // th) * th, -(-w // 128) * 128
    seg = z["gt_mask"]
    rows_any, cols_any = seg.any(axis=1), seg.any(axis=0)
    r0, r1 = int(np.argmax(rows_any)), int(len(rows_any) - np.argmax(rows_any[::-1]))
    c0_, c1 = int(np.argmax(cols_any)), int(len(cols_any) - np.argmax(cols_any[::-1]))
    oy, ox = max(0, r0 - margin) // th * th, max(0, c0_ - margin) // 128 * 128
    hc = min(hp, -(-(r1 + margin - oy) // th) * th)
    wc = min(wp, -(-(c1 + margin - ox) // 128) * 128)
    ntx = wp // tw
    tiles = (np.arange(hp // th)[oy // th:(oy + hc) // th, None] * ntx
             + np.arange(ntx)[None, ox // tw:(ox + wc) // tw]).reshape(-1)

    @jax.jit
    def step(mtx):
        cp = planes(mtx)
        det = det_planar(cp, degenerate)
        idx, counts, tile_ovf = bin_triangles_planar(cp, det, (h, w), tile_hw, k,
                                                     cull_backfaces=True)
        need_full = jnp.sum(-(-counts // kc) * kc) + tile_ovf
        table_ovf_crop = compact_bins(idx[tiles], counts[tiles], t_count, kc, total)[3]
        table_ovf_full = compact_bins(idx, counts, t_count, kc, total)[3]
        xlo, xhi = _xbounds_ndc(cp, degenerate)
        ylo, yhi = _ybounds_ndc(cp, degenerate)
        px_lo, px_hi = (xlo + 1.0) * (w / 2.0) - 0.5, (xhi + 1.0) * (w / 2.0) - 0.5
        py_lo, py_hi = (ylo + 1.0) * (h / 2.0) - 0.5, (yhi + 1.0) * (h / 2.0) - 0.5
        bx_lo = float(ox + 2) if ox > 0 else -1e9
        bx_hi = float(ox + wc - 3) if ox + wc < w else 1e9
        by_lo = float(oy + 2) if oy > 0 else -1e9
        by_hi = float(oy + hc - 3) if oy + hc < h else 1e9
        leak = jnp.sum((xlo <= xhi) & ((px_lo < bx_lo) | (px_hi > bx_hi)
                                       | (py_lo < by_lo) | (py_hi > by_hi)))
        return (tile_ovf, tile_ovf + table_ovf_crop, leak, tile_ovf + table_ovf_full,
                need_full, counts.max())

    per_step = np.array([[int(v) for v in step(m)] for m in z["mtx_history"]])
    return _summary(per_step, {"tiles": list(tile_hw), "K": k, "chunk": kc,
                               "probe_fullest_tile": probe_max,
                               "probe_slots": tot0, "capacity": total,
                               "crop": [oy, ox, hc, wc]})


def _port_rules(z, margins=None, crop_align=None):
    """The port's rules (DiffDope._resolve_max_tris / _resolve_compact_total,
    pipeline.crop_window) on its 16x16 tiles, along the saved trajectory:
    ``margins`` (per tile, table) over the probe default to DiffDope's;
    ``crop_align`` (rows, cols) widens the crop window to that alignment."""
    import numpy as np
    import torch

    from diffdope_tpu_torch.diffdope import TABLE_MARGIN, TILE_MARGIN
    from diffdope_tpu_torch.render import pipeline as pl

    tile_margin, table_margin = margins or (TILE_MARGIN, TABLE_MARGIN)

    h, w = (int(v) for v in z["resolution"])
    t_count = len(z["pos_idx"])
    mtx_hist = torch.as_tensor(z["mtx_history"])
    max_count = pl.max_tile_count(z["proj"], z["pos"], z["pos_idx"], mtx_hist[0][:1],
                                  (h, w), "cpu")
    k = min(t_count, max(512, -(-int(max_count * tile_margin) // 128) * 128))
    total = pl.compact_capacity(z["proj"], z["pos"], z["pos_idx"], mtx_hist[0][:1],
                                (h, w), k, 1.0, "cpu", table_margin)
    window = pl.crop_window(z["gt_mask"].astype(np.float32), (h, w))
    if crop_align is not None:
        ah, aw = crop_align
        oy, ox, hc, wc = window
        hp, wp = pl._padded((h, w))
        oy2, ox2 = oy // ah * ah, ox // aw * aw
        window = (oy2, ox2, min(hp - oy2, -(-(oy + hc - oy2) // ah) * ah),
                  min(wp - ox2, -(-(ox + wc - ox2) // aw) * aw))
    mesh = pl._Mesh(z["proj"], z["pos"], z["pos_idx"], None, None, None,
                    torch.device("cpu"))
    crop = pl._Crop(window, (h, w), torch.device("cpu"))
    probe = pl._binned(mesh, mtx_hist[0][:1], (h, w), None, None, False, k)
    rows = []
    with torch.no_grad():
        for m in mtx_hist:
            exact = pl._binned(mesh, m, (h, w), None, None, True, k).telemetry
            crop_run = pl._binned(mesh, m, (h, w), total, crop, True, k).telemetry
            full_run = pl._binned(mesh, m, (h, w), total, None, True, k).telemetry
            rows.append([int(exact["_bin_overflow"]), int(crop_run["_bin_overflow"]),
                         int(crop_run["_crop_leak"]), int(full_run["_bin_overflow"]),
                         int(exact["_bin_need"]), int(exact["_bin_max"])])
    per_step = np.array(rows)
    return _summary(per_step, {"tiles": list(pl.TILE_HW), "K": k, "chunk": pl.K_CHUNK,
                               "probe_fullest_tile": max_count,
                               "probe_slots": int(probe.telemetry["_bin_need"]),
                               "capacity": total,
                               "crop": list(window)})


def _summary(per_step, rules):
    """First step and worst value of each column along the trajectory:
    pairs beyond the per-tile K; pairs a run drops with the crop (K and
    the table together); triangles leaking out of the crop; pairs a run
    drops on the full frame (after a leak turns the crop off); the slots a
    full-frame table needs; the fullest tile."""
    import numpy as np

    names = ("tile_overflow", "run_overflow_cropped", "crop_leak",
             "run_overflow_full_frame", "slots_needed", "fullest_tile")
    out = dict(rules)
    for col, name in enumerate(names):
        hit = np.nonzero(per_step[:, col] > 0)[0]
        out[name] = {"first_step": int(hit[0]) if len(hit) else None,
                     "step0": int(per_step[0, col]), "max": int(per_step[:, col].max())}
    return out


def rules(out: Path) -> None:
    import numpy as np

    for path in sorted(out.glob("*.npz")):
        z = dict(np.load(path))
        row = {"init": path.stem,
               "reference": _reference_rules(z),
               "port": _port_rules(z),
               "port_reference_margins": _port_rules(z, (1.5, 1.35)),
               "port_crop_32x128": _port_rules(z, crop_align=(32, 128))}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    if len(sys.argv) != 3 or sys.argv[1] not in ("trajectories", "rules"):
        raise SystemExit(__doc__)
    {"trajectories": trajectories, "rules": rules}[sys.argv[1]](Path(sys.argv[2]))
