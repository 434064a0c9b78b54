"""BOP evaluation: refine every object of a scene frame, and sweep the
perturbation levels (counterpart of ``diffdope_tpu/bop.py``).

Given a BOP-format scene directory (rgb/, depth/, mask_visib/,
scene_camera.json), a models directory (obj_XXXXXX.ply) and per-frame
perturbed poses ({frame: [{cam_R_m2c (9), cam_t_m2c (3), obj_id}]}),
:func:`refine_bop_frame` refines each object through :class:`DiffDope`
and returns the refined poses in the OpenCV/BOP frame.
:func:`sweep_perturbation_levels` walks the perturbation JSONs level by
level, on real BOP images (``bop_root``) or on scenes it synthesizes
with a stand-in mesh, and aggregates ADD(-S), its AUC and the init's own
score as the control.

The synthesized branch builds one fused loss per configuration with the
ground truth deferred (``make_fused_loss(gt=None)``): every object's
rendered ground truth is fed per call, on the full frame.  On the card
the compact bin table is sized from a probe of 16 poses, as the
reference sizes its own; off the card the uniform-K table runs, as the
reference runs it off the TPU (``bop.py:315-368``).

Neither ``data_root`` nor the synthesized branch's ``mesh_path`` has a
default: the repo holds no BOP data.  Everything runs on the card unless
``device`` says otherwise.
"""

from __future__ import annotations

import json
import logging
import zlib
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from diffdope_tpu_torch import geometry as geo
from diffdope_tpu_torch.camera import Camera
from diffdope_tpu_torch.config import ConfigNode
from diffdope_tpu_torch.diffdope import DiffDope
from diffdope_tpu_torch.image import Image, Scene
from diffdope_tpu_torch.losses import select_losses
from diffdope_tpu_torch.mesh import Mesh, load_mesh
from diffdope_tpu_torch.metrics import (
    add_auc,
    add_metric,
    adds_metric,
    object_diameter,
    subsample_points,
)
from diffdope_tpu_torch.object3d import Object3D
from diffdope_tpu_torch.optimize import (
    POSE_KEYS,
    CapturedRefine,
    apply_pose_jitter,
    argmin_step_hypothesis,
    draw_learning_rates,
    draw_pose_jitter,
    pose_matrix,
    pose_params,
    refine_with_restarts,
)
from diffdope_tpu_torch.render.pipeline import (
    K_CHUNK,
    TILE_HW,
    compact_capacity,
    make_fused_loss,
    render_rgb_mask,
)

log = logging.getLogger(__name__)


PERTURBATION_LEVELS = (
    "deg_001_trans_001", "deg_010_trans_004", "deg_040_trans_016",
)
#: the per-tile cap the synthesized branch starts from, before the overflow
#: recovery's boost (``bop.py:371``)
BASE_TILE_CAP = 1024
#: the compact table's margin over the probe's need (``bop.py:358-360``)
PROBE_SLACK = 1.3


def parse_level(level: str):
    """'deg_010_trans_004' -> (10.0, 4.0): the rotation error in degrees
    and the translation error in the perturbation JSONs' unit; the
    synthesized branch applies the latter as ``value * obj_scale`` working
    units (``bop.py:40-48``)."""
    parts = level.split("_")
    return float(parts[1]), float(parts[3])


def find_error_scenes(data_root, dataset: str):
    """[(scene_id, {level: json_path})] of the perturbation JSONs under
    ``data_root/dataset/<split>/<scene>/scene_error_<level>.json``,
    scene_id 'split/scene', both sorted."""
    root = Path(data_root) / dataset
    out = []
    for split_dir in sorted(root.iterdir()):
        if not split_dir.is_dir():
            continue
        for scene_dir in sorted(split_dir.iterdir()):
            levels = {}
            for lv in PERTURBATION_LEVELS:
                p = scene_dir / f"scene_error_{lv}.json"
                if p.exists():
                    levels[lv] = p
            if levels:
                out.append((f"{split_dir.name}/{scene_dir.name}", levels))
    return out


def sweep_perturbation_levels(
    data_root,
    dataset: str = "hope",
    levels=None,
    max_scenes: int = 1,
    max_frames: int = 1,
    max_objects: int = 3,
    batchsize: int = 16,
    nb_iterations: int = 40,
    resolution=(160, 160),
    obj_scale: float = 0.01,
    mesh_path=None,
    bop_root=None,
    models_dir=None,
    cfg: Optional[ConfigNode] = None,
    seed: int = 0,
    shard=(0, 1),
    log_fn=print,
    optimizer: str = "adam",
    base_lr: float = 0.02,
    lr_bounds=(0.5, 4.0),
    loss_weights=(0.7, 0.0, 1.0),
    init_jitter=(0.0, 0.0),
    restarts: int = 0,
    restart_jitter=(10.0, 0.02),
    argmin_rule: str = "best_step",
    device="cuda",
) -> Dict[str, dict]:
    """Sweep the perturbation JSONs under ``data_root`` and aggregate
    ADD(-S) and its AUC per level (``bop.py:70-207``).

    With ``bop_root`` (a real BOP dataset root: <split>/<scene>/ with rgb/,
    mask_visib/, scene_gt.json, and models/ unless ``models_dir``) the JSON
    pose is the init and scene_gt.json the ground truth.  Without it the
    branch is synthesized: the JSON rotation is the ground truth at a fixed
    distance, its image rendered with the stand-in ``mesh_path``, and the
    init is the ground truth perturbed by the level's own magnitudes.
    ``shard=(i, n)`` takes every n-th scene from the i-th.

    Returns {level: {'n', 'mode', 'add_mean', 'add_med', 'acc_01d',
    'auc_01d', 'adds_acc_01d', 'adds_auc_01d', 'add_init_mean',
    'acc_01d_init', 'per_object'}}; the init columns are the control
    (the refiner must not lose what the init already had)."""
    if bop_root is None and mesh_path is None:
        raise ValueError("the synthesized sweep needs mesh_path (a stand-in mesh)")
    levels = list(levels or PERTURBATION_LEVELS)
    scenes = find_error_scenes(data_root, dataset)
    scenes = scenes[shard[0] :: shard[1]][:max_scenes]
    if not scenes:
        raise FileNotFoundError(f"no perturbation JSONs under {data_root}/{dataset}")

    results: Dict[str, dict] = {}
    mesh_cache: Dict[int, Mesh] = {}
    for level in levels:
        per_object = []
        for scene_id, level_paths in scenes:
            if level not in level_paths:
                continue
            with open(level_paths[level]) as f:
                frames = json.load(f)
            for frame in sorted(frames, key=lambda s: int(s))[:max_frames]:
                objs = frames[frame][:max_objects] if max_objects else frames[frame]
                if bop_root is not None:
                    per_object.extend(_sweep_real_frame(
                        cfg, bop_root, models_dir, dataset, scene_id, frame,
                        objs, obj_scale, mesh_cache, device,
                    ))
                else:
                    per_object.extend(_sweep_synth_objects(
                        objs, level, scene_id, frame, mesh_path, obj_scale,
                        resolution, batchsize, nb_iterations, seed, log_fn,
                        optimizer, base_lr, lr_bounds, loss_weights,
                        init_jitter, restarts, restart_jitter, argmin_rule, device,
                    ))
        adds = np.asarray([o["add"] for o in per_object], float)
        adds_s = np.asarray([o.get("adds", o["add"]) for o in per_object], float)
        dias = np.asarray([o["diameter"] for o in per_object], float)
        norm = adds / np.maximum(dias, 1e-9)
        norm_s = adds_s / np.maximum(dias, 1e-9)
        add_i = np.asarray([o["add_init"] for o in per_object if "add_init" in o], float)
        norm_i = add_i / np.maximum(dias[: len(add_i)], 1e-9)
        results[level] = {
            "n": len(per_object),
            "mode": "real" if bop_root is not None else "synthesized",
            "add_mean": float(adds.mean()) if len(adds) else float("nan"),
            "add_med": float(np.median(adds)) if len(adds) else float("nan"),
            "acc_01d": float((norm < 0.1).mean()) if len(adds) else float("nan"),
            "auc_01d": add_auc(norm, 0.1) if len(adds) else float("nan"),
            "adds_acc_01d": float((norm_s < 0.1).mean()) if len(adds_s) else float("nan"),
            "adds_auc_01d": add_auc(norm_s, 0.1) if len(adds_s) else float("nan"),
            "add_init_mean": float(add_i.mean()) if len(add_i) else None,
            "acc_01d_init": float((norm_i < 0.1).mean()) if len(add_i) else None,
            "per_object": per_object,
        }
        r = results[level]
        init_note = (f" (init control acc@0.1d={r['acc_01d_init']:.3f})"
                     if r["acc_01d_init"] is not None else "")
        log_fn(f"[{level}] n={r['n']} ADD mean={r['add_mean']:.4f} "
               f"med={r['add_med']:.4f} acc@0.1d={r['acc_01d']:.3f} "
               f"AUC@0.1d={r['auc_01d']:.3f} ADD-S acc@0.1d={r['adds_acc_01d']:.3f}"
               + init_note)
    return results


def _sweep_real_frame(cfg, bop_root, models_dir, dataset, scene_id, frame,
                      objs, obj_scale, mesh_cache, device="cuda"):
    """The real branch: refine against the dataset's images, score against
    scene_gt.json (``bop.py:210-230``); ``bop_root`` is the dataset root,
    so the models are at ``bop_root/models`` unless ``models_dir``."""
    scene_dir = Path(bop_root) / scene_id
    with open(scene_dir / "scene_gt.json") as f:
        gt_objs = json.load(f)[str(int(frame))]
    res = refine_bop_frame(
        cfg if cfg is not None else ConfigNode(), scene_dir,
        Path(models_dir) if models_dir else Path(bop_root) / "models",
        objs, frame=frame, obj_scale=obj_scale, mesh_cache=mesh_cache,
        gt_objs=gt_objs, device=device,
    )
    out = []
    for i_obj, entry in res.items():
        entry = dict(entry)
        entry.update(scene=scene_id, frame=frame, i_obj=int(i_obj))
        out.append(entry)
    return out


def probe_poses(probe_dz: float = 0.2):
    """The capacity probe's 16 poses (``bop.py:349-356``): rotations from
    ``default_rng(0)`` (the first the identity), at z = -2 and, for the
    last 8, at the closest approach the levels reach, -2 + ``probe_dz``;
    (16, 4) quaternions and (16, 3) translations, float32."""
    prng = np.random.default_rng(0)
    qs = prng.normal(size=(16, 4)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    qs[0] = (0.0, 0.0, 0.0, 1.0)
    ts = np.zeros((16, 3), np.float32)
    ts[:, 2] = -2.0
    ts[8:, 2] = -2.0 + probe_dz
    return qs, ts


def _pose_batch(qs, ts, device) -> torch.Tensor:
    """(N, 4, 4) poses of N quaternions and translations."""
    cols = list(np.asarray(qs, np.float32).T) + list(np.asarray(ts, np.float32).T)
    return pose_matrix({k: torch.as_tensor(c, device=device)
                        for k, c in zip(POSE_KEYS, cols)})[0]


def probe_capacity(proj, mesh: Mesh, resolution, boost: float = 1.0,
                   probe_dz: float = 0.2, device="cuda") -> int:
    """The compact table's capacity for a sweep: the largest chunk-rounded
    need of the 16 probe poses (:func:`probe_poses`), each binned alone
    and uncapped on the port's tiles, x ``PROBE_SLACK`` x ``boost``, plus
    a chunk, rounded to the chunk (``bop.py:315-360``, there on 32x128
    tiles): the batch's bins vary with the rotation and grow as the
    object nears the camera, so one canonical pose under-sizes the
    table."""
    mtx = _pose_batch(*probe_poses(probe_dz), device)
    t_count = int(np.asarray(mesh.pos_idx).shape[0])
    return max(compact_capacity(proj, mesh.pos, mesh.pos_idx, mtx[i : i + 1], resolution,
                                t_count, boost, device, PROBE_SLACK)
               for i in range(mtx.shape[0]))


def tile_cap(boost: float, resolution) -> int:
    """The per-tile bin cap at a capacity boost: ``BASE_TILE_CAP`` x boost,
    rounded up to the port's chunk (``bop.py:366-371``, there to its
    128-slot chunk).  The port's tables take any cap up to int32 slot
    ids (a cap past T changes nothing: no tile holds more); past that it
    raises by name rather than truncate."""
    cap = -(-int(BASE_TILE_CAP * boost) // K_CHUNK) * K_CHUNK
    tiles = (-(-resolution[0] // TILE_HW[0])) * (-(-resolution[1] // TILE_HW[1]))
    if tiles * (-(-cap // 128) * 128) >= 2 ** 31:
        raise ValueError(f"max_tris_per_tile {cap} (capacity boost {boost:.3f}) overflows "
                         f"the int32 slot ids of a {tiles}-tile table")
    return cap


def _synth_context(mesh_path, resolution, batchsize, nb_iterations,
                   obj_scale, seed, optimizer="adam", base_lr=0.02,
                   lr_bounds=(0.5, 4.0), loss_weights=(0.7, 0.0, 1.0),
                   init_jitter=(0.0, 0.0), capacity_boost=1.0,
                   roi_crop="auto", probe_dz=0.2, device="cuda"):
    """The sweep's machinery for one configuration, built once and cached
    (``bop.py:233-431``): the stand-in mesh, the ground-truth render, the
    fused loss with its ground truth deferred, the refinement, the scores.
    The refinement ('refine') is one ``optimize.CapturedRefine``, the
    reference's ``jit_refine`` (``bop.py:388-395``): every object, frame,
    level and re-run of the configuration calls it with its own ground
    truth, copied in, and replays one captured step.  The cache keeps one
    context (the reference's keeps every one): a context's capture holds
    its graph's memory pool on the card (``CapturedRefine.pool_bytes``),
    and a recovery's escalated context never returns to the one it
    replaced.

    ``loss_weights`` = (rgb, depth, mask), 0 disabling a term.
    ``capacity_boost`` scales the compact capacity and the per-tile cap,
    and ``roi_crop`` is passed to the loss; the recovery loop of
    :func:`_sweep_synth_objects` escalates both (a deferred loss has no
    crop, so only the boost can act).  ``probe_dz`` is the closest
    approach the probe assumes."""
    device = torch.device(device)
    key = (str(mesh_path), tuple(resolution), batchsize, nb_iterations,
           obj_scale, seed, optimizer, base_lr, tuple(lr_bounds),
           tuple(loss_weights), tuple(init_jitter), capacity_boost,
           roi_crop, probe_dz, str(device))
    if key in _synth_ctx_cache:
        return _synth_ctx_cache[key]
    # one context kept: the one this replaces, its graph and memory pool go
    # before the new one is built
    _synth_ctx_cache.clear()

    h, w = resolution
    f = 1.2 * max(h, w)
    proj = geo.projection_from_intrinsics(f, f, w / 2, h / 2, w, h, 0.01, 100.0).astype(
        np.float32)
    mesh = load_mesh(mesh_path, scale=obj_scale, vertex_pad=128, triangle_pad=128)
    cc = mesh.corner_colors
    color_kw = dict(corner_colors=cc) if cc is not None else dict(vtx_color=mesh.vtx_color)
    # back faces never win on a closed, consistently wound mesh
    cull = bool(mesh.is_closed and mesh.is_oriented)

    w_rgb, w_depth, w_mask = loss_weights
    loss_fns, weights = select_losses(
        {"l1_mask": w_mask > 0, "weight_mask": w_mask,
         "l1_rgb_with_mask": w_rgb > 0, "weight_rgb": w_rgb,
         "l1_depth_with_mask": w_depth > 0, "weight_depth": w_depth})
    lrs = draw_learning_rates(seed, batchsize, lr_bounds, device)

    # off the card the uniform-K table, as the reference runs off the TPU
    compact_total = (probe_capacity(proj, mesh, resolution, capacity_boost, probe_dz,
                                    device) if device.type == "cuda" else None)
    max_tris = tile_cap(capacity_boost, resolution)
    fused = make_fused_loss(
        proj, mesh.pos, mesh.pos_idx, resolution, None, lrs, weights,
        use_rgb=w_rgb > 0, use_depth=w_depth > 0, use_mask=w_mask > 0,
        edge_adj=mesh.edge_adj, compact_total=compact_total, roi_crop=roi_crop,
        cull_backfaces=cull, max_tris_per_tile=max_tris, device=device, **color_kw,
    )

    def gt_render(q, t):
        mtx, _, _ = pose_matrix(pose_params(q, t, 1, device))
        r = render_rgb_mask(proj, mtx, mesh.pos, mesh.pos_idx, resolution,
                            edge_adj=mesh.edge_adj, device=device, cull_backfaces=cull,
                            **color_kw)
        return ({"rgb": r["rgb"][0], "segmentation": r["mask"][0], "depth": r["depth"][0]},
                mtx[0])

    refine_kw = dict(nb_iterations=nb_iterations, base_lr=base_lr, lr_decay=0.1,
                     optimizer=optimizer, fused_loss_fn=fused)
    pts = subsample_points(np.asarray(mesh.pos[: mesh.num_vertices]))

    def score(mtx_est, mtx_gt):
        args = (mtx_est[:3, :3], mtx_est[:3, 3], mtx_gt[:3, :3], mtx_gt[:3, 3])
        return add_metric(pts, *args), adds_metric(pts[:500], *args)

    def init_mtx(q, t):
        return pose_matrix(pose_params(q, t, 1, device))[0][0]

    jd, jt = init_jitter
    jitter = None
    if jd > 0 or jt > 0:
        def jitter(p, seed_int):
            # draw and apply apart: parity tests feed the reference's draws
            gen = torch.Generator().manual_seed(seed_int)
            return apply_pose_jitter(p, draw_pose_jitter(batchsize, gen, jd, jt))

    ctx = dict(
        gt_render=gt_render,
        refine=CapturedRefine(None, tuple(loss_fns), weights, **refine_kw),
        refine_kw=refine_kw, score=score, lrs=lrs, argmin_sb=argmin_step_hypothesis,
        init_mtx=init_mtx, pose_params=lambda q, t, b: pose_params(q, t, b, device),
        diameter=object_diameter(pts), jitter=jitter, weights=weights,
        fused=fused, compact_total=compact_total, max_tris_per_tile=max_tris,
    )
    _synth_ctx_cache[key] = ctx
    return ctx


def _worst(telemetry, key: str) -> int:
    """The largest per-step value of a telemetry counter (0 if absent)."""
    v = (telemetry or {}).get(key)
    if v is None:
        return 0
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return int(np.max(np.asarray(v), initial=0))


def _sweep_synth_objects(objs, level, scene_id, frame, mesh_path, obj_scale,
                         resolution, batchsize, nb_iterations, seed, log_fn,
                         optimizer="adam", base_lr=0.02,
                         lr_bounds=(0.5, 4.0), loss_weights=(0.7, 0.0, 1.0),
                         init_jitter=(0.0, 0.0), restarts=0,
                         restart_jitter=(10.0, 0.02),
                         argmin_rule="best_step", device="cuda"):
    """The synthesized branch (``bop.py:434-588``): each object's JSON
    rotation is the ground truth at 2 units from the camera, the init that
    pose perturbed by the level's magnitudes.

    The perturbations come from ``default_rng(seed + crc32(level/scene/
    frame))``, consumed as the reference does: per object the rotation
    axis, the translation direction, an integer for the init jitter's
    generator when the jitter is on, and one for the restarts' generator
    always (torch's generators take the integers the reference's
    ``PRNGKey``s take, so the numpy stream, and every later object's init,
    stays the reference's).  ``init_jitter=(deg, trans)`` spreads the
    hypotheses around the init (hypothesis 0 unjittered), ``restarts``
    re-seeds them at the best between segments, ``argmin_rule`` picks the
    kept pose ('best_step': the best (step, hypothesis) of the history).

    A run that dropped (tile, triangle) pairs or leaked out of a crop is
    run again from the same init with the capacities grown x max(1.5,
    1 + overflow / (1024 boost)), or without the crop, at most twice; the
    escalation persists for the configuration's later objects.  Every
    entry records the init's own scores ('add_init', 'adds_init') and the
    worst telemetry of its kept run where it is not 0."""
    device = torch.device(device)
    esc_key = (str(mesh_path), tuple(resolution), batchsize, nb_iterations,
               obj_scale, seed, optimizer, base_lr, tuple(lr_bounds),
               tuple(loss_weights), tuple(init_jitter), str(device))
    esc = _synth_escalation.setdefault(esc_key, {"boost": 1.0, "roi_crop": "auto"})

    def _ctx():
        return _synth_context(
            mesh_path, resolution, batchsize, nb_iterations, obj_scale,
            seed, optimizer, base_lr, lr_bounds, loss_weights, init_jitter,
            capacity_boost=esc["boost"], roi_crop=esc["roi_crop"], device=device,
        )

    ctx = _ctx()
    deg, trans_mag = parse_level(level)
    rng = np.random.default_rng(seed + zlib.crc32(f"{level}/{scene_id}/{frame}".encode()))
    out = []
    for i_obj, obj in enumerate(objs):
        r_cv = np.asarray(obj["cam_R_m2c"], float).reshape(3, 3)
        _, q_gl = geo.opencv_to_opengl(np.zeros(3), r_cv)
        q_gt = np.asarray(q_gl, np.float32)
        t_gt = np.array([0.0, 0.0, -2.0], np.float32)
        gt, mtx_gt = ctx["gt_render"](q_gt, t_gt)

        dq = geo.quat_from_axis_angle(rng.normal(size=3), np.deg2rad(deg))
        q0 = geo.quat_multiply(torch.as_tensor(dq, dtype=torch.float32),
                               torch.as_tensor(q_gt)).numpy()
        dt = rng.normal(size=3)
        dt = dt / np.linalg.norm(dt) * trans_mag * obj_scale
        t0 = (t_gt + dt).astype(np.float32)

        p0 = ctx["pose_params"](q0, t0, batchsize)
        if ctx["jitter"] is not None:
            p0 = ctx["jitter"](p0, int(rng.integers(2 ** 31)))
        restart_seed = int(rng.integers(2 ** 31))

        def _run(ctx):
            if restarts > 0:
                gen = torch.Generator().manual_seed(restart_seed)
                return refine_with_restarts(
                    p0, None, (), gt, ctx["lrs"], ctx["weights"],
                    restarts=restarts, restart_jitter_deg=restart_jitter[0],
                    restart_jitter_trans=restart_jitter[1],
                    draw_jitter=lambda b: draw_pose_jitter(b, gen, *restart_jitter),
                    jit_refine=ctx["refine"], **ctx["refine_kw"],
                )
            return ctx["refine"](p0, gt=gt, learning_rates=ctx["lrs"])

        for attempt in range(3):
            result = _run(ctx)
            overflow = _worst(result.telemetry, "_bin_overflow")
            leak = _worst(result.telemetry, "_crop_leak")
            if (overflow == 0 and leak == 0) or attempt == 2:
                break
            if overflow > 0:
                # overflow counts the dropped (tile, triangle) pairs: a cap
                # that many slots larger fits the identical re-run
                esc["boost"] *= max(1.5, 1.0 + overflow / (BASE_TILE_CAP * esc["boost"]))
                log_fn(f"  recovery {level} {scene_id}/{frame}#{i_obj}: bin overflow up "
                       f"to {overflow}/step — capacity x{esc['boost']:.2f}, re-running")
            if leak > 0:
                esc["roi_crop"] = "off"
                log_fn(f"  recovery {level} {scene_id}/{frame}#{i_obj}: ROI crop leak up "
                       f"to {leak}/step — full-frame, re-running")
            ctx = _ctx()
        s_best, b_best = ctx["argmin_sb"](result.losses_values, argmin_rule)
        s_best, b_best = int(s_best), int(b_best)
        add, adds = ctx["score"](result.mtx_history[s_best][b_best], mtx_gt)
        add_i, adds_i = ctx["score"](ctx["init_mtx"](q0, t0), mtx_gt)
        entry = {
            "scene": scene_id, "frame": frame, "i_obj": i_obj,
            "obj_id": int(obj.get("obj_id", -1)),
            "add": float(add), "adds": float(adds),
            "add_init": float(add_i), "adds_init": float(adds_i),
            "best_step": s_best, "best_hyp": b_best,
            "diameter": ctx["diameter"],
            "final_loss": float(result.total_loss[-1]),
        }
        # a degraded kept run stays visible in the sweep's JSON
        for tk in ("_bin_overflow", "_crop_leak"):
            worst = _worst(result.telemetry, tk)
            if worst > 0:
                entry[tk.lstrip("_") + "_max"] = worst
                log_fn(f"  WARNING {level} {scene_id}/{frame}#{i_obj}: {tk} up to "
                       f"{worst}/step — renders degraded")
        out.append(entry)
        log_fn(f"  {level} {scene_id}/{frame}#{i_obj}: add={entry['add']:.4f} "
               f"adds={entry['adds']:.4f} d={entry['diameter']:.3f} "
               f"(init add={entry['add_init']:.4f}, best step {s_best}/hyp {b_best})")
    return out


#: the last configuration's context (:func:`_synth_context`)
_synth_ctx_cache: Dict[tuple, dict] = {}
#: the recovery's escalation (capacity boost, roi_crop) per configuration,
#: so a later object at an escalated level skips the degraded first run
_synth_escalation: Dict[tuple, dict] = {}


def load_bop_camera(scene_dir, frame: str, image_hw, resize: float = 1.0) -> Optional[Camera]:
    """The camera of scene_camera.json's cam_K, at the images' full size
    (``image_hw`` read at ``resize``), or None without the file."""
    cam_json = Path(scene_dir) / "scene_camera.json"
    if not cam_json.exists():
        return None
    with open(cam_json) as f:
        k = np.asarray(json.load(f)[str(int(frame))]["cam_K"], float).reshape(3, 3)
    h, w = image_hw
    return Camera(
        fx=k[0, 0], fy=k[1, 1], cx=k[0, 2], cy=k[1, 2],
        im_width=int(w / resize) if resize else w, im_height=int(h / resize) if resize else h,
    )


def refine_bop_frame(
    cfg: ConfigNode,
    scene_dir,
    models_dir,
    frame_objs,
    frame: str = "0",
    obj_scale: float = 0.01,
    camera: Optional[Camera] = None,
    mesh_cache: Optional[Dict[int, Mesh]] = None,
    gt_objs=None,
    device="cuda",
) -> Dict[str, dict]:
    """Refine every object of one frame (``bop.py:611-757``).

    Args:
        cfg: the configuration (hyperparameters, losses, tpu, scene groups;
            ``scene.image_resize`` scales the images and the camera).
        scene_dir: the BOP scene directory (rgb/, depth/, mask_visib/).
        models_dir: the obj_XXXXXX.ply meshes, in millimetres.
        frame_objs: [{'cam_R_m2c': 9 floats, 'cam_t_m2c': 3 floats (mm),
            'obj_id'}], the initial poses.
        frame: the frame id.
        obj_scale: millimetres -> working units, for meshes and poses.
        camera: the camera; default scene_camera.json's, else cfg.camera.
        mesh_cache: meshes by obj_id, reused across frames.
        gt_objs: the true poses in the same format; with them each entry
            gets its ADD, ADD-S and the object's diameter.
        device: where the refinement runs (default the card).

    The depth image is BOP's png x depth_scale millimetres
    (scene_camera.json), read as working units (divisor 1 / (depth_scale
    x obj_scale)).  Object i is fitted to mask_visib/<frame>_<i>.png, i
    the enumeration order; a missing mask raises, never falling back to
    the placeholder segmentation.

    Returns {object index: {'obj_id', 'cam_R_m2c', 'cam_t_m2c' (mm),
    'argmin', 'final_loss'[, 'add', 'adds', 'diameter']}}."""
    scene_dir = Path(scene_dir)
    models_dir = Path(models_dir)
    mesh_cache = mesh_cache if mesh_cache is not None else {}
    resize = float(cfg.get("scene", ConfigNode()).get("image_resize", 1.0) or 1.0)
    fr = str(int(frame)).zfill(6)

    cam_ds = 1.0
    cam_json = scene_dir / "scene_camera.json"
    if cam_json.exists():
        with open(cam_json) as f:
            cam_ds = float(json.load(f)[str(int(frame))].get("depth_scale", 1.0))
    depth_path = scene_dir / "depth" / f"{fr}.png"
    scene = Scene(
        path_img=str(scene_dir / "rgb" / f"{fr}.png"),
        # a placeholder only: each object's mask replaces it below
        path_segmentation=str(scene_dir / "rgb" / f"{fr}.png"),
        image_resize=resize,
    )
    if depth_path.exists():
        scene.tensor_depth = Image(
            img_path=str(depth_path), img_resize=resize, depth=True,
            depth_scale=1.0 / (cam_ds * obj_scale),
        )
    if camera is None:
        camera = load_bop_camera(scene_dir, frame, scene.get_resolution(), resize)
    if camera is None:
        camera = Camera(**cfg.camera)
    if resize and resize < 1.0:
        camera.resize(resize)

    results: Dict[str, dict] = {}
    ddope: Optional[DiffDope] = None
    for i_obj, obj in enumerate(frame_objs):
        obj_id = int(obj["obj_id"])
        if obj_id not in mesh_cache:
            mesh_cache[obj_id] = load_mesh(models_dir / f"obj_{str(obj_id).zfill(6)}.ply",
                                           scale=obj_scale)
        mesh = mesh_cache[obj_id]
        pose = Object3D(
            position=obj["cam_t_m2c"], rotation=obj["cam_R_m2c"], scale=obj_scale,
            batchsize=int(cfg.get("hyperparameters", ConfigNode()).get("batchsize", 16)),
            mesh=mesh,
        )
        mask_path = scene_dir / "mask_visib" / f"{fr}_{str(i_obj).zfill(6)}.png"
        if not mask_path.exists():
            raise FileNotFoundError(
                f"per-object visible mask missing: {mask_path} — refusing to "
                "refine against the RGB placeholder segmentation")
        scene.tensor_segmentation = Image(img_path=str(mask_path), img_resize=resize)

        if ddope is None:
            ddope = DiffDope(cfg=cfg, camera=camera, object3d=pose, scene=scene,
                             device=device)
        else:
            ddope.set_object3d(pose)
            ddope.set_scene(scene)
        ddope.run_optimization()
        pose_cv = ddope.get_pose_opencv()
        entry = {
            "obj_id": obj_id,
            "cam_R_m2c": pose_cv[:3, :3].reshape(-1).tolist(),
            "cam_t_m2c": (pose_cv[:3, 3] / obj_scale).tolist(),
            "argmin": int(ddope.get_argmin()),
            "final_loss": float(ddope.last_run_stats["final_loss"]),
        }
        if gt_objs is not None:
            gt = gt_objs[i_obj]
            pts = subsample_points(mesh.pos[: mesh.num_vertices])

            def f32(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=ddope.device)

            r_gt = np.asarray(gt["cam_R_m2c"], float).reshape(3, 3)
            t_gt = np.asarray(gt["cam_t_m2c"], float) * obj_scale
            args = (f32(pose_cv[:3, :3]), f32(pose_cv[:3, 3]), f32(r_gt), f32(t_gt))
            entry["add"] = float(add_metric(pts, *args))
            entry["adds"] = float(adds_metric(pts[:500], *args))
            entry["diameter"] = object_diameter(pts)
        results[str(i_obj)] = entry
        log.info("object %d: %s", i_obj,
                 {k: entry[k] for k in ("obj_id", "argmin", "final_loss")})
    return results
