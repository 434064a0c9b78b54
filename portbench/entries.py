"""The system under test, as each configuration drives it.

A configuration names its ``entry``:

- ``captured_refine``: one ``optimize.CapturedRefine`` over the fused loss
  with its ground truth deferred (``render.pipeline.make_fused_loss(gt=None)``),
  built in set-up and called once a request with the frame's ground truth
  and the request's initial poses; the kept pose is the program's
  ``argmin_step_hypothesis`` (the best step's best hypothesis), read back
  to the host.
- ``diffdope``: the public ``DiffDope`` session, built once; a request sets
  the frame's scene and the initial pose, runs ``run_optimization()`` and
  reads ``get_pose()``.

Both take the frames and the initial poses that the benchmark made
(``Problem``, ``traffic``); the program's own imports happen in ``build``, so
the reference and the traffic import none of it.
"""

from __future__ import annotations

import copy
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from portbench import traffic as traffic_mod
from portbench.reference import geometry as geo
from portbench.reference import mesh as ref_mesh
from portbench.reference.render import Mesh, cull_keep, render

ROOT = Path(__file__).resolve().parent.parent
#: the growth of the program's overflow recovery (``DiffDope.run_optimization``)
RECOVERY_BOOST = 1.5
#: frames the reference renders at once in set-up
_FRAMES_PER_BATCH = 4


@dataclass
class Problem:
    """What both sides are given: the mesh, the camera, the optimizer's
    settings, the per-hypothesis loss scales and the base pose."""

    pos: np.ndarray          # (N, 3) float32, scaled
    tri: np.ndarray          # (T, 3) int32
    colors: np.ndarray       # (N, 3) float32
    adj: np.ndarray          # (T, 3) int32
    proj: np.ndarray         # (4, 4) float32
    resolution: tuple        # (H, W)
    batch: int
    steps: int
    optimizer: str
    base_lr: float
    lr_decay: float
    weights: Dict[str, float]
    scales: np.ndarray       # (B,) float32
    cull: bool               # back faces dropped where back-facing in every hypothesis
    q_base: np.ndarray       # (4,) float64
    t_base: np.ndarray       # (3,) float64
    renormalize_init: bool   # the entry normalizes the initial quaternion in float64
    drows_bf16: bool         # the gradient of the per-pixel rows in bfloat16


def _closed_oriented(faces: np.ndarray) -> bool:
    """Every edge shared by two faces that traverse it in opposite directions."""
    a = faces.reshape(-1).astype(np.int64)
    b = np.roll(faces, -1, axis=1).reshape(-1).astype(np.int64)
    n = int(faces.max()) + 1
    directed = a * n + b
    if len(np.unique(directed)) != len(directed):
        return False
    return bool(np.isin(b * n + a, directed).all())


def problem_of(config: Dict) -> Problem:
    """The configuration's problem, made by the benchmark from its file alone."""
    if config["entry"] == "captured_refine":
        m = config["mesh"]
        v, f = ref_mesh.icosphere(int(m["subdiv"]))
        h, w = config["resolution"]
        cam = config["camera"]
        focal = cam["focal_over_size"] * max(h, w)
        proj = geo.projection(focal, focal, w / 2, h / 2, w, h, cam["znear"], cam["zfar"])
        ls = config["loss_scales"]
        scales = np.random.default_rng(ls["seed"]).uniform(
            ls["low"], ls["high"], config["batch"]).astype(np.float32)
        pose = config["pose"]
        return Problem(
            pos=(v * m["radius"]).astype(np.float32), tri=f, colors=(v * 0.5 + 0.5).astype(
                np.float32), adj=ref_mesh.edge_adjacency(f), proj=proj.astype(np.float32),
            resolution=(h, w), batch=config["batch"], steps=config["steps"],
            optimizer=config["optimizer"], base_lr=config["base_lr"],
            lr_decay=config["lr_decay"], weights=config["loss_weights"], scales=scales,
            cull=bool(config["cull_backfaces"]),
            q_base=geo.quat_from_axis_angle(pose["axis"], pose["angle_rad"]),
            t_base=np.asarray(pose["translation"], np.float64), renormalize_init=False,
            drows_bf16=config["drows"] == "bfloat16")
    if config["entry"] == "diffdope":
        d = config["diffdope"]
        cam, o3, hp, tpu, losses = (d["camera"], d["object3d"], d["hyperparameters"],
                                    d["tpu"], d["losses"])
        ply = ref_mesh.read_ply(ROOT / o3["model_path"])
        scale = float(o3["scale"])
        pos = ply["vertices"] * np.float32(scale)
        resize = float(d["scene"]["image_resize"])
        h, w = int(cam["im_height"] * resize), int(cam["im_width"] * resize)
        proj = geo.projection(cam["fx"], cam["fy"], cam["cx"], cam["cy"], cam["im_width"],
                              cam["im_height"], 0.01, 200.0)
        gen = torch.Generator().manual_seed(int(tpu["seed"]))
        u = torch.rand((int(hp["batchsize"]),), generator=gen, dtype=torch.float32)
        lo, hi = (float(x) for x in hp["learning_rates_bound"])
        flip = np.diag([1.0, -1.0, -1.0])
        r_cv = np.asarray(o3["rotation"], np.float64).reshape(3, 3)
        weights = {"mask": float(losses["weight_mask"]) if losses.get("l1_mask") else 0.0,
                   "rgb": float(losses["weight_rgb"]) if losses.get("l1_rgb_with_mask") else 0.0}
        if losses.get("l1_depth_with_mask"):
            raise ValueError("the plain reference has no depth term")
        cull = tpu["cull_backfaces"]
        return Problem(
            pos=pos, tri=ply["faces"], colors=ply["colors"], adj=ref_mesh.edge_adjacency(
                ply["faces"]), proj=proj.astype(np.float32), resolution=(h, w),
            batch=int(hp["batchsize"]), steps=int(hp["nb_iterations"]) + 1,
            optimizer=str(tpu["optimizer"]), base_lr=float(hp["base_lr"]),
            lr_decay=float(hp["lr_decay"]), weights=weights,
            scales=(u * (hi - lo) + lo).numpy(),
            cull=_closed_oriented(ply["faces"]) if cull == "auto" else bool(cull),
            q_base=geo.quat_from_matrix(flip @ r_cv @ flip),
            t_base=flip @ (np.asarray(o3["position"], np.float64) * scale),
            renormalize_init=True, drows_bf16=config["drows"] == "bfloat16")
    raise ValueError(f"unknown entry {config['entry']!r}")


def init_pose(problem: Problem, q0: np.ndarray, t0: np.ndarray):
    """The initial (q, t) as float32, as the entry hands it to its steps."""
    if problem.renormalize_init:
        q = np.asarray(q0, np.float64)
        return (q / np.linalg.norm(q)).astype(np.float32), np.asarray(t0, np.float64).astype(
            np.float32)
    return np.asarray(q0, np.float32), np.asarray(t0, np.float32)


def ref_mesh_of(problem: Problem, device, dtype=torch.float32) -> Mesh:
    return Mesh(problem.pos, problem.tri, problem.colors, problem.adj, device, dtype)


@torch.no_grad()
def render_pool(problem: Problem, q: np.ndarray, t: np.ndarray, device) -> Dict[str, torch.Tensor]:
    """The frames at the true poses (P, 4), (P, 3), by the plain renderer:
    'rgb' (P, 3, H, W) the colours and 'seg' (P, 3, H, W) the antialiased
    mask in three channels, the segmentation a camera pipeline gives."""
    mesh = ref_mesh_of(problem, device)
    proj = torch.as_tensor(problem.proj, device=device)
    rgb, seg = [], []
    for s in range(0, len(q), _FRAMES_PER_BATCH):
        mtx = geo.pose_matrix(torch.as_tensor(q[s:s + _FRAMES_PER_BATCH], dtype=torch.float32,
                                              device=device),
                              torch.as_tensor(t[s:s + _FRAMES_PER_BATCH], dtype=torch.float32,
                                              device=device))
        keep = None
        if problem.cull:
            keep = torch.stack([cull_keep(mesh, proj, mtx[i:i + 1]) for i in range(len(mtx))])
        for i in range(len(mtx)):
            out = render(mesh, proj, mtx[i:i + 1], problem.resolution,
                         None if keep is None else keep[i])
            rgb.append(out["rgb"][0])
            seg.append(out["mask"][0][None].expand(3, -1, -1))
    return {"rgb": torch.stack(rgb), "seg": torch.stack(seg).contiguous(),
            "mtx": geo.pose_matrix(torch.as_tensor(q, dtype=torch.float32),
                                   torch.as_tensor(t, dtype=torch.float32)).numpy()}


@dataclass
class Record:
    """One refinement as the window saw it."""

    request: traffic_mod.Request
    wall_s: float
    pose: np.ndarray                      # (4, 4) the kept pose on the host
    failed: bool = False
    program: Dict = field(default_factory=dict)   # the program's counters
    keep: Dict = field(default_factory=dict)      # the outputs the check reads


class CapturedRefineEntry:
    """``optimize.CapturedRefine`` over the deferred fused loss."""

    def __init__(self, problem: Problem, frames: Dict[str, torch.Tensor], device):
        self.problem, self.device = problem, torch.device(device)
        # the program reads its ground truth as (H, W, 3) images
        self.gt = [{"rgb": frames["rgb"][i].permute(1, 2, 0).contiguous(),
                    "segmentation": frames["seg"][i].permute(1, 2, 0).contiguous()}
                   for i in range(frames["rgb"].shape[0])]
        self.frames_mtx = frames["mtx"]

    def build(self) -> None:
        from diffdope_tpu_torch.diffdope import TILE_MARGIN
        from diffdope_tpu_torch.optimize import CapturedRefine
        from diffdope_tpu_torch.render.pipeline import (
            make_fused_loss,
            compact_capacity,
            max_tile_count,
        )

        p, dev = self.problem, self.device
        mtx = torch.as_tensor(self.frames_mtx, device=dev)
        t_count = len(p.tri)
        # the port's own probe over the pool, each true pose alone: the
        # fullest tile by DiffDope's 'auto' rule, and the compact table by
        # the bench's rule grown once by the overflow recovery's x1.5 (the
        # bench's rule alone dropped pairs in 1 of 16 refinements: its 64
        # hypotheses spread over more tiles than one pose covers)
        most = max(max_tile_count(p.proj, p.pos, p.tri, mtx[i:i + 1], p.resolution, dev)
                   for i in range(len(mtx)))
        self.max_tris = min(t_count, max(512, -(-int(most * TILE_MARGIN) // 128) * 128))
        self.capacity = max(compact_capacity(p.proj, p.pos, p.tri, mtx[i:i + 1], p.resolution,
                                             self.max_tris, RECOVERY_BOOST, dev)
                            for i in range(len(mtx)))
        self.fn = make_fused_loss(
            p.proj, p.pos, p.tri, p.resolution, None, p.scales, p.weights,
            use_rgb=bool(p.weights.get("rgb")), use_mask=bool(p.weights.get("mask")),
            edge_adj=p.adj, vtx_color=p.colors, compact_total=self.capacity,
            cull_backfaces=p.cull, max_tris_per_tile=self.max_tris, device=dev)
        self.refine = CapturedRefine(fused_loss_fn=self.fn, nb_iterations=p.steps - 1,
                                     base_lr=p.base_lr, lr_decay=p.lr_decay,
                                     optimizer=p.optimizer)

    def counters(self) -> Dict:
        return {"max_tris_per_tile": self.max_tris, "compact_total": self.capacity}

    def request(self, req: traffic_mod.Request) -> Record:
        from diffdope_tpu_torch.optimize import argmin_step_hypothesis, pose_params

        t0 = time.perf_counter()
        params0 = pose_params(req.q0, req.t0, self.problem.batch, self.device)
        res = self.refine(params0, gt=self.gt[req.frame])
        s, h = argmin_step_hypothesis(res.losses_values, "best_step")
        s, h = int(s), int(h)
        pose = res.mtx_history[s, h].cpu().numpy()
        wall = time.perf_counter() - t0
        return Record(req, wall, pose, program={"steps": self.problem.steps},
                      keep={"result": res, "kept": (s, h)})

    def outputs(self, rec: Record) -> Dict:
        """The program's outputs the check reads, on the host: the first four
        poses and three steps' terms of every hypothesis, the kept (step,
        hypothesis), its batch of poses and its terms."""
        res, (s, h) = rec.keep["result"], rec.keep["kept"]
        tel = res.telemetry or {}
        return {
            "mtx": res.mtx_history[:4].cpu().numpy(),
            "terms": {k: v[:3].cpu().numpy() for k, v in res.losses_values.items()},
            "kept": (s, h), "kept_batch": res.mtx_history[s].cpu().numpy(),
            "kept_terms": {k: float(v[s, h]) for k, v in res.losses_values.items()},
            "overflow": int(tel["_bin_overflow"].max()) if "_bin_overflow" in tel else 0,
            "leak": int(tel["_crop_leak"].max()) if "_crop_leak" in tel else 0,
        }

    def release(self) -> None:
        self.refine = self.fn = None


class _Warnings(logging.Handler):
    """The session's warnings, as its log gives them."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: List[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        self.messages.append(record.getMessage())


class DiffDopeEntry:
    """The public ``DiffDope`` session of the configuration."""

    def __init__(self, problem: Problem, frames: Dict[str, torch.Tensor], device,
                 config: Dict):
        self.problem, self.device, self.config = problem, torch.device(device), config
        # a camera hands the session host images, (H, W, 3) float32
        self.frames = [(frames["rgb"][i].permute(1, 2, 0).cpu().numpy(),
                        frames["seg"][i].permute(1, 2, 0).cpu().numpy())
                       for i in range(frames["rgb"].shape[0])]
        self.frames_mtx = frames["mtx"]

    def _scene(self, frame: int):
        from diffdope_tpu_torch.image import Image, Scene

        rgb, seg = self.frames[frame]
        return Scene(tensor_rgb=Image(img_tensor=rgb), tensor_segmentation=Image(img_tensor=seg))

    def build(self) -> None:
        from diffdope_tpu_torch.config import ConfigNode
        from diffdope_tpu_torch.diffdope import DiffDope

        cfg = ConfigNode(copy.deepcopy(self.config["diffdope"]))
        cfg.object3d.model_path = str(ROOT / cfg.object3d.model_path)
        self.dd = DiffDope(cfg=cfg, scene=self._scene(0), device=self.device)
        self.warnings = _Warnings()
        logging.getLogger("diffdope_tpu_torch.diffdope").addHandler(self.warnings)

    def counters(self) -> Dict:
        return {}

    def request(self, req: traffic_mod.Request) -> Record:
        dd = self.dd
        self.warnings.messages.clear()
        t0 = time.perf_counter()
        dd.set_scene(self._scene(req.frame))
        dd.object3d.set_pose(req.t0.astype(np.float64), req.q0.astype(np.float64),
                             opencv2opengl=False)
        dd.run_optimization()
        pose = np.asarray(dd.get_pose())
        wall = time.perf_counter() - t0
        stats = dd.last_run_stats
        # what the session still reports after its own recovery
        failed = any(m.startswith(("bin overflow during", "ROI crop leak during"))
                     for m in self.warnings.messages)
        return Record(req, wall, pose, failed=failed, program={
            "wall_time_s": float(stats["wall_time_s"]),
            "recovery_reruns": int(stats["recovery_reruns"]),
            "steps": int(stats["steps"]) * (1 + int(stats["recovery_reruns"]))},
            keep={"mtx": dd.mtx_history, "terms": dict(dd.losses_values)})

    def outputs(self, rec: Record) -> Dict:
        mtx, terms = rec.keep["mtx"], rec.keep["terms"]
        hit = np.argwhere((mtx == rec.pose[None, None]).all(axis=(-1, -2)))
        kept = None if len(hit) == 0 else (int(hit[0][0]), int(hit[0][1]))
        return {
            "mtx": mtx[:4], "terms": {k: v[:3] for k, v in terms.items()},
            "kept": kept, "kept_batch": None if kept is None else mtx[kept[0]],
            "kept_terms": None if kept is None else {
                k: float(v[kept[0], kept[1]]) for k, v in terms.items()},
            "overflow": 0, "leak": 0,
        }

    def release(self) -> None:
        logging.getLogger("diffdope_tpu_torch.diffdope").removeHandler(self.warnings)
        self.dd = None


def make_entry(config: Dict, problem: Problem, frames, device):
    if config["entry"] == "captured_refine":
        return CapturedRefineEntry(problem, frames, device)
    return DiffDopeEntry(problem, frames, device, config)
