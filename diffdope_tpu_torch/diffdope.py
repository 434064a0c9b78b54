"""DiffDope: the user-facing refinement session (counterpart of
``diffdope_tpu/diffdope.py``).

Same surface: ``DiffDope(cfg=cfg).run_optimization()``, then
``get_argmin()``, ``get_pose()``, ``get_pose_opencv()``, ``renders``,
``optimization_results``, ``add_loss_value()``, ``set_batchsize()``, and
the pictures ``render_img()``, ``make_animation()`` and ``plot_losses()``
(``viz``: cv2, matplotlib for the plot, imageio or cv2 for the mp4).  It
runs on the card unless ``device`` says otherwise.

A run takes one of two routes, as the reference's does:

- the fused route (``make_fused_loss``: K1 -> K3 -> K5, backward
  K6 -> K4 -> K2) for the three standard losses, mask, rgb and depth;
- the unfused route (``render_batch``: K1 -> K3, plain shade and
  antialiasing, backward K4 -> K2, then the loss functions) for
  ``tpu.fused_loss: false``, custom losses, the depth loss of a scene
  without a gt depth image, and appearance refinement.

A textured mesh renders its corner colours baked from the texture
(``tpu.texture_mode: baked``, the default) or samples the texture at each
pixel (``exact``: on the fused route the semi-fused exact-texture loss,
K5/K6's colour lane).  ``Mesh.enable_gradients_texture()`` refines the
appearance with the pose (``diffdope.py:510-536``): the texture map under
``exact``, else the corner colours, else the vertex colours, on the
unfused route (the pack takes the plain version for traced colours, as
the reference's does), written back into the mesh after the run.

Either runs on the compact bin table, or on the uniform-K table with
``tpu.compact_bins: false`` (the raster K7 in place of K3/K4, the full
frame without the ROI crop), or on the planar route that the
environment selects, as the reference's does (``DD_RASTER=v3``: K10, no
bins and so no capacity or overflow; ``DD_BINNED=0``: K7 over the bins
gathered from the triangle-order table; ``pipeline.raster_route``, read
when a run builds its loss or render).  ``tpu.raster_impl: reference`` (or ``auto``
on a mesh of at most 256 triangles, the reference's rule) takes the
unfused route on the brute-force rasterizer instead: plain torch, no
kernel, no bins and so no capacity to probe or recover.

The refinement options follow the reference's order of precedence
(``diffdope.py:485-640``): ``tpu.init_jitter_deg`` / ``init_jitter_trans``
jitter the initial hypotheses (all but the first) from a generator seeded
``tpu.seed + 1``; ``tpu.mesh_axis`` > 1 shards the hypotheses over that
many ranks (``parallel.refine_sharded``: one process a rank, launched by
torchrun; every rank builds the same session from the same configuration
and gets the global results), before any option below, so restarts do
not run under it; appearance refinement, when asked, wins over
``tpu.restarts``, which re-seeds every hypothesis around the best one
between segments (``optimize.refine_with_restarts``, jitter from a
generator seeded ``tpu.seed + 2``); else the plain segmented run.
``tpu.precompute_bins`` bins once at the initial poses, widened by
``tpu.bin_margin_px``, for the fused loss and the unfused render alike
(``pipeline.precompute_bins``), and re-bins once at the final poses to
warn if they left the bins.  ``tpu.live_loss: step`` logs every step's
total loss (a host sync a step); ``segment``, the default, logs once a
segment.  The draws are the port's own: torch's RNG cannot reproduce
``jax.random``.  An overflow or crop-leak re-run repeats the same draws.

Settings the port reads differently: ``tpu.tile_h`` / ``tpu.tile_w`` are
TPU layout knobs and are not read (the port's raster tile is
``pipeline.TILE_HW``); ``tpu.max_tris_per_tile`` and
``tpu.compact_total`` count the port's tiles and slots.
"""

from __future__ import annotations

import itertools
import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from diffdope_tpu_torch import trace, viz
from diffdope_tpu_torch.camera import Camera
from diffdope_tpu_torch.config import ConfigNode
from diffdope_tpu_torch.convert import tensor
from diffdope_tpu_torch.geometry import matmul44, opengl_to_opencv
from diffdope_tpu_torch.image import Scene
from diffdope_tpu_torch.losses import LOSS_REGISTRY, select_losses
from diffdope_tpu_torch.object3d import Object3D
from diffdope_tpu_torch.optimize import (
    CapturedRefine,
    argmin_step_hypothesis,
    draw_learning_rates,
    draw_pose_jitter,
    jitter_pose_params,
    pose_matrix,
    refine_segmented,
    refine_with_restarts,
)
from diffdope_tpu_torch.parallel import hypothesis_mesh, rank_device, refine_sharded
from diffdope_tpu_torch.render.pipeline import (
    CAPACITY_SLACK,
    K_CHUNK,
    MAX_TRIS_PER_TILE,
    TILE_HW,
    Bins,
    _Mesh,
    _binned,
    _impl,
    _padded,
    _planar,
    _render,
    _table,
    compact_capacity,
    make_fused_loss,
    max_tile_count,
    precompute_bins,
    raster_route,
)
from diffdope_tpu_torch.render.planar import bin_triangles_planar, corner_planes, det_planar

log = logging.getLogger(__name__)

#: 'auto' capacities over the init probe's: per-tile K and the compact
#: table.  The reference's are x1.5 and x1.35 on its 32x128 tiles; on the
#: port's 16x16 tiles the batch's bins grow far more as the hypotheses
#: spread: along four default-configuration trajectories the fullest tile
#: grew to 2.9x and the table's need to 4.6x the probe's, the reference's
#: to 1.2x and 1.5x of its own (tools/port_capacity_study.py)
TILE_MARGIN = 3.0
TABLE_MARGIN = 5.0


class RenderHistory:
    """Per-step renders on demand from the stored pose trajectory
    (``results[i]['rgb'|'depth'|'mask'|'mtx']``, numpy), memoized."""

    def __init__(self, ddope: "DiffDope"):
        self._dd = ddope
        self._cache: Dict[int, dict] = {}

    def __len__(self) -> int:
        h = self._dd.mtx_history
        return 0 if h is None else h.shape[0]

    def __getitem__(self, index: int) -> dict:
        n = len(self)
        if index < 0:
            index += n
        if not 0 <= index < n:
            raise IndexError(index)
        if index not in self._cache:
            mtx = self._dd.mtx_history[index]
            with torch.no_grad():
                renders = self._dd._render(torch.as_tensor(mtx, device=self._dd.device))
            entry = {k: renders[k].cpu().numpy() for k in ("rgb", "depth", "mask")}
            entry["mtx"] = np.asarray(mtx)
            if len(self._cache) > 8:  # bound memory
                self._cache.pop(next(iter(self._cache)))
            self._cache[index] = entry
        return self._cache[index]


class DiffDope:
    """Differentiable pose refinement session.

    Args:
        cfg: ConfigNode (see configs/diffdope.yaml): groups ``camera``,
            ``object3d``, ``scene``, ``losses``, ``hyperparameters``, ``tpu``.
        camera / object3d / scene: pre-built components, in place of the
            config's groups.
        device: where the refinement runs (default the card).
    """

    def __init__(self, cfg: Optional[ConfigNode] = None,
                 camera: Optional[Camera] = None,
                 object3d: Optional[Object3D] = None,
                 scene: Optional[Scene] = None,
                 batchsize: Optional[int] = None,
                 device="cuda"):
        self.cfg = cfg if cfg is not None else ConfigNode()
        self.device = torch.device(device)
        tpu_cfg = self.cfg.get("tpu", ConfigNode())
        self.seed = int(tpu_cfg.get("seed", 0))
        self.mesh_axis = int(tpu_cfg.get("mesh_axis", 1))
        if self.mesh_axis > 1:
            self.device = rank_device(self.device)
        self.optimizer_name = str(tpu_cfg.get("optimizer", "sgd"))
        self.raster_impl = str(tpu_cfg.get("raster_impl", "auto"))
        if self.raster_impl not in ("auto", "pallas", "reference"):
            raise ValueError(f"unknown tpu.raster_impl {self.raster_impl!r} "
                             "(auto | pallas | reference)")
        mk = tpu_cfg.get("max_tris_per_tile", "auto")
        self.max_tris_per_tile = mk if mk == "auto" else int(mk)

        self.camera = camera if camera is not None else Camera(**self.cfg.camera)
        self.object3d = (
            object3d if object3d is not None else Object3D(**self.cfg.object3d)
        )
        self.scene = scene if scene is not None else Scene(**self.cfg.scene)

        hp = self.cfg.get("hyperparameters", ConfigNode())
        self.batchsize = int(batchsize or hp.get("batchsize", 16))
        self.nb_iterations = int(hp.get("nb_iterations", 60))
        self.base_lr = float(hp.get("base_lr", 20.0))
        self.lr_decay = float(hp.get("lr_decay", 0.1))
        self.learning_rates_bound = list(hp.get("learning_rates_bound", [0.01, 100]))

        self.resolution = self.scene.get_resolution()  # [H, W]
        self.loss_functions, self.loss_weights = select_losses(
            self.cfg.get("losses", ConfigNode({"l1_mask": True}))
        )

        self.mtx_history: Optional[np.ndarray] = None
        self.losses_values: Dict[str, np.ndarray] = {}
        self.optimization_results = RenderHistory(self)
        self.last_run_stats: Dict[str, float] = {}
        self._render_fn = None
        self.set_batchsize(self.batchsize)

    # ------------------------------------------------------------------ #
    # configuration
    # ------------------------------------------------------------------ #
    def set_batchsize(self, batchsize: int) -> None:
        """Set the hypothesis count and redraw the per-hypothesis loss
        scales from the seed."""
        self.batchsize = int(batchsize)
        self.object3d.set_batchsize(self.batchsize)
        self.learning_rates = draw_learning_rates(
            self.seed, self.batchsize, self.learning_rates_bound, self.device
        )

    def set_object3d(self, object3d: Object3D) -> None:
        """Swap the optimized object in place."""
        self.object3d = object3d
        self.object3d.set_batchsize(self.batchsize)
        self._render_fn = None

    def set_scene(self, scene: Scene) -> None:
        """Swap the ground-truth scene in place."""
        self.scene = scene
        self.resolution = self.scene.get_resolution()
        self._render_fn = None

    def add_loss_function(self, fn: Callable) -> None:
        """Append a custom loss ``fn(renders, gt, learning_rates, weights)
        -> (scalar, (key, (B,)))``; it runs on the unfused route."""
        self.loss_functions = list(self.loss_functions) + [fn]

    @property
    def gt_tensors(self) -> Dict[str, np.ndarray]:
        """Ground-truth arrays {'rgb', 'depth', 'segmentation'} (unbatched)."""
        return self.scene.gt_arrays()

    def _tpu(self) -> ConfigNode:
        return self.cfg.get("tpu", ConfigNode())

    # ------------------------------------------------------------------ #
    # render and loss closures
    # ------------------------------------------------------------------ #
    def _mesh_arrays(self) -> dict:
        """The mesh's arrays, its colours as ``tpu.texture_mode`` chooses
        them for a textured mesh (``diffdope.py:206-220``): 'baked' (the
        default) the corner colours, 'exact' the texture with its uv."""
        mesh = self.object3d.mesh
        if mesh is None:
            raise ValueError("Object3D has no mesh attached")
        out = {
            "pos": np.asarray(mesh.pos),
            "pos_idx": np.asarray(mesh.pos_idx),
            "edge_adj": None if mesh.edge_adj is None else np.asarray(mesh.edge_adj),
        }
        texture_mode = str(self._tpu().get("texture_mode", "baked"))
        if mesh.has_textured_map:
            if texture_mode == "baked" and mesh.corner_colors is not None:
                out["corner_colors"] = np.asarray(mesh.corner_colors)
            else:
                out.update(uv=np.asarray(mesh.uv), uv_idx=np.asarray(mesh.uv_idx),
                           tex=np.asarray(mesh.tex))
        else:
            out["vtx_color"] = np.asarray(mesh.vtx_color)
        return out

    def _mesh(self, arrays, proj) -> _Mesh:
        return _Mesh(proj, arrays["pos"], arrays["pos_idx"], arrays["edge_adj"],
                     arrays.get("vtx_color"), arrays.get("corner_colors"), self.device,
                     arrays.get("tex"), arrays.get("uv"), arrays.get("uv_idx"))

    def _mtx0(self) -> torch.Tensor:
        return pose_matrix(self.object3d.initial_params(1, self.device))[0]

    def _resolve_max_tris(self, arrays, proj, resolution) -> int:
        """'auto': the initial pose's fullest tile x ``TILE_MARGIN``, at
        least 512, rounded to 128, at most T (``diffdope.py:222-266``, there
        x1.5); the overflow recovery's boost grows explicit values too."""
        boost = getattr(self, "_capacity_boost", 1.0)
        t_cap = int(arrays["pos_idx"].shape[0])
        if self.max_tris_per_tile != "auto":
            k = int(self.max_tris_per_tile)
            if boost > 1.0:
                k = min(t_cap, -(-int(k * boost) // 128) * 128)
            return k
        max_count = max_tile_count(proj, arrays["pos"], arrays["pos_idx"],
                                   self._mtx0(), resolution, self.device)
        k = min(t_cap, max(512, -(-int(max_count * TILE_MARGIN * boost) // 128) * 128))
        log.info("auto max_tris_per_tile: measured %d -> K=%d", max_count, k)
        return k

    def _resolve_compact_total(self, arrays, proj, resolution, max_tris,
                               bins: Optional[Bins] = None) -> Optional[int]:
        """The compact table's capacity, or None for the uniform-K table
        (``tpu.compact_bins: false``): ``tpu.compact_total`` (rounded up to
        the chunk), else the initial pose's chunk-padded occupancy x
        ``TABLE_MARGIN`` (x the recovery's boost) plus a chunk
        (``diffdope.py:268-316``, there x1.35).  After an overflow it is at
        least the most slots a step of the failed run needed ('_bin_need')
        x 1.35 plus a chunk, which a x1.5 boost need not reach.  Over
        precomputed ``bins``, which no step changes, it is what they fill."""
        if not self._compact_bins():
            return None
        override = self._tpu().get("compact_total", None)
        if override:
            return -(-int(override) // K_CHUNK) * K_CHUNK
        if bins is not None:
            return int((-(-bins.counts // K_CHUNK) * K_CHUNK).sum()) or K_CHUNK
        total = compact_capacity(proj, arrays["pos"], arrays["pos_idx"], self._mtx0(),
                                 resolution, max_tris,
                                 getattr(self, "_capacity_boost", 1.0), self.device,
                                 TABLE_MARGIN)
        seen = getattr(self, "_slots_seen", 0)
        total = max(total, -(-int(seen * CAPACITY_SLACK + K_CHUNK) // K_CHUNK) * K_CHUNK)
        log.info("compact bin table capacity %d", total)
        return total

    def _compact_bins(self) -> bool:
        return bool(self._tpu().get("compact_bins", True))

    def _resolve_cull(self) -> bool:
        """tpu.cull_backfaces: auto | true | false (default auto).  auto
        culls only closed, consistently wound meshes
        (``diffdope.py:318-346``)."""
        val = self._tpu().get("cull_backfaces", "auto")
        if isinstance(val, bool):
            return val
        sval = str(val).lower()
        if sval in ("true", "1", "on"):
            return True
        if sval in ("false", "0", "off"):
            return False
        mesh = self.object3d.mesh
        return bool(getattr(mesh, "is_closed", False)
                    and getattr(mesh, "is_oriented", False))

    def _impl(self, arrays) -> str:
        """The rasterizer of this session: 'pallas' (the kernels) or
        'reference' (the brute force), ``tpu.raster_impl: auto`` resolved by
        the mesh's triangle count (``diffdope.py:372-374``)."""
        return _impl(self.raster_impl, int(arrays["pos_idx"].shape[0]))

    def _precompute_bins(self, arrays, proj, resolution) -> Bins:
        """The bins of ``tpu.precompute_bins`` (``diffdope.py:348-363``):
        binned once at the initial poses (unjittered, as the reference's),
        each triangle widened by ``tpu.bin_margin_px``; K sized to the
        fullest bin under 'auto', else the configured (boosted) K, which
        raises on a drop."""
        params0 = self.object3d.initial_params(self.batchsize, self.device)
        margin = float(self._tpu().get("bin_margin_px", 24.0))
        k = ("auto" if self.max_tris_per_tile == "auto"
             else self._resolve_max_tris(arrays, proj, resolution))
        self._bins = precompute_bins(proj, pose_matrix(params0)[0], arrays["pos"],
                                     arrays["pos_idx"], resolution, k, margin,
                                     device=self.device)
        return self._bins

    def _use_bins(self) -> bool:
        return bool(self._tpu().get("precompute_bins", False))

    def _make_render_fn(self, layout: str = "channels", with_bins: bool = False):
        """``render_fn(mtx, tex=None, vtx_color=None, corner_colors=None)
        -> render_batch(...)`` on the mesh, prepared once; a colour given
        overrides the mesh's (an appearance leaf, ``diffdope.py:383-406``:
        a texture displaces baked corner colours).  The reference
        rasterizer bins nothing, so it probes no capacity and takes no
        compact table (``diffdope.py:282-283``).  ``with_bins`` renders
        over :meth:`_precompute_bins`' bins, as ``tpu.precompute_bins``
        asks of a run."""
        arrays = self._mesh_arrays()
        proj = np.asarray(self.camera.cam_proj, np.float32)
        resolution = tuple(self.resolution)
        mesh = self._mesh(arrays, proj)

        # the mesh's colours on the device once: a step that recolours the
        # mesh (an appearance leaf) copies no host data
        colors = {k: None if arrays.get(k) is None else
                  tensor(arrays[k], self.device,
                         torch.int64 if k == "uv_idx" else torch.float32)
                  for k in ("vtx_color", "corner_colors", "tex", "uv", "uv_idx")}

        def colored(tex, vtx_color, corner_colors) -> _Mesh:
            if tex is None and vtx_color is None and corner_colors is None:
                return mesh
            kw = dict(colors)
            if tex is not None:
                kw.update(tex=tex, corner_colors=None)
            if vtx_color is not None:
                kw["vtx_color"] = vtx_color
            if corner_colors is not None:
                kw["corner_colors"] = corner_colors
            return mesh.recolored(**kw)

        if self._impl(arrays) == "reference":
            def reference_fn(mtx, tex=None, vtx_color=None, corner_colors=None):
                return _render(colored(tex, vtx_color, corner_colors), mtx, resolution,
                               None, layout, impl="reference")

            return reference_fn
        route = raster_route()
        bins = self._precompute_bins(arrays, proj, resolution) if with_bins else None
        max_tris, capacity = self._capacities(arrays, proj, resolution, route, bins)
        cull = self._resolve_cull()

        def render_fn(mtx, tex=None, vtx_color=None, corner_colors=None):
            return _render(colored(tex, vtx_color, corner_colors), mtx, resolution,
                           capacity, layout, cull, max_tris, route=route, bins=bins)

        # what the kernel checks need to drive the pack and the raster of
        # the render's table (as make_fused_loss's fn carries)
        render_fn.mesh, render_fn.route = mesh, route
        render_fn.planar = lambda mtx: _planar(mesh, mtx, resolution, route, cull,
                                               max_tris, bins)
        render_fn.binned = lambda mtx: _binned(mesh, mtx, resolution, capacity, None,
                                               cull, max_tris, bins)
        render_fn.table = lambda mtx: _table(mesh, mtx, resolution, capacity, None,
                                             cull, max_tris, bins)
        render_fn.frame_hw, render_fn.roi = _padded(resolution), (0, 0) + resolution
        return render_fn

    def _capacities(self, arrays, proj, resolution, route, bins=None):
        """(per-tile K, compact capacity) of a run on ``route``: the 'v3'
        route bins nothing and needs neither (the default K is passed
        unread), 'v2' needs K only; over precomputed ``bins`` K is theirs
        and the compact table holds them."""
        if route == "v3" and bins is None:
            return MAX_TRIS_PER_TILE, None
        max_tris = (bins.idx.shape[1] if bins is not None
                    else self._resolve_max_tris(arrays, proj, resolution))
        if route is not None:
            return max_tris, None
        return max_tris, self._resolve_compact_total(arrays, proj, resolution, max_tris,
                                                     bins)

    def _render(self, mtx):
        if self._render_fn is None:
            self._render_fn = self._make_render_fn(layout="stacked")
        return self._render_fn(mtx)

    def _make_fused_loss_fn(self, gt, use_bins: bool = False):
        """The fused route's loss when the configuration allows it (standard
        mask / rgb / depth losses, ``tpu.fused_loss`` on, the gt images
        they read), else None: the unfused route runs
        (``diffdope.py:415-480``).  ``use_bins`` takes
        :meth:`_precompute_bins`' bins in place of each step's binning."""
        if not bool(self._tpu().get("fused_loss", True)):
            return None
        fns = set(self.loss_functions)
        std = {LOSS_REGISTRY[k] for k in ("l1_rgb_with_mask", "l1_depth_with_mask", "l1_mask")}
        if not fns or not fns <= std:
            return None  # custom losses need the renders
        use_depth = LOSS_REGISTRY["l1_depth_with_mask"] in fns
        if "segmentation" not in gt or (use_depth and "depth" not in gt):
            return None
        arrays = self._mesh_arrays()
        if self._impl(arrays) != "pallas":
            return None  # the reference rasterizer runs the unfused route
        proj = np.asarray(self.camera.cam_proj, np.float32)
        resolution = tuple(self.resolution)
        bins = self._precompute_bins(arrays, proj, resolution) if use_bins else None
        max_tris, capacity = self._capacities(arrays, proj, resolution, raster_route(),
                                              bins)
        crop_off = (getattr(self, "_crop_disable", False)
                    or str(self.cfg.get_dotted("tpu.roi_crop", "auto")) == "off")
        return make_fused_loss(
            proj, arrays["pos"], arrays["pos_idx"], resolution, gt,
            self.learning_rates, self.loss_weights,
            use_rgb=LOSS_REGISTRY["l1_rgb_with_mask"] in fns, use_depth=use_depth,
            use_mask=LOSS_REGISTRY["l1_mask"] in fns,
            edge_adj=arrays["edge_adj"], corner_colors=arrays.get("corner_colors"),
            vtx_color=arrays.get("vtx_color"), tex=arrays.get("tex"),
            uv=arrays.get("uv"), uv_idx=arrays.get("uv_idx"),
            compact_total=capacity, roi_crop="off" if crop_off else "auto",
            cull_backfaces=self._resolve_cull(), max_tris_per_tile=max_tris,
            device=self.device, bins=bins,
        )

    # ------------------------------------------------------------------ #
    # optimization
    # ------------------------------------------------------------------ #
    def run_optimization(self) -> None:
        """Run the refinement: ``nb_iterations + 1`` steps in segments of
        ``tpu.scan_segment``.  Populates ``losses_values``,
        ``mtx_history``, ``optimization_results`` and ``last_run_stats``.

        Overflow and crop-leak recovery (``diffdope.py:652-695``): when a
        step dropped (tile, triangle) pairs, the capacities grow x1.5 (the
        per-tile K, and the compact table to at least what the failed run
        needed, see ``_resolve_compact_total``; the uniform table has no
        capacity but K) and the run restarts from the same init; when a
        triangle left the ROI
        crop's interior, the run restarts on the full frame; at most
        ``tpu.overflow_retries`` times, unless ``tpu.overflow_recovery`` is
        off.

        After ``Mesh.enable_gradients_texture()`` the appearance leaf
        (:meth:`_appearance`) is refined with the pose on the unfused route
        and written back into the mesh (``diffdope.py:697-708``).

        Each dispatch (the first run and each re-run) builds one
        ``optimize.CapturedRefine`` and every segment and restart chunk
        calls it (``diffdope.py:562-642``'s ``_refine_jit``), so the run
        pays one step 0 and one capture on the card; a re-run builds a new
        loss, so it captures anew.  The object lives for its dispatch only,
        so a session holds no graph or memory pool between runs: the
        reference's drops of ``_refine_jit`` when a setting changes
        (``diffdope.py:138-181``) have nothing to drop here.

        The options of the module docstring apply in the reference's order:
        the init jitter, then ``tpu.mesh_axis`` > 1 (the hypotheses sharded
        over the ranks, appearance leaves included, restarts not run),
        else appearance refinement, else restarts, else the plain
        segmented run; ``tpu.precompute_bins`` under any of them.

        ``last_run_stats``: the kept dispatch's ``wall_time_s`` (host
        seconds of its refinement, its loss built), ``steps``,
        ``steps_per_sec``, ``compile_s`` (its ``CapturedRefine``'s step 0
        and capture, host seconds: 0 for the eager loop, None for a sharded
        run), ``steady_steps_per_sec`` (its graph replays over the rest of
        ``wall_time_s``; None without replays), ``final_loss``,
        ``recovery_reruns`` and ``rerun_reasons`` (one a re-run:
        'overflow', pairs dropped, also where a crop leaked too; 'leak', a
        triangle left the ROI crop).

        While tracing is on (``trace``) a run records ``dd.run`` with
        ``dd.run.gt`` (the ground truth to the device), ``dd.run.loss``
        (the loss or render build, its capacity probes ``dd.probe``
        included) and ``dd.run.dispatch`` (attributes ``attempt`` and
        ``reason``: 'first', 'overflow' or 'leak'; the refinement's
        ``dd.refine`` spans inside) for each dispatch, and ``dd.run.host``
        (the results to the host)."""
        with trace.span("run"):
            self._run_optimization()

    def _run_optimization(self) -> None:
        tpu_cfg = self._tpu()
        gt_np = self.gt_tensors
        with trace.span("run.gt"):
            gt = {k: torch.tensor(v, device=self.device) for k, v in gt_np.items()}
        params0 = self.object3d.initial_params(self.batchsize, self.device)
        jitter_deg = float(tpu_cfg.get("init_jitter_deg", 0.0))
        jitter_trans = float(tpu_cfg.get("init_jitter_trans", 0.0))
        params0 = jitter_pose_params(params0, torch.Generator().manual_seed(self.seed + 1),
                                     jitter_deg, jitter_trans)
        segment = int(tpu_cfg.get("scan_segment", 40))
        show_progress = bool(tpu_cfg.get("progress", True))
        extra_params = self._appearance()
        use_bins = self._use_bins()
        restarts = int(tpu_cfg.get("restarts", 0))
        steps = self.nb_iterations + 1
        live_step = str(tpu_cfg.get("live_loss", "segment")) == "step"

        def progress(done, total_steps, last_loss):
            log.info("refine %d/%d steps, loss %.5f", done, total_steps, last_loss)

        def losses():
            """(fused loss, render function): one of them None"""
            fused_fn = (None if extra_params
                        else self._make_fused_loss_fn(gt_np, use_bins=use_bins))
            render_fn = (self._make_render_fn(with_bins=use_bins) if fused_fn is None
                         else None)
            return fused_fn, render_fn

        def dispatch(fused_fn, render_fn):
            """(result, wall seconds, the CapturedRefine or None)"""
            logged = itertools.count(1)

            def step_cb(i, total):
                # the reference's per-step callback (diffdope.py:545-560),
                # numbered across segments and restarts
                log.info("step %d/%d loss %.5f", next(logged), steps, float(total))

            kw = dict(base_lr=self.base_lr, lr_decay=self.lr_decay,
                      optimizer=self.optimizer_name, fused_loss_fn=fused_fn)
            callback = step_cb if live_step else None
            t0 = time.perf_counter()
            if self.mesh_axis > 1:
                # the hypotheses sharded over the group's ranks, each rank
                # refining its B/n (the reference's first branch,
                # diffdope.py:579-592: no restarts, no segments)
                result = refine_sharded(
                    params0, render_fn, tuple(self.loss_functions), gt,
                    self.learning_rates, self.loss_weights,
                    hypothesis_mesh(n_devices=self.mesh_axis, device=self.device),
                    extra_params=extra_params, nb_iterations=self.nb_iterations,
                    step_callback=callback, **kw)
                return result, time.perf_counter() - t0, None
            jit_refine = CapturedRefine(render_fn, tuple(self.loss_functions),
                                        self.loss_weights, self.nb_iterations, **kw)
            if restarts > 0 and not extra_params:
                deg = float(tpu_cfg.get("restart_jitter_deg", 10.0))
                trans = float(tpu_cfg.get("restart_jitter_trans", 0.02))
                gen = torch.Generator().manual_seed(self.seed + 2)
                result = refine_with_restarts(
                    params0, render_fn, tuple(self.loss_functions), gt,
                    self.learning_rates, self.loss_weights,
                    nb_iterations=self.nb_iterations, restarts=restarts,
                    restart_jitter_deg=deg, restart_jitter_trans=trans,
                    draw_jitter=lambda b: draw_pose_jitter(b, gen, deg, trans),
                    jit_refine=jit_refine, segment_steps=segment, step_callback=callback)
            else:
                result = refine_segmented(
                    params0, render_fn, tuple(self.loss_functions), gt,
                    self.learning_rates, self.loss_weights,
                    nb_iterations=self.nb_iterations, segment_steps=segment,
                    progress_fn=progress if show_progress and not live_step else None,
                    extra_params=extra_params, jit_refine=jit_refine,
                    step_callback=callback)
            return result, time.perf_counter() - t0, jit_refine

        recovery = bool(tpu_cfg.get("overflow_recovery", True))
        max_retries = int(tpu_cfg.get("overflow_retries", 2))
        reasons = []
        for attempt in range(max_retries + 1):
            with trace.span("run.loss"):
                fns = losses()
            with trace.span("run.dispatch", attempt=attempt,
                            reason=reasons[-1] if reasons else "first"):
                result, dt, jit_refine = dispatch(*fns)
                overflow = self._telemetry_max(result, "_bin_overflow")
                leak = self._telemetry_max(result, "_crop_leak")
            if (overflow == 0 and leak == 0) or not recovery or attempt == max_retries:
                break
            reasons.append("overflow" if overflow > 0 else "leak")
            if overflow > 0:
                self._capacity_boost = getattr(self, "_capacity_boost", 1.0) * 1.5
                if self._compact_bins():
                    self._slots_seen = max(getattr(self, "_slots_seen", 0),
                                           self._telemetry_max(result, "_bin_need"))
                log.warning(
                    "bin overflow mid-refinement (up to %d dropped (tile, triangle) "
                    "pairs/step): growing bin capacity x%.2f and re-running "
                    "(attempt %d/%d)", overflow, self._capacity_boost, attempt + 1,
                    max_retries)
            if leak > 0:
                self._crop_disable = True
                log.warning(
                    "ROI crop leak mid-refinement (up to %d triangles/step outside "
                    "the crop interior): disabling the crop and re-running "
                    "(attempt %d/%d)", leak, attempt + 1, max_retries)
        self._render_fn = None  # the capacities (and the colours) may have changed
        with trace.span("run.host"):
            mesh = self.object3d.mesh
            for key in extra_params or ():
                setattr(mesh, key, result.params[key].detach().cpu().numpy())

            self._check_bin_overflow(result)
            self._bins_escaped = (self._check_bins(result) if getattr(self, "_bins", None)
                                  is not None and use_bins else None)
            self._result = result
            self.mtx_history = result.mtx_history.cpu().numpy()
            self.losses_values = {k: v.cpu().numpy() for k, v in result.losses_values.items()}
            self.optimization_results = RenderHistory(self)
            final_loss = float(result.total_loss[-1])
        compile_s = steady_sps = None
        if jit_refine is not None:
            compile_s = jit_refine.step0_s + jit_refine.capture_s
            if jit_refine.replays and dt > compile_s:
                steady_sps = jit_refine.replays / (dt - compile_s)
        self.last_run_stats = {
            "wall_time_s": dt,
            "steps": steps,
            "steps_per_sec": steps / dt,
            "compile_s": compile_s,
            "steady_steps_per_sec": steady_sps,
            "final_loss": final_loss,
            "recovery_reruns": attempt,
            "rerun_reasons": reasons,
        }
        log.info("refined %d hypotheses, %d steps in %.3fs (%.1f steps/s), "
                 "final loss %.5f", self.batchsize, steps, dt, steps / dt,
                 self.last_run_stats["final_loss"])

    def _appearance(self) -> Optional[Dict[str, torch.Tensor]]:
        """The appearance leaf that ``Mesh.enable_gradients_texture()``
        asks to refine (``diffdope.py:510-536``), or None: the texture map
        under ``tpu.texture_mode: exact``, else the corner colours, else
        the vertex colours."""
        mesh = self.object3d.mesh
        if not getattr(mesh, "optimize_appearance", False):
            return None
        exact = str(self._tpu().get("texture_mode", "baked")) == "exact"
        for key, value in (("tex", mesh.tex if exact else None),
                           ("corner_colors", mesh.corner_colors),
                           ("vtx_color", mesh.vtx_color)):
            if value is not None:
                return {key: torch.tensor(np.asarray(value, np.float32), device=self.device)}
        return None

    @staticmethod
    def _telemetry_max(result, key: str) -> int:
        """Worst per-step value of a telemetry counter (0 if absent)."""
        telem = result.telemetry or {}
        return int(telem[key].max()) if key in telem else 0

    def _check_bin_overflow(self, result) -> None:
        """Warn when the kept run dropped (tile, triangle) pairs or leaked
        out of the ROI crop at some step (``diffdope.py:751-785``)."""
        telem = result.telemetry or {}
        if "_crop_leak" in telem and int(telem["_crop_leak"].max()) > 0:
            lk = telem["_crop_leak"]
            log.warning(
                "ROI crop leak during refinement: up to %d triangles/step outside "
                "the crop interior (%d steps affected); set tpu.roi_crop=off",
                int(lk.max()), int((lk > 0).sum()))
        if "_bin_overflow" in telem and int(telem["_bin_overflow"].max()) > 0:
            ov = telem["_bin_overflow"]
            log.warning(
                "bin overflow during refinement: up to %d (tile, triangle) pairs "
                "dropped per step (worst at step %d/%d; %d steps affected); raise "
                "tpu.max_tris_per_tile", int(ov.max()), int(ov.argmax()), len(ov),
                int((ov > 0).sum()))

    @torch.no_grad()
    def _check_bins(self, result) -> int:
        """After a run over precomputed bins, which log no per-step binning
        telemetry: re-bin once at the final poses (``diffdope.py:786-
        820``), warn if the per-tile K would drop pairs there, and count
        the (tile, triangle) pairs those poses need that the precomputed
        bins lack (the poses left the margin), warned too; returns that
        count."""
        arrays, bins = self._mesh_arrays(), self._bins
        proj = np.asarray(self.camera.cam_proj, np.float32)
        mesh = _Mesh(proj, arrays["pos"], arrays["pos_idx"], None, None, None, self.device)
        cp = corner_planes(mesh.pos_c, matmul44(mesh.proj, result.mtx_history[-1]))
        det = det_planar(cp, mesh.degenerate)
        idx, counts, _ = bin_triangles_planar(cp, det, tuple(self.resolution), TILE_HW,
                                              mesh.t_count)
        k = bins.idx.shape[1]
        if int(counts.max()) > k:
            log.warning("bin overflow at the final poses: %d triangles in a tile, more "
                        "than the bins' K=%d", int(counts.max()), k)
        t = mesh.t_count
        held = torch.zeros((idx.shape[0], t + 1), dtype=torch.bool, device=self.device)
        held.scatter_(1, bins.idx.long(), True)
        need = torch.zeros_like(held)
        need.scatter_(1, idx.long(), True)
        escaped = int((need[:, :t] & ~held[:, :t]).sum())
        if escaped:
            log.warning("the final poses need %d (tile, triangle) pairs outside the "
                        "precomputed bins: raise tpu.bin_margin_px", escaped)
        return escaped

    @property
    def renders(self) -> dict:
        """The last step's renders."""
        return self.optimization_results[-1]

    def add_loss_value(self, key: str, values) -> None:
        """Append per-hypothesis values to the logged loss curves."""
        values = np.asarray(values)[None]
        if key not in self.losses_values:
            self.losses_values[key] = values
        else:
            self.losses_values[key] = np.concatenate([self.losses_values[key], values], axis=0)

    # ------------------------------------------------------------------ #
    # results
    # ------------------------------------------------------------------ #
    def _best_indices(self) -> tuple:
        """(step, hypothesis) of the selected pose under ``tpu.argmin_rule``
        (best_step by default, or last_step)."""
        if not self.losses_values:
            return -1, 0
        rule = str(self.cfg.get_dotted("tpu.argmin_rule", "best_step"))
        s, b = argmin_step_hypothesis(
            {k: torch.as_tensor(v) for k, v in self.losses_values.items()}, rule)
        return int(s), int(b)

    def get_argmin(self) -> int:
        """Index of the best hypothesis."""
        return self._best_indices()[1]

    def get_pose(self, batch_index: int = -1) -> np.ndarray:
        """The refined 4x4 pose (OpenGL frame): the selected (step,
        hypothesis) for -1, else that hypothesis at the last step."""
        if batch_index == -1:
            step, hyp = self._best_indices()
            return self.mtx_history[step][hyp]
        return self.mtx_history[-1][batch_index]

    def get_pose_opencv(self, batch_index: int = -1) -> np.ndarray:
        """The refined pose in the OpenCV/BOP frame."""
        return opengl_to_opencv(self.get_pose(batch_index))

    # ------------------------------------------------------------------ #
    # visualization (host-side, cv2)
    # ------------------------------------------------------------------ #
    def render_img(self, index: Optional[int] = None, batch_index: Optional[int] = None,
                   render_selection: str = "rgb") -> np.ndarray:
        """The overlay grid (uint8 BGR) of one step's renders, 'rgb',
        'depth' or 'mask', over the scene's (``diffdope.py:890-901``): the
        last step by default, every hypothesis or ``batch_index`` alone."""
        index = -1 if index is None else index
        entry = self.optimization_results[index]
        return self._compose_overlay(entry[render_selection], batch_index, render_selection)

    def _compose_overlay(self, gu: np.ndarray, batch_index: Optional[int],
                         render_selection: str,
                         final_width: Optional[int] = None) -> np.ndarray:
        """Crop, overlay and contours of rendered frames ``gu`` ((B, H, W[,
        C]) numpy) against the scene's gt (``diffdope.py:903-950``), as the
        ``render_images`` group of the configuration asks."""
        ri = self.cfg.get("render_images", ConfigNode())
        gt_map = {"rgb": "rgb", "depth": "depth", "mask": "segmentation"}
        gt = self.gt_tensors.get(gt_map.get(render_selection, render_selection))

        crop = None
        if ri.get("crop_around_mask", False):
            seg = self.gt_tensors.get("segmentation")
            crop = viz.find_crop(seg if seg is not None else gu[0])

        def prep(arr, batched):
            if arr is None:
                return None
            a = np.asarray(arr)
            if not batched:
                a = np.broadcast_to(a, (gu.shape[0],) + a.shape)
            if a.ndim == 3:
                a = viz.depth_to_rgb(a) if render_selection == "depth" else a[..., None]
            if crop is not None:
                t, l, s = crop
                a = a[:, t : t + s + 1, l : l + s + 1]
            return a

        fg = prep(gu, batched=True)
        bg = prep(gt, batched=False)
        if batch_index is not None:
            fg = fg[batch_index : batch_index + 1]
            bg = bg[batch_index : batch_index + 1] if bg is not None else None

        return viz.make_grid_overlay_batch(
            foreground=fg,
            background=bg,
            alpha=float(ri.get("alpha_overlay", 0.7)),
            row=int(ri.get("nrow", 4)),
            final_width=int(final_width or ri.get("final_width_batch", 2000)),
            add_background=bool(ri.get("add_background", True)),
            add_contour=bool(ri.get("add_countour", True)),
            color_contour=list(ri.get("color_countour", [0.46, 0.73, 0])),
            flip_result=bool(ri.get("flip_result", True)),
        )

    def make_animation(self, output_file_path: str = "animation.mp4", frame_rate: int = 10,
                       batch_index: int = -1, chunk: int = 16,
                       final_width: int = 800) -> None:
        """Write the refinement of one hypothesis (the argmin's by default)
        as an mp4 (``diffdope.py:952-990``): ``chunk`` steps per render,
        the step axis on the render's batch axis (the last chunk padded
        with its last pose), each frame composited at ``final_width``."""
        if batch_index == -1:
            batch_index = self.get_argmin()
        n = 0 if self.mtx_history is None else self.mtx_history.shape[0]
        if n == 0:
            raise ValueError("run_optimization() before make_animation()")
        poses = np.asarray(self.mtx_history[:, batch_index])  # (S, 4, 4)

        def frames():
            for s in range(0, n, chunk):
                mtxs = poses[s : s + chunk]
                pad = chunk - mtxs.shape[0]
                if pad:
                    mtxs = np.concatenate([mtxs, np.broadcast_to(mtxs[-1:], (pad, 4, 4))])
                with torch.no_grad():
                    rgb = self._render(torch.as_tensor(mtxs, device=self.device))["rgb"]
                rgb = rgb.cpu().numpy()
                for i in range(min(chunk, n - s)):
                    yield self._compose_overlay(rgb[i : i + 1], None, "rgb",
                                                final_width=final_width)

        viz.write_animation(frames(), output_file_path, frame_rate)

    def plot_losses(self, batch_index: int = -1) -> Optional[np.ndarray]:
        """The loss curves of one hypothesis (the argmin's by default) as a
        BGR image (``diffdope.py:992-997``; needs matplotlib)."""
        if batch_index == -1:
            batch_index = self.get_argmin()
        return viz.plot_losses_image(self.losses_values, batch_index)

    def cuda(self) -> None:
        """No-op (``diffdope.py:999``): the session runs on its ``device``,
        given when it is built."""
