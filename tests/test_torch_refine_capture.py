"""The refinement step as the port captures it (``optimize.refine``): a
function of device state only, as the reference's ``lax.scan`` body.

(a) The step scalars laid out once per call (the optimizers' ``tables``)
equal the host scalars the loop computed a step at a time: -lr(count)
from ``make_lr_schedule``, Adam's bias corrections and, for the card,
their reciprocals (the card divides by a host scalar as a product with
its float32 reciprocal), bit for bit, at ``nb_iterations`` 60 and 99 and
across segment boundaries (the count carried in ``opt_state``).

(b) One refinement step of every route ``DiffDope``, the bench and the
BOP sweep take runs, forward and backward, without an operation that
waits for the host or brings host data in (``HostSyncs``: a tensor's
value read, ``nonzero``, ``masked_select``, ``unique``, a boolean index,
a tensor made from host data), so it can be captured as a CUDA graph:
the icosphere(2) scene at 64x96, B=3, on the CPU.  The kernels' plain
twins, which a CUDA tensor never reaches, run unchecked.

The trajectories of the refactored loop against the JAX package are
``tests/test_torch_refine.py::test_torch_refine_trajectory`` and
``tests/test_torch_refine_options.py::test_torch_restarts_match_reference``.
"""

import contextlib
import functools
import importlib
import inspect
import pathlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from diffdope_tpu_torch import optimize
from diffdope_tpu_torch.optimize import make_optimizer, make_lr_schedule, refine
from torch_scene import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
RES = (64, 96)
B = 3
F32 = np.float32


def _host_scalars(name, count, length, base_lr, nb, b1=0.9, b2=0.999):
    """The scalars the eager loop computed on the host a step at a time."""
    sched = make_lr_schedule(base_lr, 0.1, nb)
    out = {"neg_lr": [float(-sched(c)) for c in range(count, count + length)]}
    if name == "adam":
        for key, b in (("bc1", b1), ("bc2", b2)):
            out[key] = [float(F32(1) - np.power(F32(b), F32(c + 1)))
                        for c in range(count, count + length)]
    return out


@pytest.mark.parametrize("name,base_lr", [("sgd", 20.0), ("adam", 0.02)])
@pytest.mark.parametrize("nb", [60, 99])
def test_torch_step_tables_equal_host_scalars(name, base_lr, nb):
    opt = make_optimizer(name, base_lr, 0.1, nb)
    total = nb + 1
    # one call, and the same steps in segments of 40 carrying the count
    for count, length in [(0, total)] + [(c, min(40, total - c)) for c in range(0, total, 40)]:
        want = _host_scalars(name, count, length, base_lr, nb)
        got = opt.tables(count, length)
        assert set(got) == set(want)
        for key, values in want.items():
            assert got[key].dtype == np.float32 and got[key].shape == (length,)
            assert got[key].tolist() == values, key
        if name == "adam":
            inv = opt.tables(count, length, reciprocal=True)
            assert set(inv) == {"neg_lr", "inv_bc1", "inv_bc2"}
            assert inv["neg_lr"].tolist() == want["neg_lr"]
            for key in ("bc1", "bc2"):
                assert inv["inv_" + key].tolist() == [float(F32(1) / F32(v))
                                                       for v in want[key]], key


@pytest.mark.parametrize("name,base_lr", [("sgd", 20.0), ("adam", 0.02)])
def test_torch_in_place_update_equals_the_host_scalar_step(name, base_lr):
    """One in-place update from a table row equals the step with the host
    scalars as Python floats, bit for bit, at counts past a segment's
    start."""
    opt = make_optimizer(name, base_lr, 0.1, 60)
    rng = np.random.default_rng(0)
    params = {k: torch.tensor(rng.normal(size=B).astype(F32)) for k in "ab"}
    grads = {k: torch.tensor(rng.normal(size=B).astype(F32)) for k in "ab"}
    state = opt.init(params)
    if name == "adam":
        for moment in ("mu", "nu"):
            state[moment] = {k: torch.tensor(rng.uniform(0, 1, B).astype(F32)) for k in "ab"}
    count = 41
    s = _host_scalars(name, count, 1, base_lr, 60)
    want = {}
    for k, p in params.items():
        g = grads[k]
        if name == "sgd":
            want[k] = p + s["neg_lr"][0] * g
        else:
            mu = (1 - 0.9) * g + 0.9 * state["mu"][k]
            nu = (1 - 0.999) * g ** 2 + 0.999 * state["nu"][k]
            want[k] = p + s["neg_lr"][0] * ((mu / s["bc1"][0])
                                            / (torch.sqrt(nu / s["bc2"][0]) + 1e-8))
    row = {k: torch.as_tensor(v)[0] for k, v in opt.tables(count, 1).items()}
    got = {k: v.clone() for k, v in params.items()}
    with torch.no_grad():
        opt.update(grads, state, got, row)
    for k in params:
        assert torch.equal(got[k], want[k]), k


class HostSyncs(TorchDispatchMode):
    """Raise on an operation that waits for the host or brings host data
    in, while ``armed`` and not ``paused``; ``callback`` is a
    ``step_callback`` that disarms it and counts the steps."""

    BANNED = {"_local_scalar_dense", "nonzero", "masked_select", "unique_dim",
              "_unique", "_unique2", "unique_consecutive", "bincount", "equal",
              "repeat_interleave", "lift_fresh", "masked_scatter"}
    INDEXING = {"index", "index_put", "index_put_", "_index_put_impl_"}

    def __init__(self):
        super().__init__()
        self.armed, self.paused, self.ops, self.steps = False, 0, 0, 0

    def callback(self, i, total):
        self.armed = False
        self.steps += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.armed and not self.paused:
            self.ops += 1
            name = func.overloadpacket.__name__
            if name in self.BANNED:
                raise AssertionError(f"a step calls {func}")
            if name in self.INDEXING and any(
                    t is not None and t.dtype == torch.bool for t in args[1]):
                raise AssertionError(f"a step indexes with a boolean mask ({func})")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def syncs_for(monkeypatch, mode=None):
    """A ``HostSyncs`` mode (or ``mode``, one of its subclasses) armed from
    each step's ``pose_matrix`` to its ``step_callback``
    (``refine(step_callback=mode.callback)``), the kernels' plain twins
    paused."""
    mode = HostSyncs() if mode is None else mode

    def paused(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            mode.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                mode.paused -= 1
        return run

    for name in ("fused_loss", "gather_rows", "pack_kernel", "raster", "raster_v3",
                 "rasterize"):
        module = importlib.import_module(f"diffdope_tpu_torch.render.{name}")
        for name, fn in list(vars(module).items()):
            if name.endswith("_plain") and inspect.isfunction(fn):
                monkeypatch.setattr(module, name, paused(fn))
    own = optimize.pose_matrix

    def pose_matrix(params):
        mode.armed = True
        return own(params)

    monkeypatch.setattr(optimize, "pose_matrix", pose_matrix)
    with mode:
        yield mode


def _bench(device, **variant):
    from diffdope_tpu_torch.bench import bench_problem

    return bench_problem(RES, subdiv=2, batch=B, device=device, **variant)


def _fused(variant, env=None):
    def build(mp, device="cpu"):
        for name, value in (env or {}).items():
            mp.setenv(name, value)
        pb = _bench(device, **variant)
        return pb["params0"], dict(fused_loss_fn=pb["fn"])
    return build


def _bins(mp, device="cpu"):
    """The bench loss over bins precomputed at the init (phase 16 (c))."""
    from diffdope_tpu_torch.render.pipeline import make_fused_loss, precompute_bins

    pb = _bench(device)
    s = pb["scene"]
    mtx0, _, _ = optimize.pose_matrix(pb["params0"])
    bins = precompute_bins(s["proj"], mtx0, s["pos"], s["tri"], RES, device=device)
    fn = make_fused_loss(s["proj"], s["pos"], s["tri"], RES, pb["gt"], pb["lrs"],
                         pb["weights"], use_rgb=True, use_mask=True,
                         edge_adj=s["edge_adj"], vtx_color=s["vtx_color"],
                         compact_total=pb["compact_total"], device=device, bins=bins)
    return pb["params0"], dict(fused_loss_fn=fn)


def _bop(mp, device="cpu"):
    """The BOP sweep's context: the ground truth and the loss scales given
    per call (phase 17), here as numpy arrays, which ``refine`` moves to
    the device before the first step."""
    from diffdope_tpu_torch.render.pipeline import make_fused_loss

    pb = _bench(device)
    s = pb["scene"]
    fn = make_fused_loss(s["proj"], s["pos"], s["tri"], RES, None, pb["lrs"],
                         pb["weights"], use_rgb=True, use_mask=True,
                         edge_adj=s["edge_adj"], vtx_color=s["vtx_color"], device=device)
    return pb["params0"], dict(fused_loss_fn=fn, gt=pb["gt"], learning_rates=pb["lrs"])


def _session(mp, fused_loss=True, textured=False, raster_impl="pallas", device="cpu",
             texture_mode="exact"):
    """A DiffDope on the scene (the gt its own render near the init, on
    the CPU); a textured mesh refines its appearance, under
    ``texture_mode``."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.mesh import build_edge_adjacency
    from diffdope_tpu_torch.render.pipeline import render_batch
    from diffdope_tpu_torch.testing import icosphere, quantize8, spherical_uv, textured_mesh

    verts, faces = icosphere(2)
    if textured:
        tex = quantize8(np.random.default_rng(3).uniform(0.1, 0.9, (32, 32, 3)))
        mesh = textured_mesh(verts, faces, spherical_uv(verts), tex, 0.4)
        mesh.enable_gradients_texture()
    else:
        mesh = tdd.Mesh(pos=(verts * 0.4).astype(F32), pos_idx=faces, vtx_normals=verts,
                        num_vertices=len(verts), num_triangles=len(faces),
                        vtx_color=(verts * 0.5 + 0.5).astype(F32),
                        edge_adj=build_edge_adjacency(faces))
    h, w = RES
    camera = tdd.Camera(fx=110.0, fy=110.0, cx=w / 2, cy=h / 2, im_width=w, im_height=h)
    mtx_gt = optimize.pose_matrix(optimize.pose_params(
        np.array([0, 0, 0, 1.0], F32), np.array([0.05, 0.0, -3.0], F32), 1, "cpu"))[0]
    colors = (dict(tex=mesh.tex, uv=mesh.uv, uv_idx=mesh.uv_idx) if textured
              else dict(vtx_color=mesh.vtx_color))
    gtr = render_batch(camera.cam_proj, mtx_gt, mesh.pos, mesh.pos_idx, RES,
                       edge_adj=mesh.edge_adj, raster_impl="pallas", device="cpu", **colors)
    scene = tdd.Scene(tensor_rgb=tdd.Image(img_tensor=gtr["rgb"][0].numpy()),
                      tensor_segmentation=tdd.Image(img_tensor=gtr["mask"][0].numpy()))
    obj = tdd.Object3D(position=[0.013, -0.021, 3.0], rotation=[0.01, -0.02, 0.015, 1.0],
                       batchsize=B, mesh=mesh)
    overrides = [f"hyperparameters.batchsize={B}", f"tpu.raster_impl={raster_impl}",
                 "tpu.progress=false", "losses.l1_rgb_with_mask=true",
                 f"tpu.fused_loss={str(fused_loss).lower()}"]
    if textured:
        overrides.append(f"tpu.texture_mode={texture_mode}")
    cfg = tdd.load_config(ROOT / "configs" / "diffdope.yaml", overrides)
    return tdd.DiffDope(cfg=cfg, camera=camera, object3d=obj, scene=scene, device=device)


def _unfused(mp, device="cpu", raster_impl="pallas"):
    """DiffDope's unfused render_batch route (phase 6), or with
    ``raster_impl`` 'reference' its brute-force rasterizer (phase 10)."""
    dd = _session(mp, fused_loss=False, raster_impl=raster_impl, device=device)
    gt = {k: torch.as_tensor(v, device=device) for k, v in dd.gt_tensors.items()}
    return dd.object3d.initial_params(B, device), dict(
        render_fn=dd._make_render_fn(), loss_fns=tuple(dd.loss_functions), gt=gt,
        learning_rates=dd.learning_rates, weights=dd.loss_weights)


def _appearance(mp, device="cpu", leaf="tex"):
    """DiffDope's appearance refinement (phase 15): the texture a leaf, or
    the baked corner colours ('corner_colors'), or the vertex colours
    ('vtx_color')."""
    if leaf == "vtx_color":
        dd = _session(mp, device=device)
        dd.object3d.mesh.enable_gradients_texture()
    else:
        dd = _session(mp, textured=True, device=device,
                      texture_mode="exact" if leaf == "tex" else "baked")
    assert set(dd._appearance()) == {leaf}
    gt = {k: torch.as_tensor(v, device=device) for k, v in dd.gt_tensors.items()}
    return dd.object3d.initial_params(B, device), dict(
        render_fn=dd._make_render_fn(), loss_fns=tuple(dd.loss_functions), gt=gt,
        learning_rates=dd.learning_rates, weights=dd.loss_weights,
        extra_params=dd._appearance())


def _api(mp, device="cpu"):
    """The nvdiffrast-style API path under refine: xfm_points -> rasterize
    (the binned search, K8 on the card) -> interpolate -> antialias (phase 9)."""
    from diffdope_tpu_torch import antialias, interpolate, rasterize, xfm_points
    from diffdope_tpu_torch.geometry import matmul44
    from diffdope_tpu_torch.losses import l1_mask, l1_rgb_with_mask

    pb = _bench(device)
    s = pb["scene"]
    proj = torch.as_tensor(s["proj"], device=device)
    pos = torch.as_tensor(s["pos"], device=device)
    tri = torch.as_tensor(s["tri"], device=device).long()
    colors = torch.as_tensor(s["vtx_color"], device=device)
    adj = torch.as_tensor(s["edge_adj"], device=device).long()

    def render_fn(mtx):
        pos_clip = xfm_points(pos, matmul44(proj, mtx))
        rast, db = rasterize(pos_clip, tri, RES, impl="pallas", tile_hw=(32, 128),
                             max_tris_per_tile=320)
        rgb, _ = interpolate(colors, rast, tri, db, diff_attrs="all")
        mask = antialias((rast[..., 3:4] > 0).float(), rast, pos_clip, tri, edge_adj=adj)
        return {"rgb": rgb, "mask": mask[..., 0]}

    gt = {k: torch.as_tensor(v, device=device) for k, v in pb["gt"].items()}
    return pb["params0"], dict(render_fn=render_fn, loss_fns=(l1_rgb_with_mask, l1_mask),
                               gt=gt, learning_rates=torch.as_tensor(pb["lrs"], device=device),
                               weights=pb["weights"])


#: every route DiffDope, the bench and the BOP sweep take, by chip_smoke.py
#: phase: ``build(monkeypatch, device="cpu") -> (params0, refine keywords)``
#: (``tests/test_torch_cuda.py`` builds them on the card)
ROUTES = {
    "compact_bf16": _fused({}, {"DD_DROWS_BF16": "1"}),  # bench, phase 5
    "depth_compact": _fused({"depth": True}),  # phase 7
    "depth_uniform": _fused({"depth": True, "uniform": True}),  # phase 8
    "v3": _fused({"route": "v3"}),  # phase 11
    "v2": _fused({"route": "v2"}),  # phase 12 (DD_BINNED=0)
    "unfused": _unfused,  # phase 6
    "brute_force": functools.partial(_unfused, raster_impl="reference"),  # phase 10
    "api": _api,  # phase 9 under refine
    "texture": _fused({"texture": True}),  # phase 14
    "texture_depth": _fused({"texture": True, "depth": True}),  # phase 14, depth
    "appearance": _appearance,  # phase 15
    "bins": _bins,  # phase 16 (c)
    "bop": _bop,  # phase 17
}


def optimizer_of(route):
    """The optimizer and base learning rate a route's test refines with."""
    return ("adam", 0.02) if route in ("compact_bf16", "bop", "appearance") else ("sgd", 1.0)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_torch_step_waits_for_no_host(route, monkeypatch):
    params0, kw = ROUTES[route](monkeypatch)
    optimizer, base_lr = optimizer_of(route)
    with syncs_for(monkeypatch) as mode:
        res = refine(params0, nb_iterations=1, base_lr=base_lr, optimizer=optimizer,
                     step_callback=mode.callback, **kw)
    assert mode.steps == 2 and mode.ops > 0
    assert res.total_loss.shape == (2,) and bool(torch.isfinite(res.total_loss).all())
    assert any(not torch.equal(res.params[k], v) for k, v in params0.items())
