"""The port's hand kernels (K1-K10, K5/K6 with the depth and the colour
lane, K1/K2 at the uv tables' two channels) against their plain torch
versions, a DiffDope run, the planar routes' and the exact-texture loss
and the ``rasterize`` op on the card against the same on the CPU.

A CUDA kernel has no CPU mode, so every test here needs a card and skips
without one.  On a machine with a card (the repo's conftest imports jax,
which that machine does not need):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

from diffdope_tpu_torch import kernels
from diffdope_tpu_torch.bench import bench_problem, distinct_poses, drows_env
from diffdope_tpu_torch.geometry import matmul44, xfm_points
from diffdope_tpu_torch.kernels.check import (
    check_gather_rows,
    check_kernels,
    check_pack,
    check_raster_ids,
    gather_rows_inputs,
    raster_ids_inputs,
)
from diffdope_tpu_torch.optimize import pose_matrix
from torch_scene import one_torch_thread  # noqa: F401

import test_torch_refine_capture as capture
import test_torch_refine_kept as kept
import test_torch_repeatable as repeatable

pytestmark = pytest.mark.cuda

RES = (64, 96)
B = 3


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problem(cuda):
    return bench_problem(RES, subdiv=2, batch=B, device=cuda)


@pytest.fixture(scope="module")
def params(problem):
    """Each hypothesis at a pose of its own."""
    return distinct_poses(problem["params0"], 0.01)


@pytest.fixture(scope="module")
def checks(problem, params):
    """K1-K6 (and the spanning op's bf16 lane of K6 and K4) on the bench
    problem's compact tables; K7 and the depth lane of K5/K6 on its
    uniform-table depth variant."""
    mtx, _, _ = pose_matrix(params)
    d_sums = torch.tensor([[1.0, 0.7, 0.9], [0.5, 1.3, 1.1], [2.0, 0.2, 0.4]],
                          device=mtx.device)
    uniform = bench_problem(RES, subdiv=2, batch=B, device=mtx.device, depth=True,
                            uniform=True)
    rows = (check_pack(problem["fn"], mtx) + check_kernels(problem["fn"], mtx, d_sums)
            + check_kernels(uniform["fn"], mtx, d_sums))
    return {row["name"]: row for row in rows}


@pytest.mark.parametrize(
    "kernel", ["K1_pack_fwd", "K2_pack_bwd", "K3_raster_fwd", "K4_raster_bwd",
               "K5_loss_fwd", "K6_loss_bwd", "K7_raster_uniform_fwd",
               "K7_raster_uniform_bwd", "K5_loss_fwd_depth", "K6_loss_bwd_depth",
               "K6_loss_bwd_bf16", "K4_raster_bwd_bf16"]
)
def test_kernel_matches_plain_on_card(checks, kernel):
    row = checks[kernel]
    assert row["ok"], row


def _value_and_grad(fn, params, device):
    p = {k: v.detach().to(device).requires_grad_(True) for k, v in params.items()}
    mtx, _, _ = pose_matrix(p)
    total, _ = fn(mtx)
    grads = torch.autograd.grad(total, list(p.values()))
    return total.detach().cpu(), {k: g.cpu() for k, g in zip(p, grads)}


def _cpu_fused_loss(problem):
    from diffdope_tpu_torch.render.pipeline import make_fused_loss

    s = problem["scene"]
    return make_fused_loss(
        s["proj"], s["pos"], s["tri"], RES, problem["gt"], problem["lrs"],
        problem["weights"], use_rgb=True, use_mask=True, edge_adj=s["edge_adj"],
        vtx_color=s["vtx_color"], compact_total=problem["compact_total"],
        device="cpu",
    )


def test_fused_loss_on_card_matches_cpu(problem, params):
    """The whole step (table, spanning op with f32 d_rows, total) on the
    card, through the kernels, against the same step on the CPU, through
    the plain versions: loss rtol 1e-5, pose gradients rtol 2e-4 / atol
    1e-6."""
    with drows_env(False):
        fn_gpu = bench_problem(RES, subdiv=2, batch=B, device=problem["fn"].gt6.device)["fn"]
        fn_cpu = _cpu_fused_loss(problem)
    kernels.reset_launches()
    v_gpu, g_gpu = _value_and_grad(fn_gpu, params, "cuda")
    six = ("pack_fwd", "pack_bwd", "raster_fwd", "raster_bwd", "loss_fwd", "loss_bwd")
    assert all(kernels.launches[c] == (1 if c in six else 0)
               for c in kernels.launches), kernels.launches
    v_cpu, g_cpu = _value_and_grad(fn_cpu, params, "cpu")
    np.testing.assert_allclose(v_gpu.numpy(), v_cpu.numpy(), rtol=1e-5, atol=1e-7)
    for k in g_cpu:
        np.testing.assert_allclose(g_gpu[k].numpy(), g_cpu[k].numpy(),
                                   rtol=2e-4, atol=1e-6, err_msg=k)


def test_fused_loss_bf16_lane_on_card(problem, params):
    """The default lane (DD_DROWS_BF16 unset: bf16 d_rows between K6 and
    K4) on the card: the bf16 K6 and K4 launch once each and their f32
    instantiations not at all; its pose gradients against the CPU's
    bf16 lane and the card's f32 lane within the contract's bf16 clause
    (atol 2e-2 of the component's scale), and apart from the f32 lane's."""
    assert problem["fn"].drows_bf16
    kernels.reset_launches()
    v_gpu, g_gpu = _value_and_grad(problem["fn"], params, "cuda")
    on = ("pack_fwd", "pack_bwd", "raster_fwd", "raster_bwd_bf16", "loss_fwd",
          "loss_bwd_bf16")
    assert all(kernels.launches[c] == (1 if c in on else 0)
               for c in kernels.launches), kernels.launches
    with drows_env(True):
        fn_cpu = _cpu_fused_loss(problem)
    with drows_env(False):
        fn_f32 = bench_problem(RES, subdiv=2, batch=B, device=problem["fn"].gt6.device)["fn"]
    _, g_cpu = _value_and_grad(fn_cpu, params, "cpu")
    _, g_f32 = _value_and_grad(fn_f32, params, "cuda")
    assert any(not torch.equal(g_gpu[k], g_f32[k]) for k in g_gpu)
    for want in (g_cpu, g_f32):
        for k, g in want.items():
            scale = float(g.abs().max())
            np.testing.assert_allclose(g_gpu[k].numpy(), g.numpy(), rtol=0,
                                       atol=2e-2 * scale, err_msg=k)


def _diffdope_session(device, fused):
    """A 2-step DiffDope session on icosphere(2) at 48x64, B=3, the gt the
    port's own render (rendered on the CPU, so both devices see the same
    images), the init off the gt pose."""
    import diffdope_tpu_torch as tdd
    from diffdope_tpu_torch.render.pipeline import render_rgb_mask
    from diffdope_tpu_torch.testing import icosphere

    h, w = 48, 64
    verts, faces = icosphere(2)
    mesh = tdd.Mesh(pos=verts * 0.4, pos_idx=faces, vtx_normals=verts,
                    num_vertices=len(verts), num_triangles=len(faces),
                    vtx_color=verts * 0.5 + 0.5,
                    edge_adj=tdd.build_edge_adjacency(faces))
    camera = tdd.Camera(fx=60.0, fy=60.0, cx=w / 2, cy=h / 2, im_width=w, im_height=h)
    mtx_gt, _, _ = pose_matrix(tdd.pose_params([0, 0, 0, 1.0], [0.05, 0.0, -3.0], 1, "cpu"))
    gt = render_rgb_mask(camera.cam_proj, mtx_gt, mesh.pos, mesh.pos_idx, (h, w),
                         edge_adj=mesh.edge_adj, vtx_color=mesh.vtx_color, device="cpu")
    scene = tdd.Scene(tensor_rgb=tdd.Image(img_tensor=gt["rgb"][0].numpy()),
                      tensor_segmentation=tdd.Image(img_tensor=gt["mask"][0].numpy()))
    obj = tdd.Object3D(position=[0.013, -0.021, 3.0], rotation=[0.01, -0.02, 0.015, 1.0],
                       batchsize=B, mesh=mesh)
    cfg = {"losses": {"l1_mask": True, "l1_rgb_with_mask": True, "weight_rgb": 0.7},
           "hyperparameters": {"batchsize": B, "nb_iterations": 1,
                               "learning_rates_bound": [0.5, 2.0]},
           "tpu": {"fused_loss": fused, "progress": False}}
    d = tdd.DiffDope(cfg=tdd.ConfigNode(cfg), camera=camera, object3d=obj, scene=scene,
                     device=device)
    d.run_optimization()
    return d


@pytest.mark.parametrize("fused", [True, False])
def test_diffdope_on_card_matches_cpu(cuda, fused):
    """The same session on the card (K1-K6 or K1-K4) and on the CPU (the
    plain versions), the spanning op's d_rows in f32: step-0 losses rtol
    1e-5, the poses after one SGD step atol 1e-5."""
    kernels.reset_launches()
    with drows_env(False):  # the f32 d_rows lane, bit for bit the chained ops
        on_card = _diffdope_session(cuda, fused)
        counters = ("pack_fwd", "pack_bwd", "raster_fwd", "raster_bwd") + (
            ("loss_fwd", "loss_bwd") if fused else ())
        assert all(kernels.launches[c] > 0 for c in counters), kernels.launches
        on_cpu = _diffdope_session("cpu", fused)
    for k, v in on_cpu.losses_values.items():
        np.testing.assert_allclose(on_card.losses_values[k][0], v[0], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(on_card.mtx_history, on_cpu.mtx_history, atol=1e-5)


def _pos_clip(problem, params, device):
    s = problem["scene"]
    mtx, _, _ = pose_matrix({k: v.to(device) for k, v in params.items()})
    proj = torch.as_tensor(s["proj"], device=device)
    return xfm_points(torch.as_tensor(s["pos"], device=device), matmul44(proj, mtx))


@pytest.mark.parametrize("tile", [(16, 32), (32, 128)])
def test_k8_matches_plain_on_card(problem, params, tile):
    """K8 against its plain twin on the bins of three distinct poses, one
    launch per call; (32, 128) pads the 96-wide frame."""
    tri = torch.as_tensor(problem["scene"]["tri"], device="cuda").long()
    inputs = raster_ids_inputs(_pos_clip(problem, params, "cuda"), tri, RES, tile)
    kernels.reset_launches()
    row = check_raster_ids(*inputs, RES, tile)
    assert kernels.launches["raster_ids"] == 1, kernels.launches
    assert row["ok"] and row["fg_pixels"] > 1000, row


def test_rasterize_on_card_matches_cpu(problem, params):
    """The rasterize op through K8 on the card and through its plain twin on
    the CPU: the same setup bits, so ids, rast and rast_db equal; the
    gradient to the clip positions rtol 2e-4, atol 1e-6 plus 1e-6 of the
    vertex's largest component (the torch ops around the gathers round
    apart on the two devices, and a component that sums cancelling
    per-pixel terms keeps their rounding: tests/test_torch_rasterize.py)."""
    from diffdope_tpu_torch.render.rasterize import rasterize

    tri = problem["scene"]["tri"]
    out = {}
    for device in ("cuda", "cpu"):
        pos_clip = _pos_clip(problem, params, device).detach().requires_grad_(True)
        rast, db = rasterize(pos_clip, tri, RES, impl="pallas")
        (grad,) = torch.autograd.grad((rast[..., :3].sum() + 1e-3 * db.sum()), pos_clip)
        out[device] = (rast.detach().cpu(), db.detach().cpu(), grad.cpu())
    assert torch.equal(out["cuda"][0], out["cpu"][0])
    assert torch.equal(out["cuda"][1], out["cpu"][1])
    got, want = out["cuda"][2].numpy(), out["cpu"][2].numpy()
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-6 + 2e-4 * np.abs(want) + 1e-6 * scale)


def test_rasterize_gradient_repeats_on_card(problem, params):
    """rasterize's backward on the card (the setup rows' segmented sum,
    one launch a backward) gives the same gradient bit for bit from call
    to call, and the segmented sum equals its plain twin (an index_add,
    with atomics on the card) within rtol 2e-4, atol 1e-6 plus 1e-6 of the
    row's largest term sum."""
    from diffdope_tpu_torch.render.rasterize import (
        rasterize,
        setup_rows_bwd,
        setup_rows_bwd_plain,
    )

    tri = problem["scene"]["tri"]
    grads = []
    for _ in range(2):
        pos_clip = _pos_clip(problem, params, "cuda").detach().requires_grad_(True)
        rast, db = rasterize(pos_clip, tri, RES, impl="pallas")
        kernels.reset_launches()
        (grad,) = torch.autograd.grad((rast[..., :3].sum() + 1e-3 * db.sum()), pos_clip)
        assert kernels.launches["setup_rows_bwd"] == 1, kernels.launches
        grads.append(grad)
    assert torch.equal(grads[0], grads[1]) and float(grads[0].abs().max()) > 0
    ids = rast[..., 3].to(torch.int32).reshape(B, -1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    d = torch.randn(ids.shape + (16,), generator=gen, device="cuda")
    got = setup_rows_bwd(d, ids, len(tri))
    want = setup_rows_bwd_plain(d, ids, len(tri))
    scale = setup_rows_bwd_plain(d.abs(), ids, len(tri))
    assert torch.equal(got, setup_rows_bwd(d, ids, len(tri)))
    assert bool(torch.all((got - want).abs() <= 1e-6 + 2e-4 * want.abs() + 1e-6 * scale))


@pytest.fixture(scope="module")
def planar_checks(problem, params):
    """K10 on the 'v3' route's sorted table and K7 over the 'v2' route's
    gathered bins, each with K5/K6, at three distinct poses."""
    mtx, _, _ = pose_matrix(params)
    d_sums = torch.tensor([[1.0, 0.7, 0.0], [0.5, 1.3, 0.0], [2.0, 0.2, 0.0]],
                          device=mtx.device)
    rows = {}
    for route in ("v3", "v2"):
        fn = bench_problem(RES, subdiv=2, batch=B, device=mtx.device, route=route)["fn"]
        rows[route] = {row["name"]: row for row in check_kernels(fn, mtx, d_sums)}
    return rows


@pytest.mark.parametrize("route,kernel", [
    ("v3", "K10_raster_v3_fwd"), ("v3", "K10_raster_v3_bwd"), ("v3", "K6_loss_bwd"),
    ("v2", "K7_raster_uniform_fwd"), ("v2", "K7_raster_uniform_bwd")])
def test_planar_kernels_match_plain_on_card(planar_checks, route, kernel):
    row = planar_checks[route][kernel]
    assert row["ok"], row


@pytest.mark.parametrize("tile", [(16, 32), (32, 128)])
def test_k9_matches_plain_on_card(problem, params, tile):
    """K9's forward and backward against their plain versions on the packed
    rows and bins of three distinct poses, one launch each."""
    s = problem["scene"]
    pos_clip = _pos_clip(problem, params, "cuda")
    tri = torch.as_tensor(s["tri"], device="cuda").long()
    inputs = gather_rows_inputs(pos_clip, tri, RES, tile,
                                torch.as_tensor(s["vtx_color"], device="cuda"),
                                torch.as_tensor(s["edge_adj"], device="cuda").long())
    kernels.reset_launches()
    fwd, bwd = check_gather_rows(*inputs, RES, tile)
    assert kernels.launches["gather_rows_fwd"] == kernels.launches["gather_rows_bwd"] == 1
    assert fwd["ok"] and fwd["fg_pixels"] > 1000, fwd
    assert bwd["ok"], bwd


@pytest.mark.parametrize("route", ["v3", "v2"])
def test_planar_fused_loss_on_card_matches_cpu(problem, params, route):
    """A planar route's whole step on the card (K10, or K7 over the gathered
    bins, then K5/K6; no pack kernel) against the same on the CPU: loss
    rtol 1e-5, pose gradients rtol 2e-4 / atol 1e-6."""
    from diffdope_tpu_torch.bench import raster_env
    from diffdope_tpu_torch.render.pipeline import make_fused_loss

    s = problem["scene"]
    fns = {}
    with raster_env(route):
        for device in ("cuda", "cpu"):
            fns[device] = make_fused_loss(
                s["proj"], s["pos"], s["tri"], RES, problem["gt"], problem["lrs"],
                problem["weights"], use_rgb=True, use_mask=True, edge_adj=s["edge_adj"],
                vtx_color=s["vtx_color"], device=device)
    out = {}
    for device, fn in fns.items():
        kernels.reset_launches()
        p = {k: v.detach().to(device).requires_grad_(True) for k, v in params.items()}
        mtx, _, _ = pose_matrix(p)
        total, _ = fn(mtx)
        grads = torch.autograd.grad(total, list(p.values()))
        out[device] = (total.detach().cpu(), [g.cpu() for g in grads], dict(kernels.launches))
    # on 'v2' the segmented sum adds each triangle's slot cotangents, one
    # launch for every hypothesis
    on = {c: 1 for c in (("raster_v3_fwd", "raster_v3_bwd") if route == "v3"
                         else ("raster_uniform_fwd", "raster_uniform_bwd", "index_rows_bwd"))
          + ("loss_fwd", "loss_bwd")}
    launches = out["cuda"][2]
    assert all(launches[c] == on.get(c, 0) for c in launches), launches
    np.testing.assert_allclose(out["cuda"][0].numpy(), out["cpu"][0].numpy(), rtol=1e-5,
                               atol=1e-7)
    for g, want in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=2e-4, atol=1e-6)


@pytest.fixture(scope="module")
def texture_checks(params):
    """K1/K2 at n_ch 2 (the uv table) and K3-K6 with the colour lane on the
    bench problem textured, without and with the depth plane."""
    mtx, _, _ = pose_matrix(params)
    d_sums = torch.tensor([[1.0, 0.7, 0.9], [0.5, 1.3, 1.1], [2.0, 0.2, 0.4]],
                          device=mtx.device)
    rows = {}
    for depth in (False, True):
        fn = bench_problem(RES, subdiv=2, batch=B, device=mtx.device, texture=True,
                           depth=depth)["fn"]
        assert fn.mesh.n_ch == 2 and fn.sample.packed
        for row in check_pack(fn, mtx) + check_kernels(fn, mtx, d_sums):
            rows[row["name"]] = row
    return rows


@pytest.mark.parametrize(
    "kernel", ["K1_pack_fwd", "K2_pack_bwd", "K5_loss_fwd_color", "K6_loss_bwd_color",
               "K5_loss_fwd_color_depth", "K6_loss_bwd_color_depth"]
)
def test_texture_kernels_match_plain_on_card(texture_checks, kernel):
    row = texture_checks[kernel]
    assert row["ok"], row


def test_fused_texture_loss_on_card_matches_cpu(problem, params):
    """The exact-texture step on the card (K1-K4, the colour lane of K5/K6,
    the plain sampler between them) against the same on the CPU: loss rtol
    1e-5, pose gradients rtol 2e-4 / atol 1e-6; the plain pack never runs."""
    out = {}
    for device in ("cuda", "cpu"):
        fn = bench_problem(RES, subdiv=2, batch=B, device=device, texture=True)["fn"]
        kernels.reset_launches()
        p = {k: v.detach().to(device).requires_grad_(True) for k, v in params.items()}
        total, _ = fn(pose_matrix(p)[0])
        grads = torch.autograd.grad(total, list(p.values()))
        out[device] = (total.detach().cpu(), [g.cpu() for g in grads], dict(kernels.launches))
    on = ("pack_fwd", "pack_bwd", "raster_fwd", "raster_bwd", "loss_fwd_color",
          "loss_bwd_color")
    launches = out["cuda"][2]
    assert all(launches[c] == (1 if c in on else 0) for c in launches), launches
    np.testing.assert_allclose(out["cuda"][0].numpy(), out["cpu"][0].numpy(), rtol=1e-5,
                               atol=1e-7)
    for g, want in zip(out["cuda"][1], out["cpu"][1]):
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=2e-4, atol=1e-6)


def _pack_fn(n_ch, b, n, seed, all_sentinel=False):
    """A stand-in for a loss function's pack inputs (``mesh`` and
    ``binned``, what ``check_pack`` reads) on the random problem of
    ``test_torch_pack_kernel`` (sentinel slots, degenerate triangles),
    on the card; with ``all_sentinel`` every slot is a sentinel."""
    from types import SimpleNamespace

    from test_torch_pack_kernel import _inputs_random

    from diffdope_tpu_torch.render.planar import static_pack_rows

    x = _inputs_random(n_ch, b=b, n=n, seed=seed)
    if all_sentinel:
        x["flat"][:] = x["t_count"]
    dev = torch.device("cuda")
    pos_c = torch.tensor(x["pos_c"], device=dev)
    attrs = torch.tensor(x["attrs"], device=dev)
    degen = torch.tensor(x["degen"], device=dev)
    mesh = SimpleNamespace(pos_c=pos_c, attrs=attrs, degenerate=degen, t_count=x["t_count"],
                           static=static_pack_rows(pos_c, attrs, degen))
    bn = SimpleNamespace(flat=torch.tensor(x["flat"], device=dev),
                         mvp=torch.tensor(x["mvp"], device=dev),
                         sil=torch.tensor(x["sil"], device=dev),
                         off_c=torch.zeros(1, dtype=torch.int32, device=dev))  # no tiles
    return SimpleNamespace(mesh=mesh, binned=lambda mtx: bn), torch.tensor(x["mtx"], device=dev)


@pytest.mark.parametrize("case", ["random_rgb", "random_uv", "all_sentinel", "scene_uniform",
                                  "scene_uv"])
def test_k2_matches_plain_and_repeats_on_card(cuda, params, case):
    """K2 against its plain twin (rtol 2e-4, atol 1e-6 plus 1e-6 of the
    hypothesis' sum of |terms|) at n_ch 3 and 2, with B and n no multiple
    of K2's 2048-slot chunk, on a table of sentinels only, on the test
    scene's uniform-K and uv tables; two launches bit for bit."""
    from diffdope_tpu_torch.kernels.check import pack_inputs
    from diffdope_tpu_torch.render.pack_kernel import _CHUNK, pack_bwd

    if case.startswith("scene"):
        kw = {"uniform": True} if case == "scene_uniform" else {"texture": True}
        fn = bench_problem(RES, subdiv=2, batch=B, device=cuda, **kw)["fn"]
        mtx, _, _ = pose_matrix(params)
    else:
        fn, mtx = _pack_fn(2 if case == "random_uv" else 3, 5, 5000, seed=3,
                           all_sentinel=case == "all_sentinel")
    row = [r for r in check_pack(fn, mtx) if r["name"] == "K2_pack_bwd"][0]
    assert row["ok"], row
    _, mvpm, tab, _, n_ch, order = pack_inputs(fn, mtx)
    b, n = mvpm.shape[0], tab.shape[1]
    if case.startswith(("random", "all")):
        assert n % _CHUNK and n > 2 * _CHUNK
    assert row["slots"] == 0 if case == "all_sentinel" else 0 < row["slots"] <= n
    g = torch.randn((b, 32, n), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    first = pack_bwd(mvpm, tab, g, n_ch, order)
    assert torch.equal(first, pack_bwd(mvpm, tab, g, n_ch, order))
    if case == "all_sentinel":
        assert not first.any()


@pytest.mark.parametrize("texture", [False, True])
def test_k2_layouts_equal_repeat_and_replay_on_card(cuda, params, texture):
    """K2 on the compact and on the uniform-K table of the same bins (the
    test scene, n_ch 3, and its uv table, n_ch 2) under one cotangent on
    their live slots and another on their padding: the same (B, 19) bit
    for bit; K2 repeats bit for bit; K2's places (``slot_order_of``) and
    K2 captured in a CUDA graph replay equal to the eager launches."""
    from diffdope_tpu_torch.kernels.check import check_pack_layouts, pack_inputs
    from diffdope_tpu_torch.render.pack_kernel import pack_bwd
    from diffdope_tpu_torch.render.pipeline import slot_order_of

    mtx, _, _ = pose_matrix(params)
    fns = [bench_problem(RES, subdiv=2, batch=B, device=cuda, texture=texture,
                         uniform=uniform)["fn"] for uniform in (False, True)]
    row = check_pack_layouts(*fns, mtx)
    assert row["same_slots"] and row["ok"], row
    n_compact, n_uniform = row["table_slots"]
    assert 0 < row["slots"] < n_compact < n_uniform
    for fn in fns:
        bn, mvpm, tab, _, n_ch, order = pack_inputs(fn, mtx)
        g = torch.randn((B, 32, tab.shape[1]), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(2))
        eager = pack_bwd(mvpm, tab, g, n_ch, order)
        assert torch.equal(eager, pack_bwd(mvpm, tab, g, n_ch, order))
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            pack_bwd(mvpm, tab, g, n_ch, slot_order_of(bn, fn.mesh))  # warm
            graph.capture_begin()
            out = pack_bwd(mvpm, tab, g, n_ch, slot_order_of(bn, fn.mesh))
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(stream)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)


def _k5_window(fn, mtx):
    """(rows, ids, gt6, dplane, colors, roi) of ``fn``'s raster at poses
    ``mtx``, cut to a window 5 rows and 7 columns short of its frame (no
    multiple of K5's 16-pixel tile) whose last 3 rows and 5 columns lie
    past the frame ``roi`` says, with the second hypothesis' foreground
    removed; a seeded depth plane, the colour planes ``fn`` samples from
    the rows (foreground-masked) where it samples a texture."""
    from diffdope_tpu_torch.kernels.check import _binned_spec

    b = mtx.shape[0]
    hf, wf = fn.frame_hw
    with torch.no_grad():
        ids, rows, _ = _binned_spec(fn, mtx, b * hf * wf).fwd()
        colors = fn.sample(rows, ids) if getattr(fn, "sample", None) else None
    hc, wc = hf - 5, wf - 7
    ids = ids[:, :hc, :wc].contiguous()
    ids[1] = 0
    rows = rows[:, :, :hc, :wc].contiguous()
    gt6 = fn.gt6[:, :hc, :wc].contiguous()
    gen = torch.Generator(device=mtx.device).manual_seed(5)
    dplane = torch.randn((b, hc, wc), generator=gen, device=mtx.device)
    if colors is not None:
        colors = (colors[:, :, :hc, :wc] * (ids > 0)[:, None]).contiguous()
    return rows, ids, gt6, dplane, colors, (2, 3, hc - 3 + 2, wc - 5 + 3)


@pytest.mark.parametrize("depth", [False, True], ids=["no_depth", "depth"])
@pytest.mark.parametrize("lane", ["rgb", "color"])
def test_k5_lanes_match_plain_and_repeat_on_card(cuda, params, lane, depth):
    """K5 in each of its four lanes on a window cut by the frame (vh < hc,
    vw < wc) and no multiple of its tile, one hypothesis without
    foreground: sums within rtol 1e-5, atol 1e-7 of the plain twin, two
    launches bit for bit, and bit for bit the sums with every foreground id
    collapsed to 1 (only silhouette pairs add to the mask)."""
    from diffdope_tpu_torch.render.fused_loss import loss_sums, loss_sums_plain

    fn = bench_problem(RES, subdiv=2, batch=B, device=cuda, texture=lane == "color",
                       uniform=lane == "rgb")["fn"]
    mtx, _, _ = pose_matrix(params)
    rows, ids, gt6, dplane, colors, roi = _k5_window(fn, mtx)
    hc, wc = ids.shape[1:]
    assert hc % 16 and wc % 16 and roi[2] - roi[0] < hc and roi[3] - roi[1] < wc
    assert (ids[0] > 0).any() and not (ids[1] > 0).any()
    dpl = dplane if depth else None
    sums = loss_sums(rows, ids, gt6, roi, dpl, colors)
    want = loss_sums_plain(rows, ids, gt6, roi, dpl, colors)
    assert want[:, 0].min() > 0 and (want[:, 2].min() > 0 if depth else True)
    np.testing.assert_allclose(sums.cpu().numpy(), want.cpu().numpy(), rtol=1e-5, atol=1e-7)
    assert torch.equal(sums, loss_sums(rows, ids, gt6, roi, dpl, colors))
    one = (ids > 0).to(ids.dtype)
    assert torch.equal(sums, loss_sums(rows, one, gt6, roi, dpl, colors))


def _k6_window(fn, mtx):
    """(rows, ids, gt6, dplane, colors, roi) of ``fn``'s raster at poses
    ``mtx`` cut to its first 57 rows and 75 columns (no multiple of the
    16-pixel tile: the object's lower and right silhouette lies in the
    last partial tiles), a seeded depth plane, the colour planes ``fn``
    samples from the rows (foreground-masked) where it samples a texture."""
    from diffdope_tpu_torch.kernels.check import _binned_spec

    b = mtx.shape[0]
    hf, wf = fn.frame_hw
    with torch.no_grad():
        ids, rows, _ = _binned_spec(fn, mtx, b * hf * wf).fwd()
        colors = fn.sample(rows, ids) if getattr(fn, "sample", None) else None
    hc, wc = 57, 75
    cut = np.s_[..., :hc, :wc]
    ids, rows, gt6 = (x[cut].contiguous() for x in (ids, rows, fn.gt6))
    gen = torch.Generator(device=mtx.device).manual_seed(5)
    dplane = torch.randn((b, hc, wc), generator=gen, device=mtx.device)
    if colors is not None:
        colors = (colors[cut] * (ids > 0)[:, None]).contiguous()
    return rows, ids, gt6, dplane, colors, tuple(fn.roi)


def _border_pairs(fg):
    """Silhouette pairs that straddle a 16-pixel tile border, by the side
    their foreground pixel lies on: left, right, above, below."""
    h = (fg[:, :, 15:-1:16] != fg[:, :, 16::16])
    v = (fg[:, 15:-1:16] != fg[:, 16::16])
    return dict(left=int((h & fg[:, :, 15:-1:16]).sum()), right=int((h & fg[:, :, 16::16]).sum()),
                above=int((v & fg[:, 15:-1:16]).sum()), below=int((v & fg[:, 16::16]).sum()))


@pytest.mark.parametrize("lane", ["rgb", "bf16", "depth", "color", "color_depth"])
def test_k6_lanes_match_plain_and_repeat_on_card(cuda, params, lane):
    """K6 in each of its five lanes on a window whose silhouette crosses
    tile borders in all four directions and lies in the last partial tiles
    of both axes: d_rows within K6's tolerance of the plain twin (rtol
    2e-4, atol 1e-6 plus 1e-6 of the pixel's largest lane), d_dplane and
    d_colors rtol 2e-4, atol 1e-6; the bf16 lane the f32 lane's d_rows
    rounded bit for bit; two launches bit for bit, and bit for bit the
    same with every foreground id collapsed to 1 (only silhouette pairs
    reach the edge lanes)."""
    from diffdope_tpu_torch.kernels.check import _close
    from diffdope_tpu_torch.render.fused_loss import loss_bwd, loss_bwd_plain

    fn = bench_problem(RES, subdiv=2, batch=B, device=cuda,
                       texture=lane.startswith("color"))["fn"]
    mtx, _, _ = pose_matrix(params)
    rows, ids, gt6, dplane, colors, roi = _k6_window(fn, mtx)
    fg = ids > 0
    assert all(n > 0 for n in _border_pairs(fg).values()), _border_pairs(fg)
    assert fg[:, 48:].any() and fg[:, :, 64:].any()  # the last partial tiles
    dpl = dplane if lane.endswith("depth") else None
    d_sums = torch.tensor([[1.0, 0.7, 0.9], [0.5, 1.3, 1.1], [2.0, 0.2, 0.4]], device=cuda)
    dtype = torch.bfloat16 if lane == "bf16" else torch.float32
    got = loss_bwd(rows, ids, gt6, roi, d_sums, dpl, colors, d_rows_dtype=dtype)
    want = loss_bwd_plain(rows, ids, gt6, roi, d_sums, dpl, colors)
    scale = want[0].abs().amax(dim=1, keepdim=True)
    if lane == "bf16":
        f32 = loss_bwd(rows, ids, gt6, roi, d_sums)[0]
        assert torch.equal(got[0], f32.to(torch.bfloat16))
        got = (f32,) + got[1:]
    assert _close(got[0], want[0], 2e-4, 1e-6, scale)
    assert float(want[0][:, :9].abs().max()) > 0
    for plane, ref in zip(got[1:], want[1:]):
        assert (plane is None) == (ref is None)
        if ref is not None:
            assert _close(plane, ref, 2e-4, 1e-6)

    def bits(out):
        return [x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
                for x in out if x is not None]

    first = bits(loss_bwd(rows, ids, gt6, roi, d_sums, dpl, colors, d_rows_dtype=dtype))
    again = bits(loss_bwd(rows, ids, gt6, roi, d_sums, dpl, colors, d_rows_dtype=dtype))
    one = bits(loss_bwd(rows, fg.to(ids.dtype), gt6, roi, d_sums, dpl, colors,
                        d_rows_dtype=dtype))
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert all(torch.equal(x, y) for x, y in zip(first, one))


def _edge_tiles(b, table, kc, device):
    """A winner map (b, 32, 48) over 2 x 3 tiles of 16 x 16 and its table:
    tile 0 one winner for all 256 pixels, tile 1 256 distinct winners,
    tile 2 no foreground, the rest 60% foreground on 9 winners; the compact
    table holds 1, 70, 0, 8, 2 and 40 chunks of ``kc`` and a tail of 5
    chunks, the uniform table K = 68 ``kc`` a tile, plus one where ``kc``
    is odd (with ``kc`` 32, 2,240 and 2,176 slots: more than the kernel
    maps a round).  Returns (win, n_slots, off_c, used)."""
    rng = np.random.default_rng(0)
    nt = 6
    if table == "compact":
        used = np.array([1, 70, 0, 8, 2, 40], np.int32)
        off_c = np.concatenate([[0], np.cumsum(used)[:-1]]).astype(np.int32)
        base, n = off_c * kc, used * kc
        n_slots = int((used.sum() + 5) * kc)
    else:
        k = 68 * kc + kc % 2
        base, n = np.arange(nt) * k, np.full(nt, k)
        off_c = used = None
        n_slots = nt * k
    win = np.full((b, 32, 48), -1, np.int32)
    for bi in range(b):
        for t in range(nt):
            tile = win[bi, (t // 3) * 16:(t // 3 + 1) * 16, (t % 3) * 16:(t % 3 + 1) * 16]
            if t == 0:
                tile[:] = base[t] + 3
            elif t == 1:
                tile[:] = (base[t] + rng.permutation(n[t])[:256]).reshape(16, 16)
            elif t > 2:
                m = rng.random((16, 16)) < 0.6
                tile[m] = base[t] + rng.integers(0, min(n[t], 9), m.sum())
    as_t = (lambda a: None if a is None else torch.tensor(a, device=device))
    return as_t(win), n_slots, as_t(off_c), as_t(used)


@pytest.mark.parametrize("kc", [32, 5], ids=["aligned", "odd"])
@pytest.mark.parametrize("lane", ["compact_f32", "compact_bf16", "uniform"])
def test_k4_edge_tiles_match_plain_and_repeat_on_card(cuda, lane, kc):
    """K4 (both lanes) and K7's backward on edge tiles: one triangle winning
    a whole tile, 256 distinct winners, a tile without foreground, a tile
    holding more slots than one round maps; d_bins within K4's tolerance
    of the plain twin (its zeros exactly: the held slots no pixel won,
    the compact table's tail, each uniform bin's padding), with the
    allocator's block filled with NaN before; two launches bit for bit.
    Chunks (or K) of 5 slots take the kernel's one-float stores, 32 its
    float4 stores."""
    from diffdope_tpu_torch.kernels.check import _close
    from diffdope_tpu_torch.render.raster import (
        raster_bwd,
        raster_bwd_plain,
        raster_uniform_bwd,
    )

    b = 2
    win, n_slots, off_c, used = _edge_tiles(b, lane.split("_")[0], kc, cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    d_rows = torch.randn((b, 32, 32, 48), generator=gen, device=cuda)
    if lane == "compact_bf16":
        d_rows = d_rows.to(torch.bfloat16)

    def run():
        junk = torch.full((b, 32, n_slots), float("nan"), device=cuda)
        del junk  # the caching allocator hands the same block to d_bins
        if lane == "uniform":
            return raster_uniform_bwd(d_rows, win, n_slots, (16, 16))
        return raster_bwd(d_rows, win, n_slots, (16, 16), off_c, used, kc)

    got = run()
    want = raster_bwd_plain(d_rows, win, n_slots)
    scale = raster_bwd_plain(d_rows.abs(), win, n_slots)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got == 0, want == 0)
    assert _close(got, want, 2e-4, 1e-6, scale)
    if lane != "uniform":
        end = int(((off_c + used) * kc).max())
        assert end < n_slots and not got[:, :, end:].any()
    assert torch.equal(got.view(torch.int32), run().view(torch.int32))


@pytest.fixture(scope="module")
def v3_table(cuda, params):
    """The 'v3' bench problem at the test scene's three distinct poses: the
    fused loss, the poses, the sorted table and its tables."""
    from diffdope_tpu_torch.render import raster_v3
    from diffdope_tpu_torch.render.pipeline import TILE_HW

    fn = bench_problem(RES, subdiv=2, batch=B, device=cuda, route="v3")["fn"]
    mtx, _, _ = pose_matrix(params)
    with torch.no_grad():
        pl = fn.planar(mtx)
    tables = raster_v3.prepare(pl.packed, RES, TILE_HW)
    return fn, mtx, raster_v3.sorted_table(pl.packed, tables), tables


def test_k10_repeats_bit_for_bit_on_card(v3_table):
    """K10's forward (ids, win, rows) and backward (under a seeded normal
    d_rows) give the same bits on a second launch."""
    from diffdope_tpu_torch.render import raster_v3
    from diffdope_tpu_torch.render.pipeline import TILE_HW

    _, _, packed_s, tables = v3_table
    first = [o.clone() for o in raster_v3.raster_v3_fwd(packed_s, tables, RES, TILE_HW)]
    again = raster_v3.raster_v3_fwd(packed_s, tables, RES, TILE_HW)
    assert int((first[0] > 0).sum()) > 1000
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(first, again))
    win = first[2]
    gen = torch.Generator(device=win.device).manual_seed(3)
    d_rows = torch.randn((B, 32) + tuple(win.shape[1:]), generator=gen, device=win.device)
    d1 = raster_v3.raster_v3_bwd(d_rows, win, tables, TILE_HW).clone()
    d2 = raster_v3.raster_v3_bwd(d_rows, win, tables, TILE_HW)
    assert torch.equal(d1.view(torch.int32), d2.view(torch.int32))


def test_k10_backward_writes_every_slot_on_card(v3_table):
    """K10's backward launched on an output filled with NaN: every value is
    written, +0 at each (hypothesis, slot) that won no pixel, and the sums
    agree with the plain twin at rtol 2e-4, atol 1e-6 plus 1e-6 of the
    summed |d_rows|."""
    from diffdope_tpu_torch.kernels.check import _close
    from diffdope_tpu_torch.render import raster_v3
    from diffdope_tpu_torch.render.pipeline import TILE_HW

    _, _, packed_s, tables = v3_table
    _, _, win = raster_v3.raster_v3_fwd(packed_s, tables, RES, TILE_HW)
    nty, ntx = RES[0] // TILE_HW[0], RES[1] // TILE_HW[1]
    gen = torch.Generator(device=win.device).manual_seed(4)
    d_rows = torch.randn((B, 32) + tuple(win.shape[1:]), generator=gen, device=win.device)
    out = torch.full((B, 32, tables.t_pad), float("nan"), device=win.device)
    kernels.reset_launches()
    kernels.launch("dd_raster_v3_bwd", "raster_v3_bwd", d_rows.data_ptr(), win.data_ptr(),
                   tables.clo.data_ptr(), tables.chi.data_ptr(), tables.rlo_tc.data_ptr(),
                   tables.rhi_tc.data_ptr(), B, tables.t_pad, nty, ntx, *TILE_HW,
                   out.data_ptr())
    torch.cuda.synchronize()
    assert kernels.launches["raster_v3_bwd"] == 1
    assert bool(torch.isfinite(out).all())
    won = torch.zeros((B, tables.t_pad), dtype=torch.bool, device=win.device)
    bi = torch.arange(B, device=win.device)[:, None, None].expand_as(win)
    won[bi[win >= 0], win[win >= 0].long()] = True
    assert 0 < int(won.sum()) < won.numel()
    assert bool((out.view(torch.int32)[~won[:, None, :].expand_as(out)] == 0).all())
    want = raster_v3.raster_v3_bwd_plain(d_rows, win, tables.t_pad)
    scale = raster_v3.raster_v3_bwd_plain(d_rows.abs(), win, tables.t_pad)
    assert _close(out, want, 2e-4, 1e-6, scale)


def test_k10_equals_k7_over_exact_bins_on_card(v3_table):
    """At the test scene K10's ids and rows equal, bit for bit, K7's over
    exact per-tile bins gathered from the same triangle-order table (no
    capacity, no cull), as phase 11 holds at its own shapes."""
    from diffdope_tpu_torch.render import pipeline
    from diffdope_tpu_torch.render.gather_rows import invert_bins
    from diffdope_tpu_torch.render.planar import bin_triangles_planar
    from diffdope_tpu_torch.render.raster import raster_gather_rows_v2
    from diffdope_tpu_torch.render.raster_v3 import raster_gather_rows_v3

    fn, mtx, _, _ = v3_table
    t_count = fn.mesh.t_count
    with torch.no_grad():
        packed, cp, det = pipeline._planar_pack(fn.mesh, mtx)
        idx, counts, overflow = bin_triangles_planar(cp, det, RES, pipeline.TILE_HW, t_count)
        assert int(overflow) == 0
        inv = invert_bins(idx, t_count, "auto")
        ids2, rows2 = raster_gather_rows_v2(packed, idx, counts, *inv, RES, pipeline.TILE_HW,
                                            padded=True)
        ids3, rows3 = raster_gather_rows_v3(packed, RES, pipeline.TILE_HW, padded=True)
    assert int((ids3 > 0).sum()) > 1000
    assert torch.equal(ids2, ids3) and torch.equal(rows2, rows3)


def test_k10_matches_plain_over_the_padding_on_card(cuda, params):
    """K10 on a 70x100 frame (padded to 80x112) with the object moved across
    its bottom and right edges: the forward's ids, win and rows equal the
    plain twin's on every pixel of the padded frame, foreground in the
    padding included; the backward within its tolerance."""
    from diffdope_tpu_torch.render import raster_v3
    from diffdope_tpu_torch.render.pipeline import TILE_HW

    res = (70, 100)
    fn = bench_problem(res, subdiv=2, batch=B, device=cuda, route="v3")["fn"]
    moved = dict(params, x=params["x"] + 0.4, y=params["y"] - 0.3)
    mtx, _, _ = pose_matrix(moved)
    d_sums = torch.tensor([[1.0, 0.7, 0.0], [0.5, 1.3, 0.0], [2.0, 0.2, 0.0]], device=cuda)
    rows = {row["name"]: row for row in check_kernels(fn, mtx, d_sums)}
    assert rows["K10_raster_v3_fwd"]["ok"], rows["K10_raster_v3_fwd"]
    assert rows["K10_raster_v3_bwd"]["ok"], rows["K10_raster_v3_bwd"]
    with torch.no_grad():
        ids, _ = raster_v3.raster_gather_rows_v3(fn.planar(mtx).packed, res, TILE_HW,
                                                  padded=True)
    assert int((ids[:, res[0]:] > 0).sum() + (ids[:, :, res[1]:] > 0).sum()) > 0


def _moved(params):
    """The poses moved across a 70x100 frame's bottom and right edges."""
    return dict(params, x=params["x"] + 0.4, y=params["y"] - 0.3)


@pytest.mark.parametrize("tile", [(16, 32), (32, 128)])
def test_k8_k9_match_plain_over_the_padding_and_repeat_on_card(cuda, params, tile):
    """K8's ids and K9's ids, win and rows on a 70x100 frame (padded to
    whole tiles) with the object across its bottom and right edges: equal
    to the plain twins' on every pixel (K9's of the padded frame,
    foreground in the padding included), and the same bits from launch to
    launch."""
    from diffdope_tpu_torch.render.gather_rows import gather_rows_fwd, gather_rows_fwd_plain
    from diffdope_tpu_torch.render.rasterize import raster_ids, raster_ids_binned_plain

    res = (70, 100)
    problem = bench_problem(res, subdiv=2, batch=B, device=cuda)
    s = problem["scene"]
    pos_clip = _pos_clip(problem, _moved(params), "cuda")
    tri = torch.as_tensor(s["tri"], device="cuda").long()
    coef, idx, counts = raster_ids_inputs(pos_clip, tri, res, tile)
    ids = raster_ids(coef, idx, counts, res, tile)  # the frame (K9's pads it)
    assert torch.equal(ids, raster_ids_binned_plain(coef, idx, counts, res, tile))
    assert torch.equal(ids, raster_ids(coef, idx, counts, res, tile))
    packed, idx, counts = gather_rows_inputs(pos_clip, tri, res, tile,
                                             torch.as_tensor(s["vtx_color"], device="cuda"),
                                             torch.as_tensor(s["edge_adj"], device="cuda").long())
    got = gather_rows_fwd(packed, idx, counts, res, tile)
    want = gather_rows_fwd_plain(packed, idx, counts, res, tile)
    again = gather_rows_fwd(packed, idx, counts, res, tile)
    assert all(torch.equal(a, w) and torch.equal(a, c) for a, w, c in zip(got, want, again))
    fg = got[0] > 0
    assert int(fg.sum()) > 1000
    assert int(fg[:, res[0]:].sum() + fg[:, :, res[1]:].sum()) > 0


def _k9_bwd_inputs(seed=3):
    """A winner map over 3 x 4 tiles of 32x128, B = 2, K = 4,352 (more
    slots than a tile's 4,096 pixels), with seeded normal d_rows: tile 0
    holds no slot; tile 1 holds K, every pixel won by a random one; in
    tile 2 one slot wins a 20x60 block (a run of 1,200 pixels); tile 3
    holds 50 slots and wins none; the rest hold random counts, about 60%
    of their pixels won.  Returns (d_rows, win, counts, K) as numpy."""
    rng = np.random.default_rng(seed)
    b, nty, ntx, (th, tw), k = 2, 3, 4, (32, 128), 4352
    counts = rng.integers(1, k, nty * ntx).astype(np.int32)
    counts[:4] = (0, k, 700, 50)
    win = np.full((b, nty * th, ntx * tw), -1, np.int32)
    for bi in range(b):
        for t in range(1, nty * ntx):
            if t == 3:
                continue
            r0, c0 = (t // ntx) * th, (t % ntx) * tw
            fg = rng.random((th, tw)) < (1.0 if t == 1 else 0.6)
            slot = rng.integers(0, counts[t], (th, tw))
            if t == 2:
                fg[4:24, 10:70], slot[4:24, 10:70] = True, 17
            win[bi, r0:r0 + th, c0:c0 + tw] = np.where(fg, t * k + slot, -1)
    d_rows = rng.normal(size=(b, 32) + win.shape[1:]).astype(np.float32)
    return d_rows, win, counts, k


def test_k9_backward_tail_and_long_run_on_card(cuda):
    """K9's backward at K = 4,352 over a map with an empty tile, a tile
    holding K slots, held slots no pixel wins and a 1,200-pixel run: d_bin
    equals the plain twin's (rtol 2e-4, atol 1e-6 plus 1e-6 of the slot's
    sum of |d_rows|), repeats bit for bit, and is +0 (its bits all zero) at
    every slot past a tile's count."""
    from diffdope_tpu_torch.kernels.check import _close
    from diffdope_tpu_torch.render.gather_rows import gather_rows_bwd, gather_rows_bwd_plain

    d_rows, win, counts, k = _k9_bwd_inputs()
    d_rows, win, counts = (torch.as_tensor(x, device=cuda) for x in (d_rows, win, counts))
    tile = (32, 128)
    nt = counts.shape[0]
    kernels.reset_launches()
    got = gather_rows_bwd(d_rows, win, counts, k, tile)
    again = gather_rows_bwd(d_rows, win, counts, k, tile)
    assert kernels.launches["gather_rows_bwd"] == 2
    want = gather_rows_bwd_plain(d_rows, win, nt, k)
    scale = gather_rows_bwd_plain(d_rows.abs(), win, nt, k)
    assert _close(got, want, 2e-4, 1e-6, scale)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    past = torch.arange(k, device=cuda)[None, :] >= counts[:, None].long()
    assert int(past.sum()) > 2 * k
    assert not bool(got.view(torch.int32)[:, past].any())
    assert float(want[:, 2, 17].abs().sum()) > 0 and int((win == 2 * k + 17).sum()) >= 2400


@pytest.fixture(scope="module")
def sliver(cuda):
    from diffdope_tpu_torch.kernels.check import check_sliver

    return {row["name"]: row for row in check_sliver(cuda)}


@pytest.mark.parametrize("kernel", ["K3_raster_fwd", "K7_raster_uniform_fwd", "K8_raster_ids",
                                    "K9_gather_rows_fwd"])
def test_raster_forwards_match_plain_at_a_sliver_on_card(sliver, kernel):
    """K3 (a compact window of 16x16 tiles), K7 (the frame's uniform
    table), K8 and K9 (the 32x128 bins) on a sliver of the 960x540 frame
    (``check.check_sliver``), in both windings: the pixel its f32 planes
    cover 8 rows past its vertex bounds is the sliver's on the card, as in
    the plain twins, and the outputs are the twins' bit for bit."""
    row = sliver[kernel]
    assert row["ok"], row


@pytest.mark.parametrize("uniform", [False, True], ids=["compact", "uniform"])
def test_k3_k7_match_plain_over_the_padding_on_card(cuda, params, uniform):
    """K3 (compact table, its crop) and K7 (uniform table, the padded full
    frame) on a 70x100 frame with the object across its bottom and right
    edges: ids, win and rows equal the plain twin's on every pixel, and
    the uniform table's foreground reaches into the padding."""
    res = (70, 100)
    fn = bench_problem(res, subdiv=2, batch=B, device=cuda, uniform=uniform)["fn"]
    mtx, _, _ = pose_matrix(_moved(params))
    d_sums = torch.tensor([[1.0, 0.7, 0.0], [0.5, 1.3, 0.0], [2.0, 0.2, 0.0]], device=cuda)
    row = check_kernels(fn, mtx, d_sums)[0]
    assert row["name"] == ("K7_raster_uniform_fwd" if uniform else "K3_raster_fwd")
    assert row["ok"] and row["fg_pixels"] > 1000, row
    if uniform:
        from diffdope_tpu_torch.render.raster import raster_uniform_fwd
        from diffdope_tpu_torch.render.pipeline import TILE_HW

        with torch.no_grad():
            tab = fn.table(mtx)
            ids, _, _ = raster_uniform_fwd(tab.packed, tab.counts, res, TILE_HW)
        assert int((ids[:, res[0]:] > 0).sum() + (ids[:, :, res[1]:] > 0).sum()) > 0


def test_api_path_gradient_repeats_and_equals_the_brute_force_on_card(problem, params):
    """rasterize (K8) -> interpolate (of vertex colours that take a
    gradient) -> antialias -> L1: the clip positions' and the colours'
    gradients repeat bit for bit from backward to backward, and equal the
    brute force's (impl='reference', whose rast is the same) bit for bit;
    the gathers sum in a fixed order (one launch for the clip positions'
    corner gather of rasterize's setup and one for antialias's, one for
    interpolate's, one for each of antialias's two passes)."""
    from diffdope_tpu_torch.render.antialias import antialias
    from diffdope_tpu_torch.render.interpolate import interpolate
    from diffdope_tpu_torch.render.rasterize import rasterize

    s = problem["scene"]
    tri = torch.as_tensor(s["tri"], device="cuda").long()
    adj = torch.as_tensor(s["edge_adj"], device="cuda").long()
    colors = torch.as_tensor(s["vtx_color"], device="cuda")
    target = torch.as_tensor(np.random.default_rng(3).uniform(0, 1, (B,) + RES + (3,)),
                             dtype=torch.float32, device="cuda")
    out = {}
    for run, impl in (("k8", "pallas"), ("again", "pallas"), ("brute", "reference")):
        pos_clip = _pos_clip(problem, params, "cuda").detach().requires_grad_(True)
        attr = colors.clone().requires_grad_(True)
        rast, db = rasterize(pos_clip, tri, RES, impl=impl)
        rgb, _ = interpolate(attr, rast, tri, db, diff_attrs="all")
        aa = antialias(rgb, rast, pos_clip, tri, edge_adj=adj)
        kernels.reset_launches()
        grads = torch.autograd.grad((aa - target).abs().mean(), (pos_clip, attr))
        assert kernels.launches["index_rows_bwd"] == 5, kernels.launches
        out[run] = (rast.detach(), *grads)
    assert float(out["k8"][1].abs().max()) > 0 and float(out["k8"][2].abs().max()) > 0
    for run in ("again", "brute"):
        assert all(torch.equal(a, c) for a, c in zip(out["k8"], out[run])), run


def _files_scene(root):
    """rgb / depth / seg PNGs of the test scene's sphere at 96x128 (the
    port's gt render, written with ``testing.write_png``), a PLY of it, and
    the configuration that reads them at image_resize 0.5."""
    import copy

    from diffdope_tpu_torch.camera import Camera
    from diffdope_tpu_torch.mesh import mesh_from_arrays
    from diffdope_tpu_torch.optimize import pose_params
    from diffdope_tpu_torch.render.pipeline import render_rgb_mask
    from diffdope_tpu_torch.testing import icosphere, write_png

    v, f = icosphere(2)
    ply = root / "sphere.ply"
    with open(ply, "w") as fh:
        fh.write(f"ply\nformat ascii 1.0\nelement vertex {len(v)}\nproperty float x\n"
                 "property float y\nproperty float z\nproperty uchar red\n"
                 "property uchar green\nproperty uchar blue\n"
                 f"element face {len(f)}\nproperty list uchar int vertex_indices\n"
                 "end_header\n")
        for p, c in zip(v * 0.4, np.round((v * 0.5 + 0.5) * 255).astype(int)):
            fh.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
        for t in f:
            fh.write(f"3 {t[0]} {t[1]} {t[2]}\n")
    cam = dict(fx=120.0, fy=120.0, cx=64.0, cy=48.0, im_width=128, im_height=96)
    mesh = mesh_from_arrays(v * 0.4, f, colors=v * 0.5 + 0.5)
    mtx = pose_matrix(pose_params([0, 0, 0, 1.0], [0.05, 0.0, -3.0], 1, "cpu"))[0]
    gt = render_rgb_mask(Camera(**cam).cam_proj, mtx, mesh.pos, mesh.pos_idx, (96, 128),
                         edge_adj=mesh.edge_adj, vtx_color=mesh.vtx_color, device="cpu")
    paths = {k: root / f"{k}.png" for k in ("rgb", "depth", "seg")}
    write_png(paths["rgb"], np.round(gt["rgb"][0].numpy()[::-1] * 255).astype(np.uint8))
    write_png(paths["depth"], np.round(gt["depth"][0].numpy()[::-1] * 100).astype(np.uint16))
    write_png(paths["seg"], np.round(gt["mask"][0, ..., 0].numpy()[::-1] * 255)
              .astype(np.uint8), filters="cycle")
    return copy.deepcopy({
        "camera": cam,
        "scene": {"path_img": str(paths["rgb"]), "path_depth": str(paths["depth"]),
                  "path_segmentation": str(paths["seg"]), "image_resize": 0.5},
        "object3d": {"position": [0.013, -0.021, 3.0], "rotation": [0.01, -0.02, 0.015, 1.0],
                     "model_path": str(ply)},
        "losses": {"l1_mask": True, "weight_mask": 1.0, "l1_rgb_with_mask": True,
                   "weight_rgb": 0.7, "l1_depth_with_mask": True, "weight_depth": 1.0},
        "hyperparameters": {"batchsize": 3, "nb_iterations": 3, "base_lr": 20.0,
                            "lr_decay": 0.1, "learning_rates_bound": [0.5, 2.0]},
        "tpu": {"seed": 1, "raster_impl": "pallas", "progress": False},
    })


@pytest.mark.parametrize("options", [{}, {"restarts": 1, "init_jitter_deg": 5.0,
                                          "init_jitter_trans": 0.005,
                                          "precompute_bins": True}])
def test_diffdope_from_files_on_card_matches_cpu(cuda, tmp_path, options):
    """DiffDope(cfg) from PNG files and a PLY, on the card against the same
    on the CPU: the gt arrays equal, step-0 logs at rtol 1e-5 (with
    restarts, init jitter and precomputed bins too: the same draws on both
    devices, the same number of steps, every pair of the final poses
    inside the bins)."""
    from diffdope_tpu_torch.config import ConfigNode
    from diffdope_tpu_torch.diffdope import DiffDope

    cfg = _files_scene(tmp_path)
    cfg["tpu"].update(options)
    runs = {}
    for device in ("cpu", cuda):
        dd = DiffDope(cfg=ConfigNode(cfg), device=device)
        with drows_env(False):
            kernels.reset_launches()
            dd.run_optimization()
        runs[str(device)] = dd, dict(kernels.launches)
    (cpu, _), (card, launches) = runs["cpu"], runs[str(cuda)]
    for key, value in cpu.gt_tensors.items():
        np.testing.assert_array_equal(card.gt_tensors[key], value, err_msg=key)
    assert card.mtx_history.shape == cpu.mtx_history.shape == (4, 3, 4, 4)
    np.testing.assert_array_equal(card.mtx_history[0], cpu.mtx_history[0])
    for key, value in cpu.losses_values.items():
        np.testing.assert_allclose(card.losses_values[key][0], value[0], rtol=1e-5,
                                   err_msg=key)
    assert launches["pack_fwd"] > 0 and launches["loss_fwd_depth"] > 0
    if options:
        assert card._bins_escaped == 0


def test_glb_mesh_renders_on_card_as_on_cpu(cuda, tmp_path):
    """A .glb with its texture embedded as PNG loads and renders (the exact
    texture route) on the card as on the CPU."""
    from diffdope_tpu_torch.mesh import load_mesh, load_ply
    from diffdope_tpu_torch.render.pipeline import render_batch
    from diffdope_tpu_torch.testing import png_bytes, write_gltf

    data = load_ply("data/standins/standin_tex_checker.ply")
    rng = np.random.default_rng(0)
    tex = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    path = tmp_path / "m.glb"
    uv = np.stack([data["uv"][:, 0], 1.0 - data["uv"][:, 1]], -1)
    write_gltf(path, data["vertices"], data["faces"], uv=uv, image=png_bytes(tex, "cycle"))
    mesh = load_mesh(path, scale=0.01)
    assert mesh.has_textured_map
    np.testing.assert_array_equal(mesh.tex, tex.astype(np.float32) / 255.0)
    from diffdope_tpu_torch.camera import Camera
    from diffdope_tpu_torch.optimize import pose_params

    cam = Camera(fx=120.0, fy=120.0, cx=48.0, cy=32.0, im_width=96, im_height=64)
    mtx = pose_matrix(pose_params([0.1, 0.2, 0.0, 1.0], [0.0, 0.0, -3.0], 2, "cpu"))[0]
    out = {}
    for device in ("cpu", cuda):
        r = render_batch(cam.cam_proj, mtx.to(device), mesh.pos, mesh.pos_idx, (64, 96),
                         tex=mesh.tex, uv=mesh.uv, uv_idx=mesh.uv_idx, layout="channels",
                         edge_adj=mesh.edge_adj, raster_impl="pallas", device=device)
        out[str(device)] = {k: r[k] for k in ("ids", "mask")}
    np.testing.assert_array_equal(out[str(cuda)]["ids"].cpu().numpy(), out["cpu"]["ids"].numpy())
    assert int((out["cpu"]["ids"] > 0).sum()) > 100


def _fused_value_and_grad(fn, params, *gt):
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    total, logs = fn(pose_matrix(p)[0], *gt)
    grads = torch.autograd.grad(total, list(p.values()))
    return total.detach(), {k: v.detach() for k, v in logs.items()}, dict(zip(p, grads))


@pytest.mark.parametrize("depth", [False, True], ids=["rgb_mask", "depth"])
def test_per_call_gt_equals_baked_on_card(cuda, params, depth):
    """``make_fused_loss(gt=None)`` on the card (the spanning op's bf16
    lane without depth, K3 -> K5 chained with it): for two ground truths
    in turn, fed per call, the total, logs and pose gradients equal a
    baked closure's with no crop bit for bit, so no kernel wrapper keeps
    a plane of an earlier call."""
    from diffdope_tpu_torch.render.pipeline import make_fused_loss

    pb = bench_problem(RES, subdiv=2, batch=B, device=cuda, depth=depth)
    s = pb["scene"]
    gts = [pb["gt"], {k: np.ascontiguousarray(np.roll(v, (4, -6), axis=(0, 1)))
                      for k, v in pb["gt"].items()}]

    def build(gt):
        return make_fused_loss(
            s["proj"], s["pos"], s["tri"], RES, gt, pb["lrs"], pb["weights"], use_rgb=True,
            use_depth=depth, use_mask=True, edge_adj=s["edge_adj"], vtx_color=s["vtx_color"],
            compact_total=pb["compact_total"], roi_crop="off", device=cuda)

    deferred = build(None)
    kernels.reset_launches()
    for gt in gts + gts[:1]:
        gt_t = {k: torch.tensor(v, device=cuda) for k, v in gt.items()}
        t_d, logs_d, g_d = _fused_value_and_grad(deferred, params, gt_t)
        t_b, logs_b, g_b = _fused_value_and_grad(build(gt), params)
        assert torch.equal(t_d, t_b)
        assert set(logs_d) == set(logs_b)
        for k in logs_b:
            assert torch.equal(logs_d[k], logs_b[k]), k
        for k in g_b:
            assert torch.equal(g_d[k], g_b[k]), k
    launched = dict(kernels.launches)
    fwd, bwd = ("loss_fwd_depth", "loss_bwd_depth") if depth else ("loss_fwd",
                                                                   "loss_bwd_bf16")
    assert launched[fwd] == launched[bwd] == 6 and launched["pack_fwd"] == 6


def test_sweep_capacity_drops_no_pair_at_the_probe_poses(cuda):
    """The synthesized sweep's context on the card (the JAX package's
    defaults: 160x160, B=16, the stand-in mesh): its compact capacity,
    sized from the 16 probe poses, holds every (tile, triangle) pair at
    each of them, with the deferred ground truth rendered there."""
    from diffdope_tpu_torch import bop

    ctx = bop._synth_context("data/standins/standin_asym.ply", (160, 160), 16, 40, 0.01, 0,
                             device=cuda)
    assert ctx["compact_total"] and ctx["compact_total"] % 32 == 0
    qs, ts = bop.probe_poses()
    with torch.no_grad():
        for q, t in zip(qs, ts):
            gt, mtx = ctx["gt_render"](q, t)
            total, logs = ctx["fused"](mtx.expand(16, 4, 4).contiguous(), gt)
            assert torch.isfinite(total)
            assert int(logs["_bin_overflow"]) == 0, (q, t, int(logs["_bin_need"]))
            assert int(logs["_bin_need"]) <= ctx["compact_total"]


def test_render_img_composite_on_card_equals_plain_twins(cuda):
    """``render_img``'s composite from the kernel route (K1 -> K3) equals,
    byte for byte, the composite ``_compose_overlay`` builds from the plain
    twins' render of the same poses (``check.plain_render``: no kernel
    launched)."""
    pytest.importorskip("cv2")
    from diffdope_tpu_torch.config import ConfigNode
    from diffdope_tpu_torch.kernels.check import plain_render

    d = _diffdope_session(cuda, True)
    d.cfg["render_images"] = ConfigNode({"nrow": 2, "final_width_batch": 300,
                                         "crop_around_mask": True})
    kernels.reset_launches()
    for sel in ("rgb", "depth", "mask"):
        img = d.render_img(render_selection=sel)
        assert img.dtype == np.uint8 and img.ndim == 3
    assert kernels.launches["pack_fwd"] == kernels.launches["raster_fwd"] == 1
    mtx = torch.as_tensor(d.mtx_history[-1], device=cuda)
    kernels.reset_launches()
    with plain_render(), torch.no_grad():
        plain = d._make_render_fn(layout="stacked")(mtx)
    assert not any(kernels.launches.values()), kernels.launches
    for sel in ("rgb", "depth", "mask"):
        want = d._compose_overlay(plain[sel].cpu().numpy(), None, sel)
        assert d.render_img(render_selection=sel).tobytes() == want.tobytes(), sel


def _sharded_rank(rank, root, steps):
    """One of two gloo ranks sharing the card: the bench problem's fused
    loss, B=4 at distinct poses, its 2 hypotheses refined here."""
    import datetime

    import torch.distributed as dist

    from diffdope_tpu_torch import parallel

    dist.init_process_group("gloo", init_method=f"file://{root}/rdv", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=60))
    mesh = parallel.hypothesis_mesh(n_devices=2, device="cuda")
    pb = bench_problem(RES, subdiv=2, batch=4, device=mesh.device)
    kernels.reset_launches()
    res = parallel.refine_sharded(distinct_poses(pb["params0"], 0.01), None, (), None,
                                  pb["lrs"], pb["weights"], mesh, fused_loss_fn=pb["fn"],
                                  nb_iterations=steps - 1, base_lr=0.02, lr_decay=0.1,
                                  optimizer="adam")
    torch.save({"mtx": res.mtx_history.cpu(), "total": res.total_loss.cpu(),
                "launches": dict(kernels.launches), "device": str(mesh.device)},
               f"{root}/rank{rank}.pt")
    dist.destroy_process_group()


def test_sharded_two_ranks_on_card_match_unsharded(cuda, tmp_path):
    """Two gloo ranks on one card (NCCL refuses two ranks on a device), each
    refining 2 of the 4 hypotheses through K1-K6: every rank returns the
    global history, equal to the unsharded run's at the reference's
    tolerances (mtx rtol 2e-4, atol 2e-5; total rtol 2e-4, atol 1e-6), the
    poses bit for bit (the ranks bin over the group's union)."""
    import torch.multiprocessing as mp

    from diffdope_tpu_torch.optimize import refine

    steps = 4
    ctx = mp.spawn(_sharded_rank, args=(str(tmp_path), steps), nprocs=2, join=False)
    for _ in range(60):  # five minutes
        if ctx.join(timeout=5):  # raises when a rank fails
            break
    else:
        for proc in ctx.processes:
            proc.terminate()
        pytest.fail("the ranks did not finish within 300 s")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    pb = bench_problem(RES, subdiv=2, batch=4, device=cuda)
    whole = refine(distinct_poses(pb["params0"], 0.01), None, (), None, pb["lrs"],
                   pb["weights"], fused_loss_fn=pb["fn"], nb_iterations=steps - 1,
                   base_lr=0.02, lr_decay=0.1, optimizer="adam")
    for got in ranks:
        assert got["device"].startswith("cuda")
        for c in ("pack_fwd", "pack_bwd", "raster_fwd", "raster_bwd_bf16", "loss_fwd",
                  "loss_bwd_bf16"):
            assert got["launches"][c] == steps, (c, got["launches"])
        np.testing.assert_allclose(got["mtx"].numpy(), whole.mtx_history.cpu().numpy(),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["total"].numpy(), whole.total_loss.cpu().numpy(),
                                   rtol=2e-4, atol=1e-6)
    assert torch.equal(ranks[0]["mtx"], ranks[1]["mtx"])
    # the ranks bin over the group's union: the unsharded steps bit for bit
    assert torch.equal(ranks[0]["mtx"], whole.mtx_history.cpu())


def _assert_same_result(g, e):
    """Two RefineResults equal bit for bit, field by field."""
    assert torch.equal(g.mtx_history, e.mtx_history)
    assert torch.equal(g.total_loss, e.total_loss)
    for group in ("losses_values", "telemetry", "params"):
        a, b = getattr(g, group) or {}, getattr(e, group) or {}
        assert set(a) == set(b), group
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (group, k)


@pytest.mark.parametrize("route", sorted(capture.ROUTES))
def test_graph_refine_equals_eager_on_card(cuda, route, monkeypatch):
    """``refine`` as graph replays (the default) and as the eager loop, on
    every route ``test_torch_refine_capture`` steps on the CPU (the
    planar routes, the unfused render, the brute force, the API ops, the
    textures, the appearance leaves, precomputed bins, the BOP context),
    built on the card at 64x96, B=3 ('compact_bf16' the bench problem):
    4 steps as graph replays equal the eager loop's bit for bit (poses,
    totals, logs, telemetry, params), with equal launch counts, one a
    step for each kernel of the bench route.  Not under torch's
    deterministic algorithms: no step sums floats through autograd's
    scatters (tests/test_torch_repeatable.py)."""
    from diffdope_tpu_torch.optimize import refine

    params0, kw = capture.ROUTES[route](monkeypatch, cuda)
    optimizer, base_lr = capture.optimizer_of(route)
    out = {}
    for graph in (True, False):
        kernels.reset_launches()
        res = refine(params0, nb_iterations=3, base_lr=base_lr, optimizer=optimizer,
                     cuda_graph=graph, **kw)
        torch.cuda.synchronize()
        out[graph] = res, {k: v for k, v in kernels.launches.items() if v}
    (g, lg), (e, le) = out[True], out[False]
    assert lg == le, (lg, le)
    assert all(n % 4 == 0 for n in lg.values()), lg  # whole steps
    if route == "compact_bf16":
        assert lg["pack_fwd"] == lg["loss_bwd_bf16"] == 4, lg
    _assert_same_result(g, e)
    assert g.opt_state["count"] == e.opt_state["count"] == 4


def test_tables_refine_to_the_same_poses_on_card(cuda, monkeypatch):
    """The depth routes on the compact and on the uniform-K table
    (``test_torch_refine_capture``'s 'depth_compact' and 'depth_uniform'),
    4 steps as graph replays: the same poses at every step, bit for bit
    (F3)."""
    from diffdope_tpu_torch.optimize import refine

    runs = []
    for route in ("depth_compact", "depth_uniform"):
        params0, kw = capture.ROUTES[route](monkeypatch, cuda)
        optimizer, base_lr = capture.optimizer_of(route)
        runs.append(refine(params0, nb_iterations=3, base_lr=base_lr, optimizer=optimizer,
                           **kw))
    h_c, h_u = (r.mtx_history for r in runs)
    assert not torch.equal(h_c[0], h_c[-1])
    assert torch.equal(h_c.view(torch.int32), h_u.view(torch.int32))


def test_kept_refine_equals_fresh_eager_on_card(cuda, monkeypatch):
    """One ``CapturedRefine`` on the BOP context's loss (the ground truth
    and loss scales given per call), called three times on the card with
    other poses, ground truth and loss scales each call (the second
    continuing the first's count, the third from a restart's reset, its
    step 0 a replay), equals three fresh ``refine(cuda_graph=False)``
    calls bit for bit (poses, totals, logs, telemetry, params, state) with
    equal launches; one capture serves the three; a result held from the
    first call is unchanged; a call with another batch captures anew."""
    from diffdope_tpu_torch.optimize import CapturedRefine, refine

    params0, kw = capture.ROUTES["bop"](monkeypatch, cuda)
    settings = dict(nb_iterations=kept.NB, fused_loss_fn=kw["fused_loss_fn"],
                    **kept.OPTIMIZERS["adam"])
    jit_refine = CapturedRefine(**settings)
    got, want = [], []
    for i, call in enumerate(kept._calls(params0, kw)):
        inputs = dict(gt={k: v.to(cuda) for k, v in call["gt"].items()},
                      learning_rates=call["learning_rates"].to(cuda),
                      num_steps=call["num_steps"])
        for out, run, state in ((got, jit_refine, got), (want, functools.partial(
                refine, cuda_graph=False, **settings), want)):
            kernels.reset_launches()
            res = run(call["params"], opt_state=state[0][0].opt_state if i == 1 else None,
                      **inputs)
            torch.cuda.synchronize()
            out.append((res, {k: v for k, v in kernels.launches.items() if v}))
        if i == 0:
            held = kept._snapshot(got[0][0])
    for (g, lg), (e, le) in zip(got, want):
        assert lg == le, (lg, le)
        kept._same(g, e)
    assert jit_refine.traces == 1 and jit_refine.captures == 1
    assert jit_refine.pool_bytes > 0
    kept._same(got[0][0], held)
    small = {k: v[:2] for k, v in params0.items()}
    lrs = kept._calls(params0, kw)[0]["learning_rates"][:2].to(cuda)
    res = jit_refine(small, gt=kw["gt"], learning_rates=lrs, num_steps=3)
    kept._same(res, refine(small, gt=kw["gt"], learning_rates=lrs, num_steps=3,
                           cuda_graph=False, **settings))
    assert jit_refine.traces == 2 and jit_refine.captures == 2


def test_stamps_split_every_step_on_card(cuda, monkeypatch):
    """The bench problem (400x400, B=64, 100 Adam steps) through one kept
    ``CapturedRefine`` with tracing on (``trace.FORCED``, as ``DD_TRACE=1``
    sets it): the first call's spans hold step 0, the capture and the
    replays; in the second every step has its five stamps, non-decreasing
    and each step after the last, and the steps' spans from entry to end
    sum to within 5% of the call's time by CUDA events; the result equals
    the eager loop's bit for bit."""
    from diffdope_tpu_torch import trace
    from diffdope_tpu_torch.bench import STEPS, bench_refine, run_refinement

    monkeypatch.setattr(trace, "FORCED", True)
    problem = bench_problem(device=cuda)
    jit_refine = bench_refine(problem)
    run_refinement(problem, jit_refine=jit_refine)
    spans = trace.take()
    (call,) = [s for s in spans if s.name == "dd.refine"]
    kids = sorted((s for s in spans if s.parent == call.id), key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["dd.refine.load", "dd.refine.step0",
                                      "dd.refine.capture", "dd.refine.replay",
                                      "dd.refine.result"]
    assert kids[3].attrs["replays"] == STEPS - 1
    assert kids[3].start_ns < kids[3].attrs["first_launch_end_ns"] <= kids[3].end_ns
    assert (jit_refine.captures, jit_refine.replays) == (1, STEPS - 1)
    assert jit_refine.step0_s > 0 and jit_refine.capture_s > 0

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    got = jit_refine(problem["params0"])
    end.record()
    torch.cuda.synchronize()
    (call,) = [s for s in trace.take() if s.name == "dd.refine"]
    stamps = call.stamps
    assert stamps.shape == (STEPS, trace.POINTS) and (stamps > 0).all()
    assert (np.diff(stamps, axis=1) >= 0).all()
    assert (stamps[1:, trace.STEP] >= stamps[:-1, trace.END]).all()
    stamped_ms = float((stamps[:, trace.END] - stamps[:, trace.STEP]).sum()) * 1e-6
    event_ms = start.elapsed_time(end)
    assert 0.95 * event_ms <= stamped_ms <= event_ms, (stamped_ms, event_ms)

    eager, _ = run_refinement(problem, jit_refine=bench_refine(problem, cuda_graph=False))
    _assert_same_result(got, eager)


@pytest.mark.parametrize("case", repeatable.CASES)
def test_eager_refine_repeats_on_card(cuda, case, monkeypatch):
    """Every route of ``test_graph_refine_equals_eager_on_card`` and the
    vertex-colour and corner-colour appearance leaves, built on the card:
    the eager loop twice, 4 steps, not under torch's deterministic
    algorithms, equal bit for bit (poses, totals, logs, telemetry, params)
    with equal launch counts: every gather's backward sums in a fixed
    order."""
    from diffdope_tpu_torch.optimize import refine

    params0, kw = repeatable.build(case, monkeypatch, cuda)
    optimizer, base_lr = repeatable.optimizer_of(case)
    out = []
    for _ in range(2):
        kernels.reset_launches()
        res = refine(params0, nb_iterations=3, base_lr=base_lr, optimizer=optimizer,
                     cuda_graph=False, **kw)
        torch.cuda.synchronize()
        out.append((res, {k: v for k, v in kernels.launches.items() if v}))
    (a, la), (b, lb) = out
    assert la == lb, (la, lb)
    _assert_same_result(a, b)


def test_step_that_reads_the_host_raises_on_card(problem):
    """A step that reads a tensor's value cannot be captured: ``refine``
    raises, naming the step's loss, and returns no eager result."""
    from diffdope_tpu_torch.losses import l1_mask
    from diffdope_tpu_torch.optimize import refine
    from diffdope_tpu_torch.render.pipeline import render_batch

    s = problem["scene"]
    gt = {k: torch.as_tensor(v, device="cuda") for k, v in problem["gt"].items()}

    def render_fn(mtx):
        return render_batch(s["proj"], mtx, s["pos"], s["tri"], RES,
                            vtx_color=s["vtx_color"], edge_adj=s["edge_adj"],
                            layout="channels", compact_total=problem["compact_total"],
                            raster_impl="pallas", device="cuda")

    def reading_loss(renders, gt, lrs, weights):
        term, log = l1_mask(renders, gt, lrs, weights)
        if term.item() < 0:  # a host read inside the step
            raise AssertionError("an L1 loss is never negative")
        return term, log

    with pytest.raises(RuntimeError, match="render_fn"):
        refine(problem["params0"], render_fn, (reading_loss,), gt,
               torch.as_tensor(problem["lrs"], device="cuda"), problem["weights"],
               nb_iterations=3)


def test_k9_backward_captures_on_card(problem, params):
    """K9's backward sets its shared-memory attribute at each launch
    (csrc/rasterize.cu): legal inside a capture, the replay's d_bin that of
    an eager launch."""
    from diffdope_tpu_torch.render.gather_rows import gather_rows_bwd, gather_rows_fwd

    s = problem["scene"]
    tri = torch.as_tensor(s["tri"], device="cuda").long()
    packed, idx, counts = gather_rows_inputs(
        _pos_clip(problem, params, "cuda"), tri, RES, (32, 128),
        torch.as_tensor(s["vtx_color"], device="cuda"),
        torch.as_tensor(s["edge_adj"], device="cuda").long())
    ids, rows, win = gather_rows_fwd(packed, idx, counts, RES, (32, 128))
    d_rows = torch.randn(rows.shape, generator=torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    want = gather_rows_bwd(d_rows, win, counts, idx.shape[1], (32, 128))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        got = gather_rows_bwd(d_rows, win, counts, idx.shape[1], (32, 128))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_slot_sums_on_card_match_cpu(cuda):
    """The ``DD_BINNED=0`` route's slot sums (the segmented sum, one launch
    for every hypothesis, over the slots sorted by triangle) equal the
    CPU's index_add in slot order bit for bit: both add each triangle's
    slots in ascending slot order, sentinels (index T) left out."""
    from diffdope_tpu_torch.render.rasterize import slot_sums

    rng = np.random.default_rng(5)
    t_count, n_slots = 300, 4096
    tile_idx = rng.integers(0, t_count + 1, size=(32, n_slots // 32)).astype(np.int32)
    d_bins = rng.normal(size=(B, 32, n_slots)).astype(np.float32)
    kernels.reset_launches()
    got = slot_sums(torch.as_tensor(d_bins, device="cuda"),
                    torch.as_tensor(tile_idx, device="cuda"), t_count)
    want = slot_sums(torch.as_tensor(d_bins), torch.as_tensor(tile_idx), t_count)
    assert kernels.launches["index_rows_bwd"] == 1
    assert torch.equal(got.cpu(), want)


def test_strided_segment_sum_on_card(cuda):
    """The segmented sum reading d_bins (B, 32, slots) in place through its
    strides, one launch, equals bit for bit the per-hypothesis sums of
    d_bins transposed into a contiguous (slots, 32) buffer (the form
    before the strides, through ``setup_rows_bwd``) and the CPU path, at
    B = 4 with sentinel slots, empty triangles and a triangle in every
    tile; and it reads no sentinel slot (NaN there changes nothing)."""
    from diffdope_tpu_torch.render.rasterize import setup_rows_bwd, slot_sums

    rng = np.random.default_rng(23)
    b, t_count, n_tiles, k = 4, 97, 40, 64
    tile_idx = rng.integers(0, t_count + 1, size=(n_tiles, k))
    tile_idx[:, k // 2:] = t_count  # every tile's tail: sentinels
    tile_idx[:, 0] = 5  # one triangle held in every tile
    tile_idx[tile_idx == 11] = 12  # triangle 11 held nowhere
    tile_idx = torch.as_tensor(tile_idx.astype(np.int32), device="cuda")
    d_bins = torch.as_tensor(rng.normal(size=(b, 32, n_tiles * k)).astype(np.float32),
                             device="cuda")
    d_bins[:, :, (tile_idx.reshape(-1) == t_count)] = float("nan")
    kernels.reset_launches()
    got = slot_sums(d_bins, tile_idx, t_count)
    assert kernels.launches["index_rows_bwd"] == 1
    flat = tile_idx.reshape(1, -1)
    ids = torch.where(flat < t_count, flat + 1, 0).to(torch.int32)
    old = torch.stack([setup_rows_bwd(d_bins[i].t().contiguous()[None], ids, t_count)[0]
                       for i in range(b)]).permute(0, 2, 1)
    want = slot_sums(d_bins.cpu(), tile_idx.cpu(), t_count)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, old)
    assert torch.equal(got.cpu(), want)
    assert bool((got[:, :, 11] == 0).all()) and bool((got[:, :, 5] != 0).all())
