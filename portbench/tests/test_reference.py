"""The plain reference held to hand-worked cases and, at tiny sizes on the
CPU, to the program's CPU path (its kernels' plain versions)."""

import numpy as np
import pytest
import torch

from portbench.reference import geometry as geo
from portbench.reference import mesh as ref_mesh
from portbench.reference import metrics as ref_metrics
from portbench.reference.optim import Optimizer, learning_rate
from portbench.reference.render import Mesh, loss_terms, raster_ids, render, setup

from portbench.tests.conftest import ROOT, tiny_problem


def _clip_setup(corners_ndc, z):
    """Setup lanes of triangles given by NDC corners at depth z, w = 1."""
    c = torch.zeros((1, len(corners_ndc), 3, 4))
    for t, (tri, zt) in enumerate(zip(corners_ndc, z)):
        for k, (x, y) in enumerate(tri):
            c[0, t, k] = torch.tensor([x, y, zt, 1.0])
    return setup(c, torch.zeros(len(corners_ndc), dtype=torch.bool)), c


def test_ids_of_one_triangle_by_hand():
    # x + y <= 0 of a 4 x 4 frame: pixel centres at NDC -0.75, -0.25, 0.25,
    # 0.75, row 0 at the bottom; the centres on the diagonal have an edge
    # function of exactly 0, which covers
    coef, corners = _clip_setup([[(-1.0, -1.0), (1.0, -1.0), (-1.0, 1.0)]], [0.0])
    ids = raster_ids(coef, corners, (4, 4))[0]
    want = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 0], [1, 1, 0, 0], [1, 0, 0, 0]],
                        dtype=torch.int32)
    assert torch.equal(ids, want)


def test_nearer_triangle_wins_and_ties_go_to_the_smaller_index():
    full = [(-3.0, -3.0), (9.0, -3.0), (-3.0, 9.0)]
    coef, corners = _clip_setup([full, full, full], [0.5, -0.5, -0.5])
    ids = raster_ids(coef, corners, (8, 8))
    assert (ids == 2).all()  # triangle 1 is nearer than 0 and ties with 2


def test_binned_ids_equal_every_triangle_at_every_pixel():
    v, f = ref_mesh.icosphere(2)
    proj = torch.as_tensor(geo.projection(60, 60, 24, 20, 48, 40, 0.01, 100.0), dtype=torch.float32)
    mtx = geo.pose_matrix(torch.tensor([[0.1, 0.7, 0.2, 0.6]]), torch.tensor([[0.05, -0.1, -2.0]]))
    mesh = Mesh(v * 0.5, f, v * 0.5 + 0.5, None, "cpu")
    corners = geo.xfm_points(mesh.pos_c, geo.matmul44(proj, mtx)).reshape(1, -1, 3, 4)
    coef = setup(corners, mesh.degenerate)
    ids = raster_ids(coef, corners, (40, 48))[0]
    from portbench.reference.render import _edges_z, ndc

    x = ndc(torch.arange(48), 48, torch.float32)[None, :, None]
    y = ndc(torch.arange(40), 40, torch.float32)[:, None, None]
    ok, z = _edges_z([coef[0, :, i] for i in range(13)], x, y)
    z = torch.where(ok, z, torch.full_like(z, float("inf")))
    zmin = z.amin(-1)
    brute = torch.where(torch.isinf(zmin), 0, (z == zmin[..., None]).int().argmax(-1) + 1)
    assert torch.equal(ids, brute.to(torch.int32))
    assert (ids > 0).sum() > 200


def test_add_and_auc_by_hand():
    pts = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    m = np.eye(4)
    moved = np.eye(4)
    moved[:3, 3] = (0.3, 0.4, 0.0)
    assert ref_metrics.add(pts, moved, m) == pytest.approx(0.5)
    assert ref_metrics.auc([0.0, 0.05, 0.2], 0.1) == pytest.approx((1.0 + 0.5 + 0.0) / 3)
    assert ref_metrics.diameter(pts) == pytest.approx(np.sqrt(2))


def test_optimizers_by_hand():
    lr0 = float(learning_rate(0.02, 0.1, 99, 0))
    assert lr0 == pytest.approx(0.002)
    p = {"a": torch.tensor([1.0, 1.0])}
    Optimizer("adam", 0.02, 0.1, 99).update(p, {"a": torch.tensor([3.0, -0.5])})
    assert torch.allclose(p["a"], torch.tensor([1.0 - lr0, 1.0 + lr0]), atol=1e-8)
    p = {"a": torch.tensor([1.0])}
    Optimizer("sgd", 20.0, 0.1, 60).update(p, {"a": torch.tensor([0.25])})
    assert float(p["a"]) == pytest.approx(1.0 - 2.0 * 0.25)


def test_edge_adjacency_and_ply():
    v, f = ref_mesh.icosphere(1)
    adj = ref_mesh.edge_adjacency(f)
    assert (adj >= 0).all()
    for t in range(len(f)):
        for k in range(3):
            edge = {int(f[t, k]), int(f[t, (k + 1) % 3])}
            assert edge <= set(f[adj[t, k]].tolist())
    ply = ref_mesh.read_ply(ROOT / "data/standins/standin_asym.ply")
    assert ply["vertices"].shape == (2562, 3) and ply["faces"].shape == (5120, 3)


def test_ply_reads_as_the_program_loads_it():
    from diffdope_tpu_torch.mesh import load_mesh

    ply = ref_mesh.read_ply(ROOT / "data/standins/standin_asym.ply")
    m = load_mesh(ROOT / "data/standins/standin_asym.ply", scale=0.01)
    n, t = m.num_vertices, m.num_triangles
    assert np.array_equal(m.pos[:n], ply["vertices"] * np.float32(0.01))
    assert np.array_equal(m.pos_idx[:t], ply["faces"])
    assert np.array_equal(m.vtx_color[:n], ply["colors"])
    from diffdope_tpu_torch.mesh import build_edge_adjacency

    assert np.array_equal(build_edge_adjacency(ply["faces"]), ref_mesh.edge_adjacency(ply["faces"]))


@pytest.mark.parametrize("table", ["uniform", "compact"])
def test_terms_and_pose_gradient_equal_the_programs_cpu_path(table):
    """At a tiny size the reference's loss terms and pose gradient agree with
    the program's fused loss on the CPU (the kernels' plain versions): the
    compact table with the bf16 d_rows lane, the uniform one in f32."""
    from diffdope_tpu_torch.optimize import pose_matrix, pose_params
    from diffdope_tpu_torch.render.pipeline import compact_capacity, make_fused_loss

    p, frames = tiny_problem()
    gt = {"rgb": frames["rgb"][0].permute(1, 2, 0), "segmentation": frames["seg"][0].permute(1, 2, 0)}
    q0 = geo.quat_multiply(geo.quat_from_axis_angle([0.3, 1.0, -0.2], 0.12), p.q_base)
    t0 = p.t_base + np.array([0.03, -0.02, 0.04])
    params = pose_params(q0.astype(np.float32), t0.astype(np.float32), p.batch, "cpu")
    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    cap = None
    if table == "compact":
        cap = 2 * compact_capacity(p.proj, p.pos, p.tri, pose_matrix(params)[0][:1].detach(),
                                   p.resolution, device="cpu")
    fn = make_fused_loss(p.proj, p.pos, p.tri, p.resolution, gt, p.scales, p.weights,
                         use_rgb=True, use_mask=True, edge_adj=p.adj, vtx_color=p.colors,
                         compact_total=cap, device="cpu")
    total, logs = fn(pose_matrix(params)[0])
    g_prog = torch.autograd.grad(total, [params[k] for k in ("qx", "qy", "qz", "qw", "x", "y", "z")])

    mesh = Mesh(p.pos, p.tri, p.colors, p.adj, "cpu")
    q = torch.tensor(np.tile(q0.astype(np.float32), (p.batch, 1)), requires_grad=True)
    t = torch.tensor(np.tile(t0.astype(np.float32), (p.batch, 1)), requires_grad=True)
    out = render(mesh, torch.as_tensor(p.proj), geo.pose_matrix(q, t), p.resolution,
                 drows_bf16=table == "compact")
    terms = loss_terms(out, frames["rgb"][0], frames["seg"][0], p.weights)
    ref_total = sum((v * torch.as_tensor(p.scales)).mean() for v in terms.values())
    gq, gt_ = torch.autograd.grad(ref_total, [q, t])
    for key in ("rgb", "mask_selection"):
        assert torch.allclose(logs[key], terms[key], rtol=1e-5, atol=0)
    g_ref = torch.cat([gq, gt_], dim=1)
    g_prog = torch.stack(g_prog, dim=1)
    assert torch.allclose(g_prog, g_ref, rtol=1e-4, atol=1e-4 * float(g_ref.abs().max()))
