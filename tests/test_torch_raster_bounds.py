"""K3/K7's slot ranges and the recounted kernel bounds (kernels/check.py).

``raster.slot_ranges`` are the reference's conservative rows
(``raster_v2.py:1346-1377``) and columns from the packed table's NDC
ranges, lanes 28-31, by which its TPU kernel gates chunks.  Held here, at
the bench scene's shapes cut to 64x96 (icosphere(2), triangles of ~20 px,
and icosphere(4), of 1-2 px), to exclude no covered pixel of the frame on
these scenes: neither a brute-force winner
(``rasterize.raster_ids_reference``) nor any pixel that K3's own test
(the plain twin's arithmetic) covers.  (They do miss a sliver's coverage
and the padding, so the K3/K7 forward stages by the cover boxes instead:
tests/test_torch_k3_premises.py.)  The K3 bound's operations are 15 per
pair inside a slot's cover box (``raster_v3.cover_ranges``, what the
kernel stages and ``check.range_tests`` counts), counted independently;
the bf16 lane's d_rows count 2 bytes a value.
"""

import numpy as np
import pytest
import torch

from diffdope_tpu_torch.bench import bench_problem, distinct_poses
from diffdope_tpu_torch.geometry import matmul44, xfm_points
from diffdope_tpu_torch.kernels import check
from diffdope_tpu_torch.optimize import pose_matrix
from diffdope_tpu_torch.render import pipeline, raster_v3
from diffdope_tpu_torch.render.raster import slot_ranges
from diffdope_tpu_torch.render.rasterize import raster_ids_reference
from diffdope_tpu_torch.render.setup_tris import triangle_setup
from diffdope_tpu_torch.render.shade import ndc
from torch_scene import one_torch_thread  # noqa: F401

RES = (64, 96)


@pytest.fixture(scope="module", params=[2, 4])
def scene(request):
    """The bench problem at icosphere(``subdiv``), three distinct poses."""
    problem = bench_problem(RES, subdiv=request.param, batch=3, device="cpu")
    mtx, _, _ = pose_matrix(distinct_poses(problem["params0"], 0.01))
    return problem, mtx


def _k3_coverage(packed, frame_hw):
    """(B, T, H, W): K3's coverage test of every triangle of the
    triangle-order table at every pixel, the plain twin's arithmetic."""
    h, w = frame_hw
    x = ndc(torch.arange(w), w)[None, None, None, :]
    y = ndc(torch.arange(h), h)[None, None, :, None]
    lane = [packed[:, k][..., None, None] for k in range(13)]
    sgn = torch.sign(lane[12])
    e = [x * (lane[3 * m] * sgn) + (y * (lane[3 * m + 1] * sgn) + lane[3 * m + 2] * sgn)
         for m in range(3)]
    return (e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0) & (lane[12] != 0)


def test_torch_slot_ranges_hold_every_covered_pixel(scene):
    problem, mtx = scene
    packed, _, _ = pipeline._planar_pack(problem["fn"].mesh, mtx)
    rlo, rhi, clo, chi = slot_ranges(packed, RES)
    h, w = RES
    rows = torch.arange(h)[None, None, :, None]
    cols = torch.arange(w)[None, None, None, :]
    inside = ((rows >= rlo[..., None, None]) & (rows <= rhi[..., None, None])
              & (cols >= clo[..., None, None]) & (cols <= chi[..., None, None]))
    covered = _k3_coverage(packed, RES)
    assert int(covered.sum()) > 1000
    assert not bool((covered & ~inside).any())
    # the brute force's winners (the API's setup of the same clip corners)
    s = problem["scene"]
    pos_clip = xfm_points(torch.as_tensor(s["pos"]), matmul44(torch.as_tensor(s["proj"]), mtx))
    ids = raster_ids_reference(triangle_setup(pos_clip, torch.as_tensor(s["tri"])).coef, RES)
    b, r, c = torch.nonzero(ids > 0, as_tuple=True)
    t = ids[b, r, c].long() - 1
    assert r.numel() > 1000
    assert bool(inside[b, t, r, c].all())
    # the ranges are tight enough to matter: most (pixel, triangle) pairs
    # of the frame are outside them
    assert float(inside.float().mean()) < 0.02


def test_torch_k3_bound_counts_15_per_in_range_pair(scene, monkeypatch):
    """The K3 forward's bound charges 15 operations per (hypothesis, pixel,
    slot) pair inside the slot's cover box within its tile, counted here by
    brute force over each held slot's tile."""
    problem, mtx = scene
    fn = problem["fn"]
    with torch.no_grad():
        tab = fn.table(mtx)
    n = torch.minimum(tab.counts, tab.used * pipeline.K_CHUNK).long()
    base = tab.off_c.long() * pipeline.K_CHUNK
    (th, tw), (hc, wc), (oy, ox, fh, fw) = pipeline.TILE_HW, fn.frame_hw, fn.roi
    rlo, rhi, clo, chi = raster_v3.cover_ranges(tab.packed, (fh, fw), (oy + hc, ox + wc))
    want = 0
    for t in range(n.numel()):
        r0, c0 = (t // (wc // tw)) * th + oy, (t % (wc // tw)) * tw + ox
        rows = torch.arange(r0, r0 + th)[None, None, :, None]
        cols = torch.arange(c0, c0 + tw)[None, None, None, :]
        sl = slice(int(base[t]), int(base[t] + n[t]))
        inside = ((rows >= rlo[:, sl, None, None]) & (rows <= rhi[:, sl, None, None])
                  & (cols >= clo[:, sl, None, None]) & (cols <= chi[:, sl, None, None]))
        want += int(inside.sum())
    assert want > 0
    charged = []
    monkeypatch.setattr(check, "bound", lambda n_bytes, n_ops: charged.append(n_ops))
    spec = check._binned_spec(fn, mtx, mtx.shape[0] * hc * wc)
    assert spec.info["range_tests"] == want
    spec.fwd_bound(torch.full((mtx.shape[0], hc, wc), -1, dtype=torch.int32), 0)
    assert charged == [15 * want]


def test_torch_bf16_rows_count_half_the_d_rows_bytes(monkeypatch):
    """With the bf16 lane, K6's and K4's bounds charge 2 bytes per d_rows
    value (K6 writes 32 lanes a pixel, K4 reads them at the foreground):
    the f32 rows' bytes less 64 a pixel and 64 a foreground pixel."""
    problem = bench_problem(RES, subdiv=2, batch=2, device="cpu")
    mtx, _, _ = pose_matrix(distinct_poses(problem["params0"], 0.01))
    assert problem["fn"].drows_bf16
    charged = []
    monkeypatch.setattr(check, "bound", lambda n_bytes, n_ops: (charged.append(n_bytes),
                                                              (0.0, "bytes"))[1])
    d_sums = torch.tensor([[1.0, 0.7, 0.0], [0.5, 1.3, 0.0]])
    rows = check.check_kernels(problem["fn"], mtx, d_sums)
    by_name = dict(zip((r["name"] for r in rows), charged))
    assert all(r["ok"] for r in rows), rows
    hc, wc = problem["fn"].frame_hw
    npx, fg = 2 * hc * wc, rows[0]["fg_pixels"]
    assert by_name["K6_loss_bwd"] - by_name["K6_loss_bwd_bf16"] == 2 * 32 * npx
    assert by_name["K4_raster_bwd"] - by_name["K4_raster_bwd_bf16"] == 2 * 32 * fg
    assert check.d_rows_bytes(10, torch.bfloat16) * 2 == check.d_rows_bytes(10, torch.float32)
