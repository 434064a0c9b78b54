"""The premises K10's kernels rest on, on the CPU, on sorted tables made by
both packages.

K10's forward is K3's stage and tests over the chunks of the sorted table
that each tile's gate admits (``csrc/raster.cu``, ``SortedRange``): it
stages only the slots whose rows and columns meet the tile, and skips
every (pixel, slot) test outside them.  It takes those rows and columns
from each slot's f32 edge planes (``raster_v3.cover_ranges`` is the
plain twin), over the whole padded frame, not from the vertex bounds of
lanes 28-31 that K3's staging uses (``raster.slot_ranges``), which stop
at the frame's edge and miss a sliver's f32 coverage past its corners.
K10's backward walks, per chunk, the tiles the forward gated it into.
Held here:

- the ranges never exclude a pixel that a slot can win (covered, |z| <=
  1, det != 0) anywhere in the padded frame, where the frame's rule drops
  some in the padding; and on a sliver of ``chip_smoke.py``'s phase 11,
  whose f32 planes cover a pixel 8 rows past its vertex bounds;
- a plain torch twin of the forward's walk (the gated chunks, the
  compaction, the range skip, K3's arithmetic) gives the plain K10
  forward's ids, win and rows exactly;
- every pixel's winner lies in a chunk gated at the pixel's tile, so the
  backward's walk meets every won pixel; its per-slot sums in that walk's
  order (tiles row-major, pixels ascending) agree with the plain twin at
  rtol 2e-4, atol 1e-6 plus 1e-6 of the summed |terms|.

The scene: icosphere(2) off centre so that it reaches the bottom and
right edges of a 60x90 frame (padded to 64x96 at the port's 16x16 tile),
a triangle with one corner behind the camera (its NDC ranges open, +-4),
and degenerate padding triangles; B = 2 poses 1% apart.  Its table comes
from the port's ``planar.pack_planar`` and from the JAX package's
``diffdope_tpu.render.planar.packed_planar``, each sorted by the port's
``_prepare``.
"""

import functools

import numpy as np
import pytest
import torch

from diffdope_tpu_torch.render import raster_v3 as port
from diffdope_tpu_torch.render.raster import raster_bwd_plain, slot_ranges
from diffdope_tpu_torch.render.shade import ndc
from diffdope_tpu_torch.testing import SLIVER_LANES
from torch_scene import one_torch_thread  # noqa: F401

RES = (60, 90)
PAD = (64, 96)
TILE = (16, 16)
B = 2
T_PAD = 352
CROSSING = 320  # icosphere(2)'s 320 faces, then the triangle behind the camera


@functools.lru_cache(maxsize=None)
def _scene():
    """(object-space corners (T_PAD*3, 3), triangles, mvp (B, 4, 4), pose
    matrices, degenerate mask, edge adjacency, per-corner colours) as
    numpy."""
    from diffdope_tpu import geometry as geo
    from diffdope_tpu.mesh import build_edge_adjacency
    from diffdope_tpu.optimize import pose_matrix, pose_params
    from diffdope_tpu.testing import icosphere

    v, fc = icosphere(2)
    v = v.astype(np.float32) * 0.4
    # a triangle with a corner behind the camera (the pose puts the object
    # 2 units in front)
    cross = np.array([[-0.2, -0.1, 0.3], [0.25, 0.05, 0.2], [0.0, 0.1, 2.4]], np.float32)
    n_v = v.shape[0]
    v = np.concatenate([v, cross])
    fc = np.concatenate([fc, [[n_v, n_v + 1, n_v + 2]]]).astype(np.int32)
    n_real = fc.shape[0]
    fc = np.concatenate([fc, np.zeros((T_PAD - n_real, 3), np.int32)])
    adj = np.concatenate([build_edge_adjacency(fc[:n_real]),
                          -np.ones((T_PAD - n_real, 3), np.int32)])
    h, w = RES
    f = 1.2 * max(h, w)
    proj = np.asarray(geo.projection_from_intrinsics(f, f, w / 2, h / 2, w, h, 0.01, 100.0),
                      np.float32)
    q = geo.quat_from_axis_angle(np.array([0.2, 1.0, 0.1]), 0.3)
    params = pose_params(np.asarray(q, np.float32), np.array([0.42, -0.22, -2.0], np.float32),
                         B)
    params = {k: val + np.arange(B) * 0.01 for k, val in params.items()}
    mtx = np.asarray(pose_matrix(params)[0], np.float32)
    mvp = np.einsum("ij,bjk->bik", proj, mtx).astype(np.float32)
    degen = (fc[:, 0] == fc[:, 1]) | (fc[:, 1] == fc[:, 2]) | (fc[:, 2] == fc[:, 0])
    colors = (v * 0.5 + 0.5)[fc.reshape(-1)].reshape(T_PAD, 3, 3)
    return v[fc.reshape(-1)], fc, mvp, mtx, degen, adj, colors


@functools.lru_cache(maxsize=None)
def _table(source: str) -> np.ndarray:
    """The (B, 32, T_PAD) triangle-order table of the scene, packed by the
    port or by the JAX package."""
    pos_c, _, mvp, mtx, degen, adj, colors = _scene()
    zrot = np.einsum("bj,nj->bn", mtx[:, 2, :3], pos_c).astype(np.float32)
    if source == "port":
        from diffdope_tpu_torch.render.planar import corner_planes, pack_planar

        cp = corner_planes(torch.tensor(pos_c), torch.tensor(mvp))
        packed, _ = pack_planar(cp, torch.tensor(colors), torch.tensor(zrot),
                                torch.tensor(adj).long(), torch.tensor(degen))
        return packed.numpy()
    import jax.numpy as jnp

    from diffdope_tpu.render.planar import corner_planes, packed_planar

    cp = corner_planes(jnp.asarray(pos_c)[None], jnp.asarray(mvp))
    packed, _ = packed_planar(cp, jnp.asarray(colors), jnp.asarray(zrot),
                              jnp.asarray(adj), jnp.asarray(degen))
    return np.asarray(packed)


def _sorted(source: str):
    packed = torch.tensor(_table(source))
    tables = port.prepare(packed, RES, TILE)
    return port.sorted_table(packed, tables), tables


def _tests(packed_s):
    """(B, T_pad, Hp, Wp): the slots each pixel of the padded frame can be
    won by (covered, |z| <= 1, det != 0), K3's arithmetic with the pixel
    NDC over the real frame; and z there."""
    x = ndc(torch.arange(PAD[1]), RES[1])[None, None, None, :]
    y = ndc(torch.arange(PAD[0]), RES[0])[None, None, :, None]
    lane = [packed_s[:, k][..., None, None] for k in range(14)]
    det = lane[12]
    sgn = torch.sign(det)
    e = [x * (lane[3 * m] * sgn) + (y * (lane[3 * m + 1] * sgn) + lane[3 * m + 2] * sgn)
         for m in range(3)]
    inv_det = 1.0 / torch.where(det != 0.0, det, torch.ones_like(det))
    z = (x * lane[9] + (y * lane[10] + lane[11])) * inv_det
    ok = (e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0) & (det != 0.0) & (z >= -1.0) & (z <= 1.0)
    return ok, z


def _inside(ranges):
    rlo, rhi, clo, chi = ranges
    rows = torch.arange(PAD[0])[None, None, :, None]
    cols = torch.arange(PAD[1])[None, None, None, :]
    return ((rows >= rlo[..., None, None]) & (rows <= rhi[..., None, None])
            & (cols >= clo[..., None, None]) & (cols <= chi[..., None, None]))


@pytest.mark.parametrize("source", ["port", "reference"])
def test_torch_k10_ranges_hold_every_pixel_a_slot_can_win(source):
    packed_s, tables = _sorted(source)
    can_win, _ = _tests(packed_s)
    inside = _inside(port.cover_ranges(packed_s, RES, PAD))
    assert int(can_win.sum()) > 2000
    assert not bool((can_win & ~inside).any())
    # the frame's rule of lanes 28-31 drops pixels of the padding that a
    # slot can win
    beyond = can_win & ~_inside(slot_ranges(packed_s, RES))
    assert int(beyond.sum()) > 0
    assert bool((beyond[:, :, :RES[0], :RES[1]] == 0).all())
    # the triangle behind the camera has open ranges and can win pixels
    tri = packed_s[0, 13].long()
    crossing = int((tri == CROSSING).nonzero()[0])
    assert float(packed_s[0, 31, crossing]) == 4.0 and float(packed_s[0, 30, crossing]) == -4.0
    assert int(can_win[:, crossing].sum()) > 0
    # a chunk gated at several tiles, and the ranges skip most pairs of
    # the live slots (a slot with det 0 is never staged)
    gate = port._gate(tables, PAD[0] // TILE[0], PAD[1] // TILE[1], TILE[0])
    assert int(gate.sum(dim=0).max()) > 1
    live = (packed_s[:, 12] != 0)[..., None, None].expand_as(inside)
    assert float(inside[live].float().mean()) < 0.05


def test_torch_k10_ranges_hold_a_slivers_coverage_past_its_corners():
    res, pad, pixel = (540, 960), (544, 960), (111, 328)
    packed = torch.zeros((1, 32, 1))
    for lane, value in SLIVER_LANES.items():
        packed[0, lane, 0] = value
    x = ndc(torch.tensor([pixel[1]]), res[1])
    y = ndc(torch.tensor([pixel[0]]), res[0])
    lane = [packed[0, k, 0] for k in range(13)]
    e = [x * lane[3 * m] + (y * lane[3 * m + 1] + lane[3 * m + 2]) for m in range(3)]
    z = (x * lane[9] + (y * lane[10] + lane[11])) * (1.0 / lane[12])
    assert all(bool(v >= 0) for v in e) and bool(z.abs() <= 1)  # covered, can win
    rlo, rhi, clo, chi = (v[0, 0] for v in slot_ranges(packed, res))
    assert not rlo <= pixel[0] <= rhi  # the vertex bounds miss it
    rlo, rhi, clo, chi = (v[0, 0] for v in port.cover_ranges(packed, res, pad))
    assert rlo <= pixel[0] <= rhi and clo <= pixel[1] <= chi
    assert rhi - rlo < 64 and chi - clo < 64  # still a bounded box


def _walk_twin(packed_s, tables):
    """The K10 forward's walk in plain torch: per tile the gated chunks'
    slots, those whose ranges meet the tile (per hypothesis), each tested
    at the tile's pixels inside its range by K3's arithmetic; the (z, id)
    minimum.  Returns (ids, rows, win) over the padded frame and the count
    of (hypothesis, tile, slot) stagings."""
    (th, tw), (hp, wp) = TILE, PAD
    nty, ntx = hp // th, wp // tw
    gate = port._gate(tables, nty, ntx, th)
    can_win, z = _tests(packed_s)
    rlo, rhi, clo, chi = port.cover_ranges(packed_s, RES, PAD)
    b = packed_s.shape[0]
    ids = torch.zeros((b, hp, wp), dtype=torch.int32)
    win = torch.full((b, hp, wp), -1, dtype=torch.int32)
    rows = torch.zeros((b, 32, hp, wp))
    staged = 0
    for t in range(nty * ntx):
        r0, c0 = (t // ntx) * th, (t % ntx) * tw
        chunks = torch.nonzero(gate[t]).reshape(-1)
        cand = (chunks[:, None] * tables.k_chunk + torch.arange(tables.k_chunk)).reshape(-1)
        for bi in range(b):
            meet = ((rlo[bi, cand] <= rhi[bi, cand]) & (rhi[bi, cand] >= r0)
                    & (rlo[bi, cand] <= r0 + th - 1) & (clo[bi, cand] <= chi[bi, cand])
                    & (chi[bi, cand] >= c0) & (clo[bi, cand] <= c0 + tw - 1)
                    & (packed_s[bi, 12, cand] != 0))
            s = cand[meet]
            staged += s.numel()
            r = torch.arange(r0, r0 + th)[None, :, None]
            c = torch.arange(c0, c0 + tw)[None, None, :]
            inside = ((r >= rlo[bi, s, None, None]) & (r <= rhi[bi, s, None, None])
                      & (c >= clo[bi, s, None, None]) & (c <= chi[bi, s, None, None]))
            ok = can_win[bi, s, r0:r0 + th, c0:c0 + tw] & inside
            zs = torch.where(ok, z[bi, s, r0:r0 + th, c0:c0 + tw], float("inf"))
            zmin = zs.amin(dim=0) if s.numel() else torch.full((th, tw), float("inf"))
            idv = torch.where(ok & (zs == zmin), packed_s[bi, 13, s, None, None],
                              float("inf"))
            best = idv.argmin(dim=0) if s.numel() else None
            hit = torch.isfinite(zmin)
            if not bool(hit.any()):
                continue
            slot = s[best]
            win[bi, r0:r0 + th, c0:c0 + tw] = torch.where(hit, slot, -1).int()
            ids[bi, r0:r0 + th, c0:c0 + tw] = torch.where(
                hit, packed_s[bi, 13, slot].int() + 1, 0)
            rows[bi, :, r0:r0 + th, c0:c0 + tw] = torch.where(
                hit, packed_s[bi][:, slot], 0.0)
    return ids, rows, win, staged


@pytest.mark.parametrize("source", ["port", "reference"])
def test_torch_k10_walk_twin_gives_the_plain_forward(source):
    packed_s, tables = _sorted(source)
    ids, rows, win, staged = _walk_twin(packed_s, tables)
    want_ids, want_rows, want_win = port.raster_v3_fwd_plain(packed_s, tables, RES, TILE)
    assert int((want_ids > 0).sum()) > 1000
    assert int((want_ids[:, RES[0]:] > 0).sum() + (want_ids[:, :, RES[1]:] > 0).sum()) > 0
    assert torch.equal(ids, want_ids) and torch.equal(win, want_win)
    assert torch.equal(rows, want_rows)
    gate = port._gate(tables, PAD[0] // TILE[0], PAD[1] // TILE[1], TILE[0])
    walked = B * int(gate.sum()) * tables.k_chunk
    assert staged < walked


@pytest.mark.parametrize("source", ["port", "reference"])
def test_torch_k10_backward_walk_meets_every_won_pixel(source):
    packed_s, tables = _sorted(source)
    (th, tw), (hp, wp) = TILE, PAD
    nty, ntx = hp // th, wp // tw
    _, _, win = port.raster_v3_fwd_plain(packed_s, tables, RES, TILE)
    gate = port._gate(tables, nty, ntx, th)
    bi, r, c = torch.nonzero(win >= 0, as_tuple=True)
    tile = (r // th) * ntx + c // tw
    assert bi.numel() > 1000
    assert bool(gate[tile, win[bi, r, c].long() // tables.k_chunk].all())
    # the sums in the walk's order: the tiles row-major, a tile's pixels
    # ascending, one running sum a slot
    d_rows = torch.tensor(np.random.default_rng(5).normal(size=(B, 32) + PAD)
                          .astype(np.float32))
    acc = torch.zeros((B * tables.t_pad + 1, 32))
    for t in range(nty * ntx):
        r0, c0 = (t // ntx) * th, (t % ntx) * tw
        w_t = win[:, r0:r0 + th, c0:c0 + tw].reshape(B, -1).long()
        target = torch.where(w_t >= 0, torch.arange(B)[:, None] * tables.t_pad + w_t,
                             B * tables.t_pad).reshape(-1)
        src = d_rows[:, :, r0:r0 + th, c0:c0 + tw].reshape(B, 32, -1).permute(0, 2, 1)
        acc.index_add_(0, target, src.reshape(-1, 32))
    got = acc[:-1].reshape(B, tables.t_pad, 32).permute(0, 2, 1)
    want = port.raster_v3_bwd_plain(d_rows, win, tables.t_pad)
    scale = raster_bwd_plain(d_rows.abs(), win, tables.t_pad)
    assert bool(torch.all((got - want).abs() <= 1e-6 + 2e-4 * want.abs() + 1e-6 * scale))
    assert float(want.abs().max()) > 0
