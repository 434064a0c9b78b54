"""The premises K8's and K9's forward rest on, on the CPU, on setup rows
made by both packages.

The forward (``csrc/rasterize.cu``) computes each (hypothesis, triangle)'s
cover box once (``raster_v3.cover_ranges`` is the plain twin: the frame
rows and columns its f32 edge planes, pre-signed by sign(det), can cover,
over the padded frame), runs one block per (16x16 sub-tile of a tile,
hypothesis), stages only the bin entries whose box meets the sub-tile, in
the bin's ascending order, and skips every (pixel, entry) test outside the
box.  Its tests are K8's arithmetic, ``(c0*x + c1*y) + c2`` and an IEEE
``zlin / det`` (not K3's), and a strictly smaller z wins, so the smallest
bin index keeps a tie.  Held here:

- every (pixel, triangle) pair that K8's arithmetic covers with |z| <= 1
  and det != 0 lies inside the triangle's box, on the port's setup rows
  and on the JAX package's ``triangle_setup`` rows fed through the port's
  box function: over the padded frame of tiles (16, 32) and (32, 128), for
  a triangle with a corner behind the camera (crossing w = 0), and for a
  sliver of the default configuration's frame, whose planes cover a pixel
  8 rows past its vertex bounds;
- a plain twin of the new walk (sub-tiles, box gate, compacted ascending
  stage, strict z <) gives ``raster_ids_binned_plain``'s ids and
  ``gather_rows_fwd_plain``'s ids, win and rows exactly, and stages far
  fewer (entry, sub-tile) pairs than the TPU kernel tests.

The scene is ``tests/test_torch_k10_premises.py``'s: icosphere(2) across
the bottom and right edges of a 60x90 frame, a triangle with one corner
behind the camera, degenerate padding triangles, B = 2 poses 1% apart.
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_k10_premises import CROSSING, RES, _scene

from diffdope_tpu_torch.kernels.check import bin_box_tests, gather_rows_inputs, raster_ids_inputs
from diffdope_tpu_torch.render.gather_rows import gather_rows_fwd_plain
from diffdope_tpu_torch.render.raster import slot_ranges
from diffdope_tpu_torch.render.raster_v3 import cover_ranges
from diffdope_tpu_torch.render.rasterize import raster_ids_binned_plain
from diffdope_tpu_torch.render.shade import ndc
from diffdope_tpu_torch.testing import SLIVER_LANES
from torch_scene import one_torch_thread  # noqa: F401

TILES = [(16, 32), (32, 128)]
SUB = 16  # the kernel's sub-tile


def _padded(tile):
    return tuple(-(-n // t) * t for n, t in zip(RES, tile))


@functools.lru_cache(maxsize=None)
def _clip():
    """(pos_clip (B, N, 4), tri (T, 3)) of the scene, as numpy."""
    v, fc, mvp = _scene()[:3]
    # _scene's first item is corner-expanded: take every third corner back
    verts = v.reshape(-1, 3, 3)
    n = int(fc.max()) + 1
    pos = np.zeros((n, 3), np.float32)
    pos[fc.reshape(-1)] = verts.reshape(-1, 3)
    hom = np.concatenate([pos, np.ones((n, 1), np.float32)], axis=1)
    return np.einsum("bij,nj->bni", mvp, hom).astype(np.float32), fc


@functools.lru_cache(maxsize=None)
def _rows(source: str) -> torch.Tensor:
    """The (B, T, 16) setup rows of the scene, by the port or the JAX
    package."""
    pos_clip, tri = _clip()
    if source == "port":
        from diffdope_tpu_torch.render.setup_tris import triangle_setup

        return triangle_setup(torch.tensor(pos_clip), torch.tensor(tri)).coef
    import jax.numpy as jnp

    from diffdope_tpu.render.setup_tris import triangle_setup

    return torch.tensor(np.asarray(triangle_setup(jnp.asarray(pos_clip),
                                                  jnp.asarray(tri)).coef))


def _k8_tests(rows, res, pad):
    """(B, T, Hp, Wp): the pixels of the padded frame each triangle can win
    by K8's arithmetic (covered, det != 0, |z| <= 1), pixel NDC over the
    real frame."""
    x = ndc(torch.arange(pad[1]), res[1])[None, None, None, :]
    y = ndc(torch.arange(pad[0]), res[0])[None, None, :, None]
    c = [rows[..., k][..., None, None] for k in range(13)]
    sgn = torch.sign(c[12])
    e = [(c[3 * m] * x + c[3 * m + 1] * y) + c[3 * m + 2] for m in range(3)]
    z = ((c[9] * x + c[10] * y) + c[11]) / torch.where(c[12] != 0, c[12], 1.0)
    return ((e[0] * sgn >= 0) & (e[1] * sgn >= 0) & (e[2] * sgn >= 0) & (c[12] != 0)
            & (z >= -1.0) & (z <= 1.0))


def _inside(boxes, pad):
    rlo, rhi, clo, chi = boxes
    r = torch.arange(pad[0])[None, None, :, None]
    c = torch.arange(pad[1])[None, None, None, :]
    return ((r >= rlo[..., None, None]) & (r <= rhi[..., None, None])
            & (c >= clo[..., None, None]) & (c <= chi[..., None, None]))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("source", ["port", "reference"])
def test_torch_k8_boxes_hold_every_pixel_a_triangle_can_win(source, tile):
    rows = _rows(source)
    pad = _padded(tile)
    can_win = _k8_tests(rows, RES, pad)
    inside = _inside(cover_ranges(rows.transpose(1, 2), RES, pad), pad)
    assert int(can_win.sum()) > 2000
    assert not bool((can_win & ~inside).any())
    # foreground in the padding, and the triangle behind the camera wins
    # pixels inside its (open) box
    assert int(can_win[..., RES[0]:, :].sum() + can_win[..., RES[1]:].sum()) > 0
    assert int(can_win[:, CROSSING].sum()) > 0
    # the boxes skip most (pixel, triangle) pairs of the live triangles
    live = (rows[..., 12] != 0)[..., None, None].expand_as(inside)
    assert float(inside[live].float().mean()) < 0.05


def test_torch_k8_box_holds_a_slivers_coverage_past_its_corners():
    """The sliver's lanes 0-12 as a setup row (both packages' rows carry
    the same planes there), in both windings, at 960x540 and tile
    (32, 128): K8's arithmetic covers pixel (111, 328), inside its box,
    which the vertex bounds of its packed row miss."""
    res, pixel = (540, 960), (111, 328)
    rows = torch.zeros((2, 1, 16))
    for lane, value in SLIVER_LANES.items():
        if lane < 13:
            rows[:, 0, lane] = value
    rows[1, 0, :13] *= -1.0  # planes and det negated: the other winding
    rows[1, 0, 9:12] *= -1.0  # z unchanged
    pad = (544, 1024)
    x = ndc(torch.tensor([pixel[1]]), res[1])
    y = ndc(torch.tensor([pixel[0]]), res[0])
    c = [rows[:, 0, k] for k in range(13)]
    e = [(c[3 * m] * x + c[3 * m + 1] * y) + c[3 * m + 2] for m in range(3)]
    z = ((c[9] * x + c[10] * y) + c[11]) / c[12]
    sgn = torch.sign(c[12])
    assert bool(((e[0] * sgn >= 0) & (e[1] * sgn >= 0) & (e[2] * sgn >= 0)).all())
    assert bool((z.abs() <= 1).all())
    rlo, rhi, clo, chi = cover_ranges(rows.transpose(1, 2), res, pad)
    assert bool(((rlo <= pixel[0]) & (pixel[0] <= rhi)).all())
    assert bool(((clo <= pixel[1]) & (pixel[1] <= chi)).all())
    assert bool(((rhi - rlo < 64) & (chi - clo < 64)).all())
    # the vertex bounds of a packed row miss it
    packed = torch.zeros((1, 32, 1))
    for lane, value in SLIVER_LANES.items():
        packed[0, lane, 0] = value
    vlo, vhi, _, _ = slot_ranges(packed, res)
    assert not int(vlo) <= pixel[0] <= int(vhi)


def _walk_twin(rows, idx, counts, res, tile, gather):
    """The K8/K9 forward's walk in plain torch: per (tile, 16x16 sub-tile,
    hypothesis) the bin's entries whose box meets the sub-tile, in
    ascending order (the compacted stage), each tested at the sub-tile's
    pixels in the tile and inside its box by K8's arithmetic; a strictly
    smaller z wins.  Returns (ids, win, rows or None) over the padded
    frame and the count of (hypothesis, entry, sub-tile) stagings."""
    (th, tw), pad = tile, _padded(tile)
    nty, ntx = pad[0] // th, pad[1] // tw
    b, t_count, width = rows.shape
    k = idx.shape[1]
    rlo, rhi, clo, chi = cover_ranges(rows.transpose(1, 2), res, pad)
    ids = torch.zeros((b,) + pad, dtype=torch.int32)
    win = torch.full((b,) + pad, -1, dtype=torch.int32)
    out = torch.zeros((b, 32) + pad) if gather else None
    staged = 0
    for t in range(nty * ntx):
        n = min(int(counts[t]), k)
        tri = idx[t, :n].long()
        row = tri.clamp(max=t_count - 1)
        for sr in range(0, th, SUB):
            for sc in range(0, tw, SUB):
                r0, c0 = (t // ntx) * th + sr, (t % ntx) * tw + sc
                sh, sw = min(SUB, th - sr), min(SUB, tw - sc)
                pr = torch.arange(r0, r0 + sh)[:, None]
                pc = torch.arange(c0, c0 + sw)[None, :]
                x, y = ndc(pc, res[1]), ndc(pr, res[0])
                for bi in range(b):
                    meet = ((rlo[bi, row] <= rhi[bi, row]) & (rhi[bi, row] >= r0)
                            & (rlo[bi, row] <= r0 + sh - 1) & (clo[bi, row] <= chi[bi, row])
                            & (chi[bi, row] >= c0) & (clo[bi, row] <= c0 + sw - 1))
                    zb = torch.full((sh, sw), float("inf"))
                    kb = torch.full((sh, sw), -1, dtype=torch.long)
                    for j in torch.nonzero(meet).reshape(-1).tolist():
                        staged += 1
                        c = rows[bi, row[j]]
                        sg = 1.0 if float(c[12]) > 0 else -1.0
                        e = [(c[3 * m] * sg * x + c[3 * m + 1] * sg * y) + c[3 * m + 2] * sg
                             for m in range(3)]
                        z = ((c[9] * x + c[10] * y) + c[11]) / c[12]
                        box = ((pr >= rlo[bi, row[j]]) & (pr <= rhi[bi, row[j]])
                               & (pc >= clo[bi, row[j]]) & (pc <= chi[bi, row[j]]))
                        better = (box & (e[0] >= 0) & (e[1] >= 0) & (e[2] >= 0)
                                  & (z >= -1) & (z <= 1) & (z < zb))
                        zb = torch.where(better, z, zb)
                        kb = torch.where(better, j, kb)
                    fg = kb >= 0
                    kk = kb.clamp(min=0)
                    if gather:
                        ident = rows[bi, row[kk], 13].to(torch.int32) + 1
                    else:
                        ident = tri[kk].to(torch.int32) + 1 if n else kk.int()
                    ids[bi, r0:r0 + sh, c0:c0 + sw] = torch.where(fg, ident, 0)
                    win[bi, r0:r0 + sh, c0:c0 + sw] = torch.where(fg, t * k + kb, -1).int()
                    if gather:
                        out[bi, :, r0:r0 + sh, c0:c0 + sw] = torch.where(
                            fg, rows[bi, row[kk]].permute(2, 0, 1), 0.0)
    return ids, win, out, staged


@pytest.mark.parametrize("tile", TILES)
def test_torch_k8_walk_twin_gives_the_plain_forwards(tile):
    pos_clip, tri = (torch.tensor(a) for a in _clip())
    tri = tri.long()
    pad = _padded(tile)
    coef, idx, counts = raster_ids_inputs(pos_clip, tri, RES, tile)
    ids, _, _, staged = _walk_twin(coef, idx, counts, RES, tile, gather=False)
    want = raster_ids_binned_plain(coef, idx, counts, RES, tile)  # the frame, sliced
    assert int((want > 0).sum()) > 2000
    assert torch.equal(ids[:, :RES[0], :RES[1]], want)
    # the stage holds far fewer pairs than the TPU kernel tests
    tests, pairs = bin_box_tests(coef, idx, counts, RES, tile)
    # (pairs: 458,752 at (16, 32), whose two sub-tiles a triangle often
    # spans both of; 2,752,512 at (32, 128), where the stage holds ~1/10)
    assert staged * SUB * SUB < pairs / (8 if tile == (32, 128) else 1)
    assert 0 < tests < pairs / 8

    colors = torch.rand((int(tri.max()) + 1, 3), generator=torch.Generator().manual_seed(1))
    adj = torch.tensor(np.asarray(_scene()[5])).long()
    packed, idx, counts = gather_rows_inputs(pos_clip, tri, RES, tile, colors, adj)
    got = _walk_twin(packed, idx, counts, RES, tile, gather=True)
    want_ids, want_rows, want_win = gather_rows_fwd_plain(packed, idx, counts, RES, tile)
    assert torch.equal(got[0], want_ids) and torch.equal(got[1], want_win)
    assert torch.equal(got[2], want_rows)
    assert int((want_ids[:, RES[0]:] > 0).sum() + (want_ids[:, :, RES[1]:] > 0).sum()) > 0
