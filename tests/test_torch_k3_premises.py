"""The premise K3's and K7's forward rest on, on the CPU, on compact and
uniform tables made by both packages; and what the reference's compact
raster does with a sliver.

The K3/K7 forward (``csrc/raster.cu``) stages each slot of a tile with the
rows and columns its f32 edge planes can cover (``dd::cover_range``, over
the whole window; ``raster_v3.cover_ranges`` is the plain twin) and skips
every (pixel, slot) test outside them.  Held here:

- every pixel of a slot's tile that the slot can win by K3's arithmetic
  (covered, det != 0, |z| <= 1), the padding past the frame's edge
  included, lies inside the slot's box, on the compact and the uniform
  table of the port's ``planar`` functions and of the JAX package's; the
  vertex bounds of lanes 28-31 (``raster.slot_ranges``, by which K3 staged
  before) miss some of those pixels in the padding;
- at the sliver of ``testing.SLIVER_LANES`` the plain twins of K3 (a
  compact window) and K7 (the frame's uniform table), K8 and K9 cover the
  pixel its planes cover, 8 rows past its vertex bounds, inside its box;
- the reference's compact raster (``raster_v2._fwd_from_bins_compact``,
  interpret mode) gates whole chunks by those vertex bounds: it drops that
  pixel when the sliver's chunk holds no slot that widens the chunk's rows
  past it, and covers it when one does (a reference caveat; the port
  follows its plain twins, which test every pair).

The scene is ``tests/test_torch_k10_premises.py``'s: icosphere(2) across
the bottom and right edges of a 60x90 frame (padded to 64x96 at 16x16
tiles), a triangle with a corner behind the camera, degenerate padding
triangles, B = 2 poses 1% apart.
"""

import functools

import numpy as np
import pytest
import torch

from test_torch_k10_premises import PAD, RES, T_PAD, TILE, _scene, _tests

from diffdope_tpu_torch.kernels.check import check_sliver
from diffdope_tpu_torch.render import raster as tr
from diffdope_tpu_torch.render.raster import slot_ranges
from diffdope_tpu_torch.render.raster_v3 import cover_ranges
from diffdope_tpu_torch.testing import SLIVER_FRAME, SLIVER_PIXEL, sliver_rows
from torch_scene import one_torch_thread  # noqa: F401

K_CHUNK = 32
TOTAL = 2048  # compact slots, a multiple of K_CHUNK past the scene's need


@functools.lru_cache(maxsize=None)
def _tables(source: str):
    """{layout: (table (B, 32, n), the tile of each slot (n,), -1 none)}:
    the compact and the uniform table of the scene, binned at the port's
    16x16 tile, by the port's planar functions or the JAX package's."""
    pos_c, fc, mvp, mtx, degen, adj, colors = _scene()
    if source == "port":
        from diffdope_tpu_torch.render import planar

        cp = planar.corner_planes(torch.tensor(pos_c), torch.tensor(mvp))
        det = planar.det_planar(cp, torch.tensor(degen))
        idx, counts, ovf = planar.bin_triangles_planar(cp, det, RES, TILE, T_PAD)
        flat, off_c, used, c_ovf = planar.compact_bins(idx, counts, T_PAD, K_CHUNK, TOTAL)
        sil = planar._silhouette_planar(det, torch.tensor(adj).long())

        def pack(slots):
            return planar.pack_binned(torch.tensor(pos_c), torch.tensor(mvp),
                                      torch.tensor(mtx), slots, torch.tensor(colors), sil,
                                      torch.tensor(degen), T_PAD)
    else:
        import jax.numpy as jnp

        from diffdope_tpu.render import planar

        cp = planar.corner_planes(jnp.asarray(pos_c), jnp.asarray(mvp))
        det = planar.det_planar(cp, jnp.asarray(degen))
        idx, counts, ovf = planar.bin_triangles_planar(cp, det, RES, TILE, T_PAD)
        flat, off_c, used, c_ovf = planar.compact_bins(idx, counts, T_PAD, K_CHUNK, TOTAL)
        sil = planar._silhouette_planar(det, jnp.asarray(adj))

        def pack(slots):
            return torch.tensor(np.asarray(planar.pack_binned(
                jnp.asarray(pos_c), jnp.asarray(mvp), jnp.asarray(mtx), slots,
                jnp.asarray(colors), sil, jnp.asarray(degen), T_PAD)))
    assert int(ovf) == 0 and int(c_ovf) == 0
    counts, off_c, used = (torch.tensor(np.asarray(a)).long() for a in (counts, off_c, used))
    nt, k = np.asarray(idx).shape
    # compact: tile t holds [off_c*K_CHUNK, off_c*K_CHUNK + min(counts, used*K_CHUNK))
    n = torch.minimum(counts, used * K_CHUNK)
    j = torch.arange(int(n.max()))
    held = j[None, :] < n[:, None]
    tile_c = torch.full((TOTAL,), -1, dtype=torch.long)
    tile_c[(off_c[:, None] * K_CHUNK + j[None, :])[held]] = torch.arange(nt)[:, None].expand(
        -1, j.numel())[held]
    # uniform: tile t holds [t*K, t*K + min(counts, K))
    j = torch.arange(k)
    held = j[None, :] < counts.clamp(max=k)[:, None]
    tile_u = torch.where(held, torch.arange(nt)[:, None], -1).reshape(-1)
    return {"compact": (pack(flat), tile_c), "uniform": (pack(idx), tile_u)}


@pytest.mark.parametrize("layout", ["compact", "uniform"])
@pytest.mark.parametrize("source", ["port", "reference"])
def test_torch_k3_boxes_hold_every_pixel_a_slot_can_win_in_its_tile(source, layout):
    table, tile_of = _tables(source)[layout]
    slots = torch.nonzero(tile_of >= 0).reshape(-1)
    table, t = table[:, :, slots], tile_of[slots]
    can_win, _ = _tests(table)  # (B, n, Hp, Wp), the padded frame
    ntx = PAD[1] // TILE[1]
    rows = torch.arange(PAD[0])[None, :, None]
    cols = torch.arange(PAD[1])[None, None, :]
    r0, c0 = ((t // ntx) * TILE[0])[:, None, None], ((t % ntx) * TILE[1])[:, None, None]
    in_tile = (rows >= r0) & (rows < r0 + TILE[0]) & (cols >= c0) & (cols < c0 + TILE[1])
    can_win = can_win & in_tile[None]

    def inside(ranges):
        rlo, rhi, clo, chi = (v[..., None, None] for v in ranges)
        return (rows >= rlo) & (rows <= rhi) & (cols >= clo) & (cols <= chi)

    assert int(can_win.sum()) > 2000
    assert not bool((can_win & ~inside(cover_ranges(table, RES, PAD))).any())
    # the padding holds pixels the slots can win, some of them outside the
    # vertex bounds, which stop at the frame's edge
    assert int(can_win[..., RES[0]:, :].sum() + can_win[..., RES[1]:].sum()) > 0
    assert int((can_win & ~inside(slot_ranges(table, RES))).sum()) > 0


def test_torch_k3_plain_twins_cover_a_slivers_pixel_inside_its_box():
    rows = check_sliver("cpu")
    assert [r["name"] for r in rows] == ["K3_raster_fwd", "K7_raster_uniform_fwd",
                                         "K8_raster_ids", "K9_gather_rows_fwd"]
    assert all(r["ok"] for r in rows), rows
    table = torch.tensor(sliver_rows(2))[:, :, None]  # (2, 32, 1)
    py, px = SLIVER_PIXEL
    rlo, rhi, clo, chi = cover_ranges(table, SLIVER_FRAME, (544, 960))
    assert bool(((rlo <= py) & (py <= rhi) & (clo <= px) & (px <= chi)).all())
    vlo, vhi, _, _ = slot_ranges(table, SLIVER_FRAME)
    assert not bool(((vlo <= py) & (py <= vhi)).any())


@pytest.mark.parametrize("widened", [False, True], ids=["alone", "widened"])
def test_torch_reference_compact_raster_gates_a_sliver_by_its_chunk(widened):
    """The sliver alone in its 128-slot chunk (the other slots degenerate,
    their vertex bounds empty): the reference's compact raster drops the
    pixel its planes cover.  With a second, live slot in the chunk whose
    vertex bounds reach past that row (a copy of the sliver whose first
    plane is negative over the window, so it covers nothing), the chunk's
    rows widen and the pixel is the sliver's.  The port's plain twin
    covers it in both."""
    import jax.numpy as jnp

    from diffdope_tpu.render.raster_v2 import _fwd_from_bins_compact

    (h, w), (py, px) = SLIVER_FRAME, SLIVER_PIXEL
    table = np.zeros((1, 32, 128), np.float32)
    table[0, :, 0] = sliver_rows(1)[0]
    table[0, 28, 1:], table[0, 29, 1:] = 2.0, -2.0  # empty vertex bounds
    table[0, 30, 1:], table[0, 31, 1:] = 2.0, -2.0
    if widened:  # a live slot whose rows reach past the pixel's, covering nothing
        table[0, :, 1] = table[0, :, 0]
        table[0, 2, 1] -= 1.0  # its first plane negative over the window
        table[0, 30, 1], table[0, 31, 1] = -1.0, 1.0
        table[0, 13, 1] = 6.0
    oy, ox = (py // 32) * 32, (px // 128) * 128
    counts = np.zeros(1, np.int32) + (2 if widened else 1)
    zero, one = np.zeros(1, np.int32), np.ones(1, np.int32)
    _, ids, _, _ = _fwd_from_bins_compact(
        jnp.asarray(table), jnp.asarray(counts), jnp.asarray(zero), jnp.asarray(one),
        (32, 128), (32, 128), 1, True, roi=(oy, ox, h, w))
    ids = np.asarray(ids)[0]
    port, _, _ = tr.raster_fwd_plain(torch.tensor(table), torch.tensor(counts),
                                     torch.tensor(zero), torch.tensor(one), 128, (32, 128),
                                     (32, 128), (oy, ox, h, w))
    assert np.nonzero(port[0].numpy()) == (np.array([py - oy]), np.array([px - ox]))
    assert int(ids[py - oy, px - ox]) == (6 if widened else 0)
    assert int((ids > 0).sum()) == (1 if widened else 0)
