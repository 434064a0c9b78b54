"""The premises K9's backward rests on, on the CPU, in both packages.

The backward (``csrc/rasterize.cu``) runs one block per (tile,
hypothesis): it sorts the tile's foreground pixels by (winner slot,
pixel), sums each won slot's run of d_rows from +0 in ascending pixel
order, and writes every other slot of the tile's K-wide bin as +0.  The
reference's ``_bwd_kernel`` (``diffdope_tpu/render/gather_rows.py:191``)
instead sums, per slot below the tile's count, the one-hot product of the
slot's triangle id (lane 13) with the winning ids.  The two agree when:

(a) every foreground pixel's winner slot ``win`` from the port's plain
    forward lies in its own tile's held range ``[t*K, t*K + count_t)`` and
    names the triangle the pixel's id names, and a tile's held slots carry
    distinct triangle ids, so the one-hot over ids is the one-hot over
    slots; then ``gather_rows_bwd_plain``'s d_bin equals the reference's
    slot for slot (rtol 2e-4, atol 1e-6 plus 1e-6 of the slot's sum of
    |d_rows|: the reference adds the pixels row by row in split-bf16 dots,
    the port in pixel order);
(b) the reference's d_bin is +0 at every slot past a tile's count and in
    every empty tile, and so is the port's;
(c) on a frame with padding, empty tiles and a tile whose count is K
    exactly, as well as on the reference tests' scenes
    (``tests/test_gather_rows.py:_setup_scene``: random clip-space triangles
    over a 32x128 frame, 8x128 tiles, K = 64; one and two poses).

The reference's d_bin is its ``_bwd_kernel`` in interpret mode, launched
as ``_vjp_bwd`` launches it; both packages run their own forward on the
same packed rows and bins.
"""

import functools

import numpy as np
import pytest
import torch

from diffdope_tpu_torch.render import gather_rows as port
from torch_scene import one_torch_thread  # noqa: F401

SCENES = ["seed0", "seed1_two_poses", "empty_tiles_full_tile"]


def _reference_d_bin(packed, idx, counts, ids, d_rows, res, tile):
    """d_bin (B, tiles, K, 32) of the reference's ``_bwd_kernel`` in
    interpret mode, launched as ``_vjp_bwd`` does
    (``diffdope_tpu/render/gather_rows.py:336-383``), at the cropped ids
    (B, H, W) and d_rows (B, 32, H, W)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    from diffdope_tpu.render.gather_rows import _bwd_kernel

    b, t_count, width = packed.shape
    (h, w), (th, tw) = res, tile
    nty, ntx = -(-h // th), -(-w // tw)
    num_tiles, k = idx.shape
    d_rows_p = jnp.pad(d_rows, ((0, 0), (0, 0), (0, nty * th - h), (0, ntx * tw - w)))
    ids_p = jnp.pad(ids, ((0, 0), (0, nty * th - h), (0, ntx * tw - w)))
    bin_rows = packed[:, jnp.minimum(idx, t_count - 1)]
    kernel = functools.partial(_bwd_kernel, th=th, tw=tw, k_chunk=min(128, k))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(b, num_tiles),
        in_specs=[
            pl.BlockSpec((1, th, tw), lambda bi, ti, c: (bi, ti // ntx, ti % ntx),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, k, width), lambda bi, ti, c: (bi, ti, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, width, th, tw), lambda bi, ti, c: (bi, 0, ti // ntx, ti % ntx),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, 1, k, width), lambda bi, ti, c: (bi, ti, 0, 0),
                               memory_space=pltpu.VMEM),
    )
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((b, num_tiles, k, width), jnp.float32),
        grid_spec=grid_spec, interpret=True,
    )(counts, ids_p, bin_rows, d_rows_p))


def _empty_tiles_full_tile():
    """(pos, tri, res, tile): a 60x250 frame padded to 64x256 by 8x128
    tiles; 128 small triangles inside the first tile (its count is K, 128,
    exactly: ``bin_triangles`` pads K to a multiple of 128) and 40 random
    ones in the left tiles below it; the right column of tiles and the
    bottom row hold nothing."""
    import jax.numpy as jnp

    from tests.test_rasterize import _random_scene, clip_verts

    rng = np.random.default_rng(7)
    res, tile = (60, 250), (8, 128)
    h, w = res
    py = rng.uniform(2.5, 5.5, (128, 1)) + rng.uniform(-1.5, 1.5, (128, 3))
    px = rng.uniform(5.0, 122.0, (128, 1)) + rng.uniform(-3.0, 3.0, (128, 3))
    small = clip_verts(np.stack([(2 * px + 1) / w - 1, (2 * py + 1) / h - 1], -1)
                       .reshape(-1, 2), z=rng.uniform(-0.8, 0.8, 3 * 128))
    spread, _ = _random_scene(rng, n_tri=40, spread=0.3)
    spread = np.array(spread)
    spread[..., 0] -= 0.55 * spread[..., 3]  # NDC x, y shifted to (-0.55, -0.15)
    spread[..., 1] -= 0.15 * spread[..., 3]
    pos = jnp.concatenate([small, jnp.asarray(spread)], axis=1)
    tri = jnp.arange(pos.shape[1], dtype=jnp.int32).reshape(-1, 3)
    return pos, tri, res, tile


@functools.lru_cache(maxsize=None)
def _case(name):
    """Both packages' forward and the two d_bins on one scene, as numpy:
    dict of ids, win (the port's), idx, counts, lane13 (B, T), the port's
    and the reference's d_bin, the d_bin of |d_rows| (the sums' scale)."""
    import jax.numpy as jnp

    from diffdope_tpu.render.gather_rows import invert_bins, raster_gather_rows
    from diffdope_tpu.render.setup_tris import bin_triangles, triangle_setup
    from diffdope_tpu.render.shade import pack_rows, silhouette_bits
    from tests.test_gather_rows import RES, TILE, _setup_scene

    if name == "empty_tiles_full_tile":
        pos, tri, res, tile = _empty_tiles_full_tile()
        setup = triangle_setup(pos, tri)
        idx, counts, overflow = bin_triangles(pos[:, tri], setup.det, res, tile, 128)
        assert int(overflow) == 0
        packed = pack_rows(setup, silhouette_bits(setup.det, None),
                           jnp.zeros(setup.det.shape + (4, 3)))
    else:
        seed, b_extra = (0, False) if name == "seed0" else (1, True)
        _, tri, _, packed, idx, counts, _, _ = _setup_scene(seed=seed, b_extra=b_extra)
        res, tile = RES, TILE
    t_count = tri.shape[0]
    ids_ref, _ = raster_gather_rows(packed, idx, counts, *invert_bins(idx, t_count), res,
                                    tile, True)
    packed_np, idx_np = np.asarray(packed), np.asarray(idx, np.int32)
    counts_np = np.asarray(counts, np.int32)
    ids, _, win = port.gather_rows_fwd_plain(torch.tensor(packed_np), torch.tensor(idx_np),
                                             torch.tensor(counts_np), res, tile)
    (h, w), (th, tw) = res, tile
    np.testing.assert_array_equal(ids[:, :h, :w].numpy(), np.asarray(ids_ref))
    b = packed_np.shape[0]
    hp, wp = win.shape[1:]
    rng = np.random.default_rng(11)
    d_rows = rng.normal(size=(b, 32, h, w)).astype(np.float32)
    d_rows_p = torch.nn.functional.pad(torch.tensor(d_rows), (0, wp - w, 0, hp - h))
    nt, k = idx_np.shape
    return dict(
        res=res, tile=tile, ids=ids.numpy(), win=win.numpy(), idx=idx_np,
        counts=counts_np, lane13=packed_np[..., 13],
        d_bin=port.gather_rows_bwd_plain(d_rows_p, win, nt, k).numpy(),
        scale=port.gather_rows_bwd_plain(d_rows_p.abs(), win, nt, k).numpy(),
        d_bin_ref=_reference_d_bin(packed, idx, counts, ids_ref, jnp.asarray(d_rows), res,
                                   tile))


def _tile_of_pixel(case):
    """(Hp, Wp) the tile index of each pixel of the padded frame."""
    (th, tw), (hp, wp) = case["tile"], case["win"].shape[1:]
    ntx = wp // tw
    rows, cols = np.meshgrid(np.arange(hp), np.arange(wp), indexing="ij")
    return (rows // th) * ntx + cols // tw


@pytest.mark.parametrize("name", SCENES)
def test_win_lies_in_its_tiles_held_range(name):
    """(a) A foreground pixel's winner slot is one its own tile holds, and
    the slot's triangle is the pixel's id; a background pixel has none."""
    c = _case(name)
    win, ids, k = c["win"], c["ids"], c["idx"].shape[1]
    fg = ids > 0
    assert fg.sum() > 100
    np.testing.assert_array_equal(win >= 0, fg)
    t = np.broadcast_to(_tile_of_pixel(c), win.shape)[fg]
    s = win[fg]
    assert np.all(s >= t * k) and np.all(s < t * k + c["counts"][t])
    tri = c["idx"].reshape(-1)[s]
    np.testing.assert_array_equal(tri + 1, ids[fg])
    b = np.broadcast_to(np.arange(win.shape[0])[:, None, None], win.shape)[fg]
    np.testing.assert_array_equal(c["lane13"][b, tri], tri)


@pytest.mark.parametrize("name", SCENES)
def test_held_slots_carry_distinct_ids(name):
    """(a) Within a tile, no two held slots carry one triangle id (lane 13,
    each hypothesis's): the one-hot over ids is the one-hot over slots."""
    c = _case(name)
    idx, counts = c["idx"], c["counts"]
    for t in range(idx.shape[0]):
        held = idx[t, :counts[t]]
        for lane13 in c["lane13"]:
            ids = lane13[held]
            assert len(np.unique(ids)) == len(ids), (t, ids)


@pytest.mark.parametrize("name", SCENES)
def test_d_bin_matches_reference_slot_for_slot(name):
    """(a) The port's per-slot sums equal the reference's per-id one-hot
    products at every slot of every tile."""
    c = _case(name)
    got, want, scale = c["d_bin"], c["d_bin_ref"], c["scale"]
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    assert np.all(np.abs(got - want) <= 1e-6 + 2e-4 * np.abs(want) + 1e-6 * scale)


@pytest.mark.parametrize("name", SCENES)
def test_d_bin_is_plus_zero_past_count_and_in_empty_tiles(name):
    """(b) Both packages' d_bin is +0, bit for bit, at every slot past its
    tile's count (every slot of an empty tile)."""
    c = _case(name)
    counts, k = c["counts"], c["idx"].shape[1]
    past = np.arange(k)[None, :] >= counts[:, None]  # (tiles, K)
    assert past.any()
    for d_bin in (c["d_bin"], c["d_bin_ref"]):
        bits = d_bin.view(np.int32)[:, past]
        assert np.all(bits == 0)
    if name == "empty_tiles_full_tile":  # (c)
        assert (counts == 0).sum() >= 8 and counts.max() == k
        assert np.all(c["d_bin_ref"].view(np.int32)[:, counts == 0] == 0)
