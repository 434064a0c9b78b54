"""Shared scene for the port's parity tests (tests/test_torch_*.py).

The JAX tests' small scene (tests/test_fused_loss.py:22-66): RES (64, 96),
B = 3 hypotheses, icosphere(2) with positional vertex colours, gt (rgb,
segmentation, depth) rendered by the JAX ``render_batch``.  Everything is
returned as numpy, the form in which state crosses between the two
packages.
"""

import functools

import numpy as np
import pytest
import torch

RES = (64, 96)
B = 3
LRS = np.asarray([1.0, 2.0, 0.5], np.float32)
WEIGHTS = {"rgb": 0.7, "depth": 1.0, "mask": 1.0}
#: the JAX compact table's tiles, capacity and per-tile bin size
JAX_TILE_HW = (32, 128)
#: the port's raster tile, at which the JAX uniform table is binned too
PORT_TILE_HW = (16, 16)
COMPACT_TOTAL = 1024
MAX_K = 512


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for a test module that imports this fixture by name:
    the tier-1 command runs six test workers on the CPU, and the plain
    twins' many small parallel regions ran up to 100x slower when every
    worker's threads oversubscribed it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def jax_scene():
    import jax
    import jax.numpy as jnp

    from diffdope_tpu import geometry as geo
    from diffdope_tpu.mesh import build_edge_adjacency
    from diffdope_tpu.optimize import pose_matrix, pose_params
    from diffdope_tpu.render.pipeline import render_batch
    from diffdope_tpu.testing import icosphere

    h, w = RES
    f = 1.2 * max(h, w)
    proj = np.asarray(
        geo.projection_from_intrinsics(f, f, w / 2, h / 2, w, h, 0.01, 100.0),
        np.float32,
    )
    v, fc = icosphere(2)
    pos = (v * 0.4).astype(np.float32)
    tri = fc.astype(np.int32)
    edge_adj = np.asarray(build_edge_adjacency(fc))
    vtx_color = (v * 0.5 + 0.5).astype(np.float32)

    q_gt = geo.quat_from_axis_angle(np.array([0.2, 1.0, 0.1]), 0.8)
    t_gt = np.array([0.0, 0.0, -2.0], np.float32)
    mtx_gt, _, _ = pose_matrix(pose_params(np.asarray(q_gt, np.float32), t_gt, 1))
    gt_r = jax.jit(
        lambda m: render_batch(
            proj, m, pos, tri, RES, vtx_color=vtx_color, edge_adj=edge_adj,
            raster_impl="pallas", layout="stacked", max_tris_per_tile=MAX_K,
        )
    )(mtx_gt)
    gt = {
        "rgb": np.asarray(gt_r["rgb"][0]),
        "segmentation": np.asarray(gt_r["mask"][0]),
        "depth": np.asarray(gt_r["depth"][0]),
    }
    dq = geo.quat_from_axis_angle(np.array([0.5, -0.2, 0.9]), np.deg2rad(10.0))
    q0 = np.asarray(geo.quat_multiply(jnp.asarray(dq), jnp.asarray(q_gt)), np.float32)
    t0 = t_gt + np.array([0.03, -0.02, 0.05], np.float32)
    params0 = pose_params(q0, t0, B)
    params0 = {k: np.asarray(val + jnp.arange(B) * 0.01) for k, val in params0.items()}
    mtx0 = np.asarray(pose_matrix({k: jnp.asarray(v) for k, v in params0.items()})[0])
    return dict(
        proj=proj, pos=pos, tri=tri, edge_adj=edge_adj, vtx_color=vtx_color,
        gt=gt, params0=params0, mtx0=mtx0,
    )


@functools.lru_cache(maxsize=None)
def jax_compact_table():
    """The JAX compact table and its raster at the scene's initial poses
    (``pipeline.make_fused_loss`` steps without the crop, interpret mode):
    every intermediate as numpy."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.planar import (
        _silhouette_planar,
        bin_triangles_planar,
        compact_bins,
        corner_planes,
        det_planar,
        pack_binned,
    )
    from diffdope_tpu.render.raster_v2 import _fwd_from_bins_compact, _pick_chunk

    sc = jax_scene()
    tri = sc["tri"]
    t_count = tri.shape[0]
    kc = _pick_chunk(COMPACT_TOTAL)
    degenerate = np.zeros((t_count,), bool)

    @jax.jit
    def run(mtx):
        mvp = jnp.einsum("ij,bjk->bik", sc["proj"], mtx, precision="highest")
        pos_c = sc["pos"][tri.reshape(-1)]
        cp = corner_planes(pos_c, mvp)
        det = det_planar(cp, degenerate)
        idx, counts, ovf = bin_triangles_planar(cp, det, RES, JAX_TILE_HW, MAX_K)
        sil = _silhouette_planar(det, sc["edge_adj"])
        flat, off_c, used, c_ovf = compact_bins(idx, counts, t_count, kc, COMPACT_TOTAL)
        attrs = sc["vtx_color"][tri.reshape(-1)].reshape(t_count, 3, 3)
        packed = pack_binned(pos_c, mvp, mtx, flat, attrs, sil, degenerate, t_count)
        ids_cm, idpix, rows, bounds = _fwd_from_bins_compact(
            packed, counts, off_c, used, RES, JAX_TILE_HW, idx.shape[1] // kc, True
        )
        return dict(mvp=mvp, det=det, idx=idx, counts=counts, overflow=ovf + c_ovf,
                    sil=sil, flat=flat, off_c=off_c, used=used, packed=packed,
                    ids_cm=ids_cm, ids=idpix, rows=rows, bounds=bounds)

    out = {k: np.asarray(v) for k, v in run(jnp.asarray(sc["mtx0"])).items()}
    out["k_chunk"] = kc
    return out


@functools.lru_cache(maxsize=None)
def jax_uniform_table():
    """The JAX uniform-K table at the port's 16x16 tile and its raster
    (``raster_gather_rows_binned``, interpret mode) at the scene's initial
    poses, as numpy, with the corner planes and determinants it was binned
    from."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.planar import (
        _silhouette_planar,
        bin_triangles_planar,
        corner_planes,
        det_planar,
        pack_binned,
    )
    from diffdope_tpu.render.raster_v2 import raster_gather_rows_binned

    sc = jax_scene()
    tri = sc["tri"]
    t_count = tri.shape[0]
    degenerate = np.zeros((t_count,), bool)

    def table(mtx):
        mvp = jnp.einsum("ij,bjk->bik", sc["proj"], mtx, precision="highest")
        pos_c = sc["pos"][tri.reshape(-1)]
        cp = corner_planes(pos_c, mvp)
        det = det_planar(cp, degenerate)
        idx, counts, ovf = bin_triangles_planar(cp, det, RES, PORT_TILE_HW, MAX_K)
        sil = _silhouette_planar(det, sc["edge_adj"])
        attrs = sc["vtx_color"][tri.reshape(-1)].reshape(t_count, 3, 3)
        packed = pack_binned(pos_c, mvp, mtx, idx, attrs, sil, degenerate, t_count)
        return dict(cp=cp, det=det, idx=idx, counts=counts, overflow=ovf,
                    packed=packed)

    out = jax.jit(table)(jnp.asarray(sc["mtx0"]))
    ids, rows = jax.jit(lambda p, c: raster_gather_rows_binned(p, c, RES, PORT_TILE_HW, True))(
        out["packed"], out["counts"])
    out = {k: np.asarray(v) if not isinstance(v, dict)
           else {n: np.asarray(p) for n, p in v.items()} for k, v in out.items()}
    out["ids"], out["rows"] = np.asarray(ids), np.asarray(rows)
    return out


def jax_fused_loss(monkeypatch, use_depth=False, compact_total=COMPACT_TOTAL,
                   drows_bf16=False):
    """The JAX fused loss in the port's configuration: the compact table
    (``compact_total`` None: the uniform-K table), spanning op, pack in
    plain XLA (DD_PACK=xla), f32 d_rows (bf16 with ``drows_bf16``, the
    reference's default).

    The reference reads DD_PACK when the loss is traced, so ``monkeypatch``
    must stay in force until the caller's jit has traced it; while it is,
    reaching the Pallas pack raises."""
    from diffdope_tpu.render import pack_kernel
    from diffdope_tpu.render.pipeline import make_fused_loss

    def no_pallas_pack(*args, **kwargs):
        raise AssertionError("the slice's reference packs in XLA (DD_PACK=xla)")

    monkeypatch.setenv("DD_DROWS_BF16", "1" if drows_bf16 else "0")
    monkeypatch.setenv("DD_PACK", "xla")
    monkeypatch.setattr(pack_kernel, "pack_binned_auto", no_pallas_pack)
    sc = jax_scene()
    return make_fused_loss(
        sc["proj"], sc["pos"], sc["tri"], RES, sc["gt"], LRS, WEIGHTS,
        use_rgb=True, use_depth=use_depth, use_mask=True, edge_adj=sc["edge_adj"],
        vtx_color=sc["vtx_color"], max_tris_per_tile=MAX_K,
        compact_total=compact_total,
    )


def port_fused_loss(device="cpu", use_depth=False, uniform=False, drows_bf16=False,
                    use_rgb=True):
    """The port's fused loss on the same scene, its state carried across
    by ``convert.state``; compact capacity twice the probe's, or the
    uniform-K table; the spanning op's d_rows in f32 (the contract's
    DD_DROWS_BF16=0 reference, :func:`jax_fused_loss`'s default) unless
    ``drows_bf16``; ``use_rgb`` False for the mask (and depth) terms
    only."""
    from diffdope_tpu_torch import convert
    from diffdope_tpu_torch.bench import drows_env
    from diffdope_tpu_torch.render.pipeline import compact_capacity, make_fused_loss

    sc = convert.state(jax_scene(), device)
    total = None if uniform else 2 * compact_capacity(
        sc["proj"], sc["pos"], sc["tri"], sc["mtx0"], RES, device=device)
    with drows_env(drows_bf16):
        return make_fused_loss(
            sc["proj"], sc["pos"], sc["tri"], RES, sc["gt"], LRS, WEIGHTS,
            use_rgb=use_rgb, use_depth=use_depth, use_mask=True, edge_adj=sc["edge_adj"],
            vtx_color=sc["vtx_color"], compact_total=total, device=device,
        )


def random_clip_scene(seed=42, n_tri=40, batch=2, behind=False):
    """Clip positions (batch, 3*n_tri, 4) and triangles (n_tri, 3) of small
    triangles across the screen with varied depth (w > 0), as in
    tests/test_rasterize.py, the hypotheses 1% apart; triangle 5 repeats an
    index (degenerate); ``behind`` puts a corner of triangle 7 behind the
    camera (w < 0).  For the API ops' parity tests."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-0.9, 0.9, size=(n_tri, 1, 2))
    offs = rng.uniform(-0.25, 0.25, size=(n_tri, 3, 2))
    v2d = (base + offs).reshape(-1, 2)
    z = rng.uniform(-0.8, 0.8, size=(3 * n_tri,))
    w = rng.uniform(0.5, 2.0, size=(3 * n_tri,))
    if behind:
        w[21] = -0.7
    pos = np.stack([v2d[:, 0] * w, v2d[:, 1] * w, z * w, w], axis=1)[None]
    pos = np.concatenate([pos * (1.0 + 0.01 * i) for i in range(batch)], axis=0)
    tri = np.arange(3 * n_tri, dtype=np.int32).reshape(n_tri, 3)
    tri[5] = [15, 15, 16]
    return pos.astype(np.float32), tri


#: the environment of each planar route, in both packages
ROUTES = {"v3": {"DD_RASTER": "v3"}, "v2": {"DD_BINNED": "0"}}


def set_route(mp, route):
    for name in ("DD_RASTER", "DD_BINNED"):
        mp.delenv(name, raising=False)
    for name, value in ROUTES[route].items():
        mp.setenv(name, value)


def planar_capture(mp, route, store):
    """Record (in ``store``) the planar table each reference raster call
    consumes, under ``jax.jit`` too."""
    import jax

    from diffdope_tpu.render import raster_v2, raster_v3

    module, name = ((raster_v3, "raster_gather_rows_v3") if route == "v3"
                    else (raster_v2, "raster_gather_rows_v2"))
    own = getattr(module, name)

    def wrapped(packed, *args, **kwargs):
        jax.debug.callback(lambda p: store.append(np.asarray(p)), packed)
        return own(packed, *args, **kwargs)

    mp.setattr(module, name, wrapped)


def feed_planar_table(mp, table):
    """Make the port's planar pack return ``table``'s values, its own
    autograd carrying the gradient (value + (ref - value).detach())."""
    import torch

    from diffdope_tpu_torch.render import pipeline

    own = pipeline._planar_pack

    def pack(mesh, mtx):
        packed, cp, det = own(mesh, mtx)
        ref = torch.tensor(table)
        assert ref.shape == packed.shape
        np.testing.assert_allclose(packed.detach().numpy(), table, rtol=1e-4, atol=1e-4)
        return packed + (ref - packed).detach(), cp, det

    mp.setattr(pipeline, "_planar_pack", pack)


def scene_texture(quantized=True, seed=3, size=32):
    """The texture tests' colouring of the scene's sphere: spherical uv
    (``testing.spherical_uv``, the JAX tests' formula), the faces as
    uv_idx, and a ``size``-square texture, 8-bit quantized (the packed
    sampler's) or not (the f32 sampler's)."""
    from diffdope_tpu_torch.testing import quantize8, spherical_uv

    sc = jax_scene()
    tex = np.random.default_rng(seed).uniform(0.1, 0.9, (size, size, 3)).astype(np.float32)
    return dict(tex=quantize8(tex) if quantized else tex, uv=spherical_uv(sc["pos"]),
                uv_idx=sc["tri"])


@functools.lru_cache(maxsize=None)
def jax_texture_table():
    """The JAX compact table of the scene textured (uv corners, n_ch 2),
    its raster at the scene's initial poses (interpret mode), as numpy."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.planar import (
        _silhouette_planar,
        bin_triangles_planar,
        compact_bins,
        corner_planes,
        det_planar,
        pack_binned,
    )
    from diffdope_tpu.render.raster_v2 import _fwd_from_bins_compact, _pick_chunk

    sc, tx = jax_scene(), scene_texture()
    tri = sc["tri"]
    t_count = tri.shape[0]
    kc = _pick_chunk(COMPACT_TOTAL)
    degenerate = np.zeros((t_count,), bool)

    @jax.jit
    def run(mtx):
        mvp = jnp.einsum("ij,bjk->bik", sc["proj"], mtx, precision="highest")
        pos_c = sc["pos"][tri.reshape(-1)]
        cp = corner_planes(pos_c, mvp)
        det = det_planar(cp, degenerate)
        idx, counts, _ = bin_triangles_planar(cp, det, RES, JAX_TILE_HW, MAX_K)
        sil = _silhouette_planar(det, sc["edge_adj"])
        flat, off_c, used, _ = compact_bins(idx, counts, t_count, kc, COMPACT_TOTAL)
        attrs = tx["uv"][tx["uv_idx"].reshape(-1)].reshape(t_count, 3, 2)
        packed = pack_binned(pos_c, mvp, mtx, flat, attrs, sil, degenerate, t_count)
        _, ids, rows, _ = _fwd_from_bins_compact(
            packed, counts, off_c, used, RES, JAX_TILE_HW, idx.shape[1] // kc, True)
        return dict(ids=ids, rows=rows)

    return {k: np.asarray(v) for k, v in run(jnp.asarray(sc["mtx0"])).items()}


def jax_fused_texture_loss(monkeypatch, tex, use_depth=False):
    """The JAX exact-texture fused loss on the scene (compact table, XLA
    pack, f32 d_rows), as :func:`jax_fused_loss` builds the colour one."""
    from diffdope_tpu.render import pack_kernel
    from diffdope_tpu.render.pipeline import make_fused_loss

    monkeypatch.setenv("DD_DROWS_BF16", "0")
    monkeypatch.setenv("DD_PACK", "xla")
    monkeypatch.setattr(pack_kernel, "pack_binned_auto", None)
    sc, tx = jax_scene(), scene_texture()
    return make_fused_loss(
        sc["proj"], sc["pos"], sc["tri"], RES, sc["gt"], LRS, WEIGHTS,
        use_rgb=True, use_depth=use_depth, use_mask=True, edge_adj=sc["edge_adj"],
        tex=tex, uv=tx["uv"], uv_idx=tx["uv_idx"], max_tris_per_tile=MAX_K,
        compact_total=COMPACT_TOTAL,
    )


def port_fused_texture_loss(tex, use_depth=False, device="cpu"):
    """The port's exact-texture fused loss on the same scene (compact
    capacity twice the probe's)."""
    from diffdope_tpu_torch import convert
    from diffdope_tpu_torch.render.pipeline import compact_capacity, make_fused_loss

    sc, tx = convert.state(jax_scene(), device), scene_texture()
    total = 2 * compact_capacity(sc["proj"], sc["pos"], sc["tri"], sc["mtx0"], RES,
                                 device=device)
    return make_fused_loss(
        sc["proj"], sc["pos"], sc["tri"], RES, sc["gt"], LRS, WEIGHTS,
        use_rgb=True, use_depth=use_depth, use_mask=True, edge_adj=sc["edge_adj"],
        tex=tex, uv=tx["uv"], uv_idx=tx["uv_idx"], compact_total=total, device=device,
    )


def feed_reference_pack(monkeypatch):
    """Make the port's bin-ordered pack return the reference's Pallas pack
    of the same slots (value + (ref - value).detach(), so the port's own
    pack autograd carries the gradient): XLA's CPU fusions contract the
    pack's multiply-adds into FMAs, which puts the two tables ~1e-6 apart
    and flips the z winner of a silhouette pixel now and then."""
    import jax.numpy as jnp
    import torch

    from diffdope_tpu.render.pack_kernel import pack_binned_auto as j_pack
    from diffdope_tpu_torch.render import pipeline

    own = pipeline._pack_dispatch

    def dispatch(mesh, mvp, mtx, flat, sil, *order):
        packed = own(mesh, mvp, mtx, flat, sil, *order)
        ref = j_pack(*(jnp.asarray(a.detach().numpy()) for a in (
            mesh.pos_c, mvp, mtx, flat, mesh.attrs, sil, mesh.degenerate)),
            mesh.t_count, interpret=True)
        ref = torch.tensor(np.asarray(ref))
        swapped = packed + (ref - packed).detach()
        assert torch.equal(swapped, ref)
        return swapped

    monkeypatch.setattr(pipeline, "_pack_dispatch", dispatch)


def jax_jitter_draws(key, b, deg, trans):
    """The draws of the reference's ``jitter_pose_params(params, key, deg,
    trans)``, as numpy (``optimize.py:99-114``)."""
    import jax
    import jax.numpy as jnp

    k_ax, k_ang, k_dir, k_mag = jax.random.split(jnp.asarray(key), 4)
    return {
        "axis": np.asarray(jax.random.normal(k_ax, (b, 3), jnp.float32)),
        "angle": np.asarray(jax.random.uniform(k_ang, (b,), jnp.float32, 0.0,
                                               float(np.deg2rad(deg)))),
        "direction": np.asarray(jax.random.normal(k_dir, (b, 3), jnp.float32)),
        "magnitude": np.asarray(jax.random.uniform(k_mag, (b,), jnp.float32, 0.0,
                                                   float(trans))),
    }
