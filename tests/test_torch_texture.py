"""Port parity for texture sampling and the texture helpers: the port's
``render/texture.py`` against ``diffdope_tpu/render/texture.py`` on the
same numpy inputs (a 32x32 texture, uv over [-0.2, 1.2] so that every
boundary mode is exercised), and the mesh's texture helpers (the V flip at
load, ``bake_corner_colors``) against ``diffdope_tpu/mesh.py``.

Tolerances: samples rtol 1e-6 (the same f32 expressions), the mipmapped
modes' also atol 1e-7 (the pyramid's box filter may round its four-texel
mean, and log2 the level's fraction, an ulp apart: that moves a blend of
two levels by ~1e-8 where the zero boundary makes the sample small),
gradients in tex and uv rtol 1e-5, atol 1e-6 (the scatter-add of the
texture's gradient sums its taps in another order); the packed samplers
and the packed tables bit for bit."""

import importlib

import numpy as np
import pytest
import torch
from torch_scene import one_torch_thread  # noqa: F401

# the module (the package exports its ``texture`` op under the same name)
tt = importlib.import_module("diffdope_tpu_torch.render.texture")

FILTERS = ("nearest", "linear", "linear-mipmap-nearest", "linear-mipmap-linear")
BOUNDARIES = ("wrap", "clamp", "zero")
TEX_HW = (32, 32)
UV_SHAPE = (2, 8, 10)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    tex = rng.uniform(0.0, 1.0, TEX_HW + (3,)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, UV_SHAPE + (2,)).astype(np.float32)
    # screen-space uv derivatives spanning the pyramid's levels
    uv_da = (rng.uniform(-1.0, 1.0, UV_SHAPE + (4,))
             * 10.0 ** rng.uniform(-3.0, -0.5, UV_SHAPE + (1,))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, UV_SHAPE + (3,)).astype(np.float32)
    return tex, uv, uv_da, w


def _quantized(seed=1, hw=TEX_HW):
    t = np.random.default_rng(seed).uniform(0.0, 1.0, hw + (3,))
    return (np.round(t * 255).astype(np.uint8).astype(np.float32) / 255).astype(np.float32)


@pytest.mark.parametrize("boundary", BOUNDARIES)
@pytest.mark.parametrize("filter_mode", FILTERS)
def test_torch_texture_matches_reference(filter_mode, boundary):
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.texture import texture as j_texture

    tex, uv, uv_da, w = _inputs()

    def j_obj(t, u):
        out = j_texture(t, u, jnp.asarray(uv_da), filter_mode=filter_mode,
                        boundary_mode=boundary)
        return jnp.sum(out * w), out

    (_, j_out), (j_dt, j_du) = jax.value_and_grad(j_obj, argnums=(0, 1), has_aux=True)(
        jnp.asarray(tex), jnp.asarray(uv))
    t = torch.tensor(tex, requires_grad=True)
    u = torch.tensor(uv, requires_grad=True)
    out = tt.texture(t, u, torch.tensor(uv_da), filter_mode=filter_mode,
                     boundary_mode=boundary)
    # 'nearest' reads uv only through floor: no gradient reaches it
    dt, du = torch.autograd.grad((out * torch.tensor(w)).sum(), (t, u), allow_unused=True)
    du = torch.zeros_like(u) if du is None else du
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=1e-6,
                               atol=1e-7 if "mipmap" in filter_mode else 0)
    assert np.abs(np.asarray(j_dt)).max() > 0
    np.testing.assert_allclose(dt.numpy(), np.asarray(j_dt), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(du.numpy(), np.asarray(j_du), rtol=1e-5, atol=1e-6)


def test_torch_texture_batched_tex_and_pyramid():
    """A per-hypothesis (B, TH, TW, C) texture and a precomputed pyramid
    capped at two levels."""
    import jax.numpy as jnp

    from diffdope_tpu.render.texture import build_mip_pyramid as j_pyramid
    from diffdope_tpu.render.texture import texture as j_texture

    tex, uv, uv_da, _ = _inputs(2)
    tex_b = np.stack([tex, tex[::-1]])
    got = tt.texture(torch.tensor(tex_b), torch.tensor(uv), filter_mode="linear")
    want = j_texture(jnp.asarray(tex_b), jnp.asarray(uv), filter_mode="linear")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    mip = tt.build_mip_pyramid(torch.tensor(tex), max_level=2)
    j_mip = j_pyramid(jnp.asarray(tex), max_level=2)
    assert [tuple(m.shape) for m in mip] == [tuple(m.shape) for m in j_mip]
    for m, jm in zip(mip, j_mip):
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6, atol=0)
    got = tt.texture(torch.tensor(tex), torch.tensor(uv), torch.tensor(uv_da),
                     filter_mode="linear-mipmap-linear", mip=mip)
    want = j_texture(jnp.asarray(tex), jnp.asarray(uv), jnp.asarray(uv_da),
                     filter_mode="linear-mipmap-linear", mip=j_mip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="uv_da"):
        tt.texture(torch.tensor(tex), torch.tensor(uv), filter_mode="linear-mipmap-nearest")
    with pytest.raises(ValueError, match="filter_mode"):
        tt.texture(torch.tensor(tex), torch.tensor(uv), filter_mode="cubic")


@pytest.mark.parametrize("boundary", BOUNDARIES)
def test_torch_texture_planar_matches_reference(boundary):
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.texture import texture_planar as j_planar

    tex, uv, _, w = _inputs(3)
    u, v = uv[..., 0], uv[..., 1]

    def j_obj(t, uu, vv):
        out = j_planar(t, uu, vv, boundary)
        return sum(jnp.sum(o * w[..., c]) for c, o in enumerate(out)), out

    (_, j_out), grads = jax.value_and_grad(j_obj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v))
    leaves = [torch.tensor(a, requires_grad=True) for a in (tex, u, v)]
    out = tt.texture_planar(*leaves, boundary)
    got = torch.autograd.grad(
        sum((o * torch.tensor(w[..., c])).sum() for c, o in enumerate(out)), leaves)
    for c in range(3):
        np.testing.assert_allclose(out[c].detach().numpy(), np.asarray(j_out[c]),
                                   rtol=1e-6, atol=0)
    for g, jg in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-6)


def test_torch_pack_bilinear_blocks_bit_equal():
    from diffdope_tpu.render.texture import pack_bilinear_blocks as j_blocks
    from diffdope_tpu.render.texture import pack_bilinear_blocks4 as j_blocks4

    tex = _quantized(hw=(16, 24))
    for port, ref in ((tt.pack_bilinear_blocks, j_blocks),
                      (tt.pack_bilinear_blocks4, j_blocks4)):
        got, want = port(tex), np.asarray(ref(tex))
        assert got.dtype == np.uint32 and want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
        assert port(torch.tensor(tex)) is not None
        # not 8-bit, or not the wrap boundary: no table, as in the reference
        assert port(tex + 1e-3) is None and ref(tex + 1e-3) is None
        assert port(tex, "clamp") is None and ref(tex, "clamp") is None


def test_torch_packed_samplers_equal_planar_and_reference_vjp():
    """texture_planar_packed(4) sample an 8-bit texture bit for bit as
    texture_planar does; texture_planar_packed4's regather-free VJP equals
    the reference's on the same cotangent."""
    import jax
    import jax.numpy as jnp

    from diffdope_tpu.render.texture import texture_planar_packed4 as j_packed4

    tex = _quantized()
    _, uv, _, _ = _inputs(4)
    u, v = torch.tensor(uv[..., 0]), torch.tensor(uv[..., 1])
    th, tw, c = tex.shape
    planar = torch.stack(tt.texture_planar(torch.tensor(tex), u, v))
    table4 = tt.table_tensor(tt.pack_bilinear_blocks4(tex), "cpu")
    tables = tt.table_tensor(tt.pack_bilinear_blocks(tex), "cpu")
    assert torch.equal(torch.stack(tt.texture_planar_packed(tables, th, tw, u, v)), planar)
    uu, vv = u.clone().requires_grad_(True), v.clone().requires_grad_(True)
    out = tt.texture_planar_packed4(table4, uu, vv, th, tw, c)
    assert torch.equal(out.detach(), planar)

    d_out = np.random.default_rng(5).normal(size=out.shape).astype(np.float32)
    d_u, d_v = torch.autograd.grad(out, (uu, vv), torch.tensor(d_out))
    j_out, pull = jax.vjp(lambda a, b: j_packed4(jnp.asarray(tt.pack_bilinear_blocks4(tex)),
                                                  a, b, th, tw, c),
                          jnp.asarray(uv[..., 0]), jnp.asarray(uv[..., 1]))
    j_du, j_dv = pull(jnp.asarray(d_out))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(j_out))
    np.testing.assert_allclose(d_u.numpy(), np.asarray(j_du), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d_v.numpy(), np.asarray(j_dv), rtol=1e-6, atol=1e-6)


def test_torch_bake_corner_colors_and_v_flip():
    """The corner-colour bake equals the reference's, and a textured mesh
    built from arrays keeps the reference's load conventions: V flipped,
    faces rewound, padded, corner colours baked from the flipped uv."""
    from diffdope_tpu.mesh import bake_corner_colors as j_bake
    from diffdope_tpu.mesh import orient_faces_consistently as j_orient
    from diffdope_tpu.testing import icosphere
    from diffdope_tpu_torch.mesh import bake_corner_colors
    from diffdope_tpu_torch.testing import textured_mesh

    verts, faces = icosphere(1)
    rng = np.random.default_rng(6)
    uv = rng.uniform(0.0, 1.0, (len(verts), 2)).astype(np.float32)
    tex = _quantized(7, (16, 16))
    np.testing.assert_array_equal(bake_corner_colors(tex, uv, faces),
                                  j_bake(tex, uv, faces))

    mesh = textured_mesh(verts * 50.0, faces, uv, tex, scale=0.01)
    flipped = uv.copy()
    flipped[:, 1] = 1.0 - flipped[:, 1]
    want_faces, _ = j_orient(verts * np.float32(50.0) * np.float32(0.01), faces)
    n, t = len(verts), len(faces)
    assert mesh.pos.shape[0] % 8 == 0 and mesh.pos_idx.shape[0] % 8 == 0
    assert (mesh.num_vertices, mesh.num_triangles) == (n, t)
    np.testing.assert_array_equal(mesh.uv[:n], flipped)
    np.testing.assert_array_equal(mesh.pos_idx[:t], want_faces)
    np.testing.assert_array_equal(mesh.uv_idx, mesh.pos_idx)
    np.testing.assert_array_equal(mesh.corner_colors[:t],
                                  j_bake(tex, flipped, want_faces))
    assert mesh.vtx_color is None and mesh.has_textured_map and mesh.tex is tex
