"""The plain renderer and loss that decide ``correct``: plain PyTorch, no
kernel, no table, no crop.

A pose (B, 4, 4) projects the mesh's corners to clip space; each
triangle's homogeneous setup (Olano and Greer) gives its three edge planes,
its z/w plane and its determinant; each pixel takes the nearest triangle
whose three edge functions share the determinant's sign (a tie goes to
the smaller triangle index); the pixel's colour and z are the triangle's
perspective-correct interpolation of its corners'; the foreground mask is
antialiased along silhouette edges, nvdiffrast's analytic rule; the loss
terms are L1 means over the frame, per hypothesis.

Every expression keeps the f32 operation order that the configurations
state (edge functions (c0 x + c1 y) + c2 with IEEE divides, no
contraction), so ids and coverage match the program's bit for bit where
it is right.  ``dtype`` computes all of it in another type: the control
of each cell is this renderer in bfloat16.

The id search bins each triangle into the 16 x 16 pixel tiles its screen
box (widened by two pixels) touches and tests every (pixel, triangle)
pair of a tile: the same winner as testing every triangle at every pixel,
at the cost of the tiles' lists.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from portbench.reference.geometry import matmul44, xfm_points

_EPS = 1e-12
_TILE = 16
#: (pixel, triangle) pairs evaluated at once by the id search
_PAIRS_PER_BLOCK = 1 << 23


class Mesh:
    """A mesh's arrays as tensors: corner positions (3T, 3), corner colours
    (T, 3, 3), the degenerate triangles and the edge adjacency."""

    def __init__(self, pos, tri, colors, adj, device, dtype=torch.float32):
        self.dtype = dtype
        self.tri = torch.as_tensor(tri, device=device).long()
        self.t_count = self.tri.shape[0]
        pos = torch.as_tensor(pos, device=device).to(dtype)
        flat = self.tri.reshape(-1)
        self.pos_c = pos[flat]
        self.attrs = torch.as_tensor(colors, device=device).to(dtype)[flat].reshape(-1, 3, 3)
        t = self.tri
        self.degenerate = (t[:, 0] == t[:, 1]) | (t[:, 1] == t[:, 2]) | (t[:, 2] == t[:, 0])
        self.adj = None if adj is None else torch.as_tensor(adj, device=device).long()


def ndc(pix: torch.Tensor, frame: int, dtype) -> torch.Tensor:
    """(2 pix + 1) / frame - 1, the divide IEEE (a tensor divisor)."""
    v = 2.0 * pix.to(dtype) + 1.0
    return v / torch.full_like(v, float(frame)) - 1.0


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0]]


def setup(corners: torch.Tensor, degenerate: torch.Tensor) -> torch.Tensor:
    """(B, T, 3, 4) clip corners -> (B, T, 13) lanes: c0, c1, c2 (edge
    planes over (X, Y, 1)), zc (the z/w numerator plane), det; zero for a
    degenerate triangle."""
    a = [[corners[..., k, i] for i in (0, 1, 3)] for k in range(3)]
    z = [corners[..., k, 2] for k in range(3)]
    c0, c1, c2 = _cross(a[1], a[2]), _cross(a[2], a[0]), _cross(a[0], a[1])
    det = (c0[0] * a[0][0] + c0[1] * a[0][1]) + c0[2] * a[0][2]
    zc = [(z[0] * c0[i] + z[1] * c1[i]) + z[2] * c2[i] for i in range(3)]
    keep = (~degenerate).to(det.dtype).expand(det.shape)
    lanes = [x * keep for x in c0 + c1 + c2 + zc]
    det = torch.where(keep > 0, det, torch.zeros_like(det))
    return torch.stack(lanes + [det], dim=-1)


def _edges_z(c, x, y):
    """(covered and in depth range, z) of lanes ``c`` at NDC (x, y)."""
    e = [(c[3 * m] * x + c[3 * m + 1] * y) + c[3 * m + 2] for m in range(3)]
    zlin = (c[9] * x + c[10] * y) + c[11]
    det = c[12]
    sgn = torch.sign(det)
    nz = det != 0.0
    covered = (e[0] * sgn >= 0) & (e[1] * sgn >= 0) & (e[2] * sgn >= 0) & nz
    z = zlin / torch.where(nz, det, torch.ones_like(det))
    return covered & (z >= -1.0) & (z <= 1.0), z


@torch.no_grad()
def raster_ids(coef: torch.Tensor, corners: torch.Tensor, resolution: Tuple[int, int],
               keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W) int32 ids (+1, 0 = background) of setup lanes ``coef``
    (B, T, 13) with clip ``corners`` (B, T, 3, 4); ``keep`` (T,) drops the
    other triangles (a cull)."""
    b_count, t_count = coef.shape[:2]
    h, w = resolution
    nty, ntx = -(-h // _TILE), -(-w // _TILE)
    dev, dtype = coef.device, coef.dtype
    lanes_x = torch.arange(_TILE * _TILE, device=dev) % _TILE
    lanes_y = torch.arange(_TILE * _TILE, device=dev) // _TILE
    out = torch.zeros((b_count, nty * _TILE, ntx * _TILE), dtype=torch.int32, device=dev)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)
    for b in range(b_count):
        cw = corners[b, ..., 3].float()
        safe = torch.where(cw.abs() > 1e-9, cw, torch.full_like(cw, 1e-9))
        px = (corners[b, ..., 0].float() / safe + 1.0) * (w / 2.0) - 0.5
        py = (corners[b, ..., 1].float() / safe + 1.0) * (h / 2.0) - 0.5
        behind = (cw <= 1e-9).any(dim=-1)
        live = coef[b, :, 12] != 0
        if keep is not None:
            live = live & keep
        x0 = torch.where(behind, 0, torch.floor((px.amin(-1) - 2.0) / _TILE).clamp(0, ntx - 1))
        x1 = torch.where(behind, ntx - 1,
                         torch.floor((px.amax(-1) + 2.0) / _TILE).clamp(0, ntx - 1))
        y0 = torch.where(behind, 0, torch.floor((py.amin(-1) - 2.0) / _TILE).clamp(0, nty - 1))
        y1 = torch.where(behind, nty - 1,
                         torch.floor((py.amax(-1) + 2.0) / _TILE).clamp(0, nty - 1))
        onscreen = behind | ((px.amax(-1) >= -2.0) & (px.amin(-1) <= w + 1.0)
                             & (py.amax(-1) >= -2.0) & (py.amin(-1) <= h + 1.0))
        tris = torch.nonzero(live & onscreen).flatten()
        if tris.numel() == 0:
            continue
        nx = (x1 - x0 + 1).long()[tris]
        ny = (y1 - y0 + 1).long()[tris]
        per = nx * ny
        tri_of = torch.repeat_interleave(tris, per)
        first = torch.repeat_interleave(torch.cumsum(per, 0) - per, per)
        local = torch.arange(tri_of.numel(), device=dev) - first
        nxr = torch.repeat_interleave(nx, per)
        tile = ((y0.long()[tri_of] + local // nxr) * ntx + x0.long()[tri_of] + local % nxr)
        order = torch.argsort(tile * t_count + tri_of)
        tile, tri_of = tile[order], tri_of[order]
        tiles, counts = torch.unique_consecutive(tile, return_counts=True)
        starts = torch.cumsum(counts, 0) - counts
        k_max = int(counts.max())
        slot = torch.arange(tile.numel(), device=dev) - torch.repeat_interleave(starts, counts)
        row = torch.repeat_interleave(torch.arange(tiles.numel(), device=dev), counts)
        lists = torch.full((tiles.numel(), k_max), t_count, dtype=torch.long, device=dev)
        lists[row, slot] = tri_of
        table = torch.cat([coef[b], coef.new_zeros((1, coef.shape[-1]))])  # sentinel: det 0
        step = max(1, _PAIRS_PER_BLOCK // (k_max * _TILE * _TILE))
        for s in range(0, tiles.numel(), step):
            tl, ls = tiles[s:s + step], lists[s:s + step]
            col = (tl % ntx)[:, None] * _TILE + lanes_x[None, :]
            rowp = (tl // ntx)[:, None] * _TILE + lanes_y[None, :]
            x = ndc(col, w, dtype)[:, None, :]
            y = ndc(rowp, h, dtype)[:, None, :]
            c = table[ls]  # (n, K, 13)
            ok, z = _edges_z([c[..., i, None] for i in range(13)], x, y)
            ok = ok & ((col < w) & (rowp < h))[:, None, :]
            zc = torch.where(ok, z, inf)
            zmin = zc.amin(dim=1)
            first_min = (zc == zmin[:, None, :]).to(torch.int8).argmax(dim=1)
            ids = torch.where(torch.isinf(zmin), 0,
                              ls.gather(1, first_min).to(torch.int32) + 1)
            out[b].view(-1)[(rowp * (ntx * _TILE) + col).reshape(-1)] = ids.reshape(-1)
    return out[:, :h, :w].contiguous()


def cull_keep(mesh: Mesh, proj: torch.Tensor, mtx: torch.Tensor) -> torch.Tensor:
    """(T,) the triangles the configuration's back-face cull keeps at the
    batch of poses ``mtx``: front-facing in some hypothesis, or with a
    corner behind the camera in some."""
    b, t = mtx.shape[0], mesh.t_count
    corners = xfm_points(mesh.pos_c, matmul44(proj, mtx)).reshape(b, t, 3, 4)
    det = setup(corners, mesh.degenerate)[..., 12]
    behind = (corners[..., 3] <= 1e-9).any(dim=-1)
    return ((det > 0) | behind).any(dim=0)


def silhouette_bits(det: torch.Tensor, adj: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, T) bitmask: bit m set where the line chat_m = 0 borders a
    silhouette (a boundary edge or a facing transition); edge slot k joins
    corners (k, k + 1) and lies on line (k + 2) % 3."""
    if adj is None:
        return torch.full_like(det, 7.0)
    facing = det.detach() > 0.0
    bits = torch.zeros(det.shape, dtype=torch.int32, device=det.device)
    for k in range(3):
        nb = adj[:, k]
        sil = (nb < 0)[None, :] | (facing[:, nb.clamp(min=0)] != facing)
        bits = bits | (sil.to(torch.int32) << ((k + 2) % 3))
    return bits.to(det.dtype)


def rows_of(mesh: Mesh, mtx: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """(B, T, 32) rows: the setup lanes, the triangle index, the silhouette
    bits, and the interpolation planes of the three colours and the
    rotated z (value = g . (X, Y, 1) / (e0 + e1 + e2))."""
    b, t = mtx.shape[0], mesh.t_count
    p = mesh.pos_c
    zrot = (mtx[:, 2, 0, None] * p[:, 0] + mtx[:, 2, 1, None] * p[:, 1]) \
        + mtx[:, 2, 2, None] * p[:, 2]
    vals = torch.cat([mesh.attrs.expand(b, t, 3, 3), zrot.reshape(b, t, 3, 1)], dim=-1)
    c = [coef[..., 0:3], coef[..., 3:6], coef[..., 6:9]]
    v = [vals[..., k, :, None] for k in range(3)]
    planes = (v[0] * c[0][..., None, :] + v[1] * c[1][..., None, :]) + v[2] * c[2][..., None, :]
    idx = torch.arange(t, dtype=coef.dtype, device=coef.device).expand(b, t)
    sil = silhouette_bits(coef[..., 12], mesh.adj)
    zero = coef.new_zeros((b, t, 1))
    return torch.cat([coef, idx[..., None], sil[..., None], zero, planes.reshape(b, t, 12),
                      coef.new_zeros((b, t, 4))], dim=-1)


def shade(ids: torch.Tensor, rows: torch.Tensor, x, y, channels: int):
    """(zw, [values of the first ``channels`` planes]) at every pixel, 0 on
    background."""
    fg = ids > 0
    e0 = rows[:, 0] * x + rows[:, 1] * y + rows[:, 2]
    e1 = rows[:, 3] * x + rows[:, 4] * y + rows[:, 5]
    e2 = rows[:, 6] * x + rows[:, 7] * y + rows[:, 8]
    zlin = rows[:, 9] * x + rows[:, 10] * y + rows[:, 11]
    det = rows[:, 12]
    s = e0 + e1 + e2
    s_safe = torch.where(s.abs() > _EPS, s, torch.ones_like(s))
    zw = zlin / torch.where(det != 0.0, det, torch.ones_like(det))
    zero = torch.zeros_like(s)
    vals = [torch.where(fg, (rows[:, 16 + 3 * c] * x + rows[:, 17 + 3 * c] * y
                             + rows[:, 18 + 3 * c]) / s_safe, zero) for c in range(channels)]
    return torch.where(fg, zw, zero), vals


def antialias(color, ids, zw, rows, x, y):
    """Silhouette-edge antialiasing of ``color`` (B, H, W): each adjacent
    pixel pair whose ids differ is blended by how far the foreground
    triangle's silhouette edge overhangs the pair's midpoint."""
    h, w = color.shape[1:]
    x = x.expand(h, w)
    y = y.expand(h, w)
    ids, zw = ids.detach(), zw.detach()

    def pad(a, dim, front):
        shape = list(a.shape)
        shape[dim] = 1
        z = a.new_zeros(shape)
        return torch.cat((z, a) if front else (a, z), dim=dim)

    d_a, d_b = _pairs(color[:, :, :-1], color[:, :, 1:], ids[:, :, :-1], ids[:, :, 1:],
                      zw[:, :, :-1], zw[:, :, 1:], rows[..., :-1], rows[..., 1:],
                      x[:, :-1][None], x[:, 1:][None], y[:, :-1][None], True)
    delta = pad(d_a, 2, False) + pad(d_b, 2, True)
    d_t, d_bt = _pairs(color[:, :-1, :], color[:, 1:, :], ids[:, :-1, :], ids[:, 1:, :],
                       zw[:, :-1, :], zw[:, 1:, :], rows[:, :, :-1, :], rows[:, :, 1:, :],
                       y[:-1, :][None], y[1:, :][None], x[:-1, :][None], False)
    delta = delta + pad(d_t, 1, False) + pad(d_bt, 1, True)
    return color + delta


def _pairs(c_a, c_b, id_a, id_b, zw_a, zw_b, rows_a, rows_b, along, along_next, across,
           horizontal: bool):
    differ = id_a != id_b
    fg_is_a = (id_a > 0) & ((id_b == 0) | (zw_a <= zw_b))
    active = differ & ((fg_is_a & (id_a > 0)) | (~fg_is_a & (id_b > 0)))

    def lane(k):
        return torch.where(fg_is_a, rows_a[:, k], rows_b[:, k])

    sil = lane(14).detach().to(torch.int32)
    seg = along_next - along
    any_valid = None
    lam_min = torch.full(active.shape, float("inf"), dtype=rows_a.dtype, device=rows_a.device)
    lam_max = torch.full(active.shape, float("-inf"), dtype=rows_a.dtype, device=rows_a.device)
    det_sign = torch.sign(lane(12)).detach()
    for m in range(3):
        am, bm, cm = lane(3 * m), lane(3 * m + 1), lane(3 * m + 2)
        denom, num = (am, -(bm * across + cm)) if horizontal else (bm, -(am * across + cm))
        denom_ok = denom.abs() > _EPS
        cross_pos = num / torch.where(denom_ok, denom, torch.full_like(denom, _EPS))
        lam = (cross_pos - along) / seg
        on_edge = None
        for j in range(3):
            if j == m:
                continue
            aj, bj, cj = lane(3 * j), lane(3 * j + 1), lane(3 * j + 2)
            ej = (aj * cross_pos + bj * across + cj) if horizontal \
                else (aj * across + bj * cross_pos + cj)
            cond = (ej * det_sign).detach() >= 0.0
            on_edge = cond if on_edge is None else (on_edge & cond)
        valid = (active & denom_ok & on_edge & (lam >= 0.0) & (lam <= 1.0)
                 & (((sil >> m) & 1) != 0))
        any_valid = valid if any_valid is None else (any_valid | valid)
        lam_min = torch.where(valid & (lam < lam_min), lam, lam_min)
        lam_max = torch.where(valid & (lam > lam_max), lam, lam_max)
    lam_sel = torch.where(fg_is_a, lam_min, lam_max)
    lam_sel = torch.where(any_valid, lam_sel, torch.full_like(lam_sel, 0.5))
    lam_sel = torch.minimum(torch.maximum(lam_sel, lam_sel.new_zeros(())), lam_sel.new_ones(()))
    mu = torch.where(fg_is_a, lam_sel - 0.5, 0.5 - lam_sel)
    gate = active & any_valid
    c_fg = torch.where(fg_is_a, c_a, c_b)
    c_bg = torch.where(fg_is_a, c_b, c_a)
    diff = c_fg - c_bg
    zero = torch.zeros_like(mu)
    delta_bg = torch.where(gate, torch.maximum(mu, zero) * diff, zero)
    delta_fg = torch.where(gate, -torch.maximum(-mu, zero) * diff, zero)
    return torch.where(fg_is_a, delta_fg, delta_bg), torch.where(fg_is_a, delta_bg, delta_fg)


class _RoundGrad(torch.autograd.Function):
    """Identity whose gradient is rounded to bfloat16 (to nearest even) and
    back: the configurations' bf16 lane for the gradient of the per-pixel
    rows."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def render(mesh: Mesh, proj: torch.Tensor, mtx: torch.Tensor, resolution: Tuple[int, int],
           keep: Optional[torch.Tensor] = None, drows_bf16: bool = False
           ) -> Dict[str, torch.Tensor]:
    """Render poses ``mtx`` (B, 4, 4), differentiably in them: 'rgb' (B, 3,
    H, W) the interpolated colours (0 on background), 'mask' (B, H, W) the
    antialiased foreground, 'ids' (B, H, W).  ``drows_bf16`` rounds the
    gradient that reaches each pixel's row of its triangle to bfloat16."""
    h, w = resolution
    b, t = mtx.shape[0], mesh.t_count
    mvp = matmul44(proj, mtx)
    corners = xfm_points(mesh.pos_c, mvp).reshape(b, t, 3, 4)
    coef = setup(corners, mesh.degenerate)
    ids = raster_ids(coef.detach(), corners.detach(), resolution, keep)
    packed = rows_of(mesh, mtx, coef)
    fg = (ids > 0).reshape(b, -1)
    idx = (ids.long() - 1).clamp(min=0).reshape(b, -1, 1).expand(-1, -1, packed.shape[-1])
    rows = torch.gather(packed, 1, idx)
    rows = torch.where(fg[..., None], rows, torch.zeros_like(rows))
    rows = rows.permute(0, 2, 1).reshape(b, packed.shape[-1], h, w)
    if drows_bf16:
        rows = _RoundGrad.apply(rows)
    dtype = mesh.dtype
    x = ndc(torch.arange(w, device=mtx.device), w, dtype)[None, :]
    y = ndc(torch.arange(h, device=mtx.device), h, dtype)[:, None]
    zw, vals = shade(ids, rows, x, y, 3)
    mask = antialias((ids > 0).to(dtype), ids, zw, rows, x, y)
    return {"rgb": torch.stack(vals, dim=1), "mask": mask, "ids": ids}


def _l1(d: torch.Tensor) -> torch.Tensor:
    """|d|, its derivative +1 at 0."""
    return torch.where(d >= 0, d, -d)


def loss_terms(out: Dict[str, torch.Tensor], gt_rgb: torch.Tensor, gt_seg: torch.Tensor,
               weights: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """Per-hypothesis terms, each already times its weight: 'rgb' the mean
    over the frame of |colour - gt| inside the gt segmentation, 'mask_selection'
    the mean of |mask - segmentation|, each summed over the three channels
    and divided by 3.  ``gt_rgb`` and ``gt_seg`` are (3, H, W)."""
    npx = float(gt_seg.shape[-1] * gt_seg.shape[-2])
    out_terms = {}
    if weights.get("rgb"):
        s = sum(_l1((out["rgb"][:, c] - gt_rgb[c]) * gt_seg[c]).sum(dim=(1, 2))
                for c in range(3))
        out_terms["rgb"] = s / (3.0 * npx) * weights["rgb"]
    if weights.get("mask"):
        s = sum(_l1(out["mask"] - gt_seg[c]).sum(dim=(1, 2)) for c in range(3))
        out_terms["mask_selection"] = s / (3.0 * npx) * weights["mask"]
    return out_terms
