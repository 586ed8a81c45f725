"""Host side of the CUDA tracer kernel path (counterpart of
`lidar_rt_tpu.ops.pallas_tracer`), and the kernel's plain PyTorch twin.

The kernel boundary is the Pallas forward kernel's, per tile t of R rays
and K candidates (`TileInputs`):

    cnt (T,) int32          valid candidates per tile (valid is a prefix)
    dirs (T, R, 3)          unit ray directions
    mind, t0 (T, R)         per-ray minimum hit range / initial transmittance
    axes (T, 3, 3, K)       [n, w1, w2] candidate frame axes
    plane (T, 3, K)         [p, a_u, a_v] plane offsets for the shared origin
    inv_scale (T, 2, K)     inverse splat scales
    opac (T, K)             opacity, binner validity and p != 0 folded in
    sign (T, K)             normal orientation
    sh (T, 3, 16, K)        per-channel SH, degree mask folded in

and its outputs are the channel-major (T, 16, R) rows (0 Σw·max(b·sh0+.5, 0),
1-2 b·Σw·sh + .5Σw, 3 Σw·t, 4 Σw, 5-7 Σw·sign·n, 8 t0 − Σw, 9 raw T,
10-15 zero) and the per-(tile, candidate) Σ_rays w, (T, K).

`forward_tiles` is differentiable (`_TracerCore`, the counterpart of the
reference's `_pallas_core` custom_vjp): the forward and backward kernels
for CUDA tensors, their plain twins (`forward_tiles_reference`,
`backward_tiles_reference`) for CPU tensors; nothing falls back.  Both
kernels and twins composite in tile order, or with `exact` in each ray's
ascending (depth, candidate index) order of its gate-passing hits.  The
background term and the ray-drop head stay outside the kernels.

The reference's two training modes (`ops.tracer.TraceConfig`): with
`cache` (tile order) the forward also returns each (ray, candidate) step's
signed gated alpha and signed exclusive transmittance as bfloat16, (T, K,
R, 2) (`kernels.cache_shape`), and each ray's last index (`last_index`);
the backward decodes them in place of a replay; `fast` takes the kernels'
d_sh sums in one TF32 product per term.
The twins decode the same encoding and stay float32 otherwise.  A render
that takes no gradient never asks for the cache (`forward_tiles`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib
from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.core import sh as sh_lib
from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops import geometry, kernels
from lidar_rt_tpu_torch.ops.binning import (TileAssignment, TileConfig,
                                            bin_surfels)
from lidar_rt_tpu_torch.ops.composite import RenderOutputs, SurfelBundle

Tensor = torch.Tensor

NUM_OUT_ROWS = 16      # padded channel rows (10 used)


class TileInputs(NamedTuple):
    """The kernel boundary's inputs (shapes in the module docstring)."""

    cnt: Tensor
    dirs: Tensor
    mind: Tensor
    t0: Tensor
    axes: Tensor
    plane: Tensor
    inv_scale: Tensor
    opac: Tensor
    sign: Tensor
    sh: Tensor


def _pad_rows(x: Tensor, hp: int) -> Tensor:
    """Pad axis 0 to hp rows by repeating the last row (clamp)."""
    h = x.shape[0]
    if hp == h:
        return x
    return torch.cat([x, x[-1:].expand(hp - h, *x.shape[1:])], dim=0)


def _take_cols_mod(x: Tensor, col_offset: int, wp: int) -> Tensor:
    """Columns [col_offset, col_offset + wp) of x modulo its width along
    axis 1 (azimuth wrap): a column band of the scan, padded to whole
    tiles with the columns past its end."""
    w = x.shape[1]
    reps = -(-(col_offset % w + wp) // w)
    start = col_offset % w
    return torch.cat([x] * reps, dim=1)[:, start:start + wp]


def to_tiles(x: Tensor, tile: TileConfig, col_offset: int = 0,
             num_cols: int | None = None) -> Tensor:
    """(H, W, ...) pixels -> (T, tile_h * tile_w, ...) tiles, row-major over
    (tiles_y, tiles_x), of the column band [col_offset, col_offset +
    num_cols) (default: all of x's columns); rows clamp-padded, columns
    taken modulo W, so a band's last tile reads past its end."""
    h, w = x.shape[:2]
    num_cols = w if num_cols is None else num_cols
    th, tw = tile.tile_h, tile.tile_w
    tiles_y, tiles_x = tile.num_tiles(h, num_cols)
    rest = x.shape[2:]
    xp = _take_cols_mod(_pad_rows(x, tiles_y * th), col_offset, tiles_x * tw)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(rest)))
    return (xp.reshape(tiles_y, th, tiles_x, tw, *rest).permute(*perm)
            .reshape(tiles_y * tiles_x, th * tw, *rest))


def from_tiles(x: Tensor, tile: TileConfig, h: int, w: int) -> Tensor:
    """Inverse of `to_tiles` for (T, R, C) tiles of a band w columns wide:
    (H, w, C), the padding rows and columns dropped."""
    th, tw = tile.tile_h, tile.tile_w
    tiles_y, tiles_x = tile.num_tiles(h, w)
    c = x.shape[-1]
    return (x.reshape(tiles_y, tiles_x, th, tw, c).permute(0, 2, 1, 3, 4)
            .reshape(tiles_y * th, tiles_x * tw, c))[:h, :w]


def scatter_accum(assignment: TileAssignment, accum_tk: Tensor, n: int
                  ) -> Tensor:
    """Per-(tile, candidate) weight sums -> per-surfel (N,).  Wrap-padded
    tiles re-render duplicated columns and over-count those surfels, as
    the reference does (densify statistics only)."""
    flat_idx = torch.where(assignment.valid, assignment.index, n).reshape(-1)
    acc = torch.zeros(n + 1, dtype=accum_tk.dtype, device=accum_tk.device)
    return acc.index_add_(0, flat_idx, accum_tk.reshape(-1))[:n]


def bin_bundle(bundle: SurfelBundle, grid: rays_lib.SensorGrid, width: int,
               sensor2world: Tensor, tile: TileConfig, col_offset: int = 0,
               num_cols: int | None = None) -> TileAssignment:
    """The tile assignment of one render (of the column band col_offset,
    num_cols), with oriented footprints."""
    return bin_surfels(grid, width, transforms.invert_se3(sensor2world),
                       bundle.means, bundle.scales, bundle.opacities, tile,
                       rotations=bundle.rotations, col_offset=col_offset,
                       num_cols=num_cols)


def _prepare_tile_inputs(bundle: SurfelBundle, origin: Tensor,
                         index: Tensor, valid: Tensor):
    """Gather candidates and build their frames in (T, ., K) layout:
    (axes, plane, inv_scale, opac, sign, sh).  The frame math is the torch
    engine's (`build_frames` of `to_rotation_matrix`), so both engines see
    the same per-pair alphas."""
    n = bundle.means.shape[0]
    idx = index.clamp(0, n - 1)                               # (T, K)
    frames = geometry.build_frames(
        bundle.means[idx], quat_lib.to_rotation_matrix(bundle.rotations[idx]),
        origin)
    axes = torch.stack([frames.n, frames.w1, frames.w2], dim=1)  # (T,3,K,3)
    plane = torch.stack([frames.p, frames.a_u, frames.a_v], dim=1)
    inv_scale = (1.0 / bundle.scales[idx]).transpose(1, 2)    # (T, 2, K)
    # Binner validity and the degenerate-plane gate fold into opacity.
    opac = bundle.opacities[idx] * valid * (frames.p != 0.0)
    sh = bundle.sh[idx].permute(0, 3, 2, 1)                   # (T, 3, 16, K)
    return (axes.transpose(2, 3), plane, inv_scale, opac, frames.sign, sh)


def tile_inputs(bundle: SurfelBundle, grid: rays_lib.SensorGrid, width: int,
                sensor2world: Tensor, active_sh_degree: int,
                tile: TileConfig, assignment: TileAssignment | None = None,
                min_depth: Tensor | None = None,
                init_trans: Tensor | None = None, col_offset: int = 0,
                render_width: int | None = None
                ) -> tuple[TileInputs, TileAssignment]:
    """Bin (unless given an assignment), make the rays, and lay out one
    render's kernel inputs.  min_depth and init_trans are optional per-ray
    (H, W_r) images of the minimum hit range (default DEPTH_MIN; it gets no
    gradient) and the initial transmittance (default 1; differentiable).

    col_offset/render_width: the column band [col_offset, col_offset +
    W_r) of the W-column scan (default the whole scan).  The band's tiles
    start at col_offset; its last tile, where W_r is no multiple of
    tile_w, holds the next columns' rays, computed and dropped.  The band's
    min_depth and init_trans cover its W_r columns; in those padding
    columns they repeat the band from its start."""
    if assignment is None:
        assignment = bin_bundle(bundle, grid, width, sensor2world, tile,
                                col_offset, render_width)
    origin, dirs = rays_lib.range_rays(grid, width, sensor2world)
    dirs_t = to_tiles(dirs, tile, col_offset,
                      render_width).contiguous()              # (T, R, 3)
    t_total, rays_per_tile = dirs_t.shape[:2]
    if min_depth is None:
        mind = torch.full((t_total, rays_per_tile), geometry.DEPTH_MIN,
                          device=dirs_t.device)
    else:
        mind = to_tiles(min_depth, tile).contiguous()
    if init_trans is None:
        t0 = torch.ones((t_total, rays_per_tile), device=dirs_t.device)
    else:
        t0 = to_tiles(init_trans, tile).contiguous()
    axes, plane, inv_scale, opac, sign, sh = _prepare_tile_inputs(
        bundle, origin, assignment.index, assignment.valid)
    # The kernel computes the full-degree basis; the mask folds into sh.
    sh = sh * sh_lib.degree_mask(active_sh_degree, sh.device)[:, None]
    cnt = assignment.valid.sum(1, dtype=torch.int32)
    inputs = TileInputs(cnt, dirs_t, mind, t0, *(
        x.contiguous() for x in (axes, plane, inv_scale, opac, sign, sh)))
    return inputs, assignment


class _Pairs(NamedTuple):
    """Per-(ray, candidate) replay of the kernels, all (T, R, K) in
    candidate order."""

    safe_qd: Tensor
    b_u: Tensor
    b_v: Tensor
    t: Tensor
    u: Tensor
    v: Tensor
    g: Tensor
    alpha_raw: Tensor
    ok: Tensor
    alpha: Tensor
    t_excl: Tensor
    live: Tensor
    w: Tensor
    t_raw: Tensor      # (T, R): t0 times the product of every (1 - alpha)
    perm: Tensor | None  # (T, R, K) compositing order (exact), else None


def _in_order(x: Tensor, perm: Tensor | None) -> Tensor:
    """x (T, R, K) in compositing order."""
    return x if perm is None else torch.gather(x, -1, perm)


def _from_order(x: Tensor, perm: Tensor | None) -> Tensor:
    """Inverse of `_in_order`: back to candidate order."""
    return x if perm is None else torch.zeros_like(x).scatter(-1, perm, x)


def _pairs(cnt: Tensor, dirs: Tensor, mind: Tensor, t0: Tensor,
           axes: Tensor, plane: Tensor, inv_scale: Tensor, opac: Tensor,
           exact: bool = False) -> _Pairs:
    """Intersect, gate and composite every (ray, candidate) pair of each
    tile densely; candidates at or past `cnt` are masked out, as the
    kernels skip them.  Tile order composites in candidate order; exact
    order in each ray's ascending (t, candidate index) order of its
    gate-passing hits (a stable sort, as the reference's argsort)."""
    k = axes.shape[-1]
    n, w1, w2 = axes[:, 0], axes[:, 1], axes[:, 2]            # (T, 3, K)
    qd = geometry.ray_dot(dirs, n.transpose(1, 2))            # (T, R, K)
    b_u = geometry.ray_dot(dirs, w1.transpose(1, 2))
    b_v = geometry.ray_dot(dirs, w2.transpose(1, 2))
    p, a_u, a_v = plane[:, 0:1], plane[:, 1:2], plane[:, 2:3]  # (T, 1, K)
    abs_qd = qd.abs()
    safe_qd = torch.where(abs_qd > geometry.DENOM_EPS, qd, geometry.DENOM_EPS)
    t = p / safe_qd
    u = (a_u + t * b_u) * inv_scale[:, 0:1]
    v = (a_v + t * b_v) * inv_scale[:, 1:2]
    g = torch.exp(-0.5 * (u * u + v * v))
    alpha_raw = (opac[:, None, :] * g).clamp_max(geometry.ALPHA_MAX)
    in_cnt = torch.arange(k, device=cnt.device)[None, :] < cnt[:, None]
    ok = ((t >= mind[..., None]) & (abs_qd > geometry.DENOM_EPS)
          & (alpha_raw >= geometry.ALPHA_MIN) & in_cnt[:, None, :])
    alpha = torch.where(ok, alpha_raw, 0.0)
    perm = (torch.argsort(torch.where(ok, t, torch.inf), dim=-1, stable=True)
            if exact else None)

    # Live prefix: T_incl is non-increasing, so the T_MIN test is a prefix.
    t_incl = t0[..., None] * torch.cumprod(1.0 - _in_order(alpha, perm),
                                           dim=-1)
    t_excl = torch.cat([t0[..., None], t_incl[..., :-1]], dim=-1)
    live = _from_order(t_incl >= geometry.T_MIN, perm)
    t_excl = _from_order(t_excl, perm)
    w = torch.where(live, alpha * t_excl, 0.0)
    return _Pairs(safe_qd, b_u, b_v, t, u, v, g, alpha_raw, ok, alpha,
                  t_excl, live, w, t_incl[..., -1], perm)


def last_index(live: Tensor, cnt: Tensor) -> Tensor:
    """Each ray's last index, (T, R) int32, from its pairs' live bits (T,
    R, K) in tile order: the first candidate that is not live (the T_MIN
    test stops the ray there), else the tile's last candidate, cnt - 1 (-1
    in an empty tile)."""
    k = live.shape[-1]
    stop = torch.where((~live).any(-1), (~live).int().argmax(-1), k)
    return torch.minimum(stop, cnt.clamp(0, k)[:, None] - 1).int()


def encode_cache(f: _Pairs, cnt: Tensor) -> kernels.TracerCache:
    """The forward's cache of `f`'s pairs as the kernel makes it: pairs
    as the reference encodes them (pallas_tracer.py:286-296), (T, K, R,
    2) bfloat16, the gated alpha, negative where the ALPHA_MAX clamp held
    (zero where a gate failed), and the exclusive transmittance, negative
    where the float32 T_MIN live test failed; and each ray's last index
    (`last_index`).  Dense: the kernel writes only the steps it visits,
    here every pair is encoded."""
    clamped = f.ok & (f.alpha_raw >= geometry.ALPHA_MAX)
    ac = torch.where(clamped, -f.alpha, f.alpha)
    te = torch.where(f.live, f.t_excl, -f.t_excl)
    pairs = torch.stack([ac, te], -1).to(torch.bfloat16)       # (T, R, K, 2)
    return kernels.TracerCache(pairs.transpose(1, 2).contiguous(),
                               last_index(f.live, cnt))


def forward_tiles_reference(cnt: Tensor, dirs: Tensor, mind: Tensor,
                            t0: Tensor, axes: Tensor, plane: Tensor,
                            inv_scale: Tensor, opac: Tensor, sign: Tensor,
                            sh: Tensor, exact: bool = False,
                            cache: bool = False) -> tuple:
    """Plain PyTorch version of the forward kernel, in tile order or (exact)
    per-ray depth order: (chans (T, 16, R), accum (T, K)), with `cache`
    (tile order) also the cache (`encode_cache`).  Dense over every (ray,
    candidate) pair of a tile.  Row 9 is the product of (1 - alpha) over
    every pair; the kernel's stops at a ray's T_MIN hit."""
    kernels.check_cache_order(exact, cache)
    f = _pairs(cnt, dirs, mind, t0, axes, plane, inv_scale, opac, exact)
    w = f.w
    n = axes[:, 0]
    basis = sh_lib.basis(dirs, sh_lib.MAX_SH_DEGREE)          # (T, R, 16)
    col0 = (torch.matmul(basis, sh[:, 0]) + 0.5).clamp_min(0.0)
    sum_w = w.sum(-1)
    rows = [
        (w * col0).sum(-1),
        (basis * torch.matmul(w, sh[:, 1].transpose(1, 2))).sum(-1)
        + 0.5 * sum_w,
        (basis * torch.matmul(w, sh[:, 2].transpose(1, 2))).sum(-1)
        + 0.5 * sum_w,
        (w * f.t).sum(-1),
        sum_w,
        *torch.matmul(w, (sign[:, None] * n).transpose(1, 2)).unbind(-1),
        t0 - sum_w,
        f.t_raw,
    ]
    chans = torch.stack(rows, dim=1)                          # (T, 10, R)
    chans = torch.nn.functional.pad(chans, (0, 0, 0, NUM_OUT_ROWS - 10))
    if cache:
        return chans, w.sum(1), encode_cache(f, cnt)
    return chans, w.sum(1)


def backward_tiles_reference(cnt: Tensor, dirs: Tensor, mind: Tensor,
                             t0: Tensor, axes: Tensor, plane: Tensor,
                             inv_scale: Tensor, opac: Tensor, sign: Tensor,
                             sh: Tensor, fwd_chans: Tensor, g_chans: Tensor,
                             exact: bool = False,
                             cache: kernels.TracerCache | None = None
                             ) -> tuple[Tensor, ...]:
    """Plain PyTorch version of the backward kernel: the closed-form VJP of
    `forward_tiles_reference` in the same order, dense over pairs.
    fwd_chans are the forward's (T, 16, R) channels, g_chans their
    upstream gradients.
    Returns (d_axes (T, 3, 3, K), d_plane (T, 3, K), d_inv_scale (T, 2, K),
    d_opac (T, K), d_sh (T, 3, 16, K)), each summed over the tile's rays.

    dL/dalpha_j = gw_j T_j - (A_j + g_8 T_out + g_9 T_raw) / (1 - alpha_j),
    A_j = sum of gw_k w_k over the pairs k composited after j, gw = dL/dw;
    pairs past a ray's stop get only the raw-T term, since their w and
    suffix are exactly 0.

    cache: a `TracerCache` of these inputs, dense as
    `forward_tiles_reference` encodes it (tile order; its pairs in any
    float dtype), decoded in place of the replay's gates and products as
    the kernel decodes it (pallas_backward.py:183-200,243-270): alpha =
    |x|, the gradient gate x > 0, T_j = |y|, live y > 0, G = alpha /
    max(opacity, 1e-12), and A_j the same reversed cumulative sum of the
    decoded gw w; the intersection's locals are recomputed.  As in the
    kernel, a ray reads no pair past its last index; the pair there, if
    not live, is its stop and gets only the raw-T term."""
    kernels.check_cache_order(exact, cache)
    f = _pairs(cnt, dirs, mind, t0, axes, plane, inv_scale, opac, exact)
    alpha, t_excl, live, g_val = f.alpha, f.t_excl, f.live, f.g
    gate = f.ok & (f.alpha_raw < geometry.ALPHA_MAX)
    if cache is not None:
        k = axes.shape[-1]
        reached = (torch.arange(k, device=dirs.device)
                   <= cache.last[..., None])                  # (T, R, K)
        ac, te = (torch.where(reached, x, 0.0)
                  for x in cache.pairs.float().permute(3, 0, 2, 1))
        alpha, t_excl, live = ac.abs(), te.abs(), te > 0.0
        gate = ac > 0.0
        g_val = alpha / opac[:, None, :].clamp_min(1e-12)
    w = torch.where(live, alpha * t_excl, 0.0)
    t = f.t
    n = axes[:, 0]                                            # (T, 3, K)
    basis = sh_lib.basis(dirs, sh_lib.MAX_SH_DEGREE)          # (T, R, 16)
    c0, c1, c2 = (torch.matmul(basis, sh[:, ch]) for ch in range(3))
    g = [g_chans[:, ch, :, None] for ch in range(10)]         # (T, R, 1)
    sg = sign[:, None, :]                                     # (T, 1, K)
    col0_raw = c0 + 0.5
    gw = (g[0] * col0_raw.clamp_min(0.0) + g[1] * (c1 + 0.5)
          + g[2] * (c2 + 0.5) + g[3] * t + g[4]
          + sg * (g[5] * n[:, 0:1] + g[6] * n[:, 1:2] + g[7] * n[:, 2:3]))
    gww = _in_order(gw * w, f.perm)
    rev = torch.flip(torch.cumsum(torch.flip(gww, [-1]), -1), [-1])
    suffix = _from_order(torch.nn.functional.pad(rev[..., 1:], (0, 1)),
                         f.perm)                              # after j
    one_m = (1.0 - alpha).clamp_min(1e-6)
    t_out = fwd_chans[:, 8, :, None]
    t_raw = fwd_chans[:, 9, :, None]
    live = live.to(w.dtype)
    d_alpha = (gw * t_excl * live
               - ((suffix + g[8] * t_out) * live + g[9] * t_raw) / one_m)
    d_alpha = torch.where(gate, d_alpha, 0.0)

    # alpha -> (opacity, G) -> (u, v) -> (a_u, a_v, 1/s, t) -> axes.
    inv_s0, inv_s1 = inv_scale[:, 0:1], inv_scale[:, 1:2]     # (T, 1, K)
    d_gg = d_alpha * opac[:, None, :] * g_val
    d_u = -d_gg * f.u
    d_v = -d_gg * f.v
    d_t = d_u * inv_s0 * f.b_u + d_v * inv_s1 * f.b_v + g[3] * w
    d_qd = -d_t * t / f.safe_qd
    d_au = d_u * inv_s0
    d_av = d_v * inv_s1
    d_is0 = d_u * (plane[:, 1:2] + t * f.b_u)
    d_is1 = d_v * (plane[:, 2:3] + t * f.b_v)

    def over_rays(a, b):
        """(T, R, C) x (T, R, K) -> (T, C, K)."""
        return torch.matmul(a.transpose(1, 2), b)

    g_norm = g_chans[:, 5:8].transpose(1, 2)                  # (T, R, 3)
    d_axes = torch.stack([
        over_rays(dirs, d_qd) + sign[:, None, :] * over_rays(g_norm, w),
        over_rays(dirs, d_au * t),
        over_rays(dirs, d_av * t)], dim=1)
    d_plane = torch.stack([(d_t / f.safe_qd).sum(1), d_au.sum(1),
                           d_av.sum(1)], dim=1)
    d_inv_scale = torch.stack([d_is0.sum(1), d_is1.sum(1)], dim=1)
    d_opac = (d_alpha * g_val).sum(1)
    x0 = torch.where(col0_raw > 0.0, g[0] * w, 0.0)
    d_sh = torch.stack([over_rays(basis, x0), over_rays(basis, g[1] * w),
                        over_rays(basis, g[2] * w)], dim=1)
    return d_axes, d_plane, d_inv_scale, d_opac, d_sh


def cone_skips(cnt: Tensor, dirs: Tensor, axes: Tensor, plane: Tensor,
               inv_scale: Tensor, opac: Tensor, warp: int = 32) -> Tensor:
    """Plain float32 version of the kernels' box test (`warp_cone`,
    `cone_misses` in csrc/tracer_common.cuh, which both forward kernels and
    the backward sums kernel run): (T, ceil(R / warp), K), True where a
    kernel's warp of `warp` consecutive rays skips the candidate, since no
    direction in the box around its rays' directions can pass the
    candidate's gates.  Candidates past cnt are False.  The tile-order
    kernels still visit candidate 0 (where a ray whose t0 is below T_MIN
    stops); the exact forward leaves every True pair off its warp's
    list."""
    t, r, _ = dirs.shape
    k = axes.shape[-1]
    nw = -(-r // warp)
    d = torch.nn.functional.pad(dirs, (0, 0, 0, nw * warp - r))
    has = (torch.arange(nw * warp, device=dirs.device) < r).view(1, nw, warp)
    u = d * torch.rsqrt((d * d).sum(-1, keepdim=True).clamp_min(1e-24))
    u = torch.where(has[..., None], u.view(t, nw, warp, 3), 0.0)
    c = u.sum(2)
    c = c * torch.rsqrt((c * c).sum(-1, keepdim=True))        # (T, W, 3)
    idx = torch.arange(warp, device=dirs.device)
    last = torch.where(has, idx, -1).amax(-1)                 # (1, W)
    first = torch.where(has, idx, warp).amin(-1)
    span = (u[:, torch.arange(nw), last[0]]
            - u[:, torch.arange(nw), first[0]])               # (T, W, 3)
    span = span - (span * c).sum(-1, keepdim=True) * c
    e1 = span * torch.rsqrt((span * span).sum(-1, keepdim=True))
    e2 = torch.cross(c, e1, dim=-1)

    def extent(e):                                            # (T, W, 1)
        return torch.where(has, (u * e[:, :, None]).sum(-1).abs(),
                           0.0).amax(-1, keepdim=True) * 1.001 + 1e-5

    c_min = torch.where(has, (u * c[:, :, None]).sum(-1), float("inf")
                        ).amin(-1, keepdim=True) - 1e-5
    a1, a2 = extent(e1), extent(e2)

    n, w1, w2 = axes[:, 0], axes[:, 1], axes[:, 2]             # (T, 3, K)
    p, au, av = plane[:, 0:1], plane[:, 1:2], plane[:, 2:3]    # (T, 1, K)
    is0, is1 = inv_scale[:, 0:1], inv_scale[:, 1:2]
    uvec = is0 * (au * n + p * w1)
    vvec = is1 * (av * n + p * w2)

    def dot(e, x):                                            # (T, W, K)
        return torch.einsum("twc,tck->twk", e, x).abs()

    def length(x):                                            # (T, 1, K)
        return x.norm(dim=1, keepdim=True)

    n_len = length(n)
    n_c = dot(c, n)
    n_side = a1 * dot(e1, n) + a2 * dot(e2, n)
    qd_lo = c_min * n_c - n_side
    qd_hi = n_c + n_side
    amp = (1.0 + n_len / qd_lo) / qd_lo
    slack_u = 1e-4 * is0.abs() * amp * (au.abs() * n_len
                                        + p.abs() * length(w1))
    slack_v = 1e-4 * is1.abs() * amp * (av.abs() * n_len
                                        + p.abs() * length(w2))
    u_lo = ((c_min * dot(c, uvec) - a1 * dot(e1, uvec) - a2 * dot(e2, uvec))
            / qd_hi - slack_u).clamp_min(0.0)
    v_lo = ((c_min * dot(c, vvec) - a1 * dot(e1, vvec) - a2 * dot(e2, vvec))
            / qd_hi - slack_v).clamp_min(0.0)
    op = opac[:, None, :]
    r2 = 2.0 * torch.log(op / geometry.ALPHA_MIN)
    skip = (qd_lo > 0) & (u_lo * u_lo + v_lo * v_lo > 1.05 * r2 + 0.05)
    skip = skip | (op < geometry.ALPHA_MIN)
    in_cnt = torch.arange(k, device=dirs.device) < cnt[:, None, None]
    return skip & in_cnt


class _TracerCore(torch.autograd.Function):
    """The differentiable kernel boundary (counterpart of the reference's
    `_pallas_core` custom_vjp): the forward kernel, and the backward kernel
    as its VJP, both in tile order or (exact) per-ray depth order; on CPU
    tensors their plain twins.  With `cache` the forward's cache is saved
    for the backward, which decodes it (autograd frees it with the other
    saved tensors once the backward has run); `fast` selects the
    backward's fast sums.  Gradients reach the candidate geometry,
    opacity, SH and t0; cnt, dirs, mind and sign get none, and accum
    (densify statistics only) passes no gradient back."""

    @staticmethod
    def forward(ctx, exact, fast, cache, cnt, dirs, mind, t0, axes, plane,
                inv_scale, opac, sign, sh):
        inputs = (cnt, dirs, mind, t0, axes, plane, inv_scale, opac, sign,
                  sh)
        if dirs.device.type == "cpu":
            out = forward_tiles_reference(*inputs, exact=exact, cache=cache)
        else:
            out = kernels.tracer_forward(*inputs, exact=exact, cache=cache)
        chans, accum = out[:2]
        ctx.exact, ctx.fast = exact, fast
        ctx.save_for_backward(*inputs, chans,
                              *(out[2] if cache else (None, None)))
        ctx.mark_non_differentiable(accum)
        return chans, accum

    @staticmethod
    def backward(ctx, g_chans, _g_accum):
        *inputs, chans, pairs, last = ctx.saved_tensors
        cache = None if pairs is None else kernels.TracerCache(pairs, last)
        g_chans = g_chans.contiguous()
        if g_chans.device.type == "cpu":
            grads = backward_tiles_reference(*inputs, chans, g_chans,
                                             exact=ctx.exact, cache=cache)
        else:
            grads = kernels.tracer_backward(*inputs, chans, g_chans,
                                            exact=ctx.exact, cache=cache,
                                            fast=ctx.fast)
        d_axes, d_plane, d_inv_scale, d_opac, d_sh = grads
        d_t0 = None
        if ctx.needs_input_grad[6]:                           # t0
            # Every channel row scales linearly in t0 (w = alpha T0
            # prod(1 - alpha)); the T_MIN cutoff's t0-dependence is a
            # measure-zero step, ignored as the reference does.
            d_t0 = ((g_chans[:, :10] * chans[:, :10]).sum(1)
                    / inputs[3].clamp_min(1e-12))
        return (None, None, None, None, None, None, d_t0, d_axes, d_plane,
                d_inv_scale, d_opac, None, d_sh)


def forward_tiles(inputs: TileInputs, exact: bool = False,
                  fast: bool = False, cache: bool = False
                  ) -> tuple[Tensor, Tensor]:
    """The forward tracer on one render's tiles, differentiable: the plain
    twins for CPU tensors, the CUDA kernels for CUDA tensors (which raise
    on failure; nothing falls back).  exact composites each ray's hits in
    depth order, else in tile order.  cache (tile order; raises with
    exact) has the forward keep its residuals for the backward, only when
    a gradient will be taken: grad mode on and an input that requires
    grad.  A render under no_grad, or of inputs that need none, allocates
    no cache.  fast: the backward's fast sums."""
    kernels.check_cache_order(exact, cache)
    cache = cache and torch.is_grad_enabled() and any(
        x.requires_grad for x in inputs)
    return _TracerCore.apply(exact, fast, cache, *inputs)


def trace_forward(bundle: SurfelBundle, grid: rays_lib.SensorGrid,
                  width: int, sensor2world: Tensor, active_sh_degree: int,
                  tile: TileConfig, assignment: TileAssignment | None = None,
                  exact: bool = False, min_depth: Tensor | None = None,
                  init_trans: Tensor | None = None, col_offset: int = 0,
                  render_width: int | None = None, fast: bool = False,
                  cache: bool = False) -> tuple[Tensor, Tensor]:
    """Kernel-path render of the column band (col_offset, render_width;
    default the whole scan) -> (channels (H, W_r, 10): 9 public channels +
    raw transmittance, accum_weights (N,)).  fast, cache: as
    `forward_tiles`."""
    inputs, assignment = tile_inputs(bundle, grid, width, sensor2world,
                                     active_sh_degree, tile, assignment,
                                     min_depth, init_trans, col_offset,
                                     render_width)
    chans, accum_tk = forward_tiles(inputs, exact, fast, cache)
    img = from_tiles(chans.transpose(1, 2), tile, grid.height,
                     width if render_width is None else render_width)
    return img[..., :10], scatter_accum(assignment, accum_tk,
                                         bundle.num_surfels)


def trace(bundle: SurfelBundle, grid: rays_lib.SensorGrid, width: int,
          sensor2world: Tensor, background: Tensor,
          active_sh_degree: int = 3, tile: TileConfig = TileConfig(),
          assignment: TileAssignment | None = None, exact: bool = False,
          min_depth: Tensor | None = None, init_trans: Tensor | None = None,
          col_offset: int = 0, render_width: int | None = None,
          fast: bool = False, cache: bool = False) -> RenderOutputs:
    """Kernel-path counterpart of `ops.tracer.trace`'s torch engine (one
    pass of one column band; the tail passes chain it).  fast, cache: as
    `forward_tiles`."""
    img, accum = trace_forward(bundle, grid, width, sensor2world,
                               active_sh_degree, tile, assignment, exact,
                               min_depth, init_trans, col_offset,
                               render_width, fast, cache)
    final_t = img[..., 8:9]
    channels = torch.cat([img[..., 0:3] + final_t * background, img[..., 3:8],
                          final_t], dim=-1)
    return RenderOutputs(channels=channels, accum_weights=accum,
                         raw_trans=img[..., 9])
