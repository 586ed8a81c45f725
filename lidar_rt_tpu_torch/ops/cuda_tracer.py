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
`backward_tiles_reference`) for CPU tensors; nothing falls back.  The
background term and the ray-drop head stay outside the kernels.
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


def _take_cols_mod(x: Tensor, wp: int) -> Tensor:
    """Columns [0, wp) of x modulo its width along axis 1 (azimuth wrap)."""
    w = x.shape[1]
    return torch.cat([x] * -(-wp // w), dim=1)[:, :wp]


def to_tiles(x: Tensor, tile: TileConfig) -> Tensor:
    """(H, W, ...) pixels -> (T, tile_h * tile_w, ...) tiles, row-major over
    (tiles_y, tiles_x); rows clamp-padded, columns wrap-padded."""
    h, w = x.shape[:2]
    th, tw = tile.tile_h, tile.tile_w
    tiles_y, tiles_x = tile.num_tiles(h, w)
    rest = x.shape[2:]
    xp = _take_cols_mod(_pad_rows(x, tiles_y * th), tiles_x * tw)
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(rest)))
    return (xp.reshape(tiles_y, th, tiles_x, tw, *rest).permute(*perm)
            .reshape(tiles_y * tiles_x, th * tw, *rest))


def from_tiles(x: Tensor, tile: TileConfig, h: int, w: int) -> Tensor:
    """Inverse of `to_tiles` for (T, R, C) tiles: (H, W, C), first copy of
    each pixel kept."""
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
               sensor2world: Tensor, tile: TileConfig) -> TileAssignment:
    """The tile assignment of one render, with oriented footprints."""
    return bin_surfels(grid, width, transforms.invert_se3(sensor2world),
                       bundle.means, bundle.scales, bundle.opacities, tile,
                       rotations=bundle.rotations)


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
                tile: TileConfig, assignment: TileAssignment | None = None
                ) -> tuple[TileInputs, TileAssignment]:
    """Bin (unless given an assignment), make the rays, and lay out one
    render's kernel inputs."""
    if assignment is None:
        assignment = bin_bundle(bundle, grid, width, sensor2world, tile)
    origin, dirs = rays_lib.range_rays(grid, width, sensor2world)
    dirs_t = to_tiles(dirs, tile).contiguous()                # (T, R, 3)
    t_total, rays_per_tile = dirs_t.shape[:2]
    mind = torch.full((t_total, rays_per_tile), geometry.DEPTH_MIN,
                      device=dirs_t.device)
    t0 = torch.ones((t_total, rays_per_tile), device=dirs_t.device)
    axes, plane, inv_scale, opac, sign, sh = _prepare_tile_inputs(
        bundle, origin, assignment.index, assignment.valid)
    # The kernel computes the full-degree basis; the mask folds into sh.
    sh = sh * sh_lib.degree_mask(active_sh_degree, sh.device)[:, None]
    cnt = assignment.valid.sum(1, dtype=torch.int32)
    inputs = TileInputs(cnt, dirs_t, mind, t0, *(
        x.contiguous() for x in (axes, plane, inv_scale, opac, sign, sh)))
    return inputs, assignment


class _Pairs(NamedTuple):
    """Per-(ray, candidate) replay of the kernels, all (T, R, K)."""

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
    t_incl: Tensor
    live: Tensor
    w: Tensor


def _pairs(cnt: Tensor, dirs: Tensor, mind: Tensor, t0: Tensor,
           axes: Tensor, plane: Tensor, inv_scale: Tensor, opac: Tensor
           ) -> _Pairs:
    """Intersect, gate and composite every (ray, candidate) pair of each
    tile densely; candidates at or past `cnt` are masked out, as the
    kernels skip them."""
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

    # Live prefix: T_incl is non-increasing, so the T_MIN test is a prefix.
    t_incl = t0[..., None] * torch.cumprod(1.0 - alpha, dim=-1)
    t_excl = torch.cat([t0[..., None], t_incl[..., :-1]], dim=-1)
    live = t_incl >= geometry.T_MIN
    w = torch.where(live, alpha * t_excl, 0.0)
    return _Pairs(safe_qd, b_u, b_v, t, u, v, g, alpha_raw, ok, alpha,
                  t_excl, t_incl, live, w)


def forward_tiles_reference(cnt: Tensor, dirs: Tensor, mind: Tensor,
                            t0: Tensor, axes: Tensor, plane: Tensor,
                            inv_scale: Tensor, opac: Tensor, sign: Tensor,
                            sh: Tensor) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of the forward kernel: (chans (T, 16, R),
    accum (T, K)).  Dense over every (ray, candidate) pair of a tile.
    Row 9 is the product of (1 - alpha) over every pair; the kernel's stops
    at a ray's T_MIN hit."""
    f = _pairs(cnt, dirs, mind, t0, axes, plane, inv_scale, opac)
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
        f.t_incl[..., -1],
    ]
    chans = torch.stack(rows, dim=1)                          # (T, 10, R)
    chans = torch.nn.functional.pad(chans, (0, 0, 0, NUM_OUT_ROWS - 10))
    return chans, w.sum(1)


def backward_tiles_reference(cnt: Tensor, dirs: Tensor, mind: Tensor,
                             t0: Tensor, axes: Tensor, plane: Tensor,
                             inv_scale: Tensor, opac: Tensor, sign: Tensor,
                             sh: Tensor, fwd_chans: Tensor, g_chans: Tensor
                             ) -> tuple[Tensor, ...]:
    """Plain PyTorch version of the backward kernel: the closed-form VJP of
    `forward_tiles_reference`, dense over pairs.  fwd_chans are the
    forward's (T, 16, R) channels, g_chans their upstream gradients.
    Returns (d_axes (T, 3, 3, K), d_plane (T, 3, K), d_inv_scale (T, 2, K),
    d_opac (T, K), d_sh (T, 3, 16, K)), each summed over the tile's rays.

    dL/dalpha_j = gw_j T_j - (A_j + g_8 T_out + g_9 T_raw) / (1 - alpha_j),
    A_j = sum_{k>j} gw_k w_k, gw = dL/dw; pairs past a ray's stop get
    only the raw-T term, since their w and suffix are exactly 0."""
    f = _pairs(cnt, dirs, mind, t0, axes, plane, inv_scale, opac)
    w, t = f.w, f.t
    n = axes[:, 0]                                            # (T, 3, K)
    basis = sh_lib.basis(dirs, sh_lib.MAX_SH_DEGREE)          # (T, R, 16)
    c0, c1, c2 = (torch.matmul(basis, sh[:, ch]) for ch in range(3))
    g = [g_chans[:, ch, :, None] for ch in range(10)]         # (T, R, 1)
    sg = sign[:, None, :]                                     # (T, 1, K)
    col0_raw = c0 + 0.5
    gw = (g[0] * col0_raw.clamp_min(0.0) + g[1] * (c1 + 0.5)
          + g[2] * (c2 + 0.5) + g[3] * t + g[4]
          + sg * (g[5] * n[:, 0:1] + g[6] * n[:, 1:2] + g[7] * n[:, 2:3]))
    gww = gw * w
    rev = torch.flip(torch.cumsum(torch.flip(gww, [-1]), -1), [-1])
    suffix = torch.nn.functional.pad(rev[..., 1:], (0, 1))    # sum_{k>j}
    one_m = (1.0 - f.alpha).clamp_min(1e-6)
    t_out = fwd_chans[:, 8, :, None]
    t_raw = fwd_chans[:, 9, :, None]
    live = f.live.to(w.dtype)
    d_alpha = (gw * f.t_excl * live
               - (suffix + g[8] * t_out * live + g[9] * t_raw) / one_m)
    d_alpha = torch.where(f.ok & (f.alpha_raw < geometry.ALPHA_MAX),
                          d_alpha, 0.0)

    # alpha -> (opacity, G) -> (u, v) -> (a_u, a_v, 1/s, t) -> axes.
    inv_s0, inv_s1 = inv_scale[:, 0:1], inv_scale[:, 1:2]     # (T, 1, K)
    d_gg = d_alpha * opac[:, None, :] * f.g
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
    d_opac = (d_alpha * f.g).sum(1)
    x0 = torch.where(col0_raw > 0.0, g[0] * w, 0.0)
    d_sh = torch.stack([over_rays(basis, x0), over_rays(basis, g[1] * w),
                        over_rays(basis, g[2] * w)], dim=1)
    return d_axes, d_plane, d_inv_scale, d_opac, d_sh


class _TracerCore(torch.autograd.Function):
    """The differentiable kernel boundary (counterpart of the reference's
    `_pallas_core` custom_vjp): the forward kernel, and the backward kernel
    as its VJP; on CPU tensors their plain twins.  Gradients reach the
    candidate geometry, opacity, SH and t0; cnt, dirs, mind and sign get
    none, and accum (densify statistics only) passes no gradient back."""

    @staticmethod
    def forward(ctx, cnt, dirs, mind, t0, axes, plane, inv_scale, opac,
                sign, sh):
        inputs = (cnt, dirs, mind, t0, axes, plane, inv_scale, opac, sign,
                  sh)
        if dirs.device.type == "cpu":
            chans, accum = forward_tiles_reference(*inputs)
        else:
            chans, accum = kernels.tracer_forward(*inputs)
        ctx.save_for_backward(*inputs, chans)
        ctx.mark_non_differentiable(accum)
        return chans, accum

    @staticmethod
    def backward(ctx, g_chans, _g_accum):
        *inputs, chans = ctx.saved_tensors
        g_chans = g_chans.contiguous()
        if g_chans.device.type == "cpu":
            grads = backward_tiles_reference(*inputs, chans, g_chans)
        else:
            grads = kernels.tracer_backward(*inputs, chans, g_chans)
        d_axes, d_plane, d_inv_scale, d_opac, d_sh = grads
        d_t0 = None
        if ctx.needs_input_grad[3]:
            # Every channel row scales linearly in t0 (w = alpha T0
            # prod(1 - alpha)); the T_MIN cutoff's t0-dependence is a
            # measure-zero step, ignored as the reference does.
            d_t0 = ((g_chans[:, :10] * chans[:, :10]).sum(1)
                    / inputs[3].clamp_min(1e-12))
        return (None, None, None, d_t0, d_axes, d_plane, d_inv_scale,
                d_opac, None, d_sh)


def forward_tiles(inputs: TileInputs) -> tuple[Tensor, Tensor]:
    """The forward tracer on one render's tiles, differentiable: the plain
    twins for CPU tensors, the CUDA kernels for CUDA tensors (which raise
    on failure; nothing falls back)."""
    return _TracerCore.apply(*inputs)


def trace_forward(bundle: SurfelBundle, grid: rays_lib.SensorGrid,
                  width: int, sensor2world: Tensor, active_sh_degree: int,
                  tile: TileConfig, assignment: TileAssignment | None = None
                  ) -> tuple[Tensor, Tensor]:
    """Kernel-path render -> (channels (H, W, 10): 9 public channels + raw
    transmittance, accum_weights (N,))."""
    inputs, assignment = tile_inputs(bundle, grid, width, sensor2world,
                                     active_sh_degree, tile, assignment)
    chans, accum_tk = forward_tiles(inputs)
    img = from_tiles(chans.transpose(1, 2), tile, grid.height, width)
    return img[..., :10], scatter_accum(assignment, accum_tk,
                                         bundle.num_surfels)


def trace(bundle: SurfelBundle, grid: rays_lib.SensorGrid, width: int,
          sensor2world: Tensor, background: Tensor,
          active_sh_degree: int = 3, tile: TileConfig = TileConfig(),
          assignment: TileAssignment | None = None) -> RenderOutputs:
    """Kernel-path counterpart of `ops.tracer.trace`'s torch engine."""
    img, accum = trace_forward(bundle, grid, width, sensor2world,
                               active_sh_degree, tile, assignment)
    final_t = img[..., 8:9]
    channels = torch.cat([img[..., 0:3] + final_t * background, img[..., 3:8],
                          final_t], dim=-1)
    return RenderOutputs(channels=channels, accum_weights=accum,
                         raw_trans=img[..., 9])
