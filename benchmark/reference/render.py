"""The plain reference of the tiled surfel tracer: binning, the tail chain,
compositing in tile order, and gradients by autograd, in plain torch.

It imports nothing of the program.  It is a frozen restatement of the
semantics a `TraceConfig` of the configuration states (the port's
`ops/binning.py` hier binner, `ops/tracer.py` torch engine and tail passes,
`core/rays.py` ray model), so that the program's kernels, its tile inputs,
its binning and its untiling are all held to it:

  * binning: each surfel's oriented footprint in the raster (opacity-
    adaptive cutoff, `pad_px` of padding, the integer-sample cull at
    `snap_pad_px`); per azimuth sector the nearest coarse_factor * K
    overlapping surfels, then per row tile the nearest K of those,
    nearest-first by centre range with ties to the lower index;
  * the tail chain: pass p + 1 lists, per truncated tile, only surfels
    strictly past pass p's K-th range;
  * compositing: every (ray, candidate) pair intersected analytically,
    gated (t >= 0.2 m, |n.d| > 1e-12, p != 0, alpha >= 1/255, alpha
    clamped at 0.99), composited front to back in list order down to
    transmittance 1e-4, each pass starting from the last pass's raw
    transmittance; channels (intensity, hit and drop logits from SH
    degree <= 3, depth, weight sum, signed normal, final transmittance)
    and per-surfel weight sums.

`render` works in blocks of tiles and accumulates the gradient of a loss
that sums over rays block by block, so that it fits beside nothing else on
the card.  `dtype=torch.bfloat16` computes the compositing in bfloat16:
the control that the comparison has to fail.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

Tensor = torch.Tensor

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_MIN = 1e-4
DEPTH_MIN = 0.2
DENOM_EPS = 1e-12
CUTOFF_EPS = 0.01

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Raster(NamedTuple):
    """Row inclinations (H,), top row first; width; pixel and angle
    offsets."""

    incl: Tensor
    width: int
    pixel_offset: float
    angle_offset: float


class Tiling(NamedTuple):
    tile_h: int
    tile_w: int
    k: int
    coarse_factor: int
    pad_px: float
    snap_pad_px: float
    int_eps: float
    tail_passes: int

    def counts(self, h: int, w: int) -> tuple[int, int]:
        return -(-h // self.tile_h), -(-w // self.tile_w)


def tiling(tracer: dict) -> Tiling:
    """The configuration file's `tracer` block."""
    return Tiling(int(tracer["tile_h"]), int(tracer["tile_w"]),
                  int(tracer["max_per_tile"]), int(tracer["coarse_factor"]),
                  float(tracer["pad_px"]), float(tracer["snap_pad_px"]),
                  float(tracer["int_eps"]), int(tracer["tail_passes"]))


# --- rays --------------------------------------------------------------

def rays(r: Raster, s2w: Tensor) -> tuple[Tensor, Tensor]:
    """World rays: origin (3,), unit directions (H, W, 3)."""
    cols = torch.arange(r.width, dtype=torch.float32, device=r.incl.device)
    az = ((r.width - cols - r.pixel_offset) / float(r.width)) \
        * (2.0 * math.pi) - math.pi - r.angle_offset
    ci, si = torch.cos(r.incl)[:, None], torch.sin(r.incl)[:, None]
    d = torch.stack([ci * torch.cos(az)[None], ci * torch.sin(az)[None],
                     si * torch.ones_like(az)[None]], -1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    w = (s2w[:3, :3] * d[..., None, :]).sum(-1)
    return s2w[:3, 3], w / torch.linalg.vector_norm(w, dim=-1, keepdim=True)


def invert(m: Tensor) -> Tensor:
    r_t = m[:3, :3].T
    out = torch.zeros_like(m)
    out[:3, :3] = r_t
    out[:3, 3] = -(r_t * m[:3, 3][None, :]).sum(-1)
    out[3, 3] = 1.0
    return out


def row_of_incl(r: Raster, incl: Tensor) -> Tensor:
    rows = r.incl.flip(0)
    h = rows.shape[0]
    hi = (rows < incl[..., None]).sum(-1).clamp(1, h - 1)
    lo = hi - 1
    frac = (incl - rows[lo]) / (rows[hi] - rows[lo]).clamp_min(1e-12)
    return (h - 1) - (lo.to(incl.dtype) + frac)


def col_of_azimuth(r: Raster, az: Tensor) -> Tensor:
    x = (az + math.pi + r.angle_offset) / (2.0 * math.pi)
    return torch.remainder(r.width - r.pixel_offset - x * r.width,
                           float(r.width))


def quat_matrix(q: Tensor) -> Tensor:
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(*q.shape[:-1], 3, 3)


# --- binning -----------------------------------------------------------

def _points(w2s: Tensor, means: Tensor):
    mx, my, mz = means.unbind(-1)
    px = w2s[0, 0] * mx + w2s[0, 1] * my + w2s[0, 2] * mz + w2s[0, 3]
    py = w2s[1, 0] * mx + w2s[1, 1] * my + w2s[1, 2] * mz + w2s[1, 3]
    pz = w2s[2, 0] * mx + w2s[2, 1] * my + w2s[2, 2] * mz + w2s[2, 3]
    return px, py, pz, torch.sqrt(px * px + py * py + pz * pz)


def footprints(r: Raster, w2s: Tensor, means, scales, opac, quats,
               t: Tiling):
    """(row_lo, row_hi, col_c, col_half, rng, live) per surfel."""
    px, py, pz, rng = _points(w2s, means)
    horiz = torch.sqrt(px * px + py * py).clamp_min(1e-12)
    safe = rng.clamp_min(DEPTH_MIN)
    incl = torch.atan2(pz, horiz)
    col_c = col_of_azimuth(r, torch.atan2(py, px))
    cut = torch.sqrt(2.0 * torch.log((opac * 255.0).clamp_min(1.0 + 1e-6))) \
        + CUTOFF_EPS
    inv_rng = 1.0 / safe
    sin_i, cos_i = pz * inv_rng, horiz * inv_rng
    inv_h = 1.0 / horiz
    sin_a, cos_a = py * inv_h, px * inv_h
    qn = quats / torch.linalg.vector_norm(quats, dim=-1,
                                          keepdim=True).clamp_min(1e-12)
    qw, qx, qy, qz = qn.unbind(-1)
    c0 = (1.0 - 2.0 * (qy * qy + qz * qz), 2.0 * (qx * qy + qw * qz),
          2.0 * (qx * qz - qw * qy))
    c1 = (2.0 * (qx * qy - qw * qz), 1.0 - 2.0 * (qx * qx + qz * qz),
          2.0 * (qy * qz + qw * qx))
    e0, e1 = scales[:, 0] * cut, scales[:, 1] * cut
    s1 = [e0 * (w2s[i, 0] * c0[0] + w2s[i, 1] * c0[1] + w2s[i, 2] * c0[2])
          for i in range(3)]
    s2 = [e1 * (w2s[i, 0] * c1[0] + w2s[i, 1] * c1[1] + w2s[i, 2] * c1[2])
          for i in range(3)]

    def support(dx, dy, dz):
        d1 = s1[0] * dx + s1[1] * dy + s1[2] * dz
        d2 = s2[0] * dx + s2[1] * dy + s2[2] * dz
        return torch.sqrt(d1 * d1 + d2 * d2)

    rng_eff = (safe - support(cos_i * cos_a, cos_i * sin_a, sin_i)
               ).clamp_min(DEPTH_MIN)
    ang_row = torch.atan2(support(-sin_i * cos_a, -sin_i * sin_a, cos_i),
                          rng_eff)
    ang_col = torch.atan2(support(-sin_a, cos_a, torch.zeros_like(sin_a)),
                          rng_eff)
    row_lo = row_of_incl(r, incl + ang_row) - t.pad_px
    row_hi = row_of_incl(r, incl - ang_row) + t.pad_px
    col_half = (ang_col / torch.cos(incl).clamp_min(1e-3)) \
        * (r.width / (2.0 * math.pi)) + t.pad_px
    col_half = col_half.clamp_max(r.width / 2.0)
    live = (opac > ALPHA_MIN) & (rng > DEPTH_MIN)
    d = t.pad_px - t.snap_pad_px
    h = r.incl.shape[0]
    has_row = (torch.floor((row_hi - d).clamp_max(h - 1.0))
               >= torch.ceil((row_lo + d).clamp_min(0.0)))
    has_col = (torch.floor(col_c + col_half - d)
               >= torch.ceil(col_c - (col_half - d)))
    return row_lo, row_hi, col_c, col_half, rng, live & has_row & has_col


def _nearest(score: Tensor, k: int):
    vals, idx = torch.sort(score, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def bin_tiles(r: Raster, w2s: Tensor, means, scales, opac, quats,
              t: Tiling, min_range: Tensor | None = None):
    """The hier selection: (index (T, K) with N for an empty slot, valid
    (T, K), truncated (T,) overflow counts incl. the sector level's)."""
    n = means.shape[0]
    h, w = r.incl.shape[0], r.width
    dev = means.device
    ty_n, tx_n = t.counts(h, w)
    row_lo, row_hi, col_c, col_half, rng, live = footprints(
        r, w2s, means, scales, opac, quats, t)
    tx = torch.arange(tx_n, dtype=torch.float32, device=dev)
    first_col = torch.remainder(tx * t.tile_w, float(w))
    ty = torch.arange(ty_n, device=dev)
    t_lo = (ty * t.tile_h).to(torch.float32)
    t_hi = ((ty + 1) * t.tile_h).clamp_max(h).to(torch.float32)
    # Column overlap in integer samples, the seam retested at +-W.
    o = torch.remainder(col_c[None, :] - first_col[:, None], float(w))
    o = torch.where(o > w / 2.0, o - w, o)
    ch = col_half[None, :] + t.int_eps

    def hit(oo):
        return (torch.floor((oo + ch).clamp_max(t.tile_w - 1.0))
                >= torch.ceil((oo - ch).clamp_min(0.0)))

    col_ok = (hit(o) | hit(o + w) | hit(o - w)) & live       # (tx, N)
    if min_range is not None:
        min_range = min_range.reshape(ty_n, tx_n)
        col_ok = col_ok & (rng[None, :] > min_range.amin(0)[:, None])
    k_c = min(t.coarse_factor * t.k, n)
    top_c, idx_c = _nearest(torch.where(col_ok, rng, torch.inf), k_c)
    valid_c = torch.isfinite(top_c)
    coarse_trunc = (col_ok.sum(-1) - k_c).clamp_min(0)
    lo = row_lo[idx_c][None]
    hi = row_hi[idx_c][None]
    sl, sh_ = t_lo.view(-1, 1, 1), t_hi.view(-1, 1, 1)
    row_ok = ((torch.floor(torch.minimum(hi + t.int_eps, sh_ - 1.0))
               >= torch.ceil(torch.maximum(lo - t.int_eps, sl)))
              & valid_c)                                     # (ty, tx, K_c)
    if min_range is not None:
        row_ok = row_ok & (rng[idx_c][None] > min_range[:, :, None])
    kk = min(t.k, k_c)
    top, sel = _nearest(torch.where(row_ok, rng[idx_c][None], torch.inf)
                        .reshape(-1, k_c), kk)
    valid = torch.isfinite(top)
    idx_flat = idx_c.expand(ty_n, tx_n, k_c).reshape(-1, k_c)
    index = torch.where(valid, torch.gather(idx_flat, 1, sel), n)
    if kk < t.k:
        index = torch.nn.functional.pad(index, (0, t.k - kk), value=n)
        valid = torch.nn.functional.pad(valid, (0, t.k - kk), value=False)
    truncated = ((row_ok.sum(-1) - kk).clamp_min(0)
                 + coarse_trunc[None]).reshape(-1)
    return index, valid, truncated, rng


def tail_chain(r: Raster, w2s: Tensor, bundle, t: Tiling
               ) -> list[tuple[Tensor, Tensor]]:
    """tail_passes + 1 disjoint (index, valid) lists: each pass past the
    last pass's K-th range in every truncated tile."""
    means, quats, scales, opac = (x.detach() for x in bundle[:4])
    out, min_range = [], None
    for p in range(t.tail_passes + 1):
        index, valid, trunc, rng = bin_tiles(r, w2s, means, scales, opac,
                                             quats, t, min_range)
        out.append((index, valid))
        if p < t.tail_passes:
            n = means.shape[0]
            sel = torch.where(valid, rng[index.clamp(0, n - 1)], -torch.inf)
            cutoff = torch.where(trunc > 0, sel.amax(-1), torch.inf)
            min_range = (cutoff if min_range is None
                         else torch.maximum(cutoff, min_range))
    return out


# --- tiles -------------------------------------------------------------

def to_tiles(x: Tensor, t: Tiling) -> Tensor:
    """(H, W, ...) -> (T, tile_h * tile_w, ...): rows padded by repeating
    the last, columns wrapped modulo W."""
    h, w = x.shape[:2]
    ty_n, tx_n = t.counts(h, w)
    hp, wp = ty_n * t.tile_h, tx_n * t.tile_w
    if hp > h:
        x = torch.cat([x, x[-1:].expand(hp - h, *x.shape[1:])], 0)
    x = torch.cat([x] * (-(-wp // w)), 1)[:, :wp]
    rest = x.shape[2:]
    perm = (0, 2, 1, 3) + tuple(range(4, 4 + len(rest)))
    return (x.reshape(ty_n, t.tile_h, tx_n, t.tile_w, *rest).permute(*perm)
            .reshape(ty_n * tx_n, t.tile_h * t.tile_w, *rest))


def pixel_of_tiles(h: int, w: int, t: Tiling, device) -> Tensor:
    """(T, R) pixel id of each tiled ray, -1 for the padding rays that the
    image drops."""
    ty_n, tx_n = t.counts(h, w)
    hp, wp = ty_n * t.tile_h, tx_n * t.tile_w
    y = torch.arange(hp, device=device)[:, None].expand(hp, wp)
    x = torch.arange(wp, device=device)[None, :].expand(hp, wp)
    pid = torch.where((y < h) & (x < w), y * w + x, -1)
    return (pid.reshape(ty_n, t.tile_h, tx_n, t.tile_w).permute(0, 2, 1, 3)
            .reshape(ty_n * tx_n, t.tile_h * t.tile_w))


# --- compositing -------------------------------------------------------

def sh_basis(d: Tensor, degree: int) -> Tensor:
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-12)
    x, y, z = d.unbind(-1)
    xx, yy, zz, xy, yz, xz = x * x, y * y, z * z, x * y, y * z, x * z
    b = torch.stack([
        torch.full_like(x, SH_C0), -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * xy, SH_C2[1] * yz, SH_C2[2] * (2.0 * zz - xx - yy),
        SH_C2[3] * xz, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
        SH_C3[2] * y * (4.0 * zz - xx - yy),
        SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        SH_C3[4] * x * (4.0 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3.0 * yy)], -1)
    keep = (torch.arange(16, device=d.device) < (degree + 1) ** 2)
    return b * keep.to(b.dtype)


def composite(dirs, origin, means, quats, scales, opac, sh, valid,
              degree: int, t0: Tensor | None):
    """One pass over B tiles: rays (B, R, 3), candidates (B, K, ...).
    Returns (sums (B, R, 8): colour (3), depth, weight sum, signed normal
    (3); raw transmittance (B, R); weights (B, R, K))."""
    rot = quat_matrix(quats)                                  # (B, K, 3, 3)
    w1, w2, n = rot[..., 0], rot[..., 1], rot[..., 2]
    omm = origin - means
    p = -(n * omm).sum(-1)
    a_u = (w1 * omm).sum(-1)
    a_v = (w2 * omm).sum(-1)
    sign = torch.where(p < 0.0, 1.0, -1.0).to(p.dtype)

    def dot(axis):
        return (dirs[..., :, None, 0] * axis[..., None, :, 0]
                + dirs[..., :, None, 1] * axis[..., None, :, 1]
                + dirs[..., :, None, 2] * axis[..., None, :, 2])

    qd, b_u, b_v = dot(n), dot(w1), dot(w2)
    safe = torch.where(qd.abs() > DENOM_EPS, qd,
                       torch.full_like(qd, DENOM_EPS))
    tt = p[:, None, :] / safe
    inv_s = 1.0 / scales
    u = (a_u[:, None, :] + tt * b_u) * inv_s[:, None, :, 0]
    v = (a_v[:, None, :] + tt * b_v) * inv_s[:, None, :, 1]
    g = torch.exp(-0.5 * (u * u + v * v))
    alpha_raw = (opac[:, None, :] * g).clamp_max(ALPHA_MAX)
    ok = ((tt >= DEPTH_MIN) & (qd.abs() > DENOM_EPS) & (p[:, None, :] != 0)
          & (alpha_raw >= ALPHA_MIN) & valid[:, None, :])
    alpha = torch.where(ok, alpha_raw, torch.zeros_like(alpha_raw))
    one = torch.ones_like(alpha[..., :1]) if t0 is None else t0[..., None]
    t_incl = one * torch.cumprod(1.0 - alpha, dim=-1)
    t_excl = torch.cat([one, t_incl[..., :-1]], -1)
    live = torch.cumprod((t_incl >= T_MIN).to(alpha.dtype), dim=-1)
    w = live * alpha * t_excl
    basis = sh_basis(dirs, degree)                            # (B, R, 16)
    colors = (basis[:, :, None, :, None] * sh[:, None]).sum(-2) + 0.5
    colors = torch.cat([colors[..., :1].clamp_min(0.0), colors[..., 1:]], -1)
    sn = n * sign[..., None]
    sums = torch.cat([(w[..., None] * colors).sum(2),
                      (w * tt).sum(-1, keepdim=True),
                      w.sum(-1, keepdim=True),
                      (w[..., None] * sn[:, None]).sum(2)], -1)
    raw = one[..., 0] * torch.prod(1.0 - alpha, dim=-1)
    return sums, raw, w


class Render(NamedTuple):
    channels: Tensor     # (H, W, 9) float32
    accum: Tensor        # (N,) float32
    grads: list[Tensor] | None


def render(bundle: list[Tensor], r: Raster, s2w: Tensor, t: Tiling,
           degree: int, background: Tensor,
           loss: Callable[[Tensor, Tensor], Tensor] | None = None,
           dtype=torch.float32, block: int = 8,
           chain: list[tuple[Tensor, Tensor]] | None = None) -> Render:
    """Render the bundle (means, quats, scales, opacities, sh) from pose
    s2w through its tail chain (binned here unless given), in blocks of
    `block` tiles.  With `loss(channels (P, 9), pixel ids (P,))`, a sum
    over rays, the gradient to the five fields is accumulated block by
    block.  The compositing runs in `dtype`."""
    h, w = r.incl.shape[0], r.width
    if chain is None:
        with torch.no_grad():
            chain = tail_chain(r, invert(s2w), bundle, t)
    origin, dirs = rays(r, s2w)
    dirs_t = to_tiles(dirs, t)
    pid = pixel_of_tiles(h, w, t, dirs.device)
    n = bundle[0].shape[0]
    leaves = [x.detach().requires_grad_(loss is not None) for x in bundle]
    channels = torch.zeros((h * w, 9), device=dirs.device)
    accum = torch.zeros(n + 1, device=dirs.device)
    bg = background.to(dtype)
    for s in range(0, dirs_t.shape[0], block):
        sl = slice(s, s + block)
        with torch.set_grad_enabled(loss is not None):
            d = dirs_t[sl].to(dtype)
            o = origin.to(dtype)
            t0 = None
            tot = None
            ws = []
            for index, valid in chain:
                idx = index[sl].clamp(0, n - 1)
                sums, raw, wgt = composite(
                    d, o, *(x[idx].to(dtype) for x in leaves), valid[sl],
                    degree, t0)
                tot = sums if tot is None else tot + sums
                t0 = raw
                ws.append((index[sl], valid[sl], wgt))
            final_t = 1.0 - tot[..., 4:5]
            ch = torch.cat([tot[..., 0:3] + final_t * bg, tot[..., 3:8],
                            final_t], -1).float()
            real = pid[sl] >= 0
            ch_real, pid_real = ch[real], pid[sl][real]
            if loss is not None:
                loss(ch_real, pid_real).backward()
        with torch.no_grad():
            channels[pid_real] = ch_real.detach()
            for index, valid, wgt in ws:
                wsum = wgt.detach().float().sum(1)           # (B, K)
                accum.index_add_(0, torch.where(valid, index, n).reshape(-1),
                                 wsum.reshape(-1))
    grads = None
    if loss is not None:
        grads = [torch.zeros_like(x) if x.grad is None else x.grad
                 for x in leaves]
    return Render(channels.view(h, w, 9), accum[:n], grads)


def bench_loss(ch: Tensor, _pid: Tensor) -> Tensor:
    """The bench's loss: sum |depth| x 1e-3 + sum intensity^2."""
    return ch[:, 3].abs().sum() * 1e-3 + (ch[:, 0] ** 2).sum()


def depth_order_hits(bundle: list[Tensor], r: Raster, s2w: Tensor,
                     t: Tiling) -> int:
    """The pairs each image ray composites with no candidate budget: every
    surfel whose footprint meets the ray's tile, its gate-passing
    intersections in depth order, down to transmittance T_MIN.  Tile shape
    and budget do not change it (the footprint test is conservative)."""
    h, w = r.incl.shape[0], r.width
    means, quats, scales, opac, sh = (x.detach() for x in bundle)
    n = means.shape[0]
    every = t._replace(k=n, coarse_factor=1)
    index, valid, _, _ = bin_tiles(r, invert(s2w), means, scales, opac,
                                   quats, every)
    counts = valid.sum(1).tolist()
    origin, dirs = rays(r, s2w)
    dirs_t = to_tiles(dirs, t)
    real = pixel_of_tiles(h, w, t, dirs.device) >= 0
    hits = 0
    for tile, c in enumerate(counts):
        if c == 0:
            continue
        idx = index[tile, :c][None]
        rot = quat_matrix(quats[idx])
        w1, w2, nrm = rot[..., 0], rot[..., 1], rot[..., 2]
        omm = origin - means[idx]
        p = -(nrm * omm).sum(-1)
        d = dirs_t[tile][None]

        def dot(axis):
            return (d[..., :, None, 0] * axis[..., None, :, 0]
                    + d[..., :, None, 1] * axis[..., None, :, 1]
                    + d[..., :, None, 2] * axis[..., None, :, 2])

        qd = dot(nrm)
        safe = torch.where(qd.abs() > DENOM_EPS, qd,
                           torch.full_like(qd, DENOM_EPS))
        tt = p[:, None, :] / safe
        inv_s = 1.0 / scales[idx]
        u = ((w1 * omm).sum(-1)[:, None, :] + tt * dot(w1)) \
            * inv_s[:, None, :, 0]
        v = ((w2 * omm).sum(-1)[:, None, :] + tt * dot(w2)) \
            * inv_s[:, None, :, 1]
        alpha = (opac[idx][:, None, :] * torch.exp(-0.5 * (u * u + v * v))
                 ).clamp_max(ALPHA_MAX)
        ok = ((tt >= DEPTH_MIN) & (qd.abs() > DENOM_EPS)
              & (p[:, None, :] != 0) & (alpha >= ALPHA_MIN))
        order = torch.argsort(torch.where(ok, tt, torch.inf), dim=-1,
                              stable=True)
        a = torch.gather(torch.where(ok, alpha, 0.0), -1, order)
        live = torch.cumprod(
            (torch.cumprod(1.0 - a, -1) >= T_MIN).to(a.dtype), -1)
        hit = (live > 0) & (torch.gather(ok, -1, order))
        hits += int((hit[0] & real[tile][:, None]).sum())
    return hits
