"""Surfel -> range-image tile binning (counterpart of
`lidar_rt_tpu.ops.binning`).

Each surfel's center is projected into the raster and its angular footprint
bounded with the opacity-adaptive cutoff; per (tile_h x tile_w) tile the K
nearest overlapping surfels (by center range) are listed nearest-first.
That order is the compositing order, the sentinel index is N, and `valid`
is a prefix of each row.  Selection is exact (a stable sort).

Binners: "topk" scores a dense (T, N) overlap matrix; "hier" selects per
azimuth sector first (K_c = coarse_factor * K), then per row tile; "sort"
emits up to dup_rows x 2 dup_cols (tile, surfel) pairs per surfel and
groups them by one stable sort of (tile, quantized range) keys, so its
lists order near-equal ranges by surfel index.  All three take a per-tile
`min_range`, the re-binning half of tail re-tracing, and a column band
`col_offset`/`num_cols`, the unit of ray sharding (`parallel/`).  The hier
binner's optional macro-column level (`macro_cols`) pre-selects per wider
sector.  The reference's `approx_topk` is not ported: off a TPU,
`jax.lax.approx_max_k` falls back to an exact sort, as the port selects.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.ops import geometry

Tensor = torch.Tensor


@dataclass(frozen=True)
class TileConfig:
    """Static tiling parameters (fields as in the reference's TileConfig).

    dup_rows/dup_cols cap the row and column tiles a surfel is listed in
    by the "sort" binner (it loses its outermost tiles beyond them).
    pad_px pads every footprint (rebin-interval reuse); sample_snap culls
    surfels whose padded footprint holds no integer raster sample (margin
    snap_pad_px, default pad_px); int_overlap lists a (tile, surfel) pair
    only when footprint and tile share an integer sample, with int_eps
    slack, which must stay <= 0.5 to keep binners' lists supersets of the
    hit set.

    macro_cols (hier only; 0 = off): a macro level first keeps the
    nearest K_a = macro_factor * coarse K surfels per sector macro_cols
    wide, so that the per-tile-column stage scores (tiles_x, K_a) in
    place of (tiles_x, N); its overflow is counted in `truncated`.
    """

    tile_h: int = 32
    tile_w: int = 128
    max_per_tile: int = 512
    cutoff_eps: float = 0.01
    binner: str = "topk"
    dup_rows: int = 2
    dup_cols: int = 8
    coarse_factor: int = 8
    macro_cols: int = 0
    macro_factor: int = 4
    pad_px: float = 0.0
    sample_snap: bool = True
    snap_pad_px: float | None = None
    int_overlap: bool = True
    int_eps: float = 0.25

    def __post_init__(self):
        if self.binner not in ("topk", "hier", "sort"):
            raise ValueError(f"unknown binner {self.binner!r} "
                             "(the port has 'topk', 'hier' and 'sort')")
        if not 0.0 <= self.int_eps <= 0.5:
            raise ValueError("int_eps must lie in [0, 0.5]")

    def num_tiles(self, height: int, width: int) -> tuple[int, int]:
        """Tile counts with ceiling division."""
        return (-(-height // self.tile_h), -(-width // self.tile_w))


class TileAssignment(NamedTuple):
    """index (T, K) surfel ids (N = invalid sentinel), valid (T, K) prefix
    mask, nearest-first; truncated (T,) overflow counts."""

    index: Tensor
    valid: Tensor
    truncated: Tensor


def _int_row_overlap(row_lo, row_hi, t_lo, t_hi, eps: float):
    """Does [row_lo - eps, row_hi + eps] meet the tile's integer rows
    [t_lo, t_hi - 1] in an integer?"""
    return (torch.floor(torch.minimum(row_hi + eps, t_hi - 1.0))
            >= torch.ceil(torch.maximum(row_lo - eps, t_lo)))


def _int_col_overlap(o, col_half, tw: int, width: float, eps: float):
    """Integer-sample column overlap; o is the signed circular offset of the
    footprint center from the tile's first column, retested at +-width for
    intervals that wrap the azimuth seam."""
    ch = col_half + eps

    def hit(oo):
        return (torch.floor((oo + ch).clamp_max(tw - 1.0))
                >= torch.ceil((oo - ch).clamp_min(0.0)))

    return hit(o) | hit(o + width) | hit(o - width)


def _signed_col_offset(col_c, first_col, width: float):
    """Signed circular offset (-width/2, width/2] (floor-mod)."""
    o = torch.remainder(col_c - first_col, width)
    return torch.where(o > width / 2.0, o - width, o)


def _nearest(score: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Nearest-first K selection along the last axis: (values, indices).

    A stable sort, so equal ranges keep the lower index first, as the
    reference's `lax.top_k` does: scenes built from range images hold many
    exact range ties, and the tie order is the compositing order."""
    vals, idx = torch.sort(score, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def cutoff_radius(scales: Tensor, opacities: Tensor, eps: float) -> Tensor:
    """Opacity-adaptive splat support radius in world units, (N,)."""
    cut = torch.sqrt(2.0 * torch.log(
        (opacities * 255.0).clamp_min(1.0 + 1e-6)))
    return scales.amax(-1) * (cut + eps)


def sensor_points(world2sensor: Tensor, means: Tensor
                  ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Surfel centers in the sensor frame and their range: (px, py, pz,
    rng), each (N,).  The binner and the tail passes' range cutoff share
    it, so a cutoff equals its candidate's binned range bit for bit."""
    mx, my, mz = means.unbind(-1)
    r = world2sensor
    px = r[0, 0] * mx + r[0, 1] * my + r[0, 2] * mz + r[0, 3]
    py = r[1, 0] * mx + r[1, 1] * my + r[1, 2] * mz + r[1, 3]
    pz = r[2, 0] * mx + r[2, 1] * my + r[2, 2] * mz + r[2, 3]
    return px, py, pz, torch.sqrt(px * px + py * py + pz * pz)


def footprint_bounds(grid: rays_lib.SensorGrid, width: int,
                     world2sensor: Tensor, means: Tensor, scales: Tensor,
                     opacities: Tensor, cfg: TileConfig,
                     rotations: Tensor | None = None):
    """Per-surfel raster footprint: (row_lo, row_hi, col_c, col_half, rng,
    live).  With rotations (N, 4) the bound is the oriented disk's support
    along the elevation/azimuth tangents, else an isotropic sphere."""
    r = world2sensor
    px, py, pz, rng = sensor_points(world2sensor, means)
    horiz = torch.sqrt(px * px + py * py).clamp_min(1e-12)
    safe_rng = rng.clamp_min(geometry.DEPTH_MIN)
    incl = torch.atan2(pz, horiz)
    azim = torch.atan2(py, px)
    col_c = rays_lib.col_of_azimuth(grid, azim, width)

    cut = torch.sqrt(2.0 * torch.log((opacities * 255.0).clamp_min(
        1.0 + 1e-6))) + cfg.cutoff_eps
    if rotations is None:
        radius = scales.amax(-1) * cut
        ang_row = torch.atan2(radius, safe_rng)
        ang_col = ang_row
    else:
        inv_rng = 1.0 / safe_rng
        sin_i = pz * inv_rng
        cos_i = horiz * inv_rng
        inv_h = 1.0 / horiz
        sin_a = py * inv_h
        cos_a = px * inv_h

        qn = rotations / torch.linalg.vector_norm(
            rotations, dim=-1, keepdim=True).clamp_min(1e-12)
        qw, qx, qy, qz = qn.unbind(-1)
        c0x = 1.0 - 2.0 * (qy * qy + qz * qz)
        c0y = 2.0 * (qx * qy + qw * qz)
        c0z = 2.0 * (qx * qz - qw * qy)
        c1x = 2.0 * (qx * qy - qw * qz)
        c1y = 1.0 - 2.0 * (qx * qx + qz * qz)
        c1z = 2.0 * (qy * qz + qw * qx)

        e0 = scales[:, 0] * cut
        e1 = scales[:, 1] * cut
        s1x = e0 * (r[0, 0] * c0x + r[0, 1] * c0y + r[0, 2] * c0z)
        s1y = e0 * (r[1, 0] * c0x + r[1, 1] * c0y + r[1, 2] * c0z)
        s1z = e0 * (r[2, 0] * c0x + r[2, 1] * c0y + r[2, 2] * c0z)
        s2x = e1 * (r[0, 0] * c1x + r[0, 1] * c1y + r[0, 2] * c1z)
        s2y = e1 * (r[1, 0] * c1x + r[1, 1] * c1y + r[1, 2] * c1z)
        s2z = e1 * (r[2, 0] * c1x + r[2, 1] * c1y + r[2, 2] * c1z)

        def support(dx, dy, dz):
            d1 = s1x * dx + s1y * dy + s1z * dz
            d2 = s2x * dx + s2y * dy + s2z * dz
            return torch.sqrt(d1 * d1 + d2 * d2)

        # Nearest disk point along the view direction shortens the range.
        rng_eff = (safe_rng - support(cos_i * cos_a, cos_i * sin_a, sin_i)
                   ).clamp_min(geometry.DEPTH_MIN)
        ang_row = torch.atan2(support(-sin_i * cos_a, -sin_i * sin_a, cos_i),
                              rng_eff)
        ang_col = torch.atan2(support(-sin_a, cos_a, torch.zeros_like(sin_a)),
                              rng_eff)

    # Inclinations are monotone decreasing in row index.
    row_lo = rays_lib.row_of_inclination(grid, incl + ang_row) - cfg.pad_px
    row_hi = rays_lib.row_of_inclination(grid, incl - ang_row) + cfg.pad_px
    col_half = (ang_col / torch.cos(incl).clamp_min(1e-3)) \
        * (width / (2.0 * math.pi)) + cfg.pad_px
    col_half = col_half.clamp_max(width / 2.0)

    live = (opacities > geometry.ALPHA_MIN) & (rng > geometry.DEPTH_MIN)
    if cfg.sample_snap:
        d = 0.0 if cfg.snap_pad_px is None else cfg.pad_px - cfg.snap_pad_px
        has_row = (torch.floor((row_hi - d).clamp_max(grid.height - 1.0))
                   >= torch.ceil((row_lo + d).clamp_min(0.0)))
        has_col = (torch.floor(col_c + col_half - d)
                   >= torch.ceil(col_c - (col_half - d)))
        live = live & has_row & has_col
    return row_lo, row_hi, col_c, col_half, rng, live


def macro_candidates(cfg: TileConfig, g: int, m_total: int, k_a: int,
                      width: int, col_offset: int, col_c, col_half, rng,
                      live, sector_min=None) -> tuple[Tensor, Tensor, Tensor]:
    """The hier binner's macro level: per sector of g tile columns, the
    nearest k_a overlapping surfels as (M, k_a) indices, their validity
    and the (M,) overflow counts.  The overlap is the centre-distance test
    with a g * tile_w / 2 + 0.5 margin, with or without int_overlap; under
    min_range a sector keeps what its most permissive tile column may
    list (sector_min (tiles_x,), padded with +inf to M g)."""
    mx = torch.arange(m_total, dtype=torch.float32, device=rng.device)
    macro_c = torch.remainder(col_offset + (mx * g + g / 2.0) * cfg.tile_w,
                              float(width))
    dcol = (col_c[None, :] - macro_c[:, None]).abs()
    dcol = torch.minimum(dcol, width - dcol)               # azimuth wrap
    over = (dcol <= (col_half[None, :] + g * cfg.tile_w / 2.0 + 0.5)) \
        & live                                             # (M, N)
    if sector_min is not None:
        pad = m_total * g - sector_min.shape[0]
        macro_min = torch.nn.functional.pad(
            sector_min, (0, pad), value=torch.inf).view(m_total, g).amin(1)
        over = over & (rng[None, :] > macro_min[:, None])
    top, idx = _nearest(torch.where(over, rng, torch.inf), k_a)
    return idx, torch.isfinite(top), (over.sum(-1) - k_a).clamp_min(0)


def _pad_k(index: Tensor, valid: Tensor, k: int, n: int):
    """Pad (T, kk) selections to the configured K (tiny scenes)."""
    pad = k - index.shape[1]
    if pad == 0:
        return index, valid
    return (torch.nn.functional.pad(index, (0, pad), value=n),
            torch.nn.functional.pad(valid, (0, pad), value=False))


def bin_surfels(grid: rays_lib.SensorGrid, width: int, world2sensor: Tensor,
                means: Tensor, scales: Tensor, opacities: Tensor,
                cfg: TileConfig, rotations: Tensor | None = None,
                min_range: Tensor | None = None, col_offset: int = 0,
                num_cols: int | None = None) -> TileAssignment:
    """Assign surfels (N, 3 world) to tiles, row-major over (tiles_y,
    tiles_x): per-tile nearest-first candidate lists.  Binning is a
    visibility oracle: inputs are detached.

    min_range (T,): a tile lists only surfels with center range strictly
    above it (+inf lists none): tail re-tracing passes the range of each
    truncated tile's K-th candidate and gets ranks K+1, K+2, ...

    col_offset/num_cols bin only the column band [col_offset, col_offset +
    num_cols) of the full raster (modulo its width): tile x covers columns
    col_offset + [x tile_w, (x + 1) tile_w), and the band's last tile may
    reach into the next band."""
    means, scales, opacities = means.detach(), scales.detach(), \
        opacities.detach()
    rotations = None if rotations is None else rotations.detach()
    h = grid.height
    n = means.shape[0]
    dev = means.device
    num_cols = width if num_cols is None else num_cols
    tiles_y, tiles_x = cfg.num_tiles(h, num_cols)
    row_lo, row_hi, col_c, col_half, rng, live = footprint_bounds(
        grid, width, world2sensor.detach(), means, scales, opacities, cfg,
        rotations)
    if cfg.binner == "sort":
        return _select_sorted(cfg, h, width, col_offset, tiles_y, tiles_x,
                              row_lo, row_hi, col_c, col_half, rng, live,
                              min_range)

    tx = torch.arange(tiles_x, dtype=torch.float32, device=dev)
    ty = torch.arange(tiles_y, device=dev)
    # Floor-mod by W: a band's offset or its last tile may pass the seam.
    tile_col_c = torch.remainder(col_offset + (tx + 0.5) * cfg.tile_w,
                                 float(width))
    first_col = torch.remainder(col_offset + tx * cfg.tile_w, float(width))
    t_row_lo = (ty * cfg.tile_h).to(torch.float32)
    t_row_hi = ((ty + 1) * cfg.tile_h).clamp_max(h).to(torch.float32)

    def col_overlap_of(col_c_, col_half_):
        """(tiles_x, M) column overlap of footprints broadcast as (., M)."""
        if cfg.int_overlap:
            o = _signed_col_offset(col_c_, first_col[:, None], float(width))
            return _int_col_overlap(o, col_half_, cfg.tile_w, float(width),
                                    cfg.int_eps)
        dcol = (col_c_ - tile_col_c[:, None]).abs()
        dcol = torch.minimum(dcol, width - dcol)             # azimuth wrap
        return dcol <= (col_half_ + cfg.tile_w / 2.0 + 0.5)

    def row_overlap_of(lo, hi):
        """(tiles_y, ...) row overlap of footprint rows broadcast as lo/hi."""
        shape = (tiles_y,) + (1,) * (lo.dim() - 1)
        t_lo, t_hi = t_row_lo.view(shape), t_row_hi.view(shape)
        if cfg.int_overlap:
            return _int_row_overlap(lo, hi, t_lo, t_hi, cfg.int_eps)
        return (lo <= t_hi - 0.5) & (hi >= t_lo - 0.5)

    k = cfg.max_per_tile
    if cfg.binner == "topk":
        overlap = (row_overlap_of(row_lo[None], row_hi[None])[:, None, :]
                   & col_overlap_of(col_c[None], col_half[None])[None]
                   & live).reshape(tiles_y * tiles_x, n)
        if min_range is not None:
            overlap = overlap & (rng[None, :] > min_range[:, None])
        kk = min(k, n)
        top, idx = _nearest(torch.where(overlap, rng, torch.inf), kk)
        valid = torch.isfinite(top)
        index, valid = _pad_k(torch.where(valid, idx, n), valid, k, n)
        truncated = (overlap.sum(-1) - kk).clamp_min(0)
        return TileAssignment(index=index, valid=valid, truncated=truncated)

    # hier, stage 1: nearest K_c per azimuth sector, row extent ignored.
    # Under min_range a sector keeps what its most permissive row tile
    # may list: a candidate consumed by one row tile may still be rank
    # K+1 of a sibling.
    k_c = min(cfg.coarse_factor * k, n)
    sector_min = None
    if min_range is not None:
        min_range = min_range.reshape(tiles_y, tiles_x)
        sector_min = min_range.amin(0)                     # (tiles_x,)
    macro_trunc = 0
    if cfg.macro_cols > cfg.tile_w and cfg.macro_factor * k_c < n:
        # The macro level: nearest K_a per sector of g tile columns, then
        # each tile column selects over its parent's list.  A footprint
        # that meets a tile column meets its parent (the margins
        # telescope), so the level only adds its counted overflow.
        g = max(cfg.macro_cols // cfg.tile_w, 1)
        cand, cand_ok, macro_trunc = macro_candidates(
            cfg, g, -(-tiles_x // g), min(cfg.macro_factor * k_c, n), width,
            col_offset, col_c, col_half, rng, live, sector_min)
        parent = torch.arange(tiles_x, device=dev) // g
        cand, cand_ok = cand[parent], cand_ok[parent]      # (tiles_x, K_a)
        macro_trunc = macro_trunc[parent]
        rng_x = rng[cand]
        col_overlap = col_overlap_of(col_c[cand], col_half[cand]) & cand_ok
        if sector_min is not None:
            col_overlap = col_overlap & (rng_x > sector_min[:, None])
        k_c = min(k_c, cand.shape[1])
        # Ties keep the lower place in the parent's list.
        top_c, sel_c = _nearest(torch.where(col_overlap, rng_x, torch.inf),
                                k_c)
        idx_c = torch.gather(cand, 1, sel_c)
    else:
        col_overlap = col_overlap_of(col_c[None], col_half[None]) & live
        if sector_min is not None:
            col_overlap = col_overlap & (rng[None, :] > sector_min[:, None])
        top_c, idx_c = _nearest(torch.where(col_overlap, rng, torch.inf),
                                k_c)
    valid_c = torch.isfinite(top_c)                        # (tiles_x, K_c)
    coarse_trunc = (col_overlap.sum(-1) - k_c).clamp_min(0) + macro_trunc

    # Stage 2: row-tile refinement over the sector candidates.
    rng_c = rng[idx_c]
    row_ok = row_overlap_of(row_lo[idx_c][None], row_hi[idx_c][None]) \
        & valid_c                                          # (ty, tx, K_c)
    if min_range is not None:
        row_ok = row_ok & (rng_c[None] > min_range[:, :, None])
    kk = min(k, k_c)
    top, sel = _nearest(
        torch.where(row_ok, rng_c, torch.inf).reshape(-1, k_c), kk)
    valid = torch.isfinite(top)                            # (T, kk)
    idx_flat = idx_c.expand(tiles_y, tiles_x, k_c).reshape(-1, k_c)
    index = torch.where(valid, torch.gather(idx_flat, 1, sel), n)
    index, valid = _pad_k(index, valid, k, n)
    truncated = ((row_ok.sum(-1) - kk).clamp_min(0)
                 + coarse_trunc[None]).reshape(-1)
    return TileAssignment(index=index, valid=valid, truncated=truncated)


# The sort binner's key: tile id above an 18-bit range quantized over
# [0, 120) m (the reference's packing; the tile id takes 13 bits).
RANGE_BITS = 18
RANGE_MAX = 120.0
_INVALID_KEY = 2 ** 31 - 1


def _select_sorted(cfg: TileConfig, h: int, width: int, col_offset: int,
                   tiles_y: int, tiles_x: int, row_lo, row_hi, col_c,
                   col_half, rng, live, min_range=None) -> TileAssignment:
    """The "sort" binner: each surfel emits up to dup_rows x 2 dup_cols
    (tile, surfel) pairs (the second representation, shifted by the full
    width, covers a footprint across the azimuth seam); one stable sort of
    the packed (tile << RANGE_BITS | quantized range) keys groups the
    pairs by tile, nearest first, and each tile's list is gathered from
    its start offset.  The tile enumeration is a +-0.5 px superset of the
    topk binner's overlap test, filtered by that test."""
    n = rng.shape[0]
    dev = rng.device
    th, tw = cfg.tile_h, cfg.tile_w
    t_total = tiles_y * tiles_x
    k = cfg.max_per_tile
    fw = float(width)

    # Row tiles; the raw bounds stay unclipped for the validity test, so
    # an interval wholly above or below the raster lists nothing.
    ty_min_raw = torch.ceil((row_lo + 0.5) / th).to(torch.int32) - 1
    ty_max_raw = torch.floor((row_hi + 0.5) / th).to(torch.int32)
    ty_min = ty_min_raw.clamp(0, tiles_y - 1)
    ty_max = ty_max_raw.clamp_max(tiles_y - 1)

    # Column tiles: two representations, the second shifted by W.
    b = col_half + tw / 2.0 + 0.5
    u = torch.remainder(col_c - col_offset, fw)               # (N,)
    tx_min_u = torch.ceil((u - b) / tw - 0.5).to(torch.int32)
    tx_max_u = torch.floor((u + b) / tw - 0.5).to(torch.int32)
    tx_min_w = torch.ceil((u + width - b) / tw - 0.5).to(torch.int32)

    dy = torch.arange(cfg.dup_rows, device=dev).view(1, -1, 1, 1)
    dx = torch.arange(cfg.dup_cols, device=dev).view(1, 1, -1, 1)
    rep = torch.arange(2, device=dev).view(1, 1, 1, 2)

    def per_surfel(x):                                       # (N, 1, 1, 1)
        return x.view(-1, 1, 1, 1)

    ty_c = per_surfel(ty_min) + dy                           # (N, DR, 1, 1)
    tx_c = torch.stack([tx_min_u, tx_min_w], -1)[:, None, None, :] + dx
    # Seam dedup: the shifted representation must stay past the first.
    rep_ok = (rep == 0) | (tx_c > per_surfel(tx_max_u))
    row_ok = (ty_c <= per_surfel(ty_max)) & (ty_c >= per_surfel(ty_min_raw))
    col_in = (tx_c >= 0) & (tx_c < tiles_x)
    # The exact circular-distance test (caps and clips add no pair).
    tile_cc = torch.remainder(col_offset + (tx_c.to(torch.float32) + 0.5)
                              * tw, fw)
    dcol = (per_surfel(col_c) - tile_cc).abs()
    dcol = torch.minimum(dcol, width - dcol)
    col_ok = dcol <= (per_surfel(col_half) + tw / 2.0 + 0.5)
    if cfg.int_overlap:
        t_lo = (ty_c * th).to(torch.float32)
        t_hi = ((ty_c + 1) * th).clamp_max(h).to(torch.float32)
        row_ok = row_ok & _int_row_overlap(per_surfel(row_lo),
                                           per_surfel(row_hi), t_lo, t_hi,
                                           cfg.int_eps)
        fc = torch.remainder(col_offset + tx_c.to(torch.float32) * tw, fw)
        o = _signed_col_offset(per_surfel(col_c), fc, fw)
        col_ok = col_ok & _int_col_overlap(o, per_surfel(col_half), tw, fw,
                                           cfg.int_eps)

    valid = row_ok & col_in & col_ok & rep_ok & per_surfel(live)
    tile_id = (ty_c.clamp(0, tiles_y - 1) * tiles_x
               + tx_c.clamp(0, tiles_x - 1))                 # (N, DR, DC, 2)
    if min_range is not None:
        valid = valid & (per_surfel(rng) > min_range[tile_id])

    qrange = (rng / RANGE_MAX * (1 << RANGE_BITS)).clamp(
        0, (1 << RANGE_BITS) - 1).to(torch.int32)
    key = torch.where(valid, (tile_id << RANGE_BITS) | per_surfel(qrange),
                      _INVALID_KEY).reshape(-1)
    key_sorted, order = torch.sort(key, stable=True)
    surf_sorted = order // (cfg.dup_rows * cfg.dup_cols * 2)
    starts = torch.searchsorted(
        key_sorted >> RANGE_BITS,
        torch.arange(t_total + 1, dtype=key_sorted.dtype, device=dev))
    slots = starts[:-1, None] + torch.arange(k, device=dev)  # (T, K)
    valid_tk = slots < starts[1:, None]
    index = torch.where(valid_tk,
                        surf_sorted[slots.clamp(0, surf_sorted.numel() - 1)],
                        n)
    truncated = (starts[1:] - starts[:-1] - k).clamp_min(0)
    return TileAssignment(index=index, valid=valid_tk, truncated=truncated)
