"""The occlusion cull's design data on the street scene (counterpart of the
reference's `scripts/occlusion_stats.py`).

    python -m lidar_rt_tpu_torch.scripts.occlusion_stats [--device cuda]

A ray stops mattering past the depth where its transmittance crosses T_MIN
(its latch).  A candidate whose conservative near range (centre range less
the opacity-adaptive cutoff radius) lies past every ray of a tile's latch,
plus MARGIN, gives no weight and no gradient there, so the binner could
cull it; if the demand after the cull fits, the budget could drop from
K=256 to K=128.  It prints the share of rays that latch and their latch
depths; at the flagship 8x128 tile (K=256), the share of tiles with a
finite bound and the unique gate-passers of the selected K per tile
before and after the cull; and per tile height 8, 4 and 2 (x 128) the
binned candidates per tile (box footprint, no K cap) before and after it.

Each tile's bound is the largest latch over its rays on the padded raster
(rows clamp-padded, columns wrapped), as the reference bounds the 8x128
tiles.  The reference reshapes the cropped H x W latch image into
128-column tiles for the per-height counts, which a width no multiple of
128 (the bench's 2650) cannot do; the port bounds those tiles on the
padded raster too, which equals the reference wherever the width is a
multiple of 128.  The per-height counts are taken in float64 where the
reference's numpy takes them so.  Where no ray latches, the latch depths
line says so (the reference's percentile of no rays raises).
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops import geometry
from lidar_rt_tpu_torch.ops.binning import (TileConfig, bin_surfels,
                                            cutoff_radius, footprint_bounds,
                                            sensor_points)
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street

Tensor = torch.Tensor

TILE = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier")
MARGIN = 0.5       # metres added to the latch bound (staleness headroom)
TILE_HEIGHTS = (8, 4, 2)
CHUNK = 8
SURFEL_CHUNK = 16384


def _latch(ok: Tensor, alpha_raw: Tensor, t: Tensor) -> Tensor:
    """Per ray (B, R): the depth of the first gated hit, in depth order,
    after which the transmittance is below T_MIN (+inf if none)."""
    alpha = torch.where(ok, alpha_raw, 0.0)
    order = torch.argsort(torch.where(ok, t, torch.inf), dim=-1, stable=True)
    alpha_o = torch.gather(alpha, -1, order)
    t_o = torch.gather(t, -1, order)
    t_excl = torch.cumprod(1.0 - alpha_o, dim=-1) \
        / (1.0 - alpha_o).clamp_min(1e-12)
    latched = (alpha_o > 0.0) & (t_excl * (1.0 - alpha_o) < geometry.T_MIN)
    return torch.where(latched, t_o, torch.inf).amin(-1)


def stats(bundle: SurfelBundle, grid, width: int, s2w: Tensor,
          tile: TileConfig = TILE, device="cuda") -> dict:
    """The latch image (H, W), the per-tile demand before and after the
    cull and its finite-bound share at `tile`, and per tile height the
    binned counts before and after the cull (numpy arrays)."""
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    h, n, k = grid.height, bundle.num_surfels, tile.max_per_tile
    th, tw = tile.tile_h, tile.tile_w
    tiles_y, tiles_x = tile.num_tiles(h, width)
    w2s = transforms.invert_se3(s2w)
    with torch.no_grad():
        a = bin_surfels(grid, width, w2s, bundle.means, bundle.scales,
                        bundle.opacities, tile, rotations=bundle.rotations)
        frames, dirs_t = street.tile_rays(bundle, grid, width, s2w, tile)
        idx_c = a.index.clamp(0, n - 1)
        near = sensor_points(w2s, bundle.means)[3] - cutoff_radius(
            bundle.scales, bundle.opacities, tile.cutoff_eps)
        latch, gate_any = [], []
        for s in range(0, idx_c.shape[0], CHUNK):
            sl = slice(s, s + CHUNK)
            ok, alpha_raw, t = street.tile_gate(frames, bundle, dirs_t[sl],
                                                idx_c[sl], a.valid[sl])
            latch.append(_latch(ok, alpha_raw, t))
            gate_any.append(ok.any(1))
        latch, gate_any = torch.cat(latch), torch.cat(gate_any)   # (T, R/K)
        lb_tile = latch.amax(1) + MARGIN
        keep = near[idx_c] <= lb_tile[:, None]
        latch_full = latch.reshape(tiles_y, tiles_x, th, tw) \
            .permute(0, 2, 1, 3).reshape(tiles_y * th, tiles_x * tw)

        row_lo, row_hi, col_c, col_half, rng, live = footprint_bounds(
            grid, width, w2s, bundle.means, bundle.scales, bundle.opacities,
            tile, rotations=bundle.rotations)
        near_all = rng - cutoff_radius(bundle.scales, bundle.opacities,
                                       tile.cutoff_eps)
        col_in_half = (col_half + (tw / 2.0 + 0.5)).double()
        binned = {}
        for th2 in TILE_HEIGHTS:
            ty2 = h // th2
            lb = latch_full[:ty2 * th2].reshape(ty2, th2, tiles_x, tw) \
                .amax((1, 3)) + MARGIN                         # (ty2, TX)
            t_row_lo = torch.arange(ty2, dtype=torch.float64,
                                    device=device) * th2
            t_row_hi = (t_row_lo + th2).clamp_max(h)
            sec_c = torch.arange(tiles_x, dtype=torch.float64,
                                 device=device) * tw + tw / 2.0
            pre = torch.zeros(ty2, tiles_x, dtype=torch.int64, device=device)
            post = torch.zeros_like(pre)
            for s in range(0, n, SURFEL_CHUNK):
                sl = slice(s, s + SURFEL_CHUNK)
                row_in = ((row_lo[sl].double()[None] <= t_row_hi[:, None]
                           - 0.5)
                          & (row_hi[sl].double()[None] >= t_row_lo[:, None]
                             - 0.5))
                d = (torch.remainder(col_c[sl].double()[None]
                                     - sec_c[:, None] + width / 2.0,
                                     float(width)) - width / 2.0).abs()
                col_in = d <= col_in_half[sl][None]
                ov = row_in[:, None] & col_in[None] & live[sl]
                pre += ov.sum(-1)
                post += (ov & (near_all[sl] <= lb[:, :, None])).sum(-1)
            binned[th2] = {"pre": pre.cpu().numpy().ravel(),
                           "post": post.cpu().numpy().ravel(),
                           "finite": float(torch.isfinite(lb).float().mean())}
    return {"latch_img": latch_full[:h, :width].cpu().numpy(),
            "finite": float(torch.isfinite(lb_tile).float().mean()),
            "demand_pre": gate_any.sum(1).cpu().numpy(),
            "demand_post": (gate_any & keep).sum(1).cpu().numpy(),
            "binned": binned}


def lines(s: dict) -> list[str]:
    """The reference's printed lines (its timing line left out)."""
    out = []
    img = s["latch_img"]
    sat = np.isfinite(img)
    out.append(f"saturated rays: {sat.mean():.3f}  " + (
        f"latch depth p50 {np.median(img[sat]):.1f} m  p90 "
        f"{np.percentile(img[sat], 90):.1f} m" if sat.any() else
        "latch depth: no ray reaches T_MIN"))
    out.append(f"8x128 tiles: finite latch bound on {s['finite']:.3f} of "
               f"tiles")

    def describe(name, v):
        out.append(f"{name}: mean {v.mean():.1f}  p50 "
                   f"{np.percentile(v, 50):.0f}  p90 "
                   f"{np.percentile(v, 90):.0f}  p99 "
                   f"{np.percentile(v, 99):.0f}  max {v.max()}  frac<=128 "
                   f"{np.mean(v <= 128):.4f}")

    describe("unique gate-passers / tile, pre-cull ", s["demand_pre"])
    describe("unique gate-passers / tile, post-cull", s["demand_post"])
    for th2, b in s["binned"].items():
        pre, post = b["pre"], b["post"]
        out.append(f"{th2}x128 tiles (finite bound {b['finite']:.3f}):")
        describe("  binned/tile pre-cull ", pre)
        describe("  binned/tile post-cull", post)
        out.append(f"  total binned pairs {pre.sum()} -> {post.sum()} "
                   f"({post.sum() / max(pre.sum(), 1):.3f}x)")
    return out


def main(argv=None) -> dict:
    a = street.parser("occlusion_stats", __doc__).parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    s = stats(bundle, grid, width, s2w, TILE, a.device)
    for line in lines(s):
        print(line, flush=True)
    return s


if __name__ == "__main__":
    main()
