"""Per-ray survivor statistics on the street scene (counterpart of the
reference's `scripts/survivor_stats.py:45-289`).

    python -m lidar_rt_tpu_torch.scripts.survivor_stats [--device cuda]

At the flagship tile (8x128, K=256, hier binner) it measures how many of
each ray's K candidates matter:

  n_alpha  pairs passing every alpha gate (the pairs that carry weight or
           gradient at all);
  n_live   pairs with nonzero weight when composited in depth order,
           front to back, with the T_MIN stop;

then the unique gate-passers per tile row (1x128) and per tile (the K a
tile really needs), the binner's box footprint and an ellipse slice of it
per (pixel row, 128-column sector), and the binned candidates per 8x128
tile with no K cap, with the integer-sample snap cull off and on.  These
decide whether a compacted candidate axis (sorting survivors first) or a
smaller K pays.  The selection is exact, as the reference's
`approx_topk` is off a TPU.  The reference's scan pads the tile count to
its batch of 8 with copies of tile 0; the bench's 168 tiles need none, and
the port does not pad.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops import geometry
from lidar_rt_tpu_torch.ops.binning import (TileConfig, bin_surfels,
                                            footprint_bounds)
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street

TILE = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier")
CHUNK = 8          # tiles a step, as the reference's scan
SURFEL_CHUNK = 8192

Tensor = torch.Tensor


def _tile_binned_counts(fb, h: int, width: int, tile: TileConfig
                        ) -> Tensor:
    """Per-tile binned candidates under the box footprint, no K cap, (T,)."""
    row_lo, row_hi, col_c, col_half, _rng, live = fb
    dev = row_lo.device
    tiles_y, tiles_x = tile.num_tiles(h, width)
    th, tw = tile.tile_h, tile.tile_w
    ty = torch.arange(tiles_y, dtype=torch.float32, device=dev)
    t_row_lo = ty * th
    t_row_hi = ((ty + 1) * th).clamp_max(h)
    sec_c = torch.arange(tiles_x, dtype=torch.float32, device=dev) * tw \
        + tw / 2.0
    counts = torch.zeros(tiles_y, tiles_x, dtype=torch.int64, device=dev)
    for s in range(0, row_lo.shape[0], SURFEL_CHUNK):
        rl, rh, cc, ch, lv = (x[s:s + SURFEL_CHUNK] for x in
                              (row_lo, row_hi, col_c, col_half, live))
        row_in = ((rl[None] <= t_row_hi[:, None] - 0.5)
                  & (rh[None] >= t_row_lo[:, None] - 0.5))    # (TY, C)
        d = (torch.remainder(cc[None] - sec_c[:, None] + width / 2.0,
                             float(width)) - width / 2.0).abs()
        col_in = d <= (ch[None] + tw / 2.0 + 0.5)             # (TX, C)
        counts += (row_in[:, None] & col_in[None] & lv).sum(-1)
    return counts.reshape(-1)


def _footprint_row_counts(fb, h: int, width: int, tile: TileConfig
                          ) -> tuple[Tensor, Tensor]:
    """Per (128-column sector, pixel row) candidates under the box
    footprint and under its ellipse slice (the azimuth half-width shrunk by
    the row's offset from the footprint's centre row), each (TX, H)."""
    row_lo, row_hi, col_c, col_half, _rng, live = fb
    dev = row_lo.device
    tiles_x = tile.num_tiles(h, width)[1]
    tw = tile.tile_w
    rows = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    sec_c = torch.arange(tiles_x, dtype=torch.float32, device=dev) * tw \
        + tw / 2.0
    box = torch.zeros(tiles_x, h, dtype=torch.int64, device=dev)
    ell = torch.zeros_like(box)
    for s in range(0, row_lo.shape[0], SURFEL_CHUNK):
        rl, rh, cc, ch, lv = (x[s:s + SURFEL_CHUNK] for x in
                              (row_lo, row_hi, col_c, col_half, live))
        row_in = (rows >= rl[None]) & (rows <= rh[None])      # (H, C)
        rc = 0.5 * (rl + rh)
        rhalf = (0.5 * (rh - rl)).clamp_min(1e-6)
        frac = ((rows - rc[None]) / rhalf[None]).clamp(-1.0, 1.0)
        ch_row = ch[None] * torch.sqrt((1.0 - frac * frac).clamp_min(0.0))
        d = (torch.remainder(cc[None] - sec_c[:, None] + width / 2.0,
                             float(width)) - width / 2.0).abs()  # (TX, C)
        col_in_box = d <= (ch[None] + tw / 2.0)
        col_in_ell = d[:, None] <= ch_row[None] + tw / 2.0    # (TX, H, C)
        box += (row_in[None] & col_in_box[:, None] & lv).sum(-1)
        ell += (row_in[None] & col_in_ell & lv).sum(-1)
    return box, ell


def stats(bundle: SurfelBundle, grid, width: int, s2w: Tensor,
          tile: TileConfig = TILE, device="cuda") -> dict:
    """The survivor statistics at `tile`: histograms (index = count, length
    K + 1) of n_alpha and n_live per ray, unique gate-passers per tile row
    and per tile; the row-sector box and ellipse counts, (TX * H,); the
    per-tile binned counts with the snap cull off and on, (T,)."""
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    h, n, k = grid.height, bundle.num_surfels, tile.max_per_tile
    th, tw = tile.tile_h, tile.tile_w
    w2s = transforms.invert_se3(s2w)
    a = bin_surfels(grid, width, w2s, bundle.means, bundle.scales,
                    bundle.opacities, tile, rotations=bundle.rotations)
    frames, dirs_t = street.tile_rays(bundle, grid, width, s2w, tile)
    idx_c = a.index.clamp(0, n - 1)
    hists = {key: torch.zeros(k + 1, dtype=torch.int64, device=device)
             for key in ("n_alpha", "n_live", "n_row_true", "n_tile_true")}
    with torch.no_grad():
        for s in range(0, idx_c.shape[0], CHUNK):
            sl = slice(s, s + CHUNK)
            ok, alpha_raw, t = street.tile_gate(frames, bundle, dirs_t[sl],
                                                idx_c[sl], a.valid[sl])
            alpha = torch.where(ok, alpha_raw, 0.0)
            order = torch.argsort(torch.where(ok, t, torch.inf), dim=-1,
                                  stable=True)
            alpha_o = torch.gather(alpha, -1, order)
            t_excl = torch.cumprod(1.0 - alpha_o, dim=-1) \
                / (1.0 - alpha_o).clamp_min(1e-12)
            live = (t_excl >= geometry.T_MIN) & (alpha_o > 0.0)
            b = ok.shape[0]
            counts = {
                "n_alpha": ok.sum(-1),
                "n_live": live.sum(-1),
                "n_row_true": ok.reshape(b, th, tw, k).any(2).sum(-1),
                "n_tile_true": ok.any(1).sum(-1)}
            for key, c in counts.items():
                hists[key] += torch.bincount(c.reshape(-1), minlength=k + 1)
        fb = footprint_bounds(grid, width, w2s, bundle.means, bundle.scales,
                              bundle.opacities, tile,
                              rotations=bundle.rotations)
        box, ell = _footprint_row_counts(fb, h, width, tile)
        binned = {}
        for snap in (False, True):
            fb_s = footprint_bounds(
                grid, width, w2s, bundle.means, bundle.scales,
                bundle.opacities, dataclasses.replace(tile, sample_snap=snap),
                rotations=bundle.rotations)
            binned[snap] = _tile_binned_counts(fb_s, h, width, tile)
    out = {key: v.cpu().numpy() for key, v in hists.items()}
    out.update(box=box.cpu().numpy().ravel(), ell=ell.cpu().numpy().ravel(),
               tiles_snap_off=binned[False].cpu().numpy(),
               tiles_snap_on=binned[True].cpu().numpy())
    return out


def lines(s: dict) -> list[str]:
    """The reference's printed statistics, its labels and formats."""
    out = []

    def describe(name, h):
        d = street.hist_summary(h)
        pct, over = d["pct"], d["over"]
        out.append(f"{name}: mean {d['mean']:.1f}  p50 {pct[50]}  p90 "
                   f"{pct[90]}  p99 {pct[99]}  p99.9 {pct[99.9]}  max "
                   f"{d['max']}")
        out.append(f"  fraction of rays over 32/64/128: {over[32]:.4f} / "
                   f"{over[64]:.4f} / {over[128]:.4f}")

    def describe_arr(name, v):
        out.append(f"{name}: mean {v.mean():.1f}  p50 "
                   f"{np.percentile(v, 50):.0f}  p90 "
                   f"{np.percentile(v, 90):.0f}  p99 "
                   f"{np.percentile(v, 99):.0f}  max {v.max()}  frac>128 "
                   f"{np.mean(v > 128):.4f}  frac>192 {np.mean(v > 192):.4f}")

    def describe_tiles(name, v):
        out.append(f"{name}: mean {v.mean():.1f}  p50 "
                   f"{np.percentile(v, 50):.0f}  p90 "
                   f"{np.percentile(v, 90):.0f}  p99 "
                   f"{np.percentile(v, 99):.0f}  max {v.max()}  frac<=128 "
                   f"{np.mean(v <= 128):.4f}  frac<=256 "
                   f"{np.mean(v <= 256):.4f}")

    describe("n_alpha (gate-passing pairs/ray)   ", s["n_alpha"])
    describe("n_live  (depth-ordered live pairs) ", s["n_live"])
    describe("n_row_true (unique gate-passing per 1x128 row, of tile's K)",
             s["n_row_true"])
    describe_arr("row-sector BOX footprint count    ", s["box"])
    describe_arr("row-sector ELLIPSE-slice count    ", s["ell"])
    describe("n_tile_true (unique gate-passing per 8x128 TILE, of its K)",
             s["n_tile_true"])
    off, on = s["tiles_snap_off"], s["tiles_snap_on"]
    describe_tiles("8x128-tile binned count, snap OFF", off)
    describe_tiles("8x128-tile binned count, snap ON ", on)
    out.append(f"snap cull: binned pairs {off.sum()} -> {on.sum()} "
               f"({on.sum() / max(off.sum(), 1):.3f}x)")
    return out


def main(argv=None) -> dict:
    a = street.parser("survivor_stats", __doc__).parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    s = stats(bundle, grid, width, s2w, TILE, a.device)
    print(f"({int(s['n_alpha'].sum())} rays incl. tile padding)")
    for line in lines(s):
        print(line, flush=True)
    return s


if __name__ == "__main__":
    main()
