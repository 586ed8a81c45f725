"""The binner's footprint overcount, decomposed (counterpart of the
reference's `scripts/overcount_probe.py:57-177`).

    python -m lidar_rt_tpu_torch.scripts.overcount_probe [--device cuda]

For every binned (tile, candidate) pair of the street scene, at each tile
shape of `SHAPES` with a K no tile fills (hier binner, coarse factor 4, no
snap cull):

  int_ok   the footprint's box, cut to the tile, holds an integer (row,
           column) raster sample;
  gate_ok  the candidate passes the kernel's alpha gate at one or more of
           the tile's rays: the truth the binner bounds.

It prints the binned pairs, the gate-passers (the true demand), what an
integer-sample test keeps, the residual overcount (int_ok & ~gate_ok: box
corners and the projection bound's slack), the exactness check gate_ok &
~int_ok (about 0: a gate pass outside the box would make the footprint
bound wrong) and the gate-passers among each tile's nearest 128
int-passing candidates.  Tiles are gated CHUNK at a time: at 8x128 K=2048
the bench's 168 tiles hold 352M pairs.

On the bench's scene some tiles overlap more candidates than these K
(the counts' `most_listed`, listed plus truncated, bounds a tile's
overlap), so each shape is then probed again, in rows the reference does
not print, with the "topk" binner (the same footprint box, listed
densely: where nothing truncates it lists the hier binner's pairs) at a K
above every tile's overlap: the overcount over every candidate.
"""

from __future__ import annotations

import torch

from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops.binning import (TileConfig, bin_surfels,
                                            footprint_bounds)
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street

Tensor = torch.Tensor

# (tile_h, tile_w, K): K at least the most any tile bins.
SHAPES = [(16, 32, 1024), (8, 128, 2048)]
CHUNK = 4
SELECT_K = 128


def tile_config(th: int, tw: int, k: int, binner: str = "hier"
                ) -> TileConfig:
    return TileConfig(tile_h=th, tile_w=tw, max_per_tile=k, binner=binner,
                      coarse_factor=4, sample_snap=False)


def int_sample_ok(fb, idx: Tensor, valid: Tensor, h: int, width: int,
                  tile: TileConfig) -> Tensor:
    """(T, K): does each listed candidate's footprint box, cut to its tile,
    hold an integer raster sample (with no slack)?"""
    row_lo, row_hi, col_c, col_half = fb[:4]
    dev = idx.device
    t_total = idx.shape[0]
    tiles_x = tile.num_tiles(h, width)[1]
    th, tw = tile.tile_h, tile.tile_w
    ty = torch.arange(t_total, device=dev) // tiles_x
    tx = torch.arange(t_total, device=dev) % tiles_x
    t_row_lo = (ty * th).to(torch.float32)[:, None]
    t_row_hi = ((ty + 1) * th).clamp_max(h).to(torch.float32)[:, None]
    rl, rh = row_lo[idx], row_hi[idx]
    int_row = (torch.floor(torch.minimum(rh, t_row_hi - 1.0))
               >= torch.ceil(torch.maximum(rl, t_row_lo)))
    first_col = (tx * tw).to(torch.float32)[:, None]
    o = torch.remainder(col_c[idx] - first_col, float(width))
    o = torch.where(o > width / 2.0, o - width, o)
    ch = col_half[idx]
    int_col = (torch.floor((o + ch).clamp_max(tw - 1.0))
               >= torch.ceil((o - ch).clamp_min(0.0)))
    return int_row & int_col & valid


def probe(bundle: SurfelBundle, grid, width: int, s2w: Tensor,
          tile: TileConfig, device="cuda") -> dict:
    """The overcount at one tile config: counts of binned, gate-passing and
    int-passing pairs, int & ~gate, gate & ~int, truncated overflow,
    gate-passers inside the nearest 128 int-passing candidates, and the
    most any tile lists plus truncates (`most_listed`)."""
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    h, n = grid.height, bundle.num_surfels
    w2s = transforms.invert_se3(s2w)
    with torch.no_grad():
        asn = bin_surfels(grid, width, w2s, bundle.means, bundle.scales,
                          bundle.opacities, tile, rotations=bundle.rotations)
        fb = footprint_bounds(grid, width, w2s, bundle.means, bundle.scales,
                              bundle.opacities, tile,
                              rotations=bundle.rotations)
        idx_c = asn.index.clamp(0, n - 1)
        int_ok = int_sample_ok(fb, idx_c, asn.valid, h, width, tile)
        frames, dirs_t = street.tile_rays(bundle, grid, width, s2w, tile)
        gate = torch.cat([
            street.tile_gate(frames, bundle, dirs_t[s:s + CHUNK],
                             idx_c[s:s + CHUNK],
                             asn.valid[s:s + CHUNK])[0].any(1)
            for s in range(0, idx_c.shape[0], CHUNK)])
        gate_ok = gate & asn.valid
        in_128 = (torch.cumsum(int_ok.to(torch.int64), 1) <= SELECT_K) \
            & gate_ok & int_ok
        counts = {
            "binned": asn.valid.sum(), "gate": gate_ok.sum(),
            "int": int_ok.sum(), "int_not_gate": (int_ok & ~gate_ok).sum(),
            "gate_not_int": (gate_ok & ~int_ok).sum(),
            "truncated": asn.truncated.sum(), "gate_in_128": in_128.sum(),
            "most_listed": (asn.valid.sum(1) + asn.truncated).max()}
    return {key: int(v) for key, v in counts.items()}


def untruncated_k(k: int, c: dict) -> int:
    """A K (a multiple of 128, at least k) above every tile's overlap, as
    `probe`'s counts `c` bound it."""
    return max(k, -(-c["most_listed"] // 128) * 128)


def lines(th: int, tw: int, k: int, n: int, t_total: int, c: dict,
          binner: str = "hier") -> list[str]:
    """The reference's printed lines (its header's seconds left out); for
    the topk binner, the same lines under a header that names it."""
    binned, gate, intk = c["binned"], c["gate"], c["int"]
    dense = " topk binner, every candidate" if binner == "topk" else ""
    return [
        f"--- tile {th}x{tw} K={k}{dense} (N={n}, {t_total} tiles)",
        f"binned pairs          {binned:9d}  (truncated {c['truncated']})",
        f"gate-passing (true)   {gate:9d}  ({gate / max(binned, 1):.3f})",
        f"int-sample test keeps {intk:9d}  ({intk / max(binned, 1):.3f})",
        f"residual overcount    {c['int_not_gate']:9d}  (int_ok & ~gate: "
        f"{c['int_not_gate'] / max(intk, 1):.3f} of kept)",
        f"EXACTNESS gate&~int   {c['gate_not_int']:9d}  (must be ~0)",
        f"gate-passers inside nearest-128 int-passing: {c['gate_in_128']} "
        f"of {gate} ({c['gate_in_128'] / max(gate, 1):.4f})"]


def main(argv=None) -> dict:
    a = street.parser("overcount_probe", __doc__).parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    out = {}
    for binner in ("hier", "topk"):
        for th, tw, k in SHAPES:
            if binner == "topk":
                k = untruncated_k(k, out[f"{th}x{tw} K={k}"])
            tile = tile_config(th, tw, k, binner)
            c = probe(bundle, grid, width, s2w, tile, a.device)
            t_total = tile.num_tiles(grid.height, width)
            for line in lines(th, tw, k, bundle.num_surfels,
                              t_total[0] * t_total[1], c, binner):
                print(line, flush=True)
            out[f"{th}x{tw} K={k}" + (" topk" if binner == "topk"
                                      else "")] = c
    return out


if __name__ == "__main__":
    main()
