"""Render fidelity of a K=128 budget under three candidate-selection rules
(counterpart of the reference's `scripts/selection_probe.py:55-196`).

    python -m lidar_rt_tpu_torch.scripts.selection_probe [--device cuda]

Per 16x32 tile (hier binner, coarse factor 4, no snap cull) the tile's
rays are composited, in tile order, against:

  truth  all binned candidates (K=1024, nearest first);
  A      the nearest 128 of the binned list (the binner's own cut);
  B      the nearest 128 that pass the integer-sample overlap test;
  C      the nearest 128 true gate-passers (an oracle footprint: the best
         any footprint-based selection at this K can do);

and each rule's per-ray depth error against the truth (where the truth's
weight exceeds 0.5) and per-tile captured weight are printed.  If C
matches the truth and A does not, selection is the 16x32 K=128 quality
gap; if C misses too, the demand is real and only a larger budget (tail
passes, a larger K) closes it.  Tiles are composited CHUNK at a time (the
bench's 332 tiles hold 174M pairs).
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops import geometry
from lidar_rt_tpu_torch.ops.binning import (TileConfig, bin_surfels,
                                            footprint_bounds)
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import overcount_probe, street

Tensor = torch.Tensor

TH, TW = 16, 32
K_FULL = 1024
K_SEL = 128
RULES = ("A nearest-binned", "B int-sample", "C gate-oracle")
TILE = overcount_probe.tile_config(TH, TW, K_FULL)
CHUNK = 4


def _composite(alpha: Tensor, t: Tensor, sel: Tensor
               ) -> tuple[Tensor, Tensor]:
    """Tile-order compositing of (B, R, K) pairs restricted to sel (B, K):
    per ray (B, R) the weighted depth sum and the weight sum."""
    a = torch.where(sel[:, None, :], alpha, 0.0)
    one_m = 1.0 - a
    t_excl = torch.cumprod(one_m, dim=-1) / one_m
    live = t_excl * one_m >= geometry.T_MIN
    w = a * t_excl * live
    return (w * t).sum(-1), w.sum(-1)


def probe(bundle: SurfelBundle, grid, width: int, s2w: Tensor,
          tile: TileConfig = TILE, device="cuda") -> dict:
    """Per rule: the depth errors (rays where the truth's weight > 0.5)
    and the per-tile weight capture; the truth's truncated overflow."""
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    h, n = grid.height, bundle.num_surfels
    w2s = transforms.invert_se3(s2w)
    derr = {r: [] for r in RULES}
    wcap = {r: [] for r in RULES}
    with torch.no_grad():
        asn = bin_surfels(grid, width, w2s, bundle.means, bundle.scales,
                          bundle.opacities, tile, rotations=bundle.rotations)
        fb = footprint_bounds(grid, width, w2s, bundle.means, bundle.scales,
                              bundle.opacities, tile,
                              rotations=bundle.rotations)
        idx_c = asn.index.clamp(0, n - 1)
        int_ok = overcount_probe.int_sample_ok(fb, idx_c, asn.valid, h,
                                               width, tile)
        frames, dirs_t = street.tile_rays(bundle, grid, width, s2w, tile)
        for s in range(0, idx_c.shape[0], CHUNK):
            sl = slice(s, s + CHUNK)
            valid, iok = asn.valid[sl], int_ok[sl]
            ok, alpha_raw, t = street.tile_gate(frames, bundle, dirs_t[sl],
                                                idx_c[sl], valid)
            alpha = torch.where(ok, alpha_raw, 0.0)
            gate = ok.any(1)
            d_t, w_t = _composite(alpha, t, valid)
            m = w_t > 0.5
            for rule, keep in zip(RULES, (valid, iok, gate)):
                sel = keep & (torch.cumsum(keep.to(torch.int64), 1) <= K_SEL)
                d, wsum = _composite(alpha, t, sel)
                e = (d / w_t.clamp_min(1e-6) - d_t / w_t.clamp_min(1e-6)
                     ).abs()
                derr[rule].append(e[m])
                wcap[rule].append(wsum.sum(-1)
                                  / w_t.sum(-1).clamp_min(1e-6))
    return {"derr": {r: torch.cat(v).cpu().numpy() for r, v in derr.items()},
            "wcap": {r: torch.cat(v).cpu().numpy() for r, v in wcap.items()},
            "truncated": int(asn.truncated.sum())}


def lines(r: dict, n: int) -> list[str]:
    """The reference's printed lines (its seconds left out)."""
    out = [f"tile {TH}x{TW} truth-K={K_FULL} sel-K={K_SEL} N={n} (truth "
           f"truncated {r['truncated']})"]
    for rule in RULES:
        e, wc = r["derr"][rule], r["wcap"][rule]
        out.append(f"{rule:18s} depth err vs truth: mean {e.mean():.4f}  "
                   f"p90 {np.percentile(e, 90):.4f}  p99 "
                   f"{np.percentile(e, 99):.4f}  max {e.max():.3f}  | "
                   f"weight capture mean {wc.mean():.4f} min {wc.min():.4f}")
    return out


def main(argv=None) -> dict:
    a = street.parser("selection_probe", __doc__).parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    r = probe(bundle, grid, width, s2w, TILE, a.device)
    for line in lines(r, bundle.num_surfels):
        print(line, flush=True)
    return r


if __name__ == "__main__":
    main()
