"""The binner's stage costs and candidate demand (counterpart of the
reference's `scripts/profile_binner.py:32-109`).

    python -m lidar_rt_tpu_torch.scripts.profile_binner [--device cuda]

Times `footprint_bounds` alone and `bin_surfels` for each config of
`CONFIGS` on the street scene (device ms over ITERS back-to-back calls:
CUDA events on the card), and prints per config the candidates per tile
(mean, p95, max) and the truncated tiles (count, total overflow): the
data that decides how small tile_h x K can go before truncation hurts.
The reference's `m1024` row runs its macro-column stage, a TPU layout
stage the port does not have (`macro_cols`, on the do-not-port list): its
line says so.  Selection is exact, as the reference's `approx_topk` is
off a TPU.  A config that fails raises.
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops.binning import (TileConfig, bin_surfels,
                                            footprint_bounds)
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street

Tensor = torch.Tensor

ITERS = 20
# (label, tile_h, tile_w, K, binner, coarse factor, macro_cols)
CONFIGS = [
    ("hier  8x128 K256 cf8", 8, 128, 256, "hier", 8, 0),
    ("hier  8x128 K256 cf4", 8, 128, 256, "hier", 4, 0),
    ("hier  8x128 K256 cf8 m1024", 8, 128, 256, "hier", 8, 1024),
    ("hier  4x128 K128 cf8", 4, 128, 128, "hier", 8, 0),
    ("hier  4x128 K256 cf8", 4, 128, 256, "hier", 8, 0),
    ("hier  2x128 K128 cf8", 2, 128, 128, "hier", 8, 0),
    ("hier  1x128 K128 cf8", 1, 128, 128, "hier", 8, 0),
    ("sort  8x128 K256", 8, 128, 256, "sort", 8, 0),
]
FLAGSHIP = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier")


def profile(bundle: SurfelBundle, grid, width: int, s2w: Tensor,
            device="cuda", iters: int = ITERS) -> dict:
    """{"footprint_ms": ms, label: {"ms", "counts" (T,), "truncated" (T,)}
    or None for a config the port does not have}."""
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    w2s = transforms.invert_se3(s2w)
    args = (grid, width, w2s, bundle.means, bundle.scales, bundle.opacities)
    rot = bundle.rotations
    out = {}
    with torch.no_grad():
        out["footprint_ms"] = street.device_ms(
            lambda: footprint_bounds(*args, FLAGSHIP, rotations=rot), iters,
            device)
        for label, th, tw, k, binner, cf, macro in CONFIGS:
            if macro:
                out[label] = None
                continue
            cfg = TileConfig(tile_h=th, tile_w=tw, max_per_tile=k,
                             binner=binner, coarse_factor=cf)
            ms = street.device_ms(
                lambda cfg=cfg: bin_surfels(*args, cfg, rotations=rot),
                iters, device)
            a = bin_surfels(*args, cfg, rotations=rot)
            out[label] = {"ms": ms,
                          "counts": a.valid.sum(1).cpu().numpy(),
                          "truncated": a.truncated.cpu().numpy()}
    return out


def lines(r: dict) -> list[str]:
    """The reference's lines, its labels and formats."""
    out = [f"footprint_bounds            {r['footprint_ms']:7.2f} ms"]
    for label, c in r.items():
        if label == "footprint_ms":
            continue
        if c is None:
            out.append(f"{label:28s} not ported (macro_cols: a TPU stage "
                       "on the do-not-port list)")
            continue
        cnt, trunc = c["counts"], c["truncated"]
        out.append(f"{label:28s} {c['ms']:7.2f} ms   cand/tile mean "
                   f"{cnt.mean():6.1f} p95 {np.percentile(cnt, 95):6.0f} max "
                   f"{cnt.max():5d}   trunc tiles {int((trunc > 0).sum()):4d}"
                   f" sum {int(trunc.sum()):7d}")
    return out


def main(argv=None) -> dict:
    a = street.parser("profile_binner", __doc__).parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    r = profile(bundle, grid, width, s2w, a.device)
    for line in lines(r):
        print(line, flush=True)
    return r


if __name__ == "__main__":
    main()
