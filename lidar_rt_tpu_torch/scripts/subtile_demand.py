"""True per-sub-tile gate demand on the street scene (counterpart of the
reference's `scripts/subtile_demand.py:33-134`).

    python -m lidar_rt_tpu_torch.scripts.subtile_demand [--device cuda]

For each sub-tile shape of the flagship 8x128 tile (`SHAPES`), the unique
gate-passing candidates, of the tile's selected K=256, in each sub-tile:
the budget a kernel tiled at that shape needs.  A kernel's pairs a ray
are its K, so the smallest shape whose p99.9 demand fits K=128 halves both
kernels against K=256.
"""

from __future__ import annotations

import torch

from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops.binning import TileConfig, bin_surfels
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street

Tensor = torch.Tensor

TILE = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier")
SHAPES = [(8, 128), (4, 128), (2, 128), (1, 128),
          (8, 64), (4, 64), (2, 64), (8, 32), (4, 32), (2, 32)]
CHUNK = 8


def demand(bundle: SurfelBundle, grid, width: int, s2w: Tensor,
           tile: TileConfig = TILE, device="cuda") -> dict:
    """{(h2, w2): histogram of unique gate-passers per sub-tile, length
    K + 1} for every shape of SHAPES."""
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    n, k = bundle.num_surfels, tile.max_per_tile
    th, tw = tile.tile_h, tile.tile_w
    with torch.no_grad():
        a = bin_surfels(grid, width, transforms.invert_se3(s2w),
                        bundle.means, bundle.scales, bundle.opacities, tile,
                        rotations=bundle.rotations)
        frames, dirs_t = street.tile_rays(bundle, grid, width, s2w, tile)
        idx_c = a.index.clamp(0, n - 1)
        hists = {shape: torch.zeros(k + 1, dtype=torch.int64, device=device)
                 for shape in SHAPES}
        for s in range(0, idx_c.shape[0], CHUNK):
            sl = slice(s, s + CHUNK)
            ok = street.tile_gate(frames, bundle, dirs_t[sl], idx_c[sl],
                                  a.valid[sl])[0]
            img = ok.reshape(-1, th, tw, k)
            for h2, w2 in SHAPES:
                blocks = img.reshape(-1, th // h2, h2, tw // w2, w2, k) \
                    .any(4).any(2)
                hists[h2, w2] += torch.bincount(
                    blocks.sum(-1).reshape(-1), minlength=k + 1)
    return {shape: h.cpu().numpy() for shape, h in hists.items()}


def lines(hists: dict) -> list[str]:
    """The reference's printed lines, one per shape."""
    out = []
    for (h2, w2), h in hists.items():
        d = street.hist_summary(h)
        pct, over = d["pct"], d["over"]
        out.append(f"{h2:2d}x{w2:3d}: mean {d['mean']:6.1f}  p50 "
                   f"{pct[50]:3d}  p90 {pct[90]:3d}  p99 {pct[99]:3d}  p99.9 "
                   f"{pct[99.9]:3d}  max {d['max']:3d}  frac>128 "
                   f"{over[128]:.4f}  frac>64 {over[64]:.4f}")
    return out


def main(argv=None) -> dict:
    a = street.parser("subtile_demand", __doc__).parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    hists = demand(bundle, grid, width, s2w, TILE, a.device)
    for line in lines(hists):
        print(line, flush=True)
    return hists


if __name__ == "__main__":
    main()
