"""Does the forward render's time follow its pairs or its blocks?
(counterpart of the reference's `scripts/grid_overhead_probe.py:30-99`).

    python -m lidar_rt_tpu_torch.scripts.grid_overhead_probe [--device cuda]

Renders the street scene (`ops.tracer.trace`, binning included, no
gradient; hier binner, the card's `TraceConfig(fast_math=True,
cache_fwd=True)`, whose render without a gradient runs
`tracer_forward_kernel<false>`) at tile shapes that hold the (ray,
candidate) pairs constant while the blocks change: 8x128, 16x128, 32x128
and 8x256 at K=256, and 8x128 at K=128 (half the pairs).  Each is ITERS
steps coupled through the opacities by the render's accum, timed from a
CUDA graph and eagerly beside it (`street.time_stage`), with its CUDA
blocks, G pairs/s and us a block.  The reference's three 8x128 K=256 rows
differ only in `ray_block`, a Mosaic VMEM knob with no counterpart here,
so they are one row (as in `sweep_perf`); the kernels' grid is (ray
blocks, tiles) (`csrc/tracer_forward.cu`), so every tile shape runs.
"""

from __future__ import annotations

import torch

from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import intercept_probe, street

ITERS = 20
# (tile_h, tile_w, K, label) of each row.
ROWS = [(8, 128, 256, "8x128 K=256 (flagship; rb=512/256/128)"),
        (16, 128, 256, "16x128 K=256 (1/2 tiles)"),
        (32, 128, 256, "32x128 K=256 (1/4 tiles)"),
        (8, 256, 256, "8x256 K=256 (1/2 tiles, wide)"),
        (8, 128, 128, "8x128 K=128 (1/2 pairs)")]


def profile(bundle: SurfelBundle, grid, width: int, s2w, device,
            iters: int | None = None) -> list[dict]:
    """Per row: its shape, tiles, blocks and pairs, and `street.time_stage`
    of its render (value: the first render's accum)."""
    iters = ITERS if iters is None else iters
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    bg = torch.tensor([0.0, 0.0, 1.0], device=device)
    out = []
    for th, tw, k, label in ROWS:
        cfg = tracer_lib.TraceConfig(
            tile=TileConfig(tile_h=th, tile_w=tw, max_per_tile=k,
                            binner="hier"), fast_math=True, cache_fwd=True)

        def render(b, cfg=cfg):
            return tracer_lib.trace(b, grid, width, s2w, bg, 3,
                                    cfg).accum_weights

        row = street.time_stage(street.on_opacities(bundle, render),
                                lambda v: v, iters, device)
        tiles_y, tiles_x = cfg.tile.num_tiles(grid.height, width)
        tiles = tiles_y * tiles_x
        row.update(label=label, tile=(th, tw, k), tiles=tiles,
                   blocks=intercept_probe.blocks(tiles, th * tw),
                   pairs=tiles * th * tw * k)
        out.append(row)
    return out


def lines(rows: list[dict], device) -> list[str]:
    """The reference's line per row (graph ms, blocks, G pairs/s, us a
    block), with the eager ms and its G pairs/s beside."""
    out = [street.timer_note(device)]
    for r in rows:
        g, e = r["graph_ms"], r["eager_ms"]
        out.append(f"{r['label']:40s} {g:7.3f} ms  {r['blocks']:5d} blocks  "
                   f"{r['pairs'] / g * 1e3 / 1e9:5.1f} G pairs/s  "
                   f"{g / r['blocks'] * 1e3:6.2f} us/block   eager "
                   f"{e:7.3f} ms ({r['pairs'] / e * 1e3 / 1e9:5.1f} G "
                   f"pairs/s)")
    return out


def main(argv=None) -> list[dict]:
    a = street.parser("grid_overhead_probe", __doc__).parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    rows = profile(bundle, grid, width, s2w, a.device)
    for line in lines(rows, a.device):
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
