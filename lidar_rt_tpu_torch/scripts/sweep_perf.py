"""The tracer's speed at each tile shape and budget on the street scene
(counterpart of the reference's `scripts/sweep_perf.py:28-121`).

    python -m lidar_rt_tpu_torch.scripts.sweep_perf [--fast] [--device cuda]

Per config of `CONFIGS` (hier binner, coarse factor 8, tile order) it
times a render (`ops.tracer.trace`, binning included, no gradient), a
render with the backward of a loss on its channels (the bundle's five
gradients), and the binning alone, each over ITERS back-to-back calls
(device ms: CUDA events on the card, the host clock on the CPU), and
prints them with the forward+backward rays per second and the mean
candidates per tile.  On the card the render runs the tile-order kernels,
`tracer_forward_kernel<false>` and `tracer_backward_kernel<0,false>`;
with `--fast` the card's training mode, `TraceConfig(fast_math=True,
cache_fwd=True)`: the render without a gradient still runs
`tracer_forward_kernel<false>`, the render with one
`tracer_forward_kernel<true>` and `tracer_backward_cache_kernel<true>`.

The reference's three 8x128 K=256 rows differ only in `ray_block`, a
Mosaic VMEM knob with no counterpart here (the kernels run one thread per
ray), so they are one row.  A config that fails raises.
"""

from __future__ import annotations

import torch

from lidar_rt_tpu_torch.bench import loss
from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.ops.binning import TileConfig, bin_surfels
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street

Tensor = torch.Tensor

ITERS = 16
# (tile_h, tile_w, K, the reference's ray_block values of the row)
CONFIGS = [(8, 128, 256, (512, 256, 128)),
           (4, 128, 128, (512,)),
           (8, 64, 128, (512,))]
COARSE_FACTOR = 8


def trace_config(th: int, tw: int, k: int, fast: bool
                 ) -> tracer_lib.TraceConfig:
    return tracer_lib.TraceConfig(
        tile=TileConfig(tile_h=th, tile_w=tw, max_per_tile=k, binner="hier",
                        coarse_factor=COARSE_FACTOR),
        fast_math=fast, cache_fwd=fast)


def sweep(bundle: SurfelBundle, grid, width: int, s2w: Tensor,
          configs=CONFIGS, fast: bool = False, device="cuda",
          iters: int = ITERS) -> list[dict]:
    """Per config: its shape, ms of the forward, forward+backward and
    binning, rays per second of the forward+backward (M), and the mean
    binned candidates per tile."""
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    params = [x.detach().requires_grad_() for x in bundle]
    b = SurfelBundle(*params)
    bg = torch.tensor([0.0, 0.0, 1.0], device=device)
    w2s = transforms.invert_se3(s2w)
    rays = grid.height * width
    out = []
    for th, tw, k, blocks in configs:
        cfg = trace_config(th, tw, k, fast)

        def fwd(cfg=cfg):
            with torch.no_grad():
                return tracer_lib.trace(b, grid, width, s2w, bg, 3,
                                        cfg).channels

        def fwd_bwd(cfg=cfg):
            out_ = tracer_lib.trace(b, grid, width, s2w, bg, 3, cfg)
            return torch.autograd.grad(loss(out_.channels), params)

        def bin_only(cfg=cfg):
            with torch.no_grad():
                return bin_surfels(grid, width, w2s, b.means, b.scales,
                                   b.opacities, cfg.tile,
                                   rotations=b.rotations)

        valid = int(bin_only().valid.sum())
        t_f = street.device_ms(fwd, iters, device)
        t_fb = street.device_ms(fwd_bwd, iters, device)
        t_b = street.device_ms(bin_only, iters, device)
        tiles_y, tiles_x = cfg.tile.num_tiles(grid.height, width)
        out.append({"tile": (th, tw, k), "ray_blocks": blocks,
                    "fast": fast, "fwd_ms": t_f, "fwd_bwd_ms": t_fb,
                    "bin_ms": t_b, "mray_s": rays / (t_fb / 1e3) / 1e6,
                    "mean_cand": valid / (tiles_y * tiles_x)})
    return out


def lines(rows: list[dict]) -> list[str]:
    """The reference's line per config (its ray_block rows as one)."""
    out = []
    for r in rows:
        th, tw, k = r["tile"]
        rb = "/".join(str(v) for v in r["ray_blocks"])
        out.append(f"hier/exact/cf{COARSE_FACTOR} {th}x{tw} K={k} rb={rb} "
                   f"(no ray_block here){' fast' if r['fast'] else ''}: "
                   f"fwd {r['fwd_ms']:.1f} ms  fwd+bwd {r['fwd_bwd_ms']:.1f} "
                   f"ms ({r['mray_s']:.1f} Mray/s)  bin {r['bin_ms']:.1f} ms"
                   f"  mean cand/tile {r['mean_cand']:.0f}")
    return out


def main(argv=None) -> list[dict]:
    p = street.parser("sweep_perf", __doc__)
    p.add_argument("--fast", action="store_true",
                   help="the card's training mode (fast_math, cache_fwd)")
    a = p.parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    rows = sweep(bundle, grid, width, s2w, CONFIGS, a.fast, a.device)
    for line in lines(rows):
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
