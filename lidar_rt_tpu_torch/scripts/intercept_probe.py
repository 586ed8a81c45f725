"""The tracer kernels' fixed cost against their per-candidate work
(counterpart of the reference's `scripts/intercept_probe.py:60-139`).

    python -m lidar_rt_tpu_torch.scripts.intercept_probe [--device cuda]

Prepares one render's kernel inputs once (`cuda_tracer.tile_inputs` on
the street scene; tile shape and K from the bench's knobs, `bench.knobs`:
BENCH_TILE_H, BENCH_TILE_W, BENCH_K; hier binner) and times the
production kernels on them as ITERS steps coupled through the opacities,
each from a CUDA graph and eagerly beside it (`street.time_steps`):

  fwd_full        the real counts      = fixed cost + the candidate loop
  fwd_cnt0        every count zero     = what a block costs with no
                                         candidate (launch, rays, stores)
  fwd+bwd_full / fwd+bwd_cnt0          the same with the backward (the
                                         gradient of the channels' sum to
                                         the opacities), its own cost by
                                         subtracting the forward's
  trace_forward   `cuda_tracer.trace_forward` on the fixed assignment:
                  prep + kernel + untile, prep+untile by subtraction

The forward is `tracer_forward_kernel<false>` and the backward, with the
reference's fast flag, `tracer_backward_kernel<0,true>` (one TF32 product
a d_sh term).  Its header gives the tiles, the CUDA blocks of the forward
(its grid is (ray blocks of 128, tiles), `csrc/tracer_forward.cu`) in
place of the TPU's grid steps, and the mean count.
"""

from __future__ import annotations

import torch

from lidar_rt_tpu_torch import bench
from lidar_rt_tpu_torch.ops import cuda_tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street

ITERS = 20
# Rays a block of the tile-order kernels (`kThreads` in
# `csrc/tracer_forward.cu`): one thread a ray.
BLOCK_RAYS = 128
LABELS = ("fwd_full", "fwd_cnt0", "fwd+bwd_full", "fwd+bwd_cnt0",
          "trace_forward")


def blocks(tiles: int, rays_per_tile: int) -> int:
    """The forward kernel's CUDA blocks: ray blocks of BLOCK_RAYS a tile."""
    return tiles * -(-rays_per_tile // BLOCK_RAYS)


def profile(bundle: SurfelBundle, grid, width: int, s2w, device,
            kn: bench.Knobs | None = None, iters: int | None = None
            ) -> dict:
    """The inputs' shape (tiles, rays, blocks, mean_cnt) and each
    ablation's row by label (`street.time_steps`, with the first step's
    value: the forwards' (chans, accum), the backwards' opacity gradient,
    trace_forward's (image, accum))."""
    kn = bench.knobs() if kn is None else kn
    iters = ITERS if iters is None else iters
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    tile = TileConfig(tile_h=kn.tile_h, tile_w=kn.tile_w, max_per_tile=kn.k,
                      binner="hier")
    with torch.no_grad():
        inputs, a = cuda_tracer.tile_inputs(bundle, grid, width, s2w, 3,
                                            tile)
    zero = inputs._replace(cnt=torch.zeros_like(inputs.cnt))

    def fwd(x):
        # The reference couples the steps through the candidates' opacity.
        return lambda eps: cuda_tracer.forward_tiles(
            x._replace(opac=x.opac + eps), fast=True)

    def fwd_bwd(x):
        def stage(eps):
            op = (x.opac + eps).requires_grad_()
            chans, _ = cuda_tracer.forward_tiles(x._replace(opac=op),
                                                 fast=True)
            return torch.autograd.grad(chans.sum(), op)[0]
        return stage

    def trace(b):
        return cuda_tracer.trace_forward(b, grid, width, s2w, 3, tile, a)

    stages = {
        "fwd_full": (fwd(inputs), lambda v: v[0].sum()),
        "fwd_cnt0": (fwd(zero), lambda v: v[0].sum()),
        "fwd+bwd_full": (fwd_bwd(inputs), lambda v: v.sum()),
        "fwd+bwd_cnt0": (fwd_bwd(zero), lambda v: v.sum()),
        "trace_forward": (street.on_opacities(bundle, trace),
                          lambda v: v[0].sum()),
    }
    rows = {label: street.time_stage(fn, reduce, iters, device)
            for label, (fn, reduce) in stages.items()}
    t, r = inputs.dirs.shape[:2]
    return {"tile": tile, "tiles": t, "rays": r, "blocks": blocks(t, r),
            "mean_cnt": inputs.cnt.float().mean().item(), "inputs": inputs,
            "assignment": a, "rows": rows}


def lines(p: dict, device) -> list[str]:
    """The reference's header and lines, graph ms with eager beside, then
    the differences of both."""
    tile, rows = p["tile"], p["rows"]
    out = [f"tile {tile.tile_h}x{tile.tile_w} K={tile.max_per_tile} (no "
           f"ray_block here): {p['tiles']} tiles, {p['blocks']} CUDA blocks "
           f"of {BLOCK_RAYS} rays, mean cnt {p['mean_cnt']:.0f}",
           street.timer_note(device)]
    out += [street.stage_line(label, rows[label], 24) for label in LABELS]
    for key, name in (("graph_ms", "graph"), ("eager_ms", "eager")):
        f_full, f_cnt0, fb_full, fb_cnt0, f_tr = (rows[label][key]
                                                  for label in LABELS)
        out += [f"({name})",
                f"fwd chunk bodies        {f_full - f_cnt0:7.3f} ms",
                f"fwd intercept (cnt0)    {f_cnt0:7.3f} ms",
                f"bwd_full                {fb_full - f_full:7.3f} ms",
                f"bwd chunk bodies        "
                f"{(fb_full - f_full) - (fb_cnt0 - f_cnt0):7.3f} ms",
                f"bwd intercept (cnt0)    {fb_cnt0 - f_cnt0:7.3f} ms",
                f"prep+untile (trace_forward - fwd_full)  "
                f"{f_tr - f_full:7.3f} ms"]
    return out


def main(argv=None) -> dict:
    a = street.parser("intercept_probe", __doc__).parse_args(argv)
    kn = bench.knobs()
    bundle, grid, width, s2w = street.setup(a)
    p = profile(bundle, grid, width, s2w, a.device, kn)
    for line in lines(p, a.device):
        print(line, flush=True)
    return p


if __name__ == "__main__":
    main()
