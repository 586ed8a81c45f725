"""Stage-level timing of the tracer pipeline on the street scene
(counterpart of the reference's `scripts/profile_stages.py:30-113`).

    python -m lidar_rt_tpu_torch.scripts.profile_stages [--fast]
        [--device cuda]

Times each prefix of the pipeline, bin -> +prep -> fwd -> fwd+bwd, as
ITERS steps coupled through the opacities (`street.coupled`, the
reference's `timed_scan`), each from a CUDA graph (the reference's in-jit
scan: device time) and eagerly beside it, with each prefix's device
operations a step; the stage costs are the successive differences.  The
tile shape follows the bench's knobs (`bench.knobs`: BENCH_TILE_H,
BENCH_TILE_W, BENCH_K, BENCH_MACRO_COLS), hier binner, no footprint pad.
prep is `cuda_tracer._prepare_tile_inputs` (the reference's
`pallas_tracer._prepare_tile_inputs`), fwd `ops.tracer.trace` (its
`pallas_tracer.trace`).  On the card the prefixes run the tile-order
kernels in float32, `tracer_forward_kernel<false>` and
`tracer_backward_kernel<0,false>`; with `--fast` the card's training mode
(`TraceConfig(fast_math=True, cache_fwd=True)`), whose fwd+bwd runs
`tracer_forward_kernel<true>` and `tracer_backward_cache_kernel<true>`.
"""

from __future__ import annotations

import torch

from lidar_rt_tpu_torch import bench
from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops import cuda_tracer
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.ops.binning import TileConfig, bin_surfels
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street

ITERS = 20
LABELS = ("bin", "bin+prep", "fwd (bin+prep+kernel+untile)", "fwd+bwd")


def tile_config(kn: bench.Knobs) -> TileConfig:
    """The reference's TILE (`scripts/profile_stages.py:39-41`)."""
    return TileConfig(tile_h=kn.tile_h, tile_w=kn.tile_w, max_per_tile=kn.k,
                      macro_cols=kn.macro_cols, binner="hier")


def fwd_bwd(b: SurfelBundle, grid, width: int, s2w, bg, cfg, assignment=None):
    """The bench's loss on a render of b and its gradient to b's five
    fields: (loss, SurfelBundle of gradients)."""
    leaves = SurfelBundle(*(x.detach().requires_grad_() for x in b))
    out = tracer_lib.trace(leaves, grid, width, s2w, bg, 3, cfg,
                           assignment=assignment)
    l_ = bench.loss(out.channels)
    return l_.detach(), SurfelBundle(*torch.autograd.grad(l_, leaves))


def profile(bundle: SurfelBundle, grid, width: int, s2w, device,
            kn: bench.Knobs | None = None, fast: bool = False,
            iters: int | None = None) -> dict:
    """Each prefix's row (`street.time_stage`: graph_ms, eager_ms,
    captured, ops, busy_ms, and its value on the bundle as it is: the bin's
    TileAssignment, prep's six tile arrays, fwd's sum of intensity, fwd+bwd's
    (loss, gradients)), by label."""
    kn = bench.knobs() if kn is None else kn
    iters = ITERS if iters is None else iters
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    tile = tile_config(kn)
    cfg = tracer_lib.TraceConfig(tile=tile, fast_math=fast, cache_fwd=fast)
    bg = torch.tensor([0.0, 0.0, 1.0], device=device)
    w2s = transforms.invert_se3(s2w)

    def s_bin(b):
        return bin_surfels(grid, width, w2s, b.means, b.scales, b.opacities,
                           tile, rotations=b.rotations)

    def s_prep(b):
        a = s_bin(b)
        origin, _dirs = rays_lib.range_rays(grid, width, s2w)
        return cuda_tracer._prepare_tile_inputs(b, origin, a.index, a.valid)

    def s_fwd(b):
        return tracer_lib.trace(b, grid, width, s2w, bg, 3,
                                cfg).channels[..., 0].sum()

    stages = {
        "bin": (s_bin, lambda a: a.index.sum().float()),
        "bin+prep": (s_prep, lambda parts: sum(p.sum() for p in parts[:3])),
        "fwd (bin+prep+kernel+untile)": (s_fwd, lambda v: v),
        "fwd+bwd": (lambda b: fwd_bwd(b, grid, width, s2w, bg, cfg),
                    lambda v: v[0] + v[1].means.sum()),
    }
    return {label: street.time_stage(street.on_opacities(bundle, fn),
                                     reduce, iters, device, profile=True)
            for label, (fn, reduce) in stages.items()}


def lines(rows: dict, height: int, width: int, device) -> list[str]:
    """The reference's lines, each prefix's eager ms and device operations
    beside its graph ms, the stage differences of both, and each prefix's
    top device kernels where profiled."""
    out = [street.timer_note(device)]
    out += [street.stage_line(label, rows[label]) for label in LABELS]
    rays = height * width
    for key, name in (("graph_ms", "graph"), ("eager_ms", "eager")):
        t_bin, t_prep, t_fwd, t_fb = (rows[label][key] for label in LABELS)
        out.append(f"stages ({name}): bin {t_bin:.2f}  prep "
                   f"{t_prep - t_bin:.2f}  kernel+untile {t_fwd - t_prep:.2f}"
                   f"  bwd {t_fb - t_fwd:.2f}  -> "
                   f"{rays / (t_fb / 1e3) / 1e6:.1f} Mray/s")
    fb = rows["fwd+bwd"]
    out.append(f"host share of the eager fwd+bwd: "
               f"{1.0 - fb['graph_ms'] / fb['eager_ms']:.3f}")
    out += [f"{label}: top device kernels: "
            f"{street.top_line(rows[label]['top'])}"
            for label in LABELS if rows[label]["top"] is not None]
    return out


def main(argv=None) -> dict:
    p = street.parser("profile_stages", __doc__)
    p.add_argument("--fast", action="store_true",
                   help="the card's training mode (fast_math, cache_fwd)")
    a = p.parse_args(argv)
    kn = bench.knobs()
    bundle, grid, width, s2w = street.setup(a)
    rows = profile(bundle, grid, width, s2w, a.device, kn, a.fast)
    for line in lines(rows, grid.height, width, a.device):
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
