"""Stage timing of the amortized step, the tile assignment binned once and
fixed (counterpart of the reference's `scripts/profile_amortized.py:
30-78`).

    python -m lidar_rt_tpu_torch.scripts.profile_amortized [--device cuda]

Bins the street scene once (8x128 tiles, K=256, hier binner, 2 px
footprint pad), prints the mean candidates per tile, then times the
prefixes prep -> fwd (prep+kernel+untile) -> fwd+bwd on that assignment
as ITERS coupled steps (`street.coupled`), each from a CUDA graph and
eagerly beside it (`street.time_stage`), with the differences.  On the
card the prefixes run the tile-order kernels in float32,
`tracer_forward_kernel<false>` and `tracer_backward_kernel<0,false>`.
"""

from __future__ import annotations

import torch

from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops import cuda_tracer
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.ops.binning import TileConfig, bin_surfels
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import profile_stages, street

ITERS = 20
TILE = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier",
                  pad_px=2.0)
LABELS = ("prep (fixed assignment)", "fwd (prep+kernel+untile)", "fwd+bwd")


def profile(bundle: SurfelBundle, grid, width: int, s2w, device,
            iters: int | None = None) -> dict:
    """The assignment (assignment), its mean candidates per tile
    (mean_cand), and each prefix's row by label (`street.time_stage`; its
    value: prep's six tile arrays, fwd's sum of intensity, fwd+bwd's
    (loss, gradients))."""
    iters = ITERS if iters is None else iters
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    cfg = tracer_lib.TraceConfig(tile=TILE)
    bg = torch.tensor([0.0, 0.0, 1.0], device=device)
    a = bin_surfels(grid, width, transforms.invert_se3(s2w), bundle.means,
                    bundle.scales, bundle.opacities, TILE,
                    rotations=bundle.rotations)

    def s_prep(b):
        origin, _ = rays_lib.range_rays(grid, width, s2w)
        return cuda_tracer._prepare_tile_inputs(b, origin, a.index, a.valid)

    def s_fwd(b):
        return tracer_lib.trace(b, grid, width, s2w, bg, 3, cfg,
                                assignment=a).channels[..., 0].sum()

    stages = {
        LABELS[0]: (s_prep, lambda parts: sum(p.sum() for p in parts[:3])),
        LABELS[1]: (s_fwd, lambda v: v),
        LABELS[2]: (lambda b: profile_stages.fwd_bwd(b, grid, width, s2w,
                                                     bg, cfg, a),
                    lambda v: v[0] + v[1].means.sum()),
    }
    rows = {label: street.time_stage(street.on_opacities(bundle, fn),
                                     reduce, iters, device)
            for label, (fn, reduce) in stages.items()}
    return {"assignment": a, "mean_cand": a.valid.sum(1).float().mean().item(),
            "rows": rows}


def lines(r: dict, height: int, width: int, device) -> list[str]:
    """The reference's lines, with each prefix's eager ms beside its graph
    ms and the differences of both."""
    rows = r["rows"]
    out = [f"mean cand: {r['mean_cand']}", street.timer_note(device)]
    out += [street.stage_line(label, rows[label], 34) for label in LABELS]
    for key, name in (("graph_ms", "graph"), ("eager_ms", "eager")):
        t_p, t_f, t_fb = (rows[label][key] for label in LABELS)
        out.append(f"({name}) prep {t_p:.2f}  fwd-after-prep {t_f - t_p:.2f}"
                   f"  bwd {t_fb - t_f:.2f}  total {t_fb:.2f} -> "
                   f"{height * width / (t_fb / 1e3) / 1e6:.1f} Mray/s")
    return out


def main(argv=None) -> dict:
    a = street.parser("profile_amortized", __doc__).parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    r = profile(bundle, grid, width, s2w, a.device)
    for line in lines(r, grid.height, width, a.device):
        print(line, flush=True)
    return r


if __name__ == "__main__":
    main()
