"""Stage decomposition of the kernel path's forward render on the street
scene (counterpart of the reference's `scripts/stage_bench.py:37-80`).

    python -m lidar_rt_tpu_torch.scripts.stage_bench [--device cuda]

At 8x128 tiles, K=256, hier binner: the binning (`cuda_tracer.
bin_bundle`), the prep (`cuda_tracer.tile_inputs` on that assignment: the
rays as tiles, the candidate gathers and frames, the SH degree mask), the
forward kernel alone on the prepared `TileInputs` (`cuda_tracer.
forward_tiles`: `tracer_forward_kernel<false>` on the card, its plain twin
on the CPU) and `cuda_tracer.trace_forward` in total (binning included).
The reference times these as ITERS back-to-back dispatches, so each is
timed so (`street.device_ms`, the eager column) and from a CUDA graph of
the same ITERS calls beside it (`street.time_steps`).  The TPU-only
lane-major `drows` copy of the rays has no counterpart (ROADMAP's kernel
boundary).
"""

from __future__ import annotations

import torch

from lidar_rt_tpu_torch.ops import cuda_tracer
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street

ITERS = 20
TILE = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier")
LABELS = ("bin", "prep(gathers+basis)", "kernel", "trace_forward total")


def profile(bundle: SurfelBundle, grid, width: int, s2w, device,
            iters: int | None = None) -> dict:
    """Each stage's row by label (`street.time_steps`, with its value: the
    TileAssignment, the TileInputs, the kernel's (chans, accum) and
    trace_forward's (image, accum))."""
    iters = ITERS if iters is None else iters
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    with torch.no_grad():
        a = cuda_tracer.bin_bundle(bundle, grid, width, s2w, TILE)
        inputs, _ = cuda_tracer.tile_inputs(bundle, grid, width, s2w, 3,
                                            TILE, a)
        stages = {
            LABELS[0]: lambda: cuda_tracer.bin_bundle(bundle, grid, width,
                                                      s2w, TILE),
            LABELS[1]: lambda: cuda_tracer.tile_inputs(
                bundle, grid, width, s2w, 3, TILE, a)[0],
            LABELS[2]: lambda: cuda_tracer.forward_tiles(inputs),
            LABELS[3]: lambda: cuda_tracer.trace_forward(
                bundle, grid, width, s2w, 3, TILE),
        }
        rows = {}
        for label, fn in stages.items():
            value = fn()
            rows[label] = street.time_steps(lambda _i, fn=fn: fn(), iters,
                                            device)
            rows[label]["value"] = value
    return rows


def lines(rows: dict, device) -> list[str]:
    """The reference's lines, each stage's graph ms beside its eager
    (back-to-back) ms."""
    return [street.timer_note(device)] + [
        street.stage_line(f"{label}:", rows[label], 25) for label in LABELS]


def main(argv=None) -> dict:
    a = street.parser("stage_bench", __doc__).parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    rows = profile(bundle, grid, width, s2w, a.device)
    for line in lines(rows, a.device):
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
