"""Decompose the binning and the kernels' input preparation on the street
scene (counterpart of the reference's `scripts/prep_bench.py:42-112`).

    python -m lidar_rt_tpu_torch.scripts.prep_bench [--device cuda]

At 8x128 tiles, K=256, hier binner: the binning; its stage 0 alone
(`binning.footprint_bounds`: every surfel's projection and footprint); the
hier binner's stage 1 alone on those bounds (each tile column's nearest
K_c = coarse_factor x K surfels, the reference script's centre-distance
overlap); the rays gathered and tiled; the SH basis of the tiled rays;
`build_frames` over all N surfels; and the candidate gathers
(`cuda_tracer._prepare_tile_inputs`).  Each stage is timed as ITERS
back-to-back calls (`street.device_ms`, the eager column), from a CUDA
graph of the same calls beside it, and profiled for its device operations
a call (`street.device_profile`: kernels, copies and memsets): the count
ROADMAP's B-X2 asks of the footprint stage.
"""

from __future__ import annotations

import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib
from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.core import sh as sh_lib
from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops import binning, cuda_tracer, geometry
from lidar_rt_tpu_torch.ops.binning import TileConfig, bin_surfels
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street

ITERS = 30
TILE = TileConfig(tile_h=8, tile_w=128, max_per_tile=256, binner="hier")
LABELS = ("bin", "bin stage0 (bounds)", "bin stage1 (topKc)",
          "dirs gather+tile", "sh basis", "build_frames (all N)",
          "candidate gathers")


def stage1(bounds, width: int, tile: TileConfig = TILE):
    """The hier binner's stage 1 alone, as the reference script writes it
    (`scripts/prep_bench.py:88-105`): per tile column the nearest K_c
    live surfels whose footprint centre lies within half a tile (plus its
    half-width and half a pixel) of the column's centre, as (ranges,
    indices); +inf where fewer overlap."""
    _row_lo, _row_hi, col_c, col_half, rng, live = bounds
    tiles_x = -(-width // tile.tile_w)
    k_c = min(tile.coarse_factor * tile.max_per_tile, rng.shape[0])
    tx = torch.arange(tiles_x, dtype=torch.float32, device=rng.device)
    tile_col_c = torch.remainder((tx + 0.5) * tile.tile_w, float(width))
    dcol = (col_c[None, :] - tile_col_c[:, None]).abs()
    dcol = torch.minimum(dcol, width - dcol)
    col_overlap = (dcol <= (col_half[None, :] + tile.tile_w / 2.0 + 0.5)) \
        & live[None, :]
    return binning._nearest(torch.where(col_overlap, rng, torch.inf), k_c)


def profile(bundle: SurfelBundle, grid, width: int, s2w, device,
            iters: int | None = None) -> dict:
    """Each stage's row by label (`street.time_steps` with its device
    operations, and its value)."""
    iters = ITERS if iters is None else iters
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    w2s = transforms.invert_se3(s2w)
    origin = s2w[:3, 3]
    with torch.no_grad():
        a = bin_surfels(grid, width, w2s, bundle.means, bundle.scales,
                        bundle.opacities, TILE, rotations=bundle.rotations)
        bounds = binning.footprint_bounds(
            grid, width, w2s, bundle.means, bundle.scales, bundle.opacities,
            TILE, bundle.rotations)
        dirs_t = cuda_tracer.to_tiles(
            rays_lib.range_rays(grid, width, s2w)[1], TILE)
        stages = {
            LABELS[0]: lambda: bin_surfels(
                grid, width, w2s, bundle.means, bundle.scales,
                bundle.opacities, TILE, rotations=bundle.rotations),
            LABELS[1]: lambda: binning.footprint_bounds(
                grid, width, w2s, bundle.means, bundle.scales,
                bundle.opacities, TILE, bundle.rotations),
            LABELS[2]: lambda: stage1(bounds, width),
            LABELS[3]: lambda: cuda_tracer.to_tiles(
                rays_lib.range_rays(grid, width, s2w)[1], TILE),
            LABELS[4]: lambda: sh_lib.basis(dirs_t, 3),
            LABELS[5]: lambda: geometry.build_frames(
                bundle.means, quat_lib.to_rotation_matrix(bundle.rotations),
                origin),
            LABELS[6]: lambda: cuda_tracer._prepare_tile_inputs(
                bundle, origin, a.index, a.valid),
        }
        rows = {}
        for label, fn in stages.items():
            value = fn()
            rows[label] = street.time_steps(lambda _i, fn=fn: fn(), iters,
                                            device, profile=True)
            rows[label]["value"] = value
    return rows


def lines(rows: dict, device) -> list[str]:
    """The reference's lines, each stage's eager ms and device operations
    beside its graph ms, then each stage's top device kernels where
    profiled."""
    return [street.timer_note(device)] + [
        street.stage_line(f"{label}:", rows[label], 23) for label in LABELS
    ] + [f"{label}: top device kernels: {street.top_line(rows[label]['top'])}"
         for label in LABELS if rows[label]["top"] is not None]


def main(argv=None) -> dict:
    a = street.parser("prep_bench", __doc__).parse_args(argv)
    bundle, grid, width, s2w = street.setup(a)
    rows = profile(bundle, grid, width, s2w, a.device)
    for line in lines(rows, a.device):
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
