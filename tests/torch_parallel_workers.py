"""Rank functions of tests/test_torch_parallel.py's worlds.

A spawned rank imports the module that defines its function, so these
live apart from the test file: this module imports torch, numpy, the
port and chip_smoke.py only, never jax or `lidar_rt_tpu`.  Each takes
the rank's `Mesh` and numpy inputs and returns numpy results
(`parallel.run_world`)."""

from __future__ import annotations

import time

import numpy as np
import torch

import chip_smoke
from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.parallel import (ShardedTrainer, gather_bands,
                                         make_mesh, make_sharded_loss_fn,
                                         stack_batches, trace_ray_sharded)
from lidar_rt_tpu_torch.parallel.train_step import reduce_gradients
from lidar_rt_tpu_torch.scene import convert
from lidar_rt_tpu_torch.train import loop, options


def port_inputs(data: dict):
    """(Scene, LiDARFrames) on the CPU from the arrays of `data`: the
    scene's `<part>.<field>` arrays, and the frames' grid and images."""
    scene = convert.scene_from_numpy(data["scene"], device="cpu")
    fr = data["frames"]
    grid = rays_lib.SensorGrid(torch.tensor(fr["row_inclinations"]),
                               fr["pixel_offset"], fr["angle_offset"])
    frames = LiDARFrames.from_numpy(
        grid, fr["sensor2world"], fr["range1"], fr["intensity1"],
        device="cpu", train_frames=fr["train_frames"],
        eval_frames=fr["eval_frames"])
    return scene, frames


def trace_config(tile: dict, **kw) -> tracer_lib.TraceConfig:
    return tracer_lib.TraceConfig(tile=TileConfig(**tile), **kw)


def sharded_render(mesh, bundle: dict, grid: dict, width: int, s2w, bg,
                   degree: int, tile: dict) -> dict:
    """trace_ray_sharded with a loss on the gathered scan: the scan, the
    row's accum and the bundle's gradients."""
    b = SurfelBundle(**{k: torch.tensor(v).requires_grad_()
                        for k, v in bundle.items()})
    g = rays_lib.SensorGrid.from_bounds(grid["height"], grid["bounds"],
                                        device="cpu")
    out = trace_ray_sharded(b, g, width, torch.tensor(s2w),
                            torch.tensor(bg), degree, trace_config(tile),
                            mesh)
    scan = gather_bands(out.channels, mesh)
    loss = (scan[..., 3] ** 2).sum() * 1e-3 + scan[..., 0].sum()
    loss.backward()
    return {"channels": scan.detach(), "band": out.channels.detach(),
            "accum": out.accum_weights,
            "grads": {k: getattr(b, k).grad for k in bundle}}


def _loss_and_grads(mesh, scene, frames, args, cfg, ids, ones_mask):
    """The sharded loss of the frames `ids` (one per dp row) and its
    world-summed gradients of the background's parameters and the probe."""
    batch = stack_batches([loop.frame_batch(frames, f) for f in ids])
    if ones_mask:
        batch = batch._replace(gt_mask=torch.ones_like(batch.gt_mask))
    params = {k: v.detach().clone().requires_grad_()
              for k, v in scene.background.params().items()}
    probe = torch.zeros((scene.total_capacity, 3), requires_grad=True)
    loss_fn = make_sharded_loss_fn(frames, args, cfg, mesh)
    loss, aux = loss_fn(params, None, probe, scene, batch)
    loss.backward()
    leaves = [*params.values(), probe]
    reduce_gradients(leaves, mesh)
    return {"breakdown": torch.stack(list(aux["breakdown"])),
            "accum": aux["accum"],
            "grads": {**{k: v.grad for k, v in params.items()},
                      "probe": probe.grad}}


def sharded_losses(mesh, data: dict, opt: dict, band_free_opt: dict,
                   tile: dict) -> dict:
    """On a world of 4: the 2 x 2 loss of frames (0, 1) under `opt`; then
    under `band_free_opt` (no term that sees a band's edges) with
    all-ones masks, the 2 x 2 loss and each frame's 1 x 4 loss."""
    scene, frames = port_inputs(data)
    cfg = trace_config(tile)
    args = options.experiment_options(**opt)
    free = options.experiment_options(**band_free_opt)
    mesh14 = make_mesh(dp=1, rays=4)
    return {
        "dp2": _loss_and_grads(mesh, scene, frames, args, cfg, [0, 1],
                               False),
        "dp2_ones": _loss_and_grads(mesh, scene, frames, free, cfg, [0, 1],
                                    True),
        "dp1_ones": [_loss_and_grads(mesh14, scene, frames, free, cfg, [f],
                                     True) for f in (0, 1)],
    }


def train(mesh, data: dict, opt: dict, tile: dict, iterations: int,
          log_every: int, seed: int, tail: int = 0,
          warm_tile: dict | None = None, warmup_until: int | None = None
          ) -> dict:
    """`ShardedTrainer` on this rank's mesh: per-iteration losses and
    frames, the densify log, the state's digest and ms per step."""
    scene, frames = port_inputs(data)
    cfg = trace_config(tile, tail_passes=tail)
    warm = None if warm_tile is None else trace_config(warm_tile,
                                                       tail_passes=tail)
    t = ShardedTrainer(scene, frames, options.experiment_options(**opt),
                       mesh, trace_cfg=cfg, seed=seed, warmup_cfg=warm,
                       warmup_until=warmup_until)
    start = time.perf_counter()
    hist = t.run(iterations=iterations, log_every=log_every)
    seconds = time.perf_counter() - start
    return {"loss": [h["loss"] for h in hist],
            "frames": [h["frame"] for h in hist],
            "densify": t.densify_log, "digest": chip_smoke._state_digest(t),
            "rebins": t.state.bins.rebins,
            "ms_per_step": 1e3 * seconds / iterations}


def refuse_mesh(mesh, dp: int, rays: int):
    """Ask for a mesh that does not factor the world."""
    return make_mesh(dp, rays)


def fail_on_band(mesh, band: int):
    """Rank `band` raises while the others wait in a collective."""
    if mesh.band == band:
        raise ValueError(f"rank of band {band} fails")
    mesh.all_reduce(torch.ones(1), mesh.world)
    return mesh.band


def stall(mesh, seconds: float):
    """Every rank sleeps past the world's deadline."""
    time.sleep(seconds)
    return np.zeros(1)
