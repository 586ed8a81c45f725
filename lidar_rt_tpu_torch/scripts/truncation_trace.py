"""How much of each tile's candidate list the training step's tail chain
truncates, read as a run trains.

    python -m lidar_rt_tpu_torch.scripts.truncation_trace
        -dc configs/rehearsal/waymo.yaml -ec configs/rehearsal/full.yaml
        [--iterations N] [--device cuda] [--json out.json]
    python -m lidar_rt_tpu_torch.scripts.truncation_trace
        --checkpoints ckpt_it_15000.npz ... [--device cuda] [--json out.json]

Builds the trainer as `cli train` does (the configs' seed, loader, scene
assembly and trace configs) and trains it in chunks of
`testing_iterations` to `--iterations` (default the config's
`opt.iterations`), as `cli train` does.  After each chunk it prints one
JSON line and keeps it in `--json`: the iteration, the held-out intensity
PSNR (`cli.held_out_psnr`, as `cli train` logs it), the alive surfels of
the background and of each actor, the chunk's mean training loss and ms
per step, and `chain_truncation` over the training frames; at the end,
the tracer kernels' launches.  It writes no checkpoint and no log of the
trainer's own.

`chain_truncation(trainer, frame_ids)` bins each frame's whole tail chain
from the trainer's current scene with the step's own arguments (those of
`train.loop.make_train_step`'s `assignment_from_cache`: the composed
scene, the inverted pose, `cache_tile`'s footprint padding and the
budget's `tail_passes`), and returns per pass the summed overflow
(`TileAssignment.truncated`), the tiles that overflow and the largest
overflow of a tile.  What the last pass truncates is never composited.
It only reads: no random draw, no write to the state, its bin cache or
the optimizers, so a trainer read after every chunk trains as one that
is not.

With `--checkpoints` it trains nothing and prints each checkpoint's
alive surfels per actor beside the actors' capacity.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from lidar_rt_tpu_torch import cli
from lidar_rt_tpu_torch import config as config_lib
from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.data import build as build_lib
from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.scene.scene import Scene, compose
from lidar_rt_tpu_torch.scripts.e2e_rehearsal import card
from lidar_rt_tpu_torch.train import loop as loop_lib


def chain_truncation(trainer: loop_lib.Trainer, frame_ids) -> list[dict]:
    """Per pass of the step's tail chain, summed over `frame_ids`:
    `truncated` (candidates past K), `tiles` (tiles with any), `max` (the
    largest overflow of one tile), with the budget K and the tiles
    binned."""
    cfg = trainer.step_cfg
    bin_tile = loop_lib.cache_tile(cfg)
    frames = trainer.frames
    sums = [torch.zeros((), dtype=torch.int64,
                        device=frames.range1.device)
            for _ in range(cfg.tail_passes + 1)]
    tiles = [torch.zeros_like(s) for s in sums]
    peak = [torch.zeros_like(s) for s in sums]
    num_tiles = 0
    with torch.no_grad():
        for f in frame_ids:
            bundle, _ = compose(trainer.state.scene, f)
            chain = tracer_lib.bin_tail_chain(
                bundle, frames.grid, frames.width,
                transforms.invert_se3(frames.pose(f)), bin_tile,
                cfg.tail_passes)
            for p, a in enumerate(chain):
                sums[p] += a.truncated.sum()
                tiles[p] += (a.truncated > 0).sum()
                peak[p] = torch.maximum(peak[p], a.truncated.max())
            num_tiles += int(chain[0].truncated.shape[0])
    return [{"pass": p, "truncated": int(sums[p]), "tiles": int(tiles[p]),
             "max": int(peak[p]), "tiles_binned": num_tiles,
             "K": int(bin_tile.max_per_tile)} for p in range(len(sums))]


def actor_alive(scene: Scene) -> dict:
    """Alive surfels of each actor and the slots each has."""
    if scene.actors is None:
        return {"alive": [], "capacity": 0}
    alive = scene.actors.alive
    return {"alive": alive.sum(-1).tolist(), "capacity": int(alive.shape[1])}


def build_trainer(dc: str, ec: str, device: torch.device):
    """(trainer, args) as `cli train` builds them, before any step."""
    args = config_lib.parse(dc, config_lib.parse(ec))
    cli.set_seed(int(args.get("seed", 1)))
    frames, tracks = cli.load_dataset(args, device)
    scene = build_lib.assemble_scene(frames, tracks, args)
    cfg, warmup_cfg, warmup_until = cli.trace_configs(args, device)
    trainer = loop_lib.Trainer(scene, frames, args, cfg,
                               warmup_cfg=warmup_cfg,
                               warmup_until=warmup_until)
    return trainer, args


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trace(trainer: loop_lib.Trainer, total: int, every: int,
          device: torch.device, emit=None) -> list[dict]:
    """Train `trainer` to iteration `total` in chunks of `every`, reading
    it after each; the chunks' records (each also passed to `emit`)."""
    frames = trainer.frames
    train_ids = frames.train_frames or list(range(frames.num_frames))
    rows = []
    while trainer.iteration < total:
        chunk = min(every, total - trainer.iteration)
        start = len(trainer.history)
        _sync(device)
        t0 = time.perf_counter()
        hist = trainer.run(iterations=chunk, log_every=100)
        _sync(device)
        step_s = time.perf_counter() - t0
        psnr, per_frame, _ = cli.held_out_psnr(trainer)
        t0 = time.perf_counter()
        passes = chain_truncation(trainer, train_ids)
        _sync(device)
        row = {"iteration": trainer.iteration, "eval_psnr": psnr,
               "per_frame": [round(x, 4) for x in per_frame],
               "loss": float(np.mean([h["loss"] for h in hist[start:]])),
               "alive": hist[-1]["alive"],
               "actors": actor_alive(trainer.state.scene),
               "ms_per_step": 1e3 * step_s / chunk,
               "chain": passes,
               "read_s": time.perf_counter() - t0}
        rows.append(row)
        if emit is not None:
            emit(row)
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m lidar_rt_tpu_torch.scripts.truncation_trace")
    p.add_argument("-dc", "--data_config")
    p.add_argument("-ec", "--exp_config")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--checkpoints", nargs="+", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None)
    argv = sys.argv[1:] if argv is None else list(argv)
    a = p.parse_args(argv)
    device = torch.device(a.device)
    out = {"card": card() if device.type == "cuda" else None,
           "command": "python -m lidar_rt_tpu_torch.scripts."
                      "truncation_trace " + " ".join(argv)}
    if a.checkpoints:
        from lidar_rt_tpu_torch.utils import checkpoint as ckpt_lib
        out["checkpoints"] = {}
        for path in a.checkpoints:
            row = actor_alive(ckpt_lib.load_scene(path, device)[0])
            out["checkpoints"][path] = row
            print(json.dumps({"checkpoint": path, **row}), flush=True)
    else:
        if not (a.data_config and a.exp_config):
            p.error("-dc and -ec are needed to train")
        launches = kernels.launch_counts()
        trainer, args = build_trainer(a.data_config, a.exp_config, device)
        total = a.iterations or int(args.opt.iterations)
        every = int(args.get("testing_iterations", 1000))
        out["configs"] = [a.data_config, a.exp_config]
        out["tail_passes"] = [trainer.step_cfg.tail_passes,
                              trainer.trace_cfg.tail_passes]
        out["warmup_until"] = trainer.warmup_until
        out["chunks"] = []

        def emit(row):
            out["chunks"].append(row)
            print(json.dumps(row), flush=True)
            if a.json:
                with open(a.json, "w") as f:
                    json.dump(out, f, indent=1)

        trace(trainer, total, every, device, emit)
        out["launches"] = kernels.launches_since(launches)
        out["peak_mib"] = (torch.cuda.max_memory_allocated(device) / 2 ** 20
                           if device.type == "cuda" else None)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
