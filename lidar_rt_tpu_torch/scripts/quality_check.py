"""Convergence quality of each tracer config (counterpart of the
reference's `scripts/quality_check.py`).

    python -m lidar_rt_tpu_torch.scripts.quality_check [ITERS] [HxW] [SEED]
        [NAMES] [--device cuda] [--json out.json]

Trains the synthetic dynamic scene (4 frames at H x W; default 4000
iterations at 32x512, scene seed 0) on a compressed schedule with each
tracer config of `CONFIGS` whose name contains one of the comma-separated
NAMES (all without), and prints per config its loss trajectory, then one
line: iterations per second, alive background surfels, the engine the
config renders on, and masked depth / intensity / hit metrics on a
held-out frame.  It is how a user picks a tile shape and candidate budget:
truncation depends on the surfels per tile, so results at a small scene
do not transfer to full scans (use 64x2650 for those).

The configs are the reference's (`scripts/quality_check.py:48-78`) less
its TPU-only keys: `approx_topk` (the port bins with exact top-k) and
`ray_block` (the kernels run one thread per ray), as
`train.options.TPU_ONLY` drops them from a config's `tracer:` block.
`fast_math` and `cache_fwd` are on for a CUDA device, as
`train.options.trace_configs` sets them for the CLI.  Each config renders
on the engine `TraceConfig.resolve_engine()` names; a shape the CUDA
kernels refuse raises, it does not fall back to the torch engine.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
import time

import numpy as np
import torch

from lidar_rt_tpu_torch.data import build, synthetic
from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.train import loop, options


def _tile(h: int, w: int, k: int) -> TileConfig:
    return TileConfig(tile_h=h, tile_w=w, max_per_tile=k, binner="hier",
                      pad_px=2.0)


_T8K256, _T4K128 = _tile(8, 128, 256), _tile(4, 128, 128)
_T2K128, _T16X32 = _tile(2, 128, 128), _tile(16, 32, 128)
# (name, steady tile, warm-up tile | None, opt overrides, tail passes)
CONFIGS = [
    ("8x128 K=256 rebin1 (r2 flagship)", _T8K256, None, {}, 0),
    ("8x128 K=256 rebin10", _T8K256, None, {"rebin_interval": 10}, 0),
    ("4x128 K=128 rebin10", _T4K128, None, {"rebin_interval": 10}, 0),
    ("2x128 K=128 rebin10", _T2K128, None, {"rebin_interval": 10}, 0),
    # Small-K fine tiles with one tail pass: the tail composites what
    # each tile's K truncates.
    ("4x128 K=128 rebin10 tail1", _T4K128, None, {"rebin_interval": 10},
     1),
    ("8x128 K=128 rebin10 tail1", _tile(8, 128, 128), None,
     {"rebin_interval": 10}, 1),
    # Azimuth-narrow tiles.
    ("16x32 K=128 rebin10", _T16X32, None, {"rebin_interval": 10}, 0),
    ("16x32 K=128 rebin10 tail1", _T16X32, None, {"rebin_interval": 10},
     1),
    ("16x32 K=256->128 warmup", _T16X32, _tile(16, 32, 256),
     {"rebin_interval": 10}, 0),
]


def masked_eval(out: dict, frames, f: int) -> dict[str, float]:
    """Depth and intensity errors where both the recording and the render
    have a return, the hit accuracy and the recorded returns covered."""
    gt_d = frames.range1[f].cpu().numpy()
    gt_i = frames.intensity1[f].cpu().numpy()
    gt_m = gt_d > 0
    pred_d = out["depth"].cpu().numpy()
    pred_i = out["intensity"].cpu().numpy()
    pred_hit = out["raydrop"].cpu().numpy() < 0.5
    m = gt_m & pred_hit
    return {
        "depth_med": float(np.median(np.abs(pred_d - gt_d)[m])),
        "depth_rmse": float(np.sqrt(np.mean((pred_d - gt_d)[m] ** 2))),
        "int_mae": float(np.mean(np.abs(pred_i - gt_i)[m])),
        "hit_acc": float((pred_hit == gt_m).mean()),
        "coverage": float(m.sum() / max(gt_m.sum(), 1)),
    }


def run(name: str, tile: TileConfig, warmup_tile: TileConfig | None = None,
        opt_overrides: dict | None = None, tail_passes: int = 0, *,
        iters: int = 4000, height: int = 32, width: int = 512,
        seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Train one config; print its losses and its line, and return them
    (metrics, it/s, alive, engine, losses, kernel launches)."""
    dev = torch.device(device)
    # Every config trains from the same initial scene: the host's
    # generators and the assembly's explicit one seeded per run.
    random.seed(seed)
    np.random.seed(seed)
    frames, track = synthetic.generate(num_frames=4, height=height,
                                       width=width, device=dev)
    opts = options.experiment_options(
        densify_until_iter=iters * 5 // 12,
        opacity_reset_interval=iters // 5, iterations=iters,
        position_lr_max_steps=iters, **(opt_overrides or {}))
    scene = build.assemble_scene(
        frames, [track], opts, torch.Generator(device=dev).manual_seed(seed),
        capacity_headroom=2.0)
    card = dev.type == "cuda"
    cfg = tracer_lib.TraceConfig(tile=tile, tail_passes=tail_passes,
                                 fast_math=card, cache_fwd=card)
    wcfg = None if warmup_tile is None else dataclasses.replace(
        cfg, tile=warmup_tile, tail_passes=0)
    trainer = loop.Trainer(scene, frames, opts, cfg, warmup_cfg=wcfg)
    f_eval = frames.eval_frames[0] if frames.eval_frames else 0

    launches = kernels.launch_counts()
    t0 = time.perf_counter()
    hist = trainer.run(iterations=iters, log_every=max(iters // 8, 1))
    if card:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    step = max(len(hist) // 8, 1)
    losses = [h["loss"] for h in hist[::step]]
    print("  losses:", ["%.4f" % v for v in losses], flush=True)
    m = masked_eval(trainer.render_eval(f_eval), frames, f_eval)
    alive = int(trainer.state.scene.background.alive.sum())
    engine = cfg.resolve_engine()
    print(f"{name:36s}: {iters / dt:6.1f} it/s  alive={alive}  "
          f"engine={engine}  "
          + "  ".join(f"{k}={v:.4f}" for k, v in m.items()), flush=True)
    return {"name": name, "it_per_s": iters / dt, "alive": alive,
            "engine": engine, "metrics": m, "losses": losses,
            "launches": kernels.launches_since(launches)}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m lidar_rt_tpu_torch.scripts.quality_check")
    p.add_argument("iters", nargs="?", type=int, default=4000)
    p.add_argument("shape", nargs="?", default="32x512", help="HxW")
    p.add_argument("seed", nargs="?", type=int, default=0)
    p.add_argument("only", nargs="?", default="",
                   help="comma-separated substrings of config names")
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None,
                   help="also write each config's results here")
    a = p.parse_args(argv)
    h, w = (int(v) for v in a.shape.split("x"))
    out = []
    for name, tile, warm, over, tail in CONFIGS:
        if a.only and not any(s in name for s in a.only.split(",")):
            continue
        out.append(run(name, tile, warm, over, tail, iters=a.iters,
                       height=h, width=w, seed=a.seed, device=a.device))
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f)
    return out


if __name__ == "__main__":
    main()
