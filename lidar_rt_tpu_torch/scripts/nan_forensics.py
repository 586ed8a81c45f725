"""Catch the first non-finite gradient and name its loss term, parameter
leaf and surfels (counterpart of the reference's
`scripts/nan_forensics.py`).

    python -m lidar_rt_tpu_torch.scripts.nan_forensics [TH] [TW] [K]
        [ITERS] [--device cuda] [--json out.json]

Steps the real `Trainer` on the synthetic scene (4 frames of 64 x 2650)
with TH x TW tiles of K candidates (defaults 8 256 128, 1000 iterations).
Before each optimizer step it takes the gradient of the sum of the six
loss terms of `TERMS` with respect to every asset's parameters and checks
each leaf; at the first non-finite one it takes each term's gradient
alone, prints which terms are finite, and for each non-finite leaf of a
failing term its count, its first ten surfel indices and the first
surfel's parameters; else it prints "no non-finite gradient found".

Each term is the training loss with every other weight zeroed, its render
binned afresh, as in the reference (`term_loss`, :49).  The reference's
report iterates each gradient's leaves with `enumerate` over a dict
(its `params()`), which yields the group names, not the leaves; the port
reports each leaf by its group name (`bg.xyz`, `ac.opacity`, ...).
`fast_math` and `cache_fwd` are on for a CUDA device, as
`train.options.trace_configs` sets them for the CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.data import build, synthetic
from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.scene import compose
from lidar_rt_tpu_torch.train import loop, losses, options

TERMS = ("depth", "int_l1l2", "dssim", "bce", "cd", "reg")
CD_POINTS = 16384       # the Chamfer term's point budget (reference :70)


def term_loss(scene, batch, term: str, args, frames, cfg) -> torch.Tensor:
    """The training loss with only `term`'s weights on."""
    o = args.opt
    lw = losses.LossWeights(
        depth_l1=o.lambda_depth_l1 * (term == "depth"),
        intensity_l1=o.lambda_intensity_l1 * (term == "int_l1l2"),
        intensity_l2=o.lambda_intensity_l2 * (term == "int_l1l2"),
        intensity_dssim=o.lambda_intensity_dssim * (term == "dssim"),
        raydrop_bce=o.lambda_raydrop_bce * (term == "bce"),
        cd=o.lambda_cd * (term == "cd"),
        reg=o.lambda_reg * (term == "reg"))
    bundle, _ = compose(scene, batch.frame)
    out = tracer_lib.render_frame(
        bundle, frames.grid, frames.width, batch.sensor2world,
        scene.background.active_sh_degree, cfg, bool(o.use_rayhit))
    cd = None
    if term == "cd":
        stride = max(1, (frames.height * frames.width) // CD_POINTS)
        origin, dirs3 = rays_lib.range_rays(frames.grid, frames.width,
                                            batch.sensor2world)
        dirs_f = dirs3.reshape(-1, 3)[::stride]
        m = batch.gt_mask.reshape(-1)[::stride]
        pred = origin + dirs_f * out["depth"].reshape(-1)[::stride, None]
        gt = origin + dirs_f * batch.gt_depth.reshape(-1)[::stride, None]
        cd = losses.chamfer_loss(pred, m, gt, m)
    reg = losses.box_reg_loss(scene.background, None)
    for i in range(scene.num_actors):
        reg = reg + losses.box_reg_loss(*loop.actor(scene, i))
    return losses.render_losses(out["depth"], out["intensity"],
                                out["raydrop"], batch.gt_depth,
                                batch.gt_intensity, batch.gt_mask, lw,
                                cd_loss=cd, reg_loss=reg).total


def term_grads(scene, batch, terms, args, frames, cfg
               ) -> dict[str, dict[str, torch.Tensor]]:
    """{"bg": {group: grad}, "ac": {...}} of the sum of `terms`' losses,
    taken on detached copies of the parameters (the scene is not
    touched); a leaf the loss does not reach gets zeros."""
    parts = {"bg": scene.background}
    if scene.actors is not None:
        parts["ac"] = scene.actors
    leaves = {side: {g: v.detach().clone().requires_grad_()
                     for g, v in asset.params().items()}
              for side, asset in parts.items()}
    sc = dataclasses.replace(
        scene, background=scene.background.with_params(leaves["bg"]),
        actors=(scene.actors.with_params(leaves["ac"]) if "ac" in leaves
                else None))
    total = sum(term_loss(sc, batch, t, args, frames, cfg) for t in terms)
    total.backward()
    return {side: {g: (v.grad if v.grad is not None
                       else torch.zeros_like(v))
                   for g, v in p.items()} for side, p in leaves.items()}


def all_finite(grads) -> bool:
    return all(bool(torch.isfinite(v).all()) for p in grads.values()
               for v in p.values())


def attribute(scene, batch, args, frames, cfg, it: int) -> dict:
    """Each term's gradient alone: which are finite, and for each failing
    term's non-finite leaves their count and first ten surfel indices,
    printed in the reference's format.  Returns {"iteration", "finite":
    {term: bool}, "bad": [(term, "side.group", count, indices)]}."""
    print(f"iteration {it}: NON-FINITE total gradient", flush=True)
    report = {"iteration": it, "finite": {}, "bad": []}
    for t in TERMS:
        g = term_grads(scene, batch, (t,), args, frames, cfg)
        ok = all_finite(g)
        report["finite"][t] = ok
        print(f"  term {t}: finite={ok}", flush=True)
        if ok:
            continue
        for side, leaves in g.items():
            asset = scene.background if side == "bg" else scene.actors
            for name, leaf in leaves.items():
                bad = ~torch.isfinite(leaf)
                if not bool(bad.any()):
                    continue
                idx = np.unique(bad.nonzero()[:, 0].cpu().numpy())[:10]
                report["bad"].append((t, f"{side}.{name}",
                                      int(bad.sum()), idx.tolist()))
                print(f"    {side}.{name}: {int(bad.sum())} bad, splats "
                      f"{idx}", flush=True)
                for pn, pl in asset.params().items():
                    if pl.ndim >= 1 and pl.shape[0] >= idx.max() + 1:
                        print(f"      {pn}[{idx[0]}] = "
                              f"{pl[idx[0]].detach().cpu().numpy()}",
                              flush=True)
    return report


def run(trainer, iters: int, log_every: int = 25) -> dict | None:
    """Step `trainer` `iters` times, checking each step's total gradient
    first; the report of the first non-finite one, or None."""
    args, frames, cfg = trainer.args, trainer.frames, trainer.trace_cfg
    for it in range(1, iters + 1):
        batch = loop.frame_batch(frames, trainer._next_frame())
        scene = trainer.state.scene
        if not all_finite(term_grads(scene, batch, TERMS, args, frames,
                                     cfg)):
            return attribute(scene, batch, args, frames, cfg, it)
        # The real training step: the parameters advance as in training.
        trainer.state, metrics = trainer.step_fn(trainer.state, batch)
        if it % log_every == 0:
            print(it, float(metrics["loss"]), flush=True)
    print("no non-finite gradient found", flush=True)
    return None


def main(argv=None) -> dict | None:
    p = argparse.ArgumentParser(
        prog="python -m lidar_rt_tpu_torch.scripts.nan_forensics")
    p.add_argument("th", nargs="?", type=int, default=8)
    p.add_argument("tw", nargs="?", type=int, default=256)
    p.add_argument("k", nargs="?", type=int, default=128)
    p.add_argument("iters", nargs="?", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None,
                   help="also write the report and the tracer kernels' "
                        "launches here")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    launches = kernels.launch_counts()
    frames, track = synthetic.generate(num_frames=4, height=64, width=2650,
                                       device=dev)
    opts = options.experiment_options(
        iterations=a.iters, densify_until_iter=a.iters * 5 // 12,
        opacity_reset_interval=a.iters // 5, position_lr_max_steps=a.iters)
    scene = build.assemble_scene(frames, [track], opts,
                                 torch.Generator(device=dev).manual_seed(0),
                                 capacity_headroom=2.0)
    card = dev.type == "cuda"
    cfg = tracer_lib.TraceConfig(
        tile=TileConfig(tile_h=a.th, tile_w=a.tw, max_per_tile=a.k,
                        binner="hier"),
        fast_math=card, cache_fwd=card)
    print(f"{a.th}x{a.tw} K={a.k}, {a.iters} iterations on the "
          f"{cfg.resolve_engine()} engine", flush=True)
    report = run(loop.Trainer(scene, frames, opts, cfg), a.iters)
    if a.json:
        with open(a.json, "w") as f:
            json.dump({"report": report, "engine": cfg.resolve_engine(),
                       "launches": kernels.launches_since(launches)}, f)
    return report


if __name__ == "__main__":
    main()
