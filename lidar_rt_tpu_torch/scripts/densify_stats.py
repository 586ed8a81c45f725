"""The densification statistic of the rehearsal's Waymo scene after a few
training steps, in each of the port's training paths from one state.

    python -m lidar_rt_tpu_torch.scripts.densify_stats [--data /tmp/e2e_data]
        [--steps 100] [--device cuda] [--modes cached replayed torch]

Loads the Waymo segment that `e2e_rehearsal gen` writes, assembles it with
the rehearsal's options, and from that one state trains `--steps` steps
(fewer than `densify_from_iter`, so no densify event changes the scene)
in each mode: `cached`, the configs' training on the card (the cached
kernel pair, fast sums); `replayed`, the kernels in float32; `torch`, the
plain torch engine under autograd (the reference's jax engine's twin).
For each it prints the statistic density control reads, grad_accum /
denom over the visible background surfels (quantiles and the count at or
above `densify_grad_threshold`, split by the clone/split size boundary),
and the share of surfels seen.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os

import torch

from lidar_rt_tpu_torch.scripts.e2e_rehearsal import DATA

QUANTILES = (0.5, 0.9, 0.99, 0.999)


def main(argv=None) -> dict[str, dict]:
    from lidar_rt_tpu_torch.data import build, waymo
    from lidar_rt_tpu_torch.train import loop, options

    p = argparse.ArgumentParser(
        prog="python -m lidar_rt_tpu_torch.scripts.densify_stats")
    p.add_argument("--data", default=DATA)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--device", default="cuda")
    p.add_argument("--modes", nargs="+", default=["cached", "replayed",
                                                  "torch"])
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    opts = options.rehearsal_options("waymo")
    if a.steps >= int(opts.opt.densify_from_iter):
        p.error(f"--steps must stay below densify_from_iter "
                f"({opts.opt.densify_from_iter})")
    frames, tracks = waymo.load(os.path.join(a.data, "waymo"), opts,
                                device=dev)
    scene = build.assemble_scene(frames, tracks, opts,
                                 torch.Generator(device=dev).manual_seed(0))
    cfg, warmup_cfg, warmup_until = options.trace_configs(opts, dev)
    modes = {"cached": {},
             "replayed": {"fast_math": False, "cache_fwd": False},
             "torch": {"engine": "torch", "fast_math": False,
                       "cache_fwd": False}}
    out = {}
    for mode in a.modes:
        kw = modes[mode]
        trainer = loop.Trainer(
            copy.deepcopy(scene), frames, opts,
            dataclasses.replace(cfg, **kw),
            warmup_cfg=dataclasses.replace(warmup_cfg, **kw),
            warmup_until=warmup_until)
        trainer.run(a.steps, log_every=a.steps)
        bg = trainer.state.scene.background
        stats = trainer.state.stats_bg
        seen = bg.alive & (stats.denom > 0)
        mean = stats.grad_accum[seen] / stats.denom[seen]
        thr = float(opts.opt.densify_grad_threshold)
        big = (bg.scales.max(-1).values[seen]
               > float(opts.opt.densify_scale_threshold) * bg.extent)
        q = torch.quantile(mean.double(), torch.tensor(
            QUANTILES, dtype=torch.float64, device=mean.device)).tolist()
        over = mean >= thr
        out[mode] = {"seen": int(seen.sum()), "alive": int(bg.alive.sum()),
                     "quantiles": q, "clone": int((over & ~big).sum()),
                     "split": int((over & big).sum()),
                     "loss": trainer.history[-1]["loss"]}
        print(f"{mode}: {a.steps} steps, {out[mode]['seen']} of "
              f"{out[mode]['alive']} background surfels seen; grad_accum / "
              f"denom quantiles {dict(zip(QUANTILES, q))}; at or above "
              f"{thr}: {out[mode]['clone']} to clone, {out[mode]['split']} "
              f"to split; last loss {out[mode]['loss']:.5f}", flush=True)
        del trainer
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
