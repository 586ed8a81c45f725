"""The densification statistic of the rehearsal's Waymo scene after a few
training steps, in each of the port's training paths from one state.

    python -m lidar_rt_tpu_torch.scripts.densify_stats [--data /tmp/e2e_data]
        [--steps 100] [--device cuda] [--modes cached replayed torch]
        [--repeats 1] [--jitter 0.0]

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

With `--repeats` R > 1 each mode trains R times from the state, and it
prints how far each repeat's quantiles and counts lie from the first's:
the floor of run-to-run spread in one package.  With `--jitter` 0 (the
default) the repeats differ only in the order the kernels' atomics sum
in (deterministic on the CPU); with `--jitter` J every repeat after the
first starts from the state's surfel positions moved by Gaussian noise
of J metres (its own seed each).
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os

import torch

from lidar_rt_tpu_torch.scripts.e2e_rehearsal import DATA

QUANTILES = (0.5, 0.9, 0.99, 0.999)


def statistic(trainer, opts) -> dict:
    """Density control's statistic on `trainer`'s background: surfels
    seen and alive, the quantiles of grad_accum / denom over the seen
    ones, and the counts at or above the threshold to clone and split."""
    bg = trainer.state.scene.background
    stats = trainer.state.stats_bg
    seen = bg.alive & (stats.denom > 0)
    mean = stats.grad_accum[seen] / stats.denom[seen]
    big = (bg.scales.max(-1).values[seen]
           > float(opts.opt.densify_scale_threshold) * bg.extent)
    q = torch.quantile(mean.double(), torch.tensor(
        QUANTILES, dtype=torch.float64, device=mean.device)).tolist()
    over = mean >= float(opts.opt.densify_grad_threshold)
    return {"seen": int(seen.sum()), "alive": int(bg.alive.sum()),
            "quantiles": q, "clone": int((over & ~big).sum()),
            "split": int((over & big).sum())}


def jittered(scene, metres: float, seed: int):
    """`scene` with every surfel position (background and actors) moved by
    Gaussian noise of `metres`, drawn from a generator seeded `seed`."""
    if metres == 0.0:
        return scene
    gen = torch.Generator(device=scene.background.xyz.device)
    gen.manual_seed(seed)

    def move(asset):
        p = asset.params()
        p["xyz"] = p["xyz"] + metres * torch.randn(
            p["xyz"].shape, generator=gen, device=p["xyz"].device)
        return asset.with_params(p)

    return dataclasses.replace(
        scene, background=move(scene.background),
        actors=None if scene.actors is None else move(scene.actors))


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
    p.add_argument("--repeats", type=int, default=1,
                   help="trainings of each mode from the state")
    p.add_argument("--jitter", type=float, default=0.0,
                   help="metres of position noise on repeats after the "
                        "first")
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
        for r in range(a.repeats):
            key = mode if r == 0 else f"{mode}/{r}"
            start = scene if r == 0 else jittered(scene, a.jitter, r)
            trainer = loop.Trainer(
                copy.deepcopy(start), frames, opts,
                dataclasses.replace(cfg, **kw),
                warmup_cfg=dataclasses.replace(warmup_cfg, **kw),
                warmup_until=warmup_until)
            trainer.run(a.steps, log_every=a.steps)
            out[key] = statistic(trainer, opts)
            out[key]["loss"] = trainer.history[-1]["loss"]
            st = out[key]
            print(f"{key}: {a.steps} steps, {st['seen']} of {st['alive']} "
                  f"background surfels seen; grad_accum / denom quantiles "
                  f"{dict(zip(QUANTILES, st['quantiles']))}; at or above "
                  f"{float(opts.opt.densify_grad_threshold)}: "
                  f"{st['clone']} to clone, {st['split']} to split; last "
                  f"loss {st['loss']:.5f}", flush=True)
            if r > 0:
                first = out[mode]
                gap = [abs(x - y) / y for x, y in zip(st["quantiles"],
                                                       first["quantiles"])]
                print(f"{key} against {mode} (jitter {a.jitter} m): "
                      f"quantile gaps {dict(zip(QUANTILES, gap))}; to "
                      f"split {st['split']} / {first['split']}, to clone "
                      f"{st['clone']} / {first['clone']}; seen "
                      f"{st['seen']} / {first['seen']}", flush=True)
            del trainer
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
