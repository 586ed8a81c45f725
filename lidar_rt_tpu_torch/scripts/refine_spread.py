"""The refine U-Net's spread over seeds on a trained rehearsal model.

    python -m lidar_rt_tpu_torch.scripts.refine_spread
        [-dc configs/rehearsal/waymo.yaml] [-ec configs/rehearsal/exp.yaml]
        [--seeds 0 1 2 3 4] [--epochs N] [-t all] [--device cuda]
        [--json out.json]

After `e2e_rehearsal train` (or `cli train`) on the same configs: loads
the model directory's best checkpoint, renders the training
frames once (`train.refine.collect_inputs`, as `cli train` does), then for
each seed trains the U-Net with `train_unet(..., seed=seed)` at the
config's epochs (or --epochs), batch size and learning rate, and runs the
eval runner's metric pass (`cli eval -t all`'s frames, no LPIPS) with it.
Prints one JSON line per seed: at frames `FRAMES` the raydrop
accuracy of the U-Net in eval mode (running BatchNorm statistics, what
`cli eval` applies) and in train mode (each frame's own batch statistics,
dropout off), at the runner's 0.4 drop threshold; the mean depth MedAE
and PSNR, intensity PSNR, raydrop F1 and accuracy, Chamfer and F-score
over the evaluated frames and over the test frames; the U-Net's final
loss.  Then one line with each metric's range over the seeds, the
tracer kernels' launches and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import time

import numpy as np
import torch

from lidar_rt_tpu_torch import cli
from lidar_rt_tpu_torch import config as config_lib
from lidar_rt_tpu_torch.eval.runner import EvalRunner
from lidar_rt_tpu_torch.models.unet import unet_input
from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.scripts.e2e_rehearsal import card
from lidar_rt_tpu_torch.train import refine
from lidar_rt_tpu_torch.utils import checkpoint as ckpt_lib

# The trajectory's first, middle and last frames of the Waymo rehearsal.
FRAMES = (0, 25, 49)
# (group, metric) pairs reported per seed, as `results_all.json` keys them.
METRICS = (("depth", "medae"), ("depth", "psnr"), ("intensity", "psnr"),
           ("raydrop", "f1"), ("raydrop", "acc"), ("points", "chamfer_dist"),
           ("points", "fscore"))


def drop_accuracy(prob: torch.Tensor, gt_mask: torch.Tensor,
                  ratio: float) -> float:
    """The runner's raydrop accuracy: a ray is dropped where the refined
    probability is at least `ratio` (`EvalRunner.record_render`)."""
    return float(((prob >= ratio) == ~gt_mask).float().mean())


def _train_mode(model):
    """A copy of the U-Net that normalises with each input's own batch
    statistics, its dropout off."""
    m = copy.deepcopy(model).train()
    for mod in m.modules():
        if hasattr(mod, "dropout"):
            mod.dropout = 0.0
    return m


def _means(per_frame: dict, frames: list[int]) -> dict[str, float]:
    return {f"{g}/{k}": float(np.mean([per_frame[f][g][k] for f in frames]))
            for g, k in METRICS}


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser(
        prog="python -m lidar_rt_tpu_torch.scripts.refine_spread")
    p.add_argument("-dc", "--data_config",
                   default="configs/rehearsal/waymo.yaml")
    p.add_argument("-ec", "--exp_config",
                   default="configs/rehearsal/exp.yaml")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("-t", "--eval_type", default="all",
                   choices=["train", "test", "all"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--json", default=None,
                   help="also write every line's object here")
    a = p.parse_args(argv)
    dev = torch.device(a.device)
    launches = kernels.launch_counts()
    args = config_lib.parse(a.data_config, config_lib.parse(a.exp_config))
    cli.set_seed(int(args.get("seed", 1)))
    frames, _ = cli.load_dataset(args, dev)
    model_dir = cli._model_dir(args)
    path = ckpt_lib.find_best(os.path.join(model_dir, "models"))
    if path is None:
        p.error(f"no checkpoint under {model_dir}/models")
    scene, meta = ckpt_lib.load_scene(path, dev)
    cfg = cli.trace_configs(args, dev)[0]
    runner = EvalRunner(scene, frames, args, cfg)
    rc = args.refine
    spatial = bool(rc.use_spatial)
    epochs = int(rc.epochs) if a.epochs is None else a.epochs
    train_ids = frames.train_frames or list(range(frames.num_frames))
    t0 = time.perf_counter()
    inputs, labels = refine.collect_inputs(runner.render_frame, frames,
                                           train_ids, spatial)
    print(f"refine_spread: {path} (iteration {meta.get('iteration')}), "
          f"{len(train_ids)} training frames collected in "
          f"{time.perf_counter() - t0:.1f} s; {epochs} epochs a seed",
          flush=True)
    renders = {f: runner.render_frame(f) for f in FRAMES}

    lines = []
    for seed in a.seeds:
        t0 = time.perf_counter()
        model, hist = refine.train_unet(
            inputs, labels, epochs=epochs, batch_size=int(rc.batch_size),
            lr=float(rc.lr), seed=seed,
            use_rot=bool(rc.get("use_rot", False)))
        t_refine = time.perf_counter() - t0
        train_model = _train_mode(model)

        def rays(f):
            if not spatial:
                return ()
            origin, dirs = frames.rays(f)
            return (origin.expand_as(dirs), dirs)

        def unet_apply(f, out):
            return refine.apply_unet(model, out["raydrop"],
                                     out["intensity"], out["depth"],
                                     *rays(f))

        acc = {}
        for f, out in renders.items():
            with torch.no_grad():
                x = unet_input(out["raydrop"], out["intensity"],
                               out["depth"], *rays(f))
                prob = {"eval": unet_apply(f, out),
                        "train": train_model(x, torch.Generator(
                            device=dev))[0, 0]}
            acc[f] = {mode: drop_accuracy(v, frames.mask(f),
                                          runner.raydrop_ratio)
                      for mode, v in prob.items()}
        runner.unet_apply = unet_apply
        t0 = time.perf_counter()
        res = runner.run(a.eval_type, save_metrics=False)
        runner.unet_apply = None
        per_frame = {int(f): v for f, v in res["per_frame"].items()}
        line = {"seed": seed, "epochs": epochs, "final_loss": hist[-1],
                "accuracy": {str(f): v for f, v in acc.items()},
                "mean": _means(per_frame, sorted(per_frame)),
                "mean_test": _means(per_frame, [
                    f for f in frames.eval_frames if f in per_frame]),
                "refine_s": t_refine,
                "metric_pass_s": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)

    def span(vals):
        return [float(np.nanmin(vals)), float(np.nanmax(vals))]

    spread = {"seeds": a.seeds,
              "card": card() if dev.type == "cuda" else None,
              "range": {key: span([ln["mean"][key] for ln in lines])
                        for key in lines[0]["mean"]},
              "launches": kernels.launches_since(launches)}
    for f in FRAMES:
        for mode in ("eval", "train"):
            spread["range"][f"accuracy/{f}/{mode}"] = span(
                [ln["accuracy"][str(f)][mode] for ln in lines])
    print(json.dumps(spread), flush=True)
    if a.json:
        with open(a.json, "w") as fp:
            json.dump({"seeds": lines, "spread": spread}, fp, indent=1)
    return lines + [spread]


if __name__ == "__main__":
    main()
