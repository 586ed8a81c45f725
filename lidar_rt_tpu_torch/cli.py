"""The command line: training and evaluation (counterpart of
`lidar_rt_tpu.cli`).

    python -m lidar_rt_tpu_torch.cli train -dc <data.yaml> -ec <exp.yaml>
        [-m ckpt] [-r] [--resume] [--iterations N] [--device cuda]
    python -m lidar_rt_tpu_torch.cli eval -dc ... -ec ... [-m ckpt]
        [-un unet.npz] [-t train|test|all] [-e] [-i] [-p] [-u]

(`python -m lidar_rt_tpu_torch ...` is the same.)  The configs are read by
`lidar_rt_tpu_torch.config`, which needs no `yaml`; the data config's
`dataset:` key (synthetic | kitti360 | waymo) picks the loader.  Training
runs on `--device` (the card by default) in chunks of
`testing_iterations`: after each chunk the held-out intensity PSNR, a
visual, best-checkpoint retention and `logs/log.json`; then the U-Net
ray-drop refine and `models/unet.npz`.  Eval renders with the refined
ray-drop and writes `metrics/results_all.json`, PNGs, an APNG and PLYs.
The `tracer:` block's TPU options (approx_topk, ray_block) select nothing
here: the port bins with exact top-k, as the reference does off a TPU,
one thread per ray, and the CLI says so.  Its `fast_math` and `cache_fwd`
select the tracer kernels' training modes on the card
(`train.options.trace_configs`).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

import numpy as np
import torch

from lidar_rt_tpu_torch import config as config_lib
from lidar_rt_tpu_torch.data import build as build_lib
from lidar_rt_tpu_torch.train import options
from lidar_rt_tpu_torch.utils import checkpoint as ckpt_lib
from lidar_rt_tpu_torch.utils import console
from lidar_rt_tpu_torch.utils.record import Recorder

_LOSS_KEYS = ("loss", "depth", "intensity", "raydrop", "cd", "reg")


def set_seed(seed: int) -> None:
    """The host-side generators (frame shuffles, the loaders' numpy
    draws); device draws take explicit torch generators."""
    random.seed(seed)
    np.random.seed(seed)


def load_dataset(args, device: str | torch.device = "cuda"):
    """-> (LiDARFrames on `device`, list[ActorTrack] | None)."""
    name = str(args.get("dataset", "")).lower()
    src = str(args.get("source_dir", ""))
    if not name:
        name = ("waymo" if "waymo" in src
                else "kitti360" if "kitti" in src else "synthetic")
    if name == "synthetic":
        from lidar_rt_tpu_torch.data import synthetic
        kw = args.get("synthetic")
        kw = kw.to_dict() if kw is not None else {}
        frames, track = synthetic.generate(**kw, device=device)
        return frames, ([track] if track is not None else None)
    if name == "kitti360":
        from lidar_rt_tpu_torch.data import kitti
        return kitti.load(src, args, device=device)
    if name == "waymo":
        from lidar_rt_tpu_torch.data import waymo
        return waymo.load(src, args, device=device)
    raise ValueError(f"unknown dataset {name!r}")


def _model_dir(args) -> str:
    """output/<task>/<exp>/scene_<id>, the reference's layout
    (train.py:83-85)."""
    parts = [str(args.model_dir), str(args.task_name), str(args.exp_name)]
    sid = args.get("scene_id", "")
    if str(sid):
        parts.append(f"scene_{sid}")
    return os.path.join(*parts)


def trace_configs(args, device: torch.device):
    """`train.options.trace_configs` for `device`, logging the engine each
    budget resolves to and the `tracer:` block's TPU options, which the
    port does not read."""
    block = options.tracer_block(args)
    mapped = {k: block[k] for k in options.TPU_ONLY if k in block}
    if mapped:
        console.log(f"tracer: {mapped} select TPU code paths; the port "
                    "bins with exact top-k (as jax does off a TPU), one "
                    "thread per ray")
    cfg, warmup_cfg, warmup_until = options.trace_configs(args, device)
    budgets = [("budget", cfg)] if warmup_cfg is None else [
        ("warm-up budget", warmup_cfg), ("then", cfg)]
    console.log("tracer: " + "; ".join(
        f"{label} K={c.tile.max_per_tile} "
        f"{'exact' if c.exact_order else 'tile'} order on the "
        f"{c.resolve_engine()} engine" for label, c in budgets))
    return cfg, warmup_cfg, warmup_until


def held_out_psnr(trainer) -> tuple[float, list[float], dict]:
    """The held-out intensity PSNR of a trainer's scene: its mean over the
    eval frames (frame 0 without any), each frame's, and the first
    frame's render."""
    from lidar_rt_tpu_torch.train import losses

    frames = trainer.frames
    psnrs, first = [], None
    for f in frames.eval_frames or [0]:
        out = trainer.render_eval(f)
        if first is None:
            first = out
        psnrs.append(float(losses.psnr(out["intensity"].clamp(0, 1),
                                       frames.intensity(f),
                                       frames.mask(f))))
    return float(np.mean(psnrs)), psnrs, first


class _Stopwatch:
    """Seconds per named stage on the host clock, each ending once the
    device's queued work is done."""

    def __init__(self, device: torch.device):
        self.device, self.seconds = device, {}

    def add(self, name: str, t0: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] = self.seconds.get(name, 0.0) \
            + time.perf_counter() - t0


def _prior_log(model_dir: str, iteration: int) -> dict:
    """What logs/log.json holds up to `iteration` (a resumed run continues
    the history it resumes)."""
    path = os.path.join(model_dir, "logs", "log.json")
    if not os.path.exists(path):
        return {"history": [], "densify": [], "eval_history": []}
    with open(path) as fp:
        log = json.load(fp)
    return {k: [e for e in log.get(k, []) if e["iteration"] <= iteration]
            for k in ("history", "densify", "eval_history")}


def _train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lidar_rt_tpu_torch.cli train")
    p.add_argument("-dc", "--data_config", required=True)
    p.add_argument("-ec", "--exp_config", required=True)
    p.add_argument("-m", "--model_path", default=None,
                   help="checkpoint to resume from (reference train.py -m)")
    p.add_argument("-r", "--only_refine", action="store_true",
                   help="skip the surfel optimization; only refine the "
                        "U-Net from the -m checkpoint (reference train.py "
                        "--only_refine)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the best checkpoint in model_dir")
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--device", default="cuda")
    return p


def main_train(argv=None):
    """Train, and return the Trainer."""
    from lidar_rt_tpu_torch.ops import kernels
    from lidar_rt_tpu_torch.train import loop as loop_lib
    from lidar_rt_tpu_torch.utils import profiling
    from lidar_rt_tpu_torch.utils.export import colormap, write_png

    p = _train_parser()
    a = p.parse_args(argv)
    if a.only_refine and not (a.model_path or a.resume):
        p.error("-r/--only_refine needs -m (a trained model to refine)")
    launches = kernels.launch_counts()
    device = torch.device(a.device)
    args = config_lib.parse(a.data_config, config_lib.parse(a.exp_config))
    set_seed(int(args.get("seed", 1)))
    clock = _Stopwatch(device)

    t0 = time.perf_counter()
    frames, tracks = load_dataset(args, device)
    clock.add("load", t0)
    model_dir = _model_dir(args)
    models_dir = os.path.join(model_dir, "models")
    os.makedirs(model_dir, exist_ok=True)
    recorder = Recorder(os.path.join(model_dir, "logs"))

    t0 = time.perf_counter()
    scene = build_lib.assemble_scene(frames, tracks, args)
    clock.add("assemble", t0)
    cfg, warmup_cfg, warmup_until = trace_configs(args, device)

    def new_trainer(scene):
        trainer = loop_lib.Trainer(scene, frames, args, cfg,
                                   warmup_cfg=warmup_cfg,
                                   warmup_until=warmup_until)
        trainer.snapshot_dir = os.path.join(model_dir, "snapshots")
        return trainer

    trainer = new_trainer(scene)
    if bool(args.get("detect_anomaly", False)):
        from lidar_rt_tpu_torch.utils.profiling import \
            enable_anomaly_detection
        enable_anomaly_detection(True)

    eval_history: list[dict] = []
    if a.resume or a.model_path:
        path = a.model_path or ckpt_lib.find_best(models_dir)
        if path is None and a.only_refine:
            p.error(f"--only_refine: no checkpoint found under "
                    f"{models_dir} (and no -m given)")
        if path:
            state, meta = ckpt_lib.load(path, device, opt_args=args.opt)
            it = int(meta.get("iteration", 0))
            if isinstance(state, loop_lib.TrainState):
                trainer.restore(state, it)
            else:
                # A bare Scene (e.g. imported from a LiDAR-RT .pth): fresh
                # optimizer moments around its parameters.
                trainer = new_trainer(state)
                trainer.iteration = it
            prior = _prior_log(model_dir, it)
            trainer.history = prior["history"]
            trainer.densify_log = prior["densify"]
            eval_history = prior["eval_history"]
            print(f"resumed from {path} @ iteration {it}")

    total = a.iterations or int(args.opt.iterations)
    if a.only_refine:
        total = trainer.iteration   # no optimization step
    testing_every = int(args.get("testing_iterations", 1000))
    saving = set(args.get("saving_iterations", []))
    best_psnr = max([e["eval_psnr"] for e in eval_history], default=-1.0)
    eval_frames = frames.eval_frames or [0]

    t_start = time.time()
    logged = len(trainer.history)
    while trainer.iteration < total:
        chunk = min(testing_every, total - trainer.iteration)
        t0 = time.perf_counter()
        hist = trainer.run(iterations=chunk, log_every=100)
        clock.add("steps", t0)
        recorder.step = trainer.iteration
        for entry in hist[logged:]:
            recorder.update_loss_stats(
                {k: entry[k] for k in _LOSS_KEYS if k in entry})
        logged = len(hist)
        recorder.record("train")

        # Periodic eval, visuals and best-checkpoint retention
        # (train.py:271-302, 328-380).
        t0 = time.perf_counter()
        mean_psnr, psnrs, vis = held_out_psnr(trainer)
        is_best = mean_psnr > best_psnr
        best_psnr = max(best_psnr, mean_psnr)
        it = trainer.iteration
        eval_history.append({"iteration": it, "eval_psnr": mean_psnr,
                             "per_frame": [round(x, 4) for x in psnrs],
                             "alive": hist[-1]["alive"]})
        gt_d = frames.depth(eval_frames[0]).cpu().numpy()
        scale = max(float(gt_d.max()), 1e-6)
        img = np.concatenate([
            colormap(vis["depth"].cpu().numpy() / scale),
            colormap(gt_d / scale),
            colormap(vis["intensity"].clamp(0, 1).cpu().numpy()),
        ], axis=0)
        os.makedirs(os.path.join(model_dir, "visuals"), exist_ok=True)
        write_png(os.path.join(model_dir, "visuals", f"it_{it:06d}.png"),
                  img)
        if is_best or it in saving or it >= total:
            ckpt_lib.retain_best(models_dir, it, trainer.state, is_best,
                                 {"iteration": it, "eval_psnr": mean_psnr})
        clock.add("periodic_eval", t0)
        console.log(
            f"[{time.time() - t_start:8.1f}s] it {it}/{total} "
            f"loss {hist[-1]['loss']:.4f} eval intensity PSNR "
            f"{console.bold(f'{mean_psnr:.2f}')}"
            f"{console.green(' *best*') if is_best else ''} "
            f"alive {hist[-1]['alive']}")

    def dump_log() -> None:
        # Written before and after the refine, so that the eval
        # trajectory survives a refine-stage crash (train.py:450-501).
        with open(os.path.join(model_dir, "logs", "log.json"), "w") as fp:
            json.dump({"history": trainer.history,
                       "densify": trainer.densify_log,
                       "eval_history": eval_history,
                       "seconds": clock.seconds,
                       "launches": kernels.launches_since(launches),
                       "peak_mib": profiling.peak_mib(device),
                       "refine_loss": refine_loss},
                      fp, indent=1)

    refine_loss: list[float] = []      # mean U-Net loss per epoch
    dump_log()
    if a.only_refine or bool(args.refine.use_refine):
        from lidar_rt_tpu_torch.train import refine as refine_lib
        train_ids = frames.train_frames or list(range(frames.num_frames))
        t0 = time.perf_counter()
        inputs, labels = refine_lib.collect_inputs(
            trainer.render_eval, frames, train_ids,
            bool(args.refine.use_spatial))
        clock.add("refine_collect", t0)
        t0 = time.perf_counter()
        model, hist = refine_lib.train_unet(
            inputs, labels, epochs=int(args.refine.epochs),
            batch_size=int(args.refine.batch_size),
            lr=float(args.refine.lr),
            use_rot=bool(args.refine.get("use_rot", False)))
        clock.add("refine_epochs", t0)
        refine_loss.extend(hist)
        ckpt_lib.save(os.path.join(models_dir, "unet.npz"),
                      model.state_dict(),
                      {"in_ch": int(inputs.shape[1]),
                       "final_loss": hist[-1]})
        print(f"unet refinement: {hist[0]:.4f} -> {hist[-1]:.4f}")
    dump_log()
    _write_log_plot(os.path.join(model_dir, "logs", "log.png"),
                    trainer.history, trainer.densify_log)
    recorder.close()
    return trainer


def _write_log_plot(path: str, history: list[dict],
                    densify_log: list[dict]) -> None:
    """logs/log.png: the loss curve and alive-surfel count with the
    densify events (train.py:450-501's plot), where matplotlib is
    installed; a plot only, on no device path."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    its = [h["iteration"] for h in history if "loss" in h]
    loss = [h["loss"] for h in history if "loss" in h]
    fig, ax1 = plt.subplots(figsize=(8, 6))
    ax1.plot(its, loss, color="tab:blue", lw=0.8)
    ax1.set_xlabel("iteration")
    ax1.set_ylabel("loss", color="tab:blue")
    ax1.set_yscale("log")
    ax2 = ax1.twinx()
    alive_pts = [(h["iteration"], h["alive"]) for h in history
                 if "alive" in h]
    if alive_pts:
        ax2.plot(*zip(*alive_pts), color="tab:red")
        ax2.set_ylabel("alive surfels", color="tab:red")
    for ev in densify_log:
        ax1.axvline(ev.get("iteration", 0), color="gray", alpha=0.15, lw=0.5)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lidar_rt_tpu_torch.cli eval")
    p.add_argument("-dc", "--data_config", required=True)
    p.add_argument("-ec", "--exp_config", required=True)
    p.add_argument("-m", "--model_path", default=None)
    p.add_argument("-un", "--unet_path", default=None)
    p.add_argument("-t", "--eval_type", default="test",
                   choices=["train", "test", "all"])
    # Artifact switches (reference eval.py:549-556).
    p.add_argument("-e", "--save_eval", action="store_true",
                   help="write results_all.json + per-frame metrics")
    p.add_argument("-i", "--save_image", action="store_true",
                   help="write gt/pred PNG snapshots + depth animation")
    p.add_argument("-p", "--save_pcd", action="store_true",
                   help="write gt/pred PLY pairs")
    p.add_argument("-u", "--use_gt_mask", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


def main_eval(argv=None) -> dict:
    """Evaluate, and return the results dict."""
    from lidar_rt_tpu_torch.eval.lpips import make_lpips_fn
    from lidar_rt_tpu_torch.eval.runner import EvalRunner

    a = _eval_parser().parse_args(argv)
    device = torch.device(a.device)
    args = config_lib.parse(a.data_config, config_lib.parse(a.exp_config))
    frames, _ = load_dataset(args, device)
    model_dir = _model_dir(args)

    path = a.model_path or ckpt_lib.find_best(os.path.join(model_dir,
                                                           "models"))
    if path is None:
        raise FileNotFoundError(f"no checkpoint under {model_dir}/models")
    scene, meta = ckpt_lib.load_scene(path, device)
    print(f"evaluating {path} (meta {meta})")

    unet_apply = None
    unet_path = a.unet_path or os.path.join(model_dir, "models", "unet.npz")
    if os.path.exists(unet_path):
        from lidar_rt_tpu_torch.models.unet import make_unet
        from lidar_rt_tpu_torch.train.refine import apply_unet
        weights, umeta = ckpt_lib.load(unet_path)
        in_ch = int(umeta.get("in_ch", 3))
        model = make_unet(in_ch, device)
        model.load_state_dict({k: torch.as_tensor(v)
                               for k, v in weights.items()})

        def unet_apply(f, out):
            rays = ()
            if in_ch > 3:
                origin, dirs = frames.rays(f)
                rays = (origin.expand_as(dirs), dirs)
            return apply_unet(model, out["raydrop"], out["intensity"],
                              out["depth"], *rays)
        print(f"using unet {unet_path}")

    runner = EvalRunner(scene, frames, args,
                        trace_configs(args, device)[0],
                        unet_apply=unet_apply, use_gt_mask=a.use_gt_mask,
                        lpips_fn=make_lpips_fn(device=device))
    results = runner.run(a.eval_type, os.path.join(model_dir, "metrics"),
                         save_images=a.save_image, save_pcds=a.save_pcd,
                         save_metrics=a.save_eval)
    print(json.dumps(results["mean"], indent=2))
    return results


def main(argv=None):
    """`train ...` or `eval ...`."""
    argv = sys.argv[1:] if argv is None else list(argv)
    commands = {"train": main_train, "eval": main_eval}
    if not argv or argv[0] not in commands:
        raise SystemExit("usage: python -m lidar_rt_tpu_torch.cli "
                         "{train,eval} -dc DATA.yaml -ec EXP.yaml ...")
    return commands[argv[0]](argv[1:])


if __name__ == "__main__":
    main()
