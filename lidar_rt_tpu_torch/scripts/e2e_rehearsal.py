"""The end-to-end rehearsal through the port's command line (counterpart
of the reference's `scripts/e2e_rehearsal.py`).

    python -m lidar_rt_tpu_torch.scripts.e2e_rehearsal gen
    python -m lidar_rt_tpu_torch.scripts.e2e_rehearsal train {waymo|kitti}
        [--split N[,M...]]
    python -m lidar_rt_tpu_torch.scripts.e2e_rehearsal eval {waymo|kitti}
    python -m lidar_rt_tpu_torch.scripts.e2e_rehearsal collect
        [--data /tmp/e2e_data] [--out output/rehearsal] [--device cuda]
        [-ec configs/rehearsal/exp.yaml]
    python -m lidar_rt_tpu_torch.scripts.e2e_rehearsal train|collect
        waymo --fork N [--fork_to M] --forks CONFIG[:COUNT],...

`gen` renders both rehearsal datasets with the port's `synthetic` on the
device and writes them in their wire formats under --data: a Waymo
segment (50 frames, 64 x 2650, two returns, a street scene and 3 moving
vehicles) and a KITTI-360 sequence (40 frames, 66 x 1030, one car).
`train` and `eval` run `python -m lidar_rt_tpu_torch.cli train` and
`eval -t all -e -i` on `configs/rehearsal/<which>.yaml` and the
experiment config as child processes and print each command's seconds.
`-ec configs/rehearsal/full.yaml` runs the configs' uncompressed 30,000-step
schedule.  `train --split N,M` runs it as chunks ending at N, M and the
schedule's end, each a `cli train --iterations` resumed with `-m` from
the previous chunk's checkpoint (for a run longer than one sitting): only
the last chunk refines the U-Net, every chunk starts by re-binning (the
bin cache is not checkpointed), `log.json` goes on from the checkpoint's
iteration, and `logs/chunks.json` keeps each chunk's stage seconds,
launches and peak memory.  Split points must be multiples of
`testing_iterations` and of `rebin_interval`.
`train --fork N --fork_to M --forks ...` trains to N once (a chunk, no
refine), then runs each fork side by side as `cli train -m <its
checkpoint at N> --iterations M` under its own experiment config and
model directory (`<out>/forks/<name>`, refine off); `collect --fork N
--forks ...` writes `<out>/forks.json` (`collect_forks`: each run's evals,
loss and ms per step per 1,000 steps, densify events, and each fork's
drop: the base's mean held-out PSNR at N and one testing interval
before, less the fork's at its last eval and one interval before).
`collect` writes `<out>/e2e_torch.json` in the schema of the reference's
record `E2E_r05.json` (per dataset: mean metrics, the held-out PSNR
history with the alive surfels, final loss, iterations, the U-Net's
digest and steady-state iterations per second), plus the card's name and
power limit, and prints each dataset's stage seconds, ms per step at
each candidate budget and peak memory from `logs/log.json`; beside it,
`<out>/e2e_torch_logs.json` keeps what that schema leaves out (per
dataset `train_log`: those figures and the U-Net's loss per epoch;
`densify_events`: every densify event with its dropped count).

With the defaults the configs run as they are (their `source_dir` is
/tmp/e2e_data/<dataset>, their `model_dir`/`task_name` output/rehearsal);
any other --data, --out or -ec runs through a child experiment config
written under --out that points them there.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

from lidar_rt_tpu_torch import cli
from lidar_rt_tpu_torch import config as config_lib
from lidar_rt_tpu_torch.scripts.import_roundtrip import REPO, child_env, run

DATA = "/tmp/e2e_data"
OUT = os.path.join("output", "rehearsal")
EXP = os.path.join(REPO, "configs", "rehearsal", "exp.yaml")
# Dataset -> (data config, directory under --data, key in the record).
DATASETS = {"waymo": ("waymo.yaml", "waymo", "waymo"),
            "kitti": ("kitti.yaml", "kitti360", "kitti360")}
SHAPES = {"waymo": [50, 64, 2650, 2], "kitti360": [40, 66, 1030, 1]}


def waymo_scene(synthetic):
    """The rehearsal's Waymo street scene: corridor walls and facades over
    the full azimuth circle, three moving vehicles."""
    box = synthetic.Box
    walls = [
        box(np.array([25.0, -9.0, 2.5]), np.array([50.0, 1.5, 5.0]),
            yaw=0.05, albedo=0.7),
        box(np.array([20.0, 8.5, 2.0]), np.array([40.0, 1.5, 4.0]),
            yaw=-0.03, albedo=0.65),
        box(np.array([-30.0, -12.0, 3.0]), np.array([25.0, 2.0, 6.0]),
            yaw=0.3, albedo=0.6),
        box(np.array([-22.0, 14.0, 2.5]), np.array([30.0, 2.0, 5.0]),
            yaw=-0.2, albedo=0.75),
        box(np.array([55.0, 3.0, 4.0]), np.array([3.0, 18.0, 8.0]),
            albedo=0.8),
        box(np.array([-5.0, 35.0, 3.0]), np.array([20.0, 3.0, 6.0]),
            yaw=1.2, albedo=0.55),
        box(np.array([8.0, -30.0, 2.0]), np.array([14.0, 2.5, 4.0]),
            yaw=-0.9, albedo=0.6),
        box(np.array([3.0, 18.0, 0.8]), np.array([1.0, 1.0, 1.6]),
            albedo=0.9),
    ]
    actors = [
        box(np.array([12.0, -3.5, 0.85]), np.array([4.6, 1.9, 1.7]),
            yaw=0.0, albedo=0.9),
        box(np.array([30.0, 3.2, 0.9]), np.array([4.2, 1.8, 1.8]),
            yaw=3.1, albedo=0.85),
        box(np.array([-18.0, 2.8, 1.1]), np.array([8.5, 2.4, 2.2]),
            yaw=0.1, albedo=0.8),
    ]
    velocities = [np.array([0.9, 0.02, 0.0]), np.array([-0.7, 0.0, 0.0]),
                  np.array([0.5, -0.01, 0.0])]
    return synthetic.SyntheticScene(
        walls=walls, ground_albedo=0.45, actor=actors[0],
        actor_velocity=velocities[0], extra_actors=actors[1:],
        extra_velocities=velocities[1:], max_range=75.0)


def gen_waymo(base: str, dev, frames: int = 50, h: int = 64,
              w: int = 2650) -> dict[str, np.ndarray]:
    """Render the Waymo rehearsal segment on `dev` and write it as a
    TFRecord under `base` (the TOP lidar's ascending beam table, an
    extrinsic with a yaw offset); returns the rendered images."""
    from lidar_rt_tpu_torch.core import rays as rays_lib
    from lidar_rt_tpu_torch.data import synthetic, writers

    scene = waymo_scene(synthetic)
    beams = np.linspace(-0.31, 0.04, h)
    yaw_e = 0.05
    extrinsic = np.eye(4)
    extrinsic[:2, :2] = [[np.cos(yaw_e), -np.sin(yaw_e)],
                         [np.sin(yaw_e), np.cos(yaw_e)]]
    extrinsic[2, 3] = 2.1
    grid = rays_lib.SensorGrid.from_beams(
        np.asarray(beams, np.float32), pixel_offset=0.5, angle_offset=yaw_e,
        device=dev)
    ego2world = np.tile(np.eye(4), (frames, 1, 1))
    for f in range(frames):
        ego2world[f, :3, 3] = [f * 0.55, 0.02 * f, 0.0]
    images = np.zeros((4, frames, h, w), np.float32)
    labels = []
    for f in range(frames):
        out = synthetic.render_frame_gt_dual(scene, grid, w,
                                             ego2world[f] @ extrinsic, f)
        for i, img in enumerate(out):
            images[i, f] = img.cpu().numpy()
        inv_e = np.linalg.inv(ego2world[f])
        labels.append([(f"veh_{a}", inv_e[:3, :3] @ center + inv_e[:3, 3],
                        box.size[[0, 1, 2]], box.yaw)
                       for a, (box, center) in enumerate(
                           scene.moving_boxes(f))])
    r1, i1, r2, i2 = images
    writers.write_waymo_segment(
        base, ego2world=ego2world, extrinsic=extrinsic,
        beam_inclinations=beams, range1=r1, intensity1=i1, range2=r2,
        intensity2=i2, labels_per_frame=labels)
    return {"range1": r1, "intensity1": i1, "range2": r2, "intensity2": i2}


def gen_kitti(base: str, dev, frames: int = 40) -> dict[str, np.ndarray]:
    """Render the KITTI-360 rehearsal sequence on `dev` and write it as a
    bin/pose/XML tree under `base`; returns the rendered images."""
    from lidar_rt_tpu_torch.core import rays as rays_lib
    from lidar_rt_tpu_torch.data import kitti, synthetic, writers

    box = synthetic.Box
    walls = [
        box(np.array([20.0, -7.0, 2.0]), np.array([45.0, 1.2, 4.0]),
            yaw=0.02, albedo=0.7),
        box(np.array([15.0, 7.5, 1.8]), np.array([35.0, 1.4, 3.6]),
            yaw=-0.04, albedo=0.6),
        box(np.array([-20.0, -10.0, 2.5]), np.array([18.0, 2.0, 5.0]),
            yaw=0.4, albedo=0.65),
        box(np.array([45.0, 0.0, 3.0]), np.array([2.5, 14.0, 6.0]),
            albedo=0.75),
        box(np.array([-2.0, 20.0, 1.5]), np.array([10.0, 2.0, 3.0]),
            yaw=1.0, albedo=0.55),
    ]
    actor = box(np.array([10.0, -2.5, 0.8]), np.array([4.3, 1.8, 1.6]),
                yaw=0.05, albedo=0.9)
    scene = synthetic.SyntheticScene(
        walls=walls, ground_albedo=0.4, actor=actor,
        actor_velocity=np.array([0.6, 0.0, 0.0]), max_range=79.0)
    grid = rays_lib.SensorGrid.from_bounds(
        kitti.H, (kitti.INC_BOTTOM, kitti.INC_TOP), pixel_offset=0.0,
        angle_offset=0.0, device=dev)
    poses = np.tile(np.eye(4), (frames, 1, 1))
    for f in range(frames):
        poses[f, :3, 3] = [f * 0.5, 0.0, 1.73]
    r1 = np.zeros((frames, kitti.H, kitti.W), np.float32)
    i1 = np.zeros_like(r1)
    boxes = {}
    for f in range(frames):
        r, i = synthetic.render_frame_gt(scene, grid, kitti.W, poses[f], f)
        r1[f], i1[f] = r.cpu().numpy(), i.cpu().numpy()
        t = np.eye(4)
        t[:3, :3] = actor.rotation() @ np.diag(actor.size)
        t[:3, 3] = actor.center + f * scene.actor_velocity
        boxes[f] = t
    writers.write_kitti360_sequence(base, seq="0000", sensor2world=poses,
                                    range1=r1, intensity1=i1,
                                    boxes=[("11", boxes)])
    return {"range1": r1, "intensity1": i1}


def configs(a, which: str) -> tuple[str, str]:
    """(data config, experiment config) of `which` for the options `a`:
    the rehearsal's own with the defaults, else a child experiment config
    under --out that sends the run's data and outputs where `a` says."""
    dc = os.path.join(REPO, "configs", "rehearsal", DATASETS[which][0])
    if (os.path.abspath(a.data) == DATA and os.path.abspath(a.out)
            == os.path.abspath(OUT) and os.path.abspath(a.exp_config)
            == EXP):
        return dc, EXP
    out = os.path.abspath(a.out)
    os.makedirs(out, exist_ok=True)
    ec = os.path.join(out, f"{which}_exp.yaml")
    with open(ec, "w") as f:
        f.write(f"""# The rehearsal's experiment, its data and outputs moved.
parent_config: "{os.path.abspath(a.exp_config)}"
model_dir: "{os.path.dirname(out)}"
task_name: "{os.path.basename(out)}"
source_dir: "{os.path.join(os.path.abspath(a.data), DATASETS[which][1])}"
""")
    return dc, ec


def run_cli(a, kind: str, which: str) -> float:
    """`cli train` (split at `a.split`, if any) or `cli eval -t all -e -i`
    on `which` as child processes; their seconds."""
    dc, ec = configs(a, which)
    if kind == "train" and a.split:
        secs = train_chunks(dc, ec, a.split, os.path.abspath(a.out),
                            a.device)
        print(f"train {which} in {len(a.split) + 1} chunks: {secs:.2f} s",
              flush=True)
        return secs
    cmd = [sys.executable, "-m", "lidar_rt_tpu_torch.cli", kind, "-dc", dc,
           "-ec", ec, "--device", a.device]
    if kind == "eval":
        cmd += ["-t", "all", "-e", "-i"]
    secs = run(cmd)
    print(f"{kind} {which}: {secs:.2f} s", flush=True)
    return secs


def chunk_configs(dc: str, ec: str, splits: list[int], out: str
                  ) -> list[tuple[str, int]]:
    """(experiment config, last iteration) of each chunk of a run of `ec`
    split at `splits`: the chunks before the last run `ec` with the U-Net
    refine off (child configs under `out`), the last runs `ec` itself."""
    args = config_lib.parse(dc, config_lib.parse(ec))
    total = int(args.opt.iterations)
    steps = (int(args.get("testing_iterations", 1000)),
             max(int(args.opt.get("rebin_interval", 1) or 1), 1))
    if list(splits) != sorted(set(splits)) or not all(
            0 < n < total and n % steps[0] == 0 and n % steps[1] == 0
            for n in splits):
        raise ValueError(f"split points {splits} must rise inside (0, "
                         f"{total}) at multiples of testing_iterations "
                         f"{steps[0]} and rebin_interval {steps[1]}")
    os.makedirs(out, exist_ok=True)
    chunks = []
    for i, end in enumerate(splits):
        path = os.path.join(out, f"chunk{i}_{os.path.basename(ec)}")
        with open(path, "w") as f:
            f.write(f"""# Chunk {i} of a split run: to {end}, no refine.
parent_config: "{os.path.abspath(ec)}"
refine:
  use_refine: false
""")
        chunks.append((path, end))
    return chunks + [(ec, total)]


def chunk_checkpoint(models_dir: str, iteration: int) -> str:
    """The checkpoint a chunk saved at its last iteration."""
    for suffix in ("_good", ""):
        path = os.path.join(models_dir, f"ckpt_it_{iteration}{suffix}.npz")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no checkpoint of iteration {iteration} "
                            f"under {models_dir}")


def train_chunks(dc: str, ec: str, splits: list[int], out: str,
                 device: str) -> float:
    """`cli train` of `ec` split at `splits` (`chunk_configs`), each chunk
    resumed with `-m` from the last one's checkpoint; writes
    `logs/chunks.json` and returns the seconds of all chunks."""
    mdir = cli._model_dir(config_lib.parse(dc, config_lib.parse(ec)))
    secs, start, chunks = 0.0, None, []
    for chunk_ec, end in chunk_configs(dc, ec, splits, out):
        cmd = [sys.executable, "-m", "lidar_rt_tpu_torch.cli", "train",
               "-dc", dc, "-ec", chunk_ec, "--device", device,
               "--iterations", str(end)]
        if start is not None:
            cmd += ["-m", chunk_checkpoint(os.path.join(mdir, "models"),
                                           start)]
        t = run(cmd)
        secs += t
        with open(os.path.join(mdir, "logs", "log.json")) as f:
            log = json.load(f)
        chunks.append({"from": start or 0, "to": end, "command_s": t,
                       **{k: log[k] for k in ("seconds", "launches",
                                              "peak_mib")}})
        start = end
    with open(os.path.join(mdir, "logs", "chunks.json"), "w") as f:
        json.dump(chunks, f, indent=1)
    return secs


def fork_specs(specs: list[str]) -> list[tuple[str, str]]:
    """(name, experiment config) of each fork of `--forks`: each entry
    `config[:count]` gives `count` forks (default 1) named
    `<config's stem>_<j>`, j from 1."""
    out = []
    for spec in specs:
        path, _, count = spec.partition(":")
        stem = os.path.splitext(os.path.basename(path))[0]
        out += [(f"{stem}_{j}", os.path.abspath(path))
                for j in range(1, int(count or 1) + 1)]
    return out


def fork_configs(dc: str, ec: str, specs: list[str], out: str
                 ) -> list[tuple[str, str, str]]:
    """(name, experiment config, model directory) of each fork of
    `specs`: its config written under `<out>/forks` with the run's data,
    the model directory `<out>/forks/<name>/...` and the U-Net refine
    off."""
    source = config_lib.parse(dc, config_lib.parse(ec)).source_dir
    os.makedirs(os.path.join(out, "forks"), exist_ok=True)
    forks = []
    for name, path in fork_specs(specs):
        cfg = os.path.join(out, "forks", f"{name}.yaml")
        with open(cfg, "w") as f:
            f.write(f"""# Fork {name}: {path} resumed from the base run, no refine.
parent_config: "{path}"
source_dir: "{source}"
model_dir: "{os.path.join(out, 'forks')}"
task_name: "{name}"
refine:
  use_refine: false
""")
        forks.append((name, cfg, cli._model_dir(
            config_lib.parse(dc, config_lib.parse(cfg)))))
    return forks


def train_forks(dc: str, ec: str, at: int, to: int, specs: list[str],
                out: str, device: str) -> dict[str, float]:
    """`cli train` of `ec` to `at` (a chunk of `chunk_configs`, no
    refine), then every fork of `specs` side by side as child processes,
    each `cli train -m <the base's checkpoint at at> --iterations to` in
    its own model directory, its output in `<out>/forks/<name>.log`.
    The base run writes the loader's cache before any fork reads it.
    Returns each command's seconds."""
    base_ec = chunk_configs(dc, ec, [at], out)[0][0]
    secs = {"base": run([sys.executable, "-m", "lidar_rt_tpu_torch.cli",
                         "train", "-dc", dc, "-ec", base_ec, "--device",
                         device, "--iterations", str(at)])}
    base_dir = cli._model_dir(config_lib.parse(dc, config_lib.parse(ec)))
    ckpt = chunk_checkpoint(os.path.join(base_dir, "models"), at)
    procs = []
    for name, cfg, _ in fork_configs(dc, ec, specs, out):
        cmd = [sys.executable, "-m", "lidar_rt_tpu_torch.cli", "train",
               "-dc", dc, "-ec", cfg, "--device", device, "--iterations",
               str(to), "-m", ckpt]
        print("+", " ".join(cmd), flush=True)
        log = open(os.path.join(out, "forks", f"{name}.log"), "w")
        proc = subprocess.Popen(cmd, env=child_env(), stdout=log,
                                stderr=subprocess.STDOUT)
        procs.append((name, proc, log, time.perf_counter()))
    failed = []
    for name, proc, log, t0 in procs:
        rc = proc.wait()
        secs[name] = time.perf_counter() - t0
        log.close()
        print(f"fork {name}: rc {rc}, {secs[name]:.2f} s", flush=True)
        if rc:
            failed.append(name)
    if failed:
        raise RuntimeError(f"forks {failed} failed; see {out}/forks/")
    return secs


# A fork's drop: the base run's mean held-out PSNR over its evals at the
# fork and one testing interval before, less the fork's over its last
# eval and one base testing interval before.  A fork at a drop of
# DECLINE or more declines, at HOLD or less holds, and between is partial.
DECLINE, HOLD = 2.0, 0.5


def run_summary(mdir: str) -> dict:
    """What a run's `logs/log.json` holds, per 1,000-step chunk: held-out
    PSNR and the background's alive surfels at each eval, the mean loss
    and ms per step (from the history's stamps, each process from its
    second stamp), every densify event and their sums per asset, a digest
    of the frame order, the mean
    loss over the first and the last tenth of the steps between two
    events, the mean held-out PSNR at the evals right after an event and
    at the others, and the stage seconds, launches and peak memory."""
    with open(os.path.join(mdir, "logs", "log.json")) as f:
        log = json.load(f)
    hist = log["history"]
    loss, ms = {}, {}
    for h in hist:
        loss.setdefault(-(-h["iteration"] // 1000) * 1000, []).append(
            h["loss"])
    for seg in _segments(hist):
        for a, b in zip(seg, seg[1:]):
            chunk = -(-b["iteration"] // 1000) * 1000
            ms.setdefault(chunk, []).append(
                (b["iteration"] - a["iteration"], b["elapsed"] - a["elapsed"]))
    # The loss over the first and the last tenth of the steps between two
    # densify events: what an event does to the next steps' loss.
    events = sorted({e["iteration"] for e in log["densify"]})
    loss_at = {h["iteration"]: h["loss"] for h in hist}
    first, last = [], []
    for a, b in zip(events, events[1:]):
        n = max((b - a) // 10, 1)
        first += [loss_at[i] for i in range(a + 1, a + n + 1) if i in loss_at]
        last += [loss_at[i] for i in range(b - n + 1, b + 1) if i in loss_at]
    # Held-out PSNR at the evals that follow a densify event's own step
    # (the event runs before the eval) and at the other evals after the
    # first event.
    at_event, between = [], []
    for e in log["eval_history"]:
        if events and e["iteration"] > events[0]:
            (at_event if e["iteration"] in events else between).append(
                e["eval_psnr"])
    totals = {}
    for e in log["densify"]:
        t = totals.setdefault(e["asset"], dict.fromkeys(
            ("events", "cloned", "split", "pruned", "dropped"), 0))
        t["events"] += 1
        for k in ("cloned", "split", "pruned", "dropped"):
            t[k] += e[k]
    return {
        "eval": [{k: e[k] for k in ("iteration", "eval_psnr", "alive")}
                 for e in log["eval_history"]],
        "densify_totals": totals,
        # Runs that drew one frame order share this digest.
        "frame_order_sha256": hashlib.sha256(json.dumps(
            [h.get("frame") for h in hist]).encode()).hexdigest(),
        "loss_between_events": {
            "first_tenth": float(np.mean(first)) if first else None,
            "last_tenth": float(np.mean(last)) if last else None},
        "eval_psnr_vs_events": {
            "at_event": float(np.mean(at_event)) if at_event else None,
            "n_at_event": len(at_event),
            "between": float(np.mean(between)) if between else None,
            "n_between": len(between)},
        "loss_per_1000": {k: float(np.mean(v)) for k, v in loss.items()},
        "ms_per_step": {k: 1e3 * sum(t for _, t in v) / sum(n for n, _ in v)
                        for k, v in ms.items()},
        "densify": log["densify"],
        **{k: log[k] for k in ("seconds", "launches", "peak_mib")}}


def pair(evals: list[dict], end: int, gap: int) -> list[dict]:
    """The evals at `end - gap` and `end`: the two a drop reads, `gap`
    the base's `testing_iterations` (a fork may eval more often)."""
    by_it = {e["iteration"]: e for e in evals}
    return [by_it[end - gap], by_it[end]]


def collect_forks(dc: str, ec: str, at: int, specs: list[str], out: str
                  ) -> dict:
    """Write `<out>/forks.json`: the card, the base run's and each fork's
    `run_summary`, and each fork's drop and class (DECLINE, HOLD); print
    one line a fork."""
    args = config_lib.parse(dc, config_lib.parse(ec))
    gap = int(args.get("testing_iterations", 1000))
    base = run_summary(cli._model_dir(args))
    last = pair(base["eval"], at, gap)
    before = float(np.mean([e["eval_psnr"] for e in last]))
    rec = {"card": card(), "fork_at": at, "base_psnr_mean": before,
           "base_psnr_evals": [e["iteration"] for e in last],
           "rule": {"decline_db": DECLINE, "hold_db": HOLD},
           "base": base, "forks": {}}
    for name, _, mdir in fork_configs(dc, ec, specs, out):
        fork = run_summary(mdir)
        last = pair(fork["eval"], fork["eval"][-1]["iteration"], gap)
        drop = before - float(np.mean([e["eval_psnr"] for e in last]))
        fork.update(drop_db=drop, drop_evals=[e["iteration"] for e in last],
                    background_growth=last[-1]["alive"]
                    - base["eval"][-1]["alive"],
                    outcome="declines" if drop >= DECLINE else
                    "holds" if drop <= HOLD else "partial")
        rec["forks"][name] = fork
        print(f"{name}: drop {drop:.3f} dB ({fork['outcome']}); held-out "
              f"PSNR {[round(e['eval_psnr'], 3) for e in fork['eval']]}, "
              f"alive {[e['alive'] for e in fork['eval']]}; densify "
              f"{fork['densify_totals']}", flush=True)
    with open(os.path.join(out, "forks.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def card() -> str | None:
    """The card's name and power limit as nvidia-smi reports them, or
    None where nvidia-smi is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0]


def schedule(args) -> str:
    """The training schedule a config sets, in words."""
    opt, tr = args.opt, args.get("tracer")
    budget = f"K={int(tr.max_per_tile)}" if "max_per_tile" in tr else \
        "the default K"
    if "warmup_max_per_tile" in tr:
        budget = (f"K={int(tr.warmup_max_per_tile)} to iteration "
                  f"{int(tr.warmup_until)}, then {budget}")
    return (f"{int(opt.iterations)} iterations (densify/prune from "
            f"{int(opt.densify_from_iter)} to {int(opt.densify_until_iter)},"
            f" opacity reset every {int(opt.opacity_reset_interval)}, "
            f"held-out PSNR every {int(args.testing_iterations)}; {budget},"
            f" {int(tr.get('tail_passes', 0))} tail pass(es)), UNet refine "
            f"{int(args.refine.epochs)} epochs")


def _segments(history: list[dict]) -> list[list[dict]]:
    """The stamped history entries (every log_every iterations; `elapsed`
    is the trainer's own wall time, which restarts in each chunk of a
    split run) in runs of one process, each from its second stamp."""
    segs: list[list[dict]] = []
    for h in (h for h in history if "elapsed" in h):
        if not segs or h["elapsed"] < segs[-1][-1]["elapsed"]:
            segs.append([])
        segs[-1].append(h)
    return [s[1:] for s in segs]


def _rate(parts: list[list[dict]]) -> tuple[int, float]:
    """(iterations, seconds) spanned by runs of stamped entries."""
    its = sum(p[-1]["iteration"] - p[0]["iteration"] for p in parts if p)
    return its, sum(p[-1]["elapsed"] - p[0]["elapsed"] for p in parts if p)


def step_ms(history: list[dict], until: int) -> dict[str, float]:
    """Mean ms per step between the stamped history entries on either
    side of the budget switch at `until`, from each process's second
    stamp."""
    out = {}
    segs = _segments(history)
    for label, keep in (("warm-up", lambda i: i <= until),
                        ("after", lambda i: i >= until)):
        its, secs = _rate([[h for h in s if keep(h["iteration"])]
                           for s in segs])
        if its > 0:
            out[label] = 1e3 * secs / its
    return out


def entry(mdir: str) -> dict:
    """One dataset's part of the record, from its model directory (the
    reference's `collect`)."""
    out = {}
    res_path = os.path.join(mdir, "metrics", "results_all.json")
    if os.path.exists(res_path):
        with open(res_path) as f:
            out["metrics_mean"] = json.load(f)["mean"]
    unet = os.path.join(mdir, "models", "unet.npz")
    if os.path.exists(unet):
        with open(unet, "rb") as f:
            out["unet_npz_sha256"] = hashlib.sha256(f.read()).hexdigest()
        out["unet_npz_bytes"] = os.path.getsize(unet)
    else:
        out["unet_npz_sha256"] = None
    log_path = os.path.join(mdir, "logs", "log.json")
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = json.load(f)
        hist = log["history"]
        out["eval_history"] = log.get("eval_history", [])
        its, span = _rate(_segments(hist))
        if its > 0 and span > 0:
            out["steady_state_it_per_s"] = round(its / span, 2)
        out["final_loss"] = hist[-1]["loss"]
        out["iterations_recorded"] = len(hist)
    return out


def collect(a) -> dict:
    """Write `<out>/e2e_torch.json` and print each dataset's stages."""
    # "round": that of the reference's record, E2E_r05.json, whose schema
    # and configs the run keeps.
    rec = {"round": 5, "shapes": SHAPES, "schedule": None, "results": {},
           "card": card()}
    logs = {}
    for which, (_, _, key) in DATASETS.items():
        dc, ec = configs(a, which)
        args = config_lib.parse(dc, config_lib.parse(ec))
        rec["schedule"] = schedule(args)
        mdir = cli._model_dir(args)
        rec["results"][key] = entry(mdir)
        log_path = os.path.join(mdir, "logs", "log.json")
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = json.load(f)
            until = int(args.tracer.get("warmup_until", 0))
            ms = step_ms(log["history"], until)
            # A split run: each chunk's stages, launches and peak.
            chunks = None
            if os.path.exists(os.path.join(mdir, "logs", "chunks.json")):
                with open(os.path.join(mdir, "logs", "chunks.json")) as f:
                    chunks = json.load(f)
            for c in chunks or [log]:
                part = (f" iterations {c['from']}-{c['to']}" if "to" in c
                        else "")
                print(f"{key}{part}: stages (s) {c['seconds']}; peak "
                      f"{c['peak_mib']} MiB; launches {c['launches']}",
                      flush=True)
            print(f"{key}: ms per step " + ", ".join(
                f"{k} {v:.1f}" for k, v in ms.items())
                  + f" (budget switch at {until})", flush=True)
            logs[key] = {
                "train_log": {
                    **{k: log[k] for k in ("seconds", "launches",
                                           "peak_mib")},
                    "chunks": chunks,
                    "ms_per_step": ms, "budget_switch": until,
                    "refine_loss": log.get("refine_loss")},
                "densify_events": log["densify"]}
    os.makedirs(a.out, exist_ok=True)
    path = os.path.join(a.out, "e2e_torch.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    with open(os.path.join(a.out, "e2e_torch_logs.json"), "w") as f:
        json.dump(logs, f, indent=1)
    print(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m lidar_rt_tpu_torch.scripts.e2e_rehearsal")
    p.add_argument("command", choices=["gen", "train", "eval", "collect"])
    p.add_argument("dataset", nargs="?", choices=sorted(DATASETS))
    p.add_argument("--data", default=DATA,
                   help="where gen writes and the runs read the datasets")
    p.add_argument("--out", default=OUT,
                   help="model_dir/task_name of the runs, and the record's "
                        "directory")
    p.add_argument("-ec", "--exp_config", default=EXP)
    p.add_argument("--device", default="cuda")
    p.add_argument("--split", type=lambda v: [int(x) for x in v.split(",")],
                   default=None, help="train: chunk ends before the "
                   "schedule's end, comma-separated")
    p.add_argument("--fork", type=int, default=None, metavar="N",
                   help="train: train to N, then run --forks from that "
                   "checkpoint; collect: write <out>/forks.json")
    p.add_argument("--fork_to", type=int, default=None, metavar="M",
                   help="train --fork: the forks' last iteration")
    p.add_argument("--forks", type=lambda v: v.split(","), default=None,
                   help="experiment configs of the forks, comma-separated, "
                   "each config[:count]")
    a = p.parse_args(argv)
    if a.fork is not None and not a.forks:
        p.error("--fork needs --forks")
    if a.command == "train" and a.fork is not None and a.fork_to is None:
        p.error("train --fork needs --fork_to")
    if a.command in ("train", "eval") and a.dataset is None:
        p.error(f"{a.command} needs a dataset: waymo or kitti")
    if a.command == "gen":
        import torch

        dev = torch.device(a.device)
        gen_kitti(os.path.join(a.data, DATASETS["kitti"][1]), dev)
        gen_waymo(os.path.join(a.data, DATASETS["waymo"][1]), dev)
        print(f"wrote {a.data}", flush=True)
    elif a.fork is not None:
        dc, ec = configs(a, a.dataset or "waymo")
        out = os.path.abspath(a.out)
        if a.command == "train":
            return train_forks(dc, ec, a.fork, a.fork_to, a.forks, out,
                               a.device)
        return collect_forks(dc, ec, a.fork, a.forks, out)
    elif a.command in ("train", "eval"):
        return run_cli(a, a.command, a.dataset)
    else:
        return collect(a)


if __name__ == "__main__":
    main()
