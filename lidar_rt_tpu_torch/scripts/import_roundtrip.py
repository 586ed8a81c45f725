"""The reference-checkpoint workflow end to end from a trained port scene
(counterpart of the reference's `scripts/import_roundtrip.py`).

    python -m lidar_rt_tpu_torch.scripts.import_roundtrip \
        [--src output/rehearsal/exp/scene_we1/models] \
        [-dc configs/rehearsal/waymo.yaml] \
        [-ec configs/rehearsal/import_rt.yaml] \
        [--out output/import_rt] [--finetune 200] [--device cuda]

  1. exports the best checkpoint in --src (`checkpoint.find_best`) to a
     genuine reference-format `.pth`, `<out>/roundtrip_reference.pth`:
     torch.save((per-asset capture 12-tuples, iteration)), alive rows only
     (`utils.import_torch.save_reference`);
  2. `python -m lidar_rt_tpu_torch.scripts.import_reference_ckpt` converts
     it back on a fresh skeleton from the data config;
  3. `python -m lidar_rt_tpu_torch.cli train --resume` fine-tunes from the
     import to its iteration + --finetune;
  4. `python -m lidar_rt_tpu_torch.cli eval -t all -e` evaluates the
     fine-tuned model.

Each command runs as a child process, as a user would run it.  Writes
`<out>/import_rt.json`: the export, each command's seconds, the mean
metrics, and the fine-tune's and the eval's kernel launches and peak
device memory (from `logs/log.json` and `results_all.json`); and keeps a
copy of the imported checkpoint, `<out>/imported.npz` (the fine-tune's
best checkpoint replaces it in the model directory).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

from lidar_rt_tpu_torch import cli
from lidar_rt_tpu_torch import config as config_lib
from lidar_rt_tpu_torch.scripts import import_reference_ckpt
from lidar_rt_tpu_torch.utils import checkpoint as ckpt_lib
from lidar_rt_tpu_torch.utils import import_torch

# The checkout's root: the configs' home, and the children's import path.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def export_reference_pth(src: str, pth: str) -> dict:
    """The best checkpoint in `src` -> a reference `.pth` at `pth`."""
    path = ckpt_lib.find_best(src)
    if path is None:
        raise FileNotFoundError(f"no checkpoint in {src}")
    scene, meta = ckpt_lib.load_scene(path, "cpu")
    iteration = int(meta.get("iteration", 0))
    os.makedirs(os.path.dirname(os.path.abspath(pth)), exist_ok=True)
    sizes = [int(t[1].shape[0])
             for t in import_torch.save_reference(pth, scene, iteration)]
    print(f"exported {path} -> {pth}  (assets {sizes}, it {iteration})",
          flush=True)
    return {"src_ckpt": path, "pth": pth, "iteration": iteration,
            "asset_sizes": sizes}


def run(cmd: list[str]) -> float:
    """Run a command with this checkout importable; its seconds."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=REPO if not path
               else os.pathsep.join([REPO, path]))
    print("+", " ".join(cmd), flush=True)
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, env=env)
    return time.perf_counter() - t0


def main(argv=None) -> dict:
    """Run the round trip; return the record written to import_rt.json."""
    p = argparse.ArgumentParser(
        prog="python -m lidar_rt_tpu_torch.scripts.import_roundtrip")
    p.add_argument("--src", default=os.path.join(
        "output", "rehearsal", "exp", "scene_we1", "models"),
        help="models directory of the trained scene to export")
    p.add_argument("-dc", "--data_config", default=os.path.join(
        REPO, "configs", "rehearsal", "waymo.yaml"))
    p.add_argument("-ec", "--exp_config", default=os.path.join(
        REPO, "configs", "rehearsal", "import_rt.yaml"))
    p.add_argument("--out", default=os.path.join("output", "import_rt"),
                   help="directory for the .pth and import_rt.json")
    p.add_argument("--finetune", type=int, default=200,
                   help="fine-tune iterations after the import")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    pth = os.path.join(a.out, "roundtrip_reference.pth")
    rec = {"export": export_reference_pth(a.src, pth)}
    it = rec["export"]["iteration"]
    args = config_lib.parse(a.data_config, config_lib.parse(a.exp_config))
    model_dir = cli._model_dir(args)
    imported = import_reference_ckpt.default_output(args, it)
    common = ["-dc", a.data_config, "-ec", a.exp_config, "--device",
              a.device]
    py = sys.executable

    rec["import_s"] = run([py, "-m",
                           "lidar_rt_tpu_torch.scripts.import_reference_ckpt",
                           "--pth", pth, *common])
    found = ckpt_lib.find_best(os.path.join(model_dir, "models"))
    if os.path.abspath(found or "") != os.path.abspath(imported):
        raise RuntimeError(f"--resume would start from {found}, not the "
                           f"import {imported}: use an empty model_dir")
    # The fine-tune's best checkpoint replaces the import's (the
    # reference's checkpoint rule): keep a copy beside the .pth.
    rec["imported_ckpt"] = os.path.join(a.out, "imported.npz")
    shutil.copyfile(imported, rec["imported_ckpt"])
    rec["finetune_s"] = run([py, "-m", "lidar_rt_tpu_torch.cli", "train",
                             "--resume", "--iterations",
                             str(it + a.finetune), *common])
    rec["eval_s"] = run([py, "-m", "lidar_rt_tpu_torch.cli", "eval", "-t",
                         "all", "-e", *common])

    with open(os.path.join(model_dir, "logs", "log.json")) as f:
        log = json.load(f)
    with open(os.path.join(model_dir, "metrics", "results_all.json")) as f:
        results = json.load(f)
    its = [h["iteration"] for h in log["history"]]
    rec["finetune"] = {"iterations": [its[0], its[-1]],
                       "seconds": log["seconds"],
                       "launches": log["launches"],
                       "peak_mib": log["peak_mib"]}
    rec["eval"] = {"num_frames": results["num_frames"],
                   "eval_seconds": results["eval_seconds"],
                   "launches": results["launches"],
                   "peak_mib": results["peak_mib"]}
    rec["metrics_mean"] = results["mean"]
    out = os.path.join(a.out, "import_rt.json")
    with open(out, "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps(rec, indent=1))
    return rec


if __name__ == "__main__":
    main()
