"""Import a checkpoint trained with the original LiDAR-RT for use here
(counterpart of the reference's `scripts/import_reference_ckpt.py`).

    python -m lidar_rt_tpu_torch.scripts.import_reference_ckpt \
        -dc configs/waymo/dynamic/1.yaml -ec configs/exp.yaml \
        --pth /path/to/ckpt_it_30000_good.pth \
        [-o output/<task>/<exp>/scene_<id>/models/ckpt_it_30000_good.npz] \
        [--headroom 1.5] [--device cuda]

Rebuilds the scene's skeleton (actor tracks, capacities) from the data
config the reference run used, swaps in the checkpoint's parameters
(`utils.import_torch.scene_from_reference`) and writes a port `.npz`
scene, by default where `python -m lidar_rt_tpu_torch.cli train --resume`
and `cli eval` look for the best checkpoint (`checkpoint.find_best`).
"""

from __future__ import annotations

import argparse
import os

import torch

from lidar_rt_tpu_torch import cli
from lidar_rt_tpu_torch import config as config_lib
from lidar_rt_tpu_torch.data import build as build_lib
from lidar_rt_tpu_torch.utils import checkpoint as ckpt_lib
from lidar_rt_tpu_torch.utils import import_torch


def default_output(args, iteration: int) -> str:
    """`<model dir>/models/ckpt_it_<iteration>_good.npz`, the CLI's layout
    (`cli._model_dir`, with its scene_<id> segment)."""
    return os.path.join(cli._model_dir(args), "models",
                        f"ckpt_it_{iteration}_good.npz")


def main(argv=None) -> str:
    """Import, save, and return the written checkpoint's path."""
    p = argparse.ArgumentParser(
        prog="python -m lidar_rt_tpu_torch.scripts.import_reference_ckpt")
    p.add_argument("-dc", "--data_config", required=True)
    p.add_argument("-ec", "--exp_config", required=True)
    p.add_argument("--pth", required=True, help="reference .pth checkpoint")
    p.add_argument("-o", "--out", default=None)
    p.add_argument("--headroom", type=float, default=1.5,
                   help="capacity headroom over the imported point counts "
                        "(densify room for fine-tuning)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    device = torch.device(a.device)
    args = config_lib.parse(a.data_config, config_lib.parse(a.exp_config))
    cli.set_seed(int(args.get("seed", 1)))
    frames, tracks = cli.load_dataset(args, device)
    template = build_lib.assemble_scene(frames, tracks, args)
    scene, iteration = import_torch.scene_from_reference(
        a.pth, template, headroom=a.headroom)

    out = a.out or default_output(args, iteration)
    ckpt_lib.save(out, scene, {"iteration": iteration,
                               "imported_from": os.path.abspath(a.pth)})
    alive = int(scene.background.num_alive)
    print(f"imported {a.pth} @ iteration {iteration} -> {out}\n"
          f"  background {alive} pts / cap {scene.background.capacity}; "
          f"{scene.num_actors} actors")
    return out


if __name__ == "__main__":
    main()
