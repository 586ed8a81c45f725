"""Carry checkpoints of the JAX package (`lidar_rt_tpu`) into the port.

    python export_jax_ckpt.py ckpt_it_N_good.npz models/unet.npz --out x/
    python -m lidar_rt_tpu_torch.scripts.import_jax_ckpt x/ckpt_it_N_good.npz
        x/unet.npz (--models_dir DIR | -dc DATA.yaml -ec EXP.yaml)

The JAX package's checkpoints pickle a jax treedef, which cannot be read
without jax, so `export_jax_ckpt.py` (at the repository's root, run where
the JAX package is installed) first writes each as a plain `.npz` of
dotted pytree paths.  This command maps such a file to the port's own
format and writes it where `python -m lidar_rt_tpu_torch.cli train
--resume` and `cli eval` look (`<model dir>/models/`, the CLI's layout
for the data and experiment configs, or `--models_dir`), under the
checkpoint's own name:

  * a TrainState: the scene; each asset's Adam state, optax's `mu`, `nu`
    and `count` as torch's `exp_avg`, `exp_avg_sq` and `step` for every
    parameter group, and the step count of the xyz schedule; both
    `DensifyStats`.  The JAX package's random key has no torch
    counterpart, so the file carries no generator and `utils.checkpoint.
    load` gives the resumed trainer a fresh one: densification's random
    draws after the resume differ from the ones the JAX package would
    make.  Its tile-assignment cache is not carried either (a resumed
    trainer re-bins each frame at its first step, as after any resume);
  * a bare Scene: the scene;
  * the refine U-Net's flax variables: the port's `RayDropUNet` weights
    (`models.unet.unet_state_from_flax`) as `unet.npz`, with its input
    channels.

It needs neither jax nor the JAX package.
"""

from __future__ import annotations

import argparse
import os
import re

import numpy as np
import torch

from lidar_rt_tpu_torch.models.unet import unet_state_from_flax
from lidar_rt_tpu_torch.scene import convert
from lidar_rt_tpu_torch.scene.scene import Scene
from lidar_rt_tpu_torch.train import density, loop, optim, options
from lidar_rt_tpu_torch.utils import checkpoint as ckpt_lib

SOURCE = "lidar_rt_tpu"


def read(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """An exported file's arrays (dotted paths) and its metadata."""
    z, meta = ckpt_lib.load(path, "cpu")
    if not isinstance(z, dict) or meta.get("source") != SOURCE:
        raise ValueError(f"{path} is not a checkpoint export_jax_ckpt.py "
                         "wrote")
    return z, meta


def scene_of(z: dict, meta: dict, prefix: str = "",
             device: str | torch.device = "cpu") -> Scene:
    """The port's Scene from the exported `<prefix>background.*`,
    `actors.*` and `tracks.*` leaves and the assets' static fields."""
    arrays = {k[len(prefix):]: v for k, v in z.items()
              if k.startswith(prefix)}
    for part, static in meta["static"].items():
        arrays.update({f"{part}.{k}": np.asarray(v)
                       for k, v in static.items()})
    return convert.scene_from_numpy(arrays, device)


def adam_state(z: dict, prefix: str, group: str
               ) -> tuple[int, np.ndarray, np.ndarray]:
    """(count, mu, nu) of one group of an exported optax multi_transform
    Adam state (`<prefix>.inner_states.<group>.<...>.mu.<group>`)."""
    pat = re.compile(rf"^{re.escape(prefix)}\.inner_states\."
                     rf"{re.escape(group)}\.(.+)\.mu\.{re.escape(group)}$")
    found = [m.group(1) for m in map(pat.match, z) if m]
    if len(found) != 1:
        raise KeyError(f"{prefix}: {len(found)} Adam states for {group!r}")
    mid = f"{prefix}.inner_states.{group}.{found[0]}"
    return (int(z[f"{mid}.count"]), z[f"{mid}.mu.{group}"],
            z[f"{mid}.nu.{group}"])


def _restore_adam(opt: optim.AssetOptimizer, z: dict, prefix: str) -> None:
    counts = {}
    for group in optim.GROUPS:
        count, mu, nu = adam_state(z, prefix, group)
        param = opt.params[group]
        counts[group] = count
        # torch keeps a non-fused Adam's step as a float32 on the host.
        opt.adam.state[param] = {
            "step": torch.tensor(float(count)),
            "exp_avg": torch.as_tensor(mu, device=param.device).clone(),
            "exp_avg_sq": torch.as_tensor(nu, device=param.device).clone()}
    opt.steps = counts["xyz"]


def _stats(z: dict, prefix: str) -> density.DensifyStats:
    return density.DensifyStats(*(torch.as_tensor(z[f"{prefix}.{f}"])
                                  for f in density.DensifyStats._fields))


def train_state_of(z: dict, meta: dict) -> loop.TrainState:
    """The port's TrainState, on the CPU, with no generator.  Its
    optimizers' learning rates are the defaults' (the checkpoint holds
    none: `utils.checkpoint.load` rebuilds them from the run's options)."""
    state = loop.init_train_state(scene_of(z, meta, "scene."),
                                  options.experiment_options().opt)
    _restore_adam(state.opt_bg, z, "opt_state_bg")
    state.stats_bg = _stats(z, "stats_bg")
    if state.opt_actors is not None:
        _restore_adam(state.opt_actors, z, "opt_state_actors")
        state.stats_actors = _stats(z, "stats_actors")
    state.generator = None
    return state


def unet_state_of(z: dict) -> dict[str, np.ndarray]:
    """The port's U-Net weights from exported flax variables."""
    variables: dict = {}
    for key, value in z.items():
        *path, leaf = key.split(".")
        node = variables
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return unet_state_from_flax(variables)


def import_file(path: str, models_dir: str) -> str:
    """Import one exported file into models_dir; returns the written
    path."""
    z, meta = read(path)
    kind, name = meta["kind"], meta["name"]
    extra = {**meta["metadata"], "imported_from": os.path.abspath(path)}
    if kind == "variables":
        in_ch = int(meta["metadata"].get("in_ch", 3))
        out = os.path.join(models_dir, "unet.npz")
        ckpt_lib.save(out, unet_state_of(z), {**extra, "in_ch": in_ch})
    elif kind in ("TrainState", "Scene"):
        out = os.path.join(models_dir, name)
        state = (train_state_of(z, meta) if kind == "TrainState"
                 else scene_of(z, meta))
        ckpt_lib.save(out, state, extra)
    else:
        raise ValueError(f"{path}: unknown checkpoint kind {kind!r}")
    return out


def main(argv=None) -> list[str]:
    p = argparse.ArgumentParser(
        prog="python -m lidar_rt_tpu_torch.scripts.import_jax_ckpt",
        description=__doc__.split("\n")[0])
    p.add_argument("paths", nargs="+", metavar="EXPORTED.npz")
    p.add_argument("--models_dir", default=None,
                   help="where to write (default: the CLI's models "
                        "directory of -dc/-ec)")
    p.add_argument("-dc", "--data_config", default=None)
    p.add_argument("-ec", "--exp_config", default=None)
    a = p.parse_args(argv)
    models_dir = a.models_dir
    if models_dir is None:
        if not (a.data_config and a.exp_config):
            p.error("give --models_dir, or -dc and -ec")
        from lidar_rt_tpu_torch import cli
        from lidar_rt_tpu_torch import config as config_lib

        args = config_lib.parse(a.data_config,
                                config_lib.parse(a.exp_config))
        models_dir = os.path.join(cli._model_dir(args), "models")
    written = []
    for path in a.paths:
        out = import_file(path, models_dir)
        print(f"imported {path} -> {out}")
        written.append(out)
    return written


if __name__ == "__main__":
    main()
