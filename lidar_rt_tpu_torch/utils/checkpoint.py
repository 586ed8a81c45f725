"""Checkpoints: a training state, a scene or a state dict in one `.npz`
(counterpart of `lidar_rt_tpu.utils.checkpoint`, with the port's own
format).

The reference pickles a jax treedef beside its leaves, which cannot be read
without jax.  Here each leaf is an array keyed by its dotted path
("scene.background.xyz", "opt_bg.xyz.exp_avg", ...), the file is read with
`allow_pickle=False`, and the metadata is a JSON string:

  * a `TrainState`: the scene, both `AssetOptimizer`s (each group's Adam
    moments and step, the optimizer's step count), both `DensifyStats`
    and the densify generator's state.  The bin cache (`bins`) is not
    saved: a resumed trainer starts with a fresh, all-stale `BinCache`, so
    each frame re-bins at its first step after the resume;
  * a bare `Scene` (e.g. one imported from a LiDAR-RT `.pth`);
  * a mapping of names to tensors or arrays, nested mappings joined with
    dots (the U-Net's `state_dict`, any snapshot).

Capacity is fixed (alive masks), so a restore needs no shape surgery.
`find_best` / `retain_best` keep the reference's `ckpt_it_N[_good].npz`
names and best-checkpoint rules (train.py:328-380).
"""

from __future__ import annotations

import json
import os
import re
from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from lidar_rt_tpu_torch.scene.asset import GaussianAsset
from lidar_rt_tpu_torch.scene.convert import ASSET_FIELDS, TRACK_FIELDS
from lidar_rt_tpu_torch.scene.scene import Scene
from lidar_rt_tpu_torch.scene.tracks import ActorTrack
from lidar_rt_tpu_torch.train import density, optim

_KIND, _META = "__kind__", "__meta__"


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _asset_arrays(prefix: str, asset: GaussianAsset) -> dict:
    out = {f"{prefix}.{f}": _host(getattr(asset, f)) for f in ASSET_FIELDS}
    out[f"{prefix}.active_sh_degree"] = np.asarray(asset.active_sh_degree)
    out[f"{prefix}.max_sh_degree"] = np.asarray(asset.max_sh_degree)
    out[f"{prefix}.extent"] = np.asarray(asset.extent, np.float64)
    return out


def _scene_arrays(prefix: str, scene: Scene) -> dict:
    out = _asset_arrays(f"{prefix}background", scene.background)
    if scene.actors is not None:
        out.update(_asset_arrays(f"{prefix}actors", scene.actors))
        out.update({f"{prefix}tracks.{f}": _host(getattr(scene.tracks, f))
                    for f in TRACK_FIELDS})
    return out


def _optimizer_arrays(prefix: str, opt: optim.AssetOptimizer) -> dict:
    out = {f"{prefix}.steps": np.asarray(opt.steps)}
    for group in optim.GROUPS:
        for k, v in opt.adam.state.get(opt.params[group], {}).items():
            out[f"{prefix}.{group}.{k}"] = _host(v)
    return out


def _flatten(prefix: str, tree: Mapping) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(f"{prefix}{k}.", v))
        else:
            out[f"{prefix}{k}"] = _host(v)
    return out


def save(path: str, state: Any, metadata: dict | None = None) -> None:
    """Write a TrainState, a Scene or a (nested) mapping of tensors or
    arrays to `path`, with JSON-serialisable `metadata`."""
    from lidar_rt_tpu_torch.train.loop import TrainState

    if isinstance(state, TrainState):
        kind = "TrainState"
        arrays = _scene_arrays("scene.", state.scene)
        arrays.update(_optimizer_arrays("opt_bg", state.opt_bg))
        arrays.update({f"stats_bg.{k}": _host(v)
                       for k, v in state.stats_bg._asdict().items()})
        if state.opt_actors is not None:
            arrays.update(_optimizer_arrays("opt_actors", state.opt_actors))
            arrays.update({f"stats_actors.{k}": _host(v)
                           for k, v in state.stats_actors._asdict().items()})
        if state.generator is not None:
            arrays["generator"] = _host(state.generator.get_state())
    elif isinstance(state, Scene):
        kind, arrays = "Scene", _scene_arrays("", state)
    elif isinstance(state, Mapping):
        kind, arrays = "dict", _flatten("", state)
    else:
        raise TypeError(f"cannot checkpoint a {type(state).__name__}")
    for reserved in (_KIND, _META):
        if reserved in arrays:
            raise KeyError(f"{reserved!r} is a reserved checkpoint key")
    arrays[_KIND] = np.asarray(kind)
    arrays[_META] = np.asarray(json.dumps(metadata or {}))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def _asset(z: Mapping, prefix: str, device) -> GaussianAsset:
    return GaussianAsset(
        *(torch.as_tensor(z[f"{prefix}.{f}"], device=device)
          for f in ASSET_FIELDS),
        active_sh_degree=int(z[f"{prefix}.active_sh_degree"]),
        max_sh_degree=int(z[f"{prefix}.max_sh_degree"]),
        extent=float(z[f"{prefix}.extent"]))


def _scene(z: Mapping, prefix: str, device) -> Scene:
    background = _asset(z, f"{prefix}background", device)
    if f"{prefix}actors.xyz" not in z:
        return Scene(background=background)
    tracks = ActorTrack(*(torch.as_tensor(z[f"{prefix}tracks.{f}"],
                                          device=device)
                          for f in TRACK_FIELDS))
    return Scene(background=background,
                 actors=_asset(z, f"{prefix}actors", device), tracks=tracks)


def _restore_optimizer(opt: optim.AssetOptimizer, z: Mapping,
                       prefix: str) -> None:
    """Put the saved Adam state into a fresh optimizer over the restored
    parameters.  torch keeps a non-fused Adam's `step` on the host."""
    opt.steps = int(z[f"{prefix}.steps"])
    for group in optim.GROUPS:
        param = opt.params[group]
        keys = [k for k in ("step", "exp_avg", "exp_avg_sq")
                if f"{prefix}.{group}.{k}" in z]
        if keys:
            opt.adam.state[param] = {
                k: torch.as_tensor(z[f"{prefix}.{group}.{k}"],
                                   device="cpu" if k == "step"
                                   else param.device)
                for k in keys}


def load(path: str, device: str | torch.device = "cuda",
         opt_args=None) -> tuple[Any, dict]:
    """Read (state, metadata) back, tensors on `device` (the card unless
    the caller names another).  A TrainState needs `opt_args` (the `opt`
    options its optimizers were built with) to rebuild its learning-rate
    schedules; its `bins` is None (the trainer sets a fresh cache).  A
    mapping comes back flat, dotted keys to numpy arrays."""
    from lidar_rt_tpu_torch.train.loop import TrainState, init_train_state

    with np.load(path, allow_pickle=False) as npz:
        z = {k: npz[k] for k in npz.files}
    kind = str(z.pop(_KIND))
    metadata = json.loads(str(z.pop(_META)))
    if kind == "dict":
        return z, metadata
    if kind == "Scene":
        return _scene(z, "", device), metadata
    if kind != "TrainState":
        raise ValueError(f"{path}: unknown checkpoint kind {kind!r}")
    if opt_args is None:
        raise ValueError(f"{path} holds a TrainState: pass opt_args to "
                         "rebuild its optimizers")
    state: TrainState = init_train_state(_scene(z, "scene.", device),
                                         opt_args)
    _restore_optimizer(state.opt_bg, z, "opt_bg")
    state.stats_bg = density.DensifyStats(
        *(torch.as_tensor(z[f"stats_bg.{k}"], device=device)
          for k in density.DensifyStats._fields))
    if state.opt_actors is not None:
        _restore_optimizer(state.opt_actors, z, "opt_actors")
        state.stats_actors = density.DensifyStats(
            *(torch.as_tensor(z[f"stats_actors.{k}"], device=device)
              for k in density.DensifyStats._fields))
    if "generator" in z:
        state.generator.set_state(torch.as_tensor(z["generator"]))
    return state, metadata


def load_scene(path: str, device: str | torch.device = "cuda"
               ) -> tuple[Scene, dict]:
    """The scene of a TrainState or Scene checkpoint, and its metadata."""
    with np.load(path, allow_pickle=False) as npz:
        kind = str(npz[_KIND])
        metadata = json.loads(str(npz[_META]))
        if kind not in ("TrainState", "Scene"):
            raise ValueError(f"{path} holds a {kind}, not a scene")
        prefix = "scene." if kind == "TrainState" else ""
        z = {k: npz[k] for k in npz.files if k.startswith(prefix)}
    return _scene(z, prefix, device), metadata


_CKPT_RE = re.compile(r"ckpt_it_(\d+)(_good)?\.npz$")


def find_best(model_dir: str) -> str | None:
    """The best retained checkpoint: the `*_good` one (the reference's
    best-PSNR marker, train.py:351-368), else the highest iteration."""
    if not os.path.isdir(model_dir):
        return None
    best, best_it, best_good = None, -1, False
    for name in os.listdir(model_dir):
        m = _CKPT_RE.search(name)
        if not m:
            continue
        it, good = int(m.group(1)), bool(m.group(2))
        if (good, it) > (best_good, best_it):
            best, best_it, best_good = os.path.join(model_dir, name), it, good
    return best


def retain_best(model_dir: str, iteration: int, state: Any, is_best: bool,
                metadata: dict | None = None) -> str:
    """Save `ckpt_it_N[_good].npz`; when `is_best`, drop stale _good files
    (train.py:351-380's checkpoint GC)."""
    suffix = "_good" if is_best else ""
    path = os.path.join(model_dir, f"ckpt_it_{iteration}{suffix}.npz")
    save(path, state, metadata)
    if is_best:
        for name in os.listdir(model_dir):
            m = _CKPT_RE.search(name)
            if m and m.group(2) and int(m.group(1)) != iteration:
                os.remove(os.path.join(model_dir, name))
    return path
