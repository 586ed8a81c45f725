"""Import the original LiDAR-RT checkpoints (`.pth`) into a port `Scene`
(counterpart of `lidar_rt_tpu.utils.import_torch`).

LiDAR-RT saves `torch.save((model_params, iteration), *.pth)` where
`model_params` is one 12-tuple per asset, background first, then each
moving actor (gs_loader.py:236-241):

    (active_sh_degree, _xyz, _features_dc, _features_rest, _scaling,
     _rotation, _opacity, max_radii2D, xyz_gradient_accum, denom,
     optimizer_state_dict, spatial_lr_scale)

(gaussian_model.py:58-72).  The raw parameterizations are the port's
`GaussianAsset`'s (log scales, opacity logits, wxyz quaternions, split
DC/rest SH), so importing pads each cloud to a capacity rounded as the
reference rounds it.  Adam moments and densify statistics are not
imported: a fine-tune starts them at zero.  `scene_to_reference` writes
the same layout from a port scene (its alive rows; the reference has no
padded capacity), the export of `python -m
lidar_rt_tpu_torch.scripts.import_roundtrip`.
"""

from __future__ import annotations

import dataclasses
import pickle
import warnings

import numpy as np
import torch

from lidar_rt_tpu_torch.scene.asset import (DEAD_LOG_SCALE,
                                            DEAD_OPACITY_LOGIT, PARAM_FIELDS,
                                            GaussianAsset)
from lidar_rt_tpu_torch.scene.scene import Scene

_TUPLE_LEN = 12


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def load_reference_tuples(path: str) -> tuple[list[tuple], int]:
    """torch.load the reference .pth -> (per-asset tuples, iteration).

    SECURITY: the checkpoints embed an optimizer state dict, which torch's
    safe `weights_only=True` loader usually accepts; when it refuses (older
    formats) this falls back to the full unpickler, which can EXECUTE
    ARBITRARY CODE from the file: import only checkpoints you trust (the
    same caveat as the reference's own `--resume`)."""
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        warnings.warn(
            f"{path}: weights_only load failed; falling back to the full "
            "unpickler — only do this for checkpoints you trust",
            stacklevel=2)
        payload = torch.load(path, map_location="cpu", weights_only=False)
    if not (isinstance(payload, tuple) and len(payload) == 2):
        raise ValueError(
            f"{path}: expected (model_params, iteration), got "
            f"{type(payload).__name__}")
    model_params, iteration = payload
    for i, tup in enumerate(model_params):
        if len(tup) != _TUPLE_LEN:
            raise ValueError(
                f"{path}: asset {i} capture tuple has {len(tup)} entries, "
                f"expected {_TUPLE_LEN} (gaussian_model.py:58-72)")
    return list(model_params), int(iteration)


def _round_capacity(n: int, pad_multiple: int, headroom: float) -> int:
    want = max(int(np.ceil(n * headroom)), n)
    return -(-want // pad_multiple) * pad_multiple


def asset_from_reference(tup: tuple, capacity: int | None = None,
                         pad_multiple: int = 1024, headroom: float = 1.0,
                         max_sh_degree: int = 3,
                         device: str | torch.device = "cuda"
                         ) -> GaussianAsset:
    """One reference capture tuple -> a padded GaussianAsset on `device`
    (the card unless the caller names another).

    capacity: explicit slot count; default rounds len(points) * headroom up
    to pad_multiple (headroom > 1 leaves densify room for fine-tuning).
    """
    (active_deg, xyz, f_dc, f_rest, scaling, rotation, opacity,
     _max_radii, _grad_accum, _denom, _opt_state, spatial_lr_scale) = tup
    xyz = _to_numpy(xyz).astype(np.float32)
    f_dc = _to_numpy(f_dc).astype(np.float32)
    f_rest = _to_numpy(f_rest).astype(np.float32)
    scaling = _to_numpy(scaling).astype(np.float32)
    rotation = _to_numpy(rotation).astype(np.float32)
    opacity = _to_numpy(opacity).astype(np.float32).reshape(-1)

    n = xyz.shape[0]
    if scaling.shape != (n, 2):
        raise ValueError(
            f"_scaling is {scaling.shape}, expected ({n}, 2): this "
            "importer takes 2D-surfel checkpoints (model.dimension: 2)")
    if f_dc.shape != (n, 1, 3) or f_rest.shape[0] != n:
        raise ValueError(f"SH shapes {f_dc.shape}/{f_rest.shape} "
                         f"don't match {n} points")
    # Any SH degree up to max_sh_degree: its coefficients are zero-padded
    # to the (15, 3) f_rest storage, and active_sh_degree keeps evaluation
    # at the trained degree.
    valid_rest = {(d + 1) ** 2 - 1 for d in range(max_sh_degree + 1)}
    if f_rest.ndim != 3 or f_rest.shape[1] not in valid_rest:
        raise ValueError(
            f"_features_rest has shape {f_rest.shape}; expected (n, r, 3) "
            f"with r in {sorted(valid_rest)} (sh_degree <= {max_sh_degree})")
    if f_rest.shape[1] < 15:
        f_rest = np.concatenate(
            [f_rest, np.zeros((n, 15 - f_rest.shape[1], 3), np.float32)],
            axis=1)
    c = capacity if capacity is not None \
        else _round_capacity(n, pad_multiple, headroom)
    if n > c:
        raise ValueError(f"{n} points > capacity {c}")

    def pad(a: np.ndarray, fill: float = 0.0) -> torch.Tensor:
        out = np.full((c, *a.shape[1:]), fill, a.dtype)
        out[:n] = a
        return torch.as_tensor(out, device=device)

    quat = np.zeros((c, 4), np.float32)
    quat[:, 0] = 1.0
    quat[:n] = rotation
    alive = np.zeros((c,), bool)
    alive[:n] = True
    return GaussianAsset(
        xyz=pad(xyz), f_dc=pad(f_dc), f_rest=pad(f_rest),
        log_scale=pad(scaling, DEAD_LOG_SCALE),
        quat=torch.as_tensor(quat, device=device),
        opacity_logit=pad(opacity, DEAD_OPACITY_LOGIT),
        alive=torch.as_tensor(alive, device=device),
        active_sh_degree=int(active_deg), max_sh_degree=max_sh_degree,
        extent=float(spatial_lr_scale))


def scene_from_reference(path: str, template: Scene,
                         pad_multiple: int = 1024, headroom: float = 1.0
                         ) -> tuple[Scene, int]:
    """Reference .pth -> (a Scene shaped like `template`, on its device,
    iteration): the same actor count and tracks, capacities grown to fit
    the imported point counts.

    `template` comes from `data.build.assemble_scene` on the data config
    the model was trained on: it supplies the actor tracks, which the
    reference keeps in the dataset, not the checkpoint."""
    tuples, iteration = load_reference_tuples(path)
    n_actors = template.num_actors
    if len(tuples) != 1 + n_actors:
        raise ValueError(
            f"{path} holds {len(tuples)} assets; the data config builds "
            f"1 background + {n_actors} actors — check that dynamic/actor "
            "selection matches the reference run")
    device = template.background.xyz.device
    bg = asset_from_reference(
        tuples[0],
        capacity=max(template.background.capacity,
                     _round_capacity(len(_to_numpy(tuples[0][1])),
                                     pad_multiple, headroom)),
        device=device)
    actors = None
    if n_actors:
        counts = [_to_numpy(t[1]).shape[0] for t in tuples[1:]]
        a_cap = max(template.actors.xyz.shape[1],
                    _round_capacity(max(counts), pad_multiple, headroom))
        per = [asset_from_reference(t, capacity=a_cap, device=device)
               for t in tuples[1:]]
        # The stacked actors hold ONE extent; the reference's per-actor
        # spatial_lr_scale may differ, so take the max (extent only scales
        # the densify and prune thresholds).  The stacked actors keep the
        # first actor's SH degree (the render reads the background's).
        fields = {f.name: torch.stack([getattr(a, f.name) for a in per])
                  for f in dataclasses.fields(GaussianAsset)
                  if isinstance(getattr(per[0], f.name), torch.Tensor)}
        actors = dataclasses.replace(
            per[0], **fields, extent=max(a.extent for a in per))
    return dataclasses.replace(template, background=bg, actors=actors), \
        iteration


def scene_to_reference(scene: Scene) -> list[tuple]:
    """A port scene -> the reference's per-asset capture 12-tuples on the
    CPU, background first, then each actor (gs_loader.py:236-241): each
    asset's alive rows in slot order, zero densify statistics, an empty
    optimizer state, and its extent as spatial_lr_scale (the stacked
    actors share one)."""
    assets = [scene.background]
    for i in range(scene.num_actors):
        ac = scene.actors
        assets.append(dataclasses.replace(
            ac, alive=ac.alive[i],
            **{f: getattr(ac, f)[i] for f in PARAM_FIELDS.values()}))
    tuples = []
    for asset in assets:
        alive = asset.alive.detach().cpu()
        n = int(alive.sum())

        def rows(x: torch.Tensor) -> torch.Tensor:
            return x.detach().cpu()[alive].clone()

        tuples.append((
            int(asset.active_sh_degree), rows(asset.xyz), rows(asset.f_dc),
            rows(asset.f_rest), rows(asset.log_scale), rows(asset.quat),
            rows(asset.opacity_logit).reshape(-1, 1), torch.zeros(n),
            torch.zeros(n, 1), torch.zeros(n, 1),
            {"state": {}, "param_groups": []}, float(asset.extent)))
    return tuples


def save_reference(path: str, scene: Scene, iteration: int) -> list[tuple]:
    """Write `scene` as a reference checkpoint, torch.save((tuples,
    iteration)); return the tuples."""
    tuples = scene_to_reference(scene)
    torch.save((tuples, int(iteration)), path)
    return tuples
