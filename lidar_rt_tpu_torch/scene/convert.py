"""Build a port `Scene` from named numpy arrays.

This is how a scene crosses from `lidar_rt_tpu` (or from any numpy source)
to the port: one array per leaf, keyed `<part>.<field>`:

    background.{xyz, f_dc, f_rest, log_scale, quat, opacity_logit, alive,
                active_sh_degree[, max_sh_degree, extent]}
    actors.{same fields, stacked with a leading actor axis}      (optional)
    tracks.{size, translations, quats, present}   (required with actors)

`max_sh_degree` and `extent` are scalars; absent, they take the
reference's defaults, 3 and 200.0.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from lidar_rt_tpu_torch.scene.asset import GaussianAsset
from lidar_rt_tpu_torch.scene.scene import Scene
from lidar_rt_tpu_torch.scene.tracks import ActorTrack

ASSET_FIELDS = ("xyz", "f_dc", "f_rest", "log_scale", "quat",
                "opacity_logit", "alive")
TRACK_FIELDS = ("size", "translations", "quats", "present")


def _tensor(arrays: Mapping[str, np.ndarray], key: str,
            device) -> torch.Tensor:
    if key not in arrays:
        raise KeyError(f"scene array {key!r} is missing")
    a = np.asarray(arrays[key])
    dtype = torch.bool if a.dtype == np.bool_ else torch.float32
    return torch.tensor(a, dtype=dtype, device=device)


def _asset(arrays, part: str, device) -> GaussianAsset:
    degree = int(np.max(arrays[f"{part}.active_sh_degree"]))
    return GaussianAsset(
        *(_tensor(arrays, f"{part}.{f}", device) for f in ASSET_FIELDS),
        active_sh_degree=degree,
        max_sh_degree=int(arrays.get(f"{part}.max_sh_degree", 3)),
        extent=float(arrays.get(f"{part}.extent", 200.0)))


def scene_from_numpy(arrays: Mapping[str, np.ndarray],
                     device: str | torch.device = "cuda") -> Scene:
    """Port Scene on `device` (the card unless the caller names another)
    from `<part>.<field>` numpy arrays."""
    background = _asset(arrays, "background", device)
    if "actors.xyz" not in arrays:
        return Scene(background=background)
    tracks = ActorTrack(*(_tensor(arrays, f"tracks.{f}", device)
                          for f in TRACK_FIELDS))
    return Scene(background=background,
                 actors=_asset(arrays, "actors", device), tracks=tracks)
