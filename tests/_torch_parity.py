"""The reference's scenes and frames carried to the port, for the tests that
hold the two packages to each other from one state."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from lidar_rt_tpu_torch.core import rays as t_rays
from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.scene import convert


def scene_arrays(sc) -> dict[str, np.ndarray]:
    """A `lidar_rt_tpu` Scene as the port's `<part>.<field>` arrays."""
    out = {}
    parts = [("background", sc.background)]
    if sc.actors is not None:
        parts.append(("actors", sc.actors))
        out.update({f"tracks.{f}": np.asarray(getattr(sc.tracks, f))
                    for f in convert.TRACK_FIELDS})
    for part, asset in parts:
        for f in convert.ASSET_FIELDS + ("active_sh_degree",):
            out[f"{part}.{f}"] = np.asarray(getattr(asset, f))
        out[f"{part}.extent"] = np.float32(asset.extent)
        out[f"{part}.max_sh_degree"] = np.int32(asset.max_sh_degree)
    return out


def jittered(j_scene, scale: float = 0.05, seed: int = 0):
    """The reference's scene with its surfel positions (the background's,
    then the actors') moved by Gaussian noise of `scale` metres drawn from
    `default_rng(seed)`.  Surfels assembled from range images tie in range
    to rounding (a ground ring at one elevation), and the two packages
    round the range differently, so they would list tied candidates in
    different orders."""
    rng = np.random.default_rng(seed)

    def jitter(asset):
        noise = rng.normal(scale=scale, size=asset.xyz.shape)
        return dataclasses.replace(asset, xyz=asset.xyz + noise.astype(
            np.float32))

    return dataclasses.replace(j_scene,
                               background=jitter(j_scene.background),
                               actors=jitter(j_scene.actors))


def port_scene(j_scene):
    """The port's copy of a reference scene, on the CPU."""
    return convert.scene_from_numpy(scene_arrays(j_scene), device="cpu")


def port_grid(grid) -> t_rays.SensorGrid:
    return t_rays.SensorGrid(torch.tensor(np.asarray(grid.row_inclinations)),
                             grid.pixel_offset, grid.angle_offset)


def port_frames(frames) -> LiDARFrames:
    """The port's copy of the reference's frames (first returns), on the
    CPU, with its train / eval split."""
    return LiDARFrames.from_numpy(
        port_grid(frames.grid), frames.sensor2world, frames.range1,
        frames.intensity1, device="cpu", train_frames=frames.train_frames,
        eval_frames=frames.eval_frames)


def carried(j_scene):
    """The reference's scene jittered by 5 cm (`jittered`), and its port
    copy."""
    j_scene = jittered(j_scene)
    return j_scene, port_scene(j_scene)
