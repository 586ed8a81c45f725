"""LiDARFrames: the sensor data a trainer reads (counterpart of
`lidar_rt_tpu.data.frames`, first return only).

Per-frame range and intensity images and sensor->world poses, held as
tensors on one device so a training step uploads nothing, and the
`SensorGrid` raster that defines the rays.  Frames are indexed by position
in the list.  `inverse_projection` and `normals` serve scene assembly and
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from lidar_rt_tpu_torch.core import rays as rays_lib

Tensor = torch.Tensor


@dataclass
class LiDARFrames:
    """range1 (F, H, W) meters, 0 = no return; intensity1 (F, H, W) in
    [0, 1]; sensor2world (F, 4, 4); all float32 on one device."""

    grid: rays_lib.SensorGrid
    width: int
    sensor2world: Tensor
    range1: Tensor
    intensity1: Tensor
    train_frames: list[int] = field(default_factory=list)
    eval_frames: list[int] = field(default_factory=list)

    @staticmethod
    def from_numpy(grid: rays_lib.SensorGrid, sensor2world, range1,
                   intensity1, device: str | torch.device = "cuda",
                   train_frames=(), eval_frames=()) -> "LiDARFrames":
        """Frames on `device`, the card unless the caller names another."""
        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        range1 = f32(range1)
        return LiDARFrames(grid, int(range1.shape[2]), f32(sensor2world),
                           range1, f32(intensity1), list(train_frames),
                           list(eval_frames))

    @property
    def num_frames(self) -> int:
        return self.range1.shape[0]

    @property
    def height(self) -> int:
        return self.range1.shape[1]

    def mask(self, frame: int) -> Tensor:
        return self.range1[frame] != 0

    def depth(self, frame: int) -> Tensor:
        return self.range1[frame]

    def intensity(self, frame: int) -> Tensor:
        return self.intensity1[frame]

    def pose(self, frame: int) -> Tensor:
        return self.sensor2world[frame]
