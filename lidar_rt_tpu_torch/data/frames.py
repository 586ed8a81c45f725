"""LiDARFrames: the sensor data a loader produces and a trainer reads
(counterpart of `lidar_rt_tpu.data.frames`).

Per-frame range and intensity images of up to two returns and sensor->world
poses, held as float32 tensors on one device so a training step uploads
nothing, and the `SensorGrid` raster that defines the rays.  Frames are
indexed by position in the loaded list; `frame_numbers` keeps the
dataset's own ids.

  mask/depth/intensity(frame, return_num)  one return's images
  inverse_projection(frame)  world points + intensities of every return
                             (scene assembly's input)
  points_from_range(frame, range_image), normals(frame), rays(frame)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from lidar_rt_tpu_torch.core import rays as rays_lib

Tensor = torch.Tensor


@dataclass
class LiDARFrames:
    """range1/range2 (F, H, W) meters, 0 = no return; intensity1/intensity2
    (F, H, W) in [0, 1]; sensor2world (F, 4, 4); all float32 on one
    device.  The second return is optional."""

    grid: rays_lib.SensorGrid
    width: int
    sensor2world: Tensor
    range1: Tensor
    intensity1: Tensor
    range2: Tensor | None = None
    intensity2: Tensor | None = None
    frame_numbers: list[int] = field(default_factory=list)
    train_frames: list[int] = field(default_factory=list)
    eval_frames: list[int] = field(default_factory=list)

    @staticmethod
    def from_numpy(grid: rays_lib.SensorGrid, sensor2world, range1,
                   intensity1, device: str | torch.device = "cuda",
                   train_frames=(), eval_frames=(), range2=None,
                   intensity2=None, frame_numbers=()) -> "LiDARFrames":
        """Frames on `device`, the card unless the caller names another."""
        def f32(a):
            return None if a is None else torch.as_tensor(
                np.asarray(a, np.float32), device=device)

        range1 = f32(range1)
        return LiDARFrames(
            grid, int(range1.shape[2]), f32(sensor2world), range1,
            f32(intensity1), f32(range2), f32(intensity2),
            list(frame_numbers), list(train_frames), list(eval_frames))

    @property
    def num_frames(self) -> int:
        return self.range1.shape[0]

    @property
    def height(self) -> int:
        return self.range1.shape[1]

    def _ret(self, return_num: int) -> tuple[Tensor, Tensor]:
        if return_num == 1 or self.range2 is None:
            return self.range1, self.intensity1
        return self.range2, self.intensity2

    def mask(self, frame: int, return_num: int = 1) -> Tensor:
        return self._ret(return_num)[0][frame] != 0

    def depth(self, frame: int, return_num: int = 1) -> Tensor:
        return self._ret(return_num)[0][frame]

    def intensity(self, frame: int, return_num: int = 1) -> Tensor:
        return self._ret(return_num)[1][frame]

    def pose(self, frame: int) -> Tensor:
        return self.sensor2world[frame]

    def sensor_center(self, frame: int) -> Tensor:
        return self.sensor2world[frame, :3, 3]

    def rays(self, frame: int) -> tuple[Tensor, Tensor]:
        """(origin (3,), dirs (H, W, 3)) world-frame rays."""
        return rays_lib.range_rays(self.grid, self.width, self.pose(frame))

    def points_from_range(self, frame: int, range_image: Tensor) -> Tensor:
        """Back-project any (H, W) range image with this frame's pose."""
        return rays_lib.range_to_points(self.grid, range_image,
                                        self.pose(frame))

    def inverse_projection(self, frame: int) -> tuple[Tensor, Tensor]:
        """Every return's valid pixels -> (world points (N, 3),
        intensities (N,)): return 1 first, each in raster order."""
        pts_all, int_all = [], []
        for ret in (1, 2) if self.range2 is not None else (1,):
            r, i = self._ret(ret)
            valid = r[frame] > 0
            pts_all.append(self.points_from_range(frame, r[frame])[valid])
            int_all.append(i[frame][valid])
        return torch.cat(pts_all), torch.cat(int_all)

    def normals(self, frame: int, return_num: int = 1) -> Tensor:
        """Per-pixel normals from range-image cross products (neighbours
        wrap around both axes), facing the sensor."""
        pts = self.points_from_range(frame, self.depth(frame, return_num))
        dzdx = pts.roll(-1, 0) - pts.roll(1, 0)
        dzdy = pts.roll(-1, 1) - pts.roll(1, 1)
        n = torch.linalg.cross(dzdx, dzdy, dim=-1)
        n = n / torch.linalg.vector_norm(n, dim=-1,
                                         keepdim=True).clamp_min(1e-12)
        to_sensor = self.sensor_center(frame) - pts
        return torch.where((n * to_sensor).sum(-1, keepdim=True) < 0, -n, n)

    def split_train_eval(self, eval_stride: int = 10) -> None:
        """Hold out every `eval_stride`-th frame, starting at half the
        stride (the fallback when a config lists no eval frames)."""
        all_f = list(range(self.num_frames))
        self.eval_frames = all_f[eval_stride // 2::eval_stride]
        self.train_frames = [f for f in all_f if f not in self.eval_frames]
