"""Procedural synthetic LiDAR scenes with analytic ground truth
(counterpart of `lidar_rt_tpu.data.synthetic`).

A ground plane plus oriented boxes (static walls and moving actors),
ray-cast exactly against the sensor raster in torch on the raster's
device.  `generate` returns port `LiDARFrames` and the actor's
ground-truth `ActorTrack`; `render_frame_gt_dual` gives the two returns
that a Waymo writer needs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.scene.tracks import ActorTrack, TrackBuilder

Tensor = torch.Tensor


@dataclass
class Box:
    """Oriented box: center, full size, yaw about z; albedo in [0, 1]."""

    center: np.ndarray
    size: np.ndarray
    yaw: float = 0.0
    albedo: float = 0.8

    def rotation(self) -> np.ndarray:
        c, s = np.cos(self.yaw), np.sin(self.yaw)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


@dataclass
class SyntheticScene:
    """Ground plane at z=0 (albedo ground_albedo) + boxes; an optional
    moving actor box translating by `actor_velocity` per frame, and more
    moving actors in extra_actors/extra_velocities."""

    walls: list[Box] = field(default_factory=list)
    ground_albedo: float = 0.4
    actor: Box | None = None
    actor_velocity: np.ndarray | None = None
    max_range: float = 80.0
    extra_actors: list[Box] = field(default_factory=list)
    extra_velocities: list[np.ndarray] = field(default_factory=list)

    def moving_boxes(self, frame: int) -> list[tuple[Box, np.ndarray]]:
        """All actor boxes with their frame-`frame` centers."""
        out = []
        if self.actor is not None:
            out.append((self.actor,
                        self.actor.center + frame * self.actor_velocity))
        for box, vel in zip(self.extra_actors, self.extra_velocities):
            out.append((box, box.center + frame * np.asarray(vel)))
        return out


def default_scene(with_actor: bool = True) -> SyntheticScene:
    walls = [
        Box(np.array([18.0, -6.0, 2.0]), np.array([2.0, 30.0, 4.0]),
            yaw=0.1, albedo=0.7),
        Box(np.array([-14.0, 8.0, 1.5]), np.array([3.0, 20.0, 3.0]),
            yaw=-0.2, albedo=0.6),
        Box(np.array([6.0, 14.0, 1.0]), np.array([4.0, 2.0, 2.0]),
            albedo=0.9),
    ]
    actor = Box(np.array([8.0, -2.0, 0.9]), np.array([4.2, 1.9, 1.6]),
                yaw=0.3, albedo=0.95) if with_actor else None
    vel = np.array([0.8, 0.15, 0.0]) if with_actor else None
    return SyntheticScene(walls=walls, actor=actor, actor_velocity=vel)


def _ray_box(origin: Tensor, dirs: Tensor, box: Box, center: np.ndarray
             ) -> tuple[Tensor, Tensor]:
    """Slab-method ray/box intersection in float64 (the ray directions
    rotated into the box frame in float32).  origin (3,), dirs (R, 3).
    Returns (t (R,), cos_incidence (R,)); misses get +inf."""
    dev = dirs.device
    r = torch.as_tensor(box.rotation(), device=dev)
    o = ((origin.double() - torch.as_tensor(center, device=dev))
         @ r.double())
    d = rays_lib.rotate_points(r.T, dirs).double()
    half = torch.as_tensor(box.size / 2.0, device=dev)
    inv = 1.0 / torch.where(d.abs() > 1e-12, d, 1e-12)
    t1 = (-half - o) * inv
    t2 = (half - o) * inv
    near = torch.minimum(t1, t2)
    tmin = near.amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    t = torch.where(tmax > tmin.clamp_min(1e-3), tmin, torch.inf)
    # Entry face: the axis whose slab entry is the latest.
    axis = (near - tmin[:, None]).abs().argmin(-1, keepdim=True)
    d_axis = d.gather(1, axis)[:, 0]
    return t, d_axis.abs()


def _cast_all(scene: SyntheticScene, grid: rays_lib.SensorGrid, width: int,
              sensor2world, frame: int) -> tuple[Tensor, Tensor]:
    """Ray-cast every surface: (t (R, S), intensity (R, S)) float32 on
    the raster's device; misses +inf."""
    dev = grid.row_inclinations.device
    origin, dirs = rays_lib.range_rays(
        grid, width, torch.as_tensor(np.asarray(sensor2world, np.float32),
                                     device=dev))
    dirs = dirs.reshape(-1, 3)
    dz = dirs[:, 2]
    ts = [torch.where(dz < -1e-6, -origin[2] / torch.where(
        dz.abs() > 1e-12, dz, -1e-12), torch.inf).double()]
    its = [(scene.ground_albedo * dz.abs()).double()]
    boxes = [(b, b.center) for b in scene.walls] + scene.moving_boxes(frame)
    for box, center in boxes:
        t, cos_inc = _ray_box(origin, dirs, box, center)
        ts.append(t)
        its.append(box.albedo * cos_inc.clamp(0.1, 1.0))
    return torch.stack(ts, -1).float(), torch.stack(its, -1).float()


def _images(scene: SyntheticScene, h: int, width: int, t: Tensor,
            inten: Tensor) -> tuple[Tensor, Tensor]:
    hit = t < scene.max_range
    return (torch.where(hit, t, 0.0).view(h, width),
            torch.where(hit, inten.clamp(0.0, 1.0), 0.0).view(h, width))


def render_frame_gt(scene: SyntheticScene, grid: rays_lib.SensorGrid,
                    width: int, sensor2world, frame: int
                    ) -> tuple[Tensor, Tensor]:
    """Exact (range (H, W), intensity (H, W)) for one frame, float32 on
    the raster's device; 0 = no return."""
    t_all, i_all = _cast_all(scene, grid, width, sensor2world, frame)
    best = t_all.argmin(-1, keepdim=True)
    return _images(scene, grid.height, width, t_all.gather(1, best)[:, 0],
                   i_all.gather(1, best)[:, 0])


def render_frame_gt_dual(scene: SyntheticScene, grid: rays_lib.SensorGrid,
                         width: int, sensor2world, frame: int,
                         return_gap: float = 1.0) -> tuple[Tensor, ...]:
    """Dual-return ground truth (r1, i1, r2, i2), each (H, W): return 2 is
    the nearest surface at least `return_gap` meters past the first; rays
    with no second surface get 0."""
    t_all, i_all = _cast_all(scene, grid, width, sensor2world, frame)
    best = t_all.argmin(-1, keepdim=True)
    best_t = t_all.gather(1, best)
    t2_all = torch.where(t_all >= best_t + return_gap, t_all, torch.inf)
    second = t2_all.argmin(-1, keepdim=True)
    h = grid.height
    return (*_images(scene, h, width, best_t[:, 0],
                     i_all.gather(1, best)[:, 0]),
            *_images(scene, h, width, t2_all.gather(1, second)[:, 0],
                     i_all.gather(1, second)[:, 0]))


def generate(scene: SyntheticScene | None = None, num_frames: int = 6,
             height: int = 32, width: int = 256,
             inclination_bounds: tuple[float, float] = (-0.42, 0.08),
             sensor_height: float = 2.0, ego_velocity=(0.5, 0.0, 0.0),
             with_actor: bool = True, device: str | torch.device = "cuda",
             ) -> tuple[LiDARFrames, ActorTrack | None]:
    """A LiDARFrames sequence (+ the actor's ground-truth track) on
    `device`, the card unless the caller names another."""
    scene = scene or default_scene(with_actor)
    grid = rays_lib.SensorGrid.from_bounds(height, inclination_bounds,
                                           device=device)
    poses = np.tile(np.eye(4, dtype=np.float32), (num_frames, 1, 1))
    for f in range(num_frames):
        poses[f, :3, 3] = np.array([0.0, 0.0, sensor_height]) \
            + f * np.asarray(ego_velocity)
    images = [render_frame_gt(scene, grid, width, poses[f], f)
              for f in range(num_frames)]
    frames = LiDARFrames(
        grid, width, torch.as_tensor(poses, device=device),
        torch.stack([r for r, _ in images]),
        torch.stack([i for _, i in images]),
        frame_numbers=list(range(num_frames)))
    frames.split_train_eval(eval_stride=max(2, num_frames // 2))

    track = None
    if scene.actor is not None:
        tb = TrackBuilder(num_frames, scene.actor.size, object_id="actor0")
        c, s = np.cos(scene.actor.yaw), np.sin(scene.actor.yaw)
        quat = np.array([np.sqrt((1 + c) / 2), 0.0, 0.0,
                         np.sign(s) * np.sqrt(max(0.0, (1 - c) / 2))],
                        np.float32)
        for f in range(num_frames):
            tb.add_frame_pose(f, scene.actor.center
                              + f * scene.actor_velocity, quat)
        track = tb.build(device)
    return frames, track
