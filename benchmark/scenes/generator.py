"""The benchmark's copy of the synthetic LiDAR generator: a ground plane and
oriented boxes (walls and moving vehicles), ray-cast exactly against a
spherical raster in torch on the raster's device.

It follows the port's `data/synthetic.py` and the rehearsal's scene
builders (`scripts/e2e_rehearsal.py` `waymo_scene`, `gen_waymo`,
`gen_kitti`), with every size read from a configuration file under
`benchmark/configs/`.  Beside each return's range and intensity it keeps the
hit's surface id and the normal of the face that was hit, which the surfel
maker (`surfels.py`) needs.

Nothing here imports the port: the rays are made by this module, and the
port's `SensorGrid` is built from the same inclination table
(`drivers/common.py`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


class Box(NamedTuple):
    center: np.ndarray
    size: np.ndarray
    yaw: float
    albedo: float
    velocity: np.ndarray

    def rotation(self) -> np.ndarray:
        c, s = math.cos(self.yaw), math.sin(self.yaw)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    def center_at(self, frame: int) -> np.ndarray:
        return self.center + frame * self.velocity


def boxes(cfg: dict, kind: str) -> list[Box]:
    """The config's walls ("walls") or vehicles ("actors")."""
    out = []
    for b in cfg["scene"][kind]:
        out.append(Box(np.asarray(b["center"], np.float64),
                       np.asarray(b["size"], np.float64), float(b["yaw"]),
                       float(b["albedo"]),
                       np.asarray(b.get("velocity", [0.0, 0.0, 0.0]),
                                  np.float64)))
    return out


def inclinations(cfg: dict) -> np.ndarray:
    """Row inclinations (H,), top row first, float32."""
    r = cfg["raster"]
    h = int(r["height"])
    if "beams_linspace" in r:            # a beam table, given bottom-up
        lo, hi = r["beams_linspace"]
        return np.linspace(lo, hi, h).astype(np.float32)[::-1].copy()
    lo, hi = (math.radians(x) for x in r["bounds_deg"])
    i = np.arange(h, dtype=np.float32)
    grid_y = (h - i - float(r["pixel_offset"])) / float(h)
    return (grid_y * (hi - lo) + lo).astype(np.float32)


def poses(cfg: dict) -> np.ndarray:
    """sensor -> world (F, 4, 4), float32: the ego moves by `ego_step` per
    frame; the sensor sits `sensor_height` above it, turned by
    `extrinsic_yaw`."""
    fr = cfg["frames"]
    yaw = float(fr["extrinsic_yaw"])
    ext = np.eye(4)
    ext[:2, :2] = [[math.cos(yaw), -math.sin(yaw)],
                   [math.sin(yaw), math.cos(yaw)]]
    ext[2, 3] = float(fr["sensor_height"])
    out = np.tile(np.eye(4), (int(fr["count"]), 1, 1))
    for f in range(out.shape[0]):
        ego = np.eye(4)
        ego[:3, 3] = f * np.asarray(fr["ego_step"], np.float64)
        out[f] = ego @ ext
    return out.astype(np.float32)


def train_frames(cfg: dict) -> list[int]:
    held = set(cfg["frames"]["eval"])
    return [f for f in range(int(cfg["frames"]["count"])) if f not in held]


def sensor_dirs(incl: Tensor, width: int, pixel_offset: float,
                angle_offset: float) -> Tensor:
    """Unit directions in the sensor frame, (H, W, 3): column j has azimuth
    2 pi (W - j - pixel_offset) / W - pi - angle_offset."""
    cols = torch.arange(width, dtype=torch.float32, device=incl.device)
    az = ((width - cols - pixel_offset) / float(width)) * (2.0 * math.pi) \
        - math.pi - angle_offset
    ci, si = torch.cos(incl)[:, None], torch.sin(incl)[:, None]
    d = torch.stack([ci * torch.cos(az)[None], ci * torch.sin(az)[None],
                     si.expand(-1, width)], -1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def world_dirs(dirs: Tensor, s2w: Tensor) -> Tensor:
    """Sensor directions (H, W, 3) turned into the world frame."""
    d = (s2w[:3, :3] * dirs[..., None, :]).sum(-1)
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def _ray_box(origin: Tensor, dirs: Tensor, box: Box, center: np.ndarray
             ) -> tuple[Tensor, Tensor, Tensor]:
    """Slab-method intersection in float64: (t (R,), cos incidence (R,),
    world normal of the entry face (R, 3)); misses get +inf."""
    dev = dirs.device
    r = torch.as_tensor(box.rotation(), device=dev).double()
    o = (origin.double() - torch.as_tensor(center, device=dev)) @ r
    d = dirs.double() @ r
    half = torch.as_tensor(box.size / 2.0, device=dev)
    inv = 1.0 / torch.where(d.abs() > 1e-12, d, 1e-12)
    t1 = (-half - o) * inv
    t2 = (half - o) * inv
    near = torch.minimum(t1, t2)
    tmin = near.amax(-1)
    tmax = torch.maximum(t1, t2).amin(-1)
    t = torch.where(tmax > tmin.clamp_min(1e-3), tmin, torch.inf)
    axis = (near - tmin[:, None]).abs().argmin(-1, keepdim=True)
    d_axis = d.gather(1, axis)[:, 0]
    local_n = torch.zeros_like(d).scatter_(1, axis,
                                          -torch.sign(d_axis)[:, None])
    return t, d_axis.abs(), local_n @ r.T


class Cast(NamedTuple):
    """One frame's returns: per return (range (H, W), intensity (H, W),
    surface id (H, W) int64: 0 ground, 1.. walls, then vehicles, -1 none,
    world normal (H, W, 3)), and the ray origin (3,)."""

    returns: list[tuple[Tensor, Tensor, Tensor, Tensor]]
    origin: Tensor


def cast_frame(cfg: dict, dirs_s: Tensor, s2w: Tensor, frame: int) -> Cast:
    """Ray-cast every surface at `frame` and keep the returns the raster
    has: the nearest hit, and with two returns the nearest at least
    `return_gap` past it.  Hits beyond max_range are no return."""
    r = cfg["raster"]
    h, w = dirs_s.shape[:2]
    origin = s2w[:3, 3]
    dirs = world_dirs(dirs_s, s2w).reshape(-1, 3)
    dz = dirs[:, 2]
    ts = [torch.where(dz < -1e-6, -origin[2].double() / torch.where(
        dz.abs() > 1e-12, dz, -1e-12).double(), torch.inf)]
    its = [(float(cfg["scene"]["ground_albedo"]) * dz.abs()).double()]
    ns = [torch.tensor([0.0, 0.0, 1.0], device=dirs.device,
                       dtype=torch.float64).expand(dirs.shape[0], 3)]
    for box, center in ([(b, b.center) for b in boxes(cfg, "walls")]
                        + [(b, b.center_at(frame))
                           for b in boxes(cfg, "actors")]):
        t, cos_inc, n = _ray_box(origin, dirs, box, center)
        ts.append(t)
        its.append(box.albedo * cos_inc.clamp(0.1, 1.0))
        ns.append(n)
    t_all = torch.stack(ts, -1).float()
    i_all = torch.stack(its, -1).float()
    n_all = torch.stack(ns, 1).float()                       # (R, S, 3)
    max_range = float(r["max_range"])
    out = []
    best = t_all.argmin(-1, keepdim=True)
    best_t = t_all.gather(1, best)
    picks = [(best, best_t[:, 0])]
    if int(r["returns"]) > 1:
        t2_all = torch.where(t_all >= best_t + float(r["return_gap"]),
                             t_all, torch.inf)
        second = t2_all.argmin(-1, keepdim=True)
        picks.append((second, t2_all.gather(1, second)[:, 0]))
    for sel, t in picks:
        hit = t < max_range
        rng = torch.where(hit, t, 0.0).view(h, w)
        inten = torch.where(hit, i_all.gather(1, sel)[:, 0].clamp(0.0, 1.0),
                            0.0).view(h, w)
        sid = torch.where(hit, sel[:, 0], -1).view(h, w)
        nrm = n_all[torch.arange(n_all.shape[0], device=sel.device),
                    sel[:, 0]].view(h, w, 3)
        out.append((rng, inten, sid, nrm))
    return Cast(out, origin)


class Frames(NamedTuple):
    """The segment: row inclinations (H,), poses (F, 4, 4), range and
    intensity per return (F, H, W) (the second return None with one), the
    training frames, and every frame's casts (for the surfel maker)."""

    inclinations: Tensor
    poses: Tensor
    range1: Tensor
    intensity1: Tensor
    range2: Tensor | None
    intensity2: Tensor | None
    train: list[int]
    casts: list[Cast]


def make_frames(cfg: dict, device) -> Frames:
    """Every frame of the configuration, made on `device`."""
    incl = torch.as_tensor(inclinations(cfg), device=device)
    r = cfg["raster"]
    dirs_s = sensor_dirs(incl, int(r["width"]), float(r["pixel_offset"]),
                         float(r["angle_offset"]))
    pose = torch.as_tensor(poses(cfg), device=device)
    casts = [cast_frame(cfg, dirs_s, pose[f], f)
             for f in range(pose.shape[0])]
    stack = [torch.stack([c.returns[k][j] for c in casts])
             for k in range(len(casts[0].returns)) for j in (0, 1)]
    two = len(stack) == 4
    return Frames(incl, pose, stack[0], stack[1],
                  stack[2] if two else None, stack[3] if two else None,
                  train_frames(cfg), casts)
