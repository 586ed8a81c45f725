"""Novel-sensor re-simulation: render a scene under new sensors
(counterpart of `lidar_rt_tpu.sim`, the serving surface).

  * `render_scan`: one scan from any sensor pose and beam pattern,
  * `resimulate`: open-loop scans over a pose trajectory,
  * `rollout`: closed loop, a controller turns each scan into the next pose.

Rendering runs under `torch.no_grad()`: serving needs no gradients.
"""

from __future__ import annotations

from typing import Callable

import torch

from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.scene import Scene, compose

Tensor = torch.Tensor


@torch.no_grad()
def render_scan(scene: Scene, grid: rays_lib.SensorGrid, width: int,
                sensor2world: Tensor, frame: int = 0,
                cfg: tracer_lib.TraceConfig | None = None,
                use_rayhit: bool = True) -> dict[str, Tensor]:
    """One scan from an arbitrary sensor pose/pattern; `frame` selects the
    actor poses on the scene's timeline (clamped)."""
    cfg = cfg or tracer_lib.TraceConfig()
    bundle, _ = compose(scene, frame)
    return tracer_lib.render_frame(bundle, grid, width, sensor2world,
                                   scene.background.active_sh_degree, cfg,
                                   use_rayhit)


def resimulate(scene: Scene, grid: rays_lib.SensorGrid, width: int,
               poses: Tensor, frame_indices: list[int] | None = None,
               cfg: tracer_lib.TraceConfig | None = None,
               drop_threshold: float = 0.4) -> dict[str, Tensor]:
    """Open-loop re-simulation over poses (F, 4, 4).  frame_indices (F,)
    default to 0..F-1 clamped to the timeline.  Returns stacked (F, H, W)
    depth / intensity / raydrop and the range image (depth where the ray
    returns, 0 where it is dropped)."""
    f = poses.shape[0]
    if frame_indices is None:
        frame_indices = [min(i, scene.num_frames - 1) for i in range(f)]
    outs: dict[str, list[Tensor]] = {
        "depth": [], "intensity": [], "raydrop": [], "range_image": []}
    for pose, frame in zip(poses, frame_indices):
        out = render_scan(scene, grid, width, pose, int(frame), cfg)
        outs["depth"].append(out["depth"])
        outs["intensity"].append(out["intensity"])
        outs["raydrop"].append(out["raydrop"])
        outs["range_image"].append(
            out["depth"] * (out["raydrop"] < drop_threshold))
    return {k: torch.stack(v) for k, v in outs.items()}


def rollout(scene: Scene, grid: rays_lib.SensorGrid, width: int,
            initial_pose: Tensor,
            controller: Callable[[dict, Tensor, int], Tensor],
            num_steps: int, cfg: tracer_lib.TraceConfig | None = None
            ) -> tuple[Tensor, dict[str, list]]:
    """Closed loop: controller(scan_dict, pose, step) -> next pose.
    Returns the visited poses (S+1, 4, 4) and per-step scan lists."""
    pose = initial_pose
    poses = [pose]
    scans: dict[str, list] = {"depth": [], "intensity": [], "raydrop": []}
    for s in range(num_steps):
        out = render_scan(scene, grid, width, pose, s, cfg)
        for k in scans:
            scans[k].append(out[k])
        pose = controller(out, pose, s)
        poses.append(pose)
    return torch.stack(poses), scans
