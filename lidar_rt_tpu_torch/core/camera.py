"""Pinhole camera: debug renders of a surfel scene from camera views
(counterpart of `lidar_rt_tpu.core.camera`).

The reference's Camera/MiniCam (lib/scene/cameras.py:16-61) and the camera
branch of its `raytracing()` (lib/gaussian_renderer/__init__.py:31-41),
for synthetic-view checks of a LiDAR scene.  Camera rays follow no
spherical raster, so the render goes through the dense oracle
(`ops.composite.render_dense`), chunked over pixels: a debugging tool,
not a hot path.  The rays are built with numpy, as the reference builds
them, then moved to the render's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops import composite

Tensor = torch.Tensor


@dataclass(frozen=True)
class Camera:
    """r: (3, 3) world->camera rotation; t: (3,) translation (the
    reference's COLMAP-style convention, cameras.py:16-47)."""

    image_height: int
    image_width: int
    fovx: float
    fovy: float
    r: np.ndarray
    t: np.ndarray
    znear: float = 0.01
    zfar: float = 100.0

    @property
    def world_view_transform(self) -> np.ndarray:
        return transforms.world_to_view(self.r, self.t)

    @property
    def projection_matrix(self) -> np.ndarray:
        return transforms.projection_matrix(self.znear, self.zfar,
                                            self.fovx, self.fovy)

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.world_view_transform)[:3, 3]

    def rays(self, device: str | torch.device = "cuda"
             ) -> tuple[Tensor, Tensor]:
        """(origin (3,), dirs (H, W, 3)) world-frame pinhole rays on
        `device`, float32 (reference graphics_utils.py:88-95)."""
        h, w = self.image_height, self.image_width
        tan_x = np.tan(self.fovx / 2.0)
        tan_y = np.tan(self.fovy / 2.0)
        xs = (np.arange(w, dtype=np.float32) + 0.5) / w * 2.0 - 1.0
        ys = (np.arange(h, dtype=np.float32) + 0.5) / h * 2.0 - 1.0
        dx, dy = np.meshgrid(xs * tan_x, ys * tan_y)
        d_cam = np.stack([dx, dy, np.ones_like(dx)], axis=-1)
        c2w = np.linalg.inv(self.world_view_transform)
        d_world = d_cam @ c2w[:3, :3].T
        d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
        return (torch.as_tensor(self.camera_center, dtype=torch.float32,
                                device=device),
                torch.as_tensor(d_world, dtype=torch.float32, device=device))


def render_debug(bundle: composite.SurfelBundle, camera: Camera,
                 background: Tensor | None = None, active_sh_degree: int = 3,
                 chunk: int = 8192) -> dict[str, Tensor]:
    """Render a camera view of the surfel bundle through the dense oracle,
    `chunk` pixels at a time, on the bundle's device.

    Returns intensity, depth and accum images (H, W) and the channels
    (H, W, 9).  O(pixels x surfels): for small views of small scenes."""
    dev = bundle.means.device
    bg = background if background is not None else torch.zeros(3,
                                                                device=dev)
    origin, dirs = camera.rays(dev)
    flat = dirs.reshape(-1, 3)
    ch = torch.cat([composite.render_dense(bundle, origin,
                                           flat[s:s + chunk], bg,
                                           active_sh_degree).channels
                    for s in range(0, flat.shape[0], chunk)])
    ch = ch.reshape(camera.image_height, camera.image_width, 9)
    return {"intensity": ch[..., 0], "depth": ch[..., 3],
            "accum": ch[..., 4], "channels": ch}
