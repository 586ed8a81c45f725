"""Rigid and pinhole-camera transform helpers (counterpart of
`lidar_rt_tpu.core.transforms`)."""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def se3(rotation: Tensor, translation: Tensor) -> Tensor:
    """(..., 3, 3) + (..., 3) -> homogeneous (..., 4, 4).  The corner is
    filled on the device (a Python scalar assigned by index is copied from
    the host, which a CUDA graph cannot capture)."""
    batch = rotation.shape[:-2]
    m = torch.zeros((*batch, 4, 4), dtype=rotation.dtype,
                    device=rotation.device)
    m[..., :3, :3] = rotation
    m[..., :3, 3] = translation
    m[..., 3, 3].fill_(1.0)
    return m


def invert_se3(m: Tensor) -> Tensor:
    """Invert rigid transforms (..., 4, 4) without a general solve.

    The product R^T t is written as an elementwise sum so it stays full f32
    whatever the matmul precision setting (world-scale translations)."""
    r_t = m[..., :3, :3].transpose(-1, -2)
    t = m[..., :3, 3]
    return se3(r_t, -(r_t * t[..., None, :]).sum(-1))


def world_to_view(r: np.ndarray, t: np.ndarray,
                  translate=(0.0, 0.0, 0.0), scale: float = 1.0
                  ) -> np.ndarray:
    """Pinhole world->view matrix (4, 4) float32 of a camera with rotation
    r (3, 3) and translation t (3,) (numpy, host side; reference
    graphics_utils.py:38-52)."""
    rt = np.zeros((4, 4), dtype=np.float32)
    rt[:3, :3] = np.asarray(r).T
    rt[:3, 3] = np.asarray(t)
    rt[3, 3] = 1.0
    c2w = np.linalg.inv(rt)
    c2w[:3, 3] = (c2w[:3, 3] + np.asarray(translate)) * scale
    return np.linalg.inv(c2w).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float,
                      fovy: float) -> np.ndarray:
    """OpenGL-style perspective projection (4, 4) float32 (numpy, host
    side; reference graphics_utils.py:54-71)."""
    tan_x = np.tan(fovx / 2.0)
    tan_y = np.tan(fovy / 2.0)
    p = np.zeros((4, 4), dtype=np.float32)
    p[0, 0] = 1.0 / tan_x
    p[1, 1] = 1.0 / tan_y
    p[3, 2] = 1.0
    p[2, 2] = zfar / (zfar - znear)
    p[2, 3] = -(zfar * znear) / (zfar - znear)
    return p


def forward_fill_poses(present: np.ndarray, translations: np.ndarray,
                       rotations: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Fill missing per-frame actor poses (numpy, host side) with the
    nearest earlier observed frame, or before the first observation with
    the first.  present: (F,) bool; arrays are (F, ...)."""
    t = translations.copy()
    r = rotations.copy()
    seen = np.flatnonzero(present)
    if seen.size == 0:
        return t, r
    src = np.maximum.accumulate(np.where(present, np.arange(len(present)),
                                         -1))
    src[src < 0] = seen[0]
    return t[src], r[src]
