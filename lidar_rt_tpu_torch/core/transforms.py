"""Rigid transform helpers (counterpart of `lidar_rt_tpu.core.transforms`)."""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def se3(rotation: Tensor, translation: Tensor) -> Tensor:
    """(..., 3, 3) + (..., 3) -> homogeneous (..., 4, 4)."""
    batch = rotation.shape[:-2]
    m = torch.zeros((*batch, 4, 4), dtype=rotation.dtype,
                    device=rotation.device)
    m[..., :3, :3] = rotation
    m[..., :3, 3] = translation
    m[..., 3, 3] = 1.0
    return m


def invert_se3(m: Tensor) -> Tensor:
    """Invert rigid transforms (..., 4, 4) without a general solve.

    The product R^T t is written as an elementwise sum so it stays full f32
    whatever the matmul precision setting (world-scale translations)."""
    r_t = m[..., :3, :3].transpose(-1, -2)
    t = m[..., :3, 3]
    return se3(r_t, -(r_t * t[..., None, :]).sum(-1))


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
