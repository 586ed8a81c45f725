"""Quaternion algebra (wxyz layout), the render path's subset of
`lidar_rt_tpu.core.quaternions`.

Layout: q = (w, x, y, z), rotation acts as  p' = R(q) @ p  on column points;
the third column of R(q) is a surfel's splat-plane normal.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def normalize(q: Tensor, eps: float = 1e-12) -> Tensor:
    """Normalize quaternions to unit norm.  q: (..., 4)."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(eps)


def multiply(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a*b, each (..., 4) wxyz: R(a*b) = R(a) @ R(b)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def to_rotation_matrix(q: Tensor) -> Tensor:
    """Quaternion (..., 4), normalized internally -> rotation (..., 3, 3)."""
    q = normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)
