"""Quaternion algebra (wxyz layout), counterpart of
`lidar_rt_tpu.core.quaternions`.

Layout: q = (w, x, y, z), rotation acts as  p' = R(q) @ p  on column points;
the third column of R(q) is a surfel's splat-plane normal.
"""

from __future__ import annotations

import math

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


def rotation_matrix_vjp(q: Tensor, g: Tensor) -> Tensor:
    """VJP of `to_rotation_matrix` at unnormalized q (..., 4) with cotangent
    g (..., 3, 3): dL/dq.  Taken by autograd over the closed form
    (`torch.autograd.functional.vjp`, as the reference takes `jax.vjp`),
    so it cannot drift from `to_rotation_matrix`."""
    return torch.autograd.functional.vjp(to_rotation_matrix, q, g)[1]


def from_rotation_matrix(m: Tensor, eps: float = 1e-12) -> Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) wxyz.

    Shepperd-style: all four candidate quaternions, the one whose pivot
    magnitude is largest kept (the first on ties, as argmax does), sign
    canonicalized to w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = (1.0 + m00 + m11 + m22).clamp_min(0.0)
    qx2 = (1.0 + m00 - m11 - m22).clamp_min(0.0)
    qy2 = (1.0 - m00 + m11 - m22).clamp_min(0.0)
    qz2 = (1.0 - m00 - m11 + m22).clamp_min(0.0)
    cands = torch.stack([
        torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1),
    ], dim=-2)                                        # (..., 4 cands, 4)
    pick = torch.stack([qw2, qx2, qy2, qz2], dim=-1).argmax(-1)
    q = torch.take_along_dim(cands, pick[..., None, None].expand(
        *pick.shape, 1, 4), dim=-2)[..., 0, :]
    q = normalize(q, eps)
    return torch.where(q[..., :1] < 0, -q, q)


def rotate(q: Tensor, p: Tensor) -> Tensor:
    """Rotate points p (..., 3) by quaternions q (..., 4): R(q) @ p, as an
    elementwise sum (full f32 whatever the matmul precision setting)."""
    return (to_rotation_matrix(q) * p[..., None, :]).sum(-1)


def with_fixed_normal(normals: Tensor, theta: Tensor) -> Tensor:
    """Quaternions whose R(q)[:, 2] is the given unit normals (N, 3), spun
    in plane by theta (N, 1) radians about +z before the alignment."""
    n = normals / torch.linalg.vector_norm(
        normals, dim=-1, keepdim=True).clamp_min(1e-12)
    z = n.new_tensor([0.0, 0.0, 1.0]).expand(n.shape)
    axis = torch.linalg.cross(z, n, dim=-1)
    axis_norm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    cos_half = ((1.0 + n[..., 2:3]) * 0.5).clamp_min(0.0).sqrt()
    sin_half = ((1.0 - n[..., 2:3]) * 0.5).clamp_min(0.0).sqrt()
    safe_axis = torch.where(axis_norm > 1e-8,
                            axis / axis_norm.clamp_min(1e-12),
                            n.new_tensor([1.0, 0.0, 0.0]))
    q_align = torch.cat([cos_half, safe_axis * sin_half], dim=-1)
    # n ~ -z has no rotation axis: rotate pi about x.
    degenerate = (n[..., 2:3] < -1.0 + 1e-6) & (axis_norm <= 1e-8)
    q_align = torch.where(degenerate, n.new_tensor([0.0, 1.0, 0.0, 0.0]),
                          q_align)
    zero = torch.zeros_like(theta)
    q_spin = torch.cat([torch.cos(theta * 0.5), zero, zero,
                        torch.sin(theta * 0.5)], dim=-1)
    return normalize(multiply(q_align, q_spin))


def random_with_fixed_normal(generator: torch.Generator,
                             normals: Tensor) -> Tensor:
    """`with_fixed_normal` with each spin drawn uniformly from [0, 2 pi)
    with the caller's generator (on the normals' device)."""
    theta = torch.rand((normals.shape[0], 1), generator=generator,
                       device=normals.device) * (2.0 * math.pi)
    return with_fixed_normal(normals, theta)
