"""Render containers and the dense oracle renderer (counterpart of
`lidar_rt_tpu.ops.composite`).

`render_dense` evaluates every (ray, surfel) pair, O(R*N): tiny scenes and
tests only.  Channel layout:
    0:3  color   (intensity, ray-hit logit, ray-drop logit), SH-evaluated
    3    depth   (expected range)
    4    accum   (sum of compositing weights)
    5:8  normal  (composited signed plane normals)
    8    final transmittance
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib
from lidar_rt_tpu_torch.core import sh as sh_lib
from lidar_rt_tpu_torch.ops import geometry

Tensor = torch.Tensor


class SurfelBundle(NamedTuple):
    """Activated, world-frame surfel parameters ready to render.

    means (N, 3); rotations (N, 4) wxyz, need not be normalized;
    scales (N, 2) positive; opacities (N,) in (0, 1); sh (N, 16, 3).
    """

    means: Tensor
    rotations: Tensor
    scales: Tensor
    opacities: Tensor
    sh: Tensor

    @property
    def num_surfels(self) -> int:
        return self.means.shape[0]


class RenderOutputs(NamedTuple):
    """Per-ray channels (..., 9) + per-surfel accumulated weights (N,).

    raw_trans: per-ray ungated transmittance product.  Below T_MIN it only
    means "dead": engines may stop a ray before multiplying every alpha.
    """

    channels: Tensor
    accum_weights: Tensor
    raw_trans: Tensor | None = None


def shade(sh_coeffs: Tensor, dirs: Tensor, active_degree: int) -> Tensor:
    """(R, 3) dirs x (N, 16, 3) coeffs -> (R, N, 3) channels; intensity
    (channel 0) clamped at zero, the two logits unclamped."""
    basis = sh_lib.basis(dirs, active_degree)
    colors = torch.einsum("rk,nkc->rnc", basis, sh_coeffs) + 0.5
    return torch.cat([colors[..., :1].clamp_min(0.0), colors[..., 1:]], -1)


def render_dense(bundle: SurfelBundle, origin: Tensor, dirs: Tensor,
                 background: Tensor, active_sh_degree: int = 3,
                 order: str = "ray_t") -> RenderOutputs:
    """Render rays (R, 3) against all surfels densely.

    order "ray_t": exact per-ray depth order; "given": the surfel order as
    passed (the tiled tracer's tile order)."""
    rot_mats = quat_lib.to_rotation_matrix(bundle.rotations)
    frames = geometry.build_frames(bundle.means, rot_mats, origin)
    hits = geometry.intersect(frames, bundle.scales, bundle.opacities, dirs)

    if order == "ray_t":
        key = torch.where(hits.valid, hits.t, torch.inf)
        perm = torch.argsort(key, dim=-1, stable=True)
        w_sorted, final_t = geometry.composite_weights(
            torch.gather(hits.alpha, -1, perm))
        w = torch.zeros_like(w_sorted).scatter(-1, perm, w_sorted)
    elif order == "given":
        w, final_t = geometry.composite_weights(hits.alpha)
    else:
        raise ValueError(f"unknown order {order!r}")

    colors = shade(bundle.sh, dirs, active_sh_degree)        # (R, N, 3)
    signed_normals = frames.n * frames.sign[:, None]          # (N, 3)
    color_out = ((w[..., None] * colors).sum(1)
                 + final_t[:, None] * background[None, :])
    depth_out = (w * hits.t).sum(-1)
    accum_out = w.sum(-1)
    normal_out = (w[..., None] * signed_normals[None]).sum(1)
    channels = torch.cat(
        [color_out, depth_out[:, None], accum_out[:, None], normal_out,
         final_t[:, None]], dim=-1)
    return RenderOutputs(channels=channels, accum_weights=w.sum(0))
