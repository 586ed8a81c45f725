"""GaussianAsset: one surfel cloud (background or actor) as a frozen
dataclass of tensors (counterpart of `lidar_rt_tpu.scene.asset`).

Raw (pre-activation) parameters and their activations:

    scales   = exp(clamp(log_scale, -13.8, 13.8))
    opacity  = sigmoid(opacity_logit)
    rotation = normalize(quat)         (wxyz)
    sh       = concat(f_dc, f_rest)    per-channel SH coefficients

Arrays are padded to a fixed capacity with an `alive` mask; dead slots
hold neutral values (identity rotation, opacity logit -30).  Actors are
stacked into one asset with a leading actor axis.  `from_points` seeds an
asset from a point cloud at scene assembly.  Training keeps the
capacity fixed, so the optimizer's parameters are the asset's own tensors,
updated in place (`train/optim.py`, `train/density.py`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib
from lidar_rt_tpu_torch.core import sh as sh_lib
from lidar_rt_tpu_torch.ops import knn as knn_lib

Tensor = torch.Tensor

DEAD_OPACITY_LOGIT = -30.0
DEAD_LOG_SCALE = -10.0

# The reference's optimizer group names -> asset fields (gaussian_model.py
# :191-198; `lidar_rt_tpu.scene.asset.GaussianAsset.params`).
PARAM_FIELDS = {
    "xyz": "xyz",
    "f_dc": "f_dc",
    "f_rest": "f_rest",
    "opacity": "opacity_logit",
    "scaling": "log_scale",
    "rotation": "quat",
}


def inverse_sigmoid(x: Tensor) -> Tensor:
    return torch.log(x / (1.0 - x))


@dataclass(frozen=True)
class GaussianAsset:
    """Padded surfel cloud; leading dim = capacity C (after any actor axis).

      xyz (C, 3) local-frame positions; f_dc (C, 1, 3), f_rest (C, 15, 3)
      SH for (intensity, hit, drop); log_scale (C, 2); quat (C, 4) wxyz;
      opacity_logit (C,); alive (C,) bool; active_sh_degree the SH degree
      the renderer evaluates, grown to max_sh_degree by the SH warm-up;
      extent the asset's spatial scale (position learning rate, densify
      and prune thresholds).
    """

    xyz: Tensor
    f_dc: Tensor
    f_rest: Tensor
    log_scale: Tensor
    quat: Tensor
    opacity_logit: Tensor
    alive: Tensor
    active_sh_degree: int
    max_sh_degree: int = 3
    extent: float = 200.0

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def num_alive(self) -> Tensor:
        return self.alive.sum(dtype=torch.int64)

    @property
    def scales(self) -> Tensor:
        # Clamped exp keeps the inverse scales finite.
        return torch.exp(self.log_scale.clamp(-13.8, 13.8))

    @property
    def opacity(self) -> Tensor:
        return torch.sigmoid(self.opacity_logit)

    @property
    def rotation(self) -> Tensor:
        return quat_lib.normalize(self.quat)

    @property
    def sh(self) -> Tensor:
        """(..., 16, 3): DC + rest along the coefficient axis."""
        return torch.cat([self.f_dc, self.f_rest], dim=-2)

    def one_up_sh_degree(self) -> "GaussianAsset":
        """Grow the active SH degree by one, capped at max_sh_degree."""
        return dataclasses.replace(
            self, active_sh_degree=min(self.active_sh_degree + 1,
                                       self.max_sh_degree))

    def params(self) -> dict[str, Tensor]:
        """The learnable tensors keyed by the reference's optimizer group
        names: the unit of per-group learning rates and moment surgery."""
        return {group: getattr(self, f) for group, f in PARAM_FIELDS.items()}

    def with_params(self, p: dict[str, Tensor]) -> "GaussianAsset":
        return dataclasses.replace(
            self, **{f: p[group] for group, f in PARAM_FIELDS.items()})


def dead_asset(capacity: int, max_sh_degree: int = 3, extent: float = 200.0,
               device: str | torch.device = "cuda") -> GaussianAsset:
    """An all-padding asset with neutral parameter values on `device`."""
    quat = torch.zeros((capacity, 4), device=device)
    quat[:, 0] = 1.0
    return GaussianAsset(
        xyz=torch.zeros((capacity, 3), device=device),
        f_dc=torch.zeros((capacity, 1, 3), device=device),
        f_rest=torch.zeros((capacity, 15, 3), device=device),
        log_scale=torch.full((capacity, 2), DEAD_LOG_SCALE, device=device),
        quat=quat,
        opacity_logit=torch.full((capacity,), DEAD_OPACITY_LOGIT,
                                 device=device),
        alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
        active_sh_degree=0, max_sh_degree=max_sh_degree, extent=extent)


def from_points(points: Tensor, color: Tensor, generator: torch.Generator,
                capacity: int, normals: Tensor | None = None,
                max_sh_degree: int = 3, extent: float = 200.0,
                init_opacity: float = 0.1) -> GaussianAsset:
    """An asset seeded from a point cloud (N, 3) with colors (N, 3), on
    the points' device; the slots past N are dead.

      * DC SH = rgb_to_sh(color), the rest 0;
      * both log-scales = log sqrt(mean squared distance to the 3 Morton
        nearest neighbours, clamped at 1e-7);
      * rotations: aligned to the normals with a random in-plane spin, or
        uniform in [0, 1)^4 without normals, drawn from `generator`;
      * opacity = inverse_sigmoid(init_opacity).
    """
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"{n} points > capacity {capacity}")
    dev = points.device
    points = points.float()
    d2 = knn_lib.mean_sq_dist_to_3nn(points).clamp_min(1e-7)
    log_scale = torch.log(torch.sqrt(d2))[:, None].expand(n, 2)
    if normals is not None:
        rots = quat_lib.random_with_fixed_normal(generator, normals.float())
    else:
        rots = torch.rand((n, 4), generator=generator, device=dev)
    out = dead_asset(capacity, max_sh_degree, extent, dev)
    out.xyz[:n] = points
    out.f_dc[:n] = sh_lib.rgb_to_sh(color.float())[:, None, :]
    out.log_scale[:n] = log_scale
    out.quat[:n] = rots
    out.opacity_logit[:n] = inverse_sigmoid(
        torch.tensor(init_opacity, dtype=torch.float32, device=dev))
    out.alive[:n] = True
    return out
