"""GaussianAsset: one surfel cloud (background or actor) as a frozen
dataclass of tensors (counterpart of `lidar_rt_tpu.scene.asset`).

Raw (pre-activation) parameters and their activations:

    scales   = exp(clamp(log_scale, -13.8, 13.8))
    opacity  = sigmoid(opacity_logit)
    rotation = normalize(quat)         (wxyz)
    sh       = concat(f_dc, f_rest)    per-channel SH coefficients

Arrays are padded to a fixed capacity with an `alive` mask; actors are
stacked into one asset with a leading actor axis.  Training keeps the
capacity fixed, so the optimizer's parameters are the asset's own tensors,
updated in place (`train/optim.py`, `train/density.py`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib

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
