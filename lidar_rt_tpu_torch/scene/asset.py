"""GaussianAsset: one surfel cloud (background or actor) as a frozen
dataclass of tensors (counterpart of `lidar_rt_tpu.scene.asset`).

Raw (pre-activation) parameters and their activations:

    scales   = exp(clamp(log_scale, -13.8, 13.8))
    opacity  = sigmoid(opacity_logit)
    rotation = normalize(quat)         (wxyz)
    sh       = concat(f_dc, f_rest)    per-channel SH coefficients

Arrays are padded to a fixed capacity with an `alive` mask; actors are
stacked into one asset with a leading actor axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib

Tensor = torch.Tensor


@dataclass(frozen=True)
class GaussianAsset:
    """Padded surfel cloud; leading dim = capacity C (after any actor axis).

      xyz (C, 3) local-frame positions; f_dc (C, 1, 3), f_rest (C, 15, 3)
      SH for (intensity, hit, drop); log_scale (C, 2); quat (C, 4) wxyz;
      opacity_logit (C,); alive (C,) bool; active_sh_degree the SH degree
      the renderer evaluates.
    """

    xyz: Tensor
    f_dc: Tensor
    f_rest: Tensor
    log_scale: Tensor
    quat: Tensor
    opacity_logit: Tensor
    alive: Tensor
    active_sh_degree: int

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

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
