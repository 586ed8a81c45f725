"""Per-group Adam with the reference's learning-rate schedule (counterpart
of `lidar_rt_tpu.train.optim`).

Each asset gets one `torch.optim.Adam` (eps 1e-15) over its six parameter
groups, named as the reference names them: xyz takes an exponential
log-lerp schedule scaled by the asset's extent, f_dc the feature rate,
f_rest a twentieth of it, and opacity, scaling and rotation constants.
optax's Adam and torch's compute the same update; each group holds one
parameter whose moments (`exp_avg`, `exp_avg_sq`) have the parameter's
shape, so density control can zero them by slot (`train/density.py`).
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

ADAM_EPS = 1e-15
GROUPS = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def expon_lr_schedule(lr_init: float, lr_final: float,
                      lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
                      max_steps: int = 1_000_000):
    """Log-linear interpolation lr_init -> lr_final with an optional
    sine-eased warm-up delay; returns step -> learning rate."""

    def schedule(step: int) -> float:
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1.0 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0))
        else:
            delay_rate = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        return delay_rate * math.exp(math.log(lr_init) * (1.0 - t)
                                     + math.log(lr_final) * t)

    return schedule


class AssetOptimizer:
    """Adam over one asset's `params()` dict, one group per name (the
    counterpart of the reference's `asset_optimizer`).  opt_args holds the
    reference's learning rates (configs/base.yaml); spatial_lr_scale is
    the asset's extent; the params must be leaf tensors that require grad.

    `step()` sets the xyz group's learning rate from the schedule at the
    number of steps taken so far (optax evaluates its schedule at the
    pre-increment count) and steps every group; parameters are updated in
    place."""

    def __init__(self, opt_args, spatial_lr_scale: float,
                 params: dict[str, Tensor]):
        self.schedule = expon_lr_schedule(
            lr_init=opt_args.position_lr_init * spatial_lr_scale,
            lr_final=opt_args.position_lr_final * spatial_lr_scale,
            lr_delay_mult=opt_args.position_lr_delay_mult,
            max_steps=opt_args.position_lr_max_steps)
        lrs = {
            "xyz": self.schedule(0),
            "f_dc": opt_args.feature_lr,
            "f_rest": opt_args.feature_lr / 20.0,
            "opacity": opt_args.opacity_lr,
            "scaling": opt_args.scaling_lr,
            "rotation": opt_args.rotation_lr,
        }
        self.params = {g: params[g] for g in GROUPS}
        self.adam = torch.optim.Adam(
            [{"params": [self.params[g]], "lr": lrs[g], "name": g}
             for g in GROUPS], eps=ADAM_EPS)
        self.steps = 0

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        self.adam.param_groups[0]["lr"] = self.schedule(self.steps)
        self.adam.step()
        self.steps += 1

    def moments(self, group: str) -> list[Tensor]:
        """The Adam moments of one group, shaped like its parameter (empty
        before the first step)."""
        st = self.adam.state.get(self.params[group], {})
        return [st[k] for k in ("exp_avg", "exp_avg_sq") if k in st]

    def all_moments(self) -> list[Tensor]:
        return [m for g in GROUPS for m in self.moments(g)]

