"""The trainer's options as a plain namespace: the values of
configs/base.yaml + configs/exp.yaml, read by attribute like the
reference's config (`args.seed`, `args.opt.position_lr_init`, ...).

The reference reads those files with `lidar_rt_tpu.config`, which needs
`yaml`; the port's training path does not, so the values stand here (a
test holds them equal to the files).
"""

from __future__ import annotations

from types import SimpleNamespace

OPT = {
    "iterations": 30_000,
    "position_lr_init": 0.00016,
    "position_lr_final": 0.0000016,
    "position_lr_delay_mult": 0.01,
    "position_lr_max_steps": 30_000,
    "feature_lr": 0.0025,
    "opacity_lr": 0.05,
    "scaling_lr": 0.005,
    "rotation_lr": 0.001,
    "sh_increase_interval": 1000,
    "densification_interval": 100,
    "opacity_reset_interval": 3000,
    "densify_from_iter": 500,
    "densify_until_iter": 15_000,
    "densify_scale_threshold": 0.0002,
    "densify_grad_threshold": 0.0002,
    "densify_weight_threshold": 0.0,
    "prune_size_threshold": 0.1,
    "thresh_opa_prune": 0.003,
    "lambda_cd": 0.01,
    "lambda_depth_l1": 0.1,
    "lambda_intensity_l1": 0.85,
    "lambda_intensity_l2": 0.0,
    "lambda_intensity_dssim": 0.15,
    "lambda_raydrop_bce": 0.01,
    "lambda_reg": 0.01,
    "use_rayhit": True,
    "use_normal_init": True,
    "use_voxel_init": True,
    "cd_max_points": 16384,
    "rebin_interval": 10,
}


def experiment_options(seed: int = 1, **opt_overrides) -> SimpleNamespace:
    """configs/base.yaml + configs/exp.yaml's seed and `opt` section, with
    `opt` keys overridden by keyword."""
    unknown = set(opt_overrides) - set(OPT)
    if unknown:
        raise KeyError(f"unknown opt keys {sorted(unknown)}")
    return SimpleNamespace(seed=seed,
                           opt=SimpleNamespace(**{**OPT, **opt_overrides}))
