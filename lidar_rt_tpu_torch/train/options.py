"""The options of the data path and the trainer as a plain namespace: the
values of configs/base.yaml + configs/exp.yaml, and of the rehearsal's
configs/rehearsal/{exp,waymo,kitti}.yaml, read by attribute like the
reference's config (`args.seed`, `args.opt.position_lr_init`, ...).

The files themselves are read by `lidar_rt_tpu_torch.config` (the CLI's
path); these tables keep the values for programmatic use, and tests hold
them equal to the files.  `trace_configs` turns a `tracer` block (of
either) into the trainer's candidate-budget schedule.
"""

from __future__ import annotations

import copy
import dataclasses
from types import SimpleNamespace

import torch

from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.ops.binning import TileConfig

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


MODEL = {
    "voxel_size": 0.15,
    "bkgd_extent_factor": 3,
    "object_extent_factor": 4,
    "obj_pt_num": 10_000,
    "dimension": 2,
    "sh_degree": 3,
}

TRACER = {
    "tile_h": 8,
    "tile_w": 128,
    "max_per_tile": 256,
    "binner": "hier",
    "approx_topk": True,
    "coarse_factor": 8,
    "exact_order": False,
    "fast_math": True,
    "tail_passes": 0,
}

# configs/rehearsal/exp.yaml over configs/exp.yaml (the model, opt and
# tracer keys it sets), and each rehearsal data config's own keys with its
# base's (configs/waymo/waymo_base.yaml, configs/kitti360/kitti_base.yaml).
REHEARSAL_EXP = {
    "model": {"voxel_size": 0.35, "obj_pt_num": 4000},
    "opt": {"iterations": 4000, "position_lr_max_steps": 4000,
            "densify_from_iter": 300, "densify_until_iter": 4000,
            "opacity_reset_interval": 1000, "rebin_interval": 10},
    "tracer": {"warmup_max_per_tile": 512, "warmup_until": 2000,
               "tail_passes": 1},
}
REHEARSAL_DATA = {
    "waymo": {"data_type": "Waymo", "dataset": "waymo",
              "source_dir": "/tmp/e2e_data/waymo", "frame_length": [0, 49],
              "eval_frames": [10, 20, 30, 40], "scene_id": "we1",
              "dynamic": True},
    "kitti": {"data_type": "KITTI", "dataset": "kitti360",
              "source_dir": "/tmp/e2e_data/kitti360",
              "frame_length": [0, 39], "eval_frames": [8, 18, 28, 38],
              "scene_id": "ke1", "dynamic": True},
}


def experiment_options(seed: int = 1, **opt_overrides) -> SimpleNamespace:
    """configs/base.yaml + configs/exp.yaml's seed, `model` and `opt`
    sections, with `opt` keys overridden by keyword."""
    unknown = set(opt_overrides) - set(OPT)
    if unknown:
        raise KeyError(f"unknown opt keys {sorted(unknown)}")
    return SimpleNamespace(seed=seed, model=SimpleNamespace(**MODEL),
                           opt=SimpleNamespace(**{**OPT, **opt_overrides}))


def rehearsal_options(dataset: str) -> SimpleNamespace:
    """configs/rehearsal/exp.yaml with configs/rehearsal/<dataset>.yaml
    ("waymo" or "kitti"), their parents' values included: what the
    loaders, the assembly and the trainer read, and the `tracer` block."""
    if dataset not in REHEARSAL_DATA:
        raise KeyError(f"unknown rehearsal dataset {dataset!r}")
    ns = experiment_options(**REHEARSAL_EXP["opt"])
    ns.model = SimpleNamespace(**{**MODEL, **REHEARSAL_EXP["model"]})
    ns.tracer = SimpleNamespace(**{**TRACER, **REHEARSAL_EXP["tracer"]})
    for key, value in copy.deepcopy(REHEARSAL_DATA[dataset]).items():
        setattr(ns, key, value)
    return ns


# Keys of a `tracer` block that select TPU code paths: the port bins with
# exact top-k (as the reference does off a TPU: `jax.lax.approx_max_k`
# falls back to an exact sort there) and runs one thread per ray.
TPU_ONLY = ("approx_topk", "ray_block")
# The reference's TraceConfig defaults of its two training modes, which a
# `tracer` block without the key takes (lidar_rt_tpu/ops/tracer.py:85,93).
REFERENCE_FAST_MATH = True
REFERENCE_CACHE_FWD = True


def tracer_block(args) -> dict:
    """`args.tracer` as a dict ({} without one): a config's `Args` or a
    namespace of these tables."""
    t = getattr(args, "tracer", None)
    if t is None:
        return {}
    return t.to_dict() if hasattr(t, "to_dict") else dict(vars(t))


def trace_configs(args, device: str | torch.device = "cuda"
                  ) -> tuple[tracer_lib.TraceConfig,
                             tracer_lib.TraceConfig | None, int | None]:
    """(trace_cfg, warmup_cfg, warmup_until) from `args.tracer` for a
    trainer on `device`: the trainer's steady-state config and its larger
    warm-up budget, which differs only in max_per_tile (None without
    `warmup_max_per_tile`).  A key the block lacks takes the flagship's
    value (`FLAGSHIP_TILE`, `TraceConfig()`), as the reference's CLI does;
    `fast_math` and `cache_fwd` take the reference's defaults (True).  As
    the reference applies those two only where it runs its kernels (its
    "auto" engine resolves to the float32 jax engine off the TPU,
    lidar_rt_tpu/ops/tracer.py:110-118), they are on only for a CUDA
    device.  The `TPU_ONLY` keys are read by nothing."""
    t = tracer_block(args)
    card = torch.device(device).type == "cuda"
    ft, fd = tracer_lib.FLAGSHIP_TILE, tracer_lib.TraceConfig()
    tile = TileConfig(
        tile_h=int(t.get("tile_h", ft.tile_h)),
        tile_w=int(t.get("tile_w", ft.tile_w)),
        max_per_tile=int(t.get("max_per_tile", ft.max_per_tile)),
        binner=str(t.get("binner", ft.binner)),
        coarse_factor=int(t.get("coarse_factor", ft.coarse_factor)),
        macro_cols=int(t.get("macro_cols", ft.macro_cols)))
    cfg = tracer_lib.TraceConfig(
        tile=tile, exact_order=bool(t.get("exact_order", fd.exact_order)),
        tile_batch=int(t.get("tile_batch", fd.tile_batch)),
        tail_passes=int(t.get("tail_passes", fd.tail_passes)),
        fast_math=card and bool(t.get("fast_math", REFERENCE_FAST_MATH)),
        cache_fwd=card and bool(t.get("cache_fwd", REFERENCE_CACHE_FWD)))
    warmup_cfg = None
    if "warmup_max_per_tile" in t:
        warmup_cfg = dataclasses.replace(cfg, tile=dataclasses.replace(
            tile, max_per_tile=int(t["warmup_max_per_tile"])))
    until = t.get("warmup_until")
    return cfg, warmup_cfg, None if until is None else int(until)
