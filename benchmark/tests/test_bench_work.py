"""The yardstick's work counts do not move with the implementation's
tiling: the depth-order hits of one scene at 8 x 128 and at 16 x 128
tiles are the same count."""

from __future__ import annotations

import json
import os

import torch

from benchmark import work
from benchmark.drivers import common
from benchmark.reference import render as ref


def test_hits_do_not_move_with_tiles(tiny_root):
    with open(os.path.join(tiny_root, "benchmark", "configs",
                           "waymo_top64.json")) as f:
        cfg = json.load(f)
    inputs = common.Inputs(cfg, 3, torch.device("cpu"))
    f = inputs.frames.train[0]
    t8 = ref.tiling(cfg["tracer"])
    t16 = t8._replace(tile_h=16)
    args = (inputs.bundle(f), inputs.raster, inputs.frames.poses[f])
    h8 = ref.depth_order_hits(*args, t8)
    h16 = ref.depth_order_hits(*args, t16)
    assert h8 > 0 and h8 == h16
    rays = inputs.raster.incl.shape[0] * inputs.raster.width
    n = inputs.bundle(f)[0].shape[0]
    assert work.tracer(h8, rays, n) == work.tracer(h16, rays, n)


def test_roofline_is_the_larger_bound():
    pk = {"f32_flops": 1e12, "tf32_flops": 8e12, "bytes_per_s": 1e11}
    assert work.least_seconds(1e12, 0, 1e9, pk) == 1.0
    assert work.least_seconds(1e9, 0, 1e12, pk) == 10.0
    w = work.tracer(1000, 100, 10)
    assert w["bwd_tf32"] == 1000 * work.BWD_SH_FLOPS
