"""Fixtures of the benchmark's CPU tests: the repository root on the path,
and a temporary copy of the benchmark whose configurations are cut to a
size the CPU runs in seconds (the port's plain twins stand in for its
kernels on CPU tensors)."""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_copy(dst: str) -> str:
    """BENCHMARK.json and benchmark/ copied under dst, the port linked
    beside them, every configuration cut to 16 x 256 rays, 6 frames, a
    few thousand surfels and K = 32."""
    os.makedirs(dst, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "lidar_rt_tpu_torch"),
               os.path.join(dst, "lidar_rt_tpu_torch"))
    cdir = os.path.join(dst, "benchmark", "configs")
    for name in os.listdir(cdir):
        path = os.path.join(cdir, name)
        with open(path) as f:
            c = json.load(f)
        c["raster"].update(height=16, width=256)
        c["frames"].update(count=6, eval=[3])
        c["surfels"].update(background=3000,
                            per_actor=[150] * len(c["scene"]["actors"]),
                            voxel_size=0.8,
                            assembled={"background": 3000,
                                       "per_actor": 150})
        c["tracer"].update(max_per_tile=32, coarse_factor=4)
        with open(path, "w") as f:
            json.dump(c, f)
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return tiny_copy(str(tmp_path / "checkout"))
