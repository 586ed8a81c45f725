"""The densification statistic at the rehearsal's full size, both packages
from one state, on the CPU (slow: minutes of steps on 197k surfels).

The Waymo rehearsal segment (50 x 64 x 2650, two returns, 3 vehicles;
`lidar_rt_tpu_torch.scripts.e2e_rehearsal.gen_waymo`) is loaded by each
package with `configs/rehearsal/*`'s options and assembled by the
reference; its scene, jittered by 5 cm (range ties: the packages round
the range differently), is carried to the port by `scene.convert`.  Then
STEPS training steps on the same frame sequence at the rehearsal's
warm-up budget (K=512, tile order, one tail pass, as its steps
1-2,000): the reference's `loop.Trainer` on its jax engine (on the CPU
`approx_max_k` returns `top_k`'s set; its tail pass's cutoff taken with
its binner's range, `binner_range_cutoff`), then the port's `Trainer` on its
kernel path in float32, whose plain twins stand for the kernels on CPU
tensors.  (The port's torch engine keeps every tile's autograd
intermediates, ~30 GB at this size; the twins replay tile by tile, and
the card's three paths read this statistic alike from one state,
`scripts/densify_stats.py`.)

Held: the loss at every step within LOSS_RTOL; after the first step
(from the one state) and after all STEPS, the statistic density control
reads, grad_accum / denom over the visible background surfels
(`lidar_rt_tpu/train/density.py:44-57,134-140`): the same surfels seen
but for SEEN_RTOL of them (a ray's gate can flip at a single pixel), its
quantiles within QUANTILE_RTOL, and the count at or above
`densify_grad_threshold`, split by the clone/split size boundary, within
COUNT_RTOL (how far the card's own training paths part from one state).
`run_pair` returns every number, which the test prints, with how many
of the reference's top 0.1% of surfels the port puts higher.  The
comparison stays in float32: under `jax.enable_x64` the reference still
rounds parts of this path to float32 (its Chamfer cross term, its xyz
learning rate, its frames and rays; `test_torch_x64_islands.py`), so
float64 cannot decide it without editing the reference.

    python -m pytest tests/test_torch_densify_full.py -m slow -s
"""

from __future__ import annotations

import gc
import resource
import time

import jax
import numpy as np
import pytest
import torch

from lidar_rt_tpu import cli as j_cli
from lidar_rt_tpu.config import Args, parse
from lidar_rt_tpu.data import build as j_build
from lidar_rt_tpu.data import waymo as j_waymo
from lidar_rt_tpu.ops import tracer as j_tracer
from lidar_rt_tpu.train import loop as j_loop
from lidar_rt_tpu_torch.data import waymo as t_waymo
from lidar_rt_tpu_torch.scripts import e2e_rehearsal
from lidar_rt_tpu_torch.train import loop as t_loop
from lidar_rt_tpu_torch.train import options
from _torch_parity import binner_range_cutoff, carried

pytestmark = pytest.mark.slow

STEPS = 20
QUANTILES = (0.5, 0.9, 0.99, 0.999)
# Quantiles of the statistic within 2%, counts over the threshold within
# 4%: the card's cached, replayed and torch-engine paths part by that
# much from one state (scripts/densify_stats.py); the gap in question is
# a factor of 8.8 at the first densify event.
QUANTILE_RTOL, COUNT_RTOL = 0.02, 0.04
# 20 steps of Adam (eps 1e-15: step one moves every parameter by lr
# whatever the gradient's size) part the trajectories slowly.
LOSS_RTOL = 1e-3
SEEN_RTOL = 1e-3


def _reference_args(source_dir: str) -> Args:
    d = parse("configs/rehearsal/waymo.yaml",
              parse("configs/rehearsal/exp.yaml")).to_dict()
    d["source_dir"] = source_dir
    return Args(d)


def statistic(grad_accum, denom, alive, max_scale, opt, extent) -> dict:
    """What density control reads: grad_accum / denom over the alive
    background surfels seen at least once, its quantiles, and the count at
    or above the gradient threshold below / above the size boundary."""
    grad_accum, denom = np.asarray(grad_accum), np.asarray(denom)
    seen = np.asarray(alive) & (denom > 0)
    mean = grad_accum[seen] / denom[seen]
    over = mean >= float(opt.densify_grad_threshold)
    big = np.asarray(max_scale)[seen] > \
        float(opt.densify_scale_threshold) * extent
    return {"seen": int(seen.sum()), "alive": int(np.sum(alive)),
            "seen_mask": seen, "mean": np.where(seen, grad_accum / np.maximum(
                denom, 1.0), np.nan),
            "quantiles": [float(q) for q in
                          np.quantile(mean.astype(np.float64), QUANTILES)],
            "clone": int((over & ~big).sum()),
            "split": int((over & big).sum())}


def _peak_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def run_pair(data_dir: str, steps: int = STEPS) -> dict:
    """Both trainers `steps` steps from one state on the Waymo segment
    under `data_dir`; the losses, the statistics after the first step
    ("*_first") and after `steps`, seconds and peak RSS."""
    out = {"seconds": {}}
    t0 = time.perf_counter()
    j_args = _reference_args(data_dir)
    t_args = options.rehearsal_options("waymo")
    j_frames, j_tracks = j_waymo.load(data_dir, j_args)
    t_frames, _ = t_waymo.load(data_dir, t_args, device="cpu")
    np.testing.assert_array_equal(t_frames.range1.numpy(), j_frames.range1)
    j_scene, t_scene = carried(j_build.assemble_scene(j_frames, j_tracks,
                                                      j_args))
    out["seconds"]["load_assemble"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    real_cutoff = j_tracer._tile_range_cutoff
    j_tracer._tile_range_cutoff = binner_range_cutoff
    cfg, warm, until = j_cli._trace_cfg(j_args)
    jt = j_loop.Trainer(j_scene, j_frames, j_args, cfg, warmup_cfg=warm,
                        warmup_until=until)
    jt.CHUNK = 10 ** 9              # single steps: one compiled shape
    ref_frames, next_frame = [], jt._next_frame
    jt._next_frame = lambda: ref_frames.append(next_frame()) or \
        ref_frames[-1]
    try:
        for key, n in (("reference_first", 1), ("reference", steps - 1)):
            jt.run(iterations=n, log_every=1)
            jb = jt.state.scene.background
            out[key] = statistic(
                jt.state.stats_bg.grad_accum, jt.state.stats_bg.denom,
                jb.alive, np.max(np.asarray(jb.scales), axis=-1),
                j_args.opt, jb.extent)
    finally:
        j_tracer._tile_range_cutoff = real_cutoff
    out["seconds"]["reference"] = time.perf_counter() - t0
    out["peak_rss_gib_reference"] = _peak_rss_gib()
    out["loss"] = {"reference": [float(h["loss"]) for h in jt.history]}
    del jt, jb, j_scene, j_frames
    gc.collect()
    jax.clear_caches()

    t0 = time.perf_counter()
    cfg, warm, until = options.trace_configs(t_args, "cpu")
    tt = t_loop.Trainer(t_scene, t_frames, t_args, cfg, warmup_cfg=warm,
                        warmup_until=until)
    for key, n in (("port_first", 1), ("port", steps - 1)):
        tt.run(iterations=n, log_every=1)
        tb = tt.state.scene.background
        out[key] = statistic(
            tt.state.stats_bg.grad_accum.numpy(),
            tt.state.stats_bg.denom.numpy(), tb.alive.numpy(),
            tb.scales.max(-1).values.detach().numpy(), t_args.opt,
            tb.extent)
    out["seconds"]["port"] = time.perf_counter() - t0
    out["peak_rss_gib"] = _peak_rss_gib()

    out["K"] = [warm.tile.max_per_tile, tt.step_cfg.tile.max_per_tile]
    out["tail_passes"] = tt.step_cfg.tail_passes
    out["frames"] = {"reference": ref_frames,
                     "port": [int(h["frame"]) for h in tt.history]}
    out["loss"]["port"] = [float(h["loss"]) for h in tt.history]
    return out


def _print(out: dict) -> None:
    for key in ("seconds", "peak_rss_gib_reference", "peak_rss_gib", "K",
                "tail_passes", "frames", "loss"):
        print(key, out[key])
    for when in ("_first", ""):
        for side in ("reference", "port"):
            st = out[side + when]
            print(side + when, {k: v for k, v in st.items()
                                if k not in ("seen_mask", "mean")})
        ref = out["reference" + when]["mean"]
        port = out["port" + when]["mean"]
        both = np.isfinite(ref) & np.isfinite(port)
        top = ref[both] >= np.quantile(ref[both], 0.999)
        print(f"of the reference's top 0.1% of surfels{when} "
              f"({int(top.sum())}), the port higher at "
              f"{int((port[both][top] > ref[both][top]).sum())}")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    data = tmp_path_factory.mktemp("densify_full") / "waymo"
    e2e_rehearsal.gen_waymo(str(data), torch.device("cpu"))
    out = run_pair(str(data))
    _print(out)
    return out


def test_losses_step_by_step(pair):
    ref, port = pair["loss"]["reference"], pair["loss"]["port"]
    assert len(ref) == len(port) == STEPS
    assert pair["frames"]["port"] == pair["frames"]["reference"]
    np.testing.assert_allclose(port, ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize("when", ["first_step", "all_steps"])
def test_densify_statistic(pair, when):
    key = "_first" if when == "first_step" else ""
    ref, port = pair["reference" + key], pair["port" + key]
    differ = int(np.sum(port["seen_mask"] != ref["seen_mask"]))
    assert differ <= SEEN_RTOL * ref["seen"], differ
    np.testing.assert_allclose(port["quantiles"], ref["quantiles"],
                               rtol=QUANTILE_RTOL)
    assert ref["clone"] + ref["split"] > 0
    for kind in ("clone", "split"):
        assert abs(port[kind] - ref[kind]) <= COUNT_RTOL * ref[kind], kind
