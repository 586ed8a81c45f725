"""What the drivers share: the configuration's inputs made on the device,
the port's objects built from the configuration (and held to it), the
graph timer, and the comparison numbers."""

from __future__ import annotations

import math
import sys
import time
from types import SimpleNamespace

import torch

from benchmark.reference import render as ref
from benchmark.scenes import generator, surfels

Tensor = torch.Tensor


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Clock:
    """Seconds of each set-up stage, printed to standard error."""

    def __init__(self, device):
        self.device = device
        self.t = time.perf_counter()
        self.parts = []

    def mark(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.parts.append(f"{name} {now - self.t:.3f} s")
        self.t = now

    def report(self) -> None:
        print("setup: " + ", ".join(self.parts), file=sys.stderr,
              flush=True)


class Inputs:
    """The configuration's frames and surfels from the seed, and the
    device tables that place the vehicles at a frame (no host copy at a
    step, so a CUDA graph can capture it)."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg = cfg
        self.frames = generator.make_frames(cfg, device)
        self.surf = surfels.make_surfels(cfg, self.frames, seed, device)
        self.frames = self.frames._replace(casts=[])
        boxes = self.surf.boxes
        nf = self.frames.poses.shape[0]
        self.rot = [torch.as_tensor(b.rotation(), device=device)
                    for b in boxes]
        self.centers = torch.stack([torch.stack(
            [torch.as_tensor(b.center_at(f), device=device,
                             dtype=torch.float32) for b in boxes])
            for f in range(nf)]) if boxes else None
        self.qbox = [torch.tensor([math.cos(0.5 * b.yaw), 0.0, 0.0,
                                   math.sin(0.5 * b.yaw)], device=device)
                     for b in boxes]
        self.w2s = torch.stack([ref.invert(p) for p in self.frames.poses])
        r = cfg["raster"]
        self.raster = ref.Raster(self.frames.inclinations, int(r["width"]),
                                 float(r["pixel_offset"]),
                                 float(r["angle_offset"]))

    def bundle(self, frame: int) -> list[Tensor]:
        """The activated world-frame surfels at `frame` (means, quats,
        scales, opacities, sh), vehicles moved to their boxes."""
        s = self.surf
        means, quats = [s.background.xyz], [s.background.quat]
        for a, asset in enumerate(s.actors):
            means.append((self.rot[a] * asset.xyz[:, None, :]).sum(-1)
                         + self.centers[frame, a])
            quats.append(surfels.quat_multiply(
                self.qbox[a].expand_as(asset.quat), asset.quat))
        parts = [s.background] + s.actors
        return [torch.cat(means), torch.cat(quats),
                torch.exp(torch.cat([p.log_scale for p in parts])
                          .clamp(-13.8, 13.8)),
                torch.sigmoid(torch.cat([p.opacity_logit for p in parts])),
                torch.cat([torch.cat([p.f_dc, p.f_rest], 1)
                           for p in parts])]


def port_grid(inputs: Inputs):
    from lidar_rt_tpu_torch.core import rays as rays_lib
    r = inputs.raster
    return rays_lib.SensorGrid(r.incl, r.pixel_offset, r.angle_offset)


def port_trace_config(cfg: dict, device):
    """The port's resolved TraceConfig for a trainer on `device` from the
    configuration's tracer block (`train.options.trace_configs`), and the
    tile its trainer bins with (`train.loop.cache_tile`).  On the card
    every value must be the configuration's: a mismatch raises."""
    from lidar_rt_tpu_torch.train import loop, options
    t = cfg["tracer"]
    keys = ("tile_h", "tile_w", "max_per_tile", "binner", "coarse_factor",
            "macro_cols", "tail_passes", "exact_order", "fast_math",
            "cache_fwd")
    args = SimpleNamespace(tracer=SimpleNamespace(**{k: t[k] for k in keys}))
    trace_cfg, _, _ = options.trace_configs(args, device)
    bin_tile = loop.cache_tile(trace_cfg)
    got = {"tile_h": trace_cfg.tile.tile_h, "tile_w": trace_cfg.tile.tile_w,
           "max_per_tile": trace_cfg.tile.max_per_tile,
           "binner": trace_cfg.tile.binner,
           "coarse_factor": trace_cfg.tile.coarse_factor,
           "macro_cols": trace_cfg.tile.macro_cols,
           "tail_passes": trace_cfg.tail_passes,
           "exact_order": trace_cfg.exact_order,
           "pad_px": bin_tile.pad_px, "snap_pad_px": bin_tile.snap_pad_px,
           "int_eps": bin_tile.int_eps}
    if torch.device(device).type == "cuda":
        got.update(fast_math=trace_cfg.fast_math,
                   cache_fwd=trace_cfg.use_cache)
        if trace_cfg.resolve_engine() != "cuda":
            raise ValueError("the configuration does not resolve to the "
                             "CUDA kernels")
    wrong = {k: (v, t[k]) for k, v in got.items() if v != t[k]}
    if wrong:
        raise ValueError(f"the port's resolved tracer differs from the "
                         f"configuration: {wrong}")
    return trace_cfg, bin_tile


def report_steps(stamps: list[float]) -> None:
    """The host's seconds between step returns in the window, as
    quantiles on standard error (the window's own clock)."""
    d = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    if d:
        q = [d[min(len(d) - 1, int(p * len(d)))] * 1e3
             for p in (0.1, 0.5, 0.9)]
        print(f"window: {len(d)} steps, host ms between steps p10 {q[0]:.2f}"
              f" p50 {q[1]:.2f} p90 {q[2]:.2f} max {d[-1] * 1e3:.2f}",
              file=sys.stderr, flush=True)


def graph_ms(step, steps: list[int], device) -> float:
    """ms per step of step(i) for i in `steps` captured in one CUDA graph
    and replayed (the port's `scripts/street.py` `graph_ms`): one eager
    warm-up step on a side stream, the capture, one warm replay, one timed
    replay.  A failed capture raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(steps[0])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in steps:
            step(i)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / len(steps)
    del graph
    return ms


def eager_ms(step, steps: list[int], device) -> float:
    """ms per step of the same steps from Python: CUDA events around the
    loop, no synchronisation inside."""
    sync(device)
    if torch.device(device).type != "cuda":
        t = time.perf_counter()
        for i in steps:
            step(i)
        return (time.perf_counter() - t) * 1e3 / len(steps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in steps:
        step(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(steps)


def rel(a: Tensor, b: Tensor) -> float:
    """||a - b|| / ||b|| in float64 (0 where both are 0)."""
    a, b = a.double().to(b.device), b.double()
    den = torch.linalg.vector_norm(b)
    num = torch.linalg.vector_norm(a - b)
    if float(den) == 0.0:
        return float(num)
    return float(num / den)


def channel_rel(a: Tensor, b: Tensor) -> float:
    """The worst channel's relative L2 gap of two (H, W, C) images."""
    return max(rel(a[..., c], b[..., c]) for c in range(b.shape[-1]))


def check_entry(value: float, limit: float) -> dict:
    return {"value": value, "limit": limit}
