"""The bench's street scene, the port's one copy, and what the design probes
share (the reference's `bench.py:26-82` and the probes' common set-up,
e.g. `scripts/survivor_stats.py:46-48`).

The scene is a street-like soup of 131,072 surfels (a ground annulus of
3-60 m and two corridor walls with scattered facades) drawn with numpy from
a seed in the reference's order, scanned by a 64 x 2650 LiDAR raster whose
inclinations span (-0.31, 0.04) rad, from a sensor 2 m above the origin.
`chip_smoke.py` draws its scene from `street_soup`.

The probes (`survivor_stats`, `overcount_probe`, `subtile_demand`,
`occlusion_stats`, `selection_probe`, `profile_binner`, `sweep_perf`,
`compact_probe`) share the per-tile gate (`tile_gate`, the reference's
per-script `tile_fn`), the tiled rays, their command line (`parser`,
`setup`: `--device cuda` unless `--device cpu`; the scene is always H x W
rays and N_SURFELS surfels from seed 0, as the reference's probes take it
from the bench) and the timing (`device_ms`: CUDA events on the card, the
host clock on the CPU).

The bench (`lidar_rt_tpu_torch.bench`) and its six stage profilers
(`profile_stages`, `profile_amortized`, `stage_bench`, `prep_bench`,
`intercept_probe`, `grid_overhead_probe`) time each step two ways.
`graph_ms` is the card's counterpart of the reference's in-jit scan
(`bench.py:155-171`): ITERS coupled steps captured in one CUDA graph and
replayed, so every kernel launches with no Python in between; its time is
the device's.  `eager_ms` runs the same steps back to back from Python, as
a user's loop does; in a host-bound loop its CUDA events time the host.
One minus their ratio is the host's share of an eager step.  On the CPU
there is no graph: `graph_ms` times the eager steps on the host clock, and
every line that prints it says so (`timer_note`).  `device_profile` counts
a call's device operations (kernels, copies, memsets) from a
`torch.profiler` trace.
"""

from __future__ import annotations

import argparse
import collections
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib
from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.ops import cuda_tracer, geometry, kernels
from lidar_rt_tpu_torch.ops.binning import TileConfig
from lidar_rt_tpu_torch.ops.composite import SurfelBundle

Tensor = torch.Tensor

H, W = 64, 2650
N_SURFELS = 131_072
INCLINATION_BOUNDS = (-0.31, 0.04)
SENSOR_HEIGHT = 2.0


def street_soup(n: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The street-like surfel soup (ground annulus + wall bands), drawn in
    the reference's order from one generator: activated arrays (means,
    rotations, scales, opacities, sh)."""
    rng = np.random.default_rng(seed)
    n_ground = n // 2
    n_wall = n - n_ground
    r = np.sqrt(rng.uniform(3.0 ** 2, 60.0 ** 2, n_ground))
    th = rng.uniform(-np.pi, np.pi, n_ground)
    ground = np.stack([r * np.cos(th), r * np.sin(th),
                       rng.normal(0, 0.05, n_ground)], 1)
    x = rng.uniform(-60, 60, n_wall)
    side = rng.choice([-1, 1], n_wall)
    y = side * rng.uniform(6, 25, n_wall)
    z = rng.uniform(0, 6, n_wall)
    means = np.concatenate([ground, np.stack([x, y, z], 1)]).astype(np.float32)
    # Ground surfels face up (identity), walls sideways.
    quats = np.zeros((n, 4), np.float32)
    quats[:n_ground, 0] = 1.0
    quats[n_ground:, 0] = np.sqrt(0.5)
    quats[n_ground:, 1] = np.sqrt(0.5)
    quats += rng.normal(0, 0.1, (n, 4)).astype(np.float32)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0, :] = rng.uniform(-0.5, 1.0, (n, 3))
    scales = rng.uniform(0.1, 0.35, (n, 2)).astype(np.float32)
    opacities = rng.uniform(0.3, 0.95, n).astype(np.float32)
    return {"means": means, "rotations": quats, "scales": scales,
            "opacities": opacities, "sh": sh}


def street_scene_bundle(n: int = N_SURFELS, seed: int = 0,
                        device: str | torch.device = "cuda") -> SurfelBundle:
    """The soup as a `SurfelBundle` on `device` (the card unless the
    caller names another)."""
    soup = street_soup(n, seed)
    return SurfelBundle(*(torch.as_tensor(soup[f], device=device)
                          for f in SurfelBundle._fields))


def sensor(height: int = H, device: str | torch.device = "cuda"
           ) -> tuple[rays_lib.SensorGrid, Tensor]:
    """The scan's grid and the sensor pose (2 m up), on `device`."""
    grid = rays_lib.SensorGrid.from_bounds(height, INCLINATION_BOUNDS,
                                           pixel_offset=0.5, device=device)
    s2w = torch.eye(4, device=device)
    s2w[2, 3] = SENSOR_HEIGHT
    return grid, s2w


def on(device, bundle: SurfelBundle, grid: rays_lib.SensorGrid,
       s2w: Tensor) -> tuple[SurfelBundle, rays_lib.SensorGrid, Tensor]:
    """The scene's tensors, its grid and pose on `device`."""
    return (SurfelBundle(*(x.to(device) for x in bundle)),
            rays_lib.SensorGrid(grid.row_inclinations.to(device),
                                grid.pixel_offset, grid.angle_offset),
            s2w.to(device))


def tile_rays(bundle: SurfelBundle, grid: rays_lib.SensorGrid, width: int,
              s2w: Tensor, tile: TileConfig
              ) -> tuple[geometry.SurfelFrames, Tensor]:
    """The surfels' frames for the sensor's origin and the rays as tiles,
    (T, tile_h * tile_w, 3): rows clamp-padded, columns wrapped modulo the
    width, row-major over (tiles_y, tiles_x), as the kernels take them."""
    origin, dirs = rays_lib.range_rays(grid, width, s2w)
    frames = geometry.build_frames(
        bundle.means, quat_lib.to_rotation_matrix(bundle.rotations), origin)
    return frames, cuda_tracer.to_tiles(dirs, tile)


def tile_gate(frames: geometry.SurfelFrames, bundle: SurfelBundle,
              dirs: Tensor, idx: Tensor, valid: Tensor,
              plane_check: bool = True) -> tuple[Tensor, Tensor, Tensor]:
    """Every (ray, candidate) pair of B tiles: rays dirs (B, R, 3),
    candidates idx / valid (B, K).  Returns (ok, alpha_raw, t), each (B,
    R, K): ok is the kernel's alpha gate (t >= DEPTH_MIN, |n.d| >
    DENOM_EPS, a plane through no origin unless plane_check is off, alpha
    >= ALPHA_MIN, a valid candidate); alpha_raw is clamped at ALPHA_MAX."""
    qd = geometry.ray_dot(dirs, frames.n[idx])
    b_u = geometry.ray_dot(dirs, frames.w1[idx])
    b_v = geometry.ray_dot(dirs, frames.w2[idx])
    safe_qd = torch.where(qd.abs() > geometry.DENOM_EPS, qd,
                          geometry.DENOM_EPS)
    p = frames.p[idx][:, None, :]
    t = p / safe_qd
    scales = bundle.scales[idx]
    u = (frames.a_u[idx][:, None, :] + t * b_u) / scales[:, None, :, 0]
    v = (frames.a_v[idx][:, None, :] + t * b_v) / scales[:, None, :, 1]
    g = torch.exp(-0.5 * (u * u + v * v))
    alpha_raw = (bundle.opacities[idx][:, None, :] * g).clamp_max(
        geometry.ALPHA_MAX)
    ok = ((t >= geometry.DEPTH_MIN)
          & (qd.abs() > geometry.DENOM_EPS)
          & (alpha_raw >= geometry.ALPHA_MIN)
          & valid[:, None, :])
    if plane_check:
        ok = ok & (p != 0.0)
    return ok, alpha_raw, t


def hist_summary(h: np.ndarray) -> dict:
    """A histogram of counts (index = count) summarised as the reference's
    probes do: mean, percentiles 50/90/99/99.9 (the first count whose
    cumulative share reaches p), max, and the share over 32/64/128."""
    h = np.asarray(h, np.float64)
    tot = h.sum()
    xs = np.arange(len(h))
    cum = np.cumsum(h) / tot
    return {"mean": float((h * xs).sum() / tot),
            "pct": {p: int(np.searchsorted(cum, p / 100.0))
                    for p in (50, 90, 99, 99.9)},
            "max": int(xs[h > 0].max()) if (h > 0).any() else 0,
            "over": {b: float(h[xs > b].sum() / tot) for b in (32, 64, 128)}}


def card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "CPU"."""
    if torch.device(device).type != "cuda":
        return "CPU"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def _is_card(device) -> bool:
    return torch.device(device).type == "cuda"


def eager_ms(step, iters: int, device, warmup: int = 1) -> float:
    """Mean ms per step of step(0), ..., step(iters - 1) run back to back
    from Python after `warmup` steps (step(0), step(1), ...): CUDA events
    around the loop on a card, with no synchronisation inside it (in a
    host-bound loop the events time the host), the host clock on the
    CPU."""
    for i in range(warmup):
        step(i)
    if not _is_card(device):
        t = time.perf_counter()
        for i in range(iters):
            step(i)
        return (time.perf_counter() - t) / iters * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for i in range(iters):
        step(i)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, device) -> float:
    """Mean ms per call of fn over `iters` back-to-back calls after one
    warm-up call (`eager_ms`)."""
    return eager_ms(lambda _i: fn(), iters, device)


# graph_ms replays its capture twice: once to warm, once timed.
GRAPH_REPLAYS = 2


class GraphTime(NamedTuple):
    """`graph_ms`'s result.  ms: per step, of one timed replay (on the CPU,
    of the eager steps on the host clock).  captured: the tracer kernels'
    launches the capture holds, by `kernels.launch_counts` name; the
    wrappers count them once, at capture, and each of the GRAPH_REPLAYS
    replays launches them again (on the CPU: the steps' launches)."""

    ms: float
    captured: dict[str, int]


def graph_ms(step, iters: int, device) -> GraphTime:
    """ms per step of step(0), ..., step(iters - 1) captured in one CUDA
    graph and replayed: the card's counterpart of the reference's ITERS
    steps in one jit (`bench.py:155-171`), so no Python runs between the
    kernels.  step(0) first runs eagerly on a side stream (kernels built,
    the allocator primed), then the steps are captured, the graph replayed
    once and one replay timed with CUDA events.  The steps pass their state
    from one to the next through tensors the capture allocates, so each
    replay runs the same coupled steps from the same start.  A capture that
    fails raises: nothing falls back to eager timing.  On the CPU there is
    no graph, and the steps run eagerly on the host clock."""
    if not _is_card(device):
        before = kernels.launch_counts()
        ms = eager_ms(step, iters, device, warmup=0)
        return GraphTime(ms, kernels.launches_since(before))
    device = torch.device(device)
    with torch.cuda.device(device):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            step(0)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        with torch.cuda.graph(graph):
            for i in range(iters):
                step(i)
        captured = kernels.launches_since(before)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
    return GraphTime(start.elapsed_time(end) / iters, captured)


def timer_note(device) -> str:
    """What `graph_ms` measured on `device`, for a line that prints it."""
    if _is_card(device):
        return ("graph: one CUDA-graph replay of the steps; eager: the same "
                "steps from Python, CUDA events")
    return "CPU: no graph; both columns are eager steps on the host clock"


def device_profile(fn, iters: int, device="cuda"):
    """Device time over `iters` calls of fn from a torch.profiler trace:
    (busy ms per call, idle share of the device span from the first
    kernel's start to the last one's end, top kernels as (name, ms per
    call), device operations per call), or None when the trace holds no
    device events, and None on the CPU (no device to trace).  Only
    kernels, copies and memsets count: the device-side ranges of profiler
    annotations (such as `Optimizer.step#Adam.step`) cover kernels already
    counted.  Busy time is the union of their intervals.  The profiler
    slows the host's launches, so the idle share is an upper bound."""
    if not _is_card(device):
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and "annotation" not in str(getattr(e, "activity_type", ""))]
    if not events:
        return None
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events))
    by_name = collections.Counter()
    for e in events:
        by_name[e.name] += e.time_range.elapsed_us()
    top = [(name, us / iters / 1e3) for name, us in by_name.most_common(6)]
    return busy / iters / 1e3, 1.0 - busy / span, top, len(events) // iters


def coupled(stage, reduce, device):
    """A step of the reference's `timed_scan` (`scripts/profile_stages.py:
    45-58`): step(i) runs stage(eps), where eps is the last step's
    reduce(value) x 1e-30 (0 at the first step) and the stage adds it to
    an input (`on_opacities`), so that no step can be elided or overlapped
    while the carry stays numerically invisible.  Returns (step, state):
    state["first"] keeps the first step's value, taken with eps = 0."""
    state = {"carry": torch.zeros((), device=device), "first": None}

    def step(_i):
        value = stage(state["carry"] * 1e-30)
        if state["first"] is None:
            state["first"] = value
        state["carry"] = reduce(value) * 1e-30 + state["carry"] * 0.0

    return step, state


def on_opacities(bundle: SurfelBundle, fn):
    """The stage fn(bundle with eps added to its opacities), the
    reference's coupling through the (N,) opacities."""
    return lambda eps: fn(bundle._replace(opacities=bundle.opacities + eps))


def time_steps(step, iters: int, device, profile: bool = False) -> dict:
    """step(i) timed both ways: `graph_ms` (graph_ms, captured) and
    `eager_ms` (eager_ms), and with `profile` one eager step's device
    operations, busy ms and top kernels from `device_profile` (ops,
    busy_ms, top; None on the CPU)."""
    g = graph_ms(step, iters, device)
    row = {"graph_ms": g.ms, "captured": g.captured,
           "eager_ms": eager_ms(step, iters, device), "ops": None,
           "busy_ms": None, "top": None}
    prof = device_profile(lambda: step(0), 1, device) if profile else None
    if prof is not None:
        row["busy_ms"], row["top"], row["ops"] = prof[0], prof[2], prof[3]
    return row


def top_line(top) -> str:
    """A profile's top kernels, (name, ms per call), on one line."""
    return ", ".join(f"{name[:60]} {ms:.3f} ms" for name, ms in top)


def time_stage(stage, reduce, iters: int, device,
               profile: bool = False) -> dict:
    """`time_steps` of the coupled steps of `stage` (`coupled`), with the
    stage's first value, taken with eps = 0 (value)."""
    step, state = coupled(stage, reduce, device)
    row = time_steps(step, iters, device, profile)
    row["value"] = state["first"]
    return row


def stage_line(label: str, row: dict, width: int = 28) -> str:
    """A stage's line: graph ms, eager ms beside it, and its device
    operations per step where profiled."""
    ops = "" if row["ops"] is None else f"   {row['ops']} device ops"
    return (f"{label:{width}s} {row['graph_ms']:8.3f} ms   eager "
            f"{row['eager_ms']:8.3f} ms{ops}")


def parser(prog: str, doc: str) -> argparse.ArgumentParser:
    """A probe's command line: the device."""
    p = argparse.ArgumentParser(prog=f"python -m lidar_rt_tpu_torch.scripts."
                                f"{prog}", description=doc.split("\n")[0])
    p.add_argument("--device", default="cuda")
    return p


def setup(a: argparse.Namespace
          ) -> tuple[SurfelBundle, rays_lib.SensorGrid, int, Tensor]:
    """Print the card and the scene's size; return (bundle, grid, width,
    pose) of the street scene (N_SURFELS surfels, H x W rays, seed 0) on
    the device `a` names."""
    dev = torch.device(a.device)
    print(f"{card(dev)}; street scene {N_SURFELS} surfels, {H} x {W} rays, "
          f"seed 0, on {dev}", flush=True)
    grid, s2w = sensor(H, dev)
    return street_scene_bundle(N_SURFELS, 0, dev), grid, W, s2w
