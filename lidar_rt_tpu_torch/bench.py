"""The port's bench: forward+backward ray throughput of the tiled tracer on
the street scene, 64 x 2650 rays and 131,072 surfels (counterpart of the
reference's root `bench.py`).

    python -m lidar_rt_tpu_torch.bench [--device cuda]

The step is the reference's (`bench.py:117-145`): the opacities plus the
carried (N,) opacity gradient x 1e-30 (numerically invisible, but it makes
each step's input the last step's output, so no step can be elided or
overlapped); the tail chain re-binned (`ops.tracer.bin_tail_chain`) at
steps 0 and 10 of 20 (REBIN_EVERY), reused between; `trace` with the chain;
the loss sum|depth| x 1e-3 + sum(intensity^2); and the gradient to all five
of the bundle's fields, whose opacity gradient is the next carry.

It is timed two ways, ITERS steps each.  graph: the steps captured in one
CUDA graph and replayed (`scripts.street.graph_ms`), the reference's
semantics of ITERS steps in one jit, device throughput with no dispatch;
a failed capture raises.  eager: the same steps from Python after WARMUP
steps, CUDA events, no synchronisation inside.  An earlier line gives
both ms a step, both Mray/s and the host's share of an eager step
(1 - graph / eager); the last line is the reference's JSON, `metric`,
`value` (the graph's Mray/s) and `unit`.  The reference's `vs_baseline`
divides by a TPU target (`BASELINE.md`) and is dropped.  On the CPU
(`--device cpu`) there is no graph: both are eager steps on the host
clock, and the JSON's metric says so.

The configuration is the reference's flagship (`bench.py:104-111`): hier
binner, exact top-k (as the reference bins off a TPU), 2 px footprint
pad, 0.5 px sample snap; the card's training mode, `TraceConfig(
fast_math=True, cache_fwd=True)` (the reference's defaults, and what
`train.options.trace_configs` gives a CUDA device).  The reference's
sweep knobs are read from the environment with its names and defaults
(`knobs`): BENCH_TILE_H, BENCH_TILE_W, BENCH_K, BENCH_TAIL, BENCH_EXACT,
BENCH_MACRO_COLS, BENCH_INT_EPS.  BENCH_RAY_BLOCK has no counterpart: a
value other than the reference's 512 raises.

`step`, `trace_config` and `loss` are the functions the stage profilers of
`lidar_rt_tpu_torch/scripts/` and the tests reuse.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import NamedTuple

import torch

from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.ops import kernels
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.ops.binning import TileAssignment, TileConfig
from lidar_rt_tpu_torch.ops.composite import SurfelBundle
from lidar_rt_tpu_torch.scripts import street

Tensor = torch.Tensor

H, W = street.H, street.W
N_SURFELS = street.N_SURFELS
WARMUP, ITERS = 2, 20
# The tile assignment is a visibility oracle re-binned every REBIN_EVERY
# renders of a frame, with the footprint padded by REBIN_PAD_PX (the
# trainer's `BinCache`).
REBIN_EVERY = 10
REBIN_PAD_PX = 2.0
SNAP_PAD_PX = 0.5
# The reference's ray_block, a Mosaic VMEM block of rays: the kernels here
# run one thread per ray, so this is the only value taken.
RAY_BLOCK = 512


class Knobs(NamedTuple):
    """The reference's sweep knobs (`bench.py:31-39`)."""

    tile_h: int
    tile_w: int
    k: int
    tail: int
    exact: bool
    macro_cols: int
    int_eps: float


def knobs(environ=None) -> Knobs:
    """The knobs from `environ` (default os.environ), with the reference's
    names and defaults.  Raises ValueError for a BENCH_RAY_BLOCK other
    than 512."""
    env = os.environ if environ is None else environ
    ray_block = int(env.get("BENCH_RAY_BLOCK", RAY_BLOCK))
    if ray_block != RAY_BLOCK:
        raise ValueError(
            f"BENCH_RAY_BLOCK={ray_block}: ray_block selects a TPU code "
            f"path (a Mosaic block of rays); the port runs one thread per "
            f"ray and takes only the reference's {RAY_BLOCK}")
    return Knobs(tile_h=int(env.get("BENCH_TILE_H", 8)),
                 tile_w=int(env.get("BENCH_TILE_W", 128)),
                 k=int(env.get("BENCH_K", 256)),
                 tail=int(env.get("BENCH_TAIL", 0)),
                 exact=bool(int(env.get("BENCH_EXACT", 0))),
                 macro_cols=int(env.get("BENCH_MACRO_COLS", 0)),
                 int_eps=float(env.get("BENCH_INT_EPS", 0.25)))


def trace_config(kn: Knobs | None = None, fast: bool = True
                 ) -> tracer_lib.TraceConfig:
    """The bench's tracer configuration at the knobs (default: from the
    environment): the card's training mode with `fast`, float32
    `TraceConfig` semantics without it (the parity target)."""
    kn = knobs() if kn is None else kn
    tile = TileConfig(tile_h=kn.tile_h, tile_w=kn.tile_w,
                      max_per_tile=kn.k, binner="hier",
                      macro_cols=kn.macro_cols, pad_px=REBIN_PAD_PX,
                      snap_pad_px=SNAP_PAD_PX, int_eps=kn.int_eps)
    return tracer_lib.TraceConfig(tile=tile, exact_order=kn.exact,
                                  tail_passes=kn.tail, fast_math=fast,
                                  cache_fwd=fast)


def loss(channels: Tensor) -> Tensor:
    """The reference's bench loss: |depth| and intensity squared."""
    return (channels[..., 3].abs().sum() * 1e-3
            + (channels[..., 0] ** 2).sum())


class Scene(NamedTuple):
    """What every step renders: the bundle's fields as leaves that take
    the gradient, the grid, the scan's width, the pose and its inverse,
    and the background."""

    params: SurfelBundle
    grid: object
    width: int
    s2w: Tensor
    w2s: Tensor
    background: Tensor


def scene(bundle: SurfelBundle, grid, width: int, s2w: Tensor) -> Scene:
    """The bench's scene on the bundle's device (background (0, 0, 1))."""
    params = SurfelBundle(*(x.detach().requires_grad_() for x in bundle))
    return Scene(params, grid, width, s2w, transforms.invert_se3(s2w),
                 torch.tensor([0.0, 0.0, 1.0], device=bundle.means.device))


class Carry(NamedTuple):
    """What a step passes to the next: the (N,) opacity gradient, the tail
    chain it binned last, and its loss."""

    grad: Tensor
    chain: list[TileAssignment] | None
    loss: Tensor | None


def start(sc: Scene) -> Carry:
    """The carry before the first step: a zero gradient, no chain."""
    return Carry(torch.zeros_like(sc.params.opacities), None, None)


def step(sc: Scene, cfg: tracer_lib.TraceConfig, carry: Carry, i: int,
         rebin_every: int = REBIN_EVERY) -> Carry:
    """Step i of the coupled loop (`bench.py:117-145`): re-bin the tail
    chain where i % rebin_every == 0 (fixed in a capture, as `lax.cond`
    fixes it in the reference's scan), trace, and take the loss's gradient
    to the bundle."""
    b = sc.params._replace(opacities=sc.params.opacities
                           + carry.grad * 1e-30)
    chain = carry.chain
    if i % rebin_every == 0:
        chain = tracer_lib.bin_tail_chain(b, sc.grid, sc.width, sc.w2s,
                                          cfg.tile, cfg.tail_passes)
    out = tracer_lib.trace(b, sc.grid, sc.width, sc.s2w, sc.background, 3,
                           cfg, assignment=chain if cfg.tail_passes
                           else chain[0])
    l_ = loss(out.channels)
    grads = torch.autograd.grad(l_, sc.params)
    return Carry(grads[3], chain, l_.detach())


def run(bundle: SurfelBundle, grid, width: int, s2w: Tensor,
        cfg: tracer_lib.TraceConfig, device, iters: int | None = None,
        warmup: int | None = None, profile: bool = False) -> dict:
    """The bench: `iters` (default ITERS) coupled steps timed from a CUDA
    graph (`street.graph_ms`) and eagerly after `warmup` (default WARMUP)
    steps, each from a zero carry.  Returns both ms a step and Mray/s, the
    host share, the launches the capture holds (captured) and those of
    the eager run (eager_launches), each run's last carry (graph_carry
    after the timed replay, eager_carry), and with `profile` the device
    operations, busy ms and top kernels a step over one rebin period
    (ops, busy_ms, top)."""
    iters = ITERS if iters is None else iters
    warmup = WARMUP if warmup is None else warmup
    bundle, grid, s2w = street.on(device, bundle, grid, s2w)
    sc = scene(bundle, grid, width, s2w)
    state = {"carry": start(sc)}

    def one(i):
        state["carry"] = step(sc, cfg, state["carry"], i)

    g = street.graph_ms(one, iters, device)
    graph_carry = state["carry"]
    state["carry"] = start(sc)
    before = kernels.launch_counts()
    e = street.eager_ms(one, iters, device, warmup)
    eager_launches = kernels.launches_since(before)
    rays = grid.height * width
    out = {"graph_ms": g.ms, "eager_ms": e, "captured": g.captured,
           "eager_launches": eager_launches,
           "mray_graph": rays / g.ms / 1e3, "mray_eager": rays / e / 1e3,
           "host_share": 1.0 - g.ms / e,
           "graph_carry": graph_carry, "eager_carry": state["carry"],
           "ops": None, "busy_ms": None, "top": None}
    if profile:
        period = min(REBIN_EVERY, iters)
        prof = street.device_profile(
            lambda: [one(i) for i in range(period)], 1, device)
        if prof is not None:
            out["busy_ms"], out["ops"] = prof[0] / period, prof[3] / period
            out["top"] = [(name, ms / period) for name, ms in prof[2]]
    return out


def describe(cfg: tracer_lib.TraceConfig, iters: int) -> str:
    """The configuration's line."""
    t = cfg.tile
    rebins = ", ".join(str(i) for i in range(0, iters, REBIN_EVERY))
    return (f"bench: tile {t.tile_h}x{t.tile_w} K={t.max_per_tile} hier "
            f"(pad {t.pad_px} px, snap {t.snap_pad_px} px, int_eps "
            f"{t.int_eps}, macro_cols {t.macro_cols}), tail passes "
            f"{cfg.tail_passes}, {'exact' if cfg.exact_order else 'tile'} "
            f"order, fast_math {cfg.fast_math}, cache_fwd {cfg.cache_fwd}; "
            f"{iters} coupled steps, re-binned at steps {rebins}")


def lines(r: dict, device) -> list[str]:
    """The earlier lines: both times and rates, the host share, what the
    capture holds, and where profiled the device's work a step."""
    ops = ("" if r["ops"] is None else
           f"; {r['ops']:.1f} device ops and {r['busy_ms']:.3f} ms of "
           f"device work a step (profiled over a rebin period)")
    return [f"graph {r['graph_ms']:.3f} ms a step ({r['mray_graph']:.2f} "
            f"Mray/s), eager {r['eager_ms']:.3f} ms a step "
            f"({r['mray_eager']:.2f} Mray/s), host share "
            f"{r['host_share']:.3f} ({street.timer_note(device)})",
            f"tracer launches the capture holds: {r['captured']}{ops}"] + (
                [] if r["top"] is None else
                ["top device kernels a step: " + street.top_line(r["top"])])


def result(r: dict, device) -> dict:
    """The reference's last line: metric, value (the graph's Mray/s),
    unit."""
    metric = "fwd+bwd ray throughput, 64x2650 scan, 131k surfels"
    if torch.device(device).type != "cuda":
        metric += " (CPU, eager steps on the host clock, no graph)"
    return {"metric": metric, "value": round(r["mray_graph"], 2),
            "unit": "Mray/s/chip"}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="python -m lidar_rt_tpu_torch.bench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    cfg = trace_config()
    bundle, grid, width, s2w = street.setup(a)
    print(describe(cfg, ITERS), flush=True)
    r = run(bundle, grid, width, s2w, cfg, a.device, profile=True)
    for line in lines(r, a.device):
        print(line, flush=True)
    print(json.dumps(result(r, a.device)), flush=True)
    return r


if __name__ == "__main__":
    main()
