"""The `fwdbwd` traffic: the reference bench's coupled forward-backward
render (`bench.py:117-145`, the port's `bench.step`), copied here, on the
configuration's scene, raster and tracer.

Step i: at every `rebin_every`-th step the pose advances to the next
training frame in the trajectory's order, the world surfels are
placed for that frame as fresh leaves, and the tail chain is binned
(`ops.tracer.bin_tail_chain`, the trainer's 2 px padded tile); then the
opacities plus the carried opacity gradient x 1e-30, `ops.tracer.trace`
with the chain, the loss sum|depth| x 1e-3 + sum intensity^2, and
`torch.autograd.grad` to the five surfel fields, whose opacity gradient is
the next carry.  Spans (`bench.compose`, `bench.bin`, `bench.fwd`,
`bench.bwd`) wrap the calls into the program.

`correct` holds what sampled window steps produced (channels, per-surfel
weight sums, the five gradients) and the window's last step to the plain
reference (`reference/render.py`), rendered afresh from the same world
surfels and pose.  The sampled outputs are copied, without a
synchronisation, into host buffers made in set-up, and the frames' range
images, which this traffic does not read, leave the device before its
peak is reset, so that the peak is the program's and its inputs'.
"""

from __future__ import annotations

import time

import torch

from benchmark import trace as trace_lib
from benchmark import work
from benchmark.drivers import common
from benchmark.reference import render as ref

Tensor = torch.Tensor
NUMBERS = ("chan_rel", "accum_rel", "grad_rel")


def numbers(channels, accum, grads, r: ref.Render) -> dict:
    """The compared numbers of one step against the reference's render."""
    return {"chan_rel": common.channel_rel(channels, r.channels),
            "accum_rel": common.rel(accum, r.accum),
            "grad_rel": max(common.rel(g, e) for g, e in zip(grads,
                                                             r.grads))}


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from lidar_rt_tpu_torch.ops import tracer as tracer_lib
        from lidar_rt_tpu_torch.ops.composite import SurfelBundle
        self.tracer, self.Bundle = tracer_lib, SurfelBundle
        self.cfg, self.traffic, self.device = cfg, traffic, device
        clock = common.Clock(device)
        self.inputs = common.Inputs(cfg, seed, device)
        fr = self.inputs.frames
        self.inputs.frames = fr._replace(range1=None, intensity1=None,
                                         range2=None, intensity2=None)
        del fr
        clock.mark("inputs")
        common.sync(device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        self.grid = common.port_grid(self.inputs)
        self.trace_cfg, self.bin_tile = common.port_trace_config(cfg, device)
        self.width = self.inputs.raster.width
        self.degree = int(cfg["surfels"]["sh_degree"])
        self.rebin = int(traffic["rebin_every"])
        self.background = torch.tensor(traffic["background"], device=device)
        gen = torch.Generator().manual_seed(int(seed))
        self.order = list(self.inputs.frames.train)
        within = int(traffic["check_within"])
        self.samples = sorted(torch.randperm(within, generator=gen)[
            :int(traffic["check_steps"])].tolist())
        clock.mark("program")
        self.carry = None
        self.failed = 0
        self.i = 0
        self.warm = int(traffic["warmup_steps"])
        for _ in range(self.warm):
            f, out, grads = self.step(self.i)
            self.i += 1
        pin = device.type == "cuda"
        self.buffers = [
            [torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)
             for x in (out.channels, out.accum_weights, *grads)]
            for _ in self.samples]
        common.sync(device)
        clock.mark("warm-up")
        clock.report()

    def frame_of(self, i: int) -> int:
        return self.order[(i // self.rebin) % len(self.order)]

    def step(self, i: int):
        """Step i; returns (frame, render outputs, gradients)."""
        f = self.frame_of(i)
        if i % self.rebin == 0:
            with trace_lib.span("bench.compose"):
                self.params = self.Bundle(*(
                    x.detach().requires_grad_()
                    for x in self.inputs.bundle(f)))
            if self.carry is None:
                self.carry = torch.zeros_like(self.params.opacities)
        b = self.params._replace(opacities=self.params.opacities
                                 + self.carry * 1e-30)
        s2w = self.inputs.frames.poses[f]
        if i % self.rebin == 0:
            with trace_lib.span("bench.bin"):
                self.chain = self.tracer.bin_tail_chain(
                    b, self.grid, self.width, self.inputs.w2s[f],
                    self.bin_tile, self.trace_cfg.tail_passes)
        with trace_lib.span("bench.fwd"):
            out = self.tracer.trace(
                b, self.grid, self.width, s2w, self.background, self.degree,
                self.trace_cfg, assignment=self.chain
                if self.trace_cfg.tail_passes else self.chain[0])
            loss = (out.channels[..., 3].abs().sum() * 1e-3
                    + (out.channels[..., 0] ** 2).sum())
        with trace_lib.span("bench.bwd"):
            grads = torch.autograd.grad(loss, self.params)
        self.carry = grads[3]
        return f, out, grads

    @property
    def rays(self) -> int:
        return self.inputs.raster.incl.shape[0] * self.width

    def _keep(self, f: int, out, grads, into: list[Tensor] | None):
        """A step's outputs for the check: copied into host buffers
        without a synchronisation, or else kept where they are."""
        xs = (out.channels.detach(), out.accum_weights.detach(), *grads)
        if into is not None:
            for b, x in zip(into, xs):
                b.copy_(x, non_blocking=True)
            xs = into
        self.kept.append((f, xs[0], xs[1], tuple(xs[2:])))

    def window(self, seconds: float) -> dict:
        """Steps from Python for `seconds` of the host's clock, then one
        synchronisation; keeps the sampled steps' and the last step's
        outputs for the check."""
        self.kept = []
        common.sync(self.device)
        t0 = time.perf_counter()
        n = 0
        while True:
            f, out, grads = self.step(self.i)
            self.i += 1
            if n in self.samples:
                self._keep(f, out, grads,
                           self.buffers[self.samples.index(n)])
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self._keep(f, out, grads, None)
        common.sync(self.device)
        dt = time.perf_counter() - t0
        return {"attempted": n, "window_s": dt}

    def end_to_end(self, win: dict) -> dict:
        return {"fwdbwd_mrays_per_s":
                self.rays * win["attempted"] / win["window_s"] / 1e6}

    def traced(self):
        """`trace_steps` steps under the profiler (from a re-bin), the last
        kept for the check."""
        n = int(self.traffic["trace_steps"])
        self.i = -(-self.i // self.rebin) * self.rebin
        first = self.i
        self.kept = []

        def run():
            last = None
            for _ in range(n):
                last = self.step(self.i)
                self.i += 1
            return last

        last, reading = trace_lib.profile(run)
        self._keep(*last, None)
        self.traced_steps = list(range(first, first + n))
        return {"attempted": n}, reading, {"reading": reading, "steps": n}

    def after_trace(self) -> dict:
        """The traced steps again from a CUDA graph and eagerly (the host's
        share), and the least work of the traced steps from the
        reference's depth-order hits at each traced pose."""
        steps = self.traced_steps

        def one(i):
            self.step(i)

        g = common.graph_ms(one, steps, self.device)
        e = common.eager_ms(one, steps, self.device)
        pk = work.peaks(torch.cuda.get_device_name(self.device))
        n_surf = self.inputs.bundle(0)[0].shape[0]
        least = ops = 0.0
        with torch.no_grad():
            for f in sorted({self.frame_of(i) for i in steps}):
                k = sum(1 for i in steps if self.frame_of(i) == f)
                hits = ref.depth_order_hits(
                    self.inputs.bundle(f), self.inputs.raster,
                    self.inputs.frames.poses[f],
                    ref.tiling(self.cfg["tracer"]))
                w = work.tracer(hits, self.rays, n_surf)
                least += k * work.tracer_least_seconds(w, pk)
                ops += k * work.ops_seconds(w["fwd_f32"] + w["bwd_f32"],
                                            w["fwd_tf32"] + w["bwd_tf32"],
                                            pk)
        return {"graph_ms": g, "eager_ms": e, "tracer_least_s": least,
                "ops_s": ops / len(steps), "kernel_prefix": "tracer_"}

    def release(self) -> None:
        """Free the program's state; the kept outputs stay to be judged."""
        self.params = self.chain = self.carry = None
        common.sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits: dict) -> dict:
        worst = dict.fromkeys(NUMBERS, 0.0)
        tiling = ref.tiling(self.cfg["tracer"])
        for f, channels, accum, grads in self.kept:
            r = ref.render(self.inputs.bundle(f), self.inputs.raster,
                           self.inputs.frames.poses[f], tiling, self.degree,
                           self.background, loss=ref.bench_loss)
            got = numbers(channels, accum, grads, r)
            if any(got[k] > limits[k] for k in NUMBERS):
                self.failed += 1
            for k in NUMBERS:
                worst[k] = max(worst[k], got[k])
        self.kept = []
        return {k: common.check_entry(worst[k], limits[k]) for k in NUMBERS}


def control(cfg: dict, traffic: dict, seed: int, device, steps: int = 3
            ) -> list[dict]:
    """The reference in bfloat16 put in the program's place, against the
    float32 reference, at the traffic's first `steps` poses: the
    numbers the comparison has to fail."""
    inputs = common.Inputs(cfg, seed, device)
    tiling = ref.tiling(cfg["tracer"])
    bg = torch.tensor(traffic["background"], device=device)
    degree = int(cfg["surfels"]["sh_degree"])
    out = []
    for f in inputs.frames.train[:steps]:
        args = (inputs.bundle(f), inputs.raster, inputs.frames.poses[f],
                tiling, degree, bg)
        exact = ref.render(*args, loss=ref.bench_loss)
        low = ref.render(*args, loss=ref.bench_loss, dtype=torch.bfloat16)
        out.append(numbers(low.channels, low.accum, low.grads, exact))
    return out
