"""The program's own spans in a traced window: the `lrt.*` profiler
annotations that `lidar_rt_tpu_torch.utils.profiling.span` opens around
its layers (`profiling.SPANS`), read from the same Chrome trace as the
harness's `bench.*` spans (`trace.py`), on the same clock as the device.

From the trace's events, each charged to the innermost port span open on
the host at the moment that matters (spans nest on the program's thread):

  * `device_s`: device seconds of each kernel, copy and memset inside the
    window, charged through its launch's correlation id, as `trace.py`
    charges the harness's spans; the backward's launches, made from
    autograd's thread while `lrt.backward` is open, count there by time;
  * `syncs`: the synchronising CUDA runtime and driver calls (`SYNC_CALLS`)
    by their host start;
  * `idle_s`: every idle gap of the device (the window less the union of
    its operations), by the moment the gap began;
  * `host_s`: each span's host self time (its interval less its child
    port spans');
  * `root_device_s`, `root_idle_s`: the same device and idle seconds
    summed by the outermost port span above the innermost (a span's
    whole tree: `lrt.step` holds the step's layers);
  * `gaps`: the ten longest idle gaps, each named by the innermost open
    span of either kind, a port span first.

Work charged to no port span is under `OUTSIDE`.  `trace.py`'s reading is
left as it is; the readers below read a `PortReading` under the key
"port" of a reader's context.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import Counter
from typing import NamedTuple

from benchmark import trace

PREFIX = "lrt."
OUTSIDE = "outside spans"
# Calls after which the host holds until the device has caught up: the
# CUDA runtime's and driver API's synchronisations and blocking copies.
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize",
    "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
    "cuMemcpy", "cuMemcpyDtoH", "cuMemcpyDtoH_v2", "cuMemcpyHtoD",
    "cuMemcpyHtoD_v2", "cuMemcpyDtoD", "cuMemcpyDtoD_v2"})


class PortReading(NamedTuple):
    device_s: dict        # port span -> device self seconds
    syncs: dict           # port span -> synchronising calls begun in it
    idle_s: dict          # port span -> idle seconds of gaps begun in it
    host_s: dict          # port span -> host self seconds
    root_device_s: dict   # outermost port span -> its tree's device s
    root_idle_s: dict     # outermost port span -> its tree's idle s
    gaps: list            # [(span name, seconds)], longest first


class _Nest:
    """Properly nested intervals (a, b, name): the innermost one holding a
    time, each one's parent and outermost ancestor."""

    def __init__(self, spans: list[tuple[float, float, str]]):
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.parent = []
        stack = []
        for i, (a, b, _) in enumerate(self.spans):
            while stack and self.spans[stack[-1]][1] <= a:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self.root = []
        for i, p in enumerate(self.parent):
            self.root.append(i if p < 0 else self.root[p])

    def innermost(self, ts: float) -> int:
        """The index of the innermost interval holding ts, or -1."""
        i = bisect.bisect_right(self.starts, ts) - 1
        while i >= 0 and not (self.spans[i][0] <= ts <= self.spans[i][1]):
            i = self.parent[i]
        return i

    def name(self, i: int) -> str:
        return OUTSIDE if i < 0 else self.spans[i][2]

    def root_name(self, i: int) -> str:
        return OUTSIDE if i < 0 else self.spans[self.root[i]][2]

    def self_seconds(self, w0: float, w1: float) -> Counter:
        """Host self seconds by name, each interval clipped to [w0, w1]."""
        def clipped(i):
            a, b, _ = self.spans[i]
            return max(0.0, min(b, w1) - max(a, w0))

        out = Counter()
        for i, (_, _, name) in enumerate(self.spans):
            out[name] += clipped(i) * 1e-6
            if self.parent[i] >= 0:
                out[self.spans[self.parent[i]][2]] -= clipped(i) * 1e-6
        return out


def reduce_port_events(events: list[dict]) -> PortReading:
    """The port's reading of a Chrome trace's events (times in
    microseconds); empty when the trace holds no window or no device
    operation."""
    port, bench, device, launch, calls = [], [], [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        name = str(e.get("name", ""))
        if cat == "user_annotation":
            ival = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), name)
            if name.startswith(PREFIX):
                port.append(ival)
            elif name.startswith("bench."):
                bench.append(ival)
        elif cat in trace.DEVICE_CATS:
            device.append(e)
        elif cat in trace.LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])
            if name in SYNC_CALLS:
                calls.append(float(e["ts"]))
    win = [s for s in bench if s[2] == trace.WINDOW]
    if not win or not device:
        return PortReading({}, {}, {}, {}, {}, {}, [])
    w0, w1 = win[0][0], win[0][1]
    nest = _Nest(port)
    harness = _Nest([s for s in bench if s[2] != trace.WINDOW])

    device_s, root_device_s = Counter(), Counter()
    ivals = []
    for e in device:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        ivals.append((a, b))
        ts = launch.get((e.get("args") or {}).get("correlation"))
        if ts is not None:
            i = nest.innermost(ts)
            device_s[nest.name(i)] += (b - a) * 1e-6
            root_device_s[nest.root_name(i)] += (b - a) * 1e-6

    syncs = Counter()
    for ts in calls:
        if w0 <= ts <= w1:
            syncs[nest.name(nest.innermost(ts))] += 1

    ivals.sort()
    end, gaps = w0, []
    for a, b in ivals:
        if a > end:
            gaps.append((a - end, end))
        end = max(end, b)
    if w1 > end:
        gaps.append((w1 - end, end))
    idle_s, root_idle_s = Counter(), Counter()
    for g, at in gaps:
        i = nest.innermost(at)
        idle_s[nest.name(i)] += g * 1e-6
        root_idle_s[nest.root_name(i)] += g * 1e-6
    gaps.sort(reverse=True)
    named = []
    for g, at in gaps[:10]:
        i = nest.innermost(at)
        name = nest.name(i) if i >= 0 else harness.name(harness.innermost(at))
        named.append((name, g * 1e-6))
    return PortReading(dict(device_s), dict(syncs), dict(idle_s),
                       dict(nest.self_seconds(w0, w1)), dict(root_device_s),
                       dict(root_idle_s), named)


@contextlib.contextmanager
def keeping_port():
    """While open, the harness's traced window (`trace.profile`, which the
    drivers' `traced` calls) also reduces the program's spans from the
    same Chrome trace's events: the PortReading of the last window is in
    the yielded dict under "port".  `trace.reduce_events` is restored on
    exit."""
    kept = {}
    original = trace.reduce_events

    def reduce_events(events: list[dict]) -> trace.Reading:
        kept["port"] = reduce_port_events(events)
        return original(events)

    trace.reduce_events = reduce_events
    try:
        yield kept
    finally:
        trace.reduce_events = original


# -- readers: values per traced step from a context's "port" ------------


def _port(ctx: dict) -> PortReading | None:
    p = ctx.get("port")
    return None if p is None or not p.host_s else p


def port_span_ms(ctx: dict, *names: str) -> float | None:
    """Device ms per step charged to the named port spans (self time);
    None when no port span was recorded."""
    p = _port(ctx)
    if p is None:
        return None
    return sum(p.device_s.get(n, 0.0) for n in names) / ctx["steps"] * 1e3


def port_syncs(ctx: dict) -> float | None:
    """Synchronising calls per step made inside any port span."""
    p = _port(ctx)
    if p is None:
        return None
    return sum(v for k, v in p.syncs.items() if k != OUTSIDE) / ctx["steps"]


def port_idle_ms(ctx: dict, name: str) -> float | None:
    """Device idle ms per step in gaps that began inside the port span
    `name` (as the innermost open one)."""
    p = _port(ctx)
    if p is None:
        return None
    return p.idle_s.get(name, 0.0) / ctx["steps"] * 1e3
