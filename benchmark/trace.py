"""The traced window: a torch.profiler trace of a few steps, read into what
the per-layer readers take.

The profiler traces the card through CUPTI.  The trace is exported as a
Chrome trace to a file under TMPDIR, read back and deleted.  From it:

  * device operations: kernels, copies and memsets (the device-side
    ranges of annotations cover kernels already counted and are left
    out); busy time is the union of their intervals inside the window;
  * each device operation is charged to the harness's span (a
    `record_function` around a call into the program) whose host interval
    holds the launch that queued it, found through the launch's
    correlation id: the backward's kernels, launched from autograd's
    device thread while the harness waits in `torch.autograd.grad`, count
    to the span around that call;
  * the longest idle gaps, each named by the innermost harness span that
    was open on the host when the gap began.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import tempfile
from collections import Counter
from typing import NamedTuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


class Reading(NamedTuple):
    busy_s: float
    window_s: float
    span_device_s: dict        # span name -> device seconds charged to it
    op_s: dict                 # device op name -> seconds
    gaps: list                 # [(host span name, seconds)], longest first


@contextlib.contextmanager
def span(name: str):
    """A harness span: a profiler annotation around a call into the
    program (free when no profiler runs)."""
    with torch.profiler.record_function(name):
        yield


def profile(fn):
    """Run fn() under the profiler inside the window span; returns
    (fn's result, Reading)."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with span(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        reading = read_chrome(path)
    finally:
        os.unlink(path)
    return out, reading


def read_chrome(path: str) -> Reading:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return reduce_events(events)


def reduce_events(events: list[dict]) -> Reading:
    """The reading of a Chrome trace's events (times in microseconds)."""
    spans, device, launch = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat == "user_annotation" and str(e.get("name", "")).startswith(
                "bench."):
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                          e["name"]))
        elif cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = float(e["ts"])
    win = [s for s in spans if s[2] == WINDOW]
    if not win or not device:
        return Reading(0.0, 0.0, {}, {}, [])
    w0, w1 = win[0][0], win[0][1]
    inner = sorted((s for s in spans if s[2] != WINDOW),
                   key=lambda s: (s[0], -s[1]))

    def innermost(ts: float) -> str:
        best = None
        for a, b, name in inner:
            if a > ts:
                break
            if a <= ts <= b and (best is None or a >= best[0]):
                best = (a, b, name)
        return "outside spans" if best is None else best[2]

    ivals = []
    span_s = Counter()
    op_s = Counter()
    for e in device:
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        ivals.append((a, b))
        op_s[e.get("name", "?")] += (b - a) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        ts = launch.get(corr)
        if ts is not None:
            span_s[innermost(ts)] += (b - a) * 1e-6
    ivals.sort()
    busy, end, gaps = 0.0, w0, []
    for a, b in ivals:
        if a > end:
            gaps.append((a - end, end))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    if w1 > end:
        gaps.append((w1 - end, end))
    gaps.sort(reverse=True)
    named = [(innermost(at), g * 1e-6) for g, at in gaps[:10]]
    return Reading(busy * 1e-6, (w1 - w0) * 1e-6, dict(span_s), dict(op_s),
                   named)


def breakdown(r: Reading) -> dict:
    """The result line's breakdown: the ten device operations that took
    most time and the ten longest idle gaps, named by the host's span."""
    ops = sorted(r.op_s.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in r.gaps]}
