"""Profiling and failure-detection hooks (counterpart of
`lidar_rt_tpu.utils.profiling`).

  * `span`: a named profiler annotation (`lrt.<name>`, every name in
    `SPANS`) around one layer of the program, open only while a
    `torch.profiler` records, so that it sits on the trace's timeline
    beside the device work it launched; otherwise a shared no-op;
  * `trace`: a `torch.profiler` trace of [enter, exit), written as a
    Chrome trace that holds the spans and the device's kernels;
  * `peak_mib`: the process's peak allocated device memory;
  * `enable_anomaly_detection`: `torch.autograd.set_detect_anomaly`;
  * `guard_finite`: snapshots the training state with `utils.checkpoint`
    and raises when a metric is not finite (the reference's
    snapshot_fw.dump, diff_lidar_tracer/__init__.py:55-62,109-116).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Any

import torch


# Every span the program emits, with what it holds.  A span wraps one
# whole call, never the body of a per-chunk, per-tile-batch or per-actor
# loop.
SPANS = (
    "lrt.step",           # Trainer.step: the iteration and its schedule
    "lrt.bin",            # bin_tail_chain: a frame's tail chain binned
    "lrt.compose",        # compose: the scene flattened at a frame
    "lrt.render",         # trace: tile inputs, kernels, tail pass, untile
    "lrt.chamfer",        # chamfer_distance: searches, ties, pairs
    "lrt.loss",           # render_losses: L1, L2, DSSIM, BCE, the sum
    "lrt.backward",       # the training loss's backward()
    "lrt.adam",           # AssetOptimizer.zero_grad and step
    "lrt.density_stats",  # add_densify_stats: probe norms, visibility
    "lrt.densify",        # densify/prune and opacity-reset events
    "lrt.flush",          # the pending metrics moved to the host
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """The profiler annotation `lrt.<name>` while a `torch.profiler`
    records; otherwise one shared no-op context, so that a span costs a
    flag test when nothing is profiled (no annotation, no allocation, no
    device sync)."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("lrt." + name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device = "cuda"):
    """Profile [enter, exit) on `device` (the card unless the caller names
    another) into `<log_dir>/trace.json` (chrome://tracing, Perfetto): the
    host's operators and `SPANS`, and on a card the device's kernels,
    copies and memsets on the same timeline."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def peak_mib(device: str | torch.device) -> float | None:
    """The process's peak allocated memory on a CUDA device in MiB (since
    its start or the caller's last `torch.cuda.reset_peak_memory_stats`);
    None on any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2 ** 20


def enable_anomaly_detection(on: bool = True) -> None:
    """Autograd anomaly mode: a NaN produced in the backward pass raises
    with the forward operation that made it (train.py:530)."""
    torch.autograd.set_detect_anomaly(on)


def guard_finite(metrics: dict, state: Any, snapshot_path: str,
                 context: str = "") -> None:
    """Raise FloatingPointError, after writing `state` to `snapshot_path`,
    if any scalar metric is not finite.  `metrics` holds host numbers (the
    trainer's history): the check adds no device sync."""
    bad = {k: float(v) for k, v in metrics.items()
           if isinstance(v, (int, float)) and not math.isfinite(float(v))}
    if bad:
        from lidar_rt_tpu_torch.utils import checkpoint
        checkpoint.save(snapshot_path, state,
                        {"reason": f"non-finite metrics {bad}",
                         "context": context})
        raise FloatingPointError(
            f"non-finite metrics {bad} ({context}); state snapshot saved "
            f"to {snapshot_path}")
