"""Profiling and failure-detection hooks (counterpart of
`lidar_rt_tpu.utils.profiling`).

  * `StepTimer`: per-step wall time that waits for the device (CUDA events
    bracket the interval on a card), the recorder's batch_time source;
  * `trace`: a `torch.profiler` trace of [enter, exit), written as a
    Chrome trace, with every operator's NVTX range on a card;
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
import time
from typing import Any

import torch


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device = "cuda"):
    """Profile [enter, exit) on `device` (the card unless the caller names
    another) into `<log_dir>/trace.json` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, \
            torch.autograd.profiler.emit_nvtx(enabled=cuda):
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Seconds between consecutive `lap()` calls, each ending once the
    device's queued work is done: with CUDA events on a card (the interval
    the device took, its waits for the host included), on the host clock
    otherwise."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.cuda = torch.device(device).type == "cuda"
        self.last = self._mark()

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def lap(self) -> float:
        now = self._mark()
        if self.cuda:
            now.synchronize()
            dt = self.last.elapsed_time(now) / 1e3
        else:
            dt = now - self.last
        self.last = now
        return dt


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
