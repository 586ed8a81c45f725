"""Training recorder: smoothed loss windows + JSONL scalar log: a copy of
`lidar_rt_tpu.utils.record` (the port imports nothing of that package).

Equivalent of the reference's Recorder (lib/utils/record_utils.py:45-117 —
SmoothedValue windows feeding a tensorboardX writer).  TensorBoard is not
needed: scalars stream to `<log_dir>/scalars.jsonl` (one JSON
object per record step), which covers the same downstream uses: the
densification history plot (train.py:450-501) and ad-hoc analysis.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Any


class SmoothedValue:
    """Windowed median/mean tracker (record_utils.py:14-43)."""

    def __init__(self, window_size: int = 20):
        self.deque: collections.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float) -> None:
        self.deque.append(value)
        self.count += 1
        self.total += value

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class Recorder:
    def __init__(self, log_dir: str | None = None):
        self.step = 0
        self.loss_stats: dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.batch_time = SmoothedValue()
        self.data_time = SmoothedValue()
        self._t0 = time.time()
        self._fp = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fp = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def update_loss_stats(self, losses: dict[str, Any]) -> None:
        for k, v in losses.items():
            self.loss_stats[k].update(float(v))

    def record(self, prefix: str = "train",
               extra: dict[str, Any] | None = None) -> dict:
        # Loss stats merge FIRST so they can never shadow the row's own
        # step/elapsed fields (a trainer-history "elapsed" entry fed into
        # update_loss_stats used to overwrite the wall clock here — the
        # round-3 rehearsal's repeating-elapsed artifact).
        row = {**{k: v.median for k, v in self.loss_stats.items()},
               **(extra or {}),
               "step": self.step, "prefix": prefix,
               "elapsed": time.time() - self._t0}
        if self._fp:
            self._fp.write(json.dumps(row) + "\n")
            self._fp.flush()
        return row

    def state_str(self) -> str:
        return "  ".join(f"{k}: {v.median:.4f}"
                         for k, v in self.loss_stats.items())

    def close(self) -> None:
        if self._fp:
            self._fp.close()
