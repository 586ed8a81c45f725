"""The single-scan `Trainer`'s schedule driving the sharded step
(counterpart of `lidar_rt_tpu.parallel.trainer`).

Shuffled frame sampling, SH warm-up, densify/prune, opacity reset, the
two-phase candidate budget, cache invalidation and per-iteration metrics
are `train.loop.Trainer`'s; three hooks differ:

  * `_make_step` builds the sharded step (`parallel/train_step.py`),
  * `_sample_ids` draws mesh.dp distinct frames per iteration (the
    cache merge needs them distinct),
  * `_fresh_bins` shapes the cache as this rank's band.

Every rank seeds its frame shuffle and its densify generator alike and
applies density control to the same replicated scene, so the scene stays
replicated.
"""

from __future__ import annotations

from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.parallel import train_step as sharded_step
from lidar_rt_tpu_torch.parallel.sharding import Mesh
from lidar_rt_tpu_torch.scene.scene import Scene
from lidar_rt_tpu_torch.train import loop


class ShardedTrainer(loop.Trainer):
    """Trainer over a ("dp", "rays") mesh: each iteration trains
    mesh.dp distinct frames, each scan split into mesh.rays column bands
    (`parallel/train_step.py` for the loss and its two band terms).  Its
    history records each iteration's row of frames."""

    def __init__(self, scene: Scene, frames: LiDARFrames, args, mesh: Mesh,
                 **kwargs):
        self.mesh = mesh
        self.dp = mesh.dp
        pool = len(frames.train_frames or range(frames.num_frames))
        if pool < self.dp:
            raise ValueError(
                f"dp={self.dp} needs at least that many training frames "
                f"({pool} available): each iteration's rows hold distinct "
                "frames")
        super().__init__(scene, frames, args, **kwargs)

    def _make_step(self, cfg: tracer_lib.TraceConfig):
        return sharded_step.make_sharded_train_step(
            self.frames, self.args, cfg, self.mesh, self.rebin_every)

    def _fresh_bins(self, cfg: tracer_lib.TraceConfig) -> loop.BinCache:
        bins = sharded_step.fresh_bins(self.frames, cfg, self.mesh)
        if self.state.bins is not None:
            bins.rebins = self.state.bins.rebins
        return bins

    def _sample_ids(self, n: int) -> list[list[int]]:
        """n rows of dp distinct frame ids.  A repeat can only come across
        a shuffle's end; it is deferred to the next row."""
        rows = []
        for _ in range(n):
            row: list[int] = []
            deferred: list[int] = []
            while len(row) < self.dp:
                f = self._next_frame()
                (row if f not in row else deferred).append(f)
            self._frame_stack.extend(deferred)
            rows.append(row)
        return rows
