"""The training loop: one optimizer step and the schedule around it
(counterpart of `lidar_rt_tpu.train.loop`).

  * `train_step` renders a frame, evaluates the 5-term loss, backpropagates
    through the tiled tracer (the backward kernel on a card), applies
    per-asset Adam, and accumulates densify statistics: world-mean
    gradient norms through an explicit zero probe added to the composed
    means, and visibility from the accumulated weights;
  * `Trainer` owns the schedule: shuffled frame sampling, SH degree
    warm-up, densify/prune and opacity-reset events, per-actor densify,
    rebin-cache invalidation, the two-phase candidate budget,
    per-iteration `history`, and the non-finite guard at each log event
    (`snapshot_dir`).

The scene's capacity never changes, so the optimizers' parameters are the
scene's own tensors, updated in place by Adam and by density control.
Steps run one at a time in a Python loop; metrics stay on the device
until a log event moves them to `history`.
"""

from __future__ import annotations

import dataclasses
import os
import random
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.ops.binning import TileAssignment
from lidar_rt_tpu_torch.scene.asset import PARAM_FIELDS, GaussianAsset
from lidar_rt_tpu_torch.scene.scene import Scene, compose, split_by_asset
from lidar_rt_tpu_torch.scene.tracks import ActorTrack
from lidar_rt_tpu_torch.train import density, losses, optim
from lidar_rt_tpu_torch.utils import profiling

Tensor = torch.Tensor

STALE_AGE = (2 ** 31 - 1) // 2   # the age of a never-binned frame


class FrameBatch(NamedTuple):
    """One step's inputs (one scan)."""

    frame: int            # index into the track timeline
    sensor2world: Tensor  # (4, 4)
    gt_depth: Tensor      # (H, W)
    gt_intensity: Tensor  # (H, W)
    gt_mask: Tensor       # (H, W) bool


@dataclass
class BinCache:
    """Per-frame cached tile assignments (rebin-interval amortization).

    Binning is a stop-gradient visibility oracle.  Between densify events
    surfels drift by learning-rate-sized amounts, so a frame binned with a
    few pixels of footprint padding stays a superset of its true candidate
    sets for many steps.  `age[f]` counts optimizer steps (of any frame)
    since frame f was last binned; densify and opacity-reset events mark
    every frame stale.  Ages live on the host: the staleness decision
    costs no device sync.  `rebins` counts the frames binned.

    P (= tail_passes + 1) caches a frame's whole tail re-trace chain
    (`bin_tail_chain`): pass p lists candidates strictly past pass p-1's
    per-tile K-th candidate range, so the passes stay disjoint."""

    index: Tensor    # (F, P, T, K)
    valid: Tensor    # (F, P, T, K) bool
    age: list[int]   # (F,)
    rebins: int = 0

    @staticmethod
    def stale(num_frames: int, t_total: int, k: int, passes: int = 1,
              device=None) -> "BinCache":
        shape = (num_frames, passes, t_total, k)
        return BinCache(
            index=torch.zeros(shape, dtype=torch.int64, device=device),
            valid=torch.zeros(shape, dtype=torch.bool, device=device),
            age=[STALE_AGE] * num_frames)


@dataclass
class TrainState:
    scene: Scene
    opt_bg: optim.AssetOptimizer
    stats_bg: density.DensifyStats
    opt_actors: optim.AssetOptimizer | None = None
    stats_actors: density.DensifyStats | None = None
    generator: torch.Generator | None = None
    bins: BinCache | None = None


def _trainable(asset: GaussianAsset) -> GaussianAsset:
    """A copy of the asset whose parameters are leaf tensors that require
    grad (and whose alive mask density control may rewrite)."""
    fields = {f: getattr(asset, f).detach().clone().requires_grad_()
              for f in PARAM_FIELDS.values()}
    return dataclasses.replace(asset, alive=asset.alive.clone(), **fields)


def actor(scene: Scene, i: int) -> tuple[GaussianAsset, ActorTrack]:
    """Actor i's asset and track, as views into the stacked leaves (no
    actor axis).  Writes into the asset's views land in the scene."""
    ac, tr = scene.actors, scene.tracks
    fields = {f: getattr(ac, f)[i] for f in PARAM_FIELDS.values()}
    asset = dataclasses.replace(ac, alive=ac.alive[i], **fields)
    track = ActorTrack(tr.size[i], tr.translations[i], tr.quats[i],
                       tr.present[i])
    return asset, track


def init_train_state(scene: Scene, opt_args, seed: int = 0) -> TrainState:
    """Trainable copy of the scene, one Adam per asset (the actors share
    one over their stacked leaves), zero statistics, a generator for the
    densify draws on the scene's device."""
    scene = dataclasses.replace(
        scene, background=_trainable(scene.background),
        actors=None if scene.actors is None else _trainable(scene.actors))
    bg = scene.background
    dev = bg.xyz.device
    state = TrainState(
        scene=scene,
        opt_bg=optim.AssetOptimizer(opt_args, bg.extent, bg.params()),
        stats_bg=density.DensifyStats.zero(bg.capacity, dev),
        generator=torch.Generator(device=dev).manual_seed(seed))
    if scene.actors is not None:
        ac = scene.actors
        state.opt_actors = optim.AssetOptimizer(opt_args, ac.extent,
                                                ac.params())
        m, a = ac.xyz.shape[:2]
        state.stats_actors = density.DensifyStats.zero(m * a, dev)
    return state


def make_train_step(frames: LiDARFrames, args,
                    trace_cfg: tracer_lib.TraceConfig, rebin_every: int):
    """Build the training step: train_step(state, batch) -> (state,
    metrics), updating the state in place.

    The step renders with the frame's cached tile assignment (state.bins;
    with tail passes the whole chain) and re-bins it, with 2 px of
    footprint padding, once its age reaches `rebin_every` (>= 1) steps."""
    if rebin_every < 1:
        raise ValueError(f"rebin_every must be >= 1, got {rebin_every}")
    lw = losses.LossWeights(
        depth_l1=args.opt.lambda_depth_l1,
        intensity_l1=args.opt.lambda_intensity_l1,
        intensity_l2=args.opt.lambda_intensity_l2,
        intensity_dssim=args.opt.lambda_intensity_dssim,
        raydrop_bce=args.opt.lambda_raydrop_bce,
        cd=args.opt.lambda_cd,
        reg=args.opt.lambda_reg)
    use_rayhit = bool(args.opt.use_rayhit)
    use_cd = float(args.opt.lambda_cd) > 0
    cd_stride = max(1, (frames.height * frames.width)
                    // int(args.opt.cd_max_points))
    grid, width = frames.grid, frames.width
    # Cached assignments are binned with padded footprints; the integer-
    # sample existence cull keeps a tight margin.
    bin_tile = dataclasses.replace(trace_cfg.tile,
                                   pad_px=max(trace_cfg.tile.pad_px, 2.0),
                                   snap_pad_px=0.5)

    tail = trace_cfg.tail_passes

    def loss_fn(scene: Scene, probe: Tensor, batch: FrameBatch,
                assignment: TileAssignment | list[TileAssignment]):
        bundle, _ = compose(scene, batch.frame)
        # World-mean gradient probe for the densify statistics.
        bundle = bundle._replace(means=bundle.means + probe)
        out = tracer_lib.render_frame(
            bundle, grid, width, batch.sensor2world,
            scene.background.active_sh_degree, trace_cfg, use_rayhit,
            assignment=assignment)

        cd = None
        if use_cd:
            origin, dirs3 = rays_lib.range_rays(grid, width,
                                                batch.sensor2world)
            dirs_f = dirs3.reshape(-1, 3)[::cd_stride]
            m = batch.gt_mask.reshape(-1)[::cd_stride]
            pred = origin + dirs_f * out["depth"].reshape(-1)[::cd_stride,
                                                               None]
            gt = origin + dirs_f * batch.gt_depth.reshape(-1)[::cd_stride,
                                                              None]
            cd = losses.chamfer_loss(pred, m, gt, m)

        reg = losses.box_reg_loss(scene.background, None)
        for i in range(scene.num_actors):
            reg = reg + losses.box_reg_loss(*actor(scene, i))

        lb = losses.render_losses(out["depth"], out["intensity"],
                                  out["raydrop"], batch.gt_depth,
                                  batch.gt_intensity, batch.gt_mask, lw,
                                  cd_loss=cd, reg_loss=reg)
        return lb, out

    def assignment_from_cache(state: TrainState, batch: FrameBatch
                              ) -> TileAssignment | list[TileAssignment]:
        """The frame's cached assignment, or its chain of tail_passes + 1
        with tail passes; a stale frame bins the whole chain first."""
        f = batch.frame
        bins = state.bins
        stale = bins.age[f] >= rebin_every
        if stale:
            with torch.no_grad():
                bundle, _ = compose(state.scene, f)
                chain = tracer_lib.bin_tail_chain(
                    bundle, grid, width,
                    transforms.invert_se3(batch.sensor2world), bin_tile,
                    tail)
            for p, a in enumerate(chain):
                bins.index[f, p] = a.index
                bins.valid[f, p] = a.valid
            bins.rebins += 1
        # Every frame ages on every step: drift accrues per optimizer step.
        bins.age = [age + 1 for age in bins.age]
        if stale:
            bins.age[f] = 1
        zero = torch.zeros(bins.index.shape[2], dtype=torch.int64,
                           device=bins.index.device)
        chain = [TileAssignment(bins.index[f, p], bins.valid[f, p], zero)
                 for p in range(tail + 1)]
        return chain if tail else chain[0]

    def train_step(state: TrainState, batch: FrameBatch
                   ) -> tuple[TrainState, dict[str, Tensor]]:
        scene = state.scene
        probe = torch.zeros((scene.total_capacity, 3),
                            device=scene.background.xyz.device,
                            requires_grad=True)
        assignment = assignment_from_cache(state, batch)
        opts = [o for o in (state.opt_bg, state.opt_actors) if o is not None]
        for o in opts:
            o.zero_grad()
        lb, out = loss_fn(scene, probe, batch, assignment)
        lb.total.backward()
        for o in opts:
            o.step()

        # Densify statistics from the probe gradient and visibility.
        parts_g = split_by_asset(scene, probe.grad)
        parts_w = split_by_asset(scene, out["accum_weights"].detach())
        state.stats_bg = state.stats_bg.add(parts_g[0], parts_w[0] > 0)
        if state.stats_actors is not None:
            state.stats_actors = state.stats_actors.add(
                torch.cat(parts_g[1:]), torch.cat(parts_w[1:]) > 0)
        metrics = {"loss": lb.total, "depth": lb.depth,
                   "intensity": lb.intensity, "raydrop": lb.raydrop,
                   "cd": lb.cd, "reg": lb.reg}
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def frame_batch(frames: LiDARFrames, f: int) -> FrameBatch:
    return FrameBatch(frame=f, sensor2world=frames.pose(f),
                      gt_depth=frames.depth(f),
                      gt_intensity=frames.intensity(f),
                      gt_mask=frames.mask(f))


class Trainer:
    """The schedule around `train_step`, one step at a time.

    args: attribute options as the reference's config (`args.seed`,
    `args.opt.position_lr_init`, ...; `train.options` holds the values of
    configs/base.yaml + configs/exp.yaml).  Frames are drawn from a
    shuffled stack seeded like the reference's trainer, so both packages
    visit frames in the same order.

    warmup_cfg/warmup_until: the two-phase candidate budget.  Early
    footprints (initial scales, before pruning) overlap more surfels per
    tile than the steady-state K, and truncating them slows convergence,
    so steps 1..warmup_until render with `warmup_cfg` (a larger K), and
    every later step with `trace_cfg`.  warmup_until defaults to
    densify_until_iter; the bin cache is rebuilt at the switch."""

    def __init__(self, scene: Scene, frames: LiDARFrames, args,
                 trace_cfg: tracer_lib.TraceConfig | None = None,
                 seed: int | None = None,
                 warmup_cfg: tracer_lib.TraceConfig | None = None,
                 warmup_until: int | None = None):
        self.frames = frames
        self.args = args
        self.trace_cfg = trace_cfg or tracer_lib.TraceConfig()
        seed = int(getattr(args, "seed", 1)) if seed is None else seed
        random.seed(seed)
        np.random.seed(seed)
        self.rebin_every = int(args.opt.rebin_interval)
        self.state = init_train_state(scene, args.opt, seed)
        self._main_step = make_train_step(frames, args, self.trace_cfg,
                                          self.rebin_every)
        self.warmup_until = 0
        if warmup_cfg is not None:
            self.warmup_until = (int(args.opt.densify_until_iter)
                                 if warmup_until is None else warmup_until)
        self.step_cfg = warmup_cfg if self.warmup_until else self.trace_cfg
        self.step_fn = (make_train_step(frames, args, warmup_cfg,
                                        self.rebin_every)
                        if self.warmup_until else self._main_step)
        self.state.bins = self._fresh_bins(self.step_cfg)
        self._frame_stack: list[int] = []
        self.iteration = 0
        self.history: list[dict] = []
        # (iteration, frame, metrics on the device) awaiting a log event.
        self._pending_metrics: list[tuple[int, int, dict[str, Tensor]]] = []
        self.densify_log: list[dict] = []
        # Set to a directory to snapshot the state when a logged metric is
        # not finite (`utils.profiling.guard_finite`).
        self.snapshot_dir: str | None = None
        self._elapsed_total = 0.0

    def _next_frame(self) -> int:
        if not self._frame_stack:
            self._frame_stack = list(self.frames.train_frames
                                     or range(self.frames.num_frames))
            random.shuffle(self._frame_stack)
        return self._frame_stack.pop()

    def _fresh_bins(self, cfg: tracer_lib.TraceConfig) -> BinCache:
        """An all-stale bin cache shaped for `cfg`'s tiles and K; the
        rebin count carries over."""
        tiles_y, tiles_x = cfg.tile.num_tiles(self.frames.height,
                                              self.frames.width)
        bins = BinCache.stale(self.frames.num_frames, tiles_y * tiles_x,
                              cfg.tile.max_per_tile, cfg.tail_passes + 1,
                              self.frames.range1.device)
        if self.state.bins is not None:
            bins.rebins = self.state.bins.rebins
        return bins

    def restore(self, state: TrainState, iteration: int) -> None:
        """Continue from a saved state at `iteration` (a checkpoint holds
        no bin cache): every frame re-bins at its first step."""
        state.bins = self._fresh_bins(self.step_cfg)
        self.state, self.iteration = state, iteration

    def _invalidate_bins(self) -> None:
        """Mark every cached assignment stale (the surfel set changed)."""
        self.state.bins.age = [STALE_AGE] * len(self.state.bins.age)

    def step(self) -> dict[str, Tensor]:
        """One iteration with its schedule events; returns its metrics."""
        opt_cfg = self.args.opt
        self.iteration += 1
        it = self.iteration
        if it % int(opt_cfg.sh_increase_interval) == 0:
            self.state.scene = self.state.scene.one_up_sh_degree()
        if self.warmup_until and it > self.warmup_until:
            # The steady-state budget: new cache shape, every frame stale.
            self.step_fn, self.step_cfg = self._main_step, self.trace_cfg
            self.warmup_until = 0
            self.state.bins = self._fresh_bins(self.trace_cfg)
        f = self._next_frame()
        self.state, metrics = self.step_fn(self.state,
                                           frame_batch(self.frames, f))
        self._pending_metrics.append((it, f, metrics))
        if it < int(opt_cfg.densify_until_iter):
            if (it > int(opt_cfg.densify_from_iter)
                    and it % int(opt_cfg.densification_interval) == 0):
                self._densify(it)
            if it % int(opt_cfg.opacity_reset_interval) == 0:
                self._reset_opacity()
        return metrics

    def run(self, iterations: int | None = None,
            log_every: int = 100) -> list[dict]:
        total = iterations or int(self.args.opt.iterations)
        t0 = time.time()
        for local in range(1, total + 1):
            self.step()
            if self.iteration % log_every == 0 or local == total:
                self._flush_metrics()
                if self.snapshot_dir is not None:
                    it = self.iteration
                    profiling.guard_finite(
                        self.history[-1], self.state,
                        os.path.join(self.snapshot_dir,
                                     f"snapshot_it{it}.npz"),
                        context=f"iteration {it}")
                self.history[-1].update(
                    alive=int(self.state.scene.background.num_alive),
                    elapsed=self._elapsed_total + time.time() - t0)
        self._flush_metrics()
        self._elapsed_total += time.time() - t0
        return self.history

    def _flush_metrics(self) -> None:
        """Move pending device-side metrics into `history`, one entry per
        iteration (with the frame it trained on), with one device-to-host
        transfer."""
        if not self._pending_metrics:
            return
        keys = list(self._pending_metrics[0][2])
        host = torch.stack([torch.stack([m[k] for k in keys])
                            for _, _, m in self._pending_metrics]).tolist()
        for (it, f, _), row in zip(self._pending_metrics, host):
            self.history.append({**dict(zip(keys, row)), "iteration": it,
                                 "frame": f})
        self._pending_metrics.clear()

    def _densify_kwargs(self, asset: GaussianAsset, use_size: bool) -> dict:
        opt_cfg = self.args.opt
        return dict(
            grad_threshold=float(opt_cfg.densify_grad_threshold),
            scale_threshold=float(opt_cfg.densify_scale_threshold)
            * asset.extent,
            opacity_threshold=float(opt_cfg.thresh_opa_prune),
            prune_size_threshold=(float(opt_cfg.prune_size_threshold)
                                  if use_size else None),
            generator=self.state.generator)

    def _densify(self, it: int) -> None:
        use_size = it > int(self.args.opt.opacity_reset_interval)
        st = self.state
        bg = st.scene.background
        st.stats_bg, counts = density.densify_and_prune(
            bg, st.opt_bg.all_moments(), st.stats_bg,
            **self._densify_kwargs(bg, use_size))
        self.densify_log.append({"iteration": it, "asset": "background",
                                 **counts._asdict()})
        if st.scene.actors is not None:
            self._densify_actors(use_size)
        self._invalidate_bins()

    def _densify_actors(self, use_size: bool) -> None:
        """Per-actor densification: each actor is its own model, densified
        and pruned against its own box within its own slot range, with its
        rows of the shared Adam moments."""
        st = self.state
        m, a = st.scene.actors.xyz.shape[:2]
        grads = st.stats_actors.grad_accum.view(m, a)
        denom = st.stats_actors.denom.view(m, a)
        moments = st.opt_actors.all_moments()
        totals = None
        with torch.no_grad():
            for i in range(m):
                asset, track = actor(st.scene, i)
                _, counts = density.densify_and_prune(
                    asset, [x[i] for x in moments],
                    density.DensifyStats(grads[i], denom[i]), track=track,
                    **self._densify_kwargs(asset, use_size))
                totals = counts if totals is None else \
                    density.DensifyCounts(*(x + y for x, y in zip(totals,
                                                                 counts)))
        st.stats_actors = density.DensifyStats.zero(
            m * a, st.stats_actors.denom.device)
        self.densify_log.append({"iteration": self.iteration,
                                 "asset": "actors", **totals._asdict()})

    def _reset_opacity(self) -> None:
        st = self.state
        density.reset_opacity(st.scene.background,
                              st.opt_bg.moments("opacity"))
        if st.scene.actors is not None:
            density.reset_opacity(st.scene.actors,
                                  st.opt_actors.moments("opacity"))
        self._invalidate_bins()

    def render_eval(self, frame: int) -> dict[str, Tensor]:
        """A render of the current scene at a frame, without autograd."""
        with torch.no_grad():
            scene = self.state.scene
            bundle, _ = compose(scene, frame)
            return tracer_lib.render_frame(
                bundle, self.frames.grid, self.frames.width,
                self.frames.pose(frame), scene.background.active_sh_degree,
                self.trace_cfg, bool(self.args.opt.use_rayhit))
