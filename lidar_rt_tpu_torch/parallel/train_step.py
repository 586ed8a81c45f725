"""The sharded training step: frames x column bands over a ("dp", "rays")
mesh (counterpart of `lidar_rt_tpu.parallel.train_step`).

Every rank holds the whole scene, replicated, and trains one cell: the
frame of its dp row (row `dp_index` of the stacked batch) and its column
band of that frame's scan.  Each loss term is written as this rank's
contribution, so that the contributions summed over the world are the
reference's replicated loss:

  * a masked mean is the local masked sum over the world's mask count,
    all-reduced without gradient;
  * a mean of per-cell terms (DSSIM per band, the ray-drop BCE, the
    band-local Chamfer term) is the local term over the world size;
  * the replicated box regularisation is its value over the world size.

After `backward()` one world all-reduce of one flat buffer sums every
parameter's gradient and the probe's (the densify statistic), so every
rank takes the same Adam step on the same gradients; accum is summed over
the world.  Two terms differ from the single-scan step by design, as in
the reference: DSSIM windows stop at a band's edges, and the Chamfer
term compares each band's own points (cd_max_points / rays of them, at
the single-scan stride).

The rebin-interval cache (`BinCache`) holds this rank's band of every
frame: P (= tail_passes + 1) passes of T_band tiles.  A stale frame is
binned by the rank whose cell it is; the dp ranks of a band then merge
the rows of the step's frames with one all-reduce of int32 deltas.  That
needs distinct frames within a step (`ShardedTrainer._sample_ids`).
"""

from __future__ import annotations

import dataclasses

import torch

from lidar_rt_tpu_torch.core import rays as rays_lib
from lidar_rt_tpu_torch.core import transforms
from lidar_rt_tpu_torch.data.frames import LiDARFrames
from lidar_rt_tpu_torch.ops import tracer as tracer_lib
from lidar_rt_tpu_torch.parallel.sharding import Mesh, band_columns
from lidar_rt_tpu_torch.scene.scene import Scene, compose
from lidar_rt_tpu_torch.train import losses
from lidar_rt_tpu_torch.train.loop import (BinCache, FrameBatch, TrainState,
                                           actor, add_densify_stats,
                                           cache_tile, cached_assignment,
                                           loss_weights, step_metrics)

Tensor = torch.Tensor


def stack_batches(batches: list[FrameBatch]) -> FrameBatch:
    """Stack per-frame batches along a leading dp axis."""
    return FrameBatch(frame=[int(b.frame) for b in batches],
                      **{f: torch.stack([getattr(b, f) for b in batches])
                         for f in FrameBatch._fields[1:]})


def local_batch(batch: FrameBatch, mesh: Mesh) -> FrameBatch:
    """This rank's dp row of a stacked batch (the whole scan)."""
    i = mesh.dp_index
    return FrameBatch(int(batch.frame[i]), *(x[i] for x in batch[1:]))


def band_width(frames: LiDARFrames, mesh: Mesh) -> int:
    return band_columns(frames.width, mesh)[1]


def fresh_bins(frames: LiDARFrames, trace_cfg: tracer_lib.TraceConfig,
               mesh: Mesh) -> BinCache:
    """An all-stale cache of this rank's band of every frame: (F, P,
    T_band, K), T_band the tiles of a band (this rank's rows of the
    reference's band-major cache)."""
    tiles_y, tiles_x = trace_cfg.tile.num_tiles(frames.height,
                                                band_width(frames, mesh))
    return BinCache.stale(frames.num_frames, tiles_y * tiles_x,
                          trace_cfg.tile.max_per_tile,
                          trace_cfg.tail_passes + 1,
                          frames.range1.device)


def make_sharded_bin_fn(frames: LiDARFrames, args,
                        trace_cfg: tracer_lib.TraceConfig, mesh: Mesh,
                        rebin_every: int):
    """bin_fn(scene, batch, bins) -> this rank's cell's assignment (the
    chain of tail_passes + 1 with tail passes), updating `bins` in place.

    Ages live on the host and every rank sees every frame of the step, so
    the staleness decisions agree across ranks without a collective; each
    stale frame is binned by its own row's rank of this band, and its
    rows reach the band's other dp ranks as int32 deltas summed over the
    dp group (zero for every row another rank binned)."""
    if rebin_every < 1:
        raise ValueError(f"rebin_every must be >= 1, got {rebin_every}")
    grid, width = frames.grid, frames.width
    col_offset, band_w = band_columns(width, mesh)
    tail = trace_cfg.tail_passes
    bin_tile = cache_tile(trace_cfg)

    def bin_fn(scene: Scene, batch: FrameBatch, bins: BinCache):
        step_frames = [int(f) for f in batch.frame]
        if len(set(step_frames)) != len(step_frames):
            raise ValueError(f"the dp rows of a step need distinct frames "
                             f"(the cache merge adds their deltas): "
                             f"{step_frames}")
        stale = [bins.age[f] >= rebin_every for f in step_frames]
        f = step_frames[mesh.dp_index]
        if any(stale):
            delta = torch.zeros((mesh.dp, 2) + bins.index.shape[1:],
                                dtype=torch.int32, device=bins.index.device)
            if stale[mesh.dp_index]:
                with torch.no_grad():
                    bundle, _ = compose(scene, f)
                    chain = tracer_lib.bin_tail_chain(
                        bundle, grid, width,
                        transforms.invert_se3(batch.sensor2world[
                            mesh.dp_index]), bin_tile, tail, col_offset,
                        band_w)
                delta[mesh.dp_index, 0] = (
                    torch.stack([a.index for a in chain]) - bins.index[f])
                delta[mesh.dp_index, 1] = (
                    torch.stack([a.valid for a in chain]).to(torch.int32)
                    - bins.valid[f].to(torch.int32))
            mesh.all_reduce(delta, mesh.dp_group)
            for j, fj in enumerate(step_frames):
                if stale[j]:
                    bins.index[fj] += delta[j, 0]
                    bins.valid[fj] = (bins.valid[fj].to(torch.int32)
                                      + delta[j, 1]) > 0
            bins.rebins += sum(stale)
        # Every frame ages on every step: drift accrues per optimizer step.
        bins.age = [age + 1 for age in bins.age]
        for j, fj in enumerate(step_frames):
            if stale[j]:
                bins.age[fj] = 1
        return cached_assignment(bins, f, tail)

    return bin_fn


def make_sharded_loss_fn(frames: LiDARFrames, args,
                         trace_cfg: tracer_lib.TraceConfig, mesh: Mesh):
    """loss_fn(params_bg, params_ac, probe, scene, batch[, assignment]) ->
    (this rank's loss contribution, {"accum": accum summed over the
    world, "breakdown": the LossBreakdown summed over the world}).

    The contributions summed over the world are the reference's
    replicated loss, so each rank's gradients, summed over the world, are
    its gradients; breakdown.total is that loss.  params_bg/params_ac are
    `params()` dicts to differentiate (params_ac None keeps the actors
    fixed and leaves their box regularisation out, as the reference does);
    assignment is this rank's cell's cached assignment (None bins inside
    the trace)."""
    grid, width = frames.grid, frames.width
    col_offset, band_w = band_columns(width, mesh)
    cols = slice(col_offset, col_offset + band_w)
    lw = loss_weights(args)
    use_rayhit = bool(args.opt.use_rayhit)
    use_cd = float(args.opt.lambda_cd) > 0
    # The global point budget, split evenly over the bands, at the
    # single-scan stride.
    cd_budget = max(1, int(args.opt.cd_max_points) // mesh.rays)
    cd_stride = max(1, (frames.height * band_w) // cd_budget)
    n_world = mesh.size

    def loss_fn(params_bg, params_ac, probe: Tensor, scene: Scene,
                batch: FrameBatch, assignment=None):
        local = local_batch(batch, mesh)
        sc = dataclasses.replace(
            scene, background=scene.background.with_params(params_bg))
        if params_ac is not None:
            sc = dataclasses.replace(
                sc, actors=scene.actors.with_params(params_ac))
        bundle, _ = compose(sc, local.frame)
        bundle = bundle._replace(means=bundle.means + probe)
        dev = bundle.means.device
        out = tracer_lib.trace(
            bundle, grid, width, local.sensor2world,
            torch.tensor([0.0, 0.0, 1.0], device=dev),
            sc.background.active_sh_degree, trace_cfg, assignment,
            col_offset=col_offset, render_width=band_w)
        ch = out.channels
        intensity, depth = ch[..., 0], ch[..., 3]
        if use_rayhit:
            raydrop = torch.softmax(ch[..., 1:3], dim=-1)[..., 1]
        else:
            raydrop = torch.sigmoid(ch[..., 2])
        gt_depth = local.gt_depth[:, cols]
        gt_intensity = local.gt_intensity[:, cols]
        gt_mask = local.gt_mask[:, cols]

        m = gt_mask.to(depth.dtype)
        den = mesh.all_reduce(m.sum(), mesh.world).clamp_min(1.0)

        def global_masked_mean(x):
            return (x * m).sum() / den

        loss_depth = lw.depth_l1 * global_masked_mean(
            (depth - gt_depth).abs())
        loss_int = (
            lw.intensity_l1 * global_masked_mean(
                (intensity - gt_intensity).abs())
            + lw.intensity_l2 * global_masked_mean(
                (intensity - gt_intensity) ** 2)
            + lw.intensity_dssim * losses.dssim(intensity * m,
                                                gt_intensity * m) / n_world)
        loss_drop = lw.raydrop_bce * losses.bce_probs(raydrop,
                                                      ~gt_mask) / n_world
        loss_cd = torch.zeros((), device=dev)
        if use_cd:
            origin, dirs3 = rays_lib.range_rays(grid, width,
                                                local.sensor2world)
            dirs_f = dirs3[:, cols].reshape(-1, 3)[::cd_stride]
            mm = gt_mask.reshape(-1)[::cd_stride]
            pred = origin + dirs_f * depth.reshape(-1)[::cd_stride, None]
            gt = origin + dirs_f * gt_depth.reshape(-1)[::cd_stride, None]
            loss_cd = lw.cd * losses.chamfer_loss(pred, mm, gt,
                                                  mm) / n_world
        reg = losses.box_reg_loss(sc.background, None)
        if params_ac is not None:
            for i in range(sc.num_actors):
                reg = reg + losses.box_reg_loss(*actor(sc, i))
        loss_reg = lw.reg * reg / n_world
        loss = loss_depth + loss_int + loss_drop + loss_cd + loss_reg
        parts = torch.stack([loss, loss_depth, loss_int, loss_drop, loss_cd,
                             loss_reg]).detach().clone()
        breakdown = losses.LossBreakdown(
            *mesh.all_reduce(parts, mesh.world).unbind())
        accum = mesh.all_reduce(out.accum_weights.detach().clone(),
                                mesh.world)
        return loss, {"accum": accum, "breakdown": breakdown}

    return loss_fn


def reduce_gradients(tensors: list[Tensor], mesh: Mesh) -> None:
    """Sum the tensors' gradients over the world in one all-reduce of one
    flat buffer (a missing gradient counts as zero); every rank ends
    with the same gradients."""
    grads = [torch.zeros_like(t) if t.grad is None else t.grad
             for t in tensors]
    flat = torch.cat([g.reshape(-1) for g in grads])
    mesh.all_reduce(flat, mesh.world)
    for t, g in zip(tensors, flat.split([g.numel() for g in grads])):
        t.grad = g.view_as(t)


def make_sharded_train_step(frames: LiDARFrames, args,
                            trace_cfg: tracer_lib.TraceConfig, mesh: Mesh,
                            rebin_every: int):
    """train_step(state, batch) -> (state, metrics) over the mesh: batch
    is a stacked batch of mesh.dp distinct frames (`stack_batches`, or
    `loop.frame_batch` of a list), state.bins a `fresh_bins` cache.  The
    state is updated in place, alike on every rank; the metrics are the
    world's."""
    loss_fn = make_sharded_loss_fn(frames, args, trace_cfg, mesh)
    bin_fn = make_sharded_bin_fn(frames, args, trace_cfg, mesh, rebin_every)

    def train_step(state: TrainState, batch: FrameBatch
                   ) -> tuple[TrainState, dict[str, Tensor]]:
        scene = state.scene
        probe = torch.zeros((scene.total_capacity, 3),
                            device=scene.background.xyz.device,
                            requires_grad=True)
        assignment = bin_fn(scene, batch, state.bins)
        opts = [o for o in (state.opt_bg, state.opt_actors) if o is not None]
        for o in opts:
            o.zero_grad()
        params_bg = scene.background.params()
        params_ac = None if scene.actors is None else scene.actors.params()
        loss, aux = loss_fn(params_bg, params_ac, probe, scene, batch,
                            assignment)
        loss.backward()
        leaves = [*params_bg.values(),
                  *(() if params_ac is None else params_ac.values()), probe]
        reduce_gradients(leaves, mesh)
        for o in opts:
            o.step()
        add_densify_stats(state, probe.grad, aux["accum"])
        return state, step_metrics(aux["breakdown"])

    return train_step
