"""Adaptive density control: clone / split / prune inside a fixed capacity
(counterpart of `lidar_rt_tpu.train.density`).

Every asset owns `capacity` slots with an alive mask.  One pass per
densification interval
  1. marks sources to clone (small, high view-space gradient) and split
     (large, high gradient; the source is removed),
  2. marks prune victims (low opacity, oversized, outside the actor box),
  3. writes the children into free slots in order (clones first, then two
     children per split), and
  4. zeroes the Adam moments of every slot written or killed.
Children that find no free slot are dropped and counted.

The asset's tensors and the moments are updated in place, so the
optimizer keeps its parameters; the new values are computed from the old
ones before any is written.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from lidar_rt_tpu_torch.core import quaternions as quat_lib
from lidar_rt_tpu_torch.scene.asset import (DEAD_LOG_SCALE,
                                            DEAD_OPACITY_LOGIT,
                                            GaussianAsset, inverse_sigmoid)
from lidar_rt_tpu_torch.scene.tracks import ActorTrack

Tensor = torch.Tensor

SPLIT_N = 2            # children per split
SPLIT_SHRINK = 0.8     # child scale = scale / (0.8 * N)
# log(0.8 * N) rounded as the reference rounds it: the float32 log of the
# float32 product.
_LOG_SHRINK = float(np.log(np.float32(SPLIT_SHRINK * SPLIT_N)))

_FIELDS = ("xyz", "f_dc", "f_rest", "log_scale", "quat", "opacity_logit",
           "alive")


class DensifyStats(NamedTuple):
    """Running view-space gradient statistics."""

    grad_accum: Tensor   # (C,) sum of ||d loss / d world-mean||
    denom: Tensor        # (C,) number of steps the splat was visible

    @staticmethod
    def zero(capacity: int, device=None) -> "DensifyStats":
        return DensifyStats(torch.zeros(capacity, device=device),
                            torch.zeros(capacity, device=device))

    def add(self, world_mean_grads: Tensor, visible: Tensor
            ) -> "DensifyStats":
        """grad_accum += ||grads|| (every slot); denom += visible."""
        return DensifyStats(
            self.grad_accum + torch.linalg.vector_norm(world_mean_grads,
                                                       dim=-1),
            self.denom + visible.to(self.denom.dtype))


class DensifyCounts(NamedTuple):
    cloned: int
    split: int
    pruned: int
    dropped: int      # children that found no free slot
    alive: int


def _zero_moments_at(moments: list[Tensor], rows: Tensor) -> None:
    """Zero rows `rows` (slot indices) of every Adam moment tensor."""
    for m in moments:
        m[rows] = 0.0


def _assign(asset: GaussianAsset, new: dict[str, Tensor]) -> None:
    """Write new leaf values into the asset's own tensors (under no_grad:
    they are the optimizer's leaf parameters)."""
    for f, value in new.items():
        getattr(asset, f).copy_(value)


@torch.no_grad()
def densify_and_prune(asset: GaussianAsset, moments: list[Tensor],
                      stats: DensifyStats, *, grad_threshold: float,
                      scale_threshold: float, opacity_threshold: float,
                      prune_size_threshold: float | None,
                      track: ActorTrack | None = None,
                      generator: torch.Generator | None = None,
                      split_normals: Tensor | None = None,
                      box_normals: Tensor | None = None
                      ) -> tuple[DensifyStats, DensifyCounts]:
    """One clone + split + prune pass over one asset, in place.

    moments: the asset's Adam moment tensors, leading dim = capacity.
    grad_threshold:        opt.densify_grad_threshold
    scale_threshold:       opt.densify_scale_threshold * extent, the
                           clone/split size boundary
    opacity_threshold:     opt.thresh_opa_prune
    prune_size_threshold:  opt.prune_size_threshold (None disables the
                           world-size and box prunes)
    Split offsets and the box-prune samples are standard normals, (C, 3)
    and (C, 2, 3), drawn from `generator` unless given.
    Returns (zeroed stats, counts)."""
    c = asset.capacity
    dev = asset.xyz.device
    alive = asset.alive
    mean_grads = torch.where(
        stats.denom > 0, stats.grad_accum / stats.denom.clamp_min(1.0), 0.0)
    high_grad = (mean_grads >= grad_threshold) & alive
    max_scale = asset.scales.amax(-1)
    clone_mask = high_grad & (max_scale <= scale_threshold)
    split_mask = high_grad & (max_scale > scale_threshold)

    # Prune set; split sources are removed as well.
    prune_mask = (asset.opacity < opacity_threshold) & alive
    if prune_size_threshold is not None:
        big_ws = max_scale > 0.1 * asset.extent * prune_size_threshold
        prune_mask |= big_ws & alive
        if track is not None:
            # Two normal samples per splat in its frame; outside if any
            # sample leaves the box.
            if box_normals is None:
                box_normals = torch.randn((c, 2, 3), generator=generator,
                                          device=dev)
            stds3 = torch.cat([asset.scales,
                               torch.zeros((c, 1), device=dev)], -1)
            samples = box_normals * stds3[:, None, :]
            rot = quat_lib.to_rotation_matrix(asset.quat)
            pts = ((rot[:, None] * samples[:, :, None, :]).sum(-1)
                   + asset.xyz[:, None, :])
            inside = ((pts >= track.min_xyz) & (pts <= track.max_xyz)
                      ).all(-1).all(-1)
            prune_mask |= ~inside & alive

    kill = prune_mask | split_mask
    alive_after = alive & ~kill

    # Child list: clones first, then SPLIT_N copies of each split source,
    # placed into free slots in index order.
    clone_src = torch.nonzero(clone_mask).flatten()
    split_src = torch.nonzero(split_mask).flatten()
    child_src = torch.cat([clone_src, split_src, split_src])
    child_is_split = torch.cat([
        torch.zeros_like(clone_src, dtype=torch.bool),
        torch.ones(SPLIT_N * split_src.numel(), dtype=torch.bool,
                   device=dev)])
    n_children = child_src.numel()
    free_slots = torch.nonzero(~alive_after).flatten()
    n_spawn = min(n_children, free_slots.numel())
    src = child_src[:n_spawn]
    dst = free_slots[:n_spawn]
    is_split = child_is_split[:n_spawn]

    # Child parameters.  The split offset's normal for child i is row i of
    # the (C, 3) draw, as in the reference.
    if split_normals is None:
        split_normals = torch.randn((c, 3), generator=generator, device=dev)
    stds3 = torch.cat([asset.scales[src],
                       torch.zeros((n_spawn, 1), device=dev)], -1)
    offsets = split_normals[:n_spawn] * stds3
    rot = quat_lib.to_rotation_matrix(asset.quat[src])
    split_offset = (rot * offsets[:, None, :]).sum(-1)
    is_split_f = is_split.to(torch.float32)[:, None]
    child_xyz = asset.xyz[src] + is_split_f * split_offset
    child_log_scale = (asset.log_scale[src]
                       - is_split_f * _LOG_SHRINK)

    new = {f: getattr(asset, f).clone() for f in _FIELDS}
    # Killed slots get neutral padding values.
    new["alive"] = alive_after.clone()
    new["opacity_logit"][kill] = DEAD_OPACITY_LOGIT
    new["log_scale"][kill] = DEAD_LOG_SCALE
    new["quat"][kill] = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    # Children.
    new["xyz"][dst] = child_xyz
    new["f_dc"][dst] = asset.f_dc[src]
    new["f_rest"][dst] = asset.f_rest[src]
    new["log_scale"][dst] = child_log_scale
    new["quat"][dst] = asset.quat[src]
    new["opacity_logit"][dst] = asset.opacity_logit[src]
    new["alive"][dst] = True
    _assign(asset, new)

    # Optimizer surgery: killed and spawned slots get fresh moments.
    _zero_moments_at(moments, torch.nonzero(kill).flatten())
    _zero_moments_at(moments, dst)

    counts = DensifyCounts(
        cloned=clone_src.numel(), split=split_src.numel(),
        pruned=int(prune_mask.sum()), dropped=n_children - n_spawn,
        alive=int(asset.alive.sum()))
    return DensifyStats.zero(c, dev), counts


@torch.no_grad()
def reset_opacity(asset: GaussianAsset, opacity_moments: list[Tensor]
                  ) -> None:
    """Clamp alive opacities to <= 0.01 and zero the opacity group's Adam
    moments, in place."""
    new_logit = torch.where(
        asset.alive, inverse_sigmoid(asset.opacity.clamp_max(0.01)),
        asset.opacity_logit)
    _assign(asset, {"opacity_logit": new_logit})
    for m in opacity_moments:
        m.zero_()
