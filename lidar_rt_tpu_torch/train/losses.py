"""Training losses: masked L1/L2/BCE/DSSIM, Chamfer, box regularisation
(counterpart of `lidar_rt_tpu.train.losses`).

Boolean-mask selections are masked means, so every shape stays fixed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lidar_rt_tpu_torch.ops import chamfer as chamfer_lib
from lidar_rt_tpu_torch.ops import ssim as ssim_lib
from lidar_rt_tpu_torch.scene.asset import GaussianAsset
from lidar_rt_tpu_torch.scene.tracks import ActorTrack
from lidar_rt_tpu_torch.utils import profiling

Tensor = torch.Tensor


def masked_mean(x: Tensor, mask: Tensor) -> Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def l1(pred: Tensor, gt: Tensor, mask: Tensor | None = None) -> Tensor:
    d = (pred - gt).abs()
    return d.mean() if mask is None else masked_mean(d, mask)


def l2(pred: Tensor, gt: Tensor, mask: Tensor | None = None) -> Tensor:
    d = (pred - gt) ** 2
    return d.mean() if mask is None else masked_mean(d, mask)


def psnr(pred: Tensor, gt: Tensor, mask: Tensor | None = None) -> Tensor:
    """Peak signal-to-noise for data in [0, 1]."""
    return -10.0 * torch.log10(l2(pred, gt, mask).clamp_min(1e-12))


def bce_probs(preds: Tensor, labels: Tensor, eps: float = 1e-7) -> Tensor:
    """Binary cross-entropy on probabilities."""
    p = preds.clamp(eps, 1.0 - eps)
    labels = labels.to(p.dtype)
    return (-(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
            ).mean()


def binary_focal(preds: Tensor, labels: Tensor, alpha: float = 0.25,
                 gamma: float = 2.0, eps: float = 1e-7) -> Tensor:
    """Binary focal loss on probabilities (reference loss_utils.py:93-109)."""
    labels = labels.to(preds.dtype)
    loss_y1 = (-(1.0 - alpha) * (1.0 - preds) ** gamma
               * torch.log(preds + eps) * labels)
    loss_y0 = (-alpha * preds ** gamma * torch.log1p(-preds + eps)
               * (1.0 - labels))
    return (loss_y0 + loss_y1).mean()


def dssim(pred: Tensor, gt: Tensor) -> Tensor:
    """1 - SSIM on a single-channel (H, W) image pair."""
    return 1.0 - ssim_lib.ssim(pred[None], gt[None])


def box_reg_loss(asset: GaussianAsset, track: ActorTrack | None) -> Tensor:
    """Keep splats small relative to the asset extent and, for a boxed
    actor, inside its box (weight 100).  `asset` and `track` are one asset:
    an actor's leaves without the actor axis."""
    m = asset.alive.to(torch.float32)
    scale_loss = masked_mean(asset.scales.amax(-1) * m,
                             asset.alive) / asset.extent
    if track is None:
        return scale_loss
    over = (asset.xyz - track.max_xyz).clamp_min(0.0)
    under = (track.min_xyz - asset.xyz).clamp_min(0.0)
    alive3 = asset.alive[:, None].expand(over.shape)
    box = (masked_mean(over * m[:, None], alive3)
           + masked_mean(under * m[:, None], alive3)) / asset.extent
    return box * 100.0 + scale_loss


class LossWeights(NamedTuple):
    """The loss weights of configs/exp.yaml."""

    depth_l1: float = 0.1
    intensity_l1: float = 0.85
    intensity_l2: float = 0.0
    intensity_dssim: float = 0.15
    raydrop_bce: float = 0.01
    cd: float = 0.01
    reg: float = 0.01


class LossBreakdown(NamedTuple):
    total: Tensor
    depth: Tensor
    intensity: Tensor
    raydrop: Tensor
    cd: Tensor
    reg: Tensor


def render_losses(depth: Tensor, intensity: Tensor, raydrop_prob: Tensor,
                  gt_depth: Tensor, gt_intensity: Tensor, gt_mask: Tensor,
                  weights: LossWeights, cd_loss: Tensor | None = None,
                  reg_loss: Tensor | None = None) -> LossBreakdown:
    """The 5-term training loss on one rendered frame.  All images (H, W);
    gt_mask is the "ray returned" mask, and the ray-drop labels are its
    complement."""
    with profiling.span("loss"):
        zero = torch.zeros((), device=depth.device)
        loss_depth = weights.depth_l1 * l1(depth, gt_depth, gt_mask)
        mask_f = gt_mask.to(intensity.dtype)
        loss_intensity = (
            weights.intensity_l1 * l1(intensity, gt_intensity, gt_mask)
            + weights.intensity_l2 * l2(intensity, gt_intensity, gt_mask)
            + weights.intensity_dssim * dssim(intensity * mask_f,
                                              gt_intensity * mask_f))
        loss_raydrop = weights.raydrop_bce * bce_probs(raydrop_prob, ~gt_mask)
        loss_cd = zero if cd_loss is None else weights.cd * cd_loss
        loss_reg = zero if reg_loss is None else weights.reg * reg_loss
        total = loss_depth + loss_intensity + loss_raydrop + loss_cd + loss_reg
        return LossBreakdown(total=total, depth=loss_depth,
                             intensity=loss_intensity, raydrop=loss_raydrop,
                             cd=loss_cd, reg=loss_reg)


def chamfer_loss(pred_pts: Tensor, pred_mask: Tensor, gt_pts: Tensor,
                 gt_mask: Tensor) -> Tensor:
    """Chamfer distance between back-projected prediction and ground-truth
    point clouds."""
    return chamfer_lib.chamfer_distance(pred_pts, pred_mask, gt_pts, gt_mask)
