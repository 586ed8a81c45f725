"""Eval metric suite (counterpart of `lidar_rt_tpu.eval.metrics`),
numerically parity-matched to the reference (eval.py:266-365):

  depth / intensity: RMSE, MAE, MedAE, LPIPS, SSIM, PSNR, with the
    reference's clamping (depth to [1e-6, 80], intensity to [1e-6, 1]) and
    its skimage-convention SSIM (uniform 7x7 window, data_range = observed
    gt range) — NOT the training-loss SSIM (11x11 gaussian).
  raydrop: RMSE, accuracy, F1 at threshold 0.4 (eval.py:336-352).
  points: Chamfer (sum of both directions' mean squared NN distances) +
    F-score with the reference's threshold-on-squared-distance convention
    (eval.py:266-280: `dist < 0.05` on squared distances).

Image, ray-drop and F-score arithmetic is float64 numpy, as the
reference's; the points' nearest-neighbour search runs on their device.
LPIPS requires pretrained AlexNet weights; without them `lpips_fn=None`
and the field is reported as nan (excluded from aggregate means by the
runner).
"""

from __future__ import annotations

import numpy as np
import torch

from lidar_rt_tpu_torch.ops import chamfer as chamfer_lib


def _uniform_filter(img: np.ndarray, size: int) -> np.ndarray:
    """skimage-style uniform filter via cumulative sums, reflect-padded."""
    pad = size // 2
    x = np.pad(img, pad, mode="reflect")
    # 2D moving average by separable cumsum.
    c = np.cumsum(x, axis=0)
    x = (np.concatenate([c[size - 1:size], c[size:] - c[:-size]], axis=0)
         / size)
    c = np.cumsum(x, axis=1)
    x = (np.concatenate([c[:, size - 1:size], c[:, size:] - c[:, :-size]],
                        axis=1) / size)
    return x


def ssim_skimage(a: np.ndarray, b: np.ndarray, data_range: float,
                 win_size: int = 7) -> float:
    """structural_similarity with skimage defaults (uniform window,
    K1=0.01, K2=0.03, sample covariance normalization)."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    np_ = win_size ** 2
    cov_norm = np_ / (np_ - 1)
    ux = _uniform_filter(a, win_size)
    uy = _uniform_filter(b, win_size)
    uxx = _uniform_filter(a * a, win_size)
    uyy = _uniform_filter(b * b, win_size)
    uxy = _uniform_filter(a * b, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    r = float(data_range)
    c1 = (0.01 * r) ** 2
    c2 = (0.03 * r) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / (
        (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return float(s[pad:s.shape[0] - pad, pad:s.shape[1] - pad].mean())


def _image_metrics(gt: np.ndarray, pred: np.ndarray, lo: float, hi: float,
                   lpips_fn=None) -> dict[str, float]:
    pred = np.clip(np.asarray(pred, np.float64), lo, hi)
    gt = np.clip(np.asarray(gt, np.float64), lo, hi)
    mse = float(np.mean((gt - pred) ** 2))
    out = {
        "rmse": float(np.sqrt(mse)),
        "mae": float(np.mean(np.abs(gt - pred))),
        "medae": float(np.median(np.abs(gt - pred))),
        "lpips_loss": float("nan"),
        "ssim": ssim_skimage(pred, gt,
                             data_range=float(gt.max() - gt.min()) or 1.0),
        "psnr": float(10.0 * np.log10(hi ** 2 / max(mse, 1e-20))),
    }
    if lpips_fn is not None:
        out["lpips_loss"] = float(lpips_fn(pred, gt))
    return out


def depth_metrics(gt: np.ndarray, pred: np.ndarray, max_depth: float = 80.0,
                  lpips_fn=None) -> dict[str, float]:
    """(H, W) range images; reference clamp [1e-6, 80] (eval.py:282-306)."""
    return _image_metrics(gt, pred, 1e-6, max_depth, lpips_fn)


def intensity_metrics(gt: np.ndarray, pred: np.ndarray,
                      lpips_fn=None) -> dict[str, float]:
    """(H, W) intensity images; clamp [1e-6, 1] (eval.py:308-334)."""
    return _image_metrics(gt, pred, 1e-6, 1.0, lpips_fn)


def raydrop_metrics(gt_drop: np.ndarray, pred_drop: np.ndarray,
                    threshold: float = 0.4) -> dict[str, float]:
    """gt_drop/pred_drop: 1 = dropped ray.  The runner feeds
    (1 - rayhit) for both, with pred_drop binary or probabilistic
    (eval.py:336-352, raydrop_ratio eval.py:72)."""
    gt = np.asarray(gt_drop, np.float64)
    pred = np.asarray(pred_drop, np.float64)
    rmse = float(np.sqrt(np.mean((gt - pred) ** 2)))
    pm = np.where(pred > threshold, 1.0, 0.0)
    acc = float((pm == gt).mean())
    tp = float(np.sum((gt == 1) & (pm == 1)))
    fp = float(np.sum((gt == 0) & (pm == 1)))
    fn = float(np.sum((gt == 1) & (pm == 0)))
    precision = tp / max(tp + fp, 1e-12)
    recall = tp / max(tp + fn, 1e-12)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return {"rmse": rmse, "acc": acc, "f1": f1}


def _nn_sq_dists(a: torch.Tensor, b: torch.Tensor,
                 chunk: int = 2048) -> np.ndarray:
    """Squared NN distance from each point of `a` to `b`, as float64.

    The brute-force search runs in float32 on the points' device (the
    card for the runner's clouds; host-side brute force at eval point
    counts, ~100k x ~100k, takes minutes per frame), as the reference's
    device search does, with `ops.chamfer`'s value-only search."""
    d2 = chamfer_lib.nearest_sq_dists(a.float(), b.float(), chunk=chunk)
    return d2.cpu().numpy().astype(np.float64)


def points_metrics(gt_pts: torch.Tensor, pred_pts: torch.Tensor,
                   fscore_threshold: float = 0.05) -> dict[str, float]:
    """Chamfer + F-score (eval.py:354-365, 266-280) of two (N, 3) clouds
    held as tensors on one device, where the nearest-neighbour search
    runs.  The F-score threshold is compared against SQUARED distances,
    reproducing the reference's convention exactly (not
    `ops.chamfer.fscore`, which squares its threshold)."""
    if gt_pts.shape[0] == 0 or pred_pts.shape[0] == 0:
        return {"chamfer_dist": float("nan"), "fscore": 0.0}
    d1 = _nn_sq_dists(gt_pts, pred_pts)
    d2 = _nn_sq_dists(pred_pts, gt_pts)
    chamfer = float(d1.mean() + d2.mean())
    p1 = float((d1 < fscore_threshold).mean())
    p2 = float((d2 < fscore_threshold).mean())
    f = 2 * p1 * p2 / (p1 + p2) if (p1 + p2) > 0 else 0.0
    return {"chamfer_dist": chamfer, "fscore": f}
