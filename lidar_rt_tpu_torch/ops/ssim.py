"""Windowed SSIM on range/intensity images (counterpart of
`lidar_rt_tpu.ops.ssim`).

11x11 Gaussian window (sigma 1.5), same padding, C1 = 0.01^2, C2 = 0.03^2,
applied as two separable 1-D convolutions.  Variances are clamped at 0 and
the covariance bounded by Cauchy-Schwarz, so the map stays in [-1, 1] with
bounded gradients for any input.  On a GPU the convolutions go through
cuDNN, which takes TF32 for float32 unless
`torch.backends.cudnn.allow_tf32` is False: set it so wherever SSIM is
compared with a reference.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur(img: Tensor, win: Tensor) -> Tensor:
    """Separable same-padded Gaussian filter over the last two axes of
    (C, H, W)."""
    k = win.shape[0]
    pad = k // 2
    x = img[:, None]                                   # (C, 1, H, W)
    x = torch.nn.functional.conv2d(x, win.view(1, 1, k, 1), padding=(pad, 0))
    x = torch.nn.functional.conv2d(x, win.view(1, 1, 1, k), padding=(0, pad))
    return x[:, 0]


def ssim(img1: Tensor, img2: Tensor, window_size: int = 11,
         sigma: float = 1.5) -> Tensor:
    """Mean SSIM of two (C, H, W) images in [0, 1]."""
    win = torch.as_tensor(_gaussian_window(window_size, sigma),
                          device=img1.device)
    mu1 = _blur(img1, win)
    mu2 = _blur(img2, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = (_blur(img1 * img1, win) - mu1_sq).clamp_min(0.0)
    sigma2_sq = (_blur(img2 * img2, win) - mu2_sq).clamp_min(0.0)
    sigma12 = _blur(img1 * img2, win) - mu1_mu2
    # (+eps inside the sqrt keeps its gradient finite at zero variance)
    bound = torch.sqrt(sigma1_sq * sigma2_sq + 1e-24)
    sigma12 = torch.clamp(sigma12, -bound, bound)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()
