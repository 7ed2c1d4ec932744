"""SSIM with an 11x11 Gaussian window; counterpart of log_tpu/ops/ssim.py.

Window 11, sigma 1.5, valid padding, per channel; `ssim_loss` returns
1 - mean(ssim_map). The blur is separable and written as 11 shifted
multiply-adds per axis, as in the JAX package, so every sum runs in float32
in the same order (a cuDNN convolution would run in TF32 on the card). The
five blurred images are stacked and blurred in one pass.
"""
from __future__ import annotations

import math

import torch

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def gaussian_window(window_size: int = 11, sigma: float = 1.5) -> list[float]:
    """Normalized 1-D Gaussian weights, rounded to float32 like the JAX
    package's numpy window."""
    g = torch.tensor([
        math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma ** 2))
        for x in range(window_size)
    ], dtype=torch.float32)
    return (g / g.sum()).tolist()


def _blur(img, win: list[float]):
    """Separable valid-padding blur of (C, H, W) as shifted adds per axis."""
    k = len(win)
    H, W = img.shape[-2], img.shape[-1]
    out = win[0] * img[:, 0:H - k + 1, :]
    for i in range(1, k):
        out = out + win[i] * img[:, i:H - k + 1 + i, :]
    img = out
    out = win[0] * img[:, :, 0:W - k + 1]
    for i in range(1, k):
        out = out + win[i] * img[:, :, i:W - k + 1 + i]
    return out


def ssim_map(img1, img2, window_size: int = 11):
    """Per-window SSIM map (C, H-w+1, W-w+1). img1/img2: (C, H, W)."""
    win = gaussian_window(window_size)
    C = img1.shape[0]
    blurred = _blur(torch.cat([img1, img2, img1 * img1, img2 * img2,
                               img1 * img2]), win)
    mu1, mu2, e11, e22, e12 = torch.split(blurred, C)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    return ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)
    )


def ssim_loss(img1, img2, window_size: int = 11):
    """1 - mean SSIM. img1/img2: (C, H, W) in [0, 1]."""
    return 1.0 - torch.mean(ssim_map(img1, img2, window_size))
