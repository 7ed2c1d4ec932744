"""Image quality metrics; counterpart of log_tpu/utils/metric.py. `mse` and
`psnr` take numpy arrays or tensors (SSIM: ops/ssim.py)."""
from __future__ import annotations

import numpy as np
import torch


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mse(img1, img2):
    d = (_np(img1) - _np(img2)) ** 2
    return d.reshape(d.shape[0], -1).mean(axis=1, keepdims=True)


def psnr(rgbs, target_rgbs):
    m = np.mean((_np(rgbs) - _np(target_rgbs)) ** 2)
    return float(-10 * np.log10(max(m, 1e-12)))

