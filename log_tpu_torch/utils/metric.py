"""Image quality metrics; counterpart of log_tpu/utils/metric.py. `mse`,
`psnr` and `ssim_np` take numpy arrays or tensors."""
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



def ssim_np(img1, img2):
    """Scalar SSIM of two (C, H, W) images through ops/ssim.py, on the
    device of img1 where it is a tensor, else on the CPU."""
    from ..ops.ssim import ssim_loss

    dev = img1.device if isinstance(img1, torch.Tensor) else "cpu"
    a = torch.as_tensor(_np(img1), dtype=torch.float32, device=dev)
    b = torch.as_tensor(_np(img2), dtype=torch.float32, device=dev)
    return 1.0 - float(ssim_loss(a, b))
