"""Losses of the training step: SSIM and the MiDaS scale-and-shift
invariant depth loss; counterpart of log_tpu/render/loss.py.

`depth_patch_loss` compares the rendered depth with a monocular
inverse-depth map on random square patches. The JAX package draws the
patch offsets inside its jitted step from `jax.random.PRNGKey(step)`; the
port takes them as arguments, drawn by `draw_patch_offsets` from a
generator the caller seeds (the model seeds a numpy Generator with the
global step), so a test can hand both packages the same offsets.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.ssim import ssim_loss as ssim_loss  # noqa: F401 (API parity)

NUM_PATCH = 64
PATCH_SIZE = 64


def compute_scale_and_shift(prediction, target, mask):
    """Closed-form per-image least-squares scale and shift of prediction
    onto target over the mask. Shapes (B, H, W); returns two (B,) tensors,
    zero where the system is singular (det == 0)."""
    a_00 = torch.sum(mask * prediction * prediction, dim=(1, 2))
    a_01 = torch.sum(mask * prediction, dim=(1, 2))
    a_11 = torch.sum(mask, dim=(1, 2))
    b_0 = torch.sum(mask * prediction * target, dim=(1, 2))
    b_1 = torch.sum(mask * target, dim=(1, 2))
    det = a_00 * a_11 - a_01 * a_01
    ok = det != 0
    safe = torch.where(ok, det, torch.ones_like(det))
    x_0 = torch.where(ok, (a_11 * b_0 - a_01 * b_1) / safe,
                      torch.zeros_like(det))
    x_1 = torch.where(ok, (-a_01 * b_0 + a_00 * b_1) / safe,
                      torch.zeros_like(det))
    return x_0, x_1


def gradient_loss(prediction, target, mask):
    """Masked L1 of the horizontal and vertical differences of the
    residual, over the mask's pixel count (at least 1)."""
    m = torch.sum(mask)
    diff = mask * (prediction - target)
    grad_x = torch.abs(diff[:, :, 1:] - diff[:, :, :-1])
    mask_x = mask[:, :, 1:] * mask[:, :, :-1]
    grad_y = torch.abs(diff[:, 1:, :] - diff[:, :-1, :])
    mask_y = mask[:, 1:, :] * mask[:, :-1, :]
    total = torch.sum(mask_x * grad_x) + torch.sum(mask_y * grad_y)
    return total / torch.clamp(m, min=1.0)


def scale_and_shift_invariant_loss(prediction, target, mask,
                                   alpha: float = 0.5, scales: int = 1):
    """MiDaS SSI loss: the masked MSE of the least-squares aligned
    prediction plus alpha times the gradient term at `scales` scales.
    Returns (loss, aligned prediction)."""
    scale, shift = compute_scale_and_shift(prediction, target, mask)
    pred_ssi = scale[:, None, None] * prediction + shift[:, None, None]
    mask_sum = torch.clamp(torch.sum(mask), min=1.0)
    total = torch.sum(((pred_ssi - target) * mask) ** 2) / mask_sum
    reg = 0.0
    for s in range(scales):
        step = 2 ** s
        reg = reg + gradient_loss(pred_ssi[:, ::step, ::step],
                                  target[:, ::step, ::step],
                                  mask[:, ::step, ::step])
    return total + alpha * reg, pred_ssi


def draw_patch_offsets(height: int, width: int, rng,
                       num_patch: int = NUM_PATCH,
                       patch_size: int = PATCH_SIZE):
    """(rows, cols) of num_patch patch corners, uniform in
    [0, max(height - patch_size, 1)) and [0, max(width - patch_size, 1)),
    rows drawn first. rng: a numpy Generator (int64 arrays back) or a
    torch.Generator (int64 tensors on its device)."""
    hi_r = max(height - patch_size, 1)
    hi_c = max(width - patch_size, 1)
    if isinstance(rng, torch.Generator):
        kw = dict(generator=rng, device=rng.device, dtype=torch.int64)
        return (torch.randint(0, hi_r, (num_patch,), **kw),
                torch.randint(0, hi_c, (num_patch,), **kw))
    return (rng.integers(0, hi_r, num_patch, dtype=np.int64),
            rng.integers(0, hi_c, num_patch, dtype=np.int64))


class _Patches(torch.autograd.Function):
    """img[rows + i, cols + j] for i, j < size, whose backward adds each
    patch's gradient into place one patch after another. Indexing's own
    backward accumulates overlapping patches with atomic adds on the card,
    in an order that changes from run to run; this order is fixed, so a
    step stays reproducible."""

    @staticmethod
    def forward(ctx, img, rows, cols, size):
        ctx.starts = list(zip(rows.tolist(), cols.tolist()))
        ctx.shape, ctx.size = img.shape, size
        k = torch.arange(size, device=img.device)
        rows, cols = rows.to(img.device), cols.to(img.device)
        return img[(rows[:, None] + k)[:, :, None],
                   (cols[:, None] + k)[:, None, :]]

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        s = ctx.size
        for (r, c), g_patch in zip(ctx.starts, g):
            out[r:r + s, c:c + s] += g_patch
        return out, None, None, None


def take_patches(img, rows, cols, patch_size: int = PATCH_SIZE):
    """(N, patch_size, patch_size) patches of img (H, W) at corners
    (rows, cols), each start clamped so that its patch lies inside img, as
    jax.lax.dynamic_slice clamps. Differentiable w.r.t. img, with a
    deterministic backward."""
    H, W = img.shape
    if H < patch_size or W < patch_size:
        raise ValueError(f"a {H}x{W} image holds no {patch_size}x"
                         f"{patch_size} patch")

    def starts(v, hi):
        # host corners stay on the host (the backward reads them there)
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, np.int64))
        return torch.clamp(v.to(torch.int64), 0, hi)

    return _Patches.apply(img, starts(rows, H - patch_size),
                          starts(cols, W - patch_size), patch_size)


def depth_patch_loss(pred_depth, gt_depth, accmap, rows, cols,
                     patch_size: int = PATCH_SIZE):
    """SSI loss of the rendered inverse depth 1 / (pred + 1e-5) against the
    monocular inverse depth gt on the patches at (rows, cols) (drawn over
    gt's size by draw_patch_offsets), masked where the accumulated opacity
    exceeds 0.5. pred_depth, accmap: (H, W) renders; gt_depth: (Hd, Wd),
    which may differ from (H, W): each image clamps the corners to its own
    size."""
    mask = (accmap > 0.5).to(torch.float32)
    preds = take_patches(pred_depth, rows, cols, patch_size)
    gts = take_patches(gt_depth, rows, cols, patch_size)
    masks = take_patches(mask, rows, cols, patch_size)
    loss, _ = scale_and_shift_invariant_loss(1.0 / (preds + 1e-5), gts, masks)
    return loss
