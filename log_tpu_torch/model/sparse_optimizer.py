"""Sparse per-point Adam over capacity-padded moment tensors; counterpart of
log_tpu/model/sparse_optimizer.py.

The moments live on the device beside the parameters. A step gathers the
visible slice's rows, runs Adam on them and scatters them back; lanes that
carry the out-of-range sentinel index (capacity) drop, through one spare
row appended for the scatter. When the slice covers the whole capacity in
index order (the identity fast path) the dense masked form runs instead.
Both are functional: they return new tensors and leave their inputs
untouched, so a caller may still hold the old ones.

Adam math: global-step bias correction, eps = 1e-15 added after the sqrt,
betas (0.9, 0.999), in float32 in the JAX package's operation order. LR
schedule: the Plenoxels log-lerp.

The host-spill tier of the JAX package (moments in host memory past 50M
points) is not ported yet (ROADMAP queue 1.2b).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .gaussian import pad_rows

_F32 = torch.float32


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: float = 0,
             lr_delay_mult: float = 1.0, max_steps: float = 1_000_000) -> float:
    """Log-linear LR decay, evaluated in float32 (the JAX package traces it
    with float32 scalars)."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    step = torch.tensor(float(step), dtype=_F32)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1)
        )
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(
        torch.tensor(np.log(lr_init), dtype=_F32) * (1 - t)
        + torch.tensor(np.log(lr_final), dtype=_F32) * t
    )
    lr = delay_rate * log_lerp
    return 0.0 if float(step) < 0 else float(lr)


def adam_slice_update(param, grad, exp_avg, exp_avg_sq, global_step, lr,
                      eps: float = 1e-15, beta1: float = 0.9,
                      beta2: float = 0.999, max_exp_avg_sq=None):
    """One Adam step on gathered (K, ...) rows. global_step and lr are
    float32 tensors (or lr a broadcastable per-column tensor).
    Returns (param, exp_avg, exp_avg_sq, max_exp_avg_sq)."""
    exp_avg = beta1 * exp_avg + (1 - beta1) * grad
    exp_avg_sq = beta2 * exp_avg_sq + (1 - beta2) * grad * grad
    step = torch.as_tensor(global_step, dtype=_F32, device=param.device)
    bias_c1 = 1 - beta1 ** step
    bias_c2 = 1 - beta2 ** step
    step_size = lr / bias_c1
    if max_exp_avg_sq is not None:
        max_exp_avg_sq = torch.maximum(max_exp_avg_sq, exp_avg_sq)
        denom = torch.sqrt(max_exp_avg_sq) / torch.sqrt(bias_c2) + eps
    else:
        denom = torch.sqrt(exp_avg_sq) / torch.sqrt(bias_c2) + eps
    param = param - step_size * (exp_avg / denom)
    return param, exp_avg, exp_avg_sq, max_exp_avg_sq


def _lr(lrs: dict, key: str, device):
    return torch.as_tensor(lrs[key], dtype=_F32, device=device)


def dense_adam_step(params: dict, moments: dict, grads: dict, update_mask,
                    global_step, lrs: dict, eps: float = 1e-15):
    """Adam over the whole capacity axis with a per-row update mask: the
    identity fast path (slice == capacity in index order). Masked rows keep
    their parameters and moments, exactly what the sparse path's dropped
    scatters leave. Returns (new_params, new_moments)."""
    new_params = dict(params)
    new_m1 = dict(moments["exp_avg"])
    new_m2 = dict(moments["exp_avg_sq"])
    for k in (k for k, g in grads.items() if g is not None and k in lrs):
        m1 = moments["exp_avg"][k]
        m2 = moments["exp_avg_sq"][k]
        p, m1_u, m2_u, _ = adam_slice_update(
            params[k], grads[k], m1, m2, global_step,
            _lr(lrs, k, params[k].device), eps=eps,
        )
        mask = update_mask.reshape((-1,) + (1,) * (params[k].dim() - 1))
        new_params[k] = torch.where(mask, p, params[k])
        new_m1[k] = torch.where(mask, m1_u, m1)
        new_m2[k] = torch.where(mask, m2_u, m2)
    return new_params, {"exp_avg": new_m1, "exp_avg_sq": new_m2}


def _padded(arr):
    """arr with one zero row appended at the sentinel index len(arr)."""
    return torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])])


def sparse_adam_step(params: dict, moments: dict, grads: dict, index,
                     update_mask, global_step, lrs: dict, eps: float = 1e-15):
    """Gather -> Adam -> scatter at the slice's global rows.

    params / moments: capacity-padded dicts (moments has 'exp_avg' and
      'exp_avg_sq' sub-dicts keyed like params).
    grads: (K, ...) gradients of the gathered slice.
    index: (K,) global row per lane; update_mask: (K,) bool. Masked lanes
      are redirected to the sentinel row and drop.
    Returns (new_params, new_moments).
    """
    cap = params[next(iter(params))].shape[0]
    idx = torch.where(update_mask, index.to(torch.int64), cap)
    new_params = dict(params)
    new_m1 = dict(moments["exp_avg"])
    new_m2 = dict(moments["exp_avg_sq"])
    for k in (k for k, g in grads.items() if g is not None and k in lrs):
        p2 = _padded(params[k])
        m1_2 = _padded(moments["exp_avg"][k])
        m2_2 = _padded(moments["exp_avg_sq"][k])
        p_u, m1_u, m2_u, _ = adam_slice_update(
            p2[idx], grads[k], m1_2[idx], m2_2[idx], global_step,
            _lr(lrs, k, p2.device), eps=eps,
        )
        # unique real rows; every dropped lane writes the spare row
        new_params[k] = p2.index_copy_(0, idx, p_u)[:cap]
        new_m1[k] = m1_2.index_copy_(0, idx, m1_u)[:cap]
        new_m2[k] = m2_2.index_copy_(0, idx, m2_u)[:cap]
    return new_params, {"exp_avg": new_m1, "exp_avg_sq": new_m2}


class SparseOptimizer:
    """Host container: the device moments and the LR schedule config
    (xyz and scaling scheduled, per-key constant LRs otherwise, xyz scaled
    by xyz_scale)."""

    def __init__(self, optimize_keys, lr_dict, model, xyz_scale=None):
        self.optimize_keys = list(optimize_keys)
        self.lr_dict = dict(lr_dict)
        self.global_steps = 0
        self.xyz_scale = xyz_scale if xyz_scale is not None else 1.0
        self.max_steps = int(lr_dict.get("max_steps", 1_000_000))
        self.device = model.device
        # moments in host memory past 50M points: queue 1.2b
        self.spilled: tuple = ()
        self.moments = {"exp_avg": {}, "exp_avg_sq": {}}
        for key in self.optimize_keys:
            if key not in model.keys:
                continue
            for mk in ("exp_avg", "exp_avg_sq"):
                self.moments[mk][key] = torch.zeros_like(model.get(key))
        print(
            f"[{self.__class__.__name__}] xyz_scale: {self.xyz_scale}, "
            f"steps: {self.max_steps}, lr "
            f"{self.lr_dict.get('xyz', 0) * self.xyz_scale}->"
            f"{self.lr_dict.get('xyz_final', self.lr_dict.get('xyz', 0) * 0.01) * self.xyz_scale}"
        )

    def lrs_for_step(self, step) -> dict:
        """Per-key LR (host floats) for a global step."""
        lrs = {}
        for key in self.optimize_keys:
            if key == "xyz":
                lrs[key] = expon_lr(
                    step, self.lr_dict["xyz"] * self.xyz_scale,
                    self.lr_dict.get("xyz_final", self.lr_dict["xyz"] * 0.01)
                    * self.xyz_scale,
                    max_steps=self.max_steps,
                )
            elif key == "scaling" and "scaling" in self.lr_dict:
                lrs[key] = expon_lr(
                    step, self.lr_dict["scaling"],
                    self.lr_dict.get("scaling_final", self.lr_dict["scaling"]),
                    max_steps=self.max_steps,
                )
            elif key in self.lr_dict:
                lrs[key] = float(np.float32(self.lr_dict[key]))
        return lrs

    def maybe_spill(self, num_points: int) -> bool:
        """The JAX package moves moments to host memory past 50M points;
        the port raises there until that tier is ported."""
        if num_points > int(self.lr_dict.get("spill_points", 50_000_000)):
            raise NotImplementedError(
                "host-spilled moments (past 50M points) are ROADMAP queue 1.2b"
            )
        return False

    def set_numpy(self, moments: dict, capacity: int) -> None:
        for mk in ("exp_avg", "exp_avg_sq"):
            for key, val in moments.get(mk, {}).items():
                padded = pad_rows(np.asarray(val, np.float32), capacity)
                self.moments[mk][key] = torch.from_numpy(
                    np.ascontiguousarray(padded)
                ).to(self.device)

    def to_numpy(self, num_points: int) -> dict:
        return {mk: {k: v[:num_points].cpu().numpy() for k, v in d.items()}
                for mk, d in self.moments.items()}

