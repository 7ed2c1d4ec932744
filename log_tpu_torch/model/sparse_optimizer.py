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

The host-spill tier: past `spill_points` live points the second moments,
and past `spill_points_full` the first moments too, move to pinned host
memory and leave the device (`maybe_spill`, `to_host`). A spilled step then
gathers the visible rows' moments on the host (`host_gather`), uploads them
into the step, runs the same per-key Adam ops on them as the device path,
and scatters the updated rows back on the host (`host_scatter`).
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
                     update_mask, global_step, lrs: dict, eps: float = 1e-15,
                     spilled: tuple = (), m_slices: dict | None = None):
    """Gather -> Adam -> scatter at the slice's global rows.

    params / moments: capacity-padded dicts (moments has 'exp_avg' and
      'exp_avg_sq' sub-dicts keyed like params).
    grads: (K, ...) gradients of the gathered slice.
    index: (K,) global row per lane; update_mask: (K,) bool. Masked lanes
      are redirected to the sentinel row and drop.
    spilled / m_slices: for each moment kind in `spilled` the capacity
      tensors are not on the device; m_slices[kind][key] holds the (K, ...)
      rows the host gathered at `index`, and the updated rows come back in
      a third return value for the host to scatter. Masked lanes of those
      carry the gathered rows unchanged.
    Returns (new_params, new_moments), and the updated slices if spilled.
    """
    cap = params[next(iter(params))].shape[0]
    idx = torch.where(update_mask, index.to(torch.int64), cap)
    new_params = dict(params)
    new_m = {mk: dict(moments[mk]) for mk in ("exp_avg", "exp_avg_sq")}
    out_slices = {mk: {} for mk in spilled}
    for k in (k for k, g in grads.items() if g is not None and k in lrs):
        p2 = _padded(params[k])
        rows, padded = {}, {}
        for mk in ("exp_avg", "exp_avg_sq"):
            if mk in spilled:
                rows[mk] = m_slices[mk][k]
            else:
                padded[mk] = _padded(moments[mk][k])
                rows[mk] = padded[mk][idx]
        p_u, m1_u, m2_u, _ = adam_slice_update(
            p2[idx], grads[k], rows["exp_avg"], rows["exp_avg_sq"],
            global_step, _lr(lrs, k, p2.device), eps=eps,
        )
        # unique real rows; every dropped lane writes the spare row
        new_params[k] = p2.index_copy_(0, idx, p_u)[:cap]
        mask = update_mask.reshape((-1,) + (1,) * (p_u.dim() - 1))
        for mk, upd in (("exp_avg", m1_u), ("exp_avg_sq", m2_u)):
            if mk in spilled:
                out_slices[mk][k] = torch.where(mask, upd, rows[mk])
            else:
                new_m[mk][k] = padded[mk].index_copy_(0, idx, upd)[:cap]
    if spilled:
        return new_params, new_m, out_slices
    return new_params, new_m


def _host_tensor(shape, dtype, pinned: bool):
    """An empty host tensor, in page-locked memory where pinned (which the
    card copies from and to without staging, asynchronously)."""
    return torch.empty(shape, dtype=dtype, pin_memory=pinned)


def _wait_for(device) -> None:
    """Block until the copies queued so far on device's current stream have
    landed (an event on the stream, then a wait on it)."""
    if torch.device(device).type == "cuda":
        done = torch.cuda.Event()
        done.record()
        done.synchronize()


class SparseOptimizer:
    """Host container: the device moments and the LR schedule config
    (xyz and scaling scheduled, per-key constant LRs otherwise, xyz scaled
    by xyz_scale), and the host-spill tier.

    spill_points / spill_points_full: the live point counts past which
    `maybe_spill` moves exp_avg_sq, then exp_avg too, to host memory (from
    lr_dict where it names them, else the arguments). Spilled moments live
    in `host_moments[kind][key]`, capacity-padded CPU tensors, pinned when
    the model is on a CUDA device.
    """

    def __init__(self, optimize_keys, lr_dict, model, xyz_scale=None,
                 spill_points=50_000_000, spill_points_full=100_000_000):
        self.optimize_keys = list(optimize_keys)
        self.lr_dict = dict(lr_dict)
        self.global_steps = 0
        self.xyz_scale = xyz_scale if xyz_scale is not None else 1.0
        self.max_steps = int(lr_dict.get("max_steps", 1_000_000))
        self.device = model.device
        self.spill_points = int(lr_dict.get("spill_points", spill_points))
        self.spill_points_full = int(
            lr_dict.get("spill_points_full", spill_points_full))
        self.spilled: tuple = ()
        self.host_moments: dict = {}
        # bytes the spilled steps moved: gathered rows up, updated rows down
        self.transfer_bytes = {"h2d": 0, "d2h": 0}
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

    @property
    def _pinned(self) -> bool:
        return torch.device(self.device).type == "cuda"

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

    # ---------------------------------------------------------- host moves
    def to_host(self, keys=("exp_avg_sq",)) -> None:
        """Move moment kinds to host memory and free their device tensors.
        The training step then runs in spill mode: host gather -> Adam on
        the uploaded rows -> host scatter."""
        for mk in keys:
            if mk in self.spilled:
                continue
            host = {}
            for k, v in self.moments[mk].items():
                host[k] = _host_tensor(v.shape, v.dtype, self._pinned)
                host[k].copy_(v)
            self.host_moments[mk] = host
            self.moments[mk] = {}  # frees the device copies
            self.spilled = tuple(sorted(set(self.spilled) | {mk}))

    def maybe_spill(self, num_points: int) -> bool:
        """Spill past the thresholds, each kind at most once; call after
        the point count grew. Returns True if this call spilled."""
        did = False
        if num_points > self.spill_points and "exp_avg_sq" not in self.spilled:
            print(f"[{self.__class__.__name__}] {num_points} points > "
                  f"{self.spill_points}: spilling exp_avg_sq to host")
            self.to_host(("exp_avg_sq",))
            did = True
        if (num_points > self.spill_points_full
                and "exp_avg" not in self.spilled):
            print(f"[{self.__class__.__name__}] {num_points} points > "
                  f"{self.spill_points_full}: spilling exp_avg to host")
            self.to_host(("exp_avg",))
            did = True
        return did

    def host_gather(self, index: np.ndarray) -> dict:
        """(K, ...) rows of every spilled kind at index, into pinned host
        tensors (the step uploads them without blocking). Sentinel lanes
        (index >= capacity) read the last row; the step masks them."""
        out = {}
        for mk in self.spilled:
            rows = {}
            for k, arr in self.host_moments[mk].items():
                idx = torch.from_numpy(
                    np.clip(np.asarray(index, np.int64), 0, arr.shape[0] - 1))
                rows[k] = _host_tensor((idx.shape[0],) + arr.shape[1:],
                                       arr.dtype, self._pinned)
                torch.index_select(arr, 0, idx, out=rows[k])
                self.transfer_bytes["h2d"] += rows[k].numel() * 4
            out[mk] = rows
        return out

    def host_scatter(self, index: np.ndarray, slices: dict, mask) -> None:
        """Write the step's updated (K, ...) rows back into the host tensors
        where mask is True. The rows and the mask are copied off the device
        into pinned memory without blocking, and the scatter waits for
        those copies to land before it reads them."""
        staged = {}
        for mk, rows in slices.items():
            staged[mk] = {}
            for k, sl in rows.items():
                buf = _host_tensor(sl.shape, sl.dtype,
                                   sl.device.type == "cuda")
                staged[mk][k] = buf.copy_(sl, non_blocking=True)
                self.transfer_bytes["d2h"] += buf.numel() * 4
        mask_h = _host_tensor(mask.shape, torch.bool,
                              mask.device.type == "cuda")
        mask_h.copy_(mask, non_blocking=True)
        _wait_for(mask.device)
        sel = mask_h.numpy()
        idx = torch.from_numpy(np.asarray(index, np.int64)[sel])
        sel = torch.from_numpy(sel)
        for mk, rows in staged.items():
            for k, sl in rows.items():
                self.host_moments[mk][k].index_copy_(0, idx, sl[sel])

    def set_numpy(self, moments: dict, capacity: int) -> None:
        for mk in ("exp_avg", "exp_avg_sq"):
            for key, val in moments.get(mk, {}).items():
                padded = torch.from_numpy(np.ascontiguousarray(
                    pad_rows(np.asarray(val, np.float32), capacity)))
                if mk in self.spilled:
                    host = _host_tensor(padded.shape, padded.dtype,
                                        self._pinned)
                    self.host_moments[mk][key] = host.copy_(padded)
                else:
                    self.moments[mk][key] = padded.to(self.device)

    def to_numpy(self, num_points: int) -> dict:
        out = {}
        for mk in ("exp_avg", "exp_avg_sq"):
            if mk in self.spilled:
                # copies: host_scatter updates the host tensors in place
                out[mk] = {k: v[:num_points].numpy().copy()
                           for k, v in self.host_moments[mk].items()}
            else:
                out[mk] = {k: v[:num_points].cpu().numpy()
                           for k, v in self.moments[mk].items()}
        return out
