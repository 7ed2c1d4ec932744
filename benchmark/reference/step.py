"""The reference training step of a LoD tree: the root cull and the LoD
cut of the step's camera, the render of the cut with the training
low-pass, 0.8 L1 + 0.2 (1 - SSIM) against the ground truth, the gradient
by autograd, and Adam on the leaf rows that the render saw, whose scales
are then clamped into the checkpoint's radius bounds (LoG's tree stage,
all levels optimised).

The slice of kept rows is a bucket that lags one step behind the kept
counts (LoG's training loop): the first step is sized from its own cut,
each later one from the counts of the step before (grown past them, or
halved below half), and a cut past its bucket keeps its first rows.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import math as m
from .frame import lod_cut, root_cull, tree_of
from .raster import composite

BETA1, BETA2, EPS = 0.9, 0.999, 1e-15
OPT_KEYS = ("xyz", "colors", "scaling", "opacity", "rotation", "shs")


def bucket(n: int, minimum: int = 256) -> int:
    """Smallest c in {2^k, 1.5 * 2^k} with c >= max(n, minimum)."""
    n, c = max(int(n), minimum), minimum
    while c < n:
        if c + c // 2 >= n:
            return c + c // 2
        c *= 2
    return c


def lr_at(step: int, lr_dict: dict, key: str) -> float:
    """The per-key learning rate: xyz (times xyz_scale) decays log-linearly
    to xyz_final over max_steps, scaling likewise to scaling_final where
    given; the others are constant. Evaluated in float32."""
    f = np.float32
    if key in ("xyz", "scaling"):
        scale = lr_dict.get("xyz_scale", 1.0) if key == "xyz" else 1.0
        a = lr_dict[key] * scale
        b = lr_dict.get(f"{key}_final", lr_dict[key] * (0.01 if key == "xyz"
                                                         else 1.0)) * scale
        t = np.clip(f(step) / f(lr_dict["max_steps"]), 0, 1)
        return float(np.exp(f(np.log(a)) * (1 - t) + f(np.log(b)) * t,
                            dtype=f))
    return float(f(lr_dict[key]))


def _window(dtype, device, size=11, sigma=1.5):
    g = torch.tensor([math.exp(-((x - size // 2) ** 2) / (2 * sigma ** 2))
                      for x in range(size)], dtype=torch.float32)
    return (g / g.sum()).to(device=device, dtype=dtype)


def ssim(img1, img2):
    """Mean SSIM of two (3, H, W) images: 11 x 11 Gaussian window (sigma
    1.5), valid windows, per channel."""
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    g = _window(img1.dtype, img1.device)
    wy = g.reshape(1, 1, -1, 1).expand(15, 1, -1, 1)
    wx = g.reshape(1, 1, 1, -1).expand(15, 1, 1, -1)
    x = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2])[None]
    x = F.conv2d(F.conv2d(x, wy, groups=15), wx, groups=15)[0]
    mu1, mu2, e11, e22, e12 = x.split(3)
    s = ((2 * mu1 * mu2 + C1) * (2 * (e12 - mu1 * mu2) + C2)) / (
        (mu1 * mu1 + mu2 * mu2 + C1) * (e11 - mu1 * mu1 + e22 - mu2 * mu2 + C2))
    return s.mean()


class Trainer:
    """Steps of the reference from a checkpoint (gaussian.*, tree.*,
    counter.radius3d_{min,max}), with zero Adam moments at step 0.
    half_batch plants a fault for the control readings: the loss is the
    mean over the top half of the image only."""

    def __init__(self, ckpt: dict, cfg: dict, prec: m.Prec = m.F32,
                 half_batch: bool = False):
        self.prec, self.cfg, self.half_batch = prec, cfg, half_batch
        self.tree = tree_of(ckpt)
        self.p = {k: (ckpt[f"gaussian.{k}"].float() if k == "xyz" else
                      ckpt[f"gaussian.{k}"].to(prec.dtype))
                  for k in OPT_KEYS if f"gaussian.{k}" in ckpt}
        self.m1 = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.m2 = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.smin = torch.log(torch.clamp(ckpt["counter.radius3d_min"],
                                          min=1e-12)).to(prec.dtype)
        self.smax = torch.log(torch.clamp(ckpt["counter.radius3d_max"],
                                          min=1e-12)).to(prec.dtype)
        t = self.tree
        self.leaf_opt = (t["node_index"] == -1) & (t["depth"] > 0)
        self.steps = 0
        self.bucket = None
        self.last_counts = None

    @torch.no_grad()
    def _cut(self, camera: dict):
        """(camera tensors, the kept rows (N,) bool, the check render) of
        the current parameters."""
        cam = m.camera_tensors(camera, self.p["xyz"].device)
        root_ok, check = root_cull(self.p, self.tree, cam,
                                   self.cfg["check_render_scale"], self.prec)
        keep = lod_cut(self.p, self.tree, cam, root_ok,
                       self.cfg["min_resolution_pixel"],
                       int(self.tree["depth"].max()))
        return cam, keep, check

    def _slice(self, keep):
        leaf = torch.nonzero(keep & self.leaf_opt).squeeze(1)
        node = torch.nonzero(keep & ~self.leaf_opt).squeeze(1)
        counts = (leaf.shape[0], node.shape[0])
        if self.bucket is None:
            self.bucket = (bucket(counts[0]), bucket(counts[1]) if counts[1]
                           else 0)
        elif self.last_counts is not None:
            bl, bn = self.bucket
            kl = bucket(self.last_counts[0])
            kn = bucket(self.last_counts[1]) if self.last_counts[1] else 0
            bl = kl if (kl > bl or kl * 2 < bl) else bl
            bn = kn if (kn > bn or kn * 2 < bn) else bn
            self.bucket = (bl, bn)
        if self.steps > 0:
            self.last_counts = counts
        return leaf[:self.bucket[0]], node[:self.bucket[1]]

    def step(self, camera: dict, gt_u8, background) -> dict:
        """One step on camera with ground truth gt_u8 ((3, H, W) uint8) and
        background (3,). Returns the loss, the Adam first moments' norms
        per key after the update, the rendered and updated row counts and
        the render's work (combos, pairs)."""
        dt, dev = self.prec.dtype, self.p["xyz"].device
        cam, keep, check = self._cut(camera)
        leaf, node = self._slice(keep)
        lanes = torch.cat([leaf, node])
        leaves = {k: v[lanes].detach().requires_grad_(True)
                  for k, v in self.p.items()}
        scale, op, q = m.activate(leaves)
        with torch.no_grad():
            d_xyz = leaves["xyz"].detach()
        rgb = m.sh_colour(leaves, d_xyz, cam, self.cfg["sh_degree"])
        s = m.screen_splats(leaves["xyz"], scale, q, op, cam,
                            torch.ones_like(op, dtype=torch.bool),
                            lowpass=True, tight=False)
        bg = torch.as_tensor(background, dtype=dt, device=dev)
        with torch.enable_grad():
            out = composite(s, rgb, cam["H"], cam["W"], bg)
            gt = gt_u8.to(device=dev, dtype=dt) / 255.0
            img = out["image"]
            if self.half_batch:
                img, gt = img[:, :img.shape[1] // 2], gt[:, :img.shape[1] // 2]
            l1 = (img - gt).abs().mean()
            loss = 0.8 * l1 + 0.2 * (1.0 - ssim(img, gt))
            grads = (torch.autograd.grad(loss, list(leaves.values()),
                                         allow_unused=True)
                     if loss.requires_grad else [None] * len(leaves))
        self.steps += 1
        t = self.steps
        upd = (s["radius"].detach() > 0) & (torch.arange(
            lanes.shape[0], device=dev) < leaf.shape[0])
        rows = lanes[upd]
        with torch.no_grad():
            for (k, leaf_v), g in zip(leaves.items(), grads):
                g = torch.zeros_like(leaf_v) if g is None else g
                g = g[upd]
                m1 = BETA1 * self.m1[k][rows] + (1 - BETA1) * g
                m2 = BETA2 * self.m2[k][rows] + (1 - BETA2) * g * g
                lr = lr_at(t, self.cfg["lr_dict"], k)
                denom = torch.sqrt(m2) / math.sqrt(1 - BETA2 ** t) + EPS
                p_new = self.p[k][rows] - (lr / (1 - BETA1 ** t)) * (m1 / denom)
                if k == "scaling":
                    p_new = torch.clamp(p_new, min=self.smin[rows][:, None],
                                        max=self.smax[rows][:, None])
                self.p[k] = self.p[k].index_put((rows,), p_new)
                self.m1[k] = self.m1[k].index_put((rows,), m1)
                self.m2[k] = self.m2[k].index_put((rows,), m2)
        return {"loss": float(loss.detach()), "rendered": int(lanes.shape[0]),
                "updated": int(rows.shape[0]),
                "m1_norm": {k: float(torch.linalg.vector_norm(v.float()))
                            for k, v in self.m1.items()},
                "combos": out["combos"], "pairs": out["pairs"],
                "check_combos": check["combos"],
                "check_pairs": check["pairs"],
                "image": out["image"].detach()}

    @torch.no_grad()
    def work(self, camera: dict) -> dict:
        """The work of a step on camera from the current parameters: the
        cut, the render's contributing (splat, pixel) combinations, its
        splats and the check render's combinations (no update)."""
        cam, keep, check = self._cut(camera)
        sub = {k: v[keep] for k, v in self.p.items()}
        scale, op, q = m.activate(sub)
        s = m.screen_splats(sub["xyz"], scale, q, op, cam,
                            torch.ones_like(op, dtype=torch.bool),
                            lowpass=True, tight=False)
        rgb = m.sh_colour(sub, sub["xyz"], cam, self.cfg["sh_degree"])
        out = composite(s, rgb, cam["H"], cam["W"], torch.zeros(
            3, dtype=rgb.dtype, device=rgb.device))
        return {"cut": int(keep.sum()), "combos": out["combos"],
                "pairs": out["pairs"], "splats": int(s["valid"].sum()),
                "check_combos": check["combos"]}

    def change_norms(self, ckpt: dict) -> dict:
        """Per key, the norm of the parameters' change since the
        checkpoint."""
        return {k: float(torch.linalg.vector_norm(
            v.float() - ckpt[f"gaussian.{k}"].float()))
            for k, v in self.p.items()}
