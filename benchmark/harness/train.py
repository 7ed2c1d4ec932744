"""The training cycle: the tree stage of LoG's training over a fixed set
of views. Each step is one `Trainer.training_step` (the trainer's random
background, the ground truth cached on the device), which runs
`LoG.training_iteration`: the visibility pass, the cut, the render, the
loss, the backward and sparse Adam. The harness synchronizes after each
step.

Set-up loads the seed's tree for training (zero Adam moments, step 0),
then drives the same trainer through one step per view: the first
`compared_steps` of them are read (each loss; after the first, the Adam
first moments; after the last, the parameters' change) and later held
against the reference's steps from the same checkpoint. The window then
continues the cycle for the run's seconds. A traced window keeps the
`metrics` that each step returns (the program's own counters: the loss,
`num_rendered`, the binning's `pair_total`, the visibility pass's
`counts`) and hands them to the metric files on the host, once the
window has closed, as `step_stats`.
"""
from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from . import check, inputs
from .trace import profiled
from .view import CAMERA_KEYS


def build(cfg: dict, seed: int, n_views: int, dev):
    """(model, host checkpoint): the tree loaded for the tree stage."""
    from log_tpu_torch.model.level_of_gaussian import LoG

    host = inputs.host_tree(cfg, seed, dev)
    keys = [k.split(".", 1)[1] for k in host if k.startswith("gaussian.")]
    load = dict(host)
    for k in keys:
        for mk in ("exp_avg", "exp_avg_sq"):
            load[f"optimizer.{mk}.{k}"] = np.zeros_like(host[f"gaussian.{k}"])
    load["optimizer.global_steps"] = np.float32(0)
    model = LoG(**cfg["model"], device=dev)
    if model.view_correction is not None:
        model.view_correction.init(n_views)
    model.load_state_dict(load, split="train")
    del load
    model.set_state(enable_sh=True, **cfg.get("state", {}))
    model.set_stage("tree")
    model.training_setup()
    return model, host


def run(ctx) -> dict:
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.trainer import Trainer

    cfg, tr, dev, seed = ctx.cfg, ctx.traffic, ctx.device, ctx.seed
    cam_cfg = inputs.camera_of(cfg, tr)
    H, W, V = cam_cfg["height"], cam_cfg["width"], tr["views"]
    model, host = build(cfg, seed, V, dev)
    cams = inputs.orbit(seed, V, H, W, cam_cfg["focal"], tr["height"],
                        tr["radius"])
    gts = inputs.ground_truth(seed, V, H, W, tr["gt_cells"], dev)
    batches = [{"camera": {k: np.asarray(c[k])[None] for k in CAMERA_KEYS},
                "image": g.permute(1, 2, 0).cpu().numpy()[None],
                "index": np.asarray([v])}
               for v, (c, g) in enumerate(zip(cams, gts))]
    renderer = NaiveRendererAndLoss(split="train",
                                    use_randback=tr["use_randback"],
                                    device=dev)
    trainer_seed = seed % (1 << 63)
    trainer = Trainer({}, model, renderer, seed=trainer_seed)
    trainer.set_gt_cache(True)

    def step(k: int):
        t0 = time.perf_counter()
        with record_function("bench.training_step"):
            _, out, _ = trainer.training_step(model, batches[k % V])
            ctx.sync()
        trainer.global_iterations += 1
        return out, time.perf_counter() - t0

    prog = {"losses": []}
    n_cmp = tr["compared_steps"]
    for k in range(max(tr["warmup_steps"], n_cmp)):
        out, _ = step(k)
        if k < n_cmp:
            prog["losses"].append(float(out["metrics"]["loss"]))
        if k == 0:
            prog["m1"] = _norms(model.optimizer.moments["exp_avg"])
        if k == n_cmp - 1:
            prog["change"] = {key: float(torch.linalg.vector_norm(
                model.gaussian.get(key)[:model.num_points]
                - torch.from_numpy(host[f"gaussian.{key}"]).to(dev)))
                for key in prog["m1"]}
    k0 = k + 1
    setup_s = ctx.since_start()

    times, step_metrics = [], []
    if ctx.trace:
        with profiled() as prof:
            for k in range(k0, k0 + tr["trace_steps"]):
                out, dt = step(k)
                times.append(dt)
                step_metrics.append(out["metrics"])   # device tensors
                del out   # the step's render and GT go back before the next
        window_s = sum(times)
    else:
        t0 = time.perf_counter()
        k = k0
        while time.perf_counter() - t0 < ctx.seconds:
            times.append(step(k)[1])
            k += 1
        window_s = time.perf_counter() - t0
    traced = list(range(k0, k0 + len(times))) if ctx.trace else []
    step_stats = [_host_stats(m) for m in step_metrics]
    peak = ctx.peak_bytes()
    del model, trainer, renderer
    gc.collect()
    ctx.free()

    check.reference_mode()
    from ..reference import math as ref_math
    from ..reference.step import Trainer as RefTrainer

    ckpt = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    del host
    bg_rng = np.random.default_rng(trainer_seed)
    bgs = [bg_rng.random(3).astype(np.float32) for _ in range(n_cmp)]
    t_ref = time.perf_counter()
    ref = RefTrainer(ckpt, cfg["ref"], ref_math.F32)
    ref_out = {"losses": []}
    for k in range(n_cmp):
        r = ref.step(cams[k % V], gts[k % V], bgs[k])
        ref_out["losses"].append(r["loss"])
        if k == 0:
            ref_out["m1"] = r["m1_norm"]
    ref_out["change"] = ref.change_norms(ckpt)
    numbers = check.train_gaps(prog, ref_out)
    print("compared steps:", json.dumps({"program": prog,
                                         "reference": ref_out}),
          file=sys.stderr)
    works = []
    for k in traced:
        w = RefTrainer(ckpt, cfg["ref"], ref_math.F32).work(cams[k % V])
        works.append(dict(w, pixels=H * W,
                          rows=int(ckpt["gaussian.xyz"].shape[0])))
    ref_s = time.perf_counter() - t_ref
    e2e = {"step_ms": window_s / len(times) * 1e3,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    return {"e2e": e2e, "numbers": numbers, "rows": [numbers],
            "attempted": len(times),
            "peak_bytes": peak, "ref_s": ref_s,
            "layer": {"kind": "train", "steps": times, "works": works,
                      "step_stats": step_stats,
                      "sh_degree": cfg["model"]["gaussian"]["sh_degree"],
                      "trace": prof.trace if ctx.trace else None}}


def _norms(moments: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v)) for k, v in moments.items()}


def _host_stats(metrics: dict) -> dict:
    """A step's metrics on the host: scalars as floats, the rest (the
    visibility pass's counts) as lists."""
    out = {}
    for k, v in metrics.items():
        v = v.detach().cpu()
        out[k] = float(v) if v.dim() == 0 else v.tolist()
    return out
