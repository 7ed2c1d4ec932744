"""The fly-through: one viewer in a closed loop over an orbit. Each frame
is one `NaiveRendererAndLoss.vis` call, which runs `LoG.render_fused` in
eval mode, quantizes the frame to 8 bits on the device and copies it to
the host; the next frame starts when the last is on the host.

Set-up loads the seed's tree into `LoG` through `load_state_dict`, sets
the configuration's state (SH, cull cadence), lays the rows out for
inference (`optimize_render_layout`, as the CLI's demo path does) and
renders warm-up frames; the window then runs the loop for the run's
seconds. A sample of the window's frames, drawn from the seed, is kept
and held against the reference once the program is freed.
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

CAMERA_KEYS = ("camera_center", "world_view_transform", "full_proj_transform",
               "image_width", "image_height", "FoVx", "FoVy", "K", "R", "T")


def build(cfg: dict, seed: int, dev):
    """(model, host checkpoint): the seed's tree loaded into LoG as the
    configuration states."""
    from log_tpu_torch.model.level_of_gaussian import LoG

    host = inputs.host_tree(cfg, seed, dev)
    model = LoG(**cfg["model"], device=dev)
    model.load_state_dict(host)
    model.set_state(enable_sh=True, **cfg.get("state", {}))
    model.eval()
    # the inference row layout, as the CLI's demo path sets it up
    model.optimize_render_layout()
    return model, host


def _batch(camera):
    return {"camera": {k: np.asarray(camera[k])[None] for k in CAMERA_KEYS}}


class Loop:
    """The viewer: frame i shows pose i mod poses. Frames are counted from
    the first warm-up frame, as the program counts its cull cadence
    (`loop_cull_pose`)."""

    def __init__(self, model, renderer, cams):
        self.model, self.renderer, self.cams = model, renderer, cams
        self.batches = [_batch(c) for c in cams]
        self.i = 0

    def frame(self):
        """One served frame: (index, pose, seconds, 8-bit frame, stats)."""
        i, pose = self.i, self.i % len(self.cams)
        t0 = time.perf_counter()
        with record_function("bench.vis"):
            out = self.renderer.vis(self.batches[pose], self.model)
        dt = time.perf_counter() - t0
        self.i += 1
        return i, pose, dt, out["render"][0], self.model.frame_stats()


def _wrap_render_fused(model):
    """A bench.render_fused span around each render_fused call."""
    inner = model.render_fused

    def render_fused(*a, **kw):
        with record_function("bench.render_fused"):
            return inner(*a, **kw)

    model.render_fused = render_fused


def run(ctx) -> dict:
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss

    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    cam_cfg = inputs.camera_of(cfg, tr)
    model, host = build(cfg, ctx.seed, dev)
    renderer = NaiveRendererAndLoss(split="demo", background=tr["background"],
                                    device=dev)
    cams = inputs.orbit(ctx.seed, tr["poses"], cam_cfg["height"],
                        cam_cfg["width"], cam_cfg["focal"], tr["height"],
                        tr["radius"])
    loop = Loop(model, renderer, cams)
    for _ in range(tr["warmup_frames"]):
        warm = loop.frame()
    # a host array for each frame kept for the check, its pages touched
    # here: a kept frame's image is copied into one, so that the program's
    # host block (pinned on the card) returns to its cache, and the copy
    # in the window faults no page
    slots = [np.array(warm[3]) for _ in range(tr["check_frames"])]
    del warm
    ctx.sync()
    setup_s = ctx.since_start()

    rng = np.random.default_rng(ctx.seed % (1 << 63))
    kept, frames = [], []

    def keep(f):
        """Reservoir sample of check_frames frames over the window, each
        kept image copied into its slot (frames themselves keep no
        image)."""
        frames.append(f[:3] + f[4:])
        n = len(frames)
        if len(kept) < tr["check_frames"]:
            kept.append(None)
            j = len(kept) - 1
        else:
            j = int(rng.integers(0, n))
        if j < tr["check_frames"]:
            np.copyto(slots[j], f[3])
            kept[j] = f[:3] + (slots[j],) + f[4:]

    if ctx.trace:
        _wrap_render_fused(model)
        with profiled() as prof:
            for _ in range(tr["trace_frames"]):
                keep(loop.frame())
        window_s = sum(f[2] for f in frames)   # the traced frames alone
    else:
        t0 = time.perf_counter()
        while True:
            keep(loop.frame())
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
    peak = ctx.peak_bytes()
    del model, renderer, loop
    gc.collect()
    ctx.free()

    # the reference, once the program is freed
    check.reference_mode()
    from ..reference import frame as ref_frame
    from ..reference import math as ref_math

    ckpt = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    del host
    bg = np.asarray(tr["background"], np.float32)
    t_ref = time.perf_counter()
    refs = {}

    def reference(i, pose):
        key = (pose, loop_cull_pose(i, cfg, cams))
        if key not in refs:
            refs[key] = ref_frame.frame(ckpt, cams[pose], cfg["ref"], bg,
                                        ref_math.F32,
                                        cull_camera=cams[key[1]])
        return refs[key]

    rows = []
    for i, pose, _, img, stats in kept:
        u8 = np.rint(img * 255.0).astype(np.uint8)
        ref = reference(i, pose)
        rows.append(check.frame_gaps(u8, stats["cut"], ref))
        print(f"checked frame {i} (pose {pose}): {json.dumps(rows[-1])}; "
              f"program {json.dumps(stats)}; reference cut {ref['cut']}, "
              f"pairs {ref['pairs']}", file=sys.stderr)
    numbers = check.worst(rows)
    # with the trace, the work of every traced frame from the reference's
    # cut
    works = [dict(reference(i, pose), image=None,
                  pixels=cam_cfg["height"] * cam_cfg["width"],
                  rows=int(ckpt["gaussian.xyz"].shape[0]))
             for i, pose, _, _ in (frames if ctx.trace else [])]
    ref_s = time.perf_counter() - t_ref
    times = np.array([f[2] for f in frames])
    e2e = {"frame_ms": window_s / len(frames) * 1e3,
           "frame_p95_ms": float(np.percentile(times, 95)) * 1e3,
           "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    return {"e2e": e2e, "numbers": numbers, "rows": rows,
            "attempted": len(frames),
            "peak_bytes": peak, "ref_s": ref_s,
            "layer": {"kind": "view", "frames": frames, "works": works,
                      "sh_degree": cfg["model"]["gaussian"]["sh_degree"],
                      "trace": prof.trace if ctx.trace else None}}


def loop_cull_pose(i: int, cfg: dict, cams) -> int:
    """The pose of the frame that last refreshed the program's root cull
    before frame i: it refreshes every check_render_every frames."""
    every = cfg.get("state", {}).get("check_render_every", 1)
    return ((i // every) * every) % len(cams)

