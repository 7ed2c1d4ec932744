#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (log_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA device and nvcc; exits non-zero without them. Phases:

1. header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the kernel build from log_tpu_torch/csrc (nvcc, sm_90a);
2. setup: a 600k-root synthetic LoD tree (3.24M points, from a numpy seed)
   loaded through load_object -> LoG.load_state_dict, with the model args
   of config/synthetic/level_of_gaussian.yml;
3. kernels vs plain: the first frame of a 1920x1088 orbit is rendered once
   while the inputs of every kernel call are recorded; each CUDA kernel is
   then replayed on those main-path inputs against its plain torch version
   (K4 and K3 bit-exact, K1 within the tolerances below), both timed;
4. slice: launch counters reset, 12 orbit frames through
   NaiveRendererAndLoss.vis -> LoG.render_fused (2 warm-up), timed with
   torch.cuda.synchronize(); every kernel must have launched;
5. checks: the frames are finite, of the expected shape and not blank;
   frame 0 rendered again with the plain versions agrees with the kernels;
   a small tree rendered through the kernels agrees with the oracle
   rasterizer (rasterize_ref) on the same card.

The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

import numpy as np

N_ROOTS = 600_000
H, W = 1088, 1920
FRAMES, WARMUP = 12, 2
SEED = 0
# model.args of config/synthetic/level_of_gaussian.yml without init_ply
MODEL_ARGS = {
    "use_view_correction": True,
    "gaussian": {"xyz_scale": 1.0, "sh_degree": 1},
    "optimizer": {
        "optimize_keys": ["xyz", "colors", "scaling", "opacity", "rotation",
                          "shs"],
        "opt_all_levels": True,
        "lr_dict": {"xyz": 0.00016, "xyz_final": 0.0000016, "xyz_scale": 1.0,
                    "colors": 0.0025, "shs": 0.000125, "scaling": 0.005,
                    "opacity": 0.05, "rotation": 0.001, "max_steps": 600},
    },
    "tree": {"max_child": 4, "max_level": 30},
    "densify_and_remove": {
        "upgrade_sh_iter": 10, "densify_from_iter": 1, "densify_every_iter": 1,
        "upgrade_repeat": 2, "init_split_method": "split_by_2d",
        "init_radius_min": 4, "init_radius_split": 16, "init_weight_min": 0.1,
        "min_steps": 50, "method": "naive", "split_grad_thres": 0.0002,
        "radius2d_thres": 6, "remove_weights_thres": 0.005,
        "max_split_points": 20000, "sort_method": "radii",
        "min_steps_split": 100, "scaling_decay": 0.9,
    },
}
CAMERA_KEYS = ("camera_center", "world_view_transform", "full_proj_transform",
               "image_width", "image_height", "FoVx", "FoVy", "K", "R", "T")
# K1 tolerances, kernel (sequential per pixel) vs plain (cumprod per chunk):
# products differ in rounding, so a pair can cross the alpha >= 1/255 or
# T >= 1e-4 gate in one and not the other, moving a pixel by <= ~1/255
K1_MAX_ABS = 1e-2
K1_MEAN_ABS = 1e-4
K1_MISMATCH = 1e-2  # share of pixels / pairs whose argmax id or weight differ
# the kernel frame against the plain frame and the small oracle check
FRAME_MAX_ABS = 2.0 / 255.0 + 1e-6  # after 8-bit quantization
ORACLE_MAX_ABS = 2e-2
ORACLE_MEAN_ABS = 1e-3
KERNEL_SOURCES = {
    "pack_rows": ("log_tpu_torch/csrc/pack.cu",
                  "log_tpu/ops/rasterize_tiled.py:265"),
    "expand_with_keys": ("log_tpu_torch/csrc/expand.cu",
                         "log_tpu/ops/expand_pallas.py:65"),
    "rasterize_fwd": ("log_tpu_torch/csrc/rasterize_fwd.cu",
                      "log_tpu/ops/rasterize_tiled.py:793"),
}


def make_cam(theta, height=18.0, radius=22.0, h=H, w=W, focal=1400.0):
    """Orbit camera of bench.py, looking at the scene center."""
    pos = np.array([radius * math.cos(theta), radius * math.sin(theta), height])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, np.array([0, 0, 1.0]))
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    R = np.stack([right, up, fwd])
    T = (-R @ pos).reshape(3, 1)
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    return {"K": K, "R": R, "T": T, "H": h, "W": w, "center": pos.reshape(3, 1)}


def orbit_batches(n, h=H, w=W, focal=1400.0):
    from log_tpu_torch.dataset.base import prepare_camera

    batches = []
    for i in range(n):
        pc = prepare_camera(make_cam(2 * math.pi * i / (n + 2), h=h, w=w,
                                     focal=focal), 1, 0.01, 1000.0)
        batches.append({"camera": {k: np.asarray(pc[k])[None]
                                   for k in CAMERA_KEYS}})
    return batches


def build_model(n_roots, device):
    from log_tpu_torch.utils.config import load_object
    from log_tpu_torch.utils.synth_tree import build_checkpoint

    ckpt = build_checkpoint(n_roots, seed=SEED)
    model = load_object("LoG.model.level_of_gaussian.LoG", MODEL_ARGS,
                        device=device)
    model.load_state_dict(ckpt)
    model.set_state(enable_sh=True)
    model.eval()
    return model


@contextlib.contextmanager
def patched(module, replacements):
    """Temporarily replace module attributes (kernel wrappers)."""
    saved = {name: getattr(module, name) for name in replacements}
    for name, fn in replacements.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def plain_versions():
    from log_tpu_torch.ops import rasterize_tiled as rt
    from log_tpu_torch.ops.expand import expand_with_keys_plain

    return patched(rt, {"pack_rows": rt.pack_rows_plain,
                        "expand_with_keys": expand_with_keys_plain,
                        "rasterize_forward": rt.rasterize_forward_plain})


def record_kernel_inputs(model, renderer, batch):
    """Render one frame, recording the arguments of every kernel call."""
    from log_tpu_torch.ops import rasterize_tiled as rt

    calls = {"pack_rows": [], "expand_with_keys": [], "rasterize_fwd": []}

    def recorder(name, fn):
        def call(*args, **kwargs):
            calls[name].append((args, kwargs))
            return fn(*args, **kwargs)
        return call

    with patched(rt, {
        "pack_rows": recorder("pack_rows", rt.pack_rows),
        "expand_with_keys": recorder("expand_with_keys", rt.expand_with_keys),
        "rasterize_forward": recorder("rasterize_fwd", rt.rasterize_forward),
    }):
        renderer.vis(batch, model)
    return calls


def device_ms(fn, reps):
    """Mean device milliseconds of fn over reps runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _bits(t):
    import torch

    return t.contiguous().view(-1).view(torch.int32)


def compare_kernels(calls, log):
    """Replay the recorded main-path calls through each kernel and its plain
    version. Returns the kernel rows of the final JSON (launches filled in
    later) and a list of failures."""
    import torch

    from log_tpu_torch.ops import rasterize_tiled as rt
    from log_tpu_torch.ops.expand import (expand_with_keys,
                                          expand_with_keys_plain)

    rows, failures = {}, []

    # K4: bit-exact
    args, kw = calls["pack_rows"][-1]
    k = rt.pack_rows(*args, **kw)
    p = rt.pack_rows_plain(*args, **kw)
    err = float((k - p).abs().max())
    exact = torch.equal(_bits(k), _bits(p))
    ms = device_ms(lambda: rt.pack_rows(*args, **kw), 10)
    pms = device_ms(lambda: rt.pack_rows_plain(*args, **kw), 10)
    log(f"K4 pack_rows      shape {tuple(k.shape)}: exact={exact} "
        f"max_abs={err:.3g} kernel {ms:.4f} ms, plain {pms:.4f} ms")
    if not exact:
        failures.append("K4 pack_rows is not bit-exact")
    rows["pack_rows"] = {"max_abs_err": err, "ms": ms, "plain_ms": pms}

    # K3: bit-exact, including the tail past `total`
    args, kw = calls["expand_with_keys"][-1]
    k = expand_with_keys(*args, **kw)
    p = expand_with_keys_plain(*args, **kw)
    exact = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(k, p))
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(k, p))
    ms = device_ms(lambda: expand_with_keys(*args, **kw), 10)
    pms = device_ms(lambda: expand_with_keys_plain(*args, **kw), 10)
    total = int(args[2].reshape(()))
    log(f"K3 expand         A={args[3]} P={args[0].shape[1]} total={total}: "
        f"exact={exact} max_abs={err:.3g} kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms")
    if not exact:
        failures.append("K3 expand_with_keys is not bit-exact")
    rows["expand_with_keys"] = {"max_abs_err": err, "ms": ms, "plain_ms": pms}

    # K1: the cull render's call ("weights") and the frame's call (False),
    # plus full stats on the frame's pairs
    by_mode = {}
    for args, kw in calls["rasterize_fwd"]:
        by_mode[args[6]] = args[:6]
    cases = [("weights", by_mode["weights"]), (False, by_mode[False]),
             (True, by_mode[False])]
    k1_err, k1_ms, k1_pms = 0.0, None, None
    for mode, a in cases:
        k = rt.rasterize_forward(*a, mode)
        p = rt.rasterize_forward_plain(*a, mode)
        d_col = (k[0] - p[0]).abs()
        d_t = (k[1] - p[1]).abs()
        err = max(float(d_col.max()), float(d_t.max()))
        mean = max(float(d_col.mean()), float(d_t.mean()))
        pid_mis = float((k[2] != p[2]).float().mean())
        pw_mis = float(((k[4] - p[4]).abs() > 1e-5).float().mean())
        log(f"K1 rasterize_fwd  with_stats={mode!r} pairs={a[0].shape[1]}: "
            f"color/tfinal max_abs={err:.3g} mean_abs={mean:.3g} "
            f"pid mismatch={pid_mis:.3g} pair_w mismatch={pw_mis:.3g} "
            f"pwp max_abs={float((k[3] - p[3]).abs().max()):.3g} "
            f"cend equal={torch.equal(k[5], p[5])}")
        if err > K1_MAX_ABS or mean > K1_MEAN_ABS or pid_mis > K1_MISMATCH \
                or pw_mis > K1_MISMATCH:
            failures.append(f"K1 with_stats={mode!r} disagrees with plain")
        k1_err = max(k1_err, err)
        if mode is False:
            k1_ms = device_ms(lambda: rt.rasterize_forward(*a, mode), 10)
            k1_pms = device_ms(lambda: rt.rasterize_forward_plain(*a, mode), 2)
            log(f"K1 rasterize_fwd  with_stats=False: kernel {k1_ms:.4f} ms, "
                f"plain {k1_pms:.4f} ms")
    rows["rasterize_fwd"] = {"max_abs_err": k1_err, "ms": k1_ms,
                             "plain_ms": k1_pms}
    return rows, failures


def run_slice(model, renderer, batches, log):
    """The timed orbit: returns (per-frame ms list, renders, telemetry)."""
    import torch

    from log_tpu_torch.ops import kernels

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    renders, frame_ms, telemetry = [], [], []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = renderer.vis(batch, model)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        stats = model.frame_stats()
        telemetry.append({"frame": i, "ms": ms, **stats})
        if i >= WARMUP:
            frame_ms.append(ms)
        renders.append(out["render"][0])
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"slice: {len(batches)} frames ({WARMUP} warm-up), per-frame ms "
        + " ".join(f"{t['ms']:.2f}" for t in telemetry))
    return frame_ms, renders, telemetry, launches, peak


def oracle_check(device, log):
    """A small tree through the kernels against the oracle backend, on the
    same device. Returns (max_abs, mean_abs)."""
    import torch

    from log_tpu_torch.dataset.base import prepare_camera
    from log_tpu_torch.model.train_step import fused_prepare_render
    from log_tpu_torch.ops import pick_max_pairs
    from log_tpu_torch.render.renderer import camera_device

    model = build_model(2000, device)
    h, w = 128, 256
    pc = prepare_camera(make_cam(0.4, h=h, w=w, focal=160.0), 1, 0.01, 1000.0)
    cam = camera_device(pc, device)
    bg = torch.tensor([0.1, 0.2, 0.3], device=device)
    common = dict(
        params=model.gaussian.params(), tree_arrays=model.tree_device(),
        cam=cam, n_alive=model.num_points, is_leaf_opt=model._leaf_opt_dev,
        min_resolution_pixel=model.tree.min_resolution_pixel,
        current_depth=model.current_depth, background=bg, image_height=h,
        image_width=w, k_visible=model.capacity, sh_degree=1,
        stage_has_tree=True, num_levels=3, n_roots=model.n_roots_bucket,
        max_pairs=pick_max_pairs(model.capacity, 6),
        prep_max_pairs=pick_max_pairs(model.capacity, 1),
    )
    tiled = fused_prepare_render(backend="tiled", prep_backend="tiled",
                                 **common)
    ref = fused_prepare_render(backend="reference", prep_backend="reference",
                               **common)
    d = (tiled[0] - ref[0]).abs()
    log(f"oracle check {h}x{w}, {model.num_points} points: cut "
        f"{tiled[2].tolist()} vs {ref[2].tolist()}, render max_abs "
        f"{float(d.max()):.3g} mean_abs {float(d.mean()):.3g}")
    return float(d.max()), float(d.mean())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss

    def log(msg):
        print(msg, flush=True)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    build_s = kernels.build(force=True)
    log(f"kernel build (nvcc, sm_90a): {build_s:.2f} s")
    for line in kernels.build_log.splitlines():
        if "Used" in line or "error" in line:
            log("  ptxas: " + line.strip())

    device = "cuda"
    t0 = time.perf_counter()
    model = build_model(N_ROOTS, device)
    renderer = NaiveRendererAndLoss(split="demo", device=device)
    batches = orbit_batches(FRAMES)
    torch.cuda.synchronize()
    log(f"setup: {model.num_points} points, capacity {model.capacity}, "
        f"{time.perf_counter() - t0:.2f} s")

    failures = []
    calls = record_kernel_inputs(model, renderer, batches[0])
    rows, kfail = compare_kernels(calls, log)
    failures += kfail
    del calls

    frame_ms, renders, telemetry, launches, peak = run_slice(
        model, renderer, batches, log
    )
    last = telemetry[-1]
    log(f"slice: mean frame {np.mean(frame_ms):.3f} ms (min "
        f"{np.min(frame_ms):.3f}, max {np.max(frame_ms):.3f}) over "
        f"{len(frame_ms)} frames; last frame: cut {last['cut']} points, "
        f"slice bucket {last['k_visible']}, pair demand "
        f"{last['pair_total']} (budget {last['max_pairs']}); peak memory "
        f"{peak / 2**30:.3f} GiB; launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            failures.append(f"kernel {name} never launched on the main path")

    img = np.stack(renders)
    if img.shape != (FRAMES, 3, H, W) or not np.isfinite(img).all():
        failures.append(f"bad frames: shape {img.shape}")
    if float(img.std()) < 1e-3 or float(img.max()) <= 0.0:
        failures.append("frames are blank")

    # frame 0 again with every kernel replaced by its plain version
    with plain_versions():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = renderer.vis(batches[0], model)["render"][0]
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
    kern = renderer.vis(batches[0], model)["render"][0]
    frame_diff = float(np.abs(plain - kern).max())
    log(f"frame 0 plain versions: {plain_ms:.2f} ms, max |plain - kernels| "
        f"{frame_diff:.4g} (8-bit frames)")
    if frame_diff > FRAME_MAX_ABS:
        failures.append(f"plain frame differs by {frame_diff}")

    o_max, o_mean = oracle_check(device, log)
    if o_max > ORACLE_MAX_ABS or o_mean > ORACLE_MEAN_ABS:
        failures.append(f"small tree disagrees with the oracle: {o_max}")

    log(json.dumps({
        "slice": {"frame_ms_mean": float(np.mean(frame_ms)),
                  "frame_ms": frame_ms, "plain_frame_ms": plain_ms,
                  "frames": telemetry, "peak_bytes": peak,
                  "build_s": build_s}
    }))
    kernels_json = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        kernels_json.append({"name": name, "route": "cuda", "source": src,
                             "replaces": replaces,
                             "launches": launches[name], **rows[name]})
    if failures:
        for f in failures:
            print("FAIL: " + f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
