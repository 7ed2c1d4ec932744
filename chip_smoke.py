#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (log_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Needs a CUDA device and nvcc; exits non-zero without them. Phases:

1. header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the kernel build from log_tpu_torch/csrc (nvcc, sm_90a);
2. setup: a 600k-root synthetic LoD tree (3.24M points, from a numpy seed)
   loaded through load_object -> LoG.load_state_dict, with the model args
   of config/synthetic/level_of_gaussian.yml;
3. kernels vs plain: the first frame of a 1920x1088 orbit is rendered once
   (the generic flat-cut frame) while the inputs of every kernel call are
   recorded; each CUDA kernel is then replayed on those main-path inputs
   against its plain torch version (K4 and K3 bit-exact, K1 within the
   tolerances below, in each with_stats mode), both timed, beside its
   bound: bytes over the memory rate or FP32 operations over the peak,
   from this run's inputs (for K1, K2 and K5 the pairs of the composited
   chunks and the (pair, pixel) combinations whose alpha gate passes,
   counted on the card in plain torch);
4. serving slice: launch counters reset, 12 orbit frames through
   NaiveRendererAndLoss.vis -> LoG.render_fused (2 warm-up), timed with
   torch.cuda.synchronize(); every kernel of the path must have launched;
5. serving checks: the frames are finite, of the expected shape and not
   blank; frame 0 rendered again with the plain versions agrees with the
   kernels;
   then, on the same model with tree.cut_method = "flat_slice":
   a. flat_slice frames: frame 0's K3p and K5 inputs replayed against their
      plain versions (K3p bit-exact, K5 within K1's tolerances) and every
      K4 pack of that frame bit-exact, both timed (K5 also by the profiler:
      the device time of its own launch); 12 orbit frames (the
      weight cull every frame), K5 once per frame; frame 0 with the plain
      versions, and against the generic frame 0 within the JAX package's
      cross-path bounds (|cut difference| <= max(64, 2%), PSNR > 35 dB);
   b. the same frames with LOG_TPU_COMPACT=pallas: K6 bit-exact against its
      plain version on frame 0's inputs (timed by events and by the
      profiler, one launch per call), once per frame, and frames
      bit-identical to a.'s;
   c. block-pruned frames: a reference frame 0 at SH degree 0, then
      LoG.optimize_render_layout() and check_render_every=4, 12 orbit
      frames that must all take the block path (4 counts), frame 0 against
      the reference within the cross-path bounds;
   finally a small tree rendered through the kernels agrees with the oracle
   rasterizer (rasterize_ref) on the same card;
6. training setup: the same tree loaded with split="train" (zero Adam
   moments, the counter's radius bounds), base_iter 20 as in
   config/synthetic/train.yml, training_setup; ground truth: 4 orbit views
   rendered by the unperturbed tree (render_fused, 8-bit); then the colors
   and opacities are perturbed from a seeded torch.Generator;
7. training slice: launch counters reset, 24 steps of
   Trainer.training_step -> LoG.training_iteration cycling the 4 views with
   a random background (steps 21-24 run the per-view gain), each timed with
   torch.cuda.synchronize(); K2 must launch once per step, K1 at least twice;
8. training checks: K2 against its plain version on step 0's own inputs
   (and two launches bit-identical), K1 on step 0's "weights" and True
   calls;
   step 0 replayed from its saved inputs with every kernel swapped for its
   plain version (same loss, same per-gaussian gradients, read from the
   first Adam moments); every parameter and moment finite after each step;
   the loss of the last 4 steps below that of the first 4; the counters
   filled on the kept rows;
9. growth: the trained tree, with current_depth 20 (what upgrade_tree
   sets) and min_steps_split 0, densified once by update_depth_stage on the
   device path (timed, with the peak memory), held against the host path
   run on a second model loaded from the same snapshot (tree arrays equal,
   params, moments and counters to 1e-5 / 1e-6); then 4 more steps (K2
   once per step, K1 at least twice, the state finite), step 0's kernel
   calls held against the plain versions;
   then, on a fresh copy of the training tree:
   a. depth_step: GT frames and GT depth maps of the unperturbed tree
      (NaiveRendererAndLoss.vis with render_depth: the inverse depth,
      normalized and quantized to 16 bits as a DepthDataset map reads), the
      same perturbation, 24 steps of Trainer.training_step with
      render_depth (a second render of (camera depth, world z, 1) through
      K4, K3, K1 without stats, and K2 in the backward); step 0's kernel
      calls (copies) held against the plain versions right after it (K1's
      three modes, both K2 calls) and step 0 replayed with every kernel
      plain; every step must launch K2 twice and K1, K3, K4 at least
      twice, the depth term and the state stay finite, the loss of the
      last 8 steps must be below that of the first 8; the timed window
      and the peak are steps 1-23;
   b. spill: from the snapshot taken before a.'s first step, 12 steps
      (prepare_from_camera + LoG.train_step, LOG_TPU_IDENTITY_STEP=0, fixed
      backgrounds) on the device path, then the same 12 with both moment
      kinds spilled by maybe_spill into pinned host memory: parameters,
      moments and counters equal bit for bit (else held at rtol 1e-5, atol
      2e-6), the host gather's index the step's own, the peak device memory
      (utils/hbm.call_stats) lower by at least 90% of the moments' bytes;
      then a host-path update_depth_stage of the spilled model (the host
      moments at the new capacity, still pinned) and 2 more steps;
10. two stages: the scene's 600k roots written as a PLY (write_ply) and
   loaded through GaussianPoint(init_ply=...) (init_opacity 0.1), the init
   pass over the 4 views at scale 4, then stages init (4 x 20 steps at
   480x272) and tree (6 x 20 at 960x544) of config/synthetic/train.yml,
   each step followed by update_by_iteration, GT from the unperturbed tree;
   the schedule must fire exactly EXPECTED_EVENTS, every step must launch
   K4, K3, K1 and K2 and stay finite, the tree stage's loss must fall; the
   first init densify (device path) is held against the host path on the
   same snapshot and rand_u; the first step after each densify has its
   kernel calls held against the plain versions;
11. grown frame: one generic 1920x1088 frame of the grown model, held
   against its all-plain rerun, its kernel calls against the plain
   versions, and the device caches at the new capacity;
12. cli: a probe of the optional host packages (cv2, PIL, yaml,
   torchvision, ffmpeg); the config/synthetic_conv scene (20,000
   Gaussians, 36 views at 256x320, .png) made on the card by
   log_tpu_torch.apps.make_synthetic_scene; its full schedule (init 144,
   tree 720, tree_full 288 steps, validation every 360) through
   log_tpu_torch.apps.train under output/chip_cli (every step must launch
   K4, K3, K1 and K2, every validation render K4, K3 and K1 without stats;
   the stage checkpoints and their _wotrain twins written; the loss of the
   last 72 steps of init and of tree below that of their first 72); the
   same call again, which must resume-skip every stage; final_val (at
   least 20 dB and SSIM 0.8; the JAX package's 27.33 / 0.941 and 28.38 /
   0.952 and its curve printed beside, from a .jpg scene); demo_interpolate
   on the flat_slice frame (60 frames after 11 warm-up, K4 and K5
   launched) and val (3 gt / renders dumps). Each sub-phase's launches are
   split into those of its steps, validation views (prepare_from_camera's
   cull render and render_one) and eval-mode frames, each counted in the
   run. Held against the plain versions on copies of
   their own inputs: the first step after a densify in init and in tree
   (K4, K3, K1 cull and full stats, K2), the first validation render of
   training and of final_val, the demo's first timed frame (K4, K3, K1,
   K5, and K3p where it ran) and val's first frame;
13. cli_depth: 16-bit inverse-depth maps of the cli scene's views at its
   scale 4 (64x80), rendered by the oracle from the scene's generator
   Gaussians; the same schedule through log_tpu_torch.apps.train with
   config/example/test/train_wdepth.yml's overrides (dataset.module
   DepthDataset, depth_scale 4, render_depth True) under
   output/chip_cli_depth: every step must have a finite depth term and
   launch K2 twice and K1, K3, K4 at least twice, the loss of init and
   tree must fall; final_val (at least 20 dB / 0.8, beside the plain cli
   run's); demo_interpolate with render_type depth and then height (60
   frames, none constant, the first equal to marigold_depth_vis of vis's
   map); the first tree step after a densify held against the plain
   versions (K1 without stats and both K2 calls among them).
With --profile, 4 more frames of the generic, flat_slice and block phases
and 4 more training steps run under torch.profiler, each after its timed
run, and 4 steps of the cli run's tree stage (steps 600-603) are traced in
place; the device time by kernel goes to build/{generic,flat_slice,block,
train,cli_train}_profile.txt.

The line before the last is the kernel table as JSON (per kernel: launches
by phase and per call, max_abs_err, ms, plain_ms, bound_ms, bound_by,
library_ms, null where no single PyTorch call computes the function, with
library_note; for K5 and K6 also device_ms, the profiler's device time of
the kernel's own launches, where ms also holds the host's gaps between
calls); the last line is {"ok": true, "device": {...}}.
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
# training phases: 4 orbit views seen from higher and closer than the
# serving orbit, so that the ground fills every frame
TRAIN_VIEWS, TRAIN_STEPS, BASE_ITER = 4, 24, 20
TRAIN_RADIUS, TRAIN_HEIGHT = 14.0, 22.0
PROFILE_STEPS = 4
# K2 vs plain: per-pair gradients, max |kernel - plain| / max |plain|
K2_REL_TOL = 1e-3
# step 0 with the kernels vs with the plain versions: per-gaussian
# gradients (first Adam moments) relative to the kernel step's largest,
# and the loss
STEP_GRAD_REL_TOL = 1e-3
STEP_LOSS_TOL = 1e-4
# the same with render_depth: the depth term's gradient passes through
# 1 / (depth + 1e-5) and the closed-form scale-and-shift fit, whose
# determinant cancels (ROADMAP fact ae), so K1's sequential rounding
# (1.4e-4 on depths up to 32) reaches the per-gaussian gradients amplified
# (xyz 1.38e-3 of its largest on an H100 at 700 W; 7.9e-4 without depth)
DEPTH_STEP_GRAD_REL_TOL = 5e-3
KERNEL_SOURCES = {
    "pack_rows": ("log_tpu_torch/csrc/pack.cu",
                  "log_tpu/ops/rasterize_tiled.py:265"),
    "expand_with_keys": ("log_tpu_torch/csrc/expand.cu",
                         "log_tpu/ops/expand_pallas.py:65"),
    "rasterize_fwd": ("log_tpu_torch/csrc/rasterize_fwd.cu",
                      "log_tpu/ops/rasterize_tiled.py:793"),
    "rasterize_bwd": ("log_tpu_torch/csrc/rasterize_bwd.cu",
                      "log_tpu/ops/rasterize_tiled.py:1370"),
    "expand_packed": ("log_tpu_torch/csrc/expand.cu",
                      "log_tpu/ops/expand_pallas.py:238"),
    "rasterize_fwd_packed": ("log_tpu_torch/csrc/rasterize_fwd.cu",
                             "log_tpu/ops/rasterize_tiled.py:1094"),
    "stream_compact": ("log_tpu_torch/csrc/compact.cu",
                       "log_tpu/ops/compact_pallas.py:48"),
}
# the bound of a kernel (bound_ms): the larger of its bytes (each input
# read once, each output written once) over the memory rate and its
# operations over the FP32 peak; NVIDIA's data sheet for the H100 SXM at
# 700 W (the card's own limit is printed beside)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS = 67e12
# FP32 operations per (pair, pixel) whose alpha gate passes, expf counted
# as one: K1 and K5 (power 8, alpha 2, transmittance 3, color 6), K2 (the
# recurrence and the nine gradient terms)
COMPOSITE_OPS = 20
BACKWARD_OPS = 40
# no single PyTorch call computes these functions (library_ms is null)
NO_LIBRARY_CALL = {
    "pack_rows": "none: zero rows and the spare columns are part of the "
                 "output (a stack and a pad)",
    "expand_with_keys": "none: it decodes (tile, depth) keys per pair",
    "expand_packed": "none: it decodes (tile, depth) keys per pair",
    "rasterize_fwd": "none: sequential compositing with a per-tile "
                     "saturation exit",
    "rasterize_bwd": "none: the compositing recurrence run back to front",
    "rasterize_fwd_packed": "none: sequential compositing of bf16 records",
    "stream_compact": "none: its output is zero-filled to k",
}
SERVING_KERNELS = ("pack_rows", "expand_with_keys", "rasterize_fwd")
# the flat_slice frame: the root cull render (K3, K4, K1) and the packed
# column render (K4, K3p, K5)
FLAT_KERNELS = SERVING_KERNELS + ("expand_packed", "rasterize_fwd_packed")
BLOCK_KERNELS = ("pack_rows", "expand_packed", "rasterize_fwd_packed")
# flat_slice and block frames against another path's frame of the same
# camera: the JAX package's cross-path bounds (tests/test_block_render.py)
CROSS_PATH_PSNR = 35.0
CHECK_RENDER_EVERY = 4
PROFILE = "--profile" in sys.argv[1:]
# growth phases: steps after the 3.24M-point densify; the two stages of
# config/synthetic/train.yml (name, iterations in units of base_iter,
# model_state, dataset scale) and the schedule events they must fire
GROWTH_STEPS = 4
STAGES = (("init", 4, {}, 4), ("tree", 6, {"enable_sh": True}, 2))
EXPECTED_EVENTS = {
    "init": ((19, "reset"), (39, "init_densify"), (59, "init_densify")),
    "tree": ((19, "reset"), (39, "upgrade_tree"), (59, "reset"),
             (79, "depth_densify"), (99, "reset")),
}
STEP_KERNELS = ("pack_rows", "expand_with_keys", "rasterize_fwd",
                "rasterize_bwd")
PLY_PATH = "build/chip_smoke_roots.ply"
# the cli phase: the config/synthetic_conv scene (BASELINE.md:37) made on
# the card, and its full schedule through the port's CLI
CLI_SCENE = "output/chip_scene"
CLI_EXP = "output/chip_cli/log"
CLI_CFG = "config/synthetic_conv/train.yml"
CLI_SCENE_ARGS = [CLI_SCENE, "20000", "36", "256", "320", ".png"]
CLI_OPTS = ["root", CLI_SCENE, "PLYNAME", CLI_SCENE + "/sparse/0/sparse.npz",
            "exp", CLI_EXP, "dataset.args.ext", ".png",
            "val_dataset.args.ext", ".png"]
# the demo on the flat_slice frame, so that it runs the packed kernels
CLI_DEMO_OPTS = ["model.args.tree.cut_method", "flat_slice"]
CLI_DEMO_FRAMES, CLI_DEMO_WARMUP = 60, 11
CLI_DEMO_KERNELS = ("pack_rows", "rasterize_fwd_packed")
# the eval-mode frame held against the plain versions, by sub-phase: the
# demo's first timed frame and val's first
CLI_HELD_FRAME = {"demo": CLI_DEMO_WARMUP, "val": 0}
CLI_LOSS_WINDOW = 72  # the config's log_interval
CLI_MIN_PSNR, CLI_MIN_SSIM = 20.0, 0.8
CLI_VAL_KEYS = ("iteration", "num_points", "l1", "psnr", "ssim")
# the JAX package's final-val on this config (BASELINE.md:210-218)
CLI_JAX_FINAL = {"tiled": [27.33, 0.941], "oracle": [28.38, 0.952]}
CLI_JAX_CURVE = "artifacts/r4_quality/scalars.jsonl"
# optional host packages the cli phase runs without
CLI_BLOCKED = ("cv2", "PIL", "yaml", "torchvision")
# --profile: the cli run's steps from this one on (in its tree stage)
CLI_PROFILE_AT = 600
# host path against device path after one densify (tests/test_densify_device.py)
DENSIFY_RTOL, DENSIFY_ATOL = 1e-5, 1e-6
# depth_step: the training phase's tree and views with a depth map per view
# (the unperturbed tree's inverse depth, 16-bit) and render_depth on; the
# loss of the first and the last DEPTH_LOSS_WINDOW steps
DEPTH_STEPS, DEPTH_LOSS_WINDOW = 24, 8
# spill: SPILL_STEPS steps on the device path and again with both moment
# kinds in pinned host memory, from one snapshot; equal bit for bit, else
# held at tests/test_spill.py's tolerances; the spilled run's peak at
# least SPILL_MEMORY_SHARE of the moments' bytes under the device run's;
# then a host-path densify and SPILL_AFTER_DENSIFY more steps
SPILL_STEPS, SPILL_AFTER_DENSIFY = 12, 2
SPILL_RTOL, SPILL_ATOL = 1e-5, 2e-6
SPILL_MEMORY_SHARE = 0.9
# cli_depth: the cli scene with 16-bit inverse-depth maps at the coarsest
# scale (as config/example/test/train_wdepth.yml takes its scale 8 of
# [1, 2, 4, 8]); the overrides reach train.dataset and train.render
# through their $dataset and $RGB_RENDER_L1_SSIM substitution
CLI_DEPTH_EXP = "output/chip_cli_depth/log"
CLI_DEPTH_SCALE = 4
CLI_DEPTH_OPTS = ["dataset.module", "LoG.dataset.colmap.DepthDataset",
                  "dataset.args.depth_scale", str(CLI_DEPTH_SCALE),
                  "RGB_RENDER_L1_SSIM.args.render_depth", "True"]
# the demo's depth and height maps normalized over the scene's range (its
# Gaussians lie in [-1, 1]^3, the cameras 4 from the center)
CLI_DEPTH_RANGES = {"depth": (2.0, 6.0), "height": (-1.0, 1.0)}


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


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper replaced by its plain torch version (the
    autograd functions around them look the wrappers up at call time)."""
    from log_tpu_torch.ops import expand as ex
    from log_tpu_torch.ops import rasterize_tiled as rt

    from log_tpu_torch.ops import compact

    with patched(ex, {"expand_with_keys": ex.expand_with_keys_plain,
                      "expand_packed_with_keys":
                          ex.expand_packed_with_keys_plain}), \
            patched(rt, {"pack_rows": rt.pack_rows_plain,
                         "rasterize_forward": rt.rasterize_forward_plain,
                         "rasterize_backward": rt.rasterize_backward_plain,
                         "rasterize_forward_packed":
                             rt.rasterize_forward_packed_plain}), \
            patched(compact, {"stream_compact_cols":
                              compact.stream_compact_cols_plain}):
        yield


def _copied(x):
    """x with every tensor in it (in lists, tuples and dicts) detached and
    cloned."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_copied(v) for v in x)
    return x


@contextlib.contextmanager
def recording(calls, copy=False):
    """Record the arguments of every kernel wrapper call into calls[name]
    (with copy, copies of them, which later calls cannot overwrite)."""
    from log_tpu_torch.ops import expand as ex
    from log_tpu_torch.ops import rasterize_tiled as rt

    def recorder(name, fn):
        def call(*args, **kwargs):
            calls.setdefault(name, []).append(
                _copied((args, kwargs)) if copy else (args, kwargs))
            return fn(*args, **kwargs)
        return call

    from log_tpu_torch.ops import compact

    with patched(ex, {
                "expand_with_keys": recorder("expand_with_keys",
                                             ex.expand_with_keys),
                "expand_packed_with_keys": recorder(
                    "expand_packed", ex.expand_packed_with_keys),
            }), \
            patched(rt, {
                "pack_rows": recorder("pack_rows", rt.pack_rows),
                "rasterize_forward": recorder("rasterize_fwd",
                                              rt.rasterize_forward),
                "rasterize_backward": recorder("rasterize_bwd",
                                               rt.rasterize_backward),
                "rasterize_forward_packed": recorder(
                    "rasterize_fwd_packed", rt.rasterize_forward_packed),
            }), \
            patched(compact, {"stream_compact_cols": recorder(
                "stream_compact", compact.stream_compact_cols)}):
        yield calls


def record_kernel_inputs(model, renderer, batch):
    """Render one frame, recording the arguments of every kernel call."""
    with recording({}) as calls:
        renderer.vis(batch, model)
    return calls


def device_ms(fn, reps):
    """Mean milliseconds of fn over reps runs, after one warm-up, between
    two CUDA events: the device time of its launches and any gaps the host
    leaves between them (see kernel_device_ms)."""
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


def _self_device_us(e):
    """A profiler row's own device microseconds (the attribute's name
    differs between torch versions)."""
    us = getattr(e, "self_device_time_total", None)
    return e.self_cuda_time_total if us is None else us


PROFILE_PAD_S = 0.05  # idle host time at each end of a profiled window
PROFILE_TRIES = 3


def kernel_device_ms(fn, reps, kernel, log=print):
    """(ms, launches) per call of fn: the device time of the CUDA kernels
    whose name holds `kernel`, over reps calls under torch.profiler after
    one warm-up, and their launch count; without the host's gaps.

    The profiler keeps only the device records that fall inside its capture
    window, on timestamps converted from the card's clock to the host's: a
    window of a few short kernels can lose all of them (a K6 window of
    10 x 0.06 ms once reported 0 launches). So the calls sit between two
    idle pads, and a window that holds none of the kernel's launches is
    taken again, up to PROFILE_TRIES times, each retry logged with the
    device records the window did hold."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        rows = [e for e in dev if kernel in e.key]
        if rows or attempt == PROFILE_TRIES:
            break
        log(f"profiler window {attempt} of {PROFILE_TRIES} held no "
            f"'{kernel}' launch in {reps} calls; device records: "
            f"{[(e.key[:60], e.count) for e in dev][:8]}; taking it again")
    return (sum(_self_device_us(e) for e in rows) / 1e3 / reps,
            sum(e.count for e in rows) / reps)


def _bits(t):
    import torch

    return t.contiguous().view(-1).view(torch.int32)


def tensor_bytes(x):
    """Bytes of every tensor in x (a tensor, or lists, tuples and dicts of
    them)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return sum(tensor_bytes(v) for v in x)
    return 0


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the FP32 operations over the FP32 peak."""
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    o_ms = ops / PEAK_FP32_OPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def composite_counts(pair_data, tile_start, tile_count, n_walk, tiles_x,
                     packed=False, batch=256):
    """(pairs, dense, gated) of a compositing call (K1, K2, K5), in plain
    torch on the card; a measurement helper, not on the path. pairs: the
    run pairs inside the chunks walked (n_walk per tile: cend); dense:
    pairs x 1024 pixels; gated: the (pair, pixel) combinations whose alpha
    gate passes, in the plain versions' op order."""
    import torch

    from log_tpu_torch.ops import rasterize_tiled as rt

    dev = pair_data.device
    chunk, tw, th = rt.PAIR_CHUNK, rt.TILE_W, rt.TILE_H
    start = tile_start.long()
    end = start + tile_count.long()
    off0 = start // chunk * chunk
    n_walk = n_walk.long()
    # one item per (tile, chunk walked)
    tile = torch.repeat_interleave(torch.arange(n_walk.numel(), device=dev),
                                   n_walk)
    first = torch.cumsum(n_walk, 0) - n_walk
    step = torch.arange(tile.numel(), device=dev) - first[tile]
    lane = torch.arange(rt.TILE_PIX, device=dev)
    lx = (lane % tw).float()
    ly = (lane // tw).float()
    k = torch.arange(chunk, device=dev)
    pairs = gated = 0
    for i in range(0, tile.numel(), batch):
        t, c = tile[i:i + batch], step[i:i + batch]
        cols = off0[t, None] + c[:, None] * chunk + k
        ok = (cols >= start[t, None]) & (cols < end[t, None])
        d = pair_data[:, torch.clamp(cols, max=pair_data.shape[1] - 1)]
        if packed:
            d = rt._decode_packed(d)
        ox = ((t % tiles_x) * tw).float()
        oy = ((t // tiles_x) * th).float()
        dx = d[0][:, :, None] - (ox[:, None] + lx)[:, None]
        dy = d[1][:, :, None] - (oy[:, None] + ly)[:, None]
        power = (-0.5 * (d[2][:, :, None] * dx * dx + d[4][:, :, None] * dy * dy)
                 - d[3][:, :, None] * dx * dy)
        if packed:
            alpha = torch.exp(power + d[5][:, :, None])
        else:
            alpha = d[5][:, :, None] * torch.exp(power)
        alpha = torch.clamp(alpha, max=rt.ALPHA_MAX)
        gate = (power <= 0.0) & (alpha >= rt.ALPHA_MIN) & ok[:, :, None]
        pairs += int(ok.sum())
        gated += int(gate.sum())
    return pairs, pairs * rt.TILE_PIX, gated


def k1_calls_by_mode(calls):
    """The recorded K1 calls' first six arguments by with_stats mode."""
    return {args[6]: args[:6] for args, _ in calls["rasterize_fwd"]}


def check_k1(call, mode, a, log, failures):
    """K1 on one recorded call's inputs in one with_stats mode against its
    plain version (the K1_* tolerances), both timed, with the call's
    composited (pair, pixel) counts and its bound."""
    import torch

    from log_tpu_torch.ops import rasterize_tiled as rt

    with torch.no_grad():  # the training step's pair array requires grad
        k = rt.rasterize_forward(*a, mode)
        p = rt.rasterize_forward_plain(*a, mode)
        d_col = (k[0] - p[0]).abs()
        d_t = (k[1] - p[1]).abs()
        err = max(float(d_col.max()), float(d_t.max()))
        mean = max(float(d_col.mean()), float(d_t.mean()))
        pid_mis = float((k[2] != p[2]).float().mean())
        pw_mis = float(((k[4] - p[4]).abs() > 1e-5).float().mean())
        cend_eq = torch.equal(k[5], p[5])
        ms = device_ms(lambda: rt.rasterize_forward(*a, mode), 10)
        pms = device_ms(lambda: rt.rasterize_forward_plain(*a, mode), 2)
        pairs, dense, gated = composite_counts(a[0], a[1], a[2], k[5], a[4])
    stats = rt._stats_level(mode)
    tiles = a[1].numel()
    # records (+ the id row with full stats), tile runs, bg, 24 bytes of
    # outputs per pixel, per-pair weights, cend
    nbytes = (pairs * (10 if stats == 2 else 9) * 4 + tiles * 12 + 12
              + k[1].numel() * 24 + (pairs * 4 if stats else 0))
    b_ms, by = bound(nbytes, gated * COMPOSITE_OPS)
    log(f"K1 rasterize_fwd  {call}, with_stats={mode!r}: "
        f"color/tfinal max_abs={err:.3g} mean_abs={mean:.3g} "
        f"pid mismatch={pid_mis:.3g} pair_w mismatch={pw_mis:.3g} "
        f"pwp max_abs={float((k[3] - p[3]).abs().max()):.3g} "
        f"cend equal={cend_eq}; pairs {pairs}, (pair, pixel) dense {dense} "
        f"gated {gated} ({100 * gated / max(dense, 1):.2f}%); kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    if err > K1_MAX_ABS or mean > K1_MEAN_ABS or pid_mis > K1_MISMATCH \
            or pw_mis > K1_MISMATCH:
        failures.append(f"K1 {call} with_stats={mode!r} disagrees with "
                        f"plain")
    return {"call": call, "with_stats": mode, "max_abs_err": err,
            "mean_abs_err": mean, "ms": ms, "plain_ms": pms,
            "bound_ms": b_ms, "bound_by": by, "pairs": pairs,
            "dense_pair_pixels": dense, "gated_pair_pixels": gated}


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
    b_ms, by = bound(tensor_bytes(args) + tensor_bytes(k), 0)
    log(f"K4 pack_rows      shape {tuple(k.shape)}: exact={exact} "
        f"max_abs={err:.3g} kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({by})")
    if not exact:
        failures.append("K4 pack_rows is not bit-exact")
    rows["pack_rows"] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                         "bound_ms": b_ms, "bound_by": by}

    # K3: bit-exact, including the tail past `total`
    args, kw = calls["expand_with_keys"][-1]
    k = expand_with_keys(*args, **kw)
    p = expand_with_keys_plain(*args, **kw)
    exact = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(k, p))
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(k, p))
    ms = device_ms(lambda: expand_with_keys(*args, **kw), 10)
    pms = device_ms(lambda: expand_with_keys_plain(*args, **kw), 10)
    total = int(args[2].reshape(()))
    b_ms, by = bound(tensor_bytes(args) + tensor_bytes(k), 0)
    log(f"K3 expand         A={args[3]} P={args[0].shape[1]} total={total}: "
        f"exact={exact} max_abs={err:.3g} kernel {ms:.4f} ms, "
        f"plain {pms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    if not exact:
        failures.append("K3 expand_with_keys is not bit-exact")
    rows["expand_with_keys"] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                                "bound_ms": b_ms, "bound_by": by}

    # K1: the cull render's call ("weights") and the frame's call (False),
    # plus full stats on the frame's pairs
    by_mode = k1_calls_by_mode(calls)
    modes = [check_k1("generic frame cull", "weights", by_mode["weights"],
                      log, failures),
             check_k1("generic frame", False, by_mode[False], log, failures),
             check_k1("generic frame pairs", True, by_mode[False], log,
                      failures)]
    frame = modes[1]
    rows["rasterize_fwd"] = {
        "max_abs_err": max(m["max_abs_err"] for m in modes),
        **{key: frame[key] for key in ("ms", "plain_ms", "bound_ms",
                                       "bound_by")},
        "modes": modes}
    return rows, failures


def run_slice(model, renderer, batches, log, label="slice"):
    """The timed orbit: returns (per-frame ms list, renders, telemetry,
    launches, peak bytes)."""
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
    log(f"{label}: {len(batches)} frames ({WARMUP} warm-up), per-frame ms "
        + " ".join(f"{t['ms']:.2f}" for t in telemetry))
    last = telemetry[-1]
    log(f"{label}: mean frame {np.mean(frame_ms):.3f} ms (min "
        f"{np.min(frame_ms):.3f}, max {np.max(frame_ms):.3f}) over "
        f"{len(frame_ms)} frames; last frame: cut {last['cut']} points, "
        f"slice bucket {last['k_visible']}, pair demand "
        f"{last['pair_total']} (budget {last['max_pairs']}); peak memory "
        f"{peak / 2**30:.3f} GiB; launches {launches}")
    return frame_ms, renders, telemetry, launches, peak


def phase_json(frame_ms, telemetry, launches, peak):
    return {"frame_ms_mean": float(np.mean(frame_ms)),
            "frame_ms_min": float(np.min(frame_ms)),
            "frame_ms_max": float(np.max(frame_ms)), "frame_ms": frame_ms,
            "frames": telemetry, "launches": launches, "peak_bytes": peak}


def check_frames(renders, label):
    """Finite frames of the expected shape that are not blank."""
    img = np.stack(renders)
    if img.shape != (len(renders), 3, H, W) or not np.isfinite(img).all():
        return [f"{label}: bad frames, shape {img.shape}"]
    if float(img.std()) < 1e-3 or float(img.max()) <= 0.0:
        return [f"{label}: frames are blank"]
    return []


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


# ------------------------------------------------ flat_slice, K6, blocks
def psnr(a, b):
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))


def cross_path(label, img, cut, ref_img, ref_cut, log):
    """The JAX package's cross-path bounds: |cut difference| <= max(64, 2%)
    and PSNR > 35 dB. Returns (psnr, failures)."""
    p = psnr(img, ref_img)
    log(f"{label}: cut {cut} vs {ref_cut}, PSNR {p:.2f} dB")
    ok = (cut > 0 and abs(cut - ref_cut) <= max(64, int(0.02 * ref_cut))
          and p > CROSS_PATH_PSNR)
    return p, [] if ok else [f"{label}: cut {cut} vs {ref_cut}, PSNR {p}"]


def compare_packed_kernels(calls, log):
    """K3p and K5 against their plain versions on frame 0's own inputs of
    the flat_slice frame, and every K4 pack of that frame bit-exact."""
    import torch

    from log_tpu_torch.ops import expand as ex
    from log_tpu_torch.ops import rasterize_tiled as rt

    rows, failures = {}, []
    for args, kw in calls["pack_rows"]:
        if not torch.equal(_bits(rt.pack_rows(*args, **kw)),
                           _bits(rt.pack_rows_plain(*args, **kw))):
            failures.append(f"K4 pack of {len(args[0])} rows is not exact")

    # K3p: rows bit-exact up to `total`, keys everywhere
    args, kw = calls["expand_packed"][-1]
    k = ex.expand_packed_with_keys(*args, **kw)
    p = ex.expand_packed_with_keys_plain(*args, **kw)
    total = int(args[2].reshape(()))
    exact = (torch.equal(_bits(k[0][:, :total]), _bits(p[0][:, :total]))
             and torch.equal(k[1], p[1]) and torch.equal(_bits(k[2]),
                                                         _bits(p[2])))
    err = max(float((k[0][:, :total] - p[0][:, :total]).abs().max()),
              float((k[1] - p[1]).abs().max()),
              float((k[2].double() - p[2].double()).abs().max()))
    ms = device_ms(lambda: ex.expand_packed_with_keys(*args, **kw), 10)
    pms = device_ms(lambda: ex.expand_packed_with_keys_plain(*args, **kw), 10)
    b_ms, by = bound(tensor_bytes(args) + tensor_bytes(k), 0)
    log(f"K3p expand_packed A={args[3]} P={args[1]} total={total}: "
        f"exact={exact} max_abs={err:.3g} kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    if not exact:
        failures.append("K3p expand_packed_with_keys is not bit-exact")
    rows["expand_packed"] = {"max_abs_err": err, "ms": ms, "plain_ms": pms,
                             "bound_ms": b_ms, "bound_by": by}

    # K5: K1's tolerances
    args, kw = calls["rasterize_fwd_packed"][-1]
    k = rt.rasterize_forward_packed(*args, **kw)
    # the plain version's full output also gives the chunks composited
    full = rt.rasterize_forward_plain(*args, False, packed=True)
    p = full[:2]
    err = max(float((a - b).abs().max()) for a, b in zip(k, p))
    mean = max(float((a - b).abs().mean()) for a, b in zip(k, p))
    ms = device_ms(lambda: rt.rasterize_forward_packed(*args, **kw), 10)
    dev_ms, dev_n = kernel_device_ms(
        lambda: rt.rasterize_forward_packed(*args, **kw), 10,
        "rasterize_fwd_kernel", log)
    pms = device_ms(lambda: rt.rasterize_forward_packed_plain(*args, **kw), 2)
    pairs, dense, gated = composite_counts(args[0], args[1], args[2],
                                           full[5], args[4], packed=True)
    # six record words per pair, tile runs, bg, color and tfinal
    b_ms, by = bound(pairs * 24 + args[1].numel() * 8 + 12
                     + k[1].numel() * 16, gated * COMPOSITE_OPS)
    log(f"K5 rasterize_fwd_packed pairs={args[0].shape[1]}: color/tfinal "
        f"max_abs={err:.3g} mean_abs={mean:.3g}; composited pairs {pairs}, "
        f"(pair, pixel) dense {dense} gated {gated} "
        f"({100 * gated / max(dense, 1):.2f}%); kernel {ms:.4f} ms "
        f"(profiler: {dev_ms:.4f} ms in {dev_n:g} launch per call), plain "
        f"{pms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    if err > K1_MAX_ABS or mean > K1_MEAN_ABS:
        failures.append("K5 rasterize_forward_packed disagrees with plain")
    if dev_n != 1:
        failures.append(f"K5: the profiler saw {dev_n} launches per call")
    rows["rasterize_fwd_packed"] = {
        "max_abs_err": err, "ms": ms, "device_ms": dev_ms, "plain_ms": pms,
        "bound_ms": b_ms, "bound_by": by, "pairs": pairs,
        "dense_pair_pixels": dense, "gated_pair_pixels": gated}
    return rows, failures


def compare_k6(calls, log):
    """K6 against its plain version on frame 0's compaction inputs:
    bit-exact, in one launch per call."""
    import torch

    from log_tpu_torch.ops import compact

    args, kw = calls["stream_compact"][-1]
    k = compact.stream_compact_cols(*args, **kw)
    p = compact.stream_compact_cols_plain(*args, **kw)
    exact = (torch.equal(k[1], p[1]) and torch.equal(k[2], p[2])
             and all(torch.equal(_bits(k[0][n]), _bits(p[0][n]))
                     for n in k[0]))
    err = max(float((k[0][n].double() - p[0][n].double()).abs().nan_to_num()
                    .max()) for n in k[0])
    ms = device_ms(lambda: compact.stream_compact_cols(*args, **kw), 10)
    dev_ms, dev_n = kernel_device_ms(
        lambda: compact.stream_compact_cols(*args, **kw), 10, "compact",
        log)
    pms = device_ms(lambda: compact.stream_compact_cols_plain(*args, **kw), 10)
    cols, keep, kk = args
    # bytes the compaction needs: the mask, the words of the rows it keeps
    # (the first kk kept) and its outputs; dropped rows need not be read
    kept = int(keep.sum())
    moved = min(kept, kk) * sum(c.element_size() for c in cols.values())
    b_ms, by = bound(tensor_bytes(keep) + moved + tensor_bytes(k), 0)
    # the share of the columns' 32-byte sectors that hold a kept row: what
    # a gather of the kept words fetches from device memory
    cap8 = keep.shape[0] // 8 * 8
    sectors = float(keep[:cap8].view(-1, 8).any(dim=1).float().mean())
    log(f"K6 stream_compact cap={keep.shape[0]} columns={len(cols)} k={kk} "
        f"kept={kept} (in {100 * sectors:.1f}% of the 32-byte sectors): "
        f"exact={exact} max_abs={err:.3g}; kernel "
        f"{ms:.4f} ms (profiler: {dev_ms:.4f} ms in {dev_n:g} launch per "
        f"call), plain {pms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    fails = [] if exact else ["K6 stream_compact_cols is not bit-exact"]
    if dev_n != 1:
        fails.append(f"K6: the profiler saw {dev_n} launches per call")
    return {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": pms, "bound_ms": b_ms, "bound_by": by,
            "kept_sector_share": sectors}, fails


def render_slice_phases(model, renderer, batches, generic0, log):
    """The flat_slice frame, the same frames with K6, then the block-pruned
    frame, on the serving model. generic0: (frame 0, its cut) of the
    generic phase. Returns (json, kernel rows, launches by phase,
    failures)."""
    import os

    import torch

    out, rows, runs, failures = {}, {}, {}, []

    # 1. flat_slice: the cull every frame, the packed column render
    model.tree.cut_method = "flat_slice"
    model._refresh_device_caches()
    calls = record_kernel_inputs(model, renderer, batches[0])
    r, f = compare_packed_kernels(calls, log)
    rows.update(r)
    failures += f
    del calls
    frame_ms, renders, telemetry, launches, peak = run_slice(
        model, renderer, batches, log, "flat_slice")
    runs["flat_slice"] = launches
    out["flat_slice"] = phase_json(frame_ms, telemetry, launches, peak)
    if PROFILE:
        profile_frames("flat_slice", model, renderer, batches, frame_ms, log)
    failures += check_frames(renders, "flat_slice")
    for name in FLAT_KERNELS:
        if launches[name] <= 0:
            failures.append(f"kernel {name} never launched on the flat_slice "
                            f"path")
    if launches["rasterize_fwd_packed"] != len(batches):
        failures.append(f"K5 launched {launches['rasterize_fwd_packed']} "
                        f"times in {len(batches)} flat_slice frames")
    with plain_versions():
        plain = renderer.vis(batches[0], model)["render"][0]
    kern = renderer.vis(batches[0], model)["render"][0]
    frame_diff = float(np.abs(plain - kern).max())
    log(f"flat_slice frame 0 plain versions: max |plain - kernels| "
        f"{frame_diff:.4g} (8-bit frames)")
    if frame_diff > FRAME_MAX_ABS:
        failures.append(f"flat_slice plain frame differs by {frame_diff}")
    p, f = cross_path("flat_slice frame 0 vs the generic flat frame",
                      renders[0], telemetry[0]["cut"], *generic0, log)
    failures += f
    out["flat_slice"].update(plain_frame_max_abs=frame_diff,
                             psnr_vs_generic=p)

    # 2. the same frames with the stream-compaction kernel K6
    os.environ["LOG_TPU_COMPACT"] = "pallas"
    try:
        calls = record_kernel_inputs(model, renderer, batches[0])
        rows["stream_compact"], f = compare_k6(calls, log)
        failures += f
        del calls
        k6_ms, k6_renders, k6_tel, k6_launches, k6_peak = run_slice(
            model, renderer, batches, log, "flat_slice+K6")
    finally:
        del os.environ["LOG_TPU_COMPACT"]
    runs["flat_slice_k6"] = k6_launches
    out["flat_slice_k6"] = phase_json(k6_ms, k6_tel, k6_launches, k6_peak)
    if k6_launches["stream_compact"] != len(batches):
        failures.append(f"K6 launched {k6_launches['stream_compact']} times "
                        f"in {len(batches)} frames")
    same = all(np.array_equal(a, b) for a, b in zip(renders, k6_renders))
    log(f"flat_slice+K6: frames bit-identical to the sort compaction's: "
        f"{same}")
    if not same:
        failures.append("K6 frames differ from the sort-compaction frames")
    del renders, k6_renders

    # 3. block-pruned frames: SH degree 0 (the block path's condition),
    # the reference frame first, then the layout and a cull every 4 frames
    model.set_state(active_sh_degree=0)
    ref = renderer.vis(batches[0], model)["render"][0]
    ref_cut = model.frame_stats()["cut"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.optimize_render_layout()
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    model.set_state(check_render_every=CHECK_RENDER_EVERY)
    n_blocks = model.capacity // model._block_cache["S"]
    log(f"render layout: {layout_s:.2f} s; blocks of "
        f"{model._block_cache['S']} rows, B = {n_blocks}")
    b_ms, b_renders, b_tel, b_launches, b_peak = run_slice(
        model, renderer, batches, log, "block")
    runs["block"] = b_launches
    out["block"] = phase_json(b_ms, b_tel, b_launches, b_peak)
    if PROFILE:
        profile_frames("block", model, renderer, batches, b_ms, log)
    failures += check_frames(b_renders, "block")
    elig = [t.get("eligible_blocks") for t in b_tel]
    log(f"block: eligible blocks per frame {elig} of B = {n_blocks}")
    if any(e is None for e in elig):
        failures.append("a frame after optimize_render_layout did not take "
                        "the block path")
    for name in BLOCK_KERNELS:
        if b_launches[name] <= 0:
            failures.append(f"kernel {name} never launched on the block path")
    if b_launches["rasterize_fwd_packed"] != len(batches):
        failures.append(f"K5 launched {b_launches['rasterize_fwd_packed']} "
                        f"times in {len(batches)} block frames")
    p, f = cross_path("block frame 0 vs the flat_slice frame (SH 0)",
                      b_renders[0], b_tel[0]["cut"], ref, ref_cut, log)
    failures += f
    out["block"].update(layout_s=layout_s, n_blocks=n_blocks,
                        eligible_blocks=elig, psnr_vs_flat_slice=p)
    return out, rows, runs, failures


# --------------------------------------------------------------- training
def build_train_model(device, n_roots=N_ROOTS):
    """The synthetic tree as a fresh training checkpoint (zero Adam moments
    at global step 0, the counter's radius bounds) loaded for training."""
    from log_tpu_torch.utils.config import load_object
    from log_tpu_torch.utils.synth_tree import build_checkpoint

    ckpt = build_checkpoint(n_roots, seed=SEED)
    for key in MODEL_ARGS["optimizer"]["optimize_keys"]:
        for mk in ("exp_avg", "exp_avg_sq"):
            ckpt[f"optimizer.{mk}.{key}"] = np.zeros_like(
                ckpt[f"gaussian.{key}"])
    ckpt["optimizer.global_steps"] = np.float32(0)
    model = load_object("LoG.model.level_of_gaussian.LoG", MODEL_ARGS,
                        device=device)
    model.base_iter = BASE_ITER
    model.view_correction.init(TRAIN_VIEWS)  # what the init pass sets up
    model.load_state_dict(ckpt, split="train")
    model.set_state(enable_sh=True)
    model.set_stage("tree")
    model.training_setup()
    return model


def train_batches(h=H, w=W, focal=1400.0):
    from log_tpu_torch.dataset.base import prepare_camera

    batches = []
    for i in range(TRAIN_VIEWS):
        pc = prepare_camera(make_cam(2 * math.pi * i / TRAIN_VIEWS + 0.3,
                                     height=TRAIN_HEIGHT, radius=TRAIN_RADIUS,
                                     h=h, w=w, focal=focal), 1, 0.01, 1000.0)
        batches.append({"camera": {k: np.asarray(pc[k])[None]
                                   for k in CAMERA_KEYS},
                        "index": np.asarray([i])})
    return batches


def render_ground_truth(model, batches, log):
    """8-bit GT frames of the model (render_fused, black background), put
    into the batches as data["image"] (B, H, W, 3)."""
    import torch

    model.eval()
    for b in batches:
        camera = {k: np.asarray(v)[0] for k, v in b["camera"].items()}
        out = model.render_fused(camera, np.zeros(3, np.float32))
        img8 = (torch.clamp(out["render"], 0, 1) * 255).to(torch.uint8)
        b["image"] = img8.permute(1, 2, 0).cpu().numpy()[None]
        log(f"GT view {int(b['index'][0])} {img8.shape[2]}x{img8.shape[1]}: "
            f"alpha mean {float(out['alpha'].mean()):.4f}, pixel mean "
            f"{float(img8.float().mean()) / 255:.4f}")
    model.train()


def make_ground_truth(model, batches, device, log):
    """GT frames of the unperturbed tree (render_ground_truth); then the
    colors and opacities of the live points are perturbed (perturb)."""
    render_ground_truth(model, batches, log)
    perturb(model, device)


def perturb(model, device):
    """The colors and opacities of the live points perturbed from a seeded
    generator."""
    import torch

    n = model.num_points
    g = torch.Generator(device=device).manual_seed(SEED + 1)
    for key, scale, shift in (("colors", 0.3, 0.0), ("opacity", 0.5, -0.5)):
        val = model.gaussian.get(key)
        noise = torch.randn(val.shape, generator=g, device=device) * scale
        noise[n:] = 0.0
        noise[:n] += shift
        model.gaussian.set(key, val + noise)


def _finite(*dicts):
    import torch

    flags = [torch.isfinite(v).all() for d in dicts for v in d.values()]
    return bool(torch.stack(flags).all())


def run_train_slice(model, batches, device, log):
    """TRAIN_STEPS steps of Trainer.training_step; step 0 records its kernel
    calls and its fused_train_step arguments."""
    import torch

    from log_tpu_torch.model import level_of_gaussian as lg
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.trainer import Trainer

    renderer = NaiveRendererAndLoss(split="train", use_randback=True,
                                    device=device)
    trainer = Trainer({}, model, renderer, seed=SEED)
    trainer.set_gt_cache(True)  # full frames: the views' GT stays cached
    step0 = {"calls": {}, "step": []}
    real_step = lg.fused_train_step

    def record_step(*args, **kwargs):
        step0["step"].append((args, kwargs))
        return real_step(*args, **kwargs)

    steps, finite_fail = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for i in range(TRAIN_STEPS):
        batch = batches[i % TRAIN_VIEWS]
        use_corr = model.optimizer.global_steps >= model.base_iter
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            with recording(step0["calls"]), \
                    patched(lg, {"fused_train_step": record_step}):
                _ok, out, _ = trainer.training_step(model, batch)
        else:
            _ok, out, _ = trainer.training_step(model, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        trainer.global_iterations += 1
        met = out["metrics"]
        steps.append({
            "step": i, "ms": ms, "view": i % TRAIN_VIEWS,
            "loss": float(met["loss"]), "l1": float(met["l1"]),
            "ssim": float(met["ssim"]), "correction": bool(use_corr),
            "bucket": list(model._bucket),
            "pair_demand": int(met["pair_total"]),
            "rendered": int(met["num_rendered"]),
        })
        if not _finite(model.gaussian.params(), model.optimizer.moments["exp_avg"],
                       model.optimizer.moments["exp_avg_sq"]):
            finite_fail.append(i)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("train: per-step ms " + " ".join(f"{s['ms']:.1f}" for s in steps))
    log("train: loss " + " ".join(f"{s['loss']:.4f}" for s in steps))
    log("train: bucket " + " ".join(f"{s['bucket'][0]}+{s['bucket'][1]}"
                                    for s in steps))
    log("train: pair demand " + " ".join(str(s["pair_demand"])
                                         for s in steps))
    return steps, launches, peak, finite_fail, step0, trainer


def compare_k2(calls, log):
    """K2 against its plain version on step 0's own K2 inputs."""
    import torch

    from log_tpu_torch.ops import rasterize_tiled as rt

    args, kw = calls["rasterize_bwd"][0]
    with torch.no_grad():  # the saved pair array requires grad
        k = rt.rasterize_backward(*args, **kw)
        p = rt.rasterize_backward_plain(*args, **kw)
        scale = float(p[:9].abs().max())
        err = float((k[:9] - p[:9]).abs().max())
        tail_zero = float(k[9:].abs().max()) == 0.0
        again = rt.rasterize_backward(*args, **kw)
        same = torch.equal(_bits(k), _bits(again))
        ms = device_ms(lambda: rt.rasterize_backward(*args, **kw), 10)
        pms = device_ms(lambda: rt.rasterize_backward_plain(*args, **kw), 2)
        # K2 walks K1's composited chunks (cend <= the chunks of the run)
        pairs, dense, gated = composite_counts(args[0], args[1], args[2],
                                               args[3], args[8])
    cend = args[3]
    # records in, rows 0-8 out per pair; tile runs and cend; tfinal,
    # dcolor and dalpha per pixel; bg
    b_ms, by = bound(pairs * 72 + cend.numel() * 12 + args[4].numel() * 20
                     + 12, gated * BACKWARD_OPS)
    log(f"K2 rasterize_bwd  pairs={args[0].shape[1]} tiles={cend.numel()} "
        f"chunks walked={int(cend.sum())}: max_abs={err:.3g} "
        f"(max |plain| {scale:.3g}, rel {err / max(scale, 1e-30):.3g}) "
        f"rows 9-15 zero={tail_zero}, two launches bit-identical={same}; "
        f"pairs {pairs}, (pair, pixel) dense {dense} gated {gated} "
        f"({100 * gated / max(dense, 1):.2f}%); kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    fails = []
    if not (scale > 0 and err <= K2_REL_TOL * scale and tail_zero and same):
        fails.append("K2 rasterize_bwd disagrees with plain")
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
            "bound_by": by, "pairs": pairs, "dense_pair_pixels": dense,
            "gated_pair_pixels": gated}, fails


def compare_k1_step(calls, log):
    """K1 on training step 0's own calls: the cull render ("weights") and
    the render with full stats (True)."""
    by_mode = k1_calls_by_mode(calls)
    failures = []
    modes = [check_k1("training step cull", "weights", by_mode["weights"],
                      log, failures),
             check_k1("training step", True, by_mode[True], log, failures)]
    return modes, failures


def replay_step0(step0, log, grad_tol=STEP_GRAD_REL_TOL):
    """Step 0 again from its recorded inputs (the step is functional, so
    they are the pre-step state): once through the kernels, once through
    the plain versions. The first Adam moments after one step from zero are
    0.1 g, so they carry the per-gaussian gradients."""
    import torch

    from log_tpu_torch.model.train_step import fused_train_step

    args, kw = step0["step"][0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_k = fused_train_step(*args, **kw)
    torch.cuda.synchronize()
    k_ms = (time.perf_counter() - t0) * 1e3
    with plain_versions():
        t0 = time.perf_counter()
        out_p = fused_train_step(*args, **kw)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
    d_loss = abs(float(out_k[4]["loss"]) - float(out_p[4]["loss"]))
    worst = 0.0
    for key, m_k in out_k[1]["exp_avg"].items():
        m_p = out_p[1]["exp_avg"][key]
        rel = float((m_k - m_p).abs().max()) / max(float(m_k.abs().max()),
                                                   1e-30)
        worst = max(worst, rel)
        log(f"step 0 plain vs kernels: {key:9s} grad rel err {rel:.3g}")
    log(f"step 0 plain vs kernels: loss {float(out_k[4]['loss']):.6f} vs "
        f"{float(out_p[4]['loss']):.6f} (|d| {d_loss:.3g}); step "
        f"{k_ms:.1f} ms with kernels, {p_ms:.1f} ms plain")
    fails = []
    if d_loss > STEP_LOSS_TOL or worst > grad_tol:
        fails.append(f"step 0 with plain versions differs: loss {d_loss}, "
                     f"grad rel {worst}")
    return {"loss_abs_diff": d_loss, "grad_rel_err": worst,
            "kernel_step_ms": k_ms, "plain_step_ms": p_ms}, fails


def profile_window(label, run, n, wall_ms, log, ranges=False):
    """n calls of run(i) under torch.profiler: device busy per call (the sum
    of kernel time) against wall_ms, the median un-profiled call, and the
    top kernels; the full table goes to build/{label}_profile.txt. ranges:
    also list the training step's labelled ranges (record_function)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
    report_profile(label, prof, n, wall_ms, log, ranges)


def report_profile(label, prof, n, wall_ms, log, ranges=False):
    """profile_window's report of a finished torch.profiler run over n
    calls."""
    import os

    from torch.autograd import DeviceType

    avgs = prof.key_averages()

    def dev_ms(e):  # per call
        return _self_device_us(e) / 1e3 / n

    # the step's record_function ranges also appear on the device side (as
    # spans); they are not kernels
    kernels_ = [e for e in avgs if e.device_type == DeviceType.CUDA
                and not e.key.startswith("train_step.")]
    busy = sum(dev_ms(e) for e in kernels_)
    os.makedirs("build", exist_ok=True)
    with open(f"build/{label}_profile.txt", "w") as f:
        f.write(avgs.table(sort_by="self_cuda_time_total", row_limit=80))
    log(f"profile {label}: {n} calls, device busy {busy:.3f} ms per call "
        f"(sum of kernel time) against a median call of {wall_ms:.3f} ms "
        f"un-profiled: busy {100 * busy / wall_ms:.1f}%, idle "
        f"{100 * (1 - busy / wall_ms):.1f}%; "
        f"{sum(e.count for e in kernels_) // n} kernel launches per call")
    for e in sorted(kernels_, key=dev_ms, reverse=True)[:20]:
        log(f"  kernel {dev_ms(e):8.3f} ms/call {e.count // n:5d}x "
            f"{e.key[:100]}")
    if not ranges:
        return
    # host-side ranges: the device time of the kernels launched inside
    # them (the backward's kernels run on autograd's thread, outside);
    # device-side ranges: their span on the device timeline
    for e in sorted(avgs, key=lambda e: (e.key, str(e.device_type))):
        if e.key.startswith("train_step.") or e.key in (
                "aten::sort", "aten::scatter_reduce_", "aten::cumsum"):
            if e.device_type == DeviceType.CUDA:
                what, ms = "span", dev_ms(e)
            else:
                dev = getattr(e, "device_time_total", None)
                if dev is None:
                    dev = e.cuda_time_total
                what, ms = "kernels", dev / 1e3 / n
            log(f"  {e.key:28s} {what:7s} {ms:8.3f} ms/call "
                f"{e.count // n:5d}x")


def profile_steps(model, trainer, batches, step_ms, log):
    """PROFILE_STEPS more training steps under torch.profiler
    (build/train_profile.txt)."""

    def step(i):
        trainer.training_step(model, batches[i % TRAIN_VIEWS])
        trainer.global_iterations += 1

    profile_window("train", step, PROFILE_STEPS, step_ms, log, ranges=True)


def profile_frames(label, model, renderer, batches, frame_ms, log):
    """PROFILE_STEPS more serving frames under torch.profiler."""
    profile_window(label, lambda i: renderer.vis(batches[i], model),
                   PROFILE_STEPS, float(np.median(frame_ms)), log)


# ------------------------------------------------------------------ growth
def hold_calls(calls, label, log, rows_out=None):
    """Every K4 pack, K3 and K3p (bit-exact), K1 (each with_stats mode
    recorded), K5 (K1's tolerances) and every K2, those of them that the call
    ran, on the recorded inputs of one main-path step or frame, against
    their plain versions. Returns ({kernel: max_abs_err}, failures); with
    rows_out, K1's rows (one per mode) and K2's (one per call), with their
    times and bounds, are appended to rows_out["rasterize_fwd"] and
    rows_out["rasterize_bwd"]."""
    import torch

    from log_tpu_torch.ops import expand as ex
    from log_tpu_torch.ops import rasterize_tiled as rt

    errs, fails = {}, []
    with torch.no_grad():
        # bit-exact outputs count as error 0 (rows past a call's pairs may
        # hold the same NaN bits in both)
        for args, kw in calls.get("pack_rows", []):
            k, p = rt.pack_rows(*args, **kw), rt.pack_rows_plain(*args, **kw)
            errs["pack_rows"] = errs.get("pack_rows", 0.0)
            if not torch.equal(_bits(k), _bits(p)):
                errs["pack_rows"] = max(errs["pack_rows"],
                                        float((k - p).abs().max()))
                fails.append(f"{label}: K4 pack of {len(args[0])} rows is "
                             f"not bit-exact")
        if "expand_with_keys" in calls:
            args, kw = calls["expand_with_keys"][-1]
            k = ex.expand_with_keys(*args, **kw)
            p = ex.expand_with_keys_plain(*args, **kw)
            errs["expand_with_keys"] = 0.0
            if not all(torch.equal(_bits(a), _bits(b)) for a, b in zip(k, p)):
                errs["expand_with_keys"] = max(
                    float((a.double() - b.double()).abs().max())
                    for a, b in zip(k, p))
                fails.append(f"{label}: K3 expand_with_keys is not bit-exact")
        if "expand_packed" in calls:  # rows up to `total`, keys everywhere
            args, kw = calls["expand_packed"][-1]
            k = ex.expand_packed_with_keys(*args, **kw)
            p = ex.expand_packed_with_keys_plain(*args, **kw)
            total = int(args[2].reshape(()))
            errs["expand_packed"] = max(
                float((k[0][:, :total] - p[0][:, :total]).abs().max()),
                float((k[1] - p[1]).abs().max()),
                float((k[2].double() - p[2].double()).abs().max()))
            if not (torch.equal(_bits(k[0][:, :total]), _bits(p[0][:, :total]))
                    and torch.equal(k[1], p[1])
                    and torch.equal(_bits(k[2]), _bits(p[2]))):
                fails.append(f"{label}: K3p expand_packed_with_keys is not "
                             f"bit-exact")
        if "rasterize_fwd_packed" in calls:
            args, kw = calls["rasterize_fwd_packed"][-1]
            k = rt.rasterize_forward_packed(*args, **kw)
            p = rt.rasterize_forward_packed_plain(*args, **kw)
            errs["rasterize_fwd_packed"] = max(
                float((a - b).abs().max()) for a, b in zip(k, p))
            mean = max(float((a - b).abs().mean()) for a, b in zip(k, p))
            if errs["rasterize_fwd_packed"] > K1_MAX_ABS or mean > K1_MEAN_ABS:
                fails.append(f"{label}: K5 rasterize_forward_packed disagrees "
                             f"with plain")
    rows_out = {} if rows_out is None else rows_out
    if "rasterize_fwd" in calls:
        modes = [check_k1(label, mode, a, log, fails)
                 for mode, a in k1_calls_by_mode(calls).items()]
        errs["rasterize_fwd"] = max(m["max_abs_err"] for m in modes)
        rows_out.setdefault("rasterize_fwd", []).extend(modes)
    for call in calls.get("rasterize_bwd", []):  # each backward pass's
        row, f = compare_k2({"rasterize_bwd": [call]}, log)
        errs["rasterize_bwd"] = max(errs.get("rasterize_bwd", 0.0),
                                    row["max_abs_err"])
        rows_out.setdefault("rasterize_bwd", []).append(row)
        fails += f
    log(f"{label}: K4/K3/K3p exact, max |kernel - plain| {errs}")
    return errs, fails


def compare_models(ref, got, label, log):
    """The host path's model (ref) against the device path's (got) after
    the same densify: num_points, capacity and the tree arrays equal,
    params, moments and counters to DENSIFY_RTOL / DENSIFY_ATOL (integer
    counters equal). Returns (worst excess per group, failures)."""
    import torch

    fails = []
    if (ref.num_points, ref.capacity) != (got.num_points, got.capacity):
        return {}, [f"{label}: points/capacity {ref.num_points}/"
                    f"{ref.capacity} (host) vs {got.num_points}/"
                    f"{got.capacity} (device)"]
    for key in ("root_index", "tree") + ref.tree.KEYS:
        if not np.array_equal(getattr(ref.tree, key), getattr(got.tree, key)):
            fails.append(f"{label}: tree.{key} differs")
    n = ref.num_points
    pairs = {f"params.{k}": (ref.gaussian.get(k), got.gaussian.get(k))
             for k in ref.gaussian.keys}
    for mk in ("exp_avg", "exp_avg_sq"):
        for k, v in ref.optimizer.moments[mk].items():
            pairs[f"{mk}.{k}"] = (v, got.optimizer.moments[mk][k])
    for k, v in ref.counter.data.items():
        pairs[f"counter.{k}"] = (v, got.counter.data[k])
    worst = {}
    for name, (a, b) in pairs.items():
        a, b = a[:n], b[:n]
        if a.is_floating_point():
            excess = float(((a - b).abs() - DENSIFY_ATOL
                            - DENSIFY_RTOL * a.abs()).max())
            ok = excess <= 0
        else:
            excess = float((a.long() - b.long()).abs().max())
            ok = excess == 0
        group = name.split(".")[0]
        worst[group] = max(worst.get(group, -math.inf), excess)
        if not ok:
            fails.append(f"{label}: {name} differs (excess {excess:.3g})")
    log(f"{label}: host vs device path: {n} points, capacity {ref.capacity}, "
        f"tree arrays equal={not any('tree.' in f for f in fails)}; worst "
        f"|host - device| - tolerance by group {worst} (<= 0 holds)")
    return worst, fails


def snapshot_of(model) -> dict:
    """A copy of the model's state_dict (it hands out the host tree's own
    arrays, which a densify then changes in place)."""
    return {k: np.array(v) for k, v in model.state_dict().items()}


def host_twin(snapshot, model, device):
    """A second model on the card loaded from `snapshot` (model's
    state_dict) that densifies on the host path."""
    from log_tpu_torch.utils.config import load_object

    twin = load_object("LoG.model.level_of_gaussian.LoG", MODEL_ARGS,
                       device=device)
    twin.base_iter = model.base_iter
    twin.view_correction.init(model.view_correction.values.shape[0])
    twin.load_state_dict(snapshot, split="train")
    twin.set_stage(model.stage_name)
    twin.set_state(current_depth=model.current_depth)
    twin.densify_and_remove = dict(model.densify_and_remove,
                                   device_densify="off")
    return twin


def timed(fn):
    """(result, seconds) of fn between two synchronizes."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def hold_densify(model, snapshot, densify, label, device, log):
    """The host path on a twin loaded from `snapshot` (the state before
    the device path's densify), run by densify(twin), held against the
    model. Returns (json, failures)."""
    import torch

    twin = host_twin(snapshot, model, device)
    _, host_s = timed(lambda: densify(twin))
    worst, fails = compare_models(twin, model, label, log)
    del twin
    torch.cuda.empty_cache()
    return {"host_s": host_s, "worst_excess": worst}, fails


class ScheduleLog:
    """Wraps a model's schedule actions (update_init_stage,
    update_depth_stage, upgrade_tree, counter.reset) to record each one
    that update_by_iteration runs at the top level: (stage, iteration,
    action), the path of a densify, its wall time between synchronizes,
    and the points and capacity after it. `inject` holds the rand_u of the
    next init densify."""

    def __init__(self, model, log):
        self.model, self.log = model, log
        self.events, self.where, self.inject, self._depth = [], None, None, 0
        for attr, action in (("update_init_stage", "init_densify"),
                             ("update_depth_stage", "depth_densify"),
                             ("upgrade_tree", "upgrade_tree")):
            setattr(model, attr, self._wrap(action, getattr(model, attr)))
        model.counter.reset = self._wrap("reset", model.counter.reset)

    def _wrap(self, action, real):
        def call(*args, **kwargs):
            if self.where is None or self._depth:
                return real(*args, **kwargs)
            m = self.model
            event = {"stage": self.where[0], "iteration": self.where[1],
                     "action": action, "points_before": m.num_points,
                     "capacity_before": m.capacity}
            if action.endswith("densify"):
                event["path"] = "device" if m._use_device_densify() else "host"
            if action == "init_densify" and self.inject is not None:
                kwargs["rand_u"], self.inject = self.inject, None
            self._depth += 1
            try:
                out, event["s"] = timed(lambda: real(*args, **kwargs))
            finally:
                self._depth -= 1
            event.update(points=m.num_points, capacity=m.capacity)
            self.events.append(event)
            self.log(f"  {event['stage']} iteration {event['iteration']}: "
                     f"{action}{' (' + event['path'] + ' path)' if 'path' in event else ''}"
                     f" {event['points_before']} -> {m.num_points} points, "
                     f"capacity {event['capacity_before']} -> {m.capacity}, "
                     f"{event['s']:.3f} s")
            return out
        return call


def growth_phase(model, trainer, batches, step_ms, device, log):
    """Phase 1: one depth densify of the trained 3.24M-point tree on the
    device path, held against the host path on the same snapshot, then
    GROWTH_STEPS more training steps. Returns (json, launches, held kernel
    errors, failures)."""
    import torch

    from log_tpu_torch.ops import kernels

    failures = []
    d = model.densify_and_remove
    model.set_state(current_depth=20)  # what upgrade_tree sets
    d["min_steps_split"] = 0  # the rows have at most a few dozen steps
    d["device_densify"] = "on"
    log(f"growth: current_depth {model.current_depth}, min_steps_split "
        f"{d['min_steps_split']}, {model.num_points} points, capacity "
        f"{model.capacity}, {model.tree.num_nodes} tree nodes")
    snapshot = snapshot_of(model)
    n0, c0, nodes0 = model.num_points, model.capacity, model.tree.num_nodes
    torch.cuda.synchronize()
    before_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, dev_s = timed(lambda: model.update_depth_stage(trainer.global_iterations))
    peak = torch.cuda.max_memory_allocated()
    n_split = model.tree.num_nodes - nodes0
    n_removed = n0 + n_split * model.splitter.N - model.num_points
    log(f"growth: device densify split {n_split} parents, removed "
        f"{n_removed} children, {n0} -> {model.num_points} points, capacity "
        f"{c0} -> {model.capacity}, {dev_s:.3f} s; memory "
        f"{before_bytes / 2**30:.3f} GiB before, peak {peak / 2**30:.3f} GiB")
    if n_split <= 0:
        failures.append("growth: nothing split")
    held, f = hold_densify(
        model, snapshot,
        lambda twin: twin.update_depth_stage(trainer.global_iterations),
        "growth depth densify", device, log)
    failures += f
    del snapshot
    log(f"growth: host path {held['host_s']:.3f} s, device path "
        f"{dev_s:.3f} s")

    calls, steps, finite_fail = {}, [], []
    torch.cuda.synchronize()
    kernels.reset_launches()
    for i in range(GROWTH_STEPS):
        batch = batches[i % TRAIN_VIEWS]
        if i == 0:
            with recording(calls):
                (_, out, _), ms = timed(
                    lambda: trainer.training_step(model, batch))
        else:
            (_, out, _), ms = timed(lambda: trainer.training_step(model, batch))
        trainer.global_iterations += 1
        steps.append({"step": i, "ms": ms * 1e3,
                      "loss": float(out["metrics"]["loss"]),
                      "bucket": list(model._bucket)})
        if not _finite(model.gaussian.params(),
                       model.optimizer.moments["exp_avg"],
                       model.optimizer.moments["exp_avg_sq"]):
            finite_fail.append(i)
    launches = dict(kernels.LAUNCHES)
    log("growth: steps after the densify, ms "
        + " ".join(f"{s['ms']:.1f}" for s in steps) + f" (median before "
        f"{np.median(step_ms):.1f}); loss "
        + " ".join(f"{s['loss']:.4f}" for s in steps) + f"; launches "
        f"{launches}")
    if finite_fail:
        failures.append(f"growth: non-finite state after steps {finite_fail}")
    if launches["rasterize_bwd"] != GROWTH_STEPS:
        failures.append(f"growth: K2 launched {launches['rasterize_bwd']} "
                        f"times in {GROWTH_STEPS} steps")
    if launches["rasterize_fwd"] < 2 * GROWTH_STEPS:
        failures.append("growth: K1 launched fewer than twice per step")
    errs, f = hold_calls(calls, "growth step 0", log)
    failures += f
    return ({"points_before": n0, "points": model.num_points,
             "capacity_before": c0, "capacity": model.capacity,
             "split_parents": n_split, "removed": n_removed,
             "device_s": dev_s, "memory_before_bytes": before_bytes,
             "peak_bytes": peak, **held, "steps": steps,
             "step_ms_before_median": float(np.median(step_ms))},
            launches, errs, failures)


def inverse_depth_u16(depth, acc):
    """A monocular depth map as DepthDataset reads it: the inverse depth
    1 / (depth + 1e-5) where acc > 0.5 (else 0) over its largest value,
    quantized to 16 bits (uint16)."""
    inv = np.where(acc > 0.5, 1.0 / (np.maximum(depth, 0.0) + 1e-5), 0.0)
    return np.round(inv / max(float(inv.max()), 1e-12) * 65535.0).astype(
        np.uint16)


def render_depth_ground_truth(model, batches, device, log):
    """The model's depth maps through NaiveRendererAndLoss.vis with
    render_depth (black background), into the batches as data["depth"]
    (B, H, W): inverse depth in [0, 1] as a 16-bit map reads."""
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss

    renderer = NaiveRendererAndLoss(split="demo", render_depth=True,
                                    device=device)
    model.eval()
    for b in batches:
        preds = renderer.vis(b, model, background=np.zeros(3, np.float32))
        q = inverse_depth_u16(preds["depth"][0], preds["accmap"][0])
        b["depth"] = (q.astype(np.float32) / 65535.0)[None]
        log(f"GT depth view {int(b['index'][0])}: depth "
            f"{float(preds['depth'][0].max()):.3f} at most, accmap > 0.5 on "
            f"{float((preds['accmap'][0] > 0.5).mean()):.4f}, inverse depth "
            f"mean {float(b['depth'].mean()):.4f}")
    model.train()


def train_twin(snapshot, device):
    """A training model on the card loaded from `snapshot` (a training
    model's state_dict), set up as build_train_model sets its model."""
    from log_tpu_torch.utils.config import load_object

    model = load_object("LoG.model.level_of_gaussian.LoG", MODEL_ARGS,
                        device=device)
    model.base_iter = BASE_ITER
    model.view_correction.init(TRAIN_VIEWS)
    model.load_state_dict(snapshot, split="train")
    model.set_state(enable_sh=True)
    model.set_stage("tree")
    return model


def depth_step_phase(device, train_median, log):
    """The training phase's tree, views and perturbation with a GT depth map
    per view (the unperturbed tree's) and render_depth on: DEPTH_STEPS
    steps of Trainer.training_step. Step 0's kernel calls (copies) are held
    against the plain versions right after it and step 0 is replayed with
    every kernel plain; the timed window is steps 1 on. Returns (json,
    launches, held kernel errors, snapshot, batches, failures): the
    snapshot is the perturbed tree before any step, the batches carry the
    GT frames."""
    import torch

    from log_tpu_torch.model import level_of_gaussian as lg
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.trainer import Trainer

    failures = []
    t0 = time.perf_counter()
    model = build_train_model(device)
    batches = train_batches()
    render_ground_truth(model, batches, log)
    render_depth_ground_truth(model, batches, device, log)
    perturb(model, device)
    snapshot = snapshot_of(model)
    log(f"depth_step setup: {model.num_points} points, "
        f"{time.perf_counter() - t0:.2f} s")
    renderer = NaiveRendererAndLoss(split="train", use_randback=True,
                                    render_depth=True, device=device)
    trainer = Trainer({}, model, renderer, seed=SEED)
    trainer.set_gt_cache(True)
    step0 = {"calls": {}, "step": []}
    real_step = lg.fused_train_step

    def record_step(*args, **kwargs):
        step0["step"].append((args, kwargs))
        return real_step(*args, **kwargs)

    steps, bad, errs, replay, held_rows = [], [], {}, {}, {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    for i in range(DEPTH_STEPS):
        batch = batches[i % TRAIN_VIEWS]
        before = dict(kernels.LAUNCHES)
        if i == 0:
            with recording(step0["calls"], copy=True), \
                    patched(lg, {"fused_train_step": record_step}):
                (_, out, _), s = timed(
                    lambda: trainer.training_step(model, batch))
        else:
            (_, out, _), s = timed(lambda: trainer.training_step(model, batch))
        trainer.global_iterations += 1
        met = out["metrics"]
        steps.append({"step": i, "ms": s * 1e3, "loss": float(met["loss"]),
                      "depth": float(met["depth"]), "l1": float(met["l1"]),
                      "ran": {k: kernels.LAUNCHES[k] - before[k]
                              for k in kernels.LAUNCHES}})
        if not (math.isfinite(steps[-1]["depth"]) and _finite(
                model.gaussian.params(), model.optimizer.moments["exp_avg"],
                model.optimizer.moments["exp_avg_sq"])):
            bad.append(i)
        if i == 0:
            # the holds, then the timed window without step 0's copies
            calls = step0["calls"]
            modes = sorted(str(a[6]) for a, _ in calls.get("rasterize_fwd", []))
            log(f"depth step 0: K1 modes {modes}, "
                f"{len(calls.get('rasterize_bwd', []))} K2 calls")
            if "False" not in modes or len(calls.get("rasterize_bwd", [])) != 2:
                failures.append(f"depth step 0: K1 modes {modes} and "
                                f"{len(calls.get('rasterize_bwd', []))} K2 "
                                f"calls (want a no-stats K1 and two K2)")
            errs, f = hold_calls(calls, "depth step 0", log, held_rows)
            failures += f
            replay, f = replay_step0(step0, log, DEPTH_STEP_GRAD_REL_TOL)
            failures += f
            del step0, calls
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    peak = torch.cuda.max_memory_allocated()
    launches = {k: sum(x["ran"][k] for x in steps) for k in kernels.LAUNCHES}
    per_step = {k: v / DEPTH_STEPS for k, v in launches.items()}
    step_ms = [x["ms"] for x in steps[1:]]
    first = float(np.mean([x["loss"] for x in steps[:DEPTH_LOSS_WINDOW]]))
    last = float(np.mean([x["loss"] for x in steps[-DEPTH_LOSS_WINDOW:]]))
    log("depth_step: per-step ms " + " ".join(f"{x['ms']:.1f}" for x in steps))
    log("depth_step: loss " + " ".join(f"{x['loss']:.4f}" for x in steps))
    log("depth_step: depth term " + " ".join(f"{x['depth']:.4f}"
                                             for x in steps))
    log(f"depth_step: step median {np.median(step_ms):.3f} ms (plain "
        f"training median of this call {train_median:.3f} ms) over steps "
        f"1-{DEPTH_STEPS - 1}; peak memory {peak / 2**30:.3f} GiB; launches "
        f"per step {per_step}; mean loss first {DEPTH_LOSS_WINDOW} steps "
        f"{first:.5f}, last {DEPTH_LOSS_WINDOW} {last:.5f}")
    if bad:
        failures.append(f"depth_step: non-finite depth term or state after "
                        f"steps {bad}")
    if not last < first:
        failures.append(f"depth_step: loss did not fall: {first} -> {last}")
    uneven = [x["step"] for x in steps if x["ran"]["rasterize_bwd"] != 2
              or min(x["ran"][k] for k in ("rasterize_fwd", "expand_with_keys",
                                           "pack_rows")) < 2]
    if uneven:
        failures.append(f"depth_step: steps without K2 twice and K1, K3, K4 "
                        f"at least twice: {uneven}")
    del model, trainer
    torch.cuda.empty_cache()
    return ({"steps": steps, "step_ms_median": float(np.median(step_ms)),
             "train_step_ms_median": train_median, "peak_bytes": peak,
             "launches_per_step": per_step, "loss_first_last": [first, last],
             "step0_replay": replay, "held_rows": held_rows},
            launches, errs, snapshot, batches, failures)


def spill_phase(snapshot, batches, device, log):
    """From one snapshot of the training tree: SPILL_STEPS steps (prepare +
    LoG.train_step, LOG_TPU_IDENTITY_STEP=0, fixed backgrounds) on the
    device path, then the same steps with both moment kinds spilled by
    maybe_spill (thresholds below the point count); then a host-path
    densify of the spilled model and SPILL_AFTER_DENSIFY more steps.
    Returns (json, launches by run, failures)."""
    import os

    import torch

    from log_tpu_torch.ops import kernels
    from log_tpu_torch.utils import hbm

    failures = []
    rng = np.random.default_rng(SEED + 3)
    bgs = [rng.random(3).astype(np.float32)
           for _ in range(SPILL_STEPS + SPILL_AFTER_DENSIFY)]
    index_checks = []

    def run(model, first, n):
        rows = []
        for i in range(first, first + n):
            b = batches[i % TRAIN_VIEWS]
            camera = {k: np.asarray(v)[0] for k, v in b["camera"].items()}
            gt = np.ascontiguousarray(b["image"][0].transpose(2, 0, 1))

            def one():
                model.prepare_from_camera(camera)
                return model.train_step(camera, gt, bgs[i], view_index=i %
                                        TRAIN_VIEWS)
            (met, aux), s = timed(one)
            if index_checks and index_checks[-1][1] is None:
                index_checks[-1][1] = aux["index"].cpu().numpy()
            rows.append({"step": i, "ms": s * 1e3, "loss": float(met["loss"])})
        return rows

    saved = os.environ.get("LOG_TPU_IDENTITY_STEP")
    os.environ["LOG_TPU_IDENTITY_STEP"] = "0"
    try:
        model = train_twin(snapshot, device)
        moment_bytes = sum(v.numel() * v.element_size()
                           for kind in model.optimizer.moments.values()
                           for v in kind.values())
        moment_cols = sum(int(np.prod(v.shape[1:])) for v in
                          model.optimizer.moments["exp_avg"].values())
        kernels.reset_launches()
        dev_steps, dev_mem = hbm.call_stats(run, model, 0, SPILL_STEPS)
        dev_launches = dict(kernels.LAUNCHES)
        want = snapshot_of(model)
        n0, cap0 = model.num_points, model.capacity
        del model
        torch.cuda.empty_cache()

        model = train_twin(snapshot, device)
        opt = model.optimizer
        opt.spill_points = opt.spill_points_full = model.num_points - 1
        did = opt.maybe_spill(model.num_points)
        pinned = all(v.is_pinned() for kind in opt.host_moments.values()
                     for v in kind.values())
        log(f"spill: maybe_spill({model.num_points}) with thresholds "
            f"{opt.spill_points} -> spilled {opt.spilled}, host tensors "
            f"pinned={pinned}; device moments {moment_cols} columns x "
            f"{cap0} rows x 2 kinds = {moment_bytes} bytes "
            f"({moment_bytes / 2**30:.3f} GiB)")
        if not (did and opt.spilled == ("exp_avg", "exp_avg_sq") and pinned
                and opt.moments == {"exp_avg": {}, "exp_avg_sq": {}}):
            failures.append(f"spill: maybe_spill left {opt.spilled}, "
                            f"pinned={pinned}")
        gather = opt.host_gather

        def record_gather(index):
            if not index_checks:
                index_checks.append([np.array(index), None])
            return gather(index)

        opt.host_gather = record_gather
        kernels.reset_launches()
        moved0 = dict(opt.transfer_bytes)
        spill_steps, spill_mem = hbm.call_stats(run, model, 0, SPILL_STEPS)
        spill_launches = dict(kernels.LAUNCHES)
        moved = {k: (opt.transfer_bytes[k] - moved0[k]) / SPILL_STEPS
                 for k in moved0}
        got = snapshot_of(model)
    finally:
        if saved is None:
            del os.environ["LOG_TPU_IDENTITY_STEP"]
        else:
            os.environ["LOG_TPU_IDENTITY_STEP"] = saved

    host_idx, step_idx = index_checks[0]
    same_index = np.array_equal(host_idx, step_idx)
    diffs = {k: float(np.abs(got[k].astype(np.float64)
                             - want[k].astype(np.float64)).max())
             for k in want if got[k].shape == want[k].shape
             and not np.array_equal(got[k], want[k])}
    shapes_ok = set(got) == set(want) and all(
        got[k].shape == want[k].shape for k in want)
    held = shapes_ok and all(
        np.allclose(got[k], want[k], rtol=SPILL_RTOL, atol=SPILL_ATOL)
        for k in diffs)
    drop = dev_mem["peak_bytes"] - spill_mem["peak_bytes"]
    dev_ms = [x["ms"] for x in dev_steps[1:]]
    sp_ms = [x["ms"] for x in spill_steps[1:]]
    log("spill: device path ms " + " ".join(f"{x['ms']:.1f}" for x in dev_steps)
        + "; spilled ms " + " ".join(f"{x['ms']:.1f}" for x in spill_steps))
    log(f"spill: step median device {np.median(dev_ms):.3f} ms, spilled "
        f"{np.median(sp_ms):.3f} ms (steps 1-{SPILL_STEPS - 1}); per spilled "
        f"step {moved['h2d'] / 2**20:.2f} MiB up, {moved['d2h'] / 2**20:.2f} "
        f"MiB down; peak device memory {dev_mem['peak_bytes'] / 2**30:.3f} "
        f"GiB device path, {spill_mem['peak_bytes'] / 2**30:.3f} GiB spilled "
        f"(drop {drop / 2**30:.3f} GiB = {drop / moment_bytes:.3f} of the "
        f"moments); host index = step index: {same_index} "
        f"({int((host_idx < cap0).sum())} rows of {host_idx.size} lanes)")
    log(f"spill: spilled vs device path after {SPILL_STEPS} steps: "
        + (f"{len(want)} arrays equal bit for bit" if not diffs else
           f"differ in {sorted(diffs)}, largest |d| {max(diffs.values()):.3g}"
           f" (held at rtol {SPILL_RTOL} atol {SPILL_ATOL}: {held})"))
    if not held:
        failures.append(f"spill: spilled run differs from the device path: "
                        f"{diffs}")
    if not same_index:
        failures.append("spill: the host gather index is not the step's index")
    if drop < SPILL_MEMORY_SHARE * moment_bytes:
        failures.append(f"spill: peak fell by {drop} bytes, under "
                        f"{SPILL_MEMORY_SHARE} of the {moment_bytes} moment "
                        f"bytes")
    for name, ran in (("device path", dev_launches), ("spilled", spill_launches)):
        if ran["rasterize_bwd"] != SPILL_STEPS or min(
                ran[k] for k in STEP_KERNELS) < SPILL_STEPS:
            failures.append(f"spill {name}: launches {ran} in {SPILL_STEPS} "
                            f"steps")

    # a host-path densify of the spilled model, then more steps
    d = model.densify_and_remove
    model.set_state(current_depth=20)  # what upgrade_tree sets
    d["min_steps_split"] = 0
    path = "device" if model._use_device_densify() else "host"
    _, dens_s = timed(lambda: model.update_depth_stage(SPILL_STEPS))
    host_ok = all(v.shape[0] == model.capacity and v.is_pinned()
                  for kind in opt.host_moments.values()
                  for v in kind.values())
    kernels.reset_launches()
    after = run(model, SPILL_STEPS, SPILL_AFTER_DENSIFY)
    after_launches = dict(kernels.LAUNCHES)
    finite = (_finite(model.gaussian.params())
              and _finite(*opt.host_moments.values())
              and all(math.isfinite(x["loss"]) for x in after))
    n1, cap1 = model.num_points, model.capacity
    log(f"spill: {path}-path densify {n0} -> {model.num_points} points, "
        f"capacity {cap0} -> {model.capacity}, {dens_s:.3f} s; host moments "
        f"at the new capacity and pinned: {host_ok}; {SPILL_AFTER_DENSIFY} "
        f"more steps ms " + " ".join(f"{x['ms']:.1f}" for x in after)
        + f", finite: {finite}")
    if path != "host" or not host_ok or not finite or n1 == n0:
        failures.append(f"spill densify: path {path}, host moments at "
                        f"capacity {host_ok}, finite {finite}, points "
                        f"{n0} -> {n1}")
    del model, opt
    torch.cuda.empty_cache()
    return ({"moment_bytes": moment_bytes, "moment_columns": moment_cols,
             "device_steps": dev_steps, "spilled_steps": spill_steps,
             "device_step_ms_median": float(np.median(dev_ms)),
             "spilled_step_ms_median": float(np.median(sp_ms)),
             "h2d_bytes_per_step": moved["h2d"],
             "d2h_bytes_per_step": moved["d2h"],
             "device_peak_bytes": dev_mem["peak_bytes"],
             "spilled_peak_bytes": spill_mem["peak_bytes"],
             "peak_drop_share": drop / moment_bytes,
             "max_abs_diff": diffs, "host_index_equal": same_index,
             "densify": {"path": path, "s": dens_s, "points_before": n0,
                         "points": n1, "capacity_before": cap0,
                         "capacity": cap1},
             "after_densify_steps": after},
            {"spill_device": dev_launches, "spill": spill_launches,
             "spill_after_densify": after_launches}, failures)


def write_root_cloud(path, log):
    """The synthetic scene's roots as a PLY (xyz, colors from their SH DC
    term), with the port's write_ply."""
    from log_tpu_torch.ops.sh import C0
    from log_tpu_torch.utils.file import write_ply
    from log_tpu_torch.utils.synth_tree import build_checkpoint

    ckpt = build_checkpoint(N_ROOTS, seed=SEED)
    xyz = ckpt["gaussian.xyz"][:N_ROOTS]
    colors = ckpt["gaussian.colors"][:N_ROOTS] * C0 + 0.5
    write_ply(path, xyz, colors)
    log(f"two-stage: wrote {N_ROOTS} roots to {path}")


def stage_batches(device, log):
    """The 4 training views at each stage's dataset scale, with GT from the
    unperturbed 3.24M-point tree."""
    import torch

    gt_model = build_model(N_ROOTS, device)
    out = {}
    for _, _, _, scale in STAGES:
        b = train_batches(h=H // scale, w=W // scale, focal=1400.0 / scale)
        render_ground_truth(gt_model, b, log)
        out[scale] = b
    del gt_model
    torch.cuda.empty_cache()
    return out


def two_stage_phase(device, log):
    """Phase 2: stages init and tree of config/synthetic/train.yml on the
    scene's roots as a point cloud, each step followed by
    update_by_iteration as the JAX package's Trainer.fit runs it. Returns
    (json, model, launches, held kernel errors, failures)."""
    import torch

    from log_tpu_torch.ops import kernels
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.config import load_object
    from log_tpu_torch.utils.trainer import Trainer

    failures, held_errs = [], {}
    batches = stage_batches(device, log)
    write_root_cloud(PLY_PATH, log)
    args = dict(MODEL_ARGS, gaussian=dict(
        MODEL_ARGS["gaussian"],
        init_ply={"filename": PLY_PATH, "init_opacity": 0.1}))
    model, setup_s = timed(lambda: load_object(
        "LoG.model.level_of_gaussian.LoG", args, device=device))
    model.base_iter = BASE_ITER
    log(f"two-stage: model from the point cloud, {model.num_points} points, "
        f"capacity {model.capacity}, {setup_s:.2f} s")

    # the init pass at the init stage's scale
    init_views = batches[STAGES[0][3]]
    model.at_init_start()
    for b in init_views:
        model.clear()
        model.init_view({k: np.asarray(v)[0] for k, v in b["camera"].items()})
    model.at_init_final()
    r3 = model.counter.data["radius3d_min"][:model.num_points]
    log(f"two-stage: init pass over {model.num_views} views: radius3d_min "
        f"< 1 on {float((r3 < 1).float().mean()):.4f} of the points; "
        f"{model}")

    renderer = NaiveRendererAndLoss(split="train", use_randback=True,
                                    device=device)
    trainer = Trainer({}, model, renderer, seed=SEED)
    sched = ScheduleLog(model, log)
    g = torch.Generator(device=device).manual_seed(SEED + 2)
    steps, missing, finite_fail, held = [], [], [], {}
    recorded = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    global_it = 0
    for stage, n_iter, state, scale in STAGES:
        n_iter *= BASE_ITER
        trainer.set_gt_cache(True)  # full frames
        model.set_stage(stage)
        model.set_state(**state)
        model.training_setup()
        views = batches[scale]
        densified = False
        for it in range(n_iter):
            before = dict(kernels.LAUNCHES)
            record = densified
            densified = False
            if record:
                calls = recorded[f"{stage} iteration {it}"] = {}
                with recording(calls):
                    (_, out, _), ms = timed(
                        lambda: trainer.training_step(model, views[it % 4]))
            else:
                (_, out, _), ms = timed(
                    lambda: trainer.training_step(model, views[it % 4]))
            trainer.global_iterations += 1
            steps.append({"stage": stage, "iteration": it, "ms": ms * 1e3,
                          "loss": float(out["metrics"]["loss"]),
                          "points": model.num_points})
            ran = {k: kernels.LAUNCHES[k] - before[k] for k in STEP_KERNELS}
            if min(ran.values()) < 1:
                missing.append((stage, it, ran))
            if not _finite(model.gaussian.params(),
                           model.optimizer.moments["exp_avg"],
                           model.optimizer.moments["exp_avg_sq"]):
                finite_fail.append((stage, it))
            if it + 1 >= n_iter:
                continue  # the last iteration skips the update
            first_init = (stage == "init" and "init" not in held
                          and model.densify_due(it)
                          and it + 1 != model.densify_and_remove[
                              "densify_from_iter"] * model.base_iter)
            if first_init:
                snapshot = snapshot_of(model)
                sched.inject = torch.rand(
                    (2, model.num_points), generator=g,
                    device=device).cpu().numpy()
                rand_u = sched.inject
            n_events = len(sched.events)
            sched.where = (stage, it)
            model.update_by_iteration(it, global_it)
            sched.where = None
            densified = any(e["action"].endswith("densify")
                            for e in sched.events[n_events:])
            if first_init:
                held["init"], f = hold_densify(
                    model, snapshot,
                    lambda twin: twin.update_init_stage(rand_u=rand_u),
                    "first init densify", device, log)
                failures += f
                del snapshot
            global_it += 1
    launches = dict(kernels.LAUNCHES)
    n_steps = len(steps)
    events = [(e["stage"], e["iteration"], e["action"]) for e in sched.events]
    want = [(stage, it, action) for stage, acts in EXPECTED_EVENTS.items()
            for it, action in acts]
    log(f"two-stage: {n_steps} steps, events {events}; launches {launches}")
    if events != want:
        failures.append(f"two-stage: schedule fired {events}, expected {want}")
    first = next((e for e in sched.events if e["action"] == "init_densify"),
                 {})
    if first.get("path") != "device":
        failures.append("two-stage: the first init densify did not take the "
                        "device path")
    if missing:
        failures.append(f"two-stage: steps without every kernel: {missing[:4]}")
    if finite_fail:
        failures.append(f"two-stage: non-finite state after {finite_fail[:4]}")
    tree_loss = [s["loss"] for s in steps if s["stage"] == "tree"]
    loss_first = float(np.mean(tree_loss[:8]))
    loss_last = float(np.mean(tree_loss[-8:]))
    log(f"two-stage: tree stage mean loss first 8 steps {loss_first:.5f}, "
        f"last 8 {loss_last:.5f}; "
        + "; ".join(f"{st} step ms median "
                    f"{np.median([s['ms'] for s in steps if s['stage'] == st]):.2f}"
                    for st, *_ in STAGES))
    if not loss_last < loss_first:
        failures.append(f"two-stage: tree loss did not fall: {loss_first} -> "
                        f"{loss_last}")
    for label, calls in recorded.items():
        errs, f = hold_calls(calls, f"two-stage {label}", log)
        failures += f
        for k, v in errs.items():
            held_errs[k] = max(held_errs.get(k, 0.0), v)
    del recorded
    del model.update_init_stage, model.update_depth_stage, model.upgrade_tree
    del model.counter.reset
    return ({"setup_s": setup_s, "events": sched.events, "steps": steps,
             "held": held, "tree_loss_first8": loss_first,
             "tree_loss_last8": loss_last, "launches": launches},
            model, launches, held_errs, failures)


def grown_frame_phase(model, device, log):
    """Phase 3: one generic 1920x1088 frame of the grown model through
    render_fused, held against its all-plain rerun. Returns (json,
    launches, held kernel errors, failures)."""
    import torch

    from log_tpu_torch.ops import kernels
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss

    renderer = NaiveRendererAndLoss(split="demo", device=device)
    batch = orbit_batches(1)[0]
    model.eval()
    calls = {}
    torch.cuda.synchronize()
    kernels.reset_launches()
    with recording(calls):
        out, s = timed(lambda: renderer.vis(batch, model))
    launches = dict(kernels.LAUNCHES)
    kern = out["render"][0]
    stats = model.frame_stats()
    failures = check_frames([kern], "grown frame")
    with plain_versions():
        plain = renderer.vis(batch, model)["render"][0]
    diff = float(np.abs(plain - kern).max())
    caches = {"tree": int(model._tree_dev["node_index"].shape[0]),
              "leaf_opt": int(model._leaf_opt_dev.shape[0]),
              "parent_xyz": int(model._tree_dev["parent_xyz"].shape[0])}
    log(f"grown frame: {model.num_points} points, capacity {model.capacity}, "
        f"{model.tree.num_nodes} tree nodes, depth "
        f"{int(model.tree.depth.max())}; cut {stats['cut']}, slice bucket "
        f"{stats['k_visible']}, pair budget {stats['max_pairs']}; "
        f"{s * 1e3:.1f} ms; device caches' rows {caches}; max |plain - "
        f"kernels| {diff:.4g}; launches {launches}")
    if diff > FRAME_MAX_ABS:
        failures.append(f"grown frame: plain frame differs by {diff}")
    if set(caches.values()) != {model.capacity}:
        failures.append(f"grown frame: device caches not at the capacity: "
                        f"{caches}")
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            failures.append(f"grown frame: kernel {name} never launched")
    errs, f = hold_calls(calls, "grown frame", log)
    failures += f
    return ({"ms": s * 1e3, "plain_frame_max_abs": diff, **stats,
             "points": model.num_points, "capacity": model.capacity,
             "launches": launches}, launches, errs, failures)


# -------------------------------------------------------------------- cli
def probe_packages(log):
    """Which optional host packages import, and whether ffmpeg is on PATH
    (the port's path must not depend on the answer)."""
    import importlib
    import shutil

    found = {}
    for name in ("cv2", "PIL", "yaml", "torchvision"):
        try:
            importlib.import_module(name)
            found[name] = True
        except Exception as exc:  # a probe: any import failure is "no"
            found[name] = f"no ({type(exc).__name__})"
    found["ffmpeg"] = shutil.which("ffmpeg") is not None
    log("probe: " + ", ".join(f"{k} {'imports' if v is True else v}"
                              if k != "ffmpeg" else
                              f"ffmpeg {'on PATH' if v else 'not on PATH'}"
                              for k, v in found.items()))
    return found


def _jax_curve():
    """The JAX package's validation curve of config/synthetic_conv
    (artifacts/r4_quality/scalars.jsonl): [(step, psnr, ssim)]."""
    rows = {}
    with open(CLI_JAX_CURVE) as f:
        for line in f:
            r = json.loads(line)
            if r["key"] in ("val/psnr", "val/ssim"):
                rows.setdefault(r["step"], {})[r["key"]] = r["val"]
    return [(s, v.get("val/psnr"), v.get("val/ssim"))
            for s, v in sorted(rows.items())]


def cli_phase(log):
    """The port's CLI on the config/synthetic_conv scene made on the card:
    make_synthetic_scene, train (the full schedule, every step's and every
    validation render's launches recorded), train again (resume-skip),
    final_val, demo_interpolate and val. Returns (json, launches by
    sub-phase and kind, calls by sub-phase and kind, held kernel errors,
    failures). cv2,
    PIL, PyYAML and torchvision are made unimportable for the phase, so
    that it runs as on a machine without them."""
    import os
    import shutil

    failures = []
    for d in (CLI_SCENE, os.path.dirname(CLI_EXP)):
        shutil.rmtree(d, ignore_errors=True)
    out = {"probe": probe_packages(log), "phase_s": {}}
    with blocked_imports(log):
        return _cli_phase(log, out, failures)


@contextlib.contextmanager
def blocked_imports(log):
    """CLI_BLOCKED made unimportable: the port's path must not need them,
    so importing one raises inside."""
    names = set(CLI_BLOCKED) | {m for m in sys.modules
                                if m.split(".")[0] in CLI_BLOCKED}
    saved = {name: sys.modules.get(name) for name in names}
    sys.modules.update(dict.fromkeys(names))
    log(f"imports of {', '.join(CLI_BLOCKED)} blocked")
    try:
        yield
    finally:
        for name, mod in saved.items():
            if mod is None:
                del sys.modules[name]
            else:
                sys.modules[name] = mod


def _cli_phase(log, out, failures):
    import os

    import torch

    from log_tpu_torch.apps import final_val, make_synthetic_scene, train
    from log_tpu_torch.model.level_of_gaussian import LoG
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.trainer import Trainer

    _, out["phase_s"]["scene"] = timed(
        lambda: make_synthetic_scene.main(CLI_SCENE_ARGS))
    log(f"cli scene: {' '.join(CLI_SCENE_ARGS)} in "
        f"{out['phase_s']['scene']:.2f} s")

    # every step, make_validation (training's and final_val's), render_one
    # and eval-mode frame (the init pass's, the demo's and val's) with its
    # launches, by sub-phase; the calls held against the plain versions
    # after the run, by label (copies, which later calls cannot overwrite)
    steps, vals, renders, frames, stage_t0 = [], [], [], [], {}
    held_calls = {}
    where = {"sub": "train"}
    # --profile: PROFILE_STEPS steps of the tree stage under torch.profiler
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if PROFILE else None
    real_step, real_val = Trainer.training_step, Trainer.make_validation
    real_one, real_stage = NaiveRendererAndLoss.render_one, LoG.set_stage
    real_vis = NaiveRendererAndLoss.vis

    def ran_since(before):
        return {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}

    def step(self, model, data):
        if PROFILE and len(steps) == CLI_PROFILE_AT:
            torch.cuda.synchronize()
            prof.start()
        # the first step of each stage after a densify changed the points
        prev = steps[-1] if steps else None
        label = f"cli {model.stage_name} step after a densify"
        hold = (prev is not None and prev["stage"] == model.stage_name
                and prev["points"] != model.num_points
                and label not in held_calls)
        calls = held_calls.setdefault(label, {}) if hold else None
        before = dict(kernels.LAUNCHES)
        with recording(calls, copy=True) if hold else contextlib.nullcontext():
            (ok, output, loss), s = timed(lambda: real_step(self, model, data))
        if PROFILE and len(steps) == CLI_PROFILE_AT + PROFILE_STEPS - 1:
            prof.stop()
        steps.append({"sub": where["sub"], "stage": model.stage_name,
                      "ms": s * 1e3, "loss": float(output["loss_dev"]),
                      "points": model.num_points, "ran": ran_since(before)})
        return ok, output, loss

    def one(self, model, camera, background):
        label = f"cli {where['sub']} validation render"
        hold = label not in held_calls
        calls = {}
        before = dict(kernels.LAUNCHES)
        with recording(calls, copy=hold):
            res = real_one(self, model, camera, background)
        if hold:
            held_calls[label] = calls
        renders.append({
            "sub": where["sub"], "ran": ran_since(before),
            "k1_modes": [a[6] for a, _ in calls.get("rasterize_fwd", [])]})
        return res

    def frame(self, batch, model, background=None):
        if getattr(model, "training", False):  # through render_one
            return real_vis(self, batch, model, background)
        sub = where["sub"]
        n = sum(f["sub"] == sub for f in frames)
        hold = n == CLI_HELD_FRAME.get(sub)
        calls = held_calls.setdefault(f"cli {sub} frame {n}", {}) \
            if hold else None
        before = dict(kernels.LAUNCHES)
        with recording(calls, copy=True) if hold else contextlib.nullcontext():
            res = real_vis(self, batch, model, background)
        frames.append({"sub": sub, "ran": ran_since(before)})
        return res

    def val(self, iteration, visualize=False):
        # a validation view: its prepare_from_camera (the cull render) and
        # its render_one
        before, n = dict(kernels.LAUNCHES), len(renders)
        rec, s = timed(lambda: real_val(self, iteration, visualize))
        vals.append(dict(rec, s=s, stage=self.model.stage_name,
                         sub=where["sub"], ran=ran_since(before),
                         views=len(renders) - n))
        return rec

    def set_stage(self, stage_name):
        stage_t0[stage_name] = time.perf_counter()
        return real_stage(self, stage_name)

    launches, n_calls = {}, {}

    def run(sub, fn):
        """fn() as sub-phase `sub`: its launches split into those of its
        steps, validation views and frames (n_calls counted in this run)
        and any outside them."""
        where["sub"] = sub
        kernels.reset_launches()
        res, s = timed(fn)
        total = dict(kernels.LAUNCHES)
        counted = dict.fromkeys(total, 0)
        for kind, rows in (("steps", steps), ("views", vals),
                           ("frames", frames)):
            rows = [x for x in rows if x["sub"] == sub]
            if rows:
                ran = {k: sum(x["ran"][k] for x in rows) for k in total}
                launches[f"cli_{sub}_{kind}"] = ran
                n_calls[f"cli_{sub}_{kind}"] = sum(x.get("views", 1)
                                                   for x in rows)
                counted = {k: counted[k] + ran[k] for k in total}
        other = {k: total[k] - counted[k] for k in total}
        if any(other.values()):
            launches[f"cli_{sub}_other"] = other
        log(f"cli {sub}: launches by kind "
            + "; ".join(f"{key[len(sub) + 5:]} {launches[key]} in "
                        f"{n_calls.get(key, 'no counted')} calls"
                        for key in launches if key.startswith(f"cli_{sub}_")))
        return res, s

    argv = ["--cfg", CLI_CFG, "split"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ckpt = os.path.join(CLI_EXP, "model_tree_full.pth")
    with patched(Trainer, {"training_step": step, "make_validation": val}), \
            patched(NaiveRendererAndLoss, {"render_one": one, "vis": frame}), \
            patched(LoG, {"set_stage": set_stage}):
        trainer, train_s = run("train", lambda: train.main(
            argv + ["train"] + CLI_OPTS))
        t_end = time.perf_counter()
        peak = torch.cuda.max_memory_allocated()
        trainer2, resume_s = run("resume", lambda: train.main(
            argv + ["train"] + CLI_OPTS))
        n_resumed = sum(x["sub"] == "resume" for x in steps)
        resumed_points = trainer2.model.num_points
        trained_points = trainer.model.num_points
        trained_depth = int(trainer.model.tree.depth.max())
        del trainer, trainer2
        torch.cuda.empty_cache()
        # final-val, then the demo and val splits of the last checkpoint
        record, fv_s = run("final_val", lambda: final_val.main(
            [CLI_CFG, ckpt] + CLI_OPTS))
        demo_ms, demo_s = run("demo", lambda: train.main(
            argv + ["demo_interpolate", "ckptname", ckpt] + CLI_DEMO_OPTS
            + CLI_OPTS))
        val_ms, val_s = run("val", lambda: train.main(
            argv + ["val", "ckptname", ckpt] + CLI_OPTS))
    out["phase_s"].update(train=train_s, resume=resume_s, final_val=fv_s,
                          demo=demo_s, val=val_s)
    stages = list(stage_t0)
    bounds = [stage_t0[s] for s in stages] + [t_end]
    stage_s = {s: bounds[i + 1] - bounds[i] for i, s in enumerate(stages)}
    train_steps = [x for x in steps if x["sub"] == "train"]
    by_stage = {s: [x for x in train_steps if x["stage"] == s]
                for s in stages}
    step_ms = [x["ms"] for x in train_steps]
    log(f"cli train: {len(train_steps)} steps in {train_s:.2f} s, stages "
        + ", ".join(f"{s} {len(by_stage[s])} steps {stage_s[s]:.2f} s (step "
                    f"median {np.median([x['ms'] for x in by_stage[s]]):.2f} "
                    f"ms)" for s in stages)
        + f"; step median {np.median(step_ms):.3f} ms; peak memory "
        f"{peak / 2**30:.3f} GiB; {trained_points} points, depth "
        f"{trained_depth}")
    if PROFILE:
        window = steps[CLI_PROFILE_AT:CLI_PROFILE_AT + PROFILE_STEPS]
        report_profile("cli_train", prof, PROFILE_STEPS,
                       float(np.median([x["ms"] for x in by_stage["tree"]])),
                       log, ranges=True)
        log(f"  profiled steps: {window[0]['stage']} stage, "
            f"{window[0]['points']} points, "
            + " ".join(f"{x['ms']:.1f}" for x in window) + " ms")
    for v in vals:
        log(f"  val at {v['iteration']} ({v['sub']}, {v['stage']}): psnr "
            f"{v['psnr']:.3f} "
            f"ssim {v['ssim']:.4f} l1 {v['l1']:.4f}, {v['num_points']} "
            f"points, {v['s']:.2f} s")
    log("  JAX package's curve (artifacts/r4_quality, .jpg scene, step: "
        "psnr/ssim): "
        + ", ".join(f"{s}: {p:.2f}/{q:.4f}" for s, p, q in _jax_curve()))
    missing = [(i, x["stage"], x["ran"]) for i, x in enumerate(train_steps)
               if min(x["ran"][k] for k in STEP_KERNELS) < 1]
    if missing:
        failures.append(f"cli train: steps without every kernel: "
                        f"{missing[:4]}")
    bad_renders = [r for r in renders
                   if min(r["ran"][k] for k in SERVING_KERNELS) < 1
                   or set(r["k1_modes"]) != {False}]
    if not renders or bad_renders:
        failures.append(f"cli validation renders without K4/K3/K1 "
                        f"(with_stats=False): {bad_renders[:2]} of "
                        f"{len(renders)}")
    for s in ("init", "tree"):
        losses = [x["loss"] for x in by_stage.get(s, [])]
        first = float(np.mean(losses[:CLI_LOSS_WINDOW]))
        last = float(np.mean(losses[-CLI_LOSS_WINDOW:]))
        out[f"{s}_loss_first_last"] = [first, last]
        log(f"cli {s}: mean loss first {CLI_LOSS_WINDOW} steps {first:.5f}, "
            f"last {CLI_LOSS_WINDOW} {last:.5f}")
        if not (len(losses) >= 2 * CLI_LOSS_WINDOW and last < first):
            failures.append(f"cli {s}: loss did not fall ({first} -> {last})")
    if not vals or any(set(CLI_VAL_KEYS) - set(v) for v in vals):
        failures.append("cli: validation records without their keys")
    ckpts = [os.path.join(CLI_EXP, f"model_{s}{w}.pth")
             for s in ("init", "tree", "tree_full") for w in ("", "_wotrain")]
    if not all(os.path.exists(c) for c in ckpts):
        failures.append(f"cli: stage checkpoints missing: "
                        f"{[c for c in ckpts if not os.path.exists(c)]}")
    log(f"cli resume: {resume_s:.2f} s, {n_resumed} steps, {resumed_points} "
        f"points (trained {trained_points})")
    if n_resumed or resumed_points != trained_points:
        failures.append(f"cli resume-skip took {n_resumed} steps")

    log(f"cli final-val: psnr {record['psnr']:.3f} ssim {record['ssim']:.4f} "
        f"l1 {record['l1']:.4f}, {record['num_points']} points (JAX package "
        f"on the .jpg scene {CLI_JAX_FINAL})")
    if record["psnr"] < CLI_MIN_PSNR or record["ssim"] < CLI_MIN_SSIM:
        failures.append(f"cli final-val below {CLI_MIN_PSNR} dB / "
                        f"{CLI_MIN_SSIM}: {record}")
    # .png frames: no JPEG encoder imports in this phase
    demo_files = os.listdir(os.path.join(CLI_EXP, "demo_interpolate", "rgb"))
    demo_launches = launches.get("cli_demo_frames", {})
    log(f"cli demo_interpolate: {len(demo_files)} frames, average frame "
        f"{demo_ms:.3f} ms (K3p launches only where the slice bucket is a "
        f"multiple of 32768)")
    if len(demo_files) != CLI_DEMO_FRAMES or n_calls.get("cli_demo_frames") \
            != CLI_DEMO_FRAMES + min(CLI_DEMO_WARMUP, CLI_DEMO_FRAMES):
        failures.append(f"cli demo wrote {len(demo_files)} frames in "
                        f"{n_calls.get('cli_demo_frames')} renders")
    if min(demo_launches.get(k, 0) for k in CLI_DEMO_KERNELS) < 1:
        failures.append(f"cli demo did not launch {CLI_DEMO_KERNELS}")
    dumps = {d: len(os.listdir(os.path.join(CLI_EXP, "test", "scale_1", d)))
             for d in ("gt", "renders")}
    log(f"cli val: {dumps} at scale 1, frame ms {val_ms}")
    if dumps != {"gt": 3, "renders": 3} or n_calls.get("cli_val_frames") != 3:
        failures.append(f"cli val dumps: {dumps} from "
                        f"{n_calls.get('cli_val_frames')} renders")

    # the recorded steps, renders and frames against the plain versions
    errs = {}
    want = [f"cli {s} step after a densify" for s in ("init", "tree")] + [
        "cli train validation render", "cli final_val validation render",
        f"cli demo frame {CLI_HELD_FRAME['demo']}",
        f"cli val frame {CLI_HELD_FRAME['val']}"]
    if set(want) - set(held_calls):
        failures.append(f"cli: no calls recorded for "
                        f"{sorted(set(want) - set(held_calls))}")
    for label, calls in held_calls.items():
        e, f = hold_calls(calls, label, log)
        failures += f
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
    held_kernels = sorted(errs)
    log(f"cli: kernels held against their plain versions on this path's "
        f"calls: {held_kernels}")
    del held_calls
    out.update(
        steps=len(step_ms), step_ms_median=float(np.median(step_ms)),
        stage_s=stage_s,
        stage_step_ms_median={s: float(np.median([x["ms"] for x in v]))
                              for s, v in by_stage.items()},
        peak_bytes=peak, points=record["num_points"], vals=vals,
        final_val=record, demo_frame_ms=demo_ms, demo_frames=len(demo_files),
        val_frame_ms=val_ms, launches=launches, calls=n_calls,
        val_renders=sum(r["sub"] == "train" for r in renders),
        jax_final=CLI_JAX_FINAL)
    return out, launches, n_calls, errs, failures


def write_cli_depth_maps(log, device="cuda"):
    """16-bit inverse-depth maps (inverse_depth_u16) of the cli scene's
    views at CLI_DEPTH_SCALE, where DepthDataset looks for them
    (cache/<scale>/depth/cam/<name><ext>.png), rendered on the card by the
    oracle from the scene's own generator Gaussians (the draws of
    SyntheticDataset with seed 0) with (camera depth, world z, 1) as
    colors over a black background. Returns the number written."""
    import os

    import torch

    from log_tpu_torch.dataset.base import prepare_camera, rescale_camera
    from log_tpu_torch.dataset.synthetic import random_gaussians, ring_cameras
    from log_tpu_torch.ops.projection import project_gaussians
    from log_tpu_torch.ops.rasterize_ref import rasterize
    from log_tpu_torch.utils import image_io

    n, views, h, w = (int(a) for a in CLI_SCENE_ARGS[1:5])
    ext = CLI_SCENE_ARGS[5]
    g = {k: torch.from_numpy(v).to(device) for k, v in
         random_gaussians(n, np.random.default_rng(0)).items()}
    ones = torch.ones_like(g["xyz"][:, 2])
    root = os.path.join(os.path.abspath(CLI_SCENE), "cache",
                        str(CLI_DEPTH_SCALE), "depth", "cam")
    for i, cam in enumerate(ring_cameras(views, h, w)):
        pc = prepare_camera(rescale_camera(cam, CLI_DEPTH_SCALE), 1, 0.01,
                            100.0)
        tx, ty = math.tan(pc["FoVx"] * 0.5), math.tan(pc["FoVy"] * 0.5)
        kw = dict(
            xyz=g["xyz"], opacity=g["opacity"], scaling=g["scaling"],
            rotation=g["rotation"], means2d_offset=torch.zeros_like(
                g["xyz"][:, :2]),
            world_view=torch.from_numpy(pc["world_view_transform"]).to(device),
            full_proj=torch.from_numpy(pc["full_proj_transform"]).to(device),
            focal_x=pc["image_width"] / (2 * tx),
            focal_y=pc["image_height"] / (2 * ty), tan_fovx=tx, tan_fovy=ty,
            background=torch.zeros(3, device=device),
            image_height=pc["image_height"], image_width=pc["image_width"],
            use_filter=False)
        with torch.no_grad():
            depth_cam = project_gaussians(
                kw["xyz"], kw["scaling"], kw["rotation"], kw["opacity"],
                kw["world_view"], kw["full_proj"], kw["focal_x"],
                kw["focal_y"], tx, ty, kw["image_height"], kw["image_width"],
                use_filter=False).depth
            # chunks of 1024 Gaussians: 20 sequential chunks per map
            out = rasterize(colors=torch.stack([depth_cam, g["xyz"][:, 2],
                                                ones], -1), chunk=1024,
                            **kw)["render"]
        out = out.cpu().numpy()
        image_io.imwrite(os.path.join(root, f"{i:04d}{ext}.png"),
                         inverse_depth_u16(out[0], out[2]))
    log(f"cli_depth: {views} inverse-depth maps {pc['image_width']}x"
        f"{pc['image_height']} (scale {CLI_DEPTH_SCALE}) under {root}")
    return views


def cli_depth_phase(plain_final, log, device="cuda"):
    """The cli scene with depth maps (write_cli_depth_maps) through the
    port's CLI with train_wdepth.yml's overrides (DepthDataset at
    CLI_DEPTH_SCALE, render_depth): train (the full schedule), final_val,
    then demo_interpolate with render_type depth and height. Returns (json,
    launches by sub-phase, calls by sub-phase, held kernel errors,
    failures)."""
    import os
    import shutil

    shutil.rmtree(os.path.dirname(CLI_DEPTH_EXP), ignore_errors=True)
    with blocked_imports(log):
        return _cli_depth_phase(plain_final, log, device)


def _cli_depth_phase(plain_final, log, device):
    import os

    import torch

    from log_tpu_torch.apps import final_val, train
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils import image_io
    from log_tpu_torch.utils.trainer import Trainer

    failures, out = [], {"phase_s": {}}
    _, out["phase_s"]["maps"] = timed(lambda: write_cli_depth_maps(log,
                                                                   device))
    opts = list(CLI_OPTS)
    opts[opts.index("exp") + 1] = CLI_DEPTH_EXP
    opts += CLI_DEPTH_OPTS
    steps, frames, views, held, taken = [], [], [], {}, {}
    where = {"sub": "train"}
    real_step, real_vis = Trainer.training_step, NaiveRendererAndLoss.vis
    real_one = NaiveRendererAndLoss.render_one

    def ran_since(before):
        return {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}

    def step(self, model, data):
        # the tree stage's first step after a densify, held afterwards
        prev = steps[-1] if steps else None
        label = "cli_depth tree step after a densify"
        hold = (model.stage_name == "tree" and prev is not None
                and prev["stage"] == "tree"
                and prev["points"] != model.num_points and label not in held)
        calls = held.setdefault(label, {}) if hold else None
        before = dict(kernels.LAUNCHES)
        with recording(calls, copy=True) if hold else contextlib.nullcontext():
            (ok, output, loss), s = timed(lambda: real_step(self, model, data))
        met = output["metrics"]
        steps.append({"stage": model.stage_name, "ms": s * 1e3,
                      "loss": float(output["loss_dev"]),
                      "depth": float(met["depth"]) if "depth" in met else None,
                      "points": model.num_points, "ran": ran_since(before)})
        return ok, output, loss

    def one(self, *args, **kwargs):
        before = dict(kernels.LAUNCHES)
        res = real_one(self, *args, **kwargs)
        views.append({"sub": where["sub"], "ran": ran_since(before)})
        return res

    def frame(self, batch, model, background=None):
        if getattr(model, "training", False):
            return real_vis(self, batch, model, background)
        before = dict(kernels.LAUNCHES)
        res = real_vis(self, batch, model, background)
        sub = where["sub"]
        n = sum(f["sub"] == sub for f in frames)
        frames.append({"sub": sub, "ran": ran_since(before)})
        if n == CLI_DEMO_WARMUP:  # the first timed frame: 000000
            taken[sub] = {k: np.array(res[k][0]) for k in
                          ("depth", "height", "accmap") if k in res}
        return res

    launches, n_calls = {}, {}

    def run(sub, fn, calls):
        """fn() as sub-phase `sub`: its launches, those of `calls` (the
        steps or frames it ran, each with its own count) apart from any
        others (validation views, the init pass)."""
        where["sub"] = sub
        kernels.reset_launches()
        n0 = len(calls)
        res, s = timed(fn)
        total = dict(kernels.LAUNCHES)
        mine = [x for x in calls[n0:] if x.get("sub", sub) == sub]
        ran = {k: sum(x["ran"][k] for x in mine) for k in total}
        launches[f"cli_depth_{sub}"] = ran
        n_calls[f"cli_depth_{sub}"] = len(mine)
        other = {k: total[k] - ran[k] for k in total}
        if any(other.values()):
            launches[f"cli_depth_{sub}_other"] = other
        log(f"cli_depth {sub}: {s:.2f} s, launches {ran} in {len(mine)} "
            f"calls, {other} outside them")
        return res, s

    argv = ["--cfg", CLI_CFG, "split"]
    ckpt = os.path.join(CLI_DEPTH_EXP, "model_tree_full.pth")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with patched(Trainer, {"training_step": step}), \
            patched(NaiveRendererAndLoss, {"vis": frame, "render_one": one}):
        trainer, out["phase_s"]["train"] = run(
            "train", lambda: train.main(argv + ["train"] + opts), steps)
        peak = torch.cuda.max_memory_allocated()
        points = trainer.model.num_points
        del trainer
        torch.cuda.empty_cache()
        record, out["phase_s"]["final_val"] = run(
            "final_val", lambda: final_val.main([CLI_CFG, ckpt] + opts),
            views)
        demo_ms = {}
        for kind, (lo, hi) in CLI_DEPTH_RANGES.items():
            demo_ms[kind], out["phase_s"][f"demo_{kind}"] = run(
                f"demo_{kind}", lambda: train.main(
                    argv + ["demo_interpolate", "ckptname", ckpt,
                            "render_type", kind, f"{kind}_min", str(lo),
                            f"{kind}_max", str(hi)] + opts), frames)
    by_stage = {}
    for x in steps:
        by_stage.setdefault(x["stage"], []).append(x)
    step_ms = [x["ms"] for x in steps]
    log(f"cli_depth train: {len(steps)} steps, "
        + ", ".join(f"{st} {len(v)} steps (median "
                    f"{np.median([x['ms'] for x in v]):.2f} ms)"
                    for st, v in by_stage.items())
        + f"; step median {np.median(step_ms):.3f} ms; peak memory "
        f"{peak / 2**30:.3f} GiB; {points} points")
    no_depth = [i for i, x in enumerate(steps)
                if x["depth"] is None or not math.isfinite(x["depth"])]
    uneven = [i for i, x in enumerate(steps) if x["ran"]["rasterize_bwd"] != 2
              or min(x["ran"][k] for k in SERVING_KERNELS) < 2]
    if not steps or no_depth or uneven:
        failures.append(f"cli_depth train: steps without a finite depth term "
                        f"{no_depth[:4]}, without K2 twice and K1, K3, K4 at "
                        f"least twice {uneven[:4]}")
    for st in ("init", "tree"):
        losses = [x["loss"] for x in by_stage.get(st, [])]
        first = float(np.mean(losses[:CLI_LOSS_WINDOW]))
        last = float(np.mean(losses[-CLI_LOSS_WINDOW:]))
        out[f"{st}_loss_first_last"] = [first, last]
        log(f"cli_depth {st}: mean loss first {CLI_LOSS_WINDOW} steps "
            f"{first:.5f}, last {CLI_LOSS_WINDOW} {last:.5f}")
        if not (len(losses) >= 2 * CLI_LOSS_WINDOW and last < first):
            failures.append(f"cli_depth {st}: loss did not fall ({first} -> "
                            f"{last})")
    log(f"cli_depth final-val: psnr {record['psnr']:.3f} ssim "
        f"{record['ssim']:.4f} l1 {record['l1']:.4f}, {record['num_points']} "
        f"points; the plain cli run of this call: psnr "
        f"{plain_final['psnr']:.3f} ssim {plain_final['ssim']:.4f}")
    if record["psnr"] < CLI_MIN_PSNR or record["ssim"] < CLI_MIN_SSIM:
        failures.append(f"cli_depth final-val below {CLI_MIN_PSNR} dB / "
                        f"{CLI_MIN_SSIM}: {record}")
    for kind, (lo, hi) in CLI_DEPTH_RANGES.items():
        sub = f"demo_{kind}"
        folder = os.path.join(CLI_DEPTH_EXP, "demo_interpolate", kind)
        names = sorted(os.listdir(folder)) if os.path.isdir(folder) else []
        imgs = [image_io.imread(os.path.join(folder, f)) for f in names]
        flat = [f for f, im in zip(names, imgs) if int(im.max()) == int(im.min())]
        n_frames = sum(f["sub"] == sub for f in frames)
        ran = launches.get(f"cli_depth_{sub}", {})
        same = False
        if sub in taken and imgs:
            want = NaiveRendererAndLoss.marigold_depth_vis(
                (taken[sub][kind] - lo) / (hi - lo))
            same = np.array_equal(imgs[0], want)
        log(f"cli_depth {sub}: {len(names)} frames ({names[:1]}...), "
            f"{len(flat)} constant, frame {CLI_DEMO_WARMUP} of vis in "
            f"Spectral colors equals {names[:1]}: {same}; average frame "
            f"{demo_ms[kind]:.3f} ms")
        if (len(names) != CLI_DEMO_FRAMES or flat or not same
                or n_frames != CLI_DEMO_FRAMES + CLI_DEMO_WARMUP
                or min(ran.get(k, 0) for k in SERVING_KERNELS) < 2 * n_frames):
            failures.append(f"cli_depth {sub}: {len(names)} frames, constant "
                            f"{flat[:3]}, equal to vis {same}, {n_frames} "
                            f"renders, launches {ran}")
    errs = {}
    if not held:
        failures.append("cli_depth: no tree step after a densify recorded")
    for label, calls in held.items():
        modes = sorted(str(a[6]) for a, _ in calls.get("rasterize_fwd", []))
        if "False" not in modes or len(calls.get("rasterize_bwd", [])) != 2:
            failures.append(f"{label}: K1 modes {modes}, "
                            f"{len(calls.get('rasterize_bwd', []))} K2 calls")
        e, f = hold_calls(calls, label, log)
        failures += f
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
    del held
    out.update(steps=len(steps), step_ms_median=float(np.median(step_ms)),
               stage_step_ms_median={st: float(np.median(
                   [x["ms"] for x in v])) for st, v in by_stage.items()},
               peak_bytes=peak, points=points, final_val=record,
               plain_final_val=plain_final, demo_frame_ms=demo_ms)
    return out, launches, n_calls, errs, failures


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
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            failures.append(f"kernel {name} never launched on the serving "
                            f"path")
    failures += check_frames(renders, "slice")
    if PROFILE:
        profile_frames("generic", model, renderer, batches, frame_ms, log)

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
    serve_runs = {"generic": launches}

    # ------------------------------------------- flat_slice, K6, blocks
    generic0 = (renders[0], telemetry[0]["cut"])
    new_json, new_rows, new_runs, nfail = render_slice_phases(
        model, renderer, batches, generic0, log)
    failures += nfail
    rows.update(new_rows)
    serve_runs.update(new_runs)

    o_max, o_mean = oracle_check(device, log)
    if o_max > ORACLE_MAX_ABS or o_mean > ORACLE_MEAN_ABS:
        failures.append(f"small tree disagrees with the oracle: {o_max}")
    slice_json = {"frame_ms_mean": float(np.mean(frame_ms)),
                  "frame_ms": frame_ms, "plain_frame_ms": plain_ms,
                  "frames": telemetry, "peak_bytes": peak, "build_s": build_s,
                  **new_json}
    del model, renders, plain, kern, generic0
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- training
    t0 = time.perf_counter()
    model = build_train_model(device)
    batches = train_batches()
    make_ground_truth(model, batches, device, log)
    torch.cuda.synchronize()
    log(f"train setup: {model.num_points} points, base_iter "
        f"{model.base_iter}, {TRAIN_VIEWS} views, "
        f"{time.perf_counter() - t0:.2f} s")
    steps, t_launches, t_peak, finite_fail, step0, trainer = run_train_slice(
        model, batches, device, log)
    step_ms = [s["ms"] for s in steps[1:]]
    log(f"train: step ms median {np.median(step_ms):.3f} (min "
        f"{np.min(step_ms):.3f}, max {np.max(step_ms):.3f}) over "
        f"{len(step_ms)} steps after step 0 ({steps[0]['ms']:.1f} ms); peak "
        f"memory {t_peak / 2**30:.3f} GiB; launches {t_launches}")
    if finite_fail:
        failures.append(f"non-finite parameters or moments after steps "
                        f"{finite_fail}")
    if t_launches["rasterize_bwd"] != TRAIN_STEPS:
        failures.append(f"K2 launched {t_launches['rasterize_bwd']} times in "
                        f"{TRAIN_STEPS} steps")
    if t_launches["rasterize_fwd"] < 2 * TRAIN_STEPS:
        failures.append("K1 launched fewer than twice per step")
    for name in ("pack_rows", "expand_with_keys"):
        if t_launches[name] < TRAIN_STEPS:
            failures.append(f"kernel {name} not launched in every step")
    first = float(np.mean([s["loss"] for s in steps[:TRAIN_VIEWS]]))
    last = float(np.mean([s["loss"] for s in steps[-TRAIN_VIEWS:]]))
    log(f"train: mean loss first {TRAIN_VIEWS} steps {first:.5f}, last "
        f"{TRAIN_VIEWS} {last:.5f}")
    if not last < first:
        failures.append(f"loss did not fall: {first} -> {last}")
    corr = [s["correction"] for s in steps]
    want_corr = [i >= BASE_ITER for i in range(TRAIN_STEPS)]
    gains = model._corr_dev["values"] if model._corr_dev is not None else None
    if corr != want_corr or gains is None or bool((gains == 1.0).all()):
        failures.append("the per-view gain did not run from base_iter on")
    else:
        log(f"view gains after training: {gains.cpu().numpy().round(4).tolist()}")
    keep = model.visibility_flag["keep_mask"]
    vis_share = float((model.counter.data["visible_count"][keep] > 0)
                      .float().mean())
    area_share = float((model.counter.data["area_sum"][keep] > 0)
                       .float().mean())
    log(f"counters on the last step's {int(keep.sum())} kept rows: "
        f"visible_count > 0 on {vis_share:.4f}, area_sum > 0 on "
        f"{area_share:.4f}")
    if vis_share < 0.95 or area_share <= 0.0:
        failures.append("counters not filled on the kept rows")
    rows["rasterize_bwd"], kfail = compare_k2(step0["calls"], log)
    failures += kfail
    step_modes, kfail = compare_k1_step(step0["calls"], log)
    failures += kfail
    rows["rasterize_fwd"]["modes"] += step_modes
    rows["rasterize_fwd"]["max_abs_err"] = max(
        m["max_abs_err"] for m in rows["rasterize_fwd"]["modes"])
    replay, sfail = replay_step0(step0, log)
    failures += sfail
    del step0
    if PROFILE:
        profile_steps(model, trainer, batches, float(np.median(step_ms)), log)

    # ------------------------------------------------------------ growth
    held = {}
    growth_json, g_launches, held["growth"], gfail = growth_phase(
        model, trainer, batches, step_ms, device, log)
    failures += gfail
    del model, trainer, batches
    torch.cuda.empty_cache()
    # ------------------------------------------------- depth and spill
    depth_json, d_launches, held["depth_step"], snapshot, batches, dfail = \
        depth_step_phase(device, float(np.median(step_ms)), log)
    failures += dfail
    rows["rasterize_fwd"]["modes"] += depth_json["held_rows"].get(
        "rasterize_fwd", [])
    rows["rasterize_bwd"]["depth_step_calls"] = depth_json["held_rows"].get(
        "rasterize_bwd", [])
    spill_json, s_launches, sfail = spill_phase(snapshot, batches, device,
                                                log)
    failures += sfail
    del snapshot, batches
    torch.cuda.empty_cache()
    two_json, model, ts_launches, held["two_stage"], tfail = two_stage_phase(
        device, log)
    failures += tfail
    frame_json, gf_launches, held["grown_frame"], ffail = grown_frame_phase(
        model, device, log)
    failures += ffail
    del model
    torch.cuda.empty_cache()
    cli_json, cli_launches, cli_calls, held["cli"], cfail = cli_phase(log)
    failures += cfail
    cd_json, cd_launches, cd_calls, held["cli_depth"], cdfail = \
        cli_depth_phase(cli_json["final_val"], log)
    failures += cdfail

    log(json.dumps({
        "slice": slice_json,
        "train": {"step_ms_median": float(np.median(step_ms)),
                  "step_ms_min": float(np.min(step_ms)),
                  "step_ms_max": float(np.max(step_ms)),
                  "steps": steps, "peak_bytes": t_peak,
                  "launches": t_launches, "step0_replay": replay},
        "growth": growth_json, "depth_step": depth_json,
        "spill": spill_json, "two_stage": two_json,
        "grown_frame": frame_json, "cli": cli_json, "cli_depth": cd_json,
    }))
    kernels_json = []
    runs = dict(serve_runs, train=t_launches, growth=g_launches,
                depth_step=d_launches, **s_launches, two_stage=ts_launches,
                grown_frame=gf_launches, **cli_launches, **cd_launches)
    # main-path calls per phase: frames, training steps, or renders
    n_calls = dict({phase: FRAMES for phase in serve_runs},
                   train=TRAIN_STEPS, growth=GROWTH_STEPS,
                   depth_step=DEPTH_STEPS, spill_device=SPILL_STEPS,
                   spill=SPILL_STEPS, spill_after_densify=SPILL_AFTER_DENSIFY,
                   two_stage=len(two_json["steps"]), grown_frame=1,
                   **cli_calls, **cd_calls)
    # the growth phases' own calls held against the plain versions
    for phase, errs in held.items():
        for name, err in errs.items():
            rows[name].setdefault("max_abs_err_by_phase", {})[phase] = err
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    for name, (src, replaces) in KERNEL_SOURCES.items():
        by_phase = {phase: run[name] for phase, run in runs.items()}
        kernels_json.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "launches_per_call": {phase: n / n_calls[phase]
                                  for phase, n in by_phase.items()
                                  if n and n_calls.get(phase)},
            "library_ms": None, "library_note": NO_LIBRARY_CALL[name],
            **rows[name]})
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
