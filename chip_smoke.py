#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (log_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --only multi

Needs a CUDA device and nvcc; exits non-zero without them. `--only multi`
runs the header and the kernel build, then only the multi-card phases of
14 (multi_rank_phase, on the training snapshot of 6), and fails with fewer
than two cards. Phases:

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
   counted on the card in plain torch); to_host (the 8-bit handoff, the
   port's own kernel) on a served frame's render (a strided view) and
   alpha, and later on the training step's cached uint8 GT, bit-exact
   against its plain version, timed beside a pinned copy_ of the same
   bytes, its bound those bytes over the host link's rate (a pinned copy_
   of 256 MiB); and the host ms of a pinned render block when the caller
   keeps its frames;
4. serving slice: launch counters reset, 12 orbit frames through
   NaiveRendererAndLoss.vis -> LoG.render_fused (2 warm-up), timed with
   torch.cuda.synchronize(); every kernel of the path must have launched,
   to_host once a frame;
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
   torch.cuda.synchronize(); K2 and to_host must launch once per step, K1
   at least twice;
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
   K5, and K3p where it ran) and val's first frame. The run draws the
   JAX package's random numbers (utils/jax_random.py): the first init
   densify's keep mask, jax.random.uniform drawn on the card, is held bit
   for bit against the numpy version of the same draw;
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
   versions (K1 without stats and both K2 calls among them); the first
   step's patch corners (jax.random.randint from PRNGKey(step), drawn on
   the card) held bit for bit against the numpy version.
14. sharded_step: in a one-rank NCCL process group (parallel/mesh.py's
   initialize_distributed), the training snapshot (before its first step)
   trained SHARDED_STEPS steps through ShardedExecutor.step (the tiled
   backend, the root weight cull over the gathered capacity axis, one
   camera a step) and through prepare_from_camera + LoG.train_step: params,
   unit quaternions, moments and float counters held at
   tests/test_parallel.py's single-chip tolerances, the integer counters
   and every step's kept counts equal; step 0's kernel calls (K1 in both
   modes, K3, K4, K2) held against the plain versions; the step median
   beside the single-card median, the peak, launches per step and the
   bytes handed to each collective per step. Then multi_rank_phase: with
   2+ cards (its json entry multi_card; with one card it logs that it did
   not run, and why), n = min(count, 4) NCCL ranks (parallel/launch.py,
   the kernel library built once before they start) after a probe of
   their group, the link between the cards from nvidia-smi (topo -m,
   else nvlink --status):
   a. step: MULTI_RANK_STEPS steps of one camera a rank through
      ShardedExecutor.step against one rank of n cameras on the same
      batches (params, unit quaternions, moments and losses at
      MULTI_RANK_TOL, visible_count, area_sum and the kept counts exact)
      and against the single-card step (ms and cameras per second); every
      rank's step 0 kernel calls held against the plain versions; per
      rank the step ms, peak memory, bytes per collective, and, over
      MULTI_PROFILE_STEPS more steps under the profiler, the device time,
      busy share and the NCCL kernels' time and share; the check cull's
      gather timed alone;
   b. densify: a depth densify (the device path) on every rank, then
      refresh_from_model, which checks that the ranks' models agree bit
      for bit, and one step after it;
   c. band render: 15's frames on the n ranks, each rank's frame 0 kernel
      calls held, the bytes each rank hands to the exchange;
   d. the 10.26M-point synthetic tree (build_checkpoint of 1.9M roots)
      built on every rank from the seed, MULTI_CAPACITY_STEPS steps (ms and peak per rank);
   e. check_sharded_fullscale at n NCCL ranks with K1: the exchange-length
      matrix, pairs exchanged against the single-card demand, overflow 0;
   f. the CLI: config/synthetic_parallel through log_tpu_torch.apps.train
      under torch.distributed.run at n ranks of one camera and at one rank
      of n cameras, final_val of each (at least MULTI_CLI_FINAL), their
      first MULTI_CLI_LOSS_STEPS losses within MULTI_RANK_TOL's loss
      bound, the launches per step;
15. sharded_render: the trained tree in the strided layout over the
   serving orbit at one rank, at SH 1 (slices, K3) and SH 0 (columns, K4 +
   K3p), every frame held against the single-card flat_slice frame
   without the weight cull (tests/test_sharded_render.py's bound), the
   exchange bucket sized from the frames' pair demand, no overflow; frame
   0's kernel calls against the plain versions (the band's K1 without
   stats); the frame time beside the serving flat_slice frame's;
16. cli_parallel: config/synthetic's scene (200 Gaussians, 16 views at
   120x160, .png) made by the port's make_synthetic_scene, and
   config/synthetic_parallel's 200 steps through log_tpu_torch.apps.train
   with train.parallel.enable on (one NCCL rank started from torchrun's
   variables) and off, each with final_val: the two final-vals within 1
   dB, every sharded step launching K4, K3, K1 and K2.
17. viewer (run after the serving checks, on a fresh copy of the serving
   tree): log_tpu_torch/apps/viewer.py's ViewerState (1920x1080, focal 1.2
   W, the mean point as center, SH 1) behind make_handler in a
   ThreadingHTTPServer on 127.0.0.1 (a free port, stopped at the end); GET
   / and a 404; 24 GET /render at their own (yaw, pitch, dist, offset)
   after 2 warm-up requests, the launch counts reset just before them; per
   request the host latency (request sent to body read), render_one's
   device time (CUDA events), the JPEG encode's time, the pair demand
   against the budget and the launches (K4, K3 and K1 each, no K2 or K5,
   no overflow); every decoded JPEG equal to its camera's direct frame
   encoded alike; request 0's frame against its all-plain rerun and its
   kernel calls against the plain versions;
18. vanilla (after the viewer): BASELINE.json configs[1], the tree's 600k
   roots as a BaseGaussian (create_from_record of their activated values,
   SH 1) over the 12-frame orbit at 1920x1088 through
   NaiveRendererAndLoss.vis (the frustum mask, then render_one with the
   capacity's pair budget): no overflow, K4, K3 and K1 once per frame;
   frame 0 against its all-plain rerun and its kernel calls against the
   plain versions; then log_tpu_torch.apps.check_viewer --oneshot on the
   card;
19. viewer_cli (after cli): make_state of Config.load_args on the cli
   phase's config and model_tree_full.pth (the viewer's own entry, --device
   cuda), its warm-up frame, 4 requests through the real handler;
20. tools (after viewer_cli): log_tpu_torch.apps.test_dataset and
   test_pointcloud on the cli scene (5 frames each, written under
   output/chip_tools) and log_tpu_torch.apps.calibration.read_colmap on a
   small COLMAP model written by the port's writers, each as python -m in
   a subprocess and checked by its outputs (their launches, in other
   processes, are not counted);
21. scale (after cli_parallel, the earlier models freed): the run functions
   of log_tpu_torch/scripts at their own sizes, SCALE_FRAMES timed frames a
   cell and SCALE_WARMUP + SCALE_STEPS steps: bench_trainstep (1920x1088,
   100k points, the identity step), bench_spill (the same geometry on the
   device path, with exp_avg_sq spilled and with both moments spilled by
   maybe_spill: the states agree), bench_4k (3840x2160 block frames of the
   3.24M-point tree at min_res 96 and 3, culled every 4 frames, and one
   close 4K vanilla frame of its roots through render_one) and
   bench_capacity (the 10.26M-point tree: memory, block frames at min_res
   96 and 3, the fused flat_slice frame at 96, the tree-stage step,
   maybe_spill not engaged), each on its JAX script's scene (the trees of
   padded_model_device(PRNGKey(0), ...) built on the card, the step state
   and GT of the JAX scripts' keys); every frame cell's budget sized from its
   demand and re-timed at a raised budget where a timed frame overflowed,
   none over its budget; the first frame or step of the SCALE_HELD cells
   recorded and held against the plain versions (K3p and K5 of the 4K and
   10.26M block frames timed);
22. dissect (after scale): log_tpu_torch/scripts' dissection and probe
   scripts with DISSECT_REPS repeats: bench_frame_dissect on the 3.24M
   tree built on the card (build_scene + pad_scene, root_major) at
   1920x1088, min_res 3 (the flat_slice and block frames' stage tables,
   each stage timed alone on the state its predecessors left: host and
   device ms, launches, syncs, peak; headline, cull with both expansion
   branches, kernel2, prims, blocksize, demand), the init-stage step's
   cumulative prefixes at 100k points, bench_kernel (K1 and K5 on
   synthetic sorted tables), the sort (DISSECT_SORT_SIZES x
   DISSECT_SORT_PAYLOADS), gather and block-take probes,
   backend_equivalence on config/synthetic (tiled and oracle) and
   check_sharded_fullscale at 2 gloo ranks on the card machine's CPU
   (DISSECT_SHARDED_FRAMES frames); every table printed on its own line;
   the stage chains' frames bit-equal to fused_prepare_render's and
   render_blocks', the full prefix to fused_prepare_train_step (loss,
   parameters, moments, counters), no timed demand past its budget, no
   bucket overflow; the first chain runs, the K6 compaction, kernel2's K5,
   the first full step and bench_kernel's K4, K1 and K5 calls held
   against the plain versions;
23. bench (after dissect): log_tpu_torch/scripts/bench.py, the port of
   bench.py, at full size (the 3.24M tree built on the card, 1920x1088,
   30 timed frames a pass, BENCH_REPEATS passes): the headline
   (fused_root_cull over cap_sort, then the flat_slice frame with its
   w_full, every frame, min_res 3), the block frame culled every 4 frames,
   and both at the realistic min_res (the first candidate whose cut holds
   300,000 points); its JSON on a line of its own; no bucket or budget
   overflow, every timed frame finite, K1, K4, K3p and K5 launched in
   every cell's timed frames; each cell's first timed frame with its cull
   replayed in a recording and its calls (K3 too, which the cull's
   binning runs) held against the plain versions, the headline's K3p and
   K5 timed;
24. cli_mask: config/synthetic's scene made on the card, masks/ by
   thresholding its white background, config/synthetic_mask through
   log_tpu_torch.apps.train (MaskForeground: every step must launch K4,
   K3, K1 and K2 with the mask handed to it, the tree stage's loss must
   fall), then final_val's masked validation.
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
    # the port's own: the JAX package hands the same arrays over in numpy
    "to_host": ("log_tpu_torch/csrc/to_host.cu", None),
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
    "to_host": "a pinned copy_ of the float32 bytes it writes moves them "
               "without the quantize (library_ms where the row measures "
               "it)",
}
# to_host's bound: the bytes it writes into pinned host memory over the
# host link's rate, which a plain copy_ of LINK_PROBE_BYTES from the device
# into pinned memory measures
LINK_PROBE_BYTES = 256 << 20
# frames a caller keeps, each holding its pinned render block: allocations
# first held untimed (to use up the cache's free blocks), then timed
KEPT_DRAIN, KEPT_TIMED = 8, 3
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
# sharded_step: the training snapshot through ShardedExecutor.step (one
# NCCL rank, one camera a step, the tiled backend, the check cull) and
# through prepare_from_camera + LoG.train_step, SHARDED_STEPS steps each;
# held at tests/test_parallel.py's single-chip tolerances (params, unit
# quaternions, moments, float counters) with the integer counters and the
# kept counts equal. Where the machine has 2+ cards (multi_rank_phase),
# min(count, 4) NCCL ranks of one camera for MULTI_RANK_STEPS steps against
# one rank of that many cameras, at test_sharded_n1_equals_n4's tolerances
# (moments at the parameters' relative one: the slice exchange sums rows
# that one rank owns, so only the order of the gradient scatter's float
# sums differs), visible_count and area_sum exact
SHARDED_STEPS, MULTI_RANK_STEPS = 12, 8
SHARDED_TOL = {"params": (2e-4, 2e-5), "rotation": (1e-3, 2e-4),
               "moments": (2e-3, 1e-7), "counters": (2e-3, 1e-5)}
MULTI_RANK_TOL = {"params": (1e-4, 1e-6), "rotation": (1e-3, 2e-4),
                  "moments": (1e-4, 1e-7), "loss": 1e-5}
# multi_rank_phase, after the steps: MULTI_PROFILE_STEPS more under the
# profiler (the NCCL kernels' device time), the check cull's gather timed
# alone (MULTI_GATHER_REPS), a depth densify whose refresh checks the
# ranks' models bit for bit, one step after it, and the band render; then
# MULTI_CAPACITY_STEPS steps of the 10.26M-point synthetic tree
# (build_checkpoint; each rank builds it from the seed) at min_res MULTI_CAPACITY_MIN_RES;
# check_sharded_fullscale on NCCL ranks with K1 (MULTI_FULLSCALE_FRAMES);
# the CLI under torchrun at n ranks of one camera and at one rank of n
# (MULTI_CLI_*: config/synthetic_parallel on a scene made by the port's
# make_synthetic_scene), the first MULTI_CLI_LOSS_STEPS losses of the two
# within MULTI_RANK_TOL["loss"], each final-val in the class of PERF.md
MULTI_PROFILE_STEPS, MULTI_GATHER_REPS = 2, 5
MULTI_CAPACITY_ROOTS, MULTI_CAPACITY_STEPS = 1_900_000, 2
MULTI_CAPACITY_MIN_RES = 96.0
MULTI_FULLSCALE_FRAMES = 8
MULTI_TIMEOUT_S, MULTI_PROBE_TIMEOUT_S = 600, 120
MULTI_CLI_SCENE = "output/chip_multi_scene"
# config/synthetic_conv's scene (cli phase): on config/synthetic's
# 200-Gaussian 120x160 scene one rank of 4 cameras ends at 17.6 dB / 0.43
# SSIM, under the class of PERF.md; on this one at 25.6 dB / 0.82
MULTI_CLI_SCENE_ARGS = [MULTI_CLI_SCENE, "20000", "36", "256", "320", ".png"]
MULTI_CLI_EXP = "output/chip_multi_{}/log"
MULTI_CLI_LOSS_STEPS = 8
MULTI_CLI_FINAL = (20.0, 0.8)  # final-val PSNR (dB) and SSIM, at least
SHARDED_EXACT = ("visible_count", "create_steps", "area_sum")
SHARDED_CLOSE = ("weights_max", "weights_sum", "grad_sum")
# sharded_render: the same tree in the strided layout over the serving
# orbit at one rank, at SH 1 (slices, K3) and SH 0 (columns, K4 + K3p),
# held against the single-card flat_slice frame without the weight cull at
# tests/test_sharded_render.py's bound
SHARDED_RENDER_SH = (1, 0)
BAND_ATOL, BAND_OUTLIERS, BAND_MAX = 2e-3, 1e-3, 2e-2
# cli_parallel: config/synthetic's scene (the verify recipe's sizes) and
# config/synthetic_parallel's 200 steps through the port's CLI with
# train.parallel.enable on (one NCCL rank) and off; final-vals within 1 dB
CLI_PAR_SCENE = "output/chip_par_scene"
CLI_PAR_EXP = "output/chip_par_{}/log"
CLI_PAR_CFG = "config/synthetic_parallel/train.yml"
CLI_PAR_SCENE_ARGS = [CLI_PAR_SCENE, "200", "16", "120", "160", ".png"]
CLI_PAR_PSNR_DB = 1.0
# viewer: the HTTP viewer (log_tpu_torch/apps/viewer.py) over the serving
# tree at the screen a 1080p cfg.viewer sets (focal 1.2 W, its default),
# VIEWER_REQUESTS GET /render at their own poses after VIEWER_WARMUP
VIEWER_H, VIEWER_W = 1080, 1920
VIEWER_REQUESTS, VIEWER_WARMUP = 24, 2
# the split of a request's latency (request_telemetry)
TELEMETRY_MS = ("prepare_ms", "render_ms", "bgr_ms", "encode_ms")
# viewer_cli: make_state on the cli phase's config and checkpoint, requests
# through the real handler; tools: the port's test_dataset, test_pointcloud
# and read_colmap as subprocesses, their outputs under TOOLS_OUT
VIEWER_CLI_REQUESTS = 4
TOOLS_OUT = "output/chip_tools"
# scale: log_tpu_torch/scripts' run functions at their own sizes with
# fewer repeats; the kernel calls of the SCALE_HELD cells' first frame
# (with its cull), of bench_spill's first spilled step and of the step
# cells' first step at their timed budget are held against the plain
# versions
SCALE_FRAMES = 6
SCALE_STEPS, SCALE_WARMUP = 6, 2
SCALE_HELD = ("trainstep step", "spill_both step 0", "4k blocks minres96",
              "4k blocks minres3", "4k vanilla frame",
              "capacity blocks_minres96", "capacity fused_minres96",
              "capacity step")
SCALE_PACKED = ("4k blocks minres96", "capacity blocks_minres96")
FRAME_KERNELS = ("pack_rows", "rasterize_fwd", "rasterize_fwd_packed")
# cli_mask: config/synthetic_mask through the port's CLI on config/synthetic's
# scene, its masks by thresholding the white background
CLI_MASK_SCENE = "output/chip_mask_scene"
CLI_MASK_EXP = "output/chip_cli_mask/log"
CLI_MASK_CFG = "config/synthetic_mask/train.yml"
CLI_MASK_SCENE_ARGS = [CLI_MASK_SCENE, "200", "16", "120", "160", ".png"]
CLI_MASK_WHITE = 250  # a pixel with every channel at least this is background
CLI_MASK_WINDOW = 20  # steps at each end of the tree stage (its base_iter)
# the dissect phase (log_tpu_torch/scripts' dissection and probe scripts)
DISSECT_REPS = 3
DISSECT_FRAME_PHASES = ("stages", "blocks", "headline", "cull", "kernel2",
                        "prims", "blocksize", "demand")
DISSECT_SHARDED_FRAMES = 4
# the sort probe's smallest and largest sizes and three payload counts
# (its whole sweep takes ~10 s of the phase)
DISSECT_SORT_SIZES = (1 << 20, 1 << 22)
DISSECT_SORT_PAYLOADS = (1, 7, 15)
DISSECT_EQUIV_OUT = "output/chip_equiv"
# the bench phase (log_tpu_torch/scripts/bench.py): bench.py's four cells
# at full size; the kernels each cell's timed frames must launch (K1 and
# K4 in the cull, K4, K3p and K5 in the frame)
BENCH_REPEATS = 5
BENCH_KERNELS = ("pack_rows", "rasterize_fwd", "expand_packed",
                 "rasterize_fwd_packed")
DISSECT_KERNELS = {
    "dissect_frame": ("pack_rows", "expand_packed", "rasterize_fwd_packed",
                      "rasterize_fwd", "stream_compact"),
    "dissect_trainstep": ("pack_rows", "expand_with_keys", "rasterize_fwd",
                          "rasterize_bwd"),
    "dissect_kernel": ("pack_rows", "rasterize_fwd", "rasterize_fwd_packed"),
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


@contextlib.contextmanager
def plain_versions():
    """Every kernel wrapper replaced by its plain torch version (the
    autograd functions around them look the wrappers up at call time)."""
    from log_tpu_torch.ops import expand as ex
    from log_tpu_torch.ops import rasterize_tiled as rt

    from log_tpu_torch.ops import compact
    from log_tpu_torch.ops import to_host as th

    with patched(ex, {"expand_with_keys": ex.expand_with_keys_plain,
                      "expand_packed_with_keys":
                          ex.expand_packed_with_keys_plain}), \
            patched(rt, {"pack_rows": rt.pack_rows_plain,
                         "rasterize_forward": rt.rasterize_forward_plain,
                         "rasterize_backward": rt.rasterize_backward_plain,
                         "rasterize_forward_packed":
                             rt.rasterize_forward_packed_plain}), \
            patched(compact, {"stream_compact_cols":
                              compact.stream_compact_cols_plain}), \
            patched(th, {"to_host": th.to_host_plain}):
        yield


def _copied(x, device=None):
    """x with every tensor in it (in lists, tuples and dicts) detached and
    cloned (onto `device` where given)."""
    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.clone() if device is None else x.to(device, copy=True)
    if isinstance(x, dict):
        return {k: _copied(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_copied(v, device) for v in x)
    return x


@contextlib.contextmanager
def recorded_draws(name, calls, limit):
    """utils/jax_random.<name> (the device draws of JAX's random numbers)
    recording its first `limit` calls: (bound arguments without the
    device, a host copy of the words)."""
    import inspect

    from log_tpu_torch.utils import jax_random

    real = getattr(jax_random, name)
    sig = inspect.signature(real)

    def draw(*args, **kwargs):
        out = real(*args, **kwargs)
        if len(calls) < limit:
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            bound.arguments.pop("device")
            calls.append((dict(bound.arguments), out.cpu().numpy()))
        return out

    with patched(jax_random, {name: draw}):
        yield


def check_draws(calls, name, label, log):
    """Each recorded draw of jax_random.<name> on the card against the
    numpy version on the host, bit for bit. Returns failures."""
    from log_tpu_torch.utils import jax_random

    if not calls:
        return [f"{label}: no {name} draw recorded"]
    failures = []
    for args, got in calls:
        want = getattr(jax_random, f"np_{name}")(**args)
        if got.dtype.kind == "f":
            same = np.array_equal(got.view(np.uint32), want.view(np.uint32))
        else:
            same = np.array_equal(got, want)
        log(f"{label}: jax_random.{name} key {args['key'].tolist()} shape "
            f"{tuple(args['shape'])} on the card equals the numpy version "
            f"bit for bit: {same} (first words {got.ravel()[:3].tolist()})")
        if not same:
            failures.append(f"{label}: jax_random.{name} on the card differs "
                            f"from the numpy version at "
                            f"{int((got != want).sum())} of {got.size}")
    return failures


@contextlib.contextmanager
def recording(calls, copy=False):
    """Record the arguments of every kernel wrapper call into calls[name]
    (with copy, copies of them, which later calls cannot overwrite; with
    copy="cpu", copies in host memory, which leave the card's memory as the
    path left it)."""
    from log_tpu_torch.ops import expand as ex
    from log_tpu_torch.ops import rasterize_tiled as rt

    def recorder(name, fn):
        def call(*args, **kwargs):
            calls.setdefault(name, []).append(
                _copied((args, kwargs), None if copy is True else copy)
                if copy else (args, kwargs))
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


def link_rate(log):
    """Bytes a second of a plain copy_ of LINK_PROBE_BYTES from the device
    into pinned host memory: the host link's rate as PyTorch reaches it."""
    import torch

    src = torch.rand(LINK_PROBE_BYTES // 4, device="cuda")
    dst = torch.empty(LINK_PROBE_BYTES // 4, pin_memory=True)
    ms = device_ms(lambda: dst.copy_(src, non_blocking=True), 10)
    rate = LINK_PROBE_BYTES / ms * 1e3
    log(f"host link: a pinned copy_ of {LINK_PROBE_BYTES} bytes "
        f"{ms:.4f} ms, {rate / 1e9:.2f} GB/s")
    return rate


def frame_planes(model, renderer, batch):
    """The planes vis hands to_host on the main path, from one served
    frame: its render (a strided view of the padded frame buffer) and its
    alpha, as render_fused returned them."""
    seen, inner = [], model.render_fused

    def render_fused(*a, **kw):
        seen.append(inner(*a, **kw))
        return seen[-1]

    with patched(model, {"render_fused": render_fused}):
        renderer.vis(batch, model)
    return seen[0]["render"], seen[0]["alpha"]


def check_to_host(call, planes, rate, log, failures):
    """to_host on the path's own planes [(src, destinations)] against
    to_host_plain, bit for bit; the kernel (into pinned memory), the plain
    version and a pinned copy_ of the bytes the kernel writes timed by CUDA
    events; the bound, those bytes over the link's rate."""
    import torch

    from log_tpu_torch.ops import to_host as th

    def outs(pinned):
        return [(src, tuple(torch.empty(src.shape, dtype=torch.float32,
                                        pin_memory=pinned)
                            for _ in range(n))) for src, n in planes]

    kern, plain = outs(True), outs(False)
    th.to_host(kern)
    torch.cuda.synchronize()
    th.to_host_plain(plain)
    pairs = [(a, b) for (_, ka), (_, pa) in zip(kern, plain)
             for a, b in zip(ka, pa)]
    exact = all(torch.equal(_bits(a), _bits(b)) for a, b in pairs)
    err = max(float((a - b).abs().max()) for a, b in pairs)
    ms = device_ms(lambda: th.to_host(kern), 10)
    pms = device_ms(lambda: th.to_host_plain(plain), 3)
    nbytes = sum(4 * src.numel() * n for src, n in planes)
    flat = torch.rand(nbytes // 4, device="cuda")
    host = torch.empty(nbytes // 4, pin_memory=True)
    lib_ms = device_ms(lambda: host.copy_(flat, non_blocking=True), 10)
    b_ms = nbytes / rate * 1e3
    shapes = [(tuple(src.shape), tuple(src.stride()), str(src.dtype), n)
              for src, n in planes]
    log(f"TH to_host        {call} {shapes}: exact={exact} max_abs={err:.3g} "
        f"kernel {ms:.4f} ms, plain {pms:.4f} ms, pinned copy_ "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({nbytes} bytes over the "
        f"link)")
    if not exact:
        failures.append(f"to_host {call} is not bit-exact")
    return {"call": call, "planes": shapes, "exact": exact,
            "max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": b_ms, "bound_by": "host link", "bytes": nbytes,
            "library_ms": lib_ms}


def kept_frame_cost(shape, log):
    """Host ms of the pinned render block vis takes a camera (`shape`),
    from PyTorch's caching host allocator: warm (a block freed just before)
    and kept (every earlier block held, as by a caller that keeps its
    frames: KEPT_DRAIN untimed, then KEPT_TIMED timed); with what the held
    timed blocks moved in torch.cuda.host_memory_stats, where it has
    any."""
    import torch

    from log_tpu_torch.ops import to_host as th

    like = torch.empty(0, device="cuda")

    def stats():
        try:
            return torch.cuda.host_memory_stats()
        except (AttributeError, RuntimeError):
            return {}

    def alloc():
        t0 = time.perf_counter()
        t = th.host_empty(shape, like)
        return t, (time.perf_counter() - t0) * 1e3

    warm = []
    for _ in range(KEPT_TIMED + 1):
        t, ms = alloc()
        warm.append(ms)
        del t
    held = [alloc()[0] for _ in range(KEPT_DRAIN)]
    before = stats()
    kept = []
    for _ in range(KEPT_TIMED):
        t, ms = alloc()
        held.append(t)
        kept.append(ms)
    after = stats()
    moved = {k: v - before.get(k, 0) for k, v in after.items()
             if isinstance(v, (int, float)) and v != before.get(k, 0)}
    del held
    nbytes = 4 * math.prod(shape)
    log(f"TH kept frame: a pinned render block of {nbytes} bytes, warm "
        + " ".join(f"{m:.3f}" for m in warm[1:]) + " ms, kept "
        + " ".join(f"{m:.3f}" for m in kept) + f" ms; host_memory_stats "
        f"moved by {KEPT_TIMED} kept: {moved}")
    return {"render_bytes": nbytes, "warm_ms": warm[1:], "kept_ms": kept,
            "host_memory_stats_moved": moved}


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


def compare_packed_kernels(calls, log, profile=True):
    """K3p and K5 against their plain versions on frame 0's own inputs of
    the flat_slice frame, and every K4 pack of that frame bit-exact; with
    profile, K5's device time and launches per call by the profiler too."""
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
        "rasterize_fwd_kernel", log) if profile else (math.nan, math.nan)
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
    if profile and dev_n != 1:
        failures.append(f"K5: the profiler saw {dev_n} launches per call")
    rows["rasterize_fwd_packed"] = {
        "max_abs_err": err, "ms": ms,
        "device_ms": dev_ms if profile else None, "plain_ms": pms,
        "bound_ms": b_ms, "bound_by": by, "pairs": pairs,
        "dense_pair_pixels": dense, "gated_pair_pixels": gated}
    return rows, failures


def compare_k6(calls, log, profile=True):
    """K6 against its plain version on frame 0's compaction inputs:
    bit-exact, in one launch per call (the profiler's count; with profile
    False neither the profiler's time nor its count)."""
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
    dev_ms, dev_n = (kernel_device_ms(
        lambda: compact.stream_compact_cols(*args, **kw), 10, "compact",
        log) if profile else (None, None))
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
        f"{ms:.4f} ms (profiler: {dev_ms} ms in {dev_n} launch per "
        f"call), plain {pms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    fails = [] if exact else ["K6 stream_compact_cols is not bit-exact"]
    if profile and dev_n != 1:
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
    also list the port's spans (utils/profiler.py's span)."""
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

    from log_tpu_torch.utils.profiler import is_span

    avgs = prof.key_averages()

    def dev_ms(e):  # per call
        return _self_device_us(e) / 1e3 / n

    # the port's spans also appear on the device side; they are not
    # kernels
    kernels_ = [e for e in avgs if e.device_type == DeviceType.CUDA
                and not is_span(e.key)]
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
        if is_span(e.key) or e.key in (
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
    draws = []  # the first init densify's keep mask, drawn on the card
    with patched(Trainer, {"training_step": step, "make_validation": val}), \
            patched(NaiveRendererAndLoss, {"render_one": one, "vis": frame}), \
            patched(LoG, {"set_stage": set_stage}), \
            recorded_draws("uniform", draws, 1):
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
    failures += check_draws(draws, "uniform", "cli first init densify", log)
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
    corners = []  # the first step's patch rows and cols, drawn on the card
    with patched(Trainer, {"training_step": step}), \
            patched(NaiveRendererAndLoss, {"vis": frame, "render_one": one}), \
            recorded_draws("randint", corners, 2):
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
    failures += check_draws(corners, "randint",
                            "cli_depth first step's patch corners", log)
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


# ------------------------------------------------------- parallel phases
def free_port() -> int:
    """A free TCP port on localhost for a process group's store."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def one_rank_group(log):
    """A one-rank NCCL process group on card 0, started by
    initialize_distributed and destroyed after."""
    import torch

    from log_tpu_torch.parallel.mesh import initialize_distributed

    dev = initialize_distributed(f"localhost:{free_port()}", 1, 0,
                                 device="cuda")
    log(f"process group: {torch.distributed.get_backend()}, world "
        f"{torch.distributed.get_world_size()}, rank device {dev}")
    try:
        yield dev
    finally:
        torch.distributed.destroy_process_group()


def step_views(batches):
    """(camera, GT (3, H, W) uint8) of each training view."""
    return [({k: np.asarray(v)[0] for k, v in b["camera"].items()},
             np.ascontiguousarray(b["image"][0].transpose(2, 0, 1)))
            for b in batches]


def hold_states(want, got, tol, label, log):
    """Two state_dicts (snapshot_of) after the same steps: params at
    tol["params"] (rotations as unit quaternions at tol["rotation"]), with
    tol["moments"] the moments (rotation's skipped: its norm is a null
    space of the loss) and the counters (SHARDED_EXACT equal, SHARDED_CLOSE
    at tol["counters"]). Returns (largest |d| by group, failures)."""
    fails, worst = [], {}
    n = want["gaussian.xyz"].shape[0]
    if got["gaussian.xyz"].shape[0] != n:
        return {}, [f"{label}: {got['gaussian.xyz'].shape[0]} points, want "
                    f"{n}"]
    for key, a in want.items():
        group, name = key.split(".", 1)[0], key.rsplit(".", 1)[-1]
        b = got[key]
        if group == "gaussian":
            rt_, at_ = tol["params"]
            if name == "rotation":
                rt_, at_ = tol["rotation"]
                a = a / np.linalg.norm(a, axis=-1, keepdims=True)
                b = b / np.linalg.norm(b, axis=-1, keepdims=True)
        elif group == "optimizer" and "moments" in tol and name != "rotation":
            if key == "optimizer.global_steps":
                rt_, at_ = 0.0, 0.0
            else:
                rt_, at_ = tol["moments"]
        elif group == "counter" and "counters" in tol and (
                name in SHARDED_EXACT or name in SHARDED_CLOSE):
            rt_, at_ = ((0.0, 0.0) if name in SHARDED_EXACT
                        else tol["counters"])
        else:
            continue
        d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
        worst[group] = max(worst.get(group, 0.0), float(d.max(initial=0.0)))
        if not np.all(d <= at_ + rt_ * np.abs(np.asarray(a, np.float64))):
            fails.append(f"{label}: {key} differs by {float(d.max()):.3g}")
    log(f"{label}: largest |d| by group {worst}; "
        f"{'held' if not fails else fails}")
    return worst, fails


def _sharded_run(model, views, steps, cams_per_device, comm, calls=None,
                 record=None):
    """`steps` ShardedExecutor.step calls over the views, batch after batch
    of cams_per_device * ranks cameras (fixed black backgrounds); the first
    step's kernel calls recorded (copies) into `calls`. Returns (executor,
    per-step rows)."""
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.parallel.executor import ShardedExecutor

    ex = ShardedExecutor(model, cams_per_device=cams_per_device,
                         backend="tiled", check_cull=True, comm=comm)
    B, rows = ex.batch, []
    for s in range(steps):
        sel = [(s * B + j) % len(views) for j in range(B)]
        before, moved = dict(kernels.LAUNCHES), dict(comm.bytes)
        ctx = (recording(calls, copy=True) if s == 0 and calls is not None
               else contextlib.nullcontext())
        with ctx:
            (met, counts), sec = timed(lambda: ex.step(
                [views[i][0] for i in sel], [views[i][1] for i in sel],
                view_indices=[i % TRAIN_VIEWS for i in sel],
                backgrounds=[np.zeros(3, np.float32)] * B))
        rows.append({"step": s, "ms": sec * 1e3, "loss": float(met["loss"]),
                     "counts": counts.tolist(), "bucket": list(ex._bucket),
                     "ran": {k: kernels.LAUNCHES[k] - before[k]
                             for k in kernels.LAUNCHES},
                     "bytes": {k: comm.bytes[k] - moved.get(k, 0)
                               for k in comm.bytes}})
    return ex, rows


def sharded_step_phase(snapshot, batches, device, log):
    """The training snapshot (3.24M points, capacity 4,194,304, 1920x1088,
    perturbed) trained SHARDED_STEPS steps through the single-card step
    (prepare_from_camera + LoG.train_step) and through ShardedExecutor.step
    in this process's one-rank NCCL group (the tiled backend, the check
    cull), one camera a step, black backgrounds; the two held against each
    other (hold_states, kept counts equal), step 0's kernel calls against
    the plain versions. Returns (json, launches, held errors, held K1/K2
    rows, the sharded model, failures)."""
    import torch

    from log_tpu_torch.ops import kernels
    from log_tpu_torch.parallel.comm import Comm
    from log_tpu_torch.utils import hbm

    failures = []
    views = step_views(batches)
    bg = np.zeros(3, np.float32)
    ref = train_twin(snapshot, device)
    ref_rows = []
    for s in range(SHARDED_STEPS):
        camera, gt = views[s % TRAIN_VIEWS]

        def one():
            vf = ref.prepare_from_camera(camera)
            met, _ = ref.train_step(camera, gt, bg, view_index=s % TRAIN_VIEWS)
            return list(vf["counts"]), float(met["loss"])
        (counts, loss), sec = timed(one)
        ref_rows.append({"ms": sec * 1e3, "counts": counts, "loss": loss})
    want = snapshot_of(ref)
    del ref
    torch.cuda.empty_cache()

    model = train_twin(snapshot, device)
    comm = Comm()
    calls = {}
    kernels.reset_launches()
    (ex, rows), mem = hbm.call_stats(
        lambda: _sharded_run(model, views, SHARDED_STEPS, 1, comm, calls))
    launches = dict(kernels.LAUNCHES)
    ex.sync_to_model()
    got = snapshot_of(model)
    del ex
    torch.cuda.empty_cache()

    worst, fails = hold_states(want, got, SHARDED_TOL,
                               "sharded_step vs single-card", log)
    failures += fails
    counts_eq = [r["counts"][0] for r in rows] == [r["counts"]
                                                  for r in ref_rows]
    if not counts_eq:
        failures.append("sharded_step: kept counts differ from the "
                        "single-card step's: "
                        f"{[r['counts'][0] for r in rows]} vs "
                        f"{[r['counts'] for r in ref_rows]}")
    held_rows = {}
    errs, hfail = hold_calls(calls, "sharded_step step 0", log, held_rows)
    failures += hfail
    del calls
    ms = [r["ms"] for r in rows[1:]]
    ref_ms = [r["ms"] for r in ref_rows[1:]]
    steady = rows[1:]
    per_step = {k: sum(r["ran"][k] for r in steady) / len(steady)
                for k in launches}
    bytes_per_step = {k: sum(r["bytes"].get(k, 0) for r in steady)
                      / len(steady) for k in rows[-1]["bytes"]}
    log("sharded_step: ms " + " ".join(f"{r['ms']:.1f}" for r in rows)
        + "; single-card ms " + " ".join(f"{r['ms']:.1f}" for r in ref_rows))
    log(f"sharded_step: step median {np.median(ms):.3f} ms against the "
        f"single-card median {np.median(ref_ms):.3f} ms (steps 1-"
        f"{SHARDED_STEPS - 1}); peak memory {mem['peak_bytes'] / 2**30:.3f} "
        f"GiB; launches per step {per_step}; bytes handed to each "
        f"collective per step {bytes_per_step}; kept counts equal "
        f"{counts_eq}; buckets {[r['bucket'] for r in rows]}; losses "
        + " ".join(f"{r['loss']:.5f}" for r in rows))
    uneven = [r["step"] for r in rows if r["ran"]["rasterize_bwd"] != 1
              or min(r["ran"][k] for k in ("rasterize_fwd", "expand_with_keys",
                                           "pack_rows")) < 2]
    if uneven:
        failures.append(f"sharded_step: steps without K2 once and K1, K3, "
                        f"K4 at least twice: {uneven}")
    if not all(math.isfinite(r["loss"]) for r in rows):
        failures.append("sharded_step: non-finite loss")
    return ({"steps": rows, "single_card_steps": ref_rows,
             "step_ms_median": float(np.median(ms)),
             "single_card_step_ms_median": float(np.median(ref_ms)),
             "peak_bytes": mem["peak_bytes"], "launches_per_step": per_step,
             "collective_bytes_per_step": bytes_per_step,
             "worst_abs_diff": worst, "counts_equal": counts_eq},
            launches, errs, held_rows, model, failures)


def link_matrix(log):
    """The link between the cards: the kinds `nvidia-smi topo -m` prints
    (NV# for NVLink; PIX, PXB, PHB, NODE, SYS for PCIe and host bridges),
    else card 0's active links from `nvidia-smi nvlink --status`, and
    whether every card reaches every other's memory (P2P). Returns (link,
    details)."""
    import re

    import torch

    def smi(*args):
        res = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True)
        text = (res.stdout if res.returncode == 0 else res.stderr) or ""
        for line in text.splitlines():
            log(f"  nvidia-smi {' '.join(args)}: {line.rstrip()}")
        return res.returncode, text

    rc, topo = smi("topo", "-m")
    kinds = sorted({k for ln in topo.splitlines() if ln.startswith("GPU")
                    for k in re.findall(r"\b(NV\d+|PIX|PXB|PHB|NODE|SYS)\b",
                                        ln)}) if rc == 0 else []
    rc, nvl = smi("nvlink", "--status", "-i", "0")
    rates = re.findall(r"Link \d+: ([\d.]+) GB/s", nvl) if rc == 0 else []
    n = torch.cuda.device_count()
    p2p = all(torch.cuda.can_device_access_peer(i, j)
              for i in range(n) for j in range(n) if i != j)
    if any(k.startswith("NV") for k in kinds) or rates:
        link = "NVLink"
    elif kinds:
        link = "/".join(kinds)
    else:
        link = "P2P, kind unknown" if p2p else "unknown"
    return link, {"topo_kinds": kinds, "card0_nvlinks_gb_per_s": rates,
                  "p2p": p2p}


def band_sizes(max_cut, max_demand, cap, n):
    """(k_local, pair budget, bucket) of the band render at n ranks from the
    single-card frames' largest cut and pair demand: a rank's share with
    headroom (1.1 at one rank; 1.5 where the rows split, for the ranks'
    unequal shares), k_local a multiple of 32,768 (the column flow's K3p),
    the (src, dst) bucket three times the mean exchange length
    (scripts/check_sharded_fullscale.py's rule) and at most the rank's
    pair budget."""
    from log_tpu_torch.ops import budget_for_demand

    room = 1.1 if n == 1 else 1.5
    k_local = min(-(-int(max_cut * room / n) // 32768) * 32768, cap // n)
    pairs = -(-budget_for_demand(int(max_demand * room / n)) // 512) * 512
    bucket = min(pairs, budget_for_demand(int(3 * max_demand / n ** 2)))
    return k_local, pairs, bucket


def _nccl_probe(rank, world, device):
    """One all_reduce and one all_gather in the ranks' group: the group
    forms and its collectives cross the cards."""
    import torch

    from log_tpu_torch.parallel.comm import Comm

    comm = Comm()
    x = torch.full((4,), float(rank + 1), device=device)
    total = comm.psum(x)
    every = comm.all_gather(x, tiled=False)
    return {"rank": rank, "device": str(device),
            "backend": torch.distributed.get_backend(),
            "psum": total.tolist(), "gathered": every[:, 0].tolist()}


def _rank_log(rank, world):
    def log(msg):
        print(f"[rank {rank}/{world}] {msg}", flush=True)
    return log


def _multi_card_rank(rank, world, device, path):
    """One NCCL rank of multi_rank_phase (parallel/launch.spawn). From the
    pickle at `path` (the training snapshot, the views, and the one-rank
    run of `world` cameras a step: its state, losses and kept counts):
    MULTI_RANK_STEPS steps of one camera through ShardedExecutor.step,
    step 0's kernel calls held against the plain versions, the result held
    on rank 0 against the one-rank run; MULTI_PROFILE_STEPS more under the
    profiler; the check cull's gather timed alone; a depth densify on every
    rank (the device path), whose refresh_from_model checks the ranks'
    models bit for bit, and one step after it; then the band render at SH
    1 and 0 (sharded_render_phase). Returns a dict of this rank's numbers,
    launches, held errors, held rows and failures."""
    import pickle

    import torch

    from log_tpu_torch.model.train_step import _normalize_rows
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.parallel.comm import Comm
    from log_tpu_torch.scripts import _common as C

    log = _rank_log(rank, world)
    dev = torch.device(device)
    failures, held_rows, launches = [], {}, {}
    with open(path, "rb") as f:
        snapshot, views, ref = pickle.load(f)
    comm = Comm()
    model = train_twin(snapshot, device)
    del snapshot
    calls = {}
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    ex, rows = _sharded_run(model, views, MULTI_RANK_STEPS, 1, comm, calls)
    launches["multi_step"] = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    errs, f = hold_calls(calls, f"rank {rank} multi_step step 0", log,
                         held_rows)
    failures += f
    del calls
    uneven = [r["step"] for r in rows if r["ran"]["rasterize_bwd"] != 1
              or min(r["ran"][k] for k in ("rasterize_fwd", "expand_with_keys",
                                           "pack_rows")) < 2]
    if uneven:
        failures.append(f"multi_step rank {rank}: steps without K2 once and "
                        f"K1, K3, K4 at least twice: {uneven}")
    out = {"rank": rank, "device": str(dev),
           "ms": [r["ms"] for r in rows], "losses": [r["loss"] for r in rows],
           "peak_bytes": peak,
           "bytes_per_step": {k: sum(r["bytes"].get(k, 0) for r in rows[1:])
                              / (len(rows) - 1) for k in rows[-1]["bytes"]}}
    ex.sync_to_model()
    if rank == 0:
        got = snapshot_of(model)
        out["worst_abs_diff"], fails = hold_states(
            ref["state"], got, MULTI_RANK_TOL,
            f"{world} ranks x 1 camera vs 1 rank x {world}", log)
        failures += fails
        for key in ("counter.visible_count", "counter.area_sum"):
            if not np.array_equal(ref["state"][key], got[key]):
                failures.append(f"multi_step: {key} differs from the "
                                f"one-rank run's")
        del got
        if not np.allclose(out["losses"], ref["losses"],
                           rtol=MULTI_RANK_TOL["loss"]):
            failures.append(f"multi_step: losses {out['losses']} vs the "
                            f"one-rank run's {ref['losses']}")
        counts = [r["counts"] for r in rows]
        out["counts_equal"] = counts == ref["counts"]
        if not out["counts_equal"]:
            failures.append(f"multi_step: kept counts {counts} vs the "
                            f"one-rank run's {ref['counts']}")

    # the profiler over more steps: device time, the NCCL kernels' share;
    # the ranks start it together (rank 0 has just compared on the host)
    torch.distributed.barrier()
    torch.cuda.synchronize()
    B = ex.batch
    nxt = [MULTI_RANK_STEPS]

    def one_step():
        s = nxt[0]
        nxt[0] += 1
        sel = [(s * B + j) % len(views) for j in range(B)]
        ex.step([views[i][0] for i in sel], [views[i][1] for i in sel],
                view_indices=[i % TRAIN_VIEWS for i in sel],
                backgrounds=[np.zeros(3, np.float32)] * B)

    dev_ms, dev_launches, ops = C.profiled(one_step, MULTI_PROFILE_STEPS, dev,
                                           top=1 << 20)
    nccl = [(name, ms) for name, ms in ops if name.lower().startswith("nccl")]
    host_ms = float(np.median(out["ms"][1:]))
    out["profile"] = {
        "steps": MULTI_PROFILE_STEPS, "device_ms": dev_ms,
        "device_launches": dev_launches, "host_ms_median": host_ms,
        "busy": dev_ms / host_ms, "nccl_ms": sum(ms for _, ms in nccl),
        "nccl_share": sum(ms for _, ms in nccl) / host_ms,
        "nccl_kernels": nccl, "top": ops[:8]}

    # the check cull's gather alone: the physical columns of the local rows
    col = ex.meta["col_of"]
    p = ex.packed
    parts = (p[:, col["xyz"][0]:col["xyz"][1]].contiguous(),
             torch.exp(p[:, col["scaling"][0]:col["scaling"][1]]),
             _normalize_rows(p[:, col["rotation"][0]:col["rotation"][1]]),
             torch.sigmoid(p[:, col["opacity"][0]]))
    gather_ms = device_ms(lambda: [comm.all_gather(a) for a in parts],
                          MULTI_GATHER_REPS)
    sent = sum(a.numel() * a.element_size() for a in parts)
    out["cull_gather"] = {"ms": gather_ms, "bytes_handed_in": sent,
                          "bytes_gathered": sent * world,
                          "gb_per_s": sent * world / gather_ms / 1e6}
    del parts

    # a depth densify on every rank, then the refresh's bit-for-bit check
    d = model.densify_and_remove
    model.set_state(current_depth=20)  # what upgrade_tree sets
    d["min_steps_split"] = 0
    d["device_densify"] = "on"
    ex.sync_to_model()
    n0, c0 = model.num_points, model.capacity
    _, dens_s = timed(lambda: model.update_depth_stage(nxt[0]))
    agree = True
    try:
        ex.refresh_from_model()
    except RuntimeError as e:
        agree = False
        failures.append(f"multi_densify: {e}")
    out["densify"] = {"points": [n0, model.num_points],
                      "capacity": [c0, model.capacity], "s": dens_s,
                      "ranks_agree": agree}
    if model.num_points == n0:
        failures.append("multi_densify: nothing changed")
    if agree:
        kernels.reset_launches()
        _, sec = timed(one_step)
        out["densify"]["step_after_ms"] = sec * 1e3
        launches["multi_step_after_densify"] = dict(kernels.LAUNCHES)
        ex.sync_to_model()
    log(f"multi_densify: {n0} -> {model.num_points} points, capacity {c0} "
        f"-> {model.capacity}, {dens_s:.3f} s; ranks agree {agree}")
    del ex
    torch.cuda.empty_cache()

    render, r_launches, r_errs, r_rows, r_fail = sharded_render_phase(
        model, device, log, comm, "multi_render")
    failures += r_fail
    launches.update(r_launches)
    for k, v in r_errs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    for k, v in r_rows.items():
        held_rows.setdefault(k, []).extend(v)
    out["render"] = render
    out.update(launches=launches, errs=errs, failures=failures,
               held_rows=held_rows if rank == 0 else {})
    return out


def capacity_views(n, h=H, w=W, focal=1400.0):
    """n host cameras of bench_capacity's orbit (radius 22, height 18) and
    a random 8-bit GT each, from the seed."""
    from log_tpu_torch.dataset.base import prepare_camera

    rng = np.random.default_rng(SEED)
    return [({k: np.asarray(v) for k, v in prepare_camera(
        make_cam(2 * math.pi * i / n, h=h, w=w, focal=focal), 1, 0.01,
        1000.0).items() if k in CAMERA_KEYS},
        rng.integers(0, 256, (3, h, w), dtype=np.uint8)) for i in range(n)]


def _multi_capacity_rank(rank, world, device):
    """One NCCL rank of the 10.26M-point step: the synthetic tree of
    build_checkpoint (MULTI_CAPACITY_ROOTS roots, capacity 12,582,912) built on this rank's
    card from the seed (not sent: the pickle would be ~3 GB), zero moments;
    the executor's refresh checks that every rank built the same tree; then
    MULTI_CAPACITY_STEPS steps of one camera a rank at min_res
    MULTI_CAPACITY_MIN_RES. Returns ms, peak, kept counts, losses."""
    import torch

    from log_tpu_torch.ops import kernels
    from log_tpu_torch.parallel.comm import Comm
    from log_tpu_torch.parallel.executor import ShardedExecutor

    log = _rank_log(rank, world)
    (model, build_s) = timed(lambda: build_train_model(
        device, n_roots=MULTI_CAPACITY_ROOTS))
    views = capacity_views(world)
    torch.cuda.reset_peak_memory_stats()
    ex = ShardedExecutor(model, backend="tiled", check_cull=True,
                         comm=Comm())  # checks that the ranks agree
    kernels.reset_launches()
    rows = []
    for s in range(MULTI_CAPACITY_STEPS):
        (met, counts), sec = timed(lambda: ex.step(
            [v[0] for v in views], [v[1] for v in views],
            backgrounds=[np.zeros(3, np.float32)] * world,
            min_res=[MULTI_CAPACITY_MIN_RES] * world))
        rows.append({"ms": sec * 1e3, "loss": float(met["loss"]),
                     "counts": counts.tolist()})
    ran = dict(kernels.LAUNCHES)
    if ran["rasterize_bwd"] != MULTI_CAPACITY_STEPS or min(
            ran[k] for k in STEP_KERNELS) < MULTI_CAPACITY_STEPS:
        raise RuntimeError(f"multi_capacity rank {rank}: launches {ran} in "
                           f"{MULTI_CAPACITY_STEPS} steps")
    out = {"rank": rank, "points": model.num_points,
           "capacity": model.capacity, "build_s": build_s, "steps": rows,
           "bucket": list(ex._bucket),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": ran}
    log(f"multi_capacity: {model.num_points} points, capacity "
        f"{model.capacity}, step ms {[round(r['ms'], 1) for r in rows]}, "
        f"peak {out['peak_bytes'] / 2**30:.3f} GiB")
    return out


def torchrun_cli_main(argv):
    """`chip_smoke.py --torchrun-cli OUT <train argv>` as a rank of
    torch.distributed.run: log_tpu_torch.apps.train.main(<train argv>), the
    CLI's own entry, with each training step's kernel launches counted and
    the first MULTI_CLI_LOSS_STEPS losses read; OUT.<rank>.json gets them,
    the wall time, the steps and the final point count."""
    import os

    from log_tpu_torch.apps import train
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.utils.trainer import Trainer

    out_prefix, args = argv[0], argv[1:]
    losses, step_launches = [], {k: 0 for k in kernels.LAUNCHES}
    real_step = Trainer.training_step

    def step(self, model, data):
        before = dict(kernels.LAUNCHES)
        res = real_step(self, model, data)
        for k in step_launches:
            step_launches[k] += kernels.LAUNCHES[k] - before[k]
        if len(losses) < MULTI_CLI_LOSS_STEPS:
            losses.append(float(res[1]["metrics"]["loss"]))
        step.n += 1
        return res
    step.n = 0

    t0 = time.perf_counter()
    with patched(Trainer, {"training_step": step}):
        trainer = train.main(args)
    wall = time.perf_counter() - t0
    rank = int(os.environ.get("RANK", "0"))
    rec = {"rank": rank, "world": int(os.environ.get("WORLD_SIZE", "1")),
           "wall_s": wall, "steps": step.n, "losses": losses,
           "points": trainer.model.num_points,
           "batch": trainer.executor.batch if trainer.executor else None,
           "step_launches": step_launches}
    with open(f"{out_prefix}.{rank}.json", "w") as f:
        json.dump(rec, f)
    return 0


def multi_cli_phase(n, log):
    """The scene (MULTI_CLI_SCENE_ARGS) made by the port's
    make_synthetic_scene, then config/synthetic_parallel through the CLI
    under torch.distributed.run: n ranks of one camera, and one rank of n
    cameras (train.parallel.cams_per_device n), each rank calling
    log_tpu_torch.apps.train.main through torchrun_cli_main; final_val of
    each run's checkpoint in this process. Returns (json, launches by run,
    steps by run, failures)."""
    import glob
    import os
    import shutil

    from log_tpu_torch.apps import final_val, make_synthetic_scene

    failures, out, launches, n_steps = [], {}, {}, {}
    shutil.rmtree(MULTI_CLI_SCENE, ignore_errors=True)
    _, out["scene_s"] = timed(lambda: make_synthetic_scene.main(
        MULTI_CLI_SCENE_ARGS))
    nccl_env = {k: v for k, v in os.environ.items() if k.startswith("NCCL_")}
    log(f"multi_cli: NCCL environment at launch {nccl_env or 'none set'}")
    for nproc, cams in ((n, 1), (1, n)):
        mode = f"{nproc}x{cams}"
        exp = MULTI_CLI_EXP.format(mode)
        shutil.rmtree(os.path.dirname(exp), ignore_errors=True)
        opts = ["root", MULTI_CLI_SCENE, "PLYNAME",
                MULTI_CLI_SCENE + "/sparse/0/sparse.npz", "exp", exp,
                "dataset.args.ext", ".png", "val_dataset.args.ext", ".png"]
        prefix = os.path.join("output", f"chip_multi_cli_{mode}")
        for old in glob.glob(prefix + ".*.json"):
            os.remove(old)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
               "--nproc_per_node", str(nproc), "chip_smoke.py",
               "--torchrun-cli", prefix, "--cfg", CLI_PAR_CFG, "split",
               "train", *opts, "train.parallel.enable", "on",
               "train.parallel.cams_per_device", str(cams)]
        log("multi_cli: " + " ".join(cmd))
        t0 = time.perf_counter()
        with open(prefix + ".log", "w") as f:
            rc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT,
                                timeout=MULTI_TIMEOUT_S).returncode
        wall = time.perf_counter() - t0
        ranks = []
        for path in sorted(glob.glob(prefix + ".*.json")):
            with open(path) as f:
                ranks.append(json.load(f))
        if rc != 0 or len(ranks) != nproc:
            with open(prefix + ".log") as f:
                tail = f.read()[-3000:]
            failures.append(f"multi_cli {mode}: rc {rc}, {len(ranks)} of "
                            f"{nproc} ranks reported; log tail:\n{tail}")
            continue
        record, fv_s = timed(lambda: final_val.main(
            [CLI_PAR_CFG, os.path.join(exp, "model_tree.pth")] + opts))
        r0 = ranks[0]
        out[mode] = {"ranks": nproc, "cams_per_device": cams,
                     "command_s": wall, "train_s": [r["wall_s"] for r in ranks],
                     "steps": r0["steps"], "batch": r0["batch"],
                     "points": [r["points"] for r in ranks],
                     "losses": r0["losses"], "final_val_s": fv_s,
                     "final_val": {k: record[k] for k in CLI_VAL_KEYS},
                     "launches_per_step": {
                         k: v / max(r0["steps"], 1)
                         for k, v in r0["step_launches"].items()}}
        launches[f"multi_cli_{mode}"] = r0["step_launches"]
        n_steps[f"multi_cli_{mode}"] = r0["steps"]
        fv = out[mode]["final_val"]
        log(f"multi_cli {mode}: {r0['steps']} steps of {r0['batch']} "
            f"cameras, command {wall:.2f} s (train {r0['wall_s']:.2f} s on "
            f"rank 0), points {out[mode]['points']}, final_val {fv} in "
            f"{fv_s:.2f} s; launches per step {out[mode]['launches_per_step']}"
            f"; losses {r0['losses']}")
        if fv["psnr"] < MULTI_CLI_FINAL[0] or fv["ssim"] < MULTI_CLI_FINAL[1]:
            failures.append(f"multi_cli {mode}: final-val {fv['psnr']:.3f} dB"
                            f" / {fv['ssim']:.4f} under {MULTI_CLI_FINAL}")
        if len({r["points"] for r in ranks}) != 1:
            failures.append(f"multi_cli {mode}: the ranks end with "
                            f"{[r['points'] for r in ranks]} points")
        if min(r0["step_launches"][k] for k in STEP_KERNELS) < r0["steps"]:
            failures.append(f"multi_cli {mode}: launches "
                            f"{r0['step_launches']} in {r0['steps']} steps")
    many, one = out.get(f"{n}x1"), out.get(f"1x{n}")
    if many and one:
        if not np.allclose(many["losses"], one["losses"],
                           rtol=MULTI_RANK_TOL["loss"]):
            failures.append(f"multi_cli: the first losses {many['losses']} "
                            f"at {n} ranks vs {one['losses']} at one rank")
        if many["steps"] != one["steps"]:
            failures.append(f"multi_cli: {many['steps']} steps at {n} ranks "
                            f"vs {one['steps']} at one rank")
    return out, launches, n_steps, failures


def _subphase(name, fn, failures, log):
    """fn() with its exception turned into a failure (and its traceback
    printed), so that the phases after it still run; None where it
    raised."""
    import traceback

    try:
        return fn()
    except Exception:
        log(f"{name} raised:\n{traceback.format_exc()}")
        failures.append(f"{name} raised (traceback above)")
        return None


def multi_rank_phase(snapshot, batches, device, log):
    """Where the machine has two cards or more, n = min(count, 4) NCCL
    ranks (parallel/launch.py, the kernel library built once before they
    start): the training step of one camera a rank against one rank of n
    cameras (this process, a one-rank group) on the same batches and
    against the single-card step, with the densify and band render of
    _multi_card_rank; the 10.26M-point step (_multi_capacity_rank);
    check_sharded_fullscale with K1 on NCCL ranks; the CLI under torchrun
    (multi_cli_phase). With one card it says so. Returns (json, launches
    by run, calls by run, held errors, held rows, failures)."""
    import os
    import pickle

    import torch

    from log_tpu_torch.parallel.comm import Comm
    from log_tpu_torch.parallel.launch import spawn
    from log_tpu_torch.scripts import check_sharded_fullscale

    cards = torch.cuda.device_count()
    if cards < 2:
        why = f"needs two cards, found {cards}"
        log(f"multi_card: the multi-card phases did not run: {why}")
        return {"cards": cards, "ran": False, "why": why}, {}, {}, {}, {}, []
    n = min(cards, 4)
    failures, launches, n_calls, errs, rows = [], {}, {}, {}, {}
    link, link_details = link_matrix(log)
    out = {"cards": cards, "ran": True, "ranks": n, "link": link,
           "link_details": link_details,
           "names": [torch.cuda.get_device_name(i) for i in range(n)]}
    log(f"multi_card: {n} NCCL ranks on {cards} cards, link {link}")
    probe = _subphase("multi_probe", lambda: spawn(
        _nccl_probe, n, "cuda", timeout_s=MULTI_PROBE_TIMEOUT_S),
        failures, log)
    out["probe"] = probe
    want = [float(n * (n + 1) // 2)] * 4
    if probe is None or any(r["psum"] != want for r in probe):
        failures.append(f"multi_probe: the {n}-rank group did not form or "
                        f"its collectives disagree: {probe}")
        return out, launches, n_calls, errs, rows, failures
    log(f"multi_probe: {probe}")
    views = step_views(batches)

    # one rank of n cameras, and the single-card step, on the same batches
    def one_rank():
        with one_rank_group(log):
            model = train_twin(snapshot, device)
            ex, ref_rows = _sharded_run(model, views, MULTI_RANK_STEPS, n,
                                        Comm())
            ex.sync_to_model()
            state = snapshot_of(model)
        del ex, model
        torch.cuda.empty_cache()
        single = train_twin(snapshot, device)
        bg = np.zeros(3, np.float32)
        single_ms = []
        for s in range(MULTI_RANK_STEPS * n):
            camera, gt = views[s % len(views)]

            def one():
                single.prepare_from_camera(camera)
                single.train_step(camera, gt, bg, view_index=s % TRAIN_VIEWS)
            single_ms.append(timed(one)[1] * 1e3)
        del single
        torch.cuda.empty_cache()
        return ref_rows, state, single_ms

    res = _subphase("multi_card one rank", one_rank, failures, log)
    if res is None:
        return out, launches, n_calls, errs, rows, failures
    ref_rows, state, single_ms = res
    one_ms = float(np.median([r["ms"] for r in ref_rows[1:]]))
    single_med = float(np.median(single_ms[1:]))
    out["one_rank"] = {"cams": n, "ms": [r["ms"] for r in ref_rows],
                       "ms_median": one_ms, "cams_per_s": n * 1e3 / one_ms,
                       "losses": [r["loss"] for r in ref_rows]}
    out["single_card"] = {"ms": single_ms, "ms_median": single_med,
                          "cams_per_s": 1e3 / single_med}
    path = os.path.join("build", "chip_smoke_multi_rank.pkl")
    os.makedirs("build", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump((snapshot, views, {
            "state": state, "losses": out["one_rank"]["losses"],
            "counts": [r["counts"] for r in ref_rows]}), f)
    del state
    try:
        ranks, sec = timed(lambda: spawn(_multi_card_rank, n, "cuda",
                                         args=(path,),
                                         timeout_s=MULTI_TIMEOUT_S))
    except RuntimeError as e:
        ranks = None
        failures.append(f"multi_step: {e}")
    finally:
        os.remove(path)
    if ranks is not None:
        for r in ranks:
            failures += r["failures"]
            for k, v in r["errs"].items():
                errs[k] = max(errs.get(k, 0.0), v)
        rows = ranks[0]["held_rows"]
        ms = np.array([r["ms"] for r in ranks])  # (ranks, steps)
        r0_med = float(np.median(ms[0, 1:]))
        max_med = float(np.median(ms[:, 1:].max(axis=0)))
        out["step"] = {
            "spawn_s": sec, "ms_rank0": ms[0].tolist(),
            "ms_max_over_ranks": ms.max(axis=0).tolist(),
            "ms_median_rank0": r0_med, "ms_median_max": max_med,
            "cams_per_s": n * 1e3 / max_med,
            "peak_bytes": [r["peak_bytes"] for r in ranks],
            "bytes_per_step": ranks[0]["bytes_per_step"],
            "profile": [r["profile"] for r in ranks],
            "cull_gather": [r["cull_gather"] for r in ranks],
            "worst_abs_diff": ranks[0].get("worst_abs_diff"),
            "counts_equal": ranks[0].get("counts_equal"),
            "losses": ranks[0]["losses"]}
        out["densify"] = [r["densify"] for r in ranks]
        out["render"] = {sh: {
            "frame_ms_mean_rank0": ranks[0]["render"][sh]["frame_ms_mean"],
            "frame_ms_mean_max": max(r["render"][sh]["frame_ms_mean"]
                                     for r in ranks),
            "flat_slice_frame_ms_mean": ranks[0]["render"][sh][
                "flat_slice_frame_ms_mean"],
            **{k: ranks[0]["render"][sh][k] for k in (
                "k_local", "pairs", "bucket", "exchange_bytes_per_frame",
                "gather_bytes_per_frame", "frames")}}
            for sh in ranks[0]["render"]}
        for key, run in ranks[0]["launches"].items():
            launches[key] = run
        n_calls.update({"multi_step": MULTI_RANK_STEPS,
                        "multi_step_after_densify": 1,
                        **{k: FRAMES for k in ranks[0]["launches"]
                           if k.startswith("multi_render")}})
        prof = ranks[0]["profile"]
        log(f"multi_step: {n} ranks x 1 camera: step median {r0_med:.3f} ms "
            f"on rank 0, {max_med:.3f} ms the slowest rank (steps 2-"
            f"{MULTI_RANK_STEPS}), {n * 1e3 / max_med:.2f} cameras/s; one "
            f"rank x {n}: {one_ms:.3f} ms ({n * 1e3 / one_ms:.2f} cameras/s);"
            f" single card: {single_med:.3f} ms a camera "
            f"({1e3 / single_med:.2f} cameras/s); peak GiB "
            f"{[round(r['peak_bytes'] / 2**30, 3) for r in ranks]}; busy "
            f"{[round(r['profile']['busy'], 3) for r in ranks]}; NCCL kernels "
            f"{[round(r['profile']['nccl_ms'], 3) for r in ranks]} ms a step "
            f"(share {[round(r['profile']['nccl_share'], 3) for r in ranks]})"
            f"; rank 0's NCCL kernels {prof['nccl_kernels']}; bytes per step "
            f"{out['step']['bytes_per_step']}; cull gather "
            f"{ranks[0]['cull_gather']}")
    # the 10.26M-point step
    cap = _subphase("multi_capacity", lambda: spawn(
        _multi_capacity_rank, n, "cuda", timeout_s=MULTI_TIMEOUT_S),
        failures, log)
    if cap is not None:
        out["capacity"] = cap
        launches["multi_capacity"] = cap[0]["launches"]
        n_calls["multi_capacity"] = MULTI_CAPACITY_STEPS
        if not all(math.isfinite(s["loss"]) for r in cap for s in r["steps"]):
            failures.append("multi_capacity: non-finite loss")
    # the band exchange at full scale with K1, on NCCL ranks
    full = _subphase("multi_fullscale", lambda: check_sharded_fullscale.run(
        N_ROOTS, MULTI_FULLSCALE_FRAMES, world=n, with_kernel=True),
        failures, log)
    if full is not None:
        out["fullscale"] = full
        log(f"multi_fullscale: {json.dumps(full)}")
        if not full["ranks_agree"] or full["max_overflow"]:
            failures.append("multi_fullscale: the ranks disagree or a "
                            "bucket overflowed")
    cli = _subphase("multi_cli", lambda: multi_cli_phase(n, log), failures,
                    log)
    if cli is not None:
        out["cli"], cli_launches, cli_steps, cfail = cli
        failures += cfail
        launches.update(cli_launches)
        n_calls.update(cli_steps)
    return out, launches, n_calls, errs, rows, failures


def sharded_render_phase(model, device, log, comm=None,
                         label="sharded_render"):
    """The trained tree in the strided layout over the serving orbit
    (1920x1088, FRAMES frames) on comm's ranks (this process's one rank by
    default): at SH 1 (the slice flow, K3) and SH 0 (the column flow, K4 +
    K3p), every frame held against the single-card flat_slice frame
    without the weight cull, which each rank renders on its own card
    (tests/test_sharded_render.py's bound); the budgets from those frames'
    cuts and pair demands (band_sizes of the largest over the ranks), no
    overflow; frame 0's kernel calls against the plain versions; the frame
    time beside the serving flat_slice frame (render_fused) of the same
    call, and the bytes this rank hands to the exchange and to the bands'
    gather per frame. Returns (json, launches by SH, held errors, held K1
    rows, failures)."""
    import torch

    from log_tpu_torch.model.train_step import fused_prepare_render
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.parallel.comm import Comm
    from log_tpu_torch.parallel.sharded_render import (ShardedRenderConfig,
                                                       interleave_shard_rows,
                                                       sharded_render_frame)
    from log_tpu_torch.render.renderer import camera_device

    failures, out, launches, errs, held_rows = [], {}, {}, {}, {}
    comm = comm if comm is not None else Comm()
    n = comm.world
    model.eval()
    model.tree.cut_method = "flat_slice"
    model._refresh_device_caches()
    params, tree = model.gaussian.params(), model.tree_device()
    params_s = interleave_shard_rows(params, n)
    tree_s = interleave_shard_rows(tree, n)
    orbit = orbit_batches(FRAMES)
    cameras = [{k: np.asarray(v)[0] for k, v in b["camera"].items()}
               for b in orbit]
    cams = [camera_device(c, device) for c in cameras]
    bg = torch.zeros(3, device=device)
    mr = float(model.tree.min_resolution_pixel)
    cap_sort = min(model.capacity,
                   -(-model.num_points // (1 << 18)) * (1 << 18))
    sh_max = model.gaussian.active_sh_degree
    for sh in SHARDED_RENDER_SH:
        refs = [fused_prepare_render(
            params, tree, cam, model.num_points, model._leaf_opt_dev, mr,
            model.current_depth, bg, H, W, k_visible=cap_sort, sh_degree=sh,
            stage_has_tree=True, num_levels=int(model.tree.depth.max()) + 1,
            backend="tiled", max_pairs=1 << 23, cut_method="flat_slice",
            n_roots=model.n_roots_bucket, prep_backend="tiled",
            check_cull=False, pack_pairs=False, cap_sort=cap_sort)
            for cam in cams]
        cuts = [int(r[2][:2].sum()) for r in refs]
        demand = [int(r[3]) for r in refs]
        # the largest over the ranks: every rank must take the same budgets
        big = comm.pmax(torch.tensor([max(cuts), max(demand)],
                                     dtype=torch.int64, device=device))
        k_local, pairs, bucket = band_sizes(int(big[0]), int(big[1]),
                                            model.capacity, n)
        cfg = ShardedRenderConfig(
            image_height=H, image_width=W, n_devices=n, k_local=k_local,
            max_pairs_local=pairs, bucket_pairs=bucket, sh_degree=sh,
            min_res_pixel=mr, layout="strided")
        frames, calls = [], {}
        kernels.reset_launches()
        for i, cam in enumerate(cams):
            ctx = recording(calls) if i == 0 else contextlib.nullcontext()
            moved = dict(comm.bytes)
            with ctx:
                (img, alpha, stats), sec = timed(lambda: sharded_render_frame(
                    params_s, tree_s, cam, model.num_points, mr,
                    model.current_depth, bg, cfg, comm))
            d = torch.maximum((img - refs[i][0]).abs().max(),
                              (alpha - refs[i][1]).abs().max())
            share = float(((img - refs[i][0]).abs() > BAND_ATOL)
                          .float().mean())
            st = stats.tolist()
            frames.append({"ms": sec * 1e3, "cut": st[0], "pairs": st[1],
                           "overflow": st[2], "lens": st[3:],
                           "max_abs_diff": float(d),
                           "share_past_atol": share,
                           "finite": bool(torch.isfinite(img).all()),
                           "bytes": {k: comm.bytes[k] - moved.get(k, 0)
                                     for k in comm.bytes}})
        ran = dict(kernels.LAUNCHES)
        launches[f"{label}_sh{sh}"] = ran
        e, f = hold_calls(calls, f"{label} SH {sh} frame 0", log, held_rows)
        failures += f
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        del calls
        # the serving flat_slice frame of the same call (weight cull, K5)
        model.gaussian.active_sh_degree = sh
        model._render_bucket = model._pair_bucket = model._frame = None
        serve = [timed(lambda c=c: model.render_fused(c, np.zeros(3)))[1]
                 * 1e3 for c in cameras]
        model.gaussian.active_sh_degree = sh_max
        ms = [x["ms"] for x in frames[WARMUP:]]
        exchange = float(np.mean([x["bytes"].get("all_to_all", 0)
                                  for x in frames]))
        gathered = float(np.mean([x["bytes"].get("all_gather", 0)
                                  for x in frames]))
        bad = [i for i, x in enumerate(frames)
               if x["overflow"] or not x["finite"] or x["cut"] != cuts[i]
               or x["max_abs_diff"] >= BAND_MAX
               or x["share_past_atol"] >= BAND_OUTLIERS]
        need = ("pack_rows", "rasterize_fwd",
                "expand_with_keys" if sh else "expand_packed")
        log(f"{label} SH {sh} ({n} ranks): k_local {k_local}, pairs {pairs}, "
            f"bucket {bucket}; frame ms " + " ".join(f"{x['ms']:.1f}"
                                                     for x in frames)
            + f"; mean {np.mean(ms):.3f} ms (frames {WARMUP}-{FRAMES - 1}) "
            f"against the flat_slice frame's {np.mean(serve[WARMUP:]):.3f} "
            f"ms; cuts {[x['cut'] for x in frames]}, pairs exchanged "
            f"{[x['pairs'] for x in frames]}, overflow "
            f"{max(x['overflow'] for x in frames)}; bytes handed to the "
            f"exchange {exchange:.0f} and to the bands' gather {gathered:.0f}"
            f" a frame; max |sharded - single| "
            f"{max(x['max_abs_diff'] for x in frames):.3g}, share past "
            f"{BAND_ATOL} {max(x['share_past_atol'] for x in frames):.3g}; "
            f"launches {ran}")
        if bad:
            failures.append(f"{label} SH {sh}: frames {bad} overflow, "
                            f"differ from the single-card frame or are not "
                            f"finite")
        if min(ran[k] for k in need) < FRAMES:
            failures.append(f"{label} SH {sh}: kernels {need} not "
                            f"launched every frame: {ran}")
        out[f"sh{sh}"] = {"k_local": k_local, "pairs": pairs,
                          "bucket": bucket, "frames": frames,
                          "frame_ms_mean": float(np.mean(ms)),
                          "exchange_bytes_per_frame": exchange,
                          "gather_bytes_per_frame": gathered,
                          "flat_slice_frame_ms": serve,
                          "flat_slice_frame_ms_mean":
                              float(np.mean(serve[WARMUP:]))}
        del refs
        torch.cuda.empty_cache()
    return out, launches, errs, held_rows, failures


def cli_parallel_phase(log):
    """config/synthetic's scene (made by the port's make_synthetic_scene)
    trained on config/synthetic_parallel's schedule through the port's CLI
    with train.parallel.enable on (one NCCL rank, from torchrun's
    variables) and off, then final_val of each. Returns (json, launches by
    run, steps by run, failures)."""
    import os
    import shutil

    from log_tpu_torch.apps import final_val, make_synthetic_scene, train
    from log_tpu_torch.model.level_of_gaussian import LoG
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.utils.trainer import Trainer

    failures, out, launches, n_steps = [], {}, {}, {}
    for d in (CLI_PAR_SCENE, os.path.dirname(CLI_PAR_EXP.format("on")),
              os.path.dirname(CLI_PAR_EXP.format("off"))):
        shutil.rmtree(d, ignore_errors=True)
    events, steps = [], []
    real_update, real_step = LoG.update_by_iteration, Trainer.training_step

    def update(self, iteration, global_iteration):
        n0 = self.num_points
        changed = real_update(self, iteration, global_iteration)
        if self.num_points != n0 or changed:
            events.append((self.stage_name, iteration, n0, self.num_points))
        return changed

    def step(self, model, data):
        res = real_step(self, model, data)
        steps.append(self.executor is not None)
        return res

    with blocked_imports(log), \
            patched(LoG, {"update_by_iteration": update}), \
            patched(Trainer, {"training_step": step}):
        _, scene_s = timed(lambda: make_synthetic_scene.main(
            CLI_PAR_SCENE_ARGS))
        for mode in ("on", "off"):
            exp = CLI_PAR_EXP.format(mode)
            opts = ["root", CLI_PAR_SCENE, "PLYNAME",
                    CLI_PAR_SCENE + "/sparse/0/sparse.npz", "exp", exp,
                    "dataset.args.ext", ".png", "val_dataset.args.ext",
                    ".png", "train.parallel.enable", mode]
            env = ({"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                    "MASTER_ADDR": "localhost", "MASTER_PORT": str(free_port())}
                   if mode == "on" else {})
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            del events[:], steps[:]
            kernels.reset_launches()
            try:
                trainer, train_s = timed(lambda: train.main(
                    ["--cfg", CLI_PAR_CFG, "split", "train"] + opts))
            finally:
                for k, v in saved.items():
                    if v is None:
                        del os.environ[k]
                    else:
                        os.environ[k] = v
            launches[f"cli_parallel_{mode}"] = dict(kernels.LAUNCHES)
            n_steps[f"cli_parallel_{mode}"] = len(steps)
            sharded = bool(steps) and all(steps)
            record, fv_s = timed(lambda: final_val.main(
                [CLI_PAR_CFG, os.path.join(exp, "model_tree.pth")] + opts))
            out[mode] = {"train_s": train_s, "final_val_s": fv_s,
                         "steps": len(steps), "sharded_steps": sharded,
                         "points": trainer.model.num_points,
                         "densify_events": list(events),
                         "final_val": {k: record[k] for k in CLI_VAL_KEYS}}
            log(f"cli_parallel {mode}: {len(steps)} steps (sharded {sharded}) "
                f"in {train_s:.2f} s, {trainer.model.num_points} points, "
                f"densify events {events}; final_val {out[mode]['final_val']} "
                f"in {fv_s:.2f} s; launches {launches[f'cli_parallel_{mode}']}")
            del trainer
    out["scene_s"] = scene_s
    on, off = out["on"], out["off"]
    d_db = abs(on["final_val"]["psnr"] - off["final_val"]["psnr"])
    log(f"cli_parallel: final-val PSNR on {on['final_val']['psnr']:.3f} / "
        f"off {off['final_val']['psnr']:.3f} dB (|d| {d_db:.3f}), SSIM "
        f"{on['final_val']['ssim']:.4f} / {off['final_val']['ssim']:.4f}")
    if not on["sharded_steps"] or off["sharded_steps"] is not False:
        failures.append("cli_parallel: enable on/off did not choose the "
                        "sharded / single-device step")
    if on["steps"] != off["steps"] or on["steps"] == 0:
        failures.append(f"cli_parallel: {on['steps']} sharded steps vs "
                        f"{off['steps']} single-device")
    if d_db > CLI_PAR_PSNR_DB:
        failures.append(f"cli_parallel: final-vals {d_db:.3f} dB apart")
    ran = launches["cli_parallel_on"]
    if ran["rasterize_bwd"] < on["steps"] or min(
            ran[k] for k in STEP_KERNELS) < on["steps"]:
        failures.append(f"cli_parallel on: launches {ran} in {on['steps']} "
                        f"steps")
    return out, launches, n_steps, failures


# ------------------------------------------------------ scale, cli_mask
def scale_phase(device, log):
    """log_tpu_torch/scripts' bench_trainstep, bench_spill, bench_4k and
    bench_capacity at their own sizes with SCALE_FRAMES timed frames per
    cell and SCALE_WARMUP + SCALE_STEPS training steps (the step cells
    add one step at their timed budget); each run between a reset and a
    read of the launch counts. The SCALE_HELD frames and steps ran inside
    a recording (host copies of every kernel call's inputs); after the runs
    those calls are held against the plain versions, and K3p and K5 of the
    SCALE_PACKED frames timed. Fails on a
    timed frame whose pair demand passed its budget, a spill at 10.26M
    points, a non-finite state or frame, spill modes that disagree, or a
    path kernel that never launched. Returns (json, launches by cell, calls
    by cell, held errors, kernel rows, failures)."""
    import torch

    from log_tpu_torch.ops import kernels
    from log_tpu_torch.scripts import (bench_4k, bench_capacity, bench_spill,
                                       bench_trainstep)

    held = {}

    def hold(label):
        if label not in SCALE_HELD:
            return contextlib.nullcontext()
        return recording(held.setdefault(label, {}), copy="cpu")

    runs = (
        ("trainstep", lambda: bench_trainstep.run(
            steps=SCALE_STEPS, warmup=SCALE_WARMUP, device=device,
            hold=hold)),
        ("spill", lambda: bench_spill.run(
            steps=SCALE_STEPS, warmup=SCALE_WARMUP, device=device,
            hold=hold)),
        ("4k", lambda: bench_4k.run(frames=SCALE_FRAMES, device=device,
                                    hold=hold)),
        ("capacity", lambda: bench_capacity.run(
            frames=SCALE_FRAMES, steps=SCALE_STEPS, warmup=SCALE_WARMUP,
            device=device, hold=hold)),
    )
    out, launches, n_calls, failures = {}, {}, {}, []
    for name, run in runs:
        torch.cuda.empty_cache()
        kernels.reset_launches()
        res, s = timed(run)
        total = dict(kernels.LAUNCHES)
        res["wall_s"] = s
        out[name] = res
        cells = {k: v for k, v in res.items()
                 if isinstance(v, dict) and "launches" in v}
        if "launches" in res:
            cells[""] = res
        inside = dict.fromkeys(total, 0)
        for cell, v in cells.items():
            key = f"scale_{name}" + (f"_{cell}" if cell else "")
            launches[key] = v["launches"]
            n_calls[key] = v.get("frames", v.get("steps", 1))
            for k in inside:
                inside[k] += v["launches"][k]
        launches[f"scale_{name}_other"] = {k: total[k] - inside[k]
                                           for k in total}
        log(f"scale {name}: {s:.2f} s; launches {total}, "
            f"{launches[f'scale_{name}_other']} outside the timed cells")
    failures += scale_checks(out, launches, n_calls, log)
    seen = set(held)
    errs, rows = {}, {}
    for label in list(held):
        calls = _copied(held.pop(label), device)
        e, f = hold_calls(calls, f"scale {label}", log, rows)
        failures += f
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        if label in SCALE_PACKED and "expand_packed" not in calls:
            failures.append(f"scale {label}: K3p did not run")
        elif label in SCALE_PACKED:
            prow, f = compare_packed_kernels(calls, log, profile=False)
            failures += f
            for k, v in prow.items():
                rows.setdefault(k, []).append(dict(v, call=f"scale {label}"))
        del calls
        torch.cuda.empty_cache()
    missing = set(SCALE_HELD) - seen
    if missing:
        failures.append(f"scale: no calls recorded for {sorted(missing)}")
    return out, launches, n_calls, errs, rows, failures


def _scale_frame_cells(res):
    return {k: v for k, v in res.items()
            if isinstance(v, dict) and "demand_per_frame" in v}


def scale_checks(out, launches, n_calls, log):
    """The scale phase's pass conditions on the runs' results."""
    failures = []
    for name, res in out.items():
        for cell, v in _scale_frame_cells(res).items():
            log(f"scale {name} {cell}: {v['ms_per_frame']:.3f} ms a frame "
                f"({v['fps']:.2f} fps), cut {v['cut']} (bucket {v['k_vis']}"
                f", overflow {v['cut_overflow']}), pair demand "
                f"{min(v['demand_per_frame'])}-{v['pairs_measured']} of "
                f"{v['max_pairs']} (rebumped {v['budget_rebumped']}), "
                f"eligible blocks {v.get('blocks_eligible')} of "
                f"{v.get('blocks_total')}; last frame finite "
                f"{v['image_finite']} std {v['image_std']:.4f}")
            if v["pairs_measured"] > v["max_pairs"] or v["budget_overflow"]:
                failures.append(f"scale {name} {cell}: a timed frame's pair "
                                f"demand passed its budget")
            if not v["image_finite"] or v["image_std"] < 0.01:
                failures.append(f"scale {name} {cell}: frame not finite or "
                                f"blank")
            ran = launches[f"scale_{name}_{cell}"]
            if min(ran[k] for k in FRAME_KERNELS) < 1:
                failures.append(f"scale {name} {cell}: launches {ran}")
    ts = out["trainstep"]
    log(f"scale trainstep: {ts['n_points']} points at {ts['h']}x{ts['w']}, "
        f"k_leaf {ts['k_leaf']} (identity {ts['identity']}): step median "
        f"{ts['step_ms_median']:.3f} ms, peak {ts['peak_bytes'] / 2**30:.3f} "
        f"GiB, pair demand {ts['pairs_measured']} of a budget of "
        f"{ts['max_pairs']} (the JAX script's {ts['call_budget']}, "
        f"warm-up demand {ts['warmup_demand']})")
    sp = out["spill"]
    for mode in ("device", "spill_sq", "spill_both"):
        m = sp[mode]
        log(f"scale spill {mode}: step median {m['step_ms_median']:.3f} ms, "
            f"{m['h2d_bytes_per_step'] / 2**20:.2f} MiB up, "
            f"{m['d2h_bytes_per_step'] / 2**20:.2f} MiB down a step, peak "
            f"{m['peak_bytes'] / 2**30:.3f} GiB; pair demand "
            f"{max(m['pairs_per_step'])} against the trainer's budget "
            f"{max(m['budget_per_step'])}; vs device {m.get('vs_device')}")
        if not m["finite"]:
            failures.append(f"scale spill {mode}: state not finite")
    if not sp["modes_agree"]:
        failures.append("scale spill: the modes' states disagree")
    van = out["4k"]["vanilla_close"]
    log(f"scale 4k vanilla frame: {van['ms']:.3f} ms, pair demand "
        f"{van['pairs_measured']} against the rail {van['rail']} (past it "
        f"{van['past_rail']}), budget {van['max_pairs']}")
    if van["budget_overflow"] or not van["finite"]:
        failures.append(f"scale 4k vanilla frame: {van}")
    cap = out["capacity"]
    tr = cap["train"]
    log(f"scale capacity: {cap['n_points']} points, capacity "
        f"{cap['capacity']}; build on the card {cap['build_s']:.2f} s, "
        f"block cache {cap['block_cache_s']:.2f} s; "
        f"{cap['live_bytes_before'] / 2**30:.3f} GiB held before the build; "
        f"memory at rest {cap['memory_at_rest']}, with the block cache "
        f"{cap['memory_with_block_cache']}; step (k_leaf {tr['k_leaf']}, "
        f"k_node {tr['k_node']}) median {tr['step_ms_median']:.3f} ms, peak "
        f"{tr['peak_bytes'] / 2**30:.3f} GiB (after the warm-up "
        f"{tr['memory_after_warmup']}), pairs {tr['pairs_measured']} of "
        f"{tr['max_pairs']} (call budget {tr['call_budget']}), kept leaf/node "
        f"{tr['kept'][0]}; spill {cap['spill']}")
    for label, res in (("trainstep", ts), ("capacity step", tr)):
        if not res["finite"]:
            failures.append(f"scale {label}: state not finite")
        if res["budget_overflow"]:
            failures.append(f"scale {label}: pair demand past the budget")
    if cap["spill"]["engaged"]:
        failures.append("scale capacity: maybe_spill engaged at "
                        f"{cap['n_points']} points")
    for key in ("scale_trainstep", "scale_spill_device",
                "scale_spill_spill_sq", "scale_spill_spill_both",
                "scale_capacity_train"):
        ran, n = launches[key], n_calls[key]
        if min(ran[k] for k in STEP_KERNELS) < n:
            failures.append(f"scale {key}: launches {ran} in {n} steps")
    ran = launches["scale_4k_vanilla_close"]
    if min(ran[k] for k in SERVING_KERNELS) < 1:
        failures.append(f"scale 4k vanilla frame: launches {ran}")
    return failures


def _table(log, smi, name, rows, **extra):
    """One stage table on a line of its own."""
    log(json.dumps({"table": name, "card": smi, **extra, "rows": rows}))


def dissect_phase(device, smi, log):
    """log_tpu_torch/scripts' dissection and probe scripts, each run between
    a reset and a read of the launch counts: bench_frame_dissect (the 3.24M
    tree at 1920x1088, min_res 3: the flat_slice and block stage tables,
    headline, cull, kernel2, prims, blocksize, demand), the init-stage step's
    prefixes at 100k points, bench_kernel, the sort, gather and block-take
    probes, backend_equivalence on config/synthetic and
    check_sharded_fullscale at 2 gloo ranks (DISSECT_SHARDED_FRAMES frames
    of the dissector's orbit). Every stage table is printed on its own line.
    Fails where a stage chain's frame is not bit-equal to its function's,
    the full prefix to fused_prepare_train_step, a timed call's demand
    passed its budget, a path kernel never launched, a held call disagrees
    with its plain version, or the sharded exchange overflowed. Returns
    (json, launches by sub-phase, held errors, kernel rows, failures)."""
    import torch

    from log_tpu_torch.ops import kernels
    from log_tpu_torch.scripts import (backend_equivalence, bench_blockgather,
                                       bench_frame_dissect, bench_gathercost,
                                       bench_kernel, bench_sortcost,
                                       bench_trainstep_dissect,
                                       check_sharded_fullscale)

    held = {}

    def hold(label):
        return recording(held.setdefault(label, {}), copy="cpu")

    runs = (
        ("frame", lambda: bench_frame_dissect.run(
            DISSECT_FRAME_PHASES, reps=DISSECT_REPS, device=device,
            hold=hold)),
        ("trainstep", lambda: bench_trainstep_dissect.run(
            reps=DISSECT_REPS, device=device, hold=hold)),
        ("kernel", lambda: bench_kernel.run(device=device, hold=hold)),
        ("sortcost", lambda: bench_sortcost.run(
            sizes=DISSECT_SORT_SIZES, payloads=DISSECT_SORT_PAYLOADS,
            reps=DISSECT_REPS, device=device)),
        ("gathercost", lambda: bench_gathercost.run(reps=DISSECT_REPS,
                                                    device=device)),
        ("blockgather", lambda: bench_blockgather.run(reps=DISSECT_REPS,
                                                      device=device)),
        ("equivalence", lambda: backend_equivalence.run(
            out=DISSECT_EQUIV_OUT, device=device)),
        ("sharded", lambda: check_sharded_fullscale.run(
            frames=DISSECT_SHARDED_FRAMES, world=2, device=device)),
    )
    out, launches, failures = {}, {}, []
    for name, run in runs:
        torch.cuda.empty_cache()
        kernels.reset_launches()
        res, sec = timed(run)
        launches[f"dissect_{name}"] = dict(kernels.LAUNCHES)
        res["wall_s"] = sec
        out[name] = res
        log(f"dissect {name}: {sec:.2f} s; launches "
            f"{launches[f'dissect_{name}']}")
    for key, path in DISSECT_KERNELS.items():
        ran = launches[key]
        if min(ran[k] for k in path) < 1:
            failures.append(f"{key}: a path kernel never launched: {ran}")

    fr = out["frame"]
    for frame in ("flat_slice", "blocks"):
        t = fr[frame]
        _table(log, smi, f"dissect {frame}", t["stages"] + [t["sum"]]
               + t["phases"], residual=t.get("residual"),
               max_pairs=t["max_pairs"], demand=t["demand"],
               chain_equal=t["chain_equal"])
        if not t["chain_equal"]:
            failures.append(f"dissect {frame}: the stage chain's frame is not "
                            f"bit-equal to the full function's")
    _table(log, smi, "dissect block cull", fr["blocks"]["cull_stages"]
           + [fr["blocks"]["cull_sum"]])
    for res_key, t in fr["headline"].items():
        _table(log, smi, f"dissect headline {res_key}", t["rows"],
               **{k: v for k, v in t.items() if k != "rows"})
    cull = fr["cull"]
    _table(log, smi, "dissect cull", cull["stages"] + [
        cull["expand_seg_broadcast"], cull["expand_take"]],
        roots_kept=cull["roots_kept"], rows_expanded=cull["rows"],
        branches_equal=cull["branches_equal_on_alive_rows"])
    if not cull["branches_equal_on_alive_rows"]:
        failures.append("dissect cull: the two expansion branches differ")
    _table(log, smi, "dissect kernel2", [fr["kernel2"]["k5"],
                                         fr["kernel2"]["tile_starts"]],
           pairs=fr["kernel2"]["pairs"])
    for probe in ("prims", "blocksize", "demand"):
        _table(log, smi, f"dissect {probe}", fr[probe]["rows"])
    ts_ = out["trainstep"]
    _table(log, smi, "dissect trainstep", ts_["prefixes"],
           itemized=ts_["itemized"], max_pairs=ts_["max_pairs"],
           pairs_measured=ts_["pairs_measured"],
           full_equals_step=ts_["full_equals_step"])
    if not ts_["full_equals_step"]:
        failures.append("dissect trainstep: the full prefix is not bit-equal "
                        "to fused_prepare_train_step")
    _table(log, smi, "dissect bench_kernel", out["kernel"]["rows"])
    for probe in ("sortcost", "gathercost", "blockgather"):
        _table(log, smi, f"dissect {probe}", out[probe]["rows"])
    eq = out["equivalence"]
    for backend, r in eq["runs"].items():
        log(f"dissect equivalence {backend}: val PSNR {r['val_psnr']}, "
            f"final-val {r['final_val']}, train {r['train_s']:.2f} s")
        if not math.isfinite(r["final_val"]["psnr"]):
            failures.append(f"dissect equivalence {backend}: final-val PSNR "
                            f"not finite")
    sh = out["sharded"]
    for f in sh["frames"]:
        log(f"dissect sharded cam {f['cam']}: cut {f['cut']}, pairs "
            f"exchanged {f['pairs_exchanged']} (single card "
            f"{f['single_card_demand']}), overflow {f['bucket_overflow']}, "
            f"lens {f['lens']}, {f['wall_s']:.2f} s")
    if sh["max_overflow"] or not sh["ranks_agree"]:
        failures.append(f"dissect sharded: overflow {sh['max_overflow']}, "
                        f"ranks agree {sh['ranks_agree']}")

    want = {"dissect flat_slice", "dissect blocks", "dissect kernel2",
            "dissect compact_k6", "dissect trainstep"}
    if want - set(held) or not any(k.startswith("bench_kernel")
                                   for k in held):
        failures.append(f"dissect: no calls recorded for "
                        f"{sorted(want - set(held))} or bench_kernel")
    errs, rows = {}, {}
    for label in list(held):
        calls = _copied(held.pop(label), device)
        if "stream_compact" in calls:
            # no profiler count here: on this call (8 columns) the profiler
            # keeps the records of half the launches in every window, while
            # the CUDA events time every launch
            row, f = compare_k6(calls, log, profile=False)
            rows.setdefault("stream_compact", []).append(
                dict(row, call=label))
            errs["stream_compact"] = max(errs.get("stream_compact", 0.0),
                                         row["max_abs_err"])
            failures += f
        e, f = hold_calls(calls, label, log, rows)
        failures += f
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        del calls
        torch.cuda.empty_cache()
    return out, launches, errs, rows, failures


def bench_phase(device, log):
    """log_tpu_torch/scripts/bench.py at full size (600k roots, 3.24M
    points, 1920x1088, 30 frames, BENCH_REPEATS repeats) between a reset
    and a read of the launch counts; its JSON on a line of its own. Each
    cell's first timed frame (with its cull) was replayed inside a recording;
    those kernel calls are held against the plain versions, and the
    headline's K3p and K5 timed. Fails where a cell's budget, slice bucket
    or block bucket overflowed, a timed frame was not finite, a kernel of
    BENCH_KERNELS did not launch in a cell's timed frames, or a held call
    disagrees. Returns (json, launches by cell, frames by cell, held errors,
    kernel rows, failures)."""
    import torch

    from log_tpu_torch.ops import kernels
    from log_tpu_torch.scripts import bench

    held = {}

    def hold(label):
        return recording(held.setdefault(label, {}), copy="cpu")

    torch.cuda.empty_cache()
    kernels.reset_launches()
    res = bench.run(repeats=BENCH_REPEATS, device=device, hold=hold)
    total = dict(kernels.LAUNCHES)
    log(json.dumps(res))
    launches, n_calls, failures = {}, {}, []
    inside = dict.fromkeys(total, 0)
    labels = {}
    for key in bench.CELLS:
        cell = res[key]
        labels[f"bench {cell['label']}"] = key
        launches[f"bench_{key}"] = cell["launches"]
        n_calls[f"bench_{key}"] = cell["frames"] * cell["repeats"]
        for k in inside:
            inside[k] += cell["launches"][k]
        log(f"bench {key} ({cell['label']}): {cell['ms_per_frame']} ms a "
            f"frame (passes {cell['ms_per_frame_runs']}), device "
            f"{cell['device_ms_per_frame']} ms, busy {cell['busy_share']}; "
            f"cut {cell['cut']} (bucket "
            f"{cell['k_vis']}), pairs {cell['pairs_measured']} of "
            f"{cell['max_pairs']} (rebumped {cell['budget_rebumped']}), cull "
            f"pairs {cell['cull_pairs']}; launches a frame "
            f"{cell['launches_per_frame']}, syncs {cell['syncs_per_frame']}, "
            f"peak {cell['peak_gb']} GiB; top {cell['top_device_ops']}")
        if cell["budget_overflow"] or cell["cut_overflow"] or cell.get(
                "blocks_overflow"):
            failures.append(f"bench {key}: a bucket or budget overflowed")
        if not cell["images_finite"]:
            failures.append(f"bench {key}: a timed frame is not finite")
        if min(cell["launches"][k] for k in BENCH_KERNELS) < 1:
            failures.append(f"bench {key}: launches {cell['launches']}")
    launches["bench_other"] = {k: total[k] - inside[k] for k in total}
    missing = set(labels) - set(held)
    if missing:
        failures.append(f"bench: no calls recorded for {sorted(missing)}")
    errs, rows = {}, {}
    for label in list(held):
        calls = _copied(held.pop(label), device)
        if not set(BENCH_KERNELS) <= set(calls):
            failures.append(f"{label}: held calls {sorted(calls)}")
        e, f = hold_calls(calls, label, log, rows)
        failures += f
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        if labels.get(label) == "headline" and "expand_packed" in calls:
            prow, f = compare_packed_kernels(calls, log, profile=False)
            failures += f
            for k, v in prow.items():
                rows.setdefault(k, []).append(dict(v, call=label))
        del calls
        torch.cuda.empty_cache()
    return res, launches, n_calls, errs, rows, failures


def write_foreground_masks(root, log):
    """masks/<view>.png beside images/<view>.png: 255 where a pixel is not
    the scene's white background (every channel under CLI_MASK_WHITE)."""
    import glob
    import os

    from log_tpu_torch.utils import image_io

    shares = []
    names = sorted(glob.glob(os.path.join(root, "images", "**", "*.png"),
                             recursive=True))
    for name in names:
        img = image_io.imread(name)
        fg = (img.min(axis=2) < CLI_MASK_WHITE).astype(np.uint8) * 255
        shares.append(float(fg.mean() / 255))
        rel = os.path.relpath(name, os.path.join(root, "images"))
        image_io.imwrite(os.path.join(root, "masks", rel), fg)
    log(f"cli_mask: {len(names)} masks, foreground share "
        f"{min(shares):.3f}-{max(shares):.3f}")
    return names, shares


def cli_mask_phase(log):
    """config/synthetic's scene made on the card by the port's
    make_synthetic_scene, masks/ by thresholding its white background, and
    config/synthetic_mask (MaskForeground: the loss restricted to the mask's
    box) trained through log_tpu_torch.apps.train with the scene's root
    overridden, then final_val (the masked validation). Every step must
    launch K4, K3, K1 and K2 and hand the mask to the step; the tree
    stage's loss must fall. Returns (json, launches, calls, failures)."""
    import os
    import shutil

    import torch

    from log_tpu_torch.apps import final_val, make_synthetic_scene, train
    from log_tpu_torch.model.level_of_gaussian import LoG
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.utils.trainer import Trainer

    for d in (CLI_MASK_SCENE, os.path.dirname(CLI_MASK_EXP)):
        shutil.rmtree(d, ignore_errors=True)
    failures, out, steps = [], {"phase_s": {}}, []
    real_step, real_iter = Trainer.training_step, LoG.training_iteration
    masked = []

    def iteration(self, *args, **kw):
        masked.append(kw.get("fg_mask") is not None)
        return real_iter(self, *args, **kw)

    def step(self, model, data):
        before = dict(kernels.LAUNCHES)
        n0 = len(masked)
        ok, output, loss = real_step(self, model, data)
        steps.append({"stage": model.stage_name,
                      "loss": float(output["loss_dev"]),
                      "masked": masked[n0:] == [True],
                      "ran": {k: kernels.LAUNCHES[k] - before[k]
                              for k in kernels.LAUNCHES}})
        return ok, output, loss

    opts = ["root", CLI_MASK_SCENE, "PLYNAME",
            CLI_MASK_SCENE + "/sparse/0/sparse.npz", "exp", CLI_MASK_EXP,
            "dataset.args.ext", ".png", "val_dataset.args.ext", ".png"]
    with blocked_imports(log):
        _, out["phase_s"]["scene"] = timed(lambda: make_synthetic_scene.main(
            CLI_MASK_SCENE_ARGS))
        (_, shares), out["phase_s"]["masks"] = timed(
            lambda: write_foreground_masks(CLI_MASK_SCENE, log))
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        with patched(Trainer, {"training_step": step}), \
                patched(LoG, {"training_iteration": iteration}):
            trainer, out["phase_s"]["train"] = timed(lambda: train.main(
                ["--cfg", CLI_MASK_CFG, "split", "train"] + opts))
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        points = trainer.model.num_points
        renderer = type(trainer.render).__name__
        del trainer
        record, out["phase_s"]["final_val"] = timed(lambda: final_val.main(
            [CLI_MASK_CFG, os.path.join(CLI_MASK_EXP, "model_tree.pth")]
            + opts))
    ran = {k: sum(x["ran"][k] for x in steps) for k in launches}
    tree = [x["loss"] for x in steps if x["stage"] == "tree"]
    first = float(np.mean(tree[:CLI_MASK_WINDOW])) if tree else math.nan
    last = float(np.mean(tree[-CLI_MASK_WINDOW:])) if tree else math.nan
    uneven = [i for i, x in enumerate(steps)
              if min(x["ran"][k] for k in STEP_KERNELS) < 1]
    unmasked = [i for i, x in enumerate(steps) if not x["masked"]]
    log(f"cli_mask: renderer {renderer}, {len(steps)} steps "
        f"({len(tree)} in the tree stage) in {out['phase_s']['train']:.2f} "
        f"s, {points} points, peak {peak / 2**30:.3f} GiB; tree loss first "
        f"{CLI_MASK_WINDOW} {first:.5f}, last {CLI_MASK_WINDOW} {last:.5f}; "
        f"launches {ran} in the steps, {launches} in all; masked "
        f"validation psnr {record['psnr']:.3f} ssim {record['ssim']:.4f} l1 "
        f"{record['l1']:.4f}")
    if renderer != "MaskForeground":
        failures.append(f"cli_mask: the config's renderer is {renderer}")
    if not steps or uneven or unmasked:
        failures.append(f"cli_mask: steps without K4, K3, K1 and K2 "
                        f"{uneven[:4]}, without the mask {unmasked[:4]}")
    if not (len(tree) >= 2 * CLI_MASK_WINDOW and last < first):
        failures.append(f"cli_mask: tree loss did not fall ({first} -> "
                        f"{last})")
    if not math.isfinite(record["psnr"]):
        failures.append(f"cli_mask: final-val {record}")
    out.update(steps=len(steps), tree_steps=len(tree),
               tree_loss_first_last=[first, last], points=points,
               peak_bytes=peak, mask_share=[min(shares), max(shares)],
               final_val={k: record[k] for k in CLI_VAL_KEYS})
    return (out, {"cli_mask": ran, "cli_mask_other": {
        k: launches[k] - ran[k] for k in launches}}, {"cli_mask": len(steps)},
            failures)


# ------------------------------------------ viewer, vanilla, viewer_cli, tools
def decode_jpeg(data):
    """BGR uint8 of JPEG bytes (cv2, else PIL): a check, not on the path."""
    try:
        import cv2

        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    except ImportError:
        import io

        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            return np.asarray(im.convert("RGB"))[:, :, ::-1].copy()


@contextlib.contextmanager
def serving(state):
    """A ThreadingHTTPServer over make_handler(state) on 127.0.0.1 (a free
    port) in a thread; yields a GET function (path -> (status, content
    type, body, host ms)); the server is shut down on exit."""
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    from log_tpu_torch.apps.viewer import make_handler

    server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    # no proxy for localhost, whatever the environment says
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    base = f"http://127.0.0.1:{server.server_address[1]}"

    def get(path):
        t0 = time.perf_counter()
        try:
            with opener.open(base + path, timeout=120) as resp:
                body = resp.read()
                status, ctype = resp.status, resp.headers["Content-Type"]
        except urllib.error.HTTPError as err:
            body, status, ctype = b"", err.code, None
        return status, ctype, body, (time.perf_counter() - t0) * 1e3

    try:
        yield get
    finally:
        server.shutdown()
        server.server_close()
        thread.join()


def render_path(yaw, pitch, dist, offset):
    return (f"/render?yaw={yaw!r}&pitch={pitch!r}&dist={dist!r}"
            f"&cx={offset[0]!r}&cy={offset[1]!r}&cz={offset[2]!r}")


@contextlib.contextmanager
def request_telemetry(renderer, model, rec):
    """The latest frame's split into rec: prepare_ms (host clock around
    model.prepare_from_camera, to a synchronize), render_ms (CUDA events
    around render_one) with its pair demand and budget, bgr_ms (host clock
    around tensor_to_bgr: the 8-bit BGR on the host) and encode_ms (host
    clock around encode_jpeg); wrappers on the instances and on image_io's
    function, removed on exit."""
    import torch

    from log_tpu_torch.utils import image_io

    real_prep, real_one = model.prepare_from_camera, renderer.render_one
    real_bgr, real_encode = renderer.tensor_to_bgr, image_io.encode_jpeg

    def host_timed(key, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec[key] = (time.perf_counter() - t0) * 1e3
            return out
        return call

    def one(*args, **kwargs):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real_one(*args, **kwargs)
        e1.record()
        e1.synchronize()
        rec["render_ms"] = e0.elapsed_time(e1)
        rec["pair_total"] = int(out["pair_total"])
        rec["max_pairs"] = int(out["max_pairs"])
        return out

    model.prepare_from_camera = host_timed("prepare_ms", real_prep)
    renderer.render_one = one
    renderer.tensor_to_bgr = host_timed("bgr_ms", real_bgr)
    try:
        with patched(image_io, {"encode_jpeg": host_timed("encode_ms",
                                                          real_encode)}):
            yield rec
    finally:
        del model.prepare_from_camera, renderer.render_one
        del renderer.tensor_to_bgr


def viewer_poses(n, seed=SEED):
    """n (yaw, pitch, dist, offset) views of the synthetic tree, each its
    own: a turn around the center, looking down 0.45-0.95 rad from 16-32
    units, the target moved up to 6 units over the ground."""
    rng = np.random.default_rng(seed + 10)
    return [(2 * math.pi * i / n + float(rng.uniform(-0.1, 0.1)),
             float(rng.uniform(0.45, 0.95)), float(rng.uniform(16.0, 32.0)),
             tuple(float(v) for v in np.append(rng.uniform(-6, 6, 2), 0.0)))
            for i in range(n)]


def viewer_requests(get, state, poses, log, label):
    """GET /render of each pose after VIEWER_WARMUP warm-up requests, the
    launch counts set to 0 just before them and read just after; per
    request the host latency, render_one's device time, the encode time,
    the pair demand and budget, the launches and the decoded frame.
    Returns (requests, launches, decoded frames, failures)."""
    from log_tpu_torch.ops import kernels

    fails, rec = [], {}
    with request_telemetry(state.renderer, state.model, rec):
        for pose in poses[:VIEWER_WARMUP]:
            get(render_path(*pose))
        kernels.reset_launches()
        reqs, frames = [], []
        for i, pose in enumerate(poses):
            before = dict(kernels.LAUNCHES)
            rec.clear()
            status, ctype, body, ms = get(render_path(*pose))
            ran = {k: kernels.LAUNCHES[k] - before[k] for k in before}
            if status != 200 or ctype != "image/jpeg":
                fails.append(f"{label} request {i}: {status} {ctype}")
                continue
            frames.append(decode_jpeg(body))
            reqs.append({"pose": pose, "latency_ms": ms, "bytes": len(body),
                         **rec, "launches": ran})
            if (ran["pack_rows"] < 1 or ran["expand_with_keys"] < 1
                    or ran["rasterize_fwd"] < 1 or ran["rasterize_bwd"]
                    or ran["rasterize_fwd_packed"]):
                fails.append(f"{label} request {i} launched {ran}")
            if rec.get("pair_total", 0) > rec.get("max_pairs", 0):
                fails.append(f"{label} request {i}: pair demand "
                             f"{rec.get('pair_total')} over the budget "
                             f"{rec.get('max_pairs')}")
        launches = dict(kernels.LAUNCHES)
    lat = [r["latency_ms"] for r in reqs]
    if lat:
        split = ", ".join(f"{k[:-3]} {np.mean([r[k] for r in reqs]):.3f}"
                          for k in TELEMETRY_MS)
        log(f"{label}: {len(reqs)} requests after {VIEWER_WARMUP} warm-up, "
            f"latency ms mean {np.mean(lat):.3f} (min {np.min(lat):.3f}, max "
            f"{np.max(lat):.3f}), of which ms {split}; "
            f"{1e3 / np.mean(lat):.2f} requests/s; pair demand "
            f"{min(r['pair_total'] for r in reqs)}-"
            f"{max(r['pair_total'] for r in reqs)} (budget "
            f"{max(r['max_pairs'] for r in reqs)}); JPEG "
            f"{np.mean([r['bytes'] for r in reqs]):.0f} bytes; launches "
            f"{launches}")
    return reqs, launches, frames, fails


def latency_json(reqs):
    keys = ("latency_ms",) + TELEMETRY_MS
    return {f"{k}_{f.__name__}": float(f([r[k] for r in reqs]))
            for k in keys for f in (np.mean, np.min, np.max)}


def viewer_phase(device, log):
    """The HTTP viewer over the 3.24M-point tree at 1920x1080: the port's
    ViewerState and make_handler behind a ThreadingHTTPServer on
    127.0.0.1, VIEWER_REQUESTS GET /render at their own poses (after
    VIEWER_WARMUP), GET / and a 404; each decoded JPEG equal to the same
    camera's direct frame encoded alike, request 0's frame with the plain
    versions and its kernel calls against them. Returns (json, launches,
    held kernel errors, K1 rows, failures)."""
    import torch

    from log_tpu_torch.apps import viewer
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils import image_io

    model = build_model(N_ROOTS, device)
    renderer = NaiveRendererAndLoss(split="demo", device=device)
    center = model.gaussian.to_numpy(["xyz"])["xyz"].mean(axis=0)
    state = viewer.ViewerState(model, renderer, VIEWER_H, VIEWER_W,
                               focal=1.2 * VIEWER_W, center=center,
                               znear=0.01, zfar=100.0)
    poses = viewer_poses(VIEWER_REQUESTS)
    t0 = time.perf_counter()
    state.render_jpeg(0.0, 0.5, 4.0, np.zeros(3))  # as viewer.main does
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with serving(state) as get:
        page = get("/")
        missing = get("/nothing")
        reqs, launches, frames, failures = viewer_requests(
            get, state, poses, log, "viewer")
    peak = torch.cuda.max_memory_allocated()
    if page[0] != 200 or page[1] != "text/html" or \
            f'width="{VIEWER_W}" height="{VIEWER_H}"'.encode() not in page[2]:
        failures.append(f"viewer: GET / answered {page[:2]}")
    if missing[0] != 404:
        failures.append(f"viewer: GET /nothing answered {missing[0]}")
    for name in SERVING_KERNELS:
        if launches[name] < VIEWER_REQUESTS:
            failures.append(f"viewer: {name} launched {launches[name]} "
                            f"times in {VIEWER_REQUESTS} requests")
    # each decoded JPEG against the same camera's direct frame, encoded
    # alike: equal pixels (the frame is deterministic); the JPEG's own loss
    # is logged
    jpeg_err = []
    for i, (pose, img) in enumerate(zip(poses, frames)):
        direct = state.render_bgr(pose[0], pose[1], pose[2],
                                  np.asarray(pose[3]))
        want = decode_jpeg(image_io.encode_jpeg(direct, viewer.JPEG_QUALITY))
        if not np.array_equal(img, want) or direct.std() < 1.0:
            failures.append(f"viewer: request {i}'s JPEG is not its "
                            f"camera's direct frame (std {direct.std()})")
        jpeg_err.append(float(np.abs(img.astype(np.float64) - direct).mean()))
    # request 0's camera: its kernel calls, and the all-plain frame
    pose = poses[0]
    calls = {}
    with recording(calls):
        kern = state.render_bgr(pose[0], pose[1], pose[2], np.asarray(pose[3]))
    with plain_versions():
        plain = state.render_bgr(pose[0], pose[1], pose[2],
                                 np.asarray(pose[3]))
    diff = float(np.abs(plain.astype(np.float64) - kern).max()) / 255.0
    log(f"viewer: warm-up frame {warm_s:.2f} s; peak memory "
        f"{peak / 2**30:.3f} GiB; decoded JPEG vs direct frame mean abs "
        f"{min(jpeg_err or [0]):.3f}-{max(jpeg_err or [0]):.3f} (8-bit); "
        f"request 0 plain vs kernels max abs {diff:.4g}")
    if diff > FRAME_MAX_ABS:
        failures.append(f"viewer: plain frame differs by {diff}")
    k_rows = {}
    errs, f = hold_calls(calls, "viewer request 0", log, k_rows)
    failures += f
    out = {"requests": reqs, "peak_bytes": peak, "warmup_frame_s": warm_s,
           "jpeg_mean_abs": jpeg_err, "plain_frame_max_abs": diff,
           "points": model.num_points, "launches": launches,
           **(latency_json(reqs) if reqs else {})}
    return out, launches, errs, k_rows, failures


def vanilla_phase(device, log):
    """BASELINE.json configs[1], the vanilla 3DGS model: the tree's 600k
    roots as a BaseGaussian (create_from_record, SH 1) over the serving
    orbit at 1920x1088 through NaiveRendererAndLoss.vis (two-phase: the
    frustum mask, then render_one with the capacity's pair budget); no
    overflow, one K4, K3 and K1 per frame; frame 0 against its all-plain
    rerun and its kernel calls against the plain versions; then
    check_viewer --oneshot on the card. Returns (json, launches, held kernel
    errors, K1 rows, failures)."""
    import torch

    from log_tpu_torch.apps import check_viewer
    from log_tpu_torch.model.base_gaussian import BaseGaussian
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.synth_tree import build_checkpoint, roots_record

    record = roots_record(build_checkpoint(N_ROOTS, seed=SEED), N_ROOTS)
    model = BaseGaussian.create_from_record(record, sh_degree=1,
                                            device=device)
    model.eval()
    model.set_state(enable_sh=True)
    renderer = NaiveRendererAndLoss(split="demo", device=device)
    batches = orbit_batches(FRAMES)
    calls = {}
    with recording(calls):
        renderer.vis(batches[0], model)
    failures, frames, renders = [], [], []
    rec = {}
    torch.cuda.reset_peak_memory_stats()
    with request_telemetry(renderer, model, rec):
        kernels.reset_launches()
        for i, batch in enumerate(batches):
            rec.clear()
            out, s = timed(lambda: renderer.vis(batch, model))
            frames.append({"frame": i, "ms": s * 1e3, **rec})
            renders.append(out["render"][0])
        launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    frame_ms = [f["ms"] for f in frames[WARMUP:]]
    over = [f["frame"] for f in frames if f["pair_total"] > f["max_pairs"]]
    log(f"vanilla: {model.num_points} Gaussians (capacity {model.capacity}), "
        f"{FRAMES} frames ({WARMUP} warm-up), per-frame ms "
        + " ".join(f"{f['ms']:.2f}" for f in frames)
        + f"; mean {np.mean(frame_ms):.3f} ms, render_one "
        f"{np.mean([f['render_ms'] for f in frames[WARMUP:]]):.3f} ms; pair "
        f"demand {min(f['pair_total'] for f in frames)}-"
        f"{max(f['pair_total'] for f in frames)} (budget "
        f"{frames[0]['max_pairs']}), overflow in frames {over}; peak memory "
        f"{peak / 2**30:.3f} GiB; launches {launches}")
    if over:
        failures.append(f"vanilla: pair overflow in frames {over}")
    for name in SERVING_KERNELS:
        if launches[name] != FRAMES:
            failures.append(f"vanilla: {name} launched {launches[name]} "
                            f"times in {FRAMES} frames")
    for name in ("rasterize_bwd", "rasterize_fwd_packed", "expand_packed"):
        if launches[name]:
            failures.append(f"vanilla: {name} launched")
    failures += check_frames(renders, "vanilla")
    with plain_versions():
        plain = renderer.vis(batches[0], model)["render"][0]
    diff = float(np.abs(plain - renders[0]).max())
    log(f"vanilla: frame 0 plain vs kernels max abs {diff:.4g}")
    if diff > FRAME_MAX_ABS:
        failures.append(f"vanilla: plain frame differs by {diff}")
    k_rows = {}
    errs, f = hold_calls(calls, "vanilla frame 0", log, k_rows)
    failures += f
    del model, renderer
    torch.cuda.empty_cache()
    # check_viewer --oneshot on the card (2,000 Gaussians at 360x480)
    kernels.reset_launches()
    jpeg, s = timed(lambda: check_viewer.main(
        ["--oneshot", "--out", "build/check_viewer.jpg"]))
    cv_launches = dict(kernels.LAUNCHES)
    img = decode_jpeg(jpeg)
    log(f"check_viewer --oneshot: {len(jpeg)} bytes, {s * 1e3:.1f} ms, "
        f"launches {cv_launches}")
    if img.shape != (check_viewer.H, check_viewer.W, 3) or img.std() < 10:
        failures.append(f"check_viewer: frame {img.shape} std {img.std()}")
    for name in SERVING_KERNELS:
        if cv_launches[name] != 1:
            failures.append(f"check_viewer: {name} launched "
                            f"{cv_launches[name]} times")
    out = {"frame_ms_mean": float(np.mean(frame_ms)),
           "frame_ms_min": float(np.min(frame_ms)),
           "frame_ms_max": float(np.max(frame_ms)), "frames": frames,
           "points": int(record["xyz"].shape[0]), "peak_bytes": peak,
           "plain_frame_max_abs": diff, "launches": launches,
           "check_viewer": {"ms": s * 1e3, "bytes": len(jpeg),
                            "launches": cv_launches}}
    return out, {"vanilla": launches, "check_viewer": cv_launches}, errs, \
        k_rows, failures


def viewer_cli_phase(log):
    """The viewer's own entry: make_state of Config.load_args on the cli
    phase's config and final checkpoint (--device cuda), the warm-up frame
    as viewer.main renders it, then VIEWER_CLI_REQUESTS requests through
    make_handler. Returns (json, launches, failures)."""
    import os

    from log_tpu_torch.apps.train import resolve_device
    from log_tpu_torch.apps.viewer import make_state
    from log_tpu_torch.utils.command import update_global_variable
    from log_tpu_torch.utils.config import Config

    ckpt = os.path.join(CLI_EXP, "model_tree_full.pth")
    args, cfg = Config.load_args(["--cfg", CLI_CFG, "ckptname", ckpt]
                                 + CLI_OPTS)
    cfg = update_global_variable(cfg, cfg)
    state, s = timed(lambda: make_state(cfg, resolve_device(args.device)))
    state.render_jpeg(0.0, 0.5, 4.0, np.zeros(3))
    poses = [(2 * math.pi * i / VIEWER_CLI_REQUESTS, 0.5, 4.0, (0.0, 0.0, 0.0))
             for i in range(VIEWER_CLI_REQUESTS)]
    with serving(state) as get:
        reqs, launches, frames, failures = viewer_requests(
            get, state, poses, log, "viewer_cli")
    log(f"viewer_cli: make_state {s:.2f} s, {state.model.num_points} points "
        f"from {ckpt}, screen {state.W}x{state.H}, focal {state.focal}")
    for i, img in enumerate(frames):
        if img.shape != (state.H, state.W, 3) or img.std() < 5:
            failures.append(f"viewer_cli: frame {i} {img.shape} std "
                            f"{img.std()}")
    if len(reqs) != VIEWER_CLI_REQUESTS:
        failures.append(f"viewer_cli: {len(reqs)} answers")
    return ({"make_state_s": s, "points": state.model.num_points,
             "screen": [state.W, state.H], "requests": reqs,
             "launches": launches, **(latency_json(reqs) if reqs else {})},
            launches, failures)


def tools_phase(log):
    """The port's test_dataset and test_pointcloud on the cli scene (5
    frames each, test_pointcloud's on the card) and read_colmap on a small
    COLMAP model written by the port's writers, each as python -m in a
    subprocess, checked by its outputs. Returns (json, failures)."""
    import os
    import shutil

    from log_tpu_torch.dataset.camera_utils import read_cameras
    from log_tpu_torch.utils import colmap_utils as cu
    from log_tpu_torch.utils import image_io

    shutil.rmtree(TOOLS_OUT, ignore_errors=True)
    failures, out = [], {}

    def run(name, module, argv):
        proc = subprocess.run([sys.executable, "-m", module, *argv],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            failures.append(f"tools: {name} exited {proc.returncode}: "
                            f"{proc.stderr[-2000:]}")
        return proc

    for name, outdir, pattern in (("test_dataset", "dataset", "{:06d}"),
                                  ("test_pointcloud", "pointcloud",
                                   "pointcloud_{:06d}")):
        d = os.path.join(TOOLS_OUT, outdir)
        _, s = timed(lambda: run(name, f"log_tpu_torch.apps.{name}",
                                 ["--cfg", CLI_CFG, *CLI_OPTS, "outdir", d]))
        files = sorted(os.listdir(d)) if os.path.isdir(d) else []
        out[name] = {"s": s, "files": files}
        imgs = [image_io.imread(os.path.join(d, f)) for f in files]
        log(f"tools: {name} {s:.2f} s, wrote {files}")
        if len(files) != 5 or any(im is None or im.std() < 5 for im in imgs):
            failures.append(f"tools: {name} wrote {files}")
        elif name == "test_pointcloud":
            # the render beside the image: the cloud lands where the
            # scene's pixels are
            render, gt = np.split(imgs[0].astype(np.float64), 2, axis=1)
            out[name]["render_gt_mean_abs"] = float(np.abs(render - gt).mean())
            log(f"tools: test_pointcloud frame 0 |render - image| mean "
                f"{out[name]['render_gt_mean_abs']:.2f} (8-bit)")
    rng = np.random.default_rng(SEED)
    colmap = os.path.join(TOOLS_OUT, "colmap")
    cameras = {1: cu.Camera(1, "PINHOLE", 320, 256,
                            np.array([300.0, 300.0, 160.0, 128.0])),
               2: cu.Camera(2, "OPENCV", 320, 256,
                            np.array([310.0, 305.0, 161.0, 127.0, 0.01,
                                      -0.02, 0.001, 0.0]))}
    images, n_pts = {}, 50
    for i in range(1, 7):
        a = 2 * math.pi * i / 6
        eye = np.array([4 * math.cos(a), 4 * math.sin(a), 1.0])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        images[i] = cu.Image(i, cu.rotmat2qvec(R), -R @ eye, 1 + i % 2,
                             f"{i:04d}.jpg", rng.uniform(0, 320, (3, 2)),
                             rng.integers(1, n_pts + 1, 3))
    points = {p: cu.Point3D(p, rng.normal(size=3), rng.integers(0, 256, 3),
                            0.5, rng.integers(1, 7, 1 + p % 4),
                            rng.integers(0, 3, 1 + p % 4))
              for p in range(1, n_pts + 1)}
    cu.write_model(cameras, images, points, colmap, ".bin")
    _, s = timed(lambda: run("read_colmap",
                             "log_tpu_torch.apps.calibration.read_colmap",
                             [colmap, "--min_views", "2"]))
    want = sum(1 for p in points.values() if p.image_ids.shape[0] >= 2)
    try:
        sparse = np.load(os.path.join(colmap, "sparse.npz"))
        cams = read_cameras(colmap)
        got = (int(sparse["xyz"].shape[0]), len(cams))
    except OSError as exc:
        got = str(exc)
    log(f"tools: read_colmap {s:.2f} s: (points, cameras) {got}, want "
        f"({want}, {len(images)})")
    if got != (want, len(images)):
        failures.append(f"tools: read_colmap gave {got}")
    out["read_colmap"] = {"s": s, "points_cameras": got}
    return out, failures


def multi_main(device, log) -> int:
    """`--only multi`: the training snapshot of the training phase (the
    3.24M-point tree, its 4 views and GT, the perturbation), then
    multi_rank_phase alone; fewer than two cards is a failure."""
    import torch

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"FAIL: --only multi needs two cards or more, found {cards}",
              file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    model = build_train_model(device)
    batches = train_batches()
    make_ground_truth(model, batches, device, log)
    snapshot = snapshot_of(model)
    del model
    torch.cuda.empty_cache()
    log(f"multi setup: {snapshot['gaussian.xyz'].shape[0]} rows, "
        f"{time.perf_counter() - t0:.2f} s")
    (mc_json, launches, n_calls, errs, rows, failures), sec = timed(
        lambda: multi_rank_phase(snapshot, batches, device, log))
    mc_json["phase_s"] = sec
    log(f"multi_card phase: {sec:.2f} s")
    log(json.dumps({"multi_card": mc_json}))
    kernels_json = []
    for name, (src, replaces) in KERNEL_SOURCES.items():
        by_phase = {phase: run[name] for phase, run in launches.items()}
        kernels_json.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "launches_per_call": {phase: k / n_calls[phase]
                                  for phase, k in by_phase.items()
                                  if k and n_calls.get(phase)},
            "max_abs_err": errs.get(name), "held_rows": rows.get(name, []),
            "library_ms": None, "library_note": NO_LIBRARY_CALL[name]})
    if failures:
        for f in failures:
            print("FAIL: " + f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels_json}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--torchrun-cli"]:
        return torchrun_cli_main(sys.argv[2:])
    only = None
    if "--only" in sys.argv[1:]:
        only = sys.argv[sys.argv.index("--only") + 1:][:1]
        if only != ["multi"]:
            print(f"chip_smoke: --only takes 'multi', not {only}",
                  file=sys.stderr)
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
    if only:
        return multi_main(device, log)
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
    rate = link_rate(log)
    ren, alp = frame_planes(model, renderer, batches[0])
    th_frame = check_to_host("generic frame", [(ren, 1), (alp, 2)], rate,
                             log, failures)
    rows["to_host"] = {
        **{key: th_frame[key] for key in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")},
        "library_note": "a pinned copy_ of the bytes the kernel writes, "
                        "with no quantize",
        "link_bytes_per_s": rate, "calls": [th_frame],
        "kept_frame": kept_frame_cost((1, *ren.shape), log)}
    del ren, alp

    frame_ms, renders, telemetry, launches, peak = run_slice(
        model, renderer, batches, log
    )
    for name in SERVING_KERNELS:
        if launches[name] <= 0:
            failures.append(f"kernel {name} never launched on the serving "
                            f"path")
    if launches["to_host"] != FRAMES:
        failures.append(f"to_host launched {launches['to_host']} times in "
                        f"{FRAMES} frames")
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

    # ----------------------------------------- the viewer, the vanilla model
    held = {}
    viewer_json, v_launches, held["viewer"], v_rows, vfail = viewer_phase(
        device, log)
    failures += vfail
    torch.cuda.empty_cache()
    vanilla_json, van_launches, held["vanilla"], van_rows, vanfail = \
        vanilla_phase(device, log)
    failures += vanfail
    for phase_rows in (v_rows, van_rows):
        rows["rasterize_fwd"]["modes"] += phase_rows.get("rasterize_fwd", [])
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
    if t_launches["to_host"] != TRAIN_STEPS:
        failures.append(f"to_host launched {t_launches['to_host']} times in "
                        f"{TRAIN_STEPS} steps")
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
    th_gt = check_to_host("training step GT",
                          [(next(iter(trainer._gt_dev_cache.values())), 1)],
                          rate, log, failures)
    rows["to_host"]["calls"].append(th_gt)
    rows["to_host"]["max_abs_err"] = max(c["max_abs_err"]
                                         for c in rows["to_host"]["calls"])
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
    # ------------------------------------------------ the parallel layer
    with one_rank_group(log):
        (ss_json, ss_launches, held["sharded_step"], ss_rows, ss_model,
         ssfail) = sharded_step_phase(snapshot, batches, device, log)
        failures += ssfail
        (sr_json, sr_launches, held["sharded_render"], sr_rows,
         srfail) = sharded_render_phase(ss_model, device, log)
        failures += srfail
    del ss_model
    torch.cuda.empty_cache()
    (mc_json, mc_launches, mc_calls, held["multi_card"], mc_rows,
     mcfail) = multi_rank_phase(snapshot, batches, device, log)
    failures += mcfail
    for phase_rows in (ss_rows, sr_rows, mc_rows):
        rows["rasterize_fwd"]["modes"] += phase_rows.get("rasterize_fwd", [])
    rows["rasterize_bwd"]["sharded_step_calls"] = ss_rows.get(
        "rasterize_bwd", [])
    if mc_rows.get("rasterize_bwd"):
        rows["rasterize_bwd"]["multi_card_calls"] = mc_rows["rasterize_bwd"]
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
    vc_json, vc_launches, vcfail = viewer_cli_phase(log)
    failures += vcfail
    tools_json, tfail = tools_phase(log)
    failures += tfail
    cd_json, cd_launches, cd_calls, held["cli_depth"], cdfail = \
        cli_depth_phase(cli_json["final_val"], log)
    failures += cdfail
    cp_json, cp_launches, cp_steps, cpfail = cli_parallel_phase(log)
    failures += cpfail
    # ------------------------------------- LoG's own scale, masked training
    torch.cuda.empty_cache()
    (sc_json, sc_launches, sc_calls, held["scale"], sc_rows,
     scfail), sc_s = timed(lambda: scale_phase(device, log))
    failures += scfail
    sc_json["phase_s"] = sc_s
    for name, kernel_rows in sc_rows.items():
        if name == "rasterize_fwd":
            rows[name]["modes"] += kernel_rows
        else:
            rows[name]["scale_calls"] = kernel_rows
    torch.cuda.empty_cache()
    (dk_json, dk_launches, held["dissect"], dk_rows, dkfail), dk_s = timed(
        lambda: dissect_phase(device, smi, log))
    failures += dkfail
    dk_json["phase_s"] = dk_s
    for name, kernel_rows in dk_rows.items():
        if name == "rasterize_fwd":
            rows[name]["modes"] += kernel_rows
        else:
            rows[name]["dissect_calls"] = kernel_rows
    torch.cuda.empty_cache()
    (bk_json, bk_launches, bk_calls, held["bench"], bk_rows,
     bkfail), bk_s = timed(lambda: bench_phase(device, log))
    failures += bkfail
    bk_json["phase_s"] = bk_s
    for name, kernel_rows in bk_rows.items():
        if name == "rasterize_fwd":
            rows[name]["modes"] += kernel_rows
        else:
            rows[name]["bench_calls"] = kernel_rows
    (cm_json, cm_launches, cm_calls, cmfail), cm_s = timed(
        lambda: cli_mask_phase(log))
    failures += cmfail
    cm_json["phase_s"]["total"] = cm_s
    log(f"phase wall times: scale {sc_s:.2f} s, dissect {dk_s:.2f} s, "
        f"bench {bk_s:.2f} s, cli_mask {cm_s:.2f} s")

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
        "sharded_step": ss_json, "sharded_render": sr_json,
        "multi_card": mc_json, "cli_parallel": cp_json, "viewer": viewer_json,
        "vanilla": vanilla_json, "viewer_cli": vc_json, "tools": tools_json,
        "scale": sc_json, "dissect": dk_json, "bench": bk_json,
        "cli_mask": cm_json,
    }))
    kernels_json = []
    runs = dict(serve_runs, train=t_launches, growth=g_launches,
                depth_step=d_launches, **s_launches, two_stage=ts_launches,
                grown_frame=gf_launches, **cli_launches, **cd_launches,
                sharded_step=ss_launches, **sr_launches, **mc_launches,
                **cp_launches,
                viewer=v_launches, **van_launches, viewer_cli=vc_launches,
                **sc_launches, **dk_launches, **bk_launches, **cm_launches)
    # main-path calls per phase: frames, training steps, or renders
    n_calls = dict({phase: FRAMES for phase in serve_runs},
                   train=TRAIN_STEPS, growth=GROWTH_STEPS,
                   depth_step=DEPTH_STEPS, spill_device=SPILL_STEPS,
                   spill=SPILL_STEPS, spill_after_densify=SPILL_AFTER_DENSIFY,
                   two_stage=len(two_json["steps"]), grown_frame=1,
                   **cli_calls, **cd_calls, sharded_step=SHARDED_STEPS,
                   **{k: FRAMES for k in sr_launches}, **mc_calls,
                   **cp_steps,
                   viewer=VIEWER_REQUESTS, vanilla=FRAMES, check_viewer=1,
                   viewer_cli=VIEWER_CLI_REQUESTS, **sc_calls, **bk_calls,
                   **cm_calls)
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
