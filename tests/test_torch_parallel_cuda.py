"""The parallel layer on the card: a one-rank NCCL group (started by
parallel/launch.py) runs the sharded step and the sharded frame on a small
tree, each held against the single-card path on the same card.

Marked `cuda`: each test skips without a CUDA device. Run them on the GPU
machine with

    python -m pytest tests/test_torch_parallel_cuda.py -q -m cuda --noconftest

- 6 ShardedExecutor steps (the tiled backend, the root weight cull, one
  camera a step) against prepare_from_camera + LoG.train_step: params,
  unit quaternions, moments and float counters at tests/test_parallel.py's
  single-chip tolerances, integer counters and kept counts equal;
- the sharded frame (strided layout, SH 0 and SH 1) against the
  single-card flat_slice frame without the weight cull, within
  tests/test_sharded_render.py's bound, with no bucket overflow;
- every kernel of both paths launched (K1, K2, K3, K4).
"""
import math

import numpy as np
import pytest
import torch

from log_tpu_torch.parallel.launch import spawn

pytestmark = pytest.mark.cuda
STEPS = 6
H, W = 128, 256
N_ROOTS = 4000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cameras(n=4):
    from log_tpu_torch.dataset.base import prepare_camera

    cams = []
    for i in range(n):
        theta = 2 * math.pi * i / n + 0.3
        pos = np.array([14.0 * math.cos(theta), 14.0 * math.sin(theta), 22.0])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, np.array([0, 0, 1.0]))
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        K = np.array([[150.0, 0, W / 2], [0, 150.0, H / 2], [0, 0, 1]])
        cams.append(prepare_camera(
            {"K": K, "R": R, "T": (-R @ pos).reshape(3, 1), "H": H, "W": W,
             "center": pos.reshape(3, 1)}, 1, 0.01, 1000.0))
    return cams


def _model(device):
    """The synthetic tree as a training model, colors perturbed."""
    from log_tpu_torch.model.level_of_gaussian import LoG
    from log_tpu_torch.utils.synth_tree import build_checkpoint

    ckpt = build_checkpoint(N_ROOTS, seed=0)
    for key in ("xyz", "colors", "scaling", "opacity", "rotation", "shs"):
        for mk in ("exp_avg", "exp_avg_sq"):
            ckpt[f"optimizer.{mk}.{key}"] = np.zeros_like(
                ckpt[f"gaussian.{key}"])
    ckpt["gaussian.colors"] = ckpt["gaussian.colors"] + 0.3 * np.random.default_rng(
        1).normal(size=ckpt["gaussian.colors"].shape).astype(np.float32)
    model = LoG(gaussian={"sh_degree": 1, "xyz_scale": 1.0},
                tree={"max_child": 4, "max_level": 30},
                optimizer={"optimize_keys": ["xyz", "colors", "scaling",
                                             "opacity", "rotation", "shs"],
                           "opt_all_levels": True,
                           "lr_dict": {"xyz": 0.00016, "xyz_final": 0.0000016,
                                       "colors": 0.0025, "shs": 0.000125,
                                       "scaling": 0.005, "opacity": 0.05,
                                       "rotation": 0.001, "max_steps": 600}},
                densify_and_remove={}, device=device)
    model.load_state_dict(ckpt, split="train")
    model.set_state(enable_sh=True)
    model.set_stage("tree")
    model.training_setup()  # the counters at the capacity
    return model, ckpt


def _gt(ckpt, cams, device):
    """8-bit frames of the unperturbed tree."""
    from log_tpu_torch.utils.synth_tree import build_checkpoint

    model, _ = _model(device)
    model.gaussian.set("colors", torch.as_tensor(
        np.pad(build_checkpoint(N_ROOTS, seed=0)["gaussian.colors"],
               ((0, model.capacity - model.num_points), (0, 0))),
        device=device))
    model.eval()
    out = []
    for c in cams:
        img = model.render_fused(c, np.zeros(3, np.float32))["render"]
        out.append((torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy())
    return out


def _state(model):
    sd = model.state_dict()
    return {k: np.array(v) for k, v in sd.items()}


def _rank(rank, world, device):
    from log_tpu_torch.model.train_step import fused_prepare_render
    from log_tpu_torch.ops import kernels
    from log_tpu_torch.parallel.comm import Comm
    from log_tpu_torch.parallel.executor import ShardedExecutor
    from log_tpu_torch.parallel.sharded_render import (ShardedRenderConfig,
                                                       interleave_shard_rows,
                                                       sharded_render_frame)
    from log_tpu_torch.render.renderer import camera_device

    cams = _cameras()
    ref, ckpt = _model(device)
    gts = _gt(ckpt, cams, device)
    bg = np.zeros(3, np.float32)
    ref_counts = []
    for s in range(STEPS):
        vf = ref.prepare_from_camera(cams[s % 4])
        ref_counts.append(list(vf["counts"]))
        ref.train_step(cams[s % 4], gts[s % 4], bg, view_index=s % 4)
    want = _state(ref)

    model, _ = _model(device)
    ex = ShardedExecutor(model, backend="tiled", comm=Comm())
    counts = []
    kernels.reset_launches()
    for s in range(STEPS):
        _, c = ex.step([cams[s % 4]], [gts[s % 4]], view_indices=[s % 4],
                       backgrounds=[bg])
        counts.append(c[0].tolist())
    step_launches = dict(kernels.LAUNCHES)
    ex.sync_to_model()
    got = _state(model)

    frames = {}
    model.eval()
    params, tree = model.gaussian.params(), model.tree_device()
    p_s, t_s = interleave_shard_rows(params, 1), interleave_shard_rows(tree, 1)
    for sh in (0, 1):
        diffs = []
        kernels.reset_launches()
        for c in cams:
            cam = camera_device(c, device)
            r_img, _, r_counts, r_pairs = fused_prepare_render(
                params, tree, cam, model.num_points, model._leaf_opt_dev,
                3.0, model.current_depth, torch.zeros(3, device=device), H,
                W, k_visible=model.capacity, sh_degree=sh,
                stage_has_tree=True, num_levels=3, backend="tiled",
                max_pairs=1 << 20, cut_method="flat_slice",
                n_roots=model.n_roots_bucket, prep_backend="tiled",
                check_cull=False, pack_pairs=False)
            cfg = ShardedRenderConfig(
                image_height=H, image_width=W, n_devices=1,
                k_local=model.capacity, max_pairs_local=1 << 20,
                bucket_pairs=1 << 20, sh_degree=sh, min_res_pixel=3.0,
                layout="strided")
            img, _, stats = sharded_render_frame(
                p_s, t_s, cam, model.num_points, 3.0, model.current_depth,
                torch.zeros(3, device=device), cfg, Comm())
            d = (img - r_img).abs()
            diffs.append((float(d.max()), float((d > 2e-3).float().mean()),
                          int(stats[2]), int(stats[0]),
                          int(r_counts[:2].sum())))
        frames[sh] = {"diffs": diffs, "launches": dict(kernels.LAUNCHES)}
    return {"want": want, "got": got, "counts": counts,
            "ref_counts": ref_counts, "step_launches": step_launches,
            "frames": frames}


@pytest.fixture(scope="module")
def ran():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return spawn(_rank, 1, "cuda", timeout_s=600)[0]


def test_one_rank_nccl_step_matches_single_card(cuda, ran):
    want, got = ran["want"], ran["got"]
    n = want["gaussian.xyz"].shape[0]
    assert ran["counts"] == ran["ref_counts"]
    for key, a in want.items():
        b = got[key]
        kind, name = key.split(".", 1)[0], key.rsplit(".", 1)[-1]
        if kind == "gaussian" and name == "rotation":
            a = a / np.linalg.norm(a, axis=-1, keepdims=True)
            b = b / np.linalg.norm(b, axis=-1, keepdims=True)
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=2e-4, err_msg=key)
        elif kind == "gaussian":
            np.testing.assert_allclose(b, a, rtol=2e-4, atol=2e-5, err_msg=key)
        elif key.startswith("optimizer.exp_avg") and name != "rotation":
            np.testing.assert_allclose(b, a, rtol=2e-3, atol=1e-7, err_msg=key)
        elif name in ("visible_count", "create_steps", "area_sum"):
            np.testing.assert_array_equal(b, a, err_msg=key)
        elif name in ("weights_max", "weights_sum", "grad_sum"):
            np.testing.assert_allclose(b, a, rtol=2e-3, atol=1e-5, err_msg=key)
    assert n > 0
    ran_ = ran["step_launches"]
    assert ran_["rasterize_bwd"] == STEPS
    assert min(ran_[k] for k in ("rasterize_fwd", "expand_with_keys",
                                 "pack_rows")) >= 2 * STEPS


@pytest.mark.parametrize("sh", [0, 1])
def test_one_rank_sharded_frame_matches_single_card(cuda, ran, sh):
    for d_max, share, overflow, cut, want_cut in ran["frames"][sh]["diffs"]:
        assert overflow == 0 and cut == want_cut
        assert d_max < 2e-2 and share < 1e-3
    launches = ran["frames"][sh]["launches"]
    assert launches["rasterize_fwd"] >= 4 and launches["pack_rows"] >= 4
