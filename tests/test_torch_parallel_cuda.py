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

Where the machine has 2 (and 4) cards, a group of that many NCCL ranks:
- every Comm collective (all_gather tiled and stacked, all_to_all, psum,
  pmax, broadcast, psum_scatter and its backward) on the dtypes the step
  and the render send (f32, int32, int64, bool as uint8), against the
  same collective on n gloo ranks on the CPU on the same inputs:
  integer-valued inputs, so that every sum is exact in any order and the
  two must agree bit for bit;
- STEPS steps of one camera a rank against one rank of n cameras on the
  same batches (a one-rank NCCL group), at chip_smoke.py's
  MULTI_RANK_TOL: params, unit quaternions, moments, losses; visible_count,
  area_sum and the kept counts exact;
- a depth densify (the device path) of the gathered state on every rank,
  after which the executor's refresh finds the ranks' models bit-equal;
- with 2 cards, a kernel handed a tensor on cuda:1 while cuda:0 is
  current raises, naming both.
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
# config/synthetic's densify settings, splits allowed at once
DENSIFY = {"upgrade_sh_iter": 10, "densify_from_iter": 1,
           "densify_every_iter": 1, "upgrade_repeat": 2,
           "init_split_method": "split_by_2d", "init_radius_min": 4,
           "init_radius_split": 16, "init_weight_min": 0.1, "min_steps": 50,
           "method": "naive", "split_grad_thres": 0.0002,
           "radius2d_thres": 6, "remove_weights_thres": 0.005,
           "max_split_points": 20000, "sort_method": "radii",
           "min_steps_split": 0, "scaling_decay": 0.9,
           "device_densify": "on"}
# n ranks x 1 camera against 1 rank x n: chip_smoke.py's MULTI_RANK_TOL
TOL = {"params": (1e-4, 1e-6), "rotation": (1e-3, 2e-4),
       "moments": (1e-4, 1e-7), "loss": 1e-5}


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
                densify_and_remove=DENSIFY, device=device)
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


# ------------------------------------------------------ 2 and 4 NCCL ranks
def _values(rng, shape, dtype, device):
    """Integer-valued inputs of a dtype (sums exact in any order)."""
    if dtype == torch.bool:
        a = rng.integers(0, 2, shape).astype(bool)
    elif dtype == torch.float32:
        a = rng.integers(-4096, 4096, shape).astype(np.float32) * 0.25
    else:
        a = rng.integers(-(1 << 20), 1 << 20, shape).astype(
            np.int32 if dtype == torch.int32 else np.int64)
    return torch.as_tensor(a, device=device)


def _collectives(comm, device, rank, world):
    """Every collective of Comm on this rank's inputs (seeded by rank);
    the results in host numpy."""
    rng = np.random.default_rng(100 + rank)
    out = {}
    for name, dt in (("f32", torch.float32), ("i32", torch.int32),
                     ("i64", torch.int64), ("bool", torch.bool)):
        x = _values(rng, (world * 3, 5), dt, device)
        out[f"all_gather_{name}"] = comm.all_gather(x)
        out[f"all_gather_stacked_{name}"] = comm.all_gather(x, tiled=False)
        out[f"all_to_all_{name}"] = comm.all_to_all(
            _values(rng, (world * 2, 3 * world), dt, device), 0, 1)
        out[f"broadcast_{name}"] = comm.broadcast(x, src=world - 1)
        if dt != torch.bool:
            out[f"psum_{name}"] = comm.psum(x)
            out[f"pmax_{name}"] = comm.pmax(x)
    x = _values(rng, (world * 2, 3, 4), torch.float32, device)
    x.requires_grad_(True)
    y = comm.psum_scatter(x)
    y.backward(_values(rng, tuple(y.shape), torch.float32, device))
    out["psum_scatter_f32"] = y.detach()
    out["psum_scatter_grad_f32"] = x.grad
    return {k: v.cpu().numpy() for k, v in out.items()}


def _steps(ex, cams, gts, steps):
    """`steps` executor steps over the cameras, batch after batch."""
    B, losses, counts = ex.batch, [], []
    bg = np.zeros(3, np.float32)
    for s in range(steps):
        sel = [(s * B + j) % len(cams) for j in range(B)]
        met, c = ex.step([cams[i] for i in sel], [gts[i] for i in sel],
                         view_indices=sel, backgrounds=[bg] * B)
        losses.append(float(met["loss"]))
        counts.append(c.tolist())
    return losses, counts


def _collective_rank(rank, world, device):
    from log_tpu_torch.parallel.comm import Comm

    return _collectives(Comm(), device, rank, world)


def _one_rank_of(rank, world, device, n):
    """One rank of n cameras a step: the reference of the n-rank step."""
    from log_tpu_torch.parallel.comm import Comm
    from log_tpu_torch.parallel.executor import ShardedExecutor

    cams = _cameras()
    model, ckpt = _model(device)
    gts = _gt(ckpt, cams, device)
    ex = ShardedExecutor(model, cams_per_device=n, backend="tiled",
                         comm=Comm())
    losses, counts = _steps(ex, cams, gts, STEPS)
    ex.sync_to_model()
    return {"losses": losses, "counts": counts, "state": _state(model)}


def _multi_rank(rank, world, device):
    """STEPS steps of one camera a rank, then a depth densify of the
    gathered state on every rank and the executor's refresh."""
    from log_tpu_torch.parallel.comm import Comm
    from log_tpu_torch.parallel.executor import ShardedExecutor, _checksum

    cams = _cameras()
    model, ckpt = _model(device)
    gts = _gt(ckpt, cams, device)
    ex = ShardedExecutor(model, backend="tiled", comm=Comm())
    out = {"rank": rank}
    out["losses"], out["counts"] = _steps(ex, cams, gts, STEPS)
    ex.sync_to_model()
    out["state"] = _state(model) if rank == 0 else None
    n = model.num_points
    cnt = {k: np.array(v) for k, v in model.counter.to_numpy(n).items()}
    leaves = np.flatnonzero((model.tree.node_index == -1)
                            & (model.tree.depth > 0))[:64]
    cnt["create_steps"][:] = 1000
    cnt["grad_sum"][leaves] = 100.0
    cnt["area_sum"][:] = np.maximum(cnt["area_sum"], 1)
    cnt["radii_max_max"][leaves] = 10_000
    model.counter.set_numpy(cnt, model.capacity)
    model.set_state(current_depth=20)
    model.update_depth_stage(STEPS)
    try:
        ex.refresh_from_model()
        out["agree"] = None
    except RuntimeError as e:
        out["agree"] = str(e)
    out["densify"] = (n, model.num_points)
    out["fingerprint"] = {k: _checksum(np.asarray(v))
                          for k, v in model.state_dict().items()}
    return out


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def multi(request):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, cards = request.param, torch.cuda.device_count()
    if cards < n:
        pytest.skip(f"needs {n} cards, found {cards}")
    return {"nccl": spawn(_collective_rank, n, "cuda", timeout_s=120),
            "gloo": spawn(_collective_rank, n, "cpu", timeout_s=120),
            "ranks": spawn(_multi_rank, n, "cuda", timeout_s=300),
            "one": spawn(_one_rank_of, 1, "cuda", args=(n,),
                         timeout_s=300)[0]}


def test_collectives_match_gloo(cuda, multi):
    for nccl, gloo in zip(multi["nccl"], multi["gloo"]):
        assert nccl.keys() == gloo.keys()
        for key, want in gloo.items():
            got = nccl[key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_n_ranks_step_matches_one_rank(cuda, multi):
    r0, one = multi["ranks"][0], multi["one"]
    np.testing.assert_allclose(r0["losses"], one["losses"], rtol=TOL["loss"])
    assert r0["counts"] == one["counts"]
    want, got = one["state"], r0["state"]
    for key, a in want.items():
        b = got[key]
        kind, name = key.split(".", 1)[0], key.rsplit(".", 1)[-1]
        if kind == "gaussian" and name == "rotation":
            a = a / np.linalg.norm(a, axis=-1, keepdims=True)
            b = b / np.linalg.norm(b, axis=-1, keepdims=True)
            np.testing.assert_allclose(b, a, *TOL["rotation"], err_msg=key)
        elif kind == "gaussian":
            np.testing.assert_allclose(b, a, *TOL["params"], err_msg=key)
        elif key.startswith("optimizer.exp_avg") and name != "rotation":
            np.testing.assert_allclose(b, a, *TOL["moments"], err_msg=key)
        elif name in ("visible_count", "area_sum"):
            np.testing.assert_array_equal(b, a, err_msg=key)
    for r in multi["ranks"][1:]:
        assert r["losses"] == r0["losses"]


def test_ranks_agree_after_densify(cuda, multi):
    ranks = multi["ranks"]
    n_before, n_after = ranks[0]["densify"]
    assert n_after != n_before
    for r in ranks:
        assert r["agree"] is None, r["agree"]
        assert r["densify"] == ranks[0]["densify"]
        assert r["fingerprint"] == ranks[0]["fingerprint"]


def test_kernel_on_another_card_raises(cuda):
    from log_tpu_torch.ops import rasterize_tiled as rt

    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two cards, found {torch.cuda.device_count()}")
    rows = [torch.ones(64, device="cuda:1")]
    with torch.cuda.device(0):
        with pytest.raises(ValueError, match=r"cuda:1.*cuda:0"):
            rt.pack_rows(rows)
    with torch.cuda.device(1):
        out = rt.pack_rows(rows)
    assert out.device == torch.device("cuda", 1)
    assert torch.equal(out[0, :64].cpu(), torch.ones(64))
