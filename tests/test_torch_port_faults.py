"""Behaviours where the port follows the JAX package: the backend override
is read first (also on a CUDA device), the oracle recomputes each chunk in
its backward instead of keeping its (chunk, H*W) intermediates, the
trainer's GT device cache starts off, its draws follow the JAX package's,
the oracle step's counters hold values (F1-F5); `vis` renders a model
without `render_fused` in two phases (F6), `render_one` sizes the pair
budget from the capacity where the prepare pass left no counts (F7), and
renders a frame whose pair demand exceeds that budget again at its demand
instead of dropping pairs (F8; the JAX package drops them), also past the
2^23 rail (F9; the flat_slice frame takes K3 at a budget past the packed
route's 2^24, the block frame raises there); K2 gives no gradient through
a final transmittance that went denormal (F10)."""
import math
import os

import numpy as np
import pytest
import torch

import log_tpu.ops as ops_jax
import log_tpu_torch.ops as ops
from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.ops import rasterize_ref
from log_tpu_torch.utils.trainer import Trainer

SIZES = (None, 100, 16384, 16385, 10 ** 6)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors and many ops: one intra-op thread (parallel test
    workers would oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ----------------------------------------------------- the backend override
def test_backend_override_is_read_on_cuda(monkeypatch):
    """A torch.device("cuda") needs no GPU."""
    monkeypatch.setenv("LOG_TPU_BACKEND", "reference")
    for n in SIZES:
        assert ops.pick_backend(n, device=torch.device("cuda")) == "reference"
        assert ops.pick_backend(n, device="cuda") == "reference"
    monkeypatch.delenv("LOG_TPU_BACKEND")
    for n in SIZES:
        assert ops.pick_backend(n, device="cuda") == "tiled"


@pytest.mark.parametrize("env", [None, "reference", "tiled"])
def test_backend_matches_jax_on_cpu(monkeypatch, env):
    if env is None:
        monkeypatch.delenv("LOG_TPU_BACKEND", raising=False)
    else:
        monkeypatch.setenv("LOG_TPU_BACKEND", env)
    for n in SIZES:
        assert ops.pick_backend(n, device="cpu") == ops_jax.pick_backend(n), n


def test_backend_needs_a_device(monkeypatch):
    """No CPU default: a call that does not say where it runs raises, and a
    CUDA device takes the tiled path at every size (the oracle never runs
    on the card unless LOG_TPU_BACKEND asks for it)."""
    monkeypatch.delenv("LOG_TPU_BACKEND", raising=False)
    with pytest.raises(TypeError):
        ops.pick_backend(100)
    with pytest.raises(TypeError):
        ops.pick_backend(100, "cuda")
    for n in SIZES:
        assert ops.pick_backend(n, device=torch.device("cuda", 0)) == "tiled"


# ------------------------------------------------ the oracle's chunk remat
H, W, P, CHUNK = 24, 40, 96, 32


def _inputs():
    rng = np.random.default_rng(3)
    f = lambda a: torch.tensor(a, dtype=torch.float32, requires_grad=True)
    q = rng.normal(size=(P, 4))
    xyz = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1, 1, P),
                    rng.uniform(-1, 1, P)], axis=1)
    pos = np.array([0.0, -8.0, 0.0])
    R = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
    fx = 30.0
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]])
    pc = prepare_camera({"K": K, "R": R, "T": (-R @ pos).reshape(3, 1),
                         "H": H, "W": W, "center": pos.reshape(3, 1)},
                        1, 0.01, 100.0)
    tx, ty = math.tan(pc["FoVx"] * 0.5), math.tan(pc["FoVy"] * 0.5)
    world_view = pc["world_view_transform"]
    full_proj = pc["full_proj_transform"]
    leaves = dict(xyz=f(xyz), colors=f(rng.uniform(0, 1, (P, 3))),
                  opacity=f(rng.uniform(0.3, 0.9, P)),
                  scaling=f(rng.uniform(0.1, 0.3, (P, 3))),
                  rotation=f(q / np.linalg.norm(q, axis=1, keepdims=True)))
    cam = dict(means2d_offset=torch.zeros(P, 2),
               world_view=torch.from_numpy(world_view),
               full_proj=torch.from_numpy(full_proj), focal_x=W / (2 * tx),
               focal_y=H / (2 * ty),
               tan_fovx=tx, tan_fovy=ty, background=torch.zeros(3),
               image_height=H, image_width=W, chunk=CHUNK)
    return leaves, cam


def _saved_bytes_and_grads():
    leaves, cam = _inputs()
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = rasterize_ref.rasterize(**leaves, **cam)
    loss = (out["render"] * torch.linspace(0, 1, H * W).reshape(H, W)).sum() \
        + out["alpha"].sum()
    loss.backward()
    return sum(saved), {k: v.grad for k, v in leaves.items()}


def test_oracle_recomputes_chunks_in_backward(monkeypatch):
    """The saved tensors stay below one (chunk, H*W) buffer per chunk with
    the recompute, and the gradients equal those without it."""
    remat_bytes, remat_grads = _saved_bytes_and_grads()
    monkeypatch.setattr(rasterize_ref, "checkpoint",
                        lambda fn, *args, **kwargs: fn(*args))
    plain_bytes, plain_grads = _saved_bytes_and_grads()
    n_chunks = math.ceil(P / CHUNK)
    one_buffer = CHUNK * H * W * 4
    assert remat_bytes < n_chunks * one_buffer, remat_bytes
    assert plain_bytes > 4 * n_chunks * one_buffer, plain_bytes
    for key, g in plain_grads.items():
        assert float(g.abs().max()) > 0, key
        assert torch.equal(remat_grads[key], g), key


# ---------------------------------------------------------- the GT cache
class _Model:
    device = torch.device("cpu")


def test_trainer_gt_cache_starts_off():
    trainer = Trainer({}, _Model(), None)
    gt = np.zeros((3, 4, 5), np.uint8)
    assert not trainer._gt_cache_ok
    a = trainer._gt_to_device(0, gt)
    assert trainer._gt_dev_cache == {} and trainer._gt_cache_bytes == 0
    assert a is not trainer._gt_to_device(0, gt)
    trainer.set_gt_cache(True)
    b = trainer._gt_to_device(0, gt)
    assert b is trainer._gt_to_device(0, gt)
    assert trainer._gt_cache_bytes == gt.nbytes
    trainer.set_gt_cache(False)
    assert trainer._gt_dev_cache == {} and trainer._gt_cache_bytes == 0


# -------------------------------------------- F4: the trainer's host draws
def _draws(trainer, renderer, n=50):
    """What fit and training_step draw, in their order: a loader's sampler
    order (its seed drawn from the trainer), then per step the random
    background and the random LoD pixel threshold."""
    out = []
    dataset = list(range(7))
    batch = {"camera": {k: np.zeros((1, 3)) for k in (
        "camera_center", "world_view_transform", "full_proj_transform",
        "image_width", "image_height", "FoVx", "FoVy", "K", "R", "T")}}
    loader = trainer.train_loader(dataset, {"batch_size": 1,
                                            "iterations": n}, base_iter=1)
    out.append(list(loader.sampler))
    for _ in range(n):
        _cam, bg = renderer.prepare_camera(batch, 0, None, is_train=True,
                                           rng=trainer.rng)
        out.append(bg.tolist())
        out.append(trainer._rand_radius_jitter())
    return out


def test_trainer_draws_match_jax(tmp_path):
    """One seed gives the JAX package's sampler indices, backgrounds and
    LoD thresholds, 50 draws each (one numpy Generator, seeded 666)."""
    from log_tpu.render.renderer import NaiveRendererAndLoss as RendererJax
    from log_tpu.utils.config import CfgNode
    from log_tpu.utils.trainer import Trainer as TrainerJax
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss

    jax_trainer = TrainerJax(CfgNode({"exp": str(tmp_path / "jax")}), None,
                             None, logdir=str(tmp_path / "jax"))
    want = _draws(jax_trainer, RendererJax(use_randback=True))
    os.close(jax_trainer._exp_lock_fd)
    renderer = NaiveRendererAndLoss(use_randback=True, device="cpu")
    got = _draws(Trainer({}, _Model(), renderer), renderer)
    assert got == want
    assert len(set(map(str, got[1::2]))) == 50  # the draws move


# ------------------------- F5: the oracle step's stats stay out of autograd
def test_oracle_step_counters_hold_values(monkeypatch):
    """On the reference backend (the CPU's default up to 16,384 points)
    the step's radii and per-gaussian weights come out of differentiable
    ops; the counters keep their values, not the render's graph, so a
    checkpoint can be written after the step."""
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.config import load_object
    from log_tpu_torch.utils.synth_tree import build_checkpoint

    monkeypatch.setenv("LOG_TPU_BACKEND", "reference")
    keys = ["xyz", "colors", "scaling", "opacity", "rotation", "shs"]
    args = {"gaussian": {"xyz_scale": 1.0, "sh_degree": 1},
            "optimizer": {"optimize_keys": keys, "opt_all_levels": True,
                          "lr_dict": {"xyz": 1.6e-4, "colors": 2.5e-3,
                                      "shs": 1.25e-4, "scaling": 5e-3,
                                      "opacity": 0.05, "rotation": 1e-3,
                                      "max_steps": 600}},
            "tree": {"max_child": 4}, "densify_and_remove": {}}
    model = load_object("LoG.model.level_of_gaussian.LoG", args, device="cpu")
    model.load_state_dict(build_checkpoint(200, seed=3))
    model.training_setup()
    pos = np.array([0.0, -22.0, 18.0])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    h, w = 24, 40
    pc = prepare_camera({"K": np.array([[30.0, 0, w / 2], [0, 30.0, h / 2],
                                        [0, 0, 1]]),
                         "R": R, "T": (-R @ pos).reshape(3, 1), "H": h,
                         "W": w, "center": pos.reshape(3, 1)}, 1, 0.01, 1000.0)
    keys = ("camera_center", "world_view_transform", "full_proj_transform",
            "image_width", "image_height", "FoVx", "FoVy", "K", "R", "T")
    batch = {"camera": {k: np.asarray(pc[k])[None] for k in keys},
             "image": np.random.default_rng(0).uniform(size=(1, h, w, 3)),
             "index": np.asarray([0])}
    renderer = NaiveRendererAndLoss(device="cpu")
    Trainer({}, model, renderer).training_step(model, batch)
    assert not any(v.requires_grad for v in model.counter.data.values())
    assert float(model.counter.data["weights_max"].max()) > 0
    assert model.state_dict()["counter.weights_max"].shape == (model.num_points,)


# ------------------------------------- F6, F7: a model without a fused frame
class _FrustumModel:
    """The renderer's view of a model with no render_fused whose prepare
    pass keeps every alive row and leaves no counts (as BaseGaussian's
    frustum flag does)."""

    training = False

    def __init__(self, n=600, scale=0.05, counts=False):
        from log_tpu_torch.model.gaussian import GaussianPoint

        rng = np.random.default_rng(5)
        g = GaussianPoint(sh_degree=0, device="cpu")
        g.register_by_pointcloud(
            rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32),
            np.full(n, scale, np.float32), init_opacity=0.6)
        self.gaussian, self.device, self.capacity = g, g.device, g.capacity
        self.visibility_flag, self.counts = None, counts

    def prepare_from_camera(self, camera):
        alive = torch.arange(self.capacity) < self.gaussian.num_points
        self.visibility_flag = {"keep_mask": alive}
        if self.counts:  # as LoG's prepare pass: (leaf, node) kept
            self.visibility_flag["counts"] = (self.gaussian.num_points, 0)


def _frustum_camera(h=48, w=64, focal=60.0):
    pos = np.array([0.0, -4.0, 1.0])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    return prepare_camera({"K": np.array([[focal, 0, w / 2],
                                          [0, focal, h / 2], [0, 0, 1]]),
                           "R": R, "T": (-R @ pos).reshape(3, 1), "H": h,
                           "W": w, "center": pos.reshape(3, 1)},
                          1, 0.01, 100.0)


def test_vis_renders_a_model_without_render_fused():
    """F6: the JAX package's vis takes the fused frame only where the model
    has one; in eval mode the port called model.render_fused on every
    model."""
    from log_tpu_torch.render.renderer import CAMERA_KEYS, NaiveRendererAndLoss

    model = _FrustumModel()
    cam = _frustum_camera()
    renderer = NaiveRendererAndLoss(split="demo", device="cpu")
    batch = {"camera": {k: np.asarray(cam[k])[None] for k in CAMERA_KEYS}}
    out = renderer.vis(batch, model)
    assert out["render"].shape == (1, 3, 48, 64)
    one = renderer.render_one(model, cam, renderer.background)["render"]
    one8 = (torch.clamp(one, 0, 1) * 255).to(torch.uint8).numpy() / 255.0
    assert np.array_equal(out["render"][0], one8.astype(np.float32))
    assert out["alpha"].max() > 0.5


def test_render_one_budget_without_counts(monkeypatch):
    """F7: without counts in the visibility flag the JAX package sizes the
    pair budget from the capacity; the port read flag["counts"] and
    raised. The tiled frame (plain kernels on the CPU) then agrees with
    the oracle at tests/test_rasterize_tiled.py's 1e-2."""
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss

    model = _FrustumModel()
    cam = _frustum_camera()
    renderer = NaiveRendererAndLoss(split="demo", device="cpu")
    model.prepare_from_camera(cam)
    assert "counts" not in model.visibility_flag
    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    tiled = renderer.render_one(model, cam, renderer.background)
    assert tiled["max_pairs"] == ops.pick_max_pairs(model.capacity)
    assert int(tiled["pair_total"]) <= tiled["max_pairs"]
    monkeypatch.setenv("LOG_TPU_BACKEND", "reference")
    ref = renderer.render_one(model, cam, renderer.background)
    assert "max_pairs" not in ref
    for key in ("render", "alpha"):
        np.testing.assert_allclose(tiled[key].numpy(), ref[key].numpy(),
                                   atol=1e-2)


def test_render_one_renders_the_demand_past_the_budget(monkeypatch):
    """F8: the budget of eight tiles a kept point is short where splats
    cover more (a close camera, large splats): the JAX package then drops
    the pairs past it and renders a wrong frame. The port renders the frame
    again at its measured demand: the same frame as with counts whose
    budget holds every pair."""
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss

    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    model = _FrustumModel(n=3000, scale=0.5, counts=True)
    cam = _frustum_camera(h=128, w=256, focal=300.0)
    renderer = NaiveRendererAndLoss(split="demo", device="cpu")
    model.prepare_from_camera(cam)
    tiled = renderer.render_one(model, cam, renderer.background)
    model.visibility_flag["counts"] = (40_000, 0)  # 8 x 40,000 pairs
    roomy = renderer.render_one(model, cam, renderer.background)
    for key in ("render", "alpha"):
        np.testing.assert_allclose(tiled[key].numpy(), roomy[key].numpy(),
                                   rtol=0, atol=1e-6)
    assert int(roomy["pair_total"]) <= roomy["max_pairs"]
    demand = int(tiled["pair_total"])
    assert demand > ops.pick_max_pairs(model.gaussian.num_points)
    assert tiled["max_pairs"] == ops.pick_max_pairs(demand, per_point=1)


def test_render_one_keeps_the_pairs_past_the_rail(monkeypatch):
    """F9: F8's second binning sized its budget with pick_max_pairs, whose
    rail (2^23) then dropped the pairs past it without a word. With the
    rail lowered to 2^16 in the port, a frame that needs more must keep
    them all (budget_for_demand) and equal the same frame rendered at a
    budget that holds every pair."""
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss

    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    model = _FrustumModel(n=3000, scale=0.5, counts=True)
    cam = _frustum_camera(h=128, w=256, focal=300.0)
    renderer = NaiveRendererAndLoss(split="demo", device="cpu")
    model.prepare_from_camera(cam)
    model.visibility_flag["counts"] = (40_000, 0)  # 8 x 40,000 pairs
    roomy = renderer.render_one(model, cam, renderer.background)
    assert int(roomy["pair_total"]) <= roomy["max_pairs"]
    real = ops.pick_max_pairs

    def railed(k_visible, per_point=8):
        return min(real(k_visible, per_point), 1 << 16)

    monkeypatch.setattr(ops, "pick_max_pairs", railed)
    model.prepare_from_camera(cam)
    out = renderer.render_one(model, cam, renderer.background)
    demand = int(out["pair_total"])
    assert demand > 1 << 16
    assert out["max_pairs"] >= demand
    assert out["max_pairs"] == ops.budget_for_demand(demand)
    for key in ("render", "alpha"):
        np.testing.assert_allclose(out[key].numpy(), roomy[key].numpy(),
                                   rtol=0, atol=1e-6)


def test_render_blocks_refuses_a_budget_past_the_packed_route():
    """F9, the block frame: it is held to the packed route (K4 into K3p),
    whose f32 run rows are exact below 2^24, so a budget there raises
    rather than truncating."""
    from log_tpu_torch.model.block_render import render_blocks
    from log_tpu_torch.ops.rasterize_tiled import PACKED_ID_LIMIT

    assert PACKED_ID_LIMIT == 1 << 24
    with pytest.raises(ValueError, match="packed route"):
        render_blocks(None, None, None, 3.0, 20, None, 64, 256, k_blocks=1,
                      k_visible=1, max_pairs=PACKED_ID_LIMIT)


def test_flat_slice_past_the_packed_limit_takes_k3(monkeypatch):
    """F9, the flat_slice frame: a budget at the packed route's limit takes
    the unpacked expansion (K3, int32 rows) and renders the same frame as
    the packed route (K4 into K3p) below it. The limit is lowered to the
    test's budget here, so that no 2^24-pair buffer is needed."""
    from log_tpu_torch.model import train_step as ts
    from log_tpu_torch.ops import expand as ex
    from log_tpu_torch.ops import rasterize_tiled as rt
    from log_tpu_torch.scripts import _common as C

    monkeypatch.setenv("LOG_TPU_PACK_SORT_KEYS", "0")
    tree = C.PaddedTree(6000, "cpu")
    n, cap = tree.n, tree.cap
    cam = C.orbit(1, 64, 256, 120.0, "cpu")[0]
    kw = dict(image_height=64, image_width=256, k_visible=rt.PACK_CHUNK,
              sh_degree=0, stage_has_tree=True, num_levels=3,
              backend="tiled", max_pairs=1 << 16, check_scale=4,
              cut_method="flat_slice", n_roots=tree.n_roots,
              prep_backend="tiled", prep_max_pairs=1 << 15, check_cull=False)
    args = (tree.params, tree.tree, cam, n, tree.leaf, 3.0, 20,
            torch.zeros(3))
    calls = []
    real = ex.expand_packed_with_keys

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(ex, "expand_packed_with_keys", counted)
    packed = ts.fused_prepare_render(*args, **kw)
    assert calls and cap == rt.PACK_CHUNK

    def refused(*a, **k):
        raise AssertionError("K3p ran past the packed route's limit")

    monkeypatch.setattr(ex, "expand_packed_with_keys", refused)
    monkeypatch.setattr(rt, "PACKED_ID_LIMIT", kw["max_pairs"])
    whole = ts.fused_prepare_render(*args, **kw)
    assert int(whole[3]) == int(packed[3]) <= kw["max_pairs"]
    for a, b in zip(whole[:3], packed[:3]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert float(whole[0].std()) > 0.01


# ------------------------- F10: K2 through a denormal final transmittance
def test_backward_through_a_denormal_transmittance():
    """F10: where a pixel's running transmittance went denormal (tens of
    nearly opaque layers; 100k points at 1920x1088 reach it on the card),
    K1's product can stick at the smallest denormal, and dividing it back
    up by each (1 - alpha) overflowed: K2 and its plain version gave
    gradients of 1e20 and more, or NaN. Such a pixel now gives its pairs no
    gradient, as one whose transmittance underflowed to 0 (ROADMAP fact
    m)."""
    from log_tpu_torch.ops import rasterize_tiled as rt
    from test_torch_kernels_cuda import denormal_tile

    args = denormal_tile()
    tf = args[4]
    assert float(tf.min()) > 0.0 and float(tf.max()) < 1e-44  # denormal
    grad = rt.rasterize_backward(*args)
    assert torch.isfinite(grad).all()
    assert float(grad.abs().max()) == 0.0
    # above the normal range the recurrence is untouched: few layers give
    # finite, non-zero gradients
    args = denormal_tile(n_opaque=2, n_soft=10)
    assert float(args[4].min()) > torch.finfo(torch.float32).tiny
    grad = rt.rasterize_backward(*args)
    assert torch.isfinite(grad).all() and float(grad.abs().max()) > 0.0
