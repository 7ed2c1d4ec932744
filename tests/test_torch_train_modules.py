"""The training step's modules one by one against log_tpu on the CPU: SSIM,
the counter update, sparse and dense Adam, the LR schedule, the expansion's
VJP, and the trainer's per-step plumbing. Inputs are made with numpy and
handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.model import counter as counter_jax
from log_tpu.model import sparse_optimizer as so_jax
from log_tpu.ops import expand_pallas as ep_jax
from log_tpu.ops import ssim as ssim_jax
from log_tpu_torch.model import counter as counter_port
from log_tpu_torch.model import sparse_optimizer as so_port
from log_tpu_torch.ops import ssim as ssim_port
from log_tpu_torch.ops.expand import ExpandWithKeys


def test_ssim_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(3, 40, 56)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.1, 0, 1).astype(np.float32)
    want_map = np.asarray(ssim_jax.ssim_map(jnp.asarray(a), jnp.asarray(b)))
    got_map = ssim_port.ssim_map(torch.from_numpy(a), torch.from_numpy(b))
    assert got_map.shape == want_map.shape == (3, 30, 46)
    # XLA contracts the blur's multiply-adds into FMAs: f32 rounding
    np.testing.assert_allclose(got_map.numpy(), want_map, atol=1e-5)
    want = float(ssim_jax.ssim_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(ssim_port.ssim_loss(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) < 1e-6


def _counter_inputs(rng, cap, K, identity):
    counter = counter_jax.init_counter(cap)
    counter["weights_max"] = rng.uniform(0, 0.5, cap).astype(np.float32)
    counter["area_sum"] = rng.integers(0, 9, cap).astype(np.int32)
    counter["radii_max_max"] = rng.integers(0, 30, cap).astype(np.int32)
    if identity:
        index = np.arange(cap, dtype=np.int32)
    else:
        index = rng.permutation(cap)[:K].astype(np.int32)
        index[rng.uniform(size=K) < 0.2] = cap  # padding lanes
    radii = np.where(rng.uniform(size=K) < 0.8,
                     rng.integers(1, 40, K), 0).astype(np.int32)
    weight = rng.uniform(size=K).astype(np.float32)
    pid = rng.integers(-1, K, (24, 32)).astype(np.int32)
    grad = rng.normal(size=(K, 2)).astype(np.float32) * 1e-3
    return counter, index, radii, weight, pid, grad


@pytest.mark.parametrize("identity", [True, False])
def test_update_counter_matches_jax(identity):
    rng = np.random.default_rng(1)
    cap = 300
    K = cap if identity else 120
    counter, *rest = _counter_inputs(rng, cap, K, identity)
    want = counter_jax.update_counter(
        {k: jnp.asarray(v) for k, v in counter.items()},
        *(jnp.asarray(a) for a in rest), identity=identity,
    )
    got = counter_port.update_counter(
        {k: torch.from_numpy(v) for k, v in counter.items()},
        *(torch.from_numpy(a) for a in rest), identity=identity,
    )
    assert set(got) == set(counter_port.COUNTER_KEYS)
    for key in counter_port.COUNTER_KEYS:
        w, g = np.asarray(want[key]), got[key].numpy()
        assert g.dtype == w.dtype, key
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=key)


def _adam_inputs(rng, cap, K):
    shapes = {"xyz": (3,), "opacity": (1,), "shs": (3, 3)}
    params = {k: rng.normal(size=(cap,) + s).astype(np.float32)
              for k, s in shapes.items()}
    moments = {m: {k: np.abs(rng.normal(size=(cap,) + s)).astype(np.float32)
                   * (0.1 if m == "exp_avg" else 0.01)
                   for k, s in shapes.items()}
               for m in ("exp_avg", "exp_avg_sq")}
    grads = {k: rng.normal(size=(K,) + s).astype(np.float32)
             for k, s in shapes.items()}
    lrs = {"xyz": 1e-3, "opacity": 0.05, "shs": 2e-4}
    mask = rng.uniform(size=K) < 0.7
    return params, moments, grads, lrs, mask


def _assert_adam_equal(got, want):
    (p_g, m_g), (p_w, m_w) = got, want
    for k in p_w:
        np.testing.assert_allclose(p_g[k].numpy(), np.asarray(p_w[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        for mk in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(m_g[mk][k].numpy(),
                                       np.asarray(m_w[mk][k]), rtol=1e-6,
                                       atol=1e-9, err_msg=f"{mk}.{k}")


@pytest.mark.parametrize("K", [40, 200])  # both JAX branches (K <= cap/16)
def test_sparse_adam_matches_jax(K):
    rng = np.random.default_rng(2)
    cap = 800
    params, moments, grads, lrs, mask = _adam_inputs(rng, cap, K)
    index = rng.permutation(cap)[:K].astype(np.int32)
    index[~mask] = cap
    t, j = torch.from_numpy, jnp.asarray
    want = so_jax.sparse_adam_step(
        {k: j(v) for k, v in params.items()},
        {m: {k: j(v) for k, v in d.items()} for m, d in moments.items()},
        {k: j(v) for k, v in grads.items()}, j(index), j(mask),
        jnp.float32(7), {k: jnp.float32(v) for k, v in lrs.items()},
    )
    pt = {k: t(v.copy()) for k, v in params.items()}
    got = so_port.sparse_adam_step(
        pt, {m: {k: t(v) for k, v in d.items()} for m, d in moments.items()},
        {k: t(v) for k, v in grads.items()}, t(index), t(mask), 7.0, lrs,
    )
    _assert_adam_equal(got, want)
    # the inputs are left as they were (the step is functional)
    for k, v in params.items():
        np.testing.assert_array_equal(pt[k].numpy(), v, err_msg=k)


def test_dense_adam_matches_jax():
    rng = np.random.default_rng(3)
    cap = 256
    params, moments, grads, lrs, mask = _adam_inputs(rng, cap, cap)
    t, j = torch.from_numpy, jnp.asarray
    want = so_jax.dense_adam_step(
        {k: j(v) for k, v in params.items()},
        {m: {k: j(v) for k, v in d.items()} for m, d in moments.items()},
        {k: j(v) for k, v in grads.items()}, j(mask), jnp.float32(3),
        {k: jnp.float32(v) for k, v in lrs.items()},
    )
    pt = {k: t(v.copy()) for k, v in params.items()}
    got = so_port.dense_adam_step(
        pt, {m: {k: t(v) for k, v in d.items()} for m, d in moments.items()},
        {k: t(v) for k, v in grads.items()}, t(mask), 3.0, lrs,
    )
    _assert_adam_equal(got, want)
    for k, v in params.items():
        np.testing.assert_array_equal(pt[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 37, 599, 600, 5000])
def test_expon_lr_matches_jax(step):
    args = (0.00016, 0.0000016)
    want = float(so_jax.expon_lr(step, *args, max_steps=600))
    got = so_port.expon_lr(step, *args, max_steps=600)
    # both in float32; XLA's exp and fused multiply-add may round 1 ulp apart
    assert got == pytest.approx(want, rel=1e-6, abs=0)


def test_expand_vjp_matches_jax():
    """The segment sum of each run's columns (float64 cumsum here, the JAX
    package's f32 cumsum there: equal to f32 rounding at this size)."""
    rng = np.random.default_rng(4)
    P, A, tiles_x, num_tiles = 200, 2048, 4, 64
    counts = np.where(rng.uniform(size=P) < 0.85, rng.integers(1, 20, P), 0)
    csum = np.cumsum(counts)
    offs = np.minimum(csum - counts, A).astype(np.int32)
    total = int(min(csum[-1], A))
    geo = (rng.integers(0, 4, P) + 32 * (rng.integers(0, 8, P)
                                         + 512 * 1)).astype(np.int32)
    vals = rng.normal(size=(10, P)).astype(np.float32)
    g = rng.normal(size=(10, A)).astype(np.float32)
    vals13 = np.concatenate([vals, offs[None].astype(np.float32),
                             geo[None].astype(np.float32),
                             np.arange(P, dtype=np.float32)[None]])

    def f(v):
        rows, _, _ = ep_jax.expand_pallas_with_keys(
            v, jnp.asarray(offs), jnp.asarray(total), A, tiles_x, num_tiles,
            interpret=True)
        return rows[:10]

    _, vjp = jax.vjp(f, jnp.asarray(vals13))
    want = np.asarray(vjp(jnp.asarray(g))[0])[:10]
    v = torch.from_numpy(vals).requires_grad_(True)
    ints = torch.from_numpy(np.stack([offs, geo, np.arange(P, dtype=np.int32)]))
    out = ExpandWithKeys.apply(v, ints, torch.tensor(total, dtype=torch.int32),
                               A, tiles_x, num_tiles)
    out[0].backward(torch.from_numpy(g))
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-5, atol=1e-5)
    assert out[1].requires_grad is False and out[2].requires_grad is False


def _tiny_trainer(seed, monkeypatch):
    from log_tpu_torch.dataset.base import prepare_camera
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.config import load_object
    from log_tpu_torch.utils.synth_tree import build_checkpoint
    from log_tpu_torch.utils.trainer import Trainer

    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    keys = ["xyz", "colors", "scaling", "opacity", "rotation", "shs"]
    args = {
        "gaussian": {"xyz_scale": 1.0, "sh_degree": 1},
        "optimizer": {"optimize_keys": keys, "opt_all_levels": True,
                      "lr_dict": {"xyz": 1.6e-4, "colors": 2.5e-3,
                                  "shs": 1.25e-4, "scaling": 5e-3,
                                  "opacity": 0.05, "rotation": 1e-3,
                                  "max_steps": 600}},
        "tree": {"max_child": 4}, "densify_and_remove": {},
    }
    model = load_object("LoG.model.level_of_gaussian.LoG", args, device="cpu")
    model.load_state_dict(build_checkpoint(200, seed=3))
    model.training_setup()
    renderer = NaiveRendererAndLoss(use_randback=True, use_rand_radius=True,
                                    device="cpu")
    h, w = 32, 256
    pos = np.array([0.0, -22.0, 18.0])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    pc = prepare_camera({"K": np.array([[60.0, 0, w / 2], [0, 60.0, h / 2],
                                        [0, 0, 1]]),
                         "R": R, "T": (-R @ pos).reshape(3, 1), "H": h,
                         "W": w, "center": pos.reshape(3, 1)}, 1, 0.01, 1000.0)
    cam_keys = ("camera_center", "world_view_transform",
                "full_proj_transform", "image_width", "image_height", "FoVx",
                "FoVy", "K", "R", "T")
    batch = {"camera": {k: np.asarray(pc[k])[None] for k in cam_keys},
             "image": np.random.default_rng(0).uniform(size=(1, h, w, 3)),
             "index": np.asarray([0])}
    return model, Trainer({}, model, renderer, seed=seed), batch


def test_trainer_training_step(monkeypatch):
    """Backgrounds and LoD thresholds come from the trainer's generator (the
    same seed gives the same steps); with the GT cache on (full frames) the
    GT is uploaded once per view; the model's LoD threshold is restored
    after each step."""
    losses = {}
    for run, seed in (("a", 7), ("b", 7), ("c", 8)):
        model, trainer, batch = _tiny_trainer(seed, monkeypatch)
        trainer.set_gt_cache(True)
        before = model.tree.min_resolution_pixel
        out = []
        for _ in range(2):
            ok, output, loss = trainer.training_step(model, batch)
            assert ok
            out.append(float(output["loss_dev"]))
            trainer.global_iterations += 1
        assert model.tree.min_resolution_pixel == before
        assert len(trainer._gt_dev_cache) == 1
        assert output["gt"].shape == (3, 32, 256)
        assert model.optimizer.global_steps == 2
        losses[run] = out
    assert losses["a"] == losses["b"]
    assert losses["a"] != losses["c"]
