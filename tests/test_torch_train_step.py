"""The port's training step against log_tpu's on the CPU.

Both packages render through the tiled backend (LOG_TPU_BACKEND=tiled: the
JAX kernels in interpret mode, the port's plain versions), with the exact
(tile, depth, gid) pair sort (LOG_TPU_PACK_SORT_KEYS=0). Inputs are made
with numpy and handed to both.

Limits: loss, l1 and ssim to 1e-5; the first moments (0.1 g after one step
from zero) to 1e-3 of each key's largest; parameters to 1e-6 where the
gradient is above 1e-4 of its key's largest (Adam with eps 1e-15 moves such
a row by lr * sign(g), so a row of a near-zero gradient may move either
way); integer counters equal, float counters to 1e-4 relative.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.model.counter import init_counter as init_counter_jax
from log_tpu.model.level_of_gaussian import LoG as LoGJax
from log_tpu.model.train_step import StepConfig as StepConfigJax
from log_tpu.model.train_step import fused_train_step as step_jax
from log_tpu.render.renderer import camera_device as camera_device_jax
from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.model.counter import COUNTER_KEYS, init_counter
from log_tpu_torch.model.train_step import StepConfig, fused_train_step
from log_tpu_torch.render.renderer import camera_device
from log_tpu_torch.utils.config import load_object
from log_tpu_torch.utils.synth_tree import build_checkpoint

KEYS = ("xyz", "colors", "scaling", "opacity", "rotation", "shs")
INT_COUNTERS = ("radii_max", "visible_count", "radii_max_max", "area_sum",
                "create_steps")


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    monkeypatch.setenv("LOG_TPU_PACK_SORT_KEYS", "0")
    monkeypatch.delenv("LOG_TPU_TILESTART", raising=False)
    monkeypatch.delenv("LOG_TPU_COMPACT", raising=False)
    monkeypatch.delenv("LOG_TPU_IDENTITY_STEP", raising=False)


def _camera(h, w, pos, focal):
    pos = np.asarray(pos, np.float64)
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, np.array([0, 0, 1.0]))
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    return prepare_camera({"K": K, "R": R, "T": (-R @ pos).reshape(3, 1),
                           "H": h, "W": w, "center": pos.reshape(3, 1)},
                          1, 0.01, 1000.0)


def assert_moments_close(m_port, m_jax, rows):
    for kind in ("exp_avg", "exp_avg_sq"):
        for k in m_jax[kind]:
            want = np.asarray(m_jax[kind][k])[:rows]
            got = np.asarray(m_port[kind][k])[:rows]
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, atol=1e-3 * scale, rtol=0,
                                       err_msg=f"{kind}.{k}")


def assert_params_close(p_port, p_jax, m_jax, rows):
    for k in p_jax:
        g = np.abs(np.asarray(m_jax["exp_avg"][k])[:rows])
        sel = g > 1e-4 * g.max()
        assert sel.any(), k
        want = np.asarray(p_jax[k])[:rows]
        got = np.asarray(p_port[k])[:rows]
        np.testing.assert_allclose(got[sel], want[sel], atol=1e-6, rtol=0,
                                   err_msg=k)


def assert_counters_close(c_port, c_jax, rows):
    for k in COUNTER_KEYS:
        want = np.asarray(c_jax[k])[:rows]
        got = np.asarray(c_port[k])[:rows]
        if k in INT_COUNTERS:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=k)


# ------------------------------------------- (c) one fused_train_step
H, W = 64, 256
CAP, N = 256, 200


def _scene(cap):
    rng = np.random.default_rng(7)
    ext = 6.0
    xyz = np.stack([rng.uniform(-ext, ext, cap), rng.uniform(-ext, ext, cap),
                    rng.uniform(0.0, 2.0, cap)], axis=1)
    q = rng.normal(size=(cap, 4))
    opac = rng.uniform(0.3, 0.9, (cap, 1))
    params = {
        "xyz": xyz,
        "colors": rng.uniform(-1, 1, (cap, 3)),
        "scaling": np.log(rng.uniform(0.1, 0.5, (cap, 3))),
        "opacity": np.log(opac / (1 - opac)),
        "rotation": q / np.linalg.norm(q, axis=1, keepdims=True),
        "shs": rng.normal(size=(cap, 3, 3)) * 0.01,
    }
    # rows past N are dead padding, zeroed
    return {k: np.where((np.arange(cap) < N).reshape((cap,) + (1,) * (v.ndim - 1)),
                        v, 0.0).astype(np.float32) for k, v in params.items()}


def _pad(params, cap):
    return {k: np.concatenate([v, np.zeros((cap - v.shape[0],) + v.shape[1:],
                                           np.float32)])
            for k, v in params.items()}


def _one_step(params, cap, k_leaf):
    """The same step through both packages; returns (port, jax) tuples of
    (params, moments, counter, metrics)."""
    keep = np.arange(cap) < N
    pc = _camera(H, W, (0.0, -14.0, 8.0), 90.0)
    gt = (np.random.default_rng(3).uniform(size=(3, H, W)) * 255).astype(
        np.uint8)
    lr = 1e-2
    counter = init_counter(cap)
    corr = {"values": np.ones((1, 3), np.float32),
            "m1": np.zeros((1, 3), np.float32),
            "m2": np.zeros((1, 3), np.float32),
            "vmax": np.zeros((1, 3), np.float32),
            "steps": np.zeros((1,), np.int32)}
    kw = dict(image_height=H, image_width=W, k_leaf=k_leaf, k_node=0,
              sh_degree=1, mode="antialias", backend="tiled",
              max_pairs=1 << 13)

    t = torch.from_numpy
    out_p = fused_train_step(
        {k: t(v) for k, v in params.items()},
        {m: {k: torch.zeros_like(t(v)) for k, v in params.items()}
         for m in ("exp_avg", "exp_avg_sq")},
        {k: t(v) for k, v in counter.items()}, t(keep),
        torch.zeros(cap, dtype=torch.bool), camera_device(pc, "cpu"), t(gt),
        torch.zeros(3), {k: lr for k in KEYS}, 1.0,
        {k: t(v) for k, v in corr.items()}, 0, torch.ones((1, 1, 1)), None,
        StepConfig(**kw),
    )
    j = jnp.asarray
    out_j = step_jax(
        {k: j(v) for k, v in params.items()},
        {m: {k: jnp.zeros_like(j(v)) for k, v in params.items()}
         for m in ("exp_avg", "exp_avg_sq")},
        {k: j(v) for k, v in init_counter_jax(cap).items()}, j(keep),
        jnp.zeros((cap,), bool), camera_device_jax(pc), j(gt), jnp.zeros(3),
        {k: jnp.float32(lr) for k in KEYS}, jnp.float32(1),
        {k: j(v) for k, v in corr.items()}, jnp.int32(0), jnp.ones((1, 1, 1)),
        jnp.ones((1, 1)), jax.random.PRNGKey(1), cfg=StepConfigJax(**kw),
    )
    port = (out_p[0], out_p[1], out_p[2], out_p[4])
    ref = (out_j[0], out_j[1], out_j[2], out_j[4])
    return port, ref


@pytest.mark.parametrize("path", ["identity", "compacted"])
def test_fused_train_step_matches_jax(path):
    """identity: k_leaf == capacity (dense masked Adam); compacted: the same
    rows inside twice the capacity (compaction + sparse Adam)."""
    params = _scene(CAP)
    cap = CAP if path == "identity" else 2 * CAP
    port, ref = _one_step(_pad(params, cap), cap, CAP)
    (p_p, m_p, c_p, met_p), (p_j, m_j, c_j, met_j) = port, ref
    for key in ("loss", "l1", "ssim"):
        assert abs(float(met_p[key]) - float(met_j[key])) <= 1e-5, key
    assert int(met_p["num_rendered"]) == int(met_j["num_rendered"]) > 50
    assert_moments_close(m_p, m_j, N)
    assert_params_close(p_p, p_j, m_j, N)
    assert_counters_close(c_p, c_j, N)
    # dead rows are untouched
    for k in params:
        np.testing.assert_array_equal(p_p[k][N:].numpy(), 0.0, err_msg=k)


def test_identity_path_matches_compacted():
    """The port's two paths agree row for row (the A/B of
    tests/test_train_step_identity.py)."""
    params = _scene(CAP)
    (p_a, m_a, c_a, met_a), _ = _one_step(params, CAP, CAP)
    (p_b, m_b, c_b, met_b), _ = _one_step(_pad(params, 2 * CAP), 2 * CAP, CAP)
    assert float(met_a["loss"]) == float(met_b["loss"])
    for k in params:
        np.testing.assert_allclose(p_a[k][:N], p_b[k][:N], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    for k in COUNTER_KEYS:
        np.testing.assert_allclose(c_a[k][:N], c_b[k][:N], rtol=1e-5,
                                   atol=1e-7, err_msg=k)


# --------------------------------- (d) training_iteration on a synthetic tree
TH, TW = 64, 256
N_ROOTS = 300
MODEL_ARGS = {
    "use_view_correction": True,
    "gaussian": {"xyz_scale": 1.0, "sh_degree": 1},
    "optimizer": {
        "optimize_keys": list(KEYS), "opt_all_levels": True,
        "lr_dict": {"xyz": 0.00016, "xyz_final": 0.0000016, "xyz_scale": 1.0,
                    "colors": 0.0025, "shs": 0.000125, "scaling": 0.005,
                    "opacity": 0.05, "rotation": 0.001, "max_steps": 600},
    },
    "tree": {"max_child": 4, "max_level": 30},
    "densify_and_remove": {},
}


def _train_checkpoint():
    """The synthetic tree as a fresh training checkpoint: zero moments."""
    ckpt = build_checkpoint(N_ROOTS, seed=2)
    for key in KEYS:
        for mk in ("exp_avg", "exp_avg_sq"):
            ckpt[f"optimizer.{mk}.{key}"] = np.zeros_like(ckpt[f"gaussian.{key}"])
    ckpt["optimizer.global_steps"] = np.float32(0)
    return ckpt


def _train_models(n_views=2):
    ckpt = _train_checkpoint()
    port = load_object("LoG.model.level_of_gaussian.LoG", MODEL_ARGS,
                       device="cpu")
    ref = LoGJax(**MODEL_ARGS)
    for m in (port, ref):
        m.view_correction.init(n_views)
        m.load_state_dict(ckpt, split="train")
        m.set_state(enable_sh=True)
        m.training_setup()
    return port, ref


def _views():
    rng = np.random.default_rng(11)
    views = []
    for i, theta in enumerate((0.4, 1.3, 2.2)):
        pc = _camera(TH, TW, (22 * math.cos(theta), 22 * math.sin(theta), 18.0),
                     100.0)
        gt = rng.integers(0, 256, (3, TH, TW), dtype=np.uint8)
        bg = rng.uniform(size=3).astype(np.float32)
        views.append((pc, gt, bg, i % 2))
    return views


def test_training_iteration_matches_jax():
    port, ref = _train_models()
    buckets = []
    for pc, gt, bg, vi in _views():
        met_p, _ = port.training_iteration(pc, gt, bg, view_index=vi)
        met_j, _ = ref.training_iteration(pc, gt, bg, view_index=vi)
        assert port._bucket == ref._bucket
        buckets.append(port._bucket)
        assert abs(float(met_p["loss"]) - float(met_j["loss"])) <= 1e-5
    assert port.optimizer.global_steps == ref.optimizer.global_steps == 3
    n = port.num_points
    sd_p, sd_j = port.state_dict(), ref.state_dict()
    assert set(sd_p) == set(sd_j)
    p_p = {k: sd_p[f"gaussian.{k}"] for k in KEYS}
    p_j = {k: sd_j[f"gaussian.{k}"] for k in KEYS}
    m_p = {mk: {k: sd_p[f"optimizer.{mk}.{k}"] for k in KEYS}
           for mk in ("exp_avg", "exp_avg_sq")}
    m_j = {mk: {k: sd_j[f"optimizer.{mk}.{k}"] for k in KEYS}
           for mk in ("exp_avg", "exp_avg_sq")}
    assert_moments_close(m_p, m_j, n)
    assert_params_close(p_p, p_j, m_j, n)
    assert_counters_close({k: sd_p[f"counter.{k}"] for k in COUNTER_KEYS},
                          {k: sd_j[f"counter.{k}"] for k in COUNTER_KEYS}, n)
    # the per-view gain stepped from base_iter (1) on: steps 2 and 3
    np.testing.assert_allclose(sd_p["view_correction.view_correction"],
                               sd_j["view_correction.view_correction"],
                               atol=1e-5)
    assert (sd_p["view_correction.view_correction"] != 1.0).any()
    assert (sd_p["counter.visible_count"] > 0).sum() > 100


# ------------------------------------------------ (e) state carried across
def _trained_state():
    """A checkpoint with every training key filled from a numpy seed."""
    rng = np.random.default_rng(5)
    ckpt = _train_checkpoint()
    n = ckpt["gaussian.xyz"].shape[0]
    for key in KEYS:
        for mk in ("exp_avg", "exp_avg_sq"):
            ckpt[f"optimizer.{mk}.{key}"] = rng.normal(
                size=ckpt[f"gaussian.{key}"].shape).astype(np.float32)
    ckpt["optimizer.global_steps"] = np.float32(37)
    for key, val in init_counter(n).items():
        if key.startswith("radius3d"):
            continue
        ckpt[f"counter.{key}"] = (rng.integers(0, 50, n) if val.dtype == np.int32
                                  else rng.uniform(size=n)).astype(val.dtype)
    ckpt["view_correction.view_correction"] = rng.uniform(
        0.8, 1.2, (2, 3)).astype(np.float32)
    return ckpt


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_train_state_dict_round_trip(direction):
    ckpt = _trained_state()
    src, dst = _train_models()
    if direction == "port_to_jax":
        dst, src = src, dst
    src.load_state_dict(ckpt, split="train")
    dst.load_state_dict(src.state_dict(), split="train")
    sd = dst.state_dict()
    assert set(sd) == set(ckpt)
    for key, val in ckpt.items():
        np.testing.assert_array_equal(np.asarray(sd[key]), val, err_msg=key)
    assert dst.optimizer.global_steps == 37
