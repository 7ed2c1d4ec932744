"""The port's depth supervision against log_tpu on the CPU: the MiDaS
losses of render/loss.py, one training step with render_depth, the depth
render of NaiveRendererAndLoss.vis, DepthDataset and the Spectral colormap
of marigold_depth_vis. Inputs come from numpy seeds and go to both.

Limits:
- the losses: values and gradients (autograd against jax.grad) to 1e-5
  relative to the largest of each, in float64 on both sides (in float32
  the closed-form scale and shift subtracts nearly equal sums, det =
  a_00 a_11 - a_01^2, and the two packages' summation orders then differ
  by up to 4e-4 of the largest gradient);
- the depth step on LOG_TPU_BACKEND=reference in both packages (the JAX
  tiled depth pass composites in bf16, ROADMAP fact i), each package
  drawing the patch corners from PRNGKey(step) (the port with
  utils/jax_random.py):
  tests/test_torch_train_step.py's limits (loss to 1e-5, first moments to
  1e-3 of each key's largest, parameters to 1e-6 where the gradient is
  above 1e-4 of its key's largest, integer counters equal, float counters
  to 1e-4);
- the depth render: depth, height and accmap on the oracle to 1e-6 of
  each map's largest in the mean and 2e-5 at most (one pixel of the test
  frame is at 1.5e-5: a pair at the alpha gate); on the tiled path (the
  JAX K1 without stats in bf16, the port's in f32) to 1e-2 of the largest
  at most (7.7e-3 measured) and 1e-3 in the mean;
- DepthDataset: items equal, depth maps bit for bit;
- marigold_depth_vis: the same bytes as matplotlib's Spectral colormap.
"""
import math
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.dataset import colmap as colmap_jax
from log_tpu.dataset.synthetic import SyntheticDataset as SyntheticJax
from log_tpu.model.counter import init_counter as init_counter_jax
from log_tpu.model.level_of_gaussian import LoG as LoGJax
from log_tpu.model.train_step import StepConfig as StepConfigJax
from log_tpu.model.train_step import fused_train_step as step_jax
from log_tpu.render import loss as loss_jax
from log_tpu.render.renderer import NaiveRendererAndLoss as RendererJax
from log_tpu.render.renderer import camera_device as camera_device_jax
from log_tpu_torch.apps import train
from log_tpu_torch.dataset import colmap
from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.model.counter import init_counter
from log_tpu_torch.model.train_step import StepConfig, fused_train_step
from log_tpu_torch.render import loss
from log_tpu_torch.render.renderer import NaiveRendererAndLoss, camera_device
from log_tpu_torch.utils import config
from log_tpu_torch.utils import jax_random as jr
from log_tpu_torch.utils.synth_tree import build_checkpoint

from test_torch_dataset import _write_scene
from test_torch_train_step import (KEYS, _camera, _scene, assert_counters_close,
                                   assert_moments_close, assert_params_close)

REL = 1e-5


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= rel * scale, (
        what, np.abs(got - want).max(), scale)


def _maps(seed, b=3, h=16, w=20):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.5, 2.0, (b, h, w)).astype(np.float32)
    target = rng.uniform(0.0, 1.0, (b, h, w)).astype(np.float32)
    mask = (rng.uniform(size=(b, h, w)) > 0.3).astype(np.float32)
    # image 1: an all-zero mask (det == 0); image 2: a constant
    # prediction (det == 0 with pixels in the mask)
    mask[1] = 0.0
    pred[2] = 1.25
    return pred, target, mask


def _both(fn_port, fn_jax, arrays, argnums):
    """Value and gradients w.r.t. argnums of a scalar function in both
    packages."""
    arrays = [np.asarray(a, np.float64) for a in arrays]
    t = [torch.tensor(a, requires_grad=i in argnums)
         for i, a in enumerate(arrays)]
    val_p = fn_port(*t)
    grads_p = torch.autograd.grad(val_p, [t[i] for i in argnums])
    with jax.enable_x64(True):
        val_j, grads_j = jax.value_and_grad(fn_jax, argnums=argnums)(
            *[jnp.asarray(a) for a in arrays])
        assert val_j.dtype == jnp.float64
    return (float(val_p.detach()), [g.numpy() for g in grads_p],
            float(val_j), [np.asarray(g) for g in grads_j])


def _weights(n):
    return np.random.default_rng(9).normal(size=n).astype(np.float32)


@pytest.mark.parametrize("name", ["compute_scale_and_shift", "gradient_loss",
                                  "ssi_scales_1", "ssi_scales_2"])
def test_losses_match_jax(name):
    """Each loss (scale and shift reduced to a weighted sum) with a
    det == 0 image and an all-zero-mask image in the batch."""
    pred, target, mask = _maps(4)
    w0, w1 = _weights(3), _weights(6)[3:]
    if name == "compute_scale_and_shift":
        def port(p, t, m):
            x0, x1 = loss.compute_scale_and_shift(p, t, m)
            return (x0 * torch.from_numpy(w0).double()).sum() + (
                x1 * torch.from_numpy(w1).double()).sum()

        def ref(p, t, m):
            x0, x1 = loss_jax.compute_scale_and_shift(p, t, m)
            return (x0 * w0).sum() + (x1 * w1).sum()
        x0, x1 = loss.compute_scale_and_shift(*map(torch.from_numpy,
                                                   (pred, target, mask)))
        assert float(x0[1]) == float(x1[1]) == 0.0  # all-zero mask
        assert float(x0[2]) == float(x1[2]) == 0.0  # constant prediction
    elif name == "gradient_loss":
        port, ref = loss.gradient_loss, loss_jax.gradient_loss
    else:
        scales = int(name[-1])

        def port(p, t, m):
            val, ssi = loss.scale_and_shift_invariant_loss(p, t, m,
                                                           scales=scales)
            return val + 0.1 * ssi.sum()

        def ref(p, t, m):
            val, ssi = loss_jax.scale_and_shift_invariant_loss(
                p, t, m, scales=scales)
            return val + 0.1 * ssi.sum()
    v_p, g_p, v_j, g_j = _both(port, ref, (pred, target, mask), (0, 1))
    assert abs(v_p - v_j) <= REL * max(abs(v_j), 1e-30), (v_p, v_j)
    for a, b, what in zip(g_p, g_j, ("d prediction", "d target")):
        _close(a, b, what=what)


def test_all_zero_mask_loss_is_zero_in_both():
    pred, target, mask = _maps(5)
    mask[:] = 0.0
    v_p, g_p, v_j, g_j = _both(
        lambda p, t, m: loss.scale_and_shift_invariant_loss(p, t, m)[0],
        lambda p, t, m: loss_jax.scale_and_shift_invariant_loss(p, t, m)[0],
        (pred, target, mask), (0,))
    assert v_p == v_j == 0.0
    assert not g_p[0].any() and not np.asarray(g_j[0]).any()


def _jax_patches(key, h, w, num_patch=loss.NUM_PATCH, size=loss.PATCH_SIZE):
    """The patch corners depth_patch_loss draws from `key`."""
    kr, kc = jax.random.split(key)
    return (np.asarray(jax.random.randint(kr, (num_patch,), 0,
                                          max(h - size, 1))),
            np.asarray(jax.random.randint(kc, (num_patch,), 0,
                                          max(w - size, 1))))


@pytest.mark.parametrize("gt_shape", [(70, 90), (96, 120)])
def test_depth_patch_loss_matches_jax(gt_shape):
    """Render 70x90; the GT map at the render's size and at a larger one
    (depth_scale != scale: the corners are drawn over the GT and clamped
    into each image, as dynamic_slice clamps)."""
    rng = np.random.default_rng(6)
    pred = rng.uniform(2.0, 30.0, (70, 90)).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, gt_shape).astype(np.float32)
    acc = rng.uniform(0.0, 1.0, (70, 90)).astype(np.float32)
    key = jax.random.PRNGKey(17)
    with jax.enable_x64(True):  # the draws of the float64 run below
        rows, cols = _jax_patches(key, *gt_shape)
    if gt_shape != (70, 90):
        assert rows.max() > 70 - 64 and cols.max() > 90 - 64  # clamps
    v_p, g_p, v_j, g_j = _both(
        lambda p, g, a: loss.depth_patch_loss(p, g, a, rows, cols),
        lambda p, g, a: loss_jax.depth_patch_loss(p, g, a, key),
        (pred, gt, acc), (0, 1))
    assert abs(v_p - v_j) <= REL * abs(v_j), (v_p, v_j)
    for a, b, what in zip(g_p, g_j, ("d pred", "d gt")):
        _close(a, b, what=what)


def test_patch_offsets_from_a_generator():
    """draw_patch_offsets: the JAX step's corners from the same key (rows
    from the first split key, cols from the second), on the device asked
    for; take_patches clamps."""
    for h, w, step in ((70, 200, 3), (64, 64, 1), (320, 1088, 12345)):
        rows, cols = loss.draw_patch_offsets(h, w, jr.prng_key(step), "cpu")
        want = _jax_patches(jax.random.PRNGKey(step), h, w)
        assert rows.dtype == cols.dtype == torch.int64
        assert rows.device.type == "cpu"
        np.testing.assert_array_equal(rows.numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(cols.numpy(), np.asarray(want[1]))
        assert rows.max() < max(h - loss.PATCH_SIZE, 1)
        assert cols.max() < max(w - loss.PATCH_SIZE, 1)
    img = torch.arange(70 * 80, dtype=torch.float32).reshape(70, 80)
    p = loss.take_patches(img, [100, 3], [-5, 10], patch_size=64)
    assert torch.equal(p[0], img[6:70, 0:64])
    assert torch.equal(p[1], img[3:67, 10:74])
    with pytest.raises(ValueError):
        loss.take_patches(img[:60], [0], [0])


# ------------------------------------------- one training step with depth
H, W = 64, 256
CAP, N = 256, 200


def test_depth_step_matches_jax(monkeypatch):
    """One fused_train_step with render_depth on the oracle in both
    packages: the depth pass's colors (camera depth, world z, 1) and its
    patch loss, each package drawing the corners from PRNGKey(5)."""
    monkeypatch.setenv("LOG_TPU_BACKEND", "reference")
    params = _scene(CAP)
    keep = np.arange(CAP) < N
    # close enough that the inverse depth varies across each patch: from
    # far, the fit's det (a_00 a_11 - a_01^2) cancels to a few digits and
    # float32 sums in another order move the depth term by ~1e-3 in both
    # packages against a float64 evaluation
    pc = _camera(H, W, (0.0, -9.0, 4.0), 90.0)
    rng = np.random.default_rng(3)
    gt = (rng.uniform(size=(3, H, W)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    gt_depth = (0.5 + 0.4 * np.sin(xx / 17.0) * np.cos(yy / 11.0)
                + 0.05 * rng.uniform(size=(H, W))).astype(np.float32)
    bg = np.array([0.2, 0.5, 0.7], np.float32)
    key = jax.random.PRNGKey(5)
    patches = loss.draw_patch_offsets(H, W, jr.prng_key(5), "cpu")
    corr = {"values": np.ones((1, 3), np.float32),
            "m1": np.zeros((1, 3), np.float32),
            "m2": np.zeros((1, 3), np.float32),
            "vmax": np.zeros((1, 3), np.float32),
            "steps": np.zeros((1,), np.int32)}
    kw = dict(image_height=H, image_width=W, k_leaf=CAP, k_node=0,
              sh_degree=1, mode="antialias", backend="reference",
              render_depth=True)
    lr = 1e-2
    t = torch.from_numpy
    out_p = fused_train_step(
        {k: t(v) for k, v in params.items()},
        {m: {k: torch.zeros_like(t(v)) for k, v in params.items()}
         for m in ("exp_avg", "exp_avg_sq")},
        {k: t(v) for k, v in init_counter(CAP).items()}, t(keep),
        torch.zeros(CAP, dtype=torch.bool), camera_device(pc, "cpu"), t(gt),
        t(bg), {k: lr for k in KEYS}, 1.0,
        {k: t(v) for k, v in corr.items()}, 0, torch.ones((1, 1, 1)),
        t(gt_depth), StepConfig(**kw), depth_patches=patches,
    )
    j = jnp.asarray
    out_j = step_jax(
        {k: j(v) for k, v in params.items()},
        {m: {k: jnp.zeros_like(j(v)) for k, v in params.items()}
         for m in ("exp_avg", "exp_avg_sq")},
        {k: j(v) for k, v in init_counter_jax(CAP).items()}, j(keep),
        jnp.zeros((CAP,), bool), camera_device_jax(pc), j(gt), j(bg),
        {k: jnp.float32(lr) for k in KEYS}, jnp.float32(1),
        {k: j(v) for k, v in corr.items()}, jnp.int32(0), jnp.ones((1, 1, 1)),
        j(gt_depth), key, cfg=StepConfigJax(**kw),
    )
    met_p, met_j = out_p[4], out_j[4]
    depth_term = float(met_p["depth"])
    assert math.isfinite(depth_term) and depth_term > 0
    # the depth term moves the total well beyond the limit
    assert float(met_p["loss"]) - (0.8 * float(met_p["l1"])
                                   + 0.2 * float(met_p["ssim"])) > 1e-3
    for key_ in ("loss", "l1", "ssim"):
        assert abs(float(met_p[key_]) - float(met_j[key_])) <= 1e-5, key_
    assert_moments_close(out_p[1], out_j[1], N)
    assert_params_close(out_p[0], out_j[0], out_j[1], N)
    assert_counters_close(out_p[2], out_j[2], N)


def test_depth_step_needs_its_inputs():
    params = _scene(CAP)
    t = torch.from_numpy
    with pytest.raises(ValueError, match="render_depth"):
        fused_train_step(
            {k: t(v) for k, v in params.items()}, {}, {}, None, None, None,
            None, None, {}, 1.0, {}, 0, None, None,
            StepConfig(image_height=H, image_width=W, k_leaf=CAP, k_node=0,
                       sh_degree=0, render_depth=True))


# --------------------------------------------------------- the depth render
def _tree_models(backend, monkeypatch):
    monkeypatch.setenv("LOG_TPU_BACKEND", backend)
    monkeypatch.setenv("LOG_TPU_PACK_SORT_KEYS", "0")
    ckpt = build_checkpoint(2000, seed=1)
    args = dict(gaussian=dict(xyz_scale=1.0, sh_degree=1),
                optimizer=dict(opt_all_levels=True), densify_and_remove={},
                tree=dict(max_child=4, max_level=30))
    port = config.load_object("LoG.model.level_of_gaussian.LoG", args,
                              device="cpu")
    ref = LoGJax(**args)
    for m in (port, ref):
        m.load_state_dict(ckpt)
        m.set_state(enable_sh=True)
        m.eval()
    return port, ref


def _tree_batch(h=64, w=128):
    pos = np.array([15.0, -12.0, 18.0])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    pc = prepare_camera({"K": np.array([[90.0, 0, w / 2], [0, 90.0, h / 2],
                                        [0, 0, 1]]),
                         "R": R, "T": (-R @ pos).reshape(3, 1), "H": h,
                         "W": w, "center": pos.reshape(3, 1)}, 1, 0.01, 1000.0)
    return train._batchify({"camera": pc})


@pytest.mark.parametrize("backend", ["reference", "tiled"])
def test_depth_render_matches_jax(backend, monkeypatch):
    """vis with render_depth on an eval-mode LoD tree: the two-phase path
    in both packages, then (depth, height, accmap) over a zero
    background."""
    port, ref = _tree_models(backend, monkeypatch)
    batch = _tree_batch()
    got = NaiveRendererAndLoss(device="cpu", render_depth=True).vis(
        batch, port, background=np.ones(3, np.float32))
    want = RendererJax(render_depth=True).vis(
        batch, ref, background=np.ones(3, np.float32))
    assert port.visibility_flag["counts"] == tuple(
        int(c) for c in ref.visibility_flag["counts"])
    assert got["accmap"].max() > 0.9 and got["depth"].max() > 10.0
    for key in ("depth", "height", "accmap"):
        assert got[key].shape == (1, 64, 128) == np.asarray(want[key]).shape
        diff = np.abs(got[key] - np.asarray(want[key]))
        scale = np.abs(np.asarray(want[key])).max()
        if backend == "reference":
            assert diff.max() <= 2e-5 * scale, (key, diff.max(), scale)
            assert diff.mean() <= 1e-6 * scale, (key, diff.mean())
        else:
            assert diff.max() <= 1e-2 * scale, (key, diff.max(), scale)
            assert diff.mean() <= 1e-3 * scale, (key, diff.mean())


# ---------------------------------------------------------- DepthDataset
def test_depth_dataset_matches_jax(tmp_path):
    """16-bit depth maps at depth_scale 2 read at scales 1, 2 and 4: the
    path rewrite, the values, and the path where a map is absent."""
    ds = SyntheticJax(n_gaussians=40, n_views=3, H=64, W=80, seed=3)
    root = str(tmp_path / "scene")
    _write_scene(root, ".png", ds)
    args = dict(root=root, cameras="", scales=[1, 2, 4], znear=0.01,
                zfar=100.0, scale3d=1.0, ext=".png", share_camera=True,
                depth_scale=2)
    jax_ds = colmap_jax.DepthDataset(**args)
    rng = np.random.default_rng(8)
    written = {}
    for i in range(2):  # view 2 has no depth map
        name = f"{root}/cache/2/depth/cam/{i:04d}.png.png"
        depth16 = rng.integers(0, 2 ** 16, (32, 40)).astype(np.uint16)
        os.makedirs(os.path.dirname(name), exist_ok=True)
        assert cv2.imwrite(name, depth16)
        written[i] = depth16
    port_ds = colmap.DepthDataset(**args)
    for scale in (1, 2, 4):
        jax_ds.set_state(scale=scale)
        port_ds.set_state(scale=scale)
        for i in range(3):
            a, b = port_ds[i], jax_ds[i]
            assert np.array_equal(a["image"], b["image"])
            if i in written:
                assert a["depth"].dtype == b["depth"].dtype == np.float32
                assert np.array_equal(a["depth"], b["depth"])
                assert np.array_equal(a["depth"] * 65535.0,
                                      written[i].astype(np.float32))
            else:
                assert a["depth"] == b["depth"]
                assert a["depth"].endswith("/2/depth/cam/0002.png.png")
    cfg_ds = config.load_object("LoG.dataset.colmap.DepthDataset", args)
    assert type(cfg_ds) is colmap.DepthDataset


# ------------------------------------------------------------ the colormap
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_marigold_depth_vis_matches_matplotlib(dtype):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(12)
    vals = rng.uniform(-0.4, 1.4, (48, 64)).astype(dtype)
    vals[0, :4] = np.nan
    vals[1, :6] = [0.0, 1.0, 1.0 / 256, 255.0 / 256, -1e-9, 1.0 + 1e-7]
    vals[2] = np.linspace(0, 1, 64)
    got = NaiveRendererAndLoss.marigold_depth_vis(vals)
    want = RendererJax.marigold_depth_vis(vals)
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 100


def test_acc_and_depth_to_bgr_match_jax():
    rng = np.random.default_rng(13)
    acc = rng.uniform(-0.2, 1.2, (24, 32)).astype(np.float32)
    got = NaiveRendererAndLoss.acc_to_bgr(acc)
    want = RendererJax.acc_to_bgr(acc)
    assert got.shape == (24, 32, 3) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    assert np.array_equal(
        NaiveRendererAndLoss.acc_to_bgr(torch.from_numpy(acc)), want)
    depth = rng.uniform(2.0, 9.0, (24, 32)).astype(np.float32)
    assert np.array_equal(NaiveRendererAndLoss.depth_to_bgr(depth),
                          RendererJax.depth_to_bgr(depth))
    # a constant map normalizes to 0 in both
    flat = np.full((4, 5), 3.0, np.float32)
    assert np.array_equal(NaiveRendererAndLoss.depth_to_bgr(flat),
                          RendererJax.depth_to_bgr(flat))
