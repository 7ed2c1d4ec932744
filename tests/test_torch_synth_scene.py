"""The port's device scene generator (log_tpu_torch/utils/synth_tree.py:
build_scene, pad_scene, checkpoint_scene) against log_tpu's
build_scene_device and padded_model_device, on the CPU.

pad_scene given JAX's own unpadded scene equals padded_model_device in both
layouts, every array exactly (cull_seg_starts and is_leaf_opt included).
build_scene's tree arrays equal JAX's exactly, and so do its uniform draws
(utils/jax_random.py: the roots' positions, in Morton order, and the
colors); the normal draws and the logs of the scales and opacities are
within 4 ulps of each key's largest value. The port's flat_slice frame of
the padded JAX scene agrees with JAX's within ROADMAP fact o's packed
bound (max 3e-2, at most 0.1% of the pixels past 1e-2), the counts
exactly. A checkpoint's
points through checkpoint_scene -> pad_scene("root_major") give the frame
of load_state_dict -> optimize_render_layout() on the same points.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.model import train_step as ts_jax
from log_tpu.render.renderer import camera_device as camera_jax
from log_tpu.utils.synth_tree import (build_scene_device,
                                      padded_model_device)
from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.model import train_step as ts
from log_tpu_torch.model.gaussian import next_capacity
from log_tpu_torch.render.renderer import camera_device
from log_tpu_torch.scripts import _common as C
from log_tpu_torch.utils import jax_random
from log_tpu_torch.utils.config import load_object
from log_tpu_torch.utils.synth_tree import (build_checkpoint, build_scene,
                                            checkpoint_scene, pad_scene,
                                            tree_sizes)

H, W = 64, 128
N_ROOTS = 1000


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    for name in ("LOG_TPU_QUADFORM", "LOG_TPU_FASTEXP", "LOG_TPU_PACK_PAIRS",
                 "LOG_TPU_COMPACT", "LOG_TPU_TILE_H", "LOG_TPU_TILESTART",
                 "LOG_TPU_CUMPROD"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("LOG_TPU_PACK_SORT_KEYS", "0")


def _camera(theta, focal=80.0):
    pos = np.array([22.0 * math.cos(theta), 22.0 * math.sin(theta), 18.0])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, np.array([0, 0, 1.0]))
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    return prepare_camera({"K": K, "R": R, "T": (-R @ pos).reshape(3, 1),
                           "H": H, "W": W, "center": pos.reshape(3, 1)},
                          1, 0.01, 1000.0)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def jax_scene():
    params, tree = build_scene_device(jax.random.PRNGKey(3), N_ROOTS)
    return _np(params), _np(tree)


@pytest.mark.parametrize("layout", ["level", "root_major"])
def test_pad_scene_equals_padded_model_device(jax_scene, layout):
    params, tree = jax_scene
    n = tree_sizes(N_ROOTS)[2]
    cap = next_capacity(n)
    want_p, want_t, want_leaf = padded_model_device(
        jax.random.PRNGKey(3), N_ROOTS, cap, layout)
    got_p, got_t, got_leaf = pad_scene(params, tree, cap, layout)
    assert set(got_p) == set(want_p) and set(got_t) == set(want_t)
    assert ("cull_seg_starts" in got_t) == (layout == "root_major")
    for got, want in ((got_p, want_p), (got_t, want_t)):
        for k in want:
            assert got[k].dtype == torch.from_numpy(np.asarray(want[k])).dtype
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
    np.testing.assert_array_equal(got_leaf.numpy(), np.asarray(want_leaf))


def test_build_scene_tree_and_draws():
    params, tree = build_scene(N_ROOTS, jax_random.prng_key(0), "cpu")
    want_p, want = build_scene_device(jax.random.PRNGKey(0), N_ROOTS)
    for k, v in want.items():
        np.testing.assert_array_equal(tree[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert set(params) == set(want_p)
    # the uniform draws bit for bit: the roots' positions (and so their
    # Morton order) and the colors
    for k, rows in (("xyz", slice(0, N_ROOTS)), ("colors", slice(None))):
        np.testing.assert_array_equal(params[k][rows].numpy(),
                                      np.asarray(want_p[k])[rows], err_msg=k)
    # the normal draws (the children's offsets, the rotations) within a
    # few ulps, and the logs of the scales and opacities (XLA's own float32
    # log) likewise: within 4 ulps of each key's largest value
    for k, v in want_p.items():
        v = np.asarray(v)
        gap = np.abs(params[k].numpy() - v).max()
        assert gap <= 4 * np.spacing(np.abs(v).max()), (k, gap)
    n1, n2, n = tree_sizes(N_ROOTS)
    xyz = params["xyz"].numpy()
    assert all(v.shape[0] == n for v in params.values())
    assert (np.abs(xyz[:N_ROOTS, :2]) <= 30).all()
    assert (xyz[:N_ROOTS, 2] >= 0).all() and (xyz[:N_ROOTS, 2] <= 2).all()
    scal = np.exp(params["scaling"].numpy())
    assert (scal[:N_ROOTS] >= 0.08 * 0.6 - 1e-6).all()
    assert (scal[:N_ROOTS] <= 0.25 * 1.4 + 1e-6).all()
    # children at 0.55x their parent's scale, jittered around it
    ip = tree["index_parent"].numpy()
    kids = np.arange(N_ROOTS, n)
    np.testing.assert_allclose(scal[kids], 0.55 * scal[ip[kids]], rtol=1e-5)
    assert np.abs(xyz[kids] - xyz[ip[kids]]).max() < 10 * scal.max()
    op = 1 / (1 + np.exp(-params["opacity"].numpy()))
    assert (op >= 0.3 - 1e-6).all() and (op <= 0.95 + 1e-6).all()
    rgb = params["colors"].numpy() * 0.28209479177387814 + 0.5
    assert (rgb >= -1e-6).all() and (rgb <= 1 + 1e-6).all()
    np.testing.assert_allclose(
        np.linalg.norm(params["rotation"].numpy(), axis=1), 1, rtol=1e-5)
    assert not params["shs"].any()
    # the roots in Morton order of the JAX generator's 2-D key
    q = np.clip(((xyz[:N_ROOTS, :2] + 30) / 60 * 1024).astype(np.int32), 0,
                1023)
    key = np.zeros(N_ROOTS, np.int64)
    for b in range(10):
        key |= ((q[:, 0] >> b) & 1).astype(np.int64) << (2 * b)
        key |= ((q[:, 1] >> b) & 1).astype(np.int64) << (2 * b + 1)
    assert (np.diff(key) >= 0).all()
    # the same key gives the same scene
    again, _ = build_scene(N_ROOTS, jax_random.prng_key(0), "cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def _frame_kw(n, cap):
    return dict(
        image_height=H, image_width=W, k_visible=next_capacity(n, 256),
        sh_degree=0, stage_has_tree=True, num_levels=3, backend="tiled",
        max_pairs=1 << 16, check_scale=4, n_roots=next_capacity(N_ROOTS, 256),
        prep_backend="tiled", prep_max_pairs=1 << 15,
        cut_method="flat_slice")


def test_frame_of_the_padded_jax_scene_matches_jax(jax_scene):
    params, tree = jax_scene
    n = tree_sizes(N_ROOTS)[2]
    cap = next_capacity(n)
    want_scene = padded_model_device(jax.random.PRNGKey(3), N_ROOTS, cap,
                                     "root_major")
    p, t, leaf = pad_scene(params, tree, cap, "root_major")
    pc = _camera(0.8)
    kw = _frame_kw(n, cap)
    want = ts_jax.fused_prepare_render(
        *want_scene[:2], camera_jax(pc), jnp.int32(n), want_scene[2],
        jnp.float32(3.0), jnp.int32(20), jnp.zeros(3, jnp.float32), **kw)
    got = ts.fused_prepare_render(p, t, camera_device(pc, "cpu"), n, leaf,
                                  3.0, 20, torch.zeros(3), **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert int(got[2][0] + got[2][1]) > 500
    for g, w in ((got[0], want[0]), (got[1], want[1])):
        d = np.abs(g.numpy() - np.asarray(w))
        assert float(d.max()) < 3e-2, d.max()
        assert float((d > 1e-2).mean()) < 1e-3
    assert float(got[0].std()) > 0.01


@pytest.mark.parametrize("pack_pairs", [True, False])
def test_checkpoint_scene_frame_equals_the_optimized_model(pack_pairs):
    """The same points in two row orders: the model's (optimize_render_
    layout ranks the roots by a 3-D Morton key) and pad_scene's (the
    build's 2-D order). The cut, the demand and the per-point math do not
    depend on the order, and the compositing order is (tile, depth), so
    the frames are equal on the packed route and on K1's."""
    ckpt = build_checkpoint(N_ROOTS, seed=4, sh_degree=0)
    n = tree_sizes(N_ROOTS)[2]
    model = load_object("LoG.model.level_of_gaussian.LoG",
                        dict(C.MODEL_ARGS, gaussian={"xyz_scale": 1.0,
                                                     "sh_degree": 0}),
                        device="cpu")
    model.load_state_dict(ckpt)
    model.eval()
    model.optimize_render_layout()
    cap = model.capacity
    p, t, leaf = pad_scene(*checkpoint_scene(ckpt, "cpu"), cap,
                           "root_major")
    pc = camera_device(_camera(2.1), "cpu")
    kw = dict(_frame_kw(n, cap), pack_pairs=pack_pairs)
    want = ts.fused_prepare_render(
        model.gaussian.params(), model.tree_device(), pc, n,
        model._leaf_opt_dev, 3.0, 20, torch.zeros(3), **kw)
    got = ts.fused_prepare_render(p, t, pc, n, leaf, 3.0, 20, torch.zeros(3),
                                  **kw)
    np.testing.assert_array_equal(got[2].numpy(), want[2].numpy())
    assert int(got[2][0] + got[2][1]) > 500
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
