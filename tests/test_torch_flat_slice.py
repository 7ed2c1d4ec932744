"""The flat_slice serving frame of log_tpu_torch against log_tpu's, on the CPU.

One seeded synthetic tree (log_tpu.utils.synth_tree.padded_model_device)
goes into both packages' fused_prepare_render(cut_method="flat_slice"); the
JAX side runs its Pallas kernels in interpret mode, the port its plain
versions. The kept counts and the pair demand must be equal; images agree
within the JAX package's own flat_slice bounds (tests/test_flat_slice.py:
max 3e-2, at most 0.1% of pixels past 1e-2): the JAX packed kernel
evaluates a quadratic form with a 1e-2 gate slack and composites in bf16.
The cut's pieces (flat_cut_pre, expand_weight_full in both branches) are
exact, the column projection within f32 rounding.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.model import train_step as ts_jax
from log_tpu.model.gaussian import next_capacity
from log_tpu.render.renderer import camera_device as camera_jax
from log_tpu.utils.synth_tree import padded_model_device, tree_sizes
from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.model import train_step as ts
from log_tpu_torch.model.tensor_tree import flat_cut_pre
from log_tpu_torch.ops import gaussian_math as gm
from log_tpu_torch.ops.projection import project_gaussians_cols
from log_tpu_torch.render.renderer import camera_device

H, W = 64, 128


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    for name in ("LOG_TPU_QUADFORM", "LOG_TPU_FASTEXP", "LOG_TPU_PACK_PAIRS",
                 "LOG_TPU_COMPACT", "LOG_TPU_TILE_H", "LOG_TPU_TILESTART",
                 "LOG_TPU_CUMPROD"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("LOG_TPU_PACK_SORT_KEYS", "0")


def _camera(theta, radius=22.0, height=18.0, focal=80.0):
    pos = np.array([radius * math.cos(theta), radius * math.sin(theta),
                    height])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, np.array([0, 0, 1.0]))
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    return prepare_camera({"K": K, "R": R, "T": (-R @ pos).reshape(3, 1),
                           "H": H, "W": W, "center": pos.reshape(3, 1)},
                          1, 0.01, 1000.0)


def _scene(n_roots, seed=0, layout="level"):
    """The JAX package's synthetic tree in both packages' arrays."""
    _, _, n = tree_sizes(n_roots)
    cap = next_capacity(n)
    params_j, tree_j, leaf_j = padded_model_device(
        jax.random.PRNGKey(seed), n_roots, cap, layout)

    def t(a):
        return torch.from_numpy(np.array(a))

    port = ({k: t(v) for k, v in params_j.items()},
            {k: t(v) for k, v in tree_j.items()}, t(leaf_j))
    return (params_j, tree_j, leaf_j), port, n, cap


def _common(n_roots, n, cap, sh_degree):
    return dict(
        image_height=H, image_width=W, k_visible=next_capacity(n, 256),
        sh_degree=sh_degree, stage_has_tree=True, num_levels=3,
        backend="tiled", max_pairs=1 << 16, check_scale=4,
        n_roots=min(next_capacity(n_roots, 256), cap), prep_backend="tiled",
        prep_max_pairs=1 << 15, cut_method="flat_slice",
    )


def _frames(jax_scene, port_scene, pc, n, kw, w_full=None):
    (params_j, tree_j, leaf_j), (params, tree, leaf) = jax_scene, port_scene
    want = ts_jax.fused_prepare_render(
        params_j, tree_j, camera_jax(pc), jnp.int32(n), leaf_j,
        jnp.float32(3.0), jnp.int32(20), jnp.zeros(3, jnp.float32),
        w_full=None if w_full is None else jnp.asarray(w_full.numpy()), **kw)
    got = ts.fused_prepare_render(
        params, tree, camera_device(pc, "cpu"), n, leaf, 3.0, 20,
        torch.zeros(3), w_full=w_full, **kw)
    return got, want


def _assert_frames_close(got, want):
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in ((got[0], want[0]), (got[1], want[1])):
        d = np.abs(g.numpy() - np.asarray(w))
        assert float(d.max()) < 3e-2, d.max()
        assert float((d > 1e-2).mean()) < 1e-3, (d > 1e-2).mean()
    assert float(got[0].std()) > 0.01


@pytest.mark.parametrize("n_roots,pack,sh_degree", [
    (5000, True, 1),   # slice bucket 32768: K3p; SH on the capacity axis
    (3000, False, 0),  # full-precision columns and K1
    (3000, False, 1),  # SH without packing: the slices path
])
def test_flat_slice_frame_matches_jax(n_roots, pack, sh_degree):
    """The packed case runs the per-frame slice-axis weight cull (no
    w_full); the other two skip the cull (check_cull=False), which keeps
    their JAX compiles short: the same cull code runs in the packed case
    and the capacity-axis cull in the w_full test."""
    jax_scene, port_scene, n, cap = _scene(n_roots, seed=2)
    params_j, tree_j, leaf_j = jax_scene
    shs = 0.3 * np.random.default_rng(7).standard_normal(
        params_j["shs"].shape).astype(np.float32)
    jax_scene = ({**params_j, "shs": jnp.asarray(shs)}, tree_j, leaf_j)
    port_scene[0]["shs"] = torch.from_numpy(shs)
    kw = _common(n_roots, n, cap, sh_degree)
    got, want = _frames(jax_scene, port_scene, _camera(0.9), n,
                        dict(kw, pack_pairs=pack, check_cull=pack))
    _assert_frames_close(got, want)
    counts = got[2].tolist()
    assert counts[0] + counts[1] > 1000
    # counts[2] is the pair demand on the column paths, -1 on the slices
    assert (counts[2] == -1) == (not pack and sh_degree > 0)


def test_flat_slice_frame_with_w_full_matches_jax():
    """The capacity-axis cull mask of fused_root_cull (equal in both
    packages) folded into the cut: the default serving frame."""
    n_roots = 3000
    jax_scene, port_scene, n, cap = _scene(n_roots, seed=1)
    kw = _common(n_roots, n, cap, 0)
    pc = _camera(1.1)
    cull = dict(prep_backend="tiled", prep_max_pairs=1 << 15, check_scale=4,
                n_roots=kw["n_roots"])
    w_j = ts_jax.fused_root_cull(jax_scene[0], jax_scene[1], camera_jax(pc),
                                 jnp.int32(n), H, W, **cull)
    w_full = ts.fused_root_cull(port_scene[0], port_scene[1],
                                camera_device(pc, "cpu"), n, H, W, **cull)
    np.testing.assert_array_equal(w_full.numpy(), np.asarray(w_j))
    assert 0 < int(w_full.sum()) < n
    got, want = _frames(jax_scene, port_scene, pc, n, kw, w_full=w_full)
    _assert_frames_close(got, want)


def test_flat_cut_pre_and_expand_weight_full_match_jax():
    from log_tpu.model.tensor_tree import flat_cut_pre as flat_cut_pre_jax

    n_roots = 600
    (_, tree_j, _), (_, tree, _), n, cap = _scene(n_roots, layout="root_major")
    rng = np.random.default_rng(3)
    frus = rng.random(cap) < 0.7
    r2d = (rng.random(cap) * 8).astype(np.float32)
    r2d_p = (rng.random(cap) * 8).astype(np.float32)
    alive = np.arange(cap) < n
    args = (frus, r2d, r2d_p, alive)
    for depth_cap in (1, 20):
        want = flat_cut_pre_jax(
            tree_j["index_parent"], tree_j["node_index"], tree_j["depth"],
            *(jnp.asarray(a) for a in args), jnp.float32(3.0),
            jnp.int32(depth_cap))
        got = flat_cut_pre(tree["index_parent"], tree["node_index"],
                           tree["depth"], *(torch.from_numpy(a) for a in args),
                           3.0, depth_cap)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < int(got.sum()) < n
    # both branches: the root_id gather and the segment scatter-max/cummax
    R = min(next_capacity(n_roots), cap)
    w = rng.random(R) > 0.5
    tree_gather = {k: v for k, v in tree.items() if k != "cull_seg_starts"}
    tree_j_gather = {k: v for k, v in tree_j.items() if k != "cull_seg_starts"}
    full_take = ts.expand_weight_full(torch.from_numpy(w), tree_gather, cap, R)
    full_seg = ts.expand_weight_full(torch.from_numpy(w), tree, cap, R)
    np.testing.assert_array_equal(
        full_take.numpy(),
        np.asarray(ts_jax.expand_weight_full(jnp.asarray(w), tree_j_gather,
                                             cap, R)))
    np.testing.assert_array_equal(
        full_seg.numpy(),
        np.asarray(ts_jax.expand_weight_full(jnp.asarray(w), tree_j, cap, R)))
    np.testing.assert_array_equal(full_seg.numpy()[:n], full_take.numpy()[:n])


def test_project_gaussians_cols_matches_jax():
    from log_tpu.ops.projection import project_gaussians_cols as cols_jax

    (params_j, _, _), (params, _, _), n, cap = _scene(600, seed=4)
    pc = _camera(0.3)
    cam, cam_j = camera_device(pc, "cpu"), camera_jax(pc)
    alive = torch.arange(cap) < n

    def columns(p, exp, sigmoid):
        x, s, q = p["xyz"], exp(p["scaling"]), p["rotation"]
        return (x[:, 0], x[:, 1], x[:, 2], s[:, 0], s[:, 1], s[:, 2],
                q[:, 0], q[:, 1], q[:, 2], q[:, 3], sigmoid(p["opacity"][:, 0]))

    keys = ("world_view", "full_proj", "focal_x", "focal_y", "tan_fovx",
            "tan_fovy")
    for mode, use_filter in (("antialias", False), ("antialias", True),
                             ("original", True)):
        kw = dict(mode=mode, use_filter=use_filter, tight_radius=True,
                  with_cut_radius=True)
        got, cut = project_gaussians_cols(
            *columns(params, torch.exp, torch.sigmoid),
            *(cam[k] for k in keys), H, W, active_mask=alive, **kw)
        want, cut_j = cols_jax(
            *columns(params_j, jnp.exp, jax.nn.sigmoid),
            *(cam_j[k] for k in keys), H, W,
            active_mask=jnp.asarray(alive.numpy()), **kw)
        for field, g, w in zip(got._fields, got, want):
            w = np.asarray(w)
            if g.dtype == torch.bool or field == "radius":
                # radius: ceil of a float; a rounding step apart at most
                assert (g.numpy() != w).mean() < 1e-3, field
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=2e-5,
                                           atol=1e-4, err_msg=field)
        np.testing.assert_allclose(cut.numpy(), np.asarray(cut_j), rtol=2e-5,
                                   atol=1e-4)
        # the cut radius is compute_radius2d's, from the same cov2d
        ref = gm.compute_radius2d(
            params["xyz"], torch.exp(params["scaling"]),
            params["rotation"] / params["rotation"].norm(dim=-1, keepdim=True),
            *(cam[k] for k in keys))
        np.testing.assert_allclose(cut.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-4)
