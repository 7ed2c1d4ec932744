"""The block-pruned frame and the render layout of log_tpu_torch against
log_tpu's, on the CPU.

`build_block_cache` prepacks the same words in both packages (exact but
for a few near-zero covariance entries that XLA rounds differently);
`render_blocks` and model-level `render_fused` before and after
`optimize_render_layout` agree within the JAX package's own cross-path
bounds (tests/test_block_render.py: |cut difference| <= max(64, 2%) and
PSNR > 35 dB). The layout's permutation, tree arrays and segment starts
are host numpy in both and must be equal.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.model import block_render as br_jax
from log_tpu.model.level_of_gaussian import LoG as LoGJax
from log_tpu.render.renderer import camera_device as camera_jax
from log_tpu_torch.model import block_render as br
from log_tpu_torch.model import train_step as ts
from log_tpu_torch.model.gaussian import next_capacity
from log_tpu_torch.render.renderer import camera_device
from log_tpu_torch.utils.config import load_object
from log_tpu_torch.utils.synth_tree import build_checkpoint, tree_sizes
from tests.test_torch_flat_slice import H, W, _camera, _common, _scene

ARGS = dict(
    gaussian=dict(xyz_scale=1.0, sh_degree=1),
    optimizer=dict(opt_all_levels=True),
    densify_and_remove={},
    tree=dict(max_child=4, max_level=30, cut_method="flat_slice"),
)


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    for name in ("LOG_TPU_QUADFORM", "LOG_TPU_FASTEXP", "LOG_TPU_PACK_PAIRS",
                 "LOG_TPU_COMPACT", "LOG_TPU_TILE_H", "LOG_TPU_TILESTART",
                 "LOG_TPU_CUMPROD"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("LOG_TPU_PACK_SORT_KEYS", "0")
    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")


def _psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 10.0 * math.log10(1.0 / max(mse, 1e-12))


def _assert_cache_close(cols, cols_j):
    """The prepacks: position, flag and root-id words exact; the bf16 pairs
    from f32 covariances and activations that XLA and torch round
    differently in a few near-zero entries, so equal up to that rounding
    (and nearly all words bit-exact)."""
    got = cols.numpy()
    want = np.array(cols_j).view(np.int32)
    exact = [br.C_X, br.C_Y, br.C_Z, br.C_FLAGS, br.C_ROOT_ID]
    np.testing.assert_array_equal(got[exact], want[exact])
    assert (got == want).mean() > 0.999
    for c in set(range(br.N_COLS)) - set(exact):
        for g, w in zip(br.unpack2_bf16(torch.from_numpy(got[c])),
                        br.unpack2_bf16(torch.from_numpy(want[c]))):
            # padding rows (zero quaternions) hold NaN covariances in both
            g, w = g.numpy(), w.numpy()
            tol = 2.0 ** -6 * np.abs(w) + 1e-6 * np.nanmax(np.abs(w))
            assert ((np.abs(g - w) <= tol)
                    | (np.isnan(g) & np.isnan(w))).all(), c


def _assert_cross_path(img_a, counts_a, img_b, counts_b):
    cut_a, cut_b = int(counts_a[0] + counts_a[1]), int(counts_b[0] + counts_b[1])
    assert cut_a > 0 and abs(cut_a - cut_b) <= max(64, int(0.02 * cut_b))
    assert _psnr(img_a, img_b) > 35.0, _psnr(img_a, img_b)


def test_render_blocks_matches_jax():
    n_roots = 3000
    (params_j, tree_j, leaf_j), (params, tree, leaf), n, cap = _scene(n_roots)
    S = br.block_size_for(cap, target=512)
    assert S == br_jax.block_size_for(cap, target=512) and cap // S > 8
    cols_j, meta_j = br_jax.build_block_cache(params_j, tree_j, leaf_j,
                                              jnp.int32(n), S)
    cols, meta = br.build_block_cache(params, tree, leaf, n, S)
    _assert_cache_close(cols, cols_j)
    for key in meta:
        np.testing.assert_allclose(meta[key].numpy(), np.asarray(meta_j[key]),
                                   rtol=1e-6, err_msg=key)
    pc = _camera(0.4)
    cam, cam_j = camera_device(pc, "cpu"), camera_jax(pc)
    np.testing.assert_array_equal(
        br.block_eligibility(meta, cam, 3.0).numpy(),
        np.asarray(br_jax.block_eligibility(meta_j, cam_j, jnp.float32(3.0))))
    k_vis = next_capacity(n, 256)
    kw = dict(k_blocks=cap // S, k_visible=k_vis, max_pairs=1 << 16)
    img_j, _, counts_j = br_jax.render_blocks(
        cols_j, meta_j, cam_j, jnp.float32(3.0), jnp.int32(20),
        jnp.zeros(3, jnp.float32), H, W, **kw)
    img, alpha, counts = br.render_blocks(cols, meta, cam, 3.0, 20,
                                          torch.zeros(3), H, W, **kw)
    assert counts.shape == (4,) and int(counts[3]) == int(counts_j[3])
    _assert_cross_path(img.numpy(), counts.numpy(), img_j,
                       np.asarray(counts_j))
    # and against the port's own fused flat_slice frame (no cull)
    img_f, _, counts_f, _ = ts.fused_prepare_render(
        params, tree, cam, n, leaf, 3.0, 20, torch.zeros(3),
        **dict(_common(n_roots, n, cap, 0), check_cull=False))
    _assert_cross_path(img.numpy(), counts.numpy(), img_f.numpy(),
                       counts_f.numpy())


def test_block_pruning_is_sound():
    """Eligible blocks only == every block, on a close-up camera that
    prunes a real share of the blocks; a far camera at a coarse LoD prunes
    deep non-root blocks."""
    _, (params, tree, leaf), n, cap = _scene(3000, seed=3)
    S = br.block_size_for(cap, target=64)
    B = cap // S
    cols, meta = br.build_block_cache(params, tree, leaf, n, S)
    cam = camera_device(_camera(1.0, radius=10.0, height=4.0, focal=400.0),
                        "cpu")
    elig = br.block_eligibility(meta, cam, 3.0)
    n_elig = int(elig.sum())
    kb = next_capacity(n_elig, 16)
    assert kb < B

    def run(k_blocks):
        return br.render_blocks(cols, meta, cam, 3.0, 20, torch.zeros(3), H,
                                W, k_blocks=k_blocks,
                                k_visible=next_capacity(n, 256),
                                max_pairs=1 << 16)

    img_all, alpha_all, counts_all = run(B)
    img_p, alpha_p, counts_p = run(kb)
    assert int(counts_p[3]) == n_elig == int(counts_all[3])
    np.testing.assert_array_equal(counts_p[:3].numpy(),
                                  counts_all[:3].numpy())
    np.testing.assert_allclose(img_p.numpy(), img_all.numpy(), atol=5e-3)
    np.testing.assert_allclose(alpha_p.numpy(), alpha_all.numpy(), atol=5e-3)
    cam_far = camera_device(_camera(2.2, radius=80.0, height=40.0,
                                    focal=220.0), "cpu")
    fine = br.block_eligibility(meta, cam_far, 3.0)
    coarse = br.block_eligibility(meta, cam_far, 1e6)
    assert int(coarse.sum()) <= int(fine.sum()) and int(coarse.sum()) < B


def _models(n_roots, jax_too=True):
    ckpt = build_checkpoint(n_roots, seed=1)
    port = load_object("LoG.model.level_of_gaussian.LoG", ARGS, device="cpu")
    models = [port] + ([LoGJax(**ARGS)] if jax_too else [])
    for m in models:
        m.load_state_dict(ckpt)
        m.set_state(active_sh_degree=0, check_render_every=2)
        m.eval()
    return models


def test_optimize_render_layout_matches_jax():
    """The permutation, the tree and the segment starts are exact; the
    frame after the layout change agrees with JAX's and with the port's
    frame before it. (This tree's capacity is below 2^16, so both packages
    keep the fused flat_slice frame, with the cull's segment expansion.)"""
    port, ref = _models(2000)
    pc = _camera(0.7)
    bg = np.zeros(3, np.float32)
    before = port.render_fused(pc, bg)
    port.optimize_render_layout()
    ref.optimize_render_layout()
    for key in ("node_index", "index_parent", "local_index", "depth",
                "root_id", "root_index", "tree"):
        np.testing.assert_array_equal(getattr(port.tree, key),
                                      getattr(ref.tree, key), err_msg=key)
    np.testing.assert_array_equal(port._cull_seg_starts, ref._cull_seg_starts)
    n = port.num_points
    for key, val in port.gaussian.to_numpy().items():
        np.testing.assert_array_equal(val,
                                      np.asarray(ref.gaussian.get(key))[:n])
    _assert_cache_close(port._block_cache["cols"], ref._block_cache["cols"])
    assert "cull_seg_starts" in port.tree_device()
    with pytest.raises(AssertionError):
        port.optimizer = object()
        port.optimize_render_layout()
    port.optimizer = None
    for _ in range(2):  # the buckets settle on the second frame
        after = port.render_fused(pc, bg)
    after_j = ref.render_fused(pc, bg)
    counts_j = np.asarray(ref._render_counts_dev)
    np.testing.assert_array_equal(after["counts"].numpy(), counts_j)
    _assert_cross_path(after["render"].numpy(), after["counts"].numpy(),
                       np.asarray(after_j["render"]), counts_j)
    _assert_cross_path(after["render"].numpy(), after["counts"].numpy(),
                       before["render"].numpy(), before["counts"].numpy())


def test_render_fused_takes_block_path():
    """Capacity >= 2^16, the optimized layout and SH degree 0: render_fused
    runs the block-pruned frame (4 counts) and agrees with the fused
    flat_slice frame of the same camera; SH degree 1 falls back to it."""
    n_roots = 9200
    assert next_capacity(tree_sizes(n_roots)[2]) >= 1 << 16
    (port,) = _models(n_roots, jax_too=False)
    pc = _camera(0.7)
    bg = np.zeros(3, np.float32)
    ref = port.render_fused(pc, bg)
    assert ref["counts"].shape == (3,)
    port.optimize_render_layout()
    for _ in range(3):  # the cull mask is reused on every other frame
        out = port.render_fused(pc, bg)
        assert out["counts"].shape == (4,)
        _assert_cross_path(out["render"].numpy(), out["counts"].numpy(),
                           ref["render"].numpy(), ref["counts"].numpy())
    assert 0 < int(out["counts"][3]) <= port.capacity // port._block_cache["S"]
    port.set_state(active_sh_degree=1)
    assert port.render_fused(pc, bg)["counts"].shape == (3,)
