"""The port's scale scripts (log_tpu_torch/scripts) on the CPU, small.

Each script's run(device="cpu") completes at a small size (600 roots or
1,000 points, frames of 32x128) with its device-memory fields null, and no
timed frame's pair demand above its budget. `budget_for_demand` and
`tree_sizes` are held against the JAX package. The scripts' scenes are the JAX
scripts' own: bench_trainstep's state and GT against the JAX script's
draws from split(PRNGKey(0), 8) (uniform draws bit for bit, the normal
draws and the logs within 4 ulps of each key's largest value), and the
tree of bench_4k and bench_capacity against padded_model_device(PRNGKey(0),
n, cap, "root_major") (integer arrays exactly, float arrays likewise
within 4 ulps). The capacity script's block frame, fused frame and
tree-stage step, on its scene at 600 roots with the same arrays given to
both packages, are held against log_tpu: the frames to ROADMAP fact o's
packed bound (max 3e-2, at most 0.1% of the pixels past 1e-2, as
tests/test_torch_flat_slice.py), the step to tests/test_torch_train_step.py's
limits (loss to 1e-5, first moments to 1e-3 of each key's largest,
parameters to 1e-6 where the gradient is above 1e-4 of its key's largest,
integer counters equal, float counters to 1e-4).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import log_tpu.ops as ops_jax
from log_tpu.model import block_render as br_jax
from log_tpu.model import train_step as ts_jax
from log_tpu.model.counter import init_counter as init_counter_jax
from log_tpu.model.gaussian import next_capacity as next_capacity_jax
from log_tpu.render.renderer import camera_device as camera_jax
from log_tpu.utils.synth_tree import padded_model_device
from log_tpu.utils.synth_tree import tree_sizes as tree_sizes_jax
from log_tpu_torch import ops
from log_tpu_torch.model.counter import COUNTER_KEYS
from log_tpu_torch.model.gaussian import next_capacity
from log_tpu_torch.scripts import _common as C
from log_tpu_torch.scripts import (bench_4k, bench_capacity, bench_spill,
                                   bench_trainstep)
from log_tpu_torch.utils.synth_tree import build_checkpoint, tree_sizes

from test_torch_train_step import (assert_counters_close,
                                   assert_moments_close, assert_params_close)

H, W = 32, 128
FOCAL = 60.0
SMALL = {
    "bench_trainstep": (bench_trainstep, dict(n_points=1000, steps=1,
                                              warmup=1, focal=30.0)),
    "bench_spill": (bench_spill, dict(n_points=1000, steps=1, warmup=1,
                                      focal=30.0)),
    "bench_4k": (bench_4k, dict(n_roots=600, frames=2, focal=FOCAL)),
    "bench_capacity": (bench_capacity, dict(n_roots=600, frames=2, steps=1,
                                            warmup=1, focal=FOCAL)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors and many ops: one intra-op thread (parallel test
    workers would oversubscribe the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    monkeypatch.setenv("LOG_TPU_PACK_SORT_KEYS", "0")
    for name in ("LOG_TPU_COMPACT", "LOG_TPU_IDENTITY_STEP",
                 "LOG_TPU_PACK_PAIRS", "LOG_TPU_TILESTART"):
        monkeypatch.delenv(name, raising=False)


def test_budget_for_demand_is_the_ladder_without_the_rail():
    """Below the rail the budget is pick_max_pairs(need, per_point=1) of
    both packages; past it the 1.5x steps go on, always holding need."""
    rng = np.random.default_rng(0)
    needs = np.concatenate([[0, 1, 1 << 16, (1 << 16) + 1, 6_291_456,
                             6_291_457, 1 << 23, (1 << 23) + 1, 20_000_000],
                            rng.integers(1, 1 << 25, 200)])
    seen_past = False
    for need in map(int, needs):
        b = ops.budget_for_demand(need)
        assert b >= need and b >= 1 << 16
        if b <= ops.PAIR_RAIL:
            assert b == ops.pick_max_pairs(need, per_point=1)
            assert b == ops_jax.pick_max_pairs(need, per_point=1)
        else:
            seen_past = True
            assert ops.pick_max_pairs(need, per_point=1) == ops.PAIR_RAIL
            assert b < 2.26 * max(need, 1)
    assert seen_past
    ladder = [ops.budget_for_demand(n) for n in range(0, 1 << 26, 1 << 19)]
    assert ladder == sorted(ladder) and ladder[-1] > 1 << 25


@pytest.mark.parametrize("n_roots", [600_000, 1_900_000])
def test_tree_sizes_match_jax(n_roots):
    assert tree_sizes(n_roots) == tree_sizes_jax(n_roots)
    n = tree_sizes(n_roots)[2]
    assert next_capacity(n) == next_capacity_jax(n)
    assert (n, next_capacity(n)) == {
        600_000: (3_240_000, 4_194_304),
        1_900_000: (10_260_000, 12_582_912)}[n_roots]


def test_synthetic_tree_at_a_small_size():
    """build_checkpoint's arrays: float32 parameters, the strided tree and
    root ids that point at roots."""
    ckpt = build_checkpoint(1500, seed=0)
    n = tree_sizes(1500)[2]
    for key in ("xyz", "colors", "scaling", "opacity", "rotation", "shs"):
        arr = ckpt[f"gaussian.{key}"]
        assert arr.dtype == np.float32 and arr.shape[0] == n
        assert np.isfinite(arr).all()
    rid = ckpt["tree.root_id"]
    assert (ckpt["tree.index_parent"][rid] == -1).all()
    assert (ckpt["tree.depth"][rid] == 0).all()


@pytest.mark.parametrize("name", sorted(SMALL))
def test_raises_without_cuda(name, monkeypatch):
    """No silent CPU: without a device argument the scripts ask for the
    card and raise where it is absent."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SMALL[name][0].run()


def _frame_cells(out):
    return [v for v in out.values()
            if isinstance(v, dict) and "demand_per_frame" in v]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_runs_on_the_cpu(name, tmp_path):
    mod, kw = SMALL[name]
    if name == "bench_4k":
        kw = dict(kw, out_dir=str(tmp_path))
    out = mod.run(device="cpu", h=H, w=W, **kw)
    assert out["card"] is None
    for cell in _frame_cells(out):
        assert not cell["budget_overflow"] and not cell["budget_rebumped"]
        assert max(cell["demand_per_frame"]) <= cell["max_pairs"]
        assert 0 < min(cell["cut_per_frame"]) and not cell["cut_overflow"]
        assert len(cell["demand_per_frame"]) == kw["frames"]
    if name == "bench_trainstep":
        assert out["identity"] and out["finite"]
        assert out["peak_bytes"] is None
        assert 0 < out["pairs_measured"] <= out["max_pairs"]
    elif name == "bench_spill":
        assert out["modes_agree"]
        for mode in bench_spill.MODES:
            assert out[mode]["peak_bytes"] is None and out[mode]["finite"]
        assert out["device"]["h2d_bytes_per_step"] == 0
        sq, both = out["spill_sq"], out["spill_both"]
        assert sq["h2d_bytes_per_step"] == sq["d2h_bytes_per_step"] > 0
        assert both["h2d_bytes_per_step"] == 2 * sq["h2d_bytes_per_step"]
    elif name == "bench_4k":
        assert out["tiles"] == [1, 4]
        assert len(out["minres96"]["frames_written"]) == 2
        van = out["vanilla_close"]
        assert not van["budget_overflow"] and van["finite"]
        assert van["pairs_measured"] > 0
    else:
        for key in ("memory_at_rest", "memory_with_block_cache",
                    "memory_after_render"):
            assert out[key] is None
        assert out["train"]["peak_bytes"] is None and out["train"]["finite"]
        assert out["train"]["pairs_measured"] > 0
        assert out["spill"] == {"engaged": False,
                                "threshold_points": 50_000_000,
                                "threshold_points_full": 100_000_000}
        assert bench_capacity.spill_check(10_260_000)["engaged"] is False


def test_4k_grid_fits_the_rect_geometry():
    assert bench_4k.check_grid(2160, 3840) == (30, 270)
    with pytest.raises(AssertionError):
        bench_4k.check_grid(2160, 4224)


# ------------------------------------------ the JAX scripts' own scenes
def _ulps(got, want, key):
    """got within 4 ulps of want's largest magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, key
    gap = np.abs(got.astype(np.float64) - want).max()
    assert gap <= 4 * np.spacing(np.abs(want).max()), (key, gap)


def test_trainstep_state_is_the_jax_scripts():
    """make_state and random_gt against scripts/bench_trainstep.py's
    gen_state and GT, rebuilt here from the same keys."""
    cap, h, w = next_capacity(1000), 24, 40
    ks = jax.random.split(jax.random.PRNGKey(0), 8)

    @jax.jit
    def gen_state():
        ext = 12.0
        xyz = jnp.stack([
            jax.random.uniform(ks[0], (cap,), minval=-ext, maxval=ext),
            jax.random.uniform(ks[1], (cap,), minval=-ext, maxval=ext),
            jax.random.uniform(ks[2], (cap,), minval=0.0, maxval=2.0),
        ], axis=1)
        scal = jnp.log(
            jax.random.uniform(ks[3], (cap, 3), minval=0.05, maxval=0.3))
        q = jax.random.normal(ks[4], (cap, 4))
        opac = jax.random.uniform(ks[5], (cap, 1), minval=0.3, maxval=0.9)
        return {"xyz": xyz,
                "colors": jax.random.uniform(ks[6], (cap, 3)) * 2 - 1,
                "scaling": scal, "opacity": jnp.log(opac / (1 - opac)),
                "rotation": q / jnp.linalg.norm(q, axis=1, keepdims=True),
                "shs": jnp.zeros((cap, 3, 3))}

    want = gen_state()
    got = bench_trainstep.make_state(cap, "cpu")
    assert set(got) == set(want)
    np.testing.assert_array_equal(bench_trainstep.state_keys(),
                                  np.asarray(ks))
    for k in ("xyz", "colors", "shs"):  # uniform draws: bit for bit
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("scaling", "opacity", "rotation"):
        _ulps(got[k].numpy(), want[k], k)
    gt_j = jax.jit(lambda: (jax.random.uniform(ks[7], (3, h, w)) * 255)
                   .astype(jnp.uint8))()
    gt = bench_trainstep.random_gt(h, w, "cpu", bench_trainstep.state_keys()[7])
    assert gt.dtype == torch.uint8
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gt_j))
    assert len(np.unique(gt.numpy())) > 200


def test_scale_scene_is_padded_model_device():
    """The tree of bench_4k and bench_capacity (_common.PaddedTree) against
    scripts/bench_4k.py:82-84's padded_model_device(PRNGKey(0), n_roots,
    cap, "root_major"), every array of the parameters and the tree."""
    n_roots = 1000
    tree = C.PaddedTree(n_roots, "cpu")
    n = tree_sizes_jax(n_roots)[2]
    cap = next_capacity_jax(n)
    assert (tree.n, tree.cap) == (n, cap)
    assert tree.n_roots == min(next_capacity_jax(n_roots), cap)
    assert tree.num_levels == 3  # the JAX capacity script's num_levels
    params_j, tree_j, leaf_j = padded_model_device(
        jax.random.PRNGKey(0), n_roots, cap, "root_major")
    np.testing.assert_array_equal(tree.leaf.numpy(), np.asarray(leaf_j))
    assert set(tree.tree) == set(tree_j) and set(tree.params) == set(params_j)
    for k, v in tree_j.items():
        if np.issubdtype(np.asarray(v).dtype, np.integer):
            np.testing.assert_array_equal(tree.tree[k].numpy(),
                                          np.asarray(v), err_msg=k)
        else:
            _ulps(tree.tree[k].numpy(), v, k)
    for k, v in params_j.items():
        _ulps(tree.params[k].numpy(), v, k)
    np.testing.assert_array_equal(tree.params["colors"].numpy(),
                                  np.asarray(params_j["colors"]))
    tree.build_block_cache()
    assert tree.block_cache["S"] == br_jax.block_size_for(cap)


# ------------------------------------- the capacity cells against log_tpu
N_ROOTS = 600
XH, XW, XFOCAL = 64, 256, 120.0  # a cut with leaves at min_res 3


def _trees():
    """The capacity script's scene at N_ROOTS (_common.PaddedTree with its
    block cache) and the same arrays in JAX with the JAX script's block
    cache (scripts/bench_capacity.py: build_block_cache on the padded
    root_major arrays)."""
    port = C.PaddedTree(N_ROOTS, "cpu")
    port.build_block_cache()
    params_j = {k: jnp.asarray(v.numpy()) for k, v in port.params.items()}
    tree_j = {k: jnp.asarray(v.numpy()) for k, v in port.tree.items()}
    leaf_j = jnp.asarray(port.leaf.numpy())
    cols_j, meta_j = br_jax.build_block_cache(
        params_j, tree_j, leaf_j, jnp.int32(port.n),
        br_jax.block_size_for(port.cap))
    return port, (params_j, tree_j, leaf_j, cols_j, meta_j)


def _cams(n):
    pcs = [C.make_cam(2 * math.pi * i / n, XH, XW, XFOCAL) for i in range(n)]
    return C.orbit(n, XH, XW, XFOCAL, "cpu"), [camera_jax(pc) for pc in pcs]


def _assert_packed_close(got, want):
    d = np.abs(np.asarray(got) - np.asarray(want))
    assert float(d.max()) < 3e-2, d.max()
    assert float((d > 1e-2).mean()) < 1e-3, (d > 1e-2).mean()


def test_capacity_cells_match_jax():
    port, (params_j, tree_j, leaf_j, cols_j, meta_j) = _trees()
    dev = torch.device("cpu")
    cams, cams_j = _cams(4)
    n, cap = port.n, port.cap

    def cull_j(cam_j, cap_sort):
        return ts_jax.fused_root_cull(
            params_j, tree_j, cam_j, jnp.int32(n), XH, XW,
            prep_backend="tiled",
            prep_max_pairs=ops_jax.pick_max_pairs(cap, per_point=1),
            check_scale=C.CHECK_SCALE, n_roots=port.n_roots,
            cap_sort=cap_sort)

    # the block frame, at the cell's own buckets and budget
    cell, (frame, cull) = C.block_cell(port, cams, 3.0, 2, 4, dev,
                                       sizing=(1, 2))
    w = cull(cams[2])
    w_j = cull_j(cams_j[2], 0)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    img, counts = frame(cams[2], w, cell["max_pairs"])
    img_j, _, counts_j = br_jax.render_blocks(
        cols_j, meta_j, cams_j[2],
        jnp.float32(3.0), jnp.int32(C.CURRENT_DEPTH),
        jnp.zeros(3, jnp.float32), XH, XW, k_blocks=cell["k_blocks"],
        k_visible=cell["k_vis"], max_pairs=cell["max_pairs"], w_full=w_j)
    counts_j = np.asarray(counts_j)
    assert int(counts[3]) == int(counts_j[3])
    assert abs(int(counts[0] + counts[1]) - int(counts_j[:2].sum())) <= max(
        64, int(0.02 * counts_j[:2].sum()))
    _assert_packed_close(img.numpy(), img_j)

    # the fused flat_slice frame
    cell_f, (frame_f, cull_f) = bench_capacity.fused_cell(port, cams, 96.0,
                                                          2, 4, dev)
    w = cull_f(cams[2])
    w_j = cull_j(cams_j[2], cell_f["cap_sort"])
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    img, counts = frame_f(cams[2], w, cell_f["max_pairs"])
    img_j, _, counts_j = ts_jax.fused_prepare_render(
        params_j, tree_j, cams_j[2], jnp.int32(n), leaf_j,
        jnp.float32(96.0), jnp.int32(C.CURRENT_DEPTH),
        jnp.zeros(3, jnp.float32), XH, XW, k_visible=cell_f["k_vis"],
        sh_degree=0, stage_has_tree=True, num_levels=port.num_levels,
        backend="tiled", max_pairs=cell_f["max_pairs"],
        check_scale=C.CHECK_SCALE, cut_method="flat_slice",
        n_roots=port.n_roots,
        prep_backend="tiled",
        prep_max_pairs=ops_jax.pick_max_pairs(cap, per_point=1),
        cap_sort=cell_f["cap_sort"], w_full=w_j)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    _assert_packed_close(img.numpy(), img_j)
    assert float(img.std()) > 0.01

    # one tree-stage step; at min_res 3, so that the cut holds leaves (the
    # rows a tree-stage step updates), with buckets that hold every row
    step, state, cfg = bench_capacity.make_step(port, cams, n, n, dev,
                                                min_res=3.0)
    # the JAX script's GT: the port's step must have drawn the same
    gt_j = (jax.random.uniform(jax.random.PRNGKey(bench_capacity.GT_SEED),
                               (3, XH, XW)) * 255).astype(jnp.uint8)
    met = step(0, cfg)
    moments_j = {mk: {k: jnp.zeros_like(v) for k, v in params_j.items()}
                 for mk in ("exp_avg", "exp_avg_sq")}
    corr = {"values": jnp.ones((1, 3)), "m1": jnp.zeros((1, 3)),
            "m2": jnp.zeros((1, 3)), "vmax": jnp.zeros((1, 3)),
            "steps": jnp.zeros((1,), jnp.int32)}
    p_j, m_j, c_j, _, met_j, _ = ts_jax.fused_prepare_train_step(
        params_j, moments_j,
        {k: jnp.asarray(v) for k, v in init_counter_jax(cap).items()},
        tree_j, jnp.int32(n), leaf_j, jnp.float32(3.0),
        jnp.int32(C.CURRENT_DEPTH), cams_j[0], gt_j,
        jnp.zeros(3), {k: jnp.float32(1e-3) for k in params_j},
        jnp.float32(1), corr, jnp.int32(0), jnp.ones((1, 1, 1)),
        jnp.ones((1, 1)), jax.random.PRNGKey(1), stage_has_tree=True,
        num_levels=port.num_levels, prep_backend="tiled",
        prep_max_pairs=ops_jax.pick_max_pairs(cap),
        check_scale=C.CHECK_SCALE,
        cfg=ts_jax.StepConfig(
            image_height=XH, image_width=XW, k_leaf=cfg.k_leaf,
            k_node=cfg.k_node, sh_degree=0, mode="antialias",
            backend="tiled", max_pairs=cfg.max_pairs),
        cut_method="flat", n_roots=port.n_roots)
    assert int(met["counts"][0]) > 100 and int(met["pair_total"]) > 0
    assert abs(float(met["loss"]) - float(met_j["loss"])) <= 1e-5
    assert_moments_close(state[1], m_j, n)
    # SH degree 0: the SH rows get no gradient in either package
    assert_params_close(state[0], {k: v for k, v in p_j.items()
                                   if k != "shs"}, m_j, n)
    assert_counters_close({k: state[2][k] for k in COUNTER_KEYS}, c_j, n)
