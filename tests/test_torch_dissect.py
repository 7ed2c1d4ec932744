"""The port's dissection and probe scripts (log_tpu_torch/scripts) and the
stage chains they time, on the CPU.

- The stage chains equal the functions they make up, bit for bit: the
  flat_slice frame (per-frame slice cull, and the cached cull mask), the
  block-pruned frame and the root cull, each run stage by stage as
  `_common.stage_chain` runs it and against `fused_prepare_render`,
  `render_blocks` and `fused_root_cull`; a stage replayed on its saved
  state gives its output again; the train-step dissector's `full` prefix
  equals `fused_prepare_train_step` (loss, parameters, moments, counters;
  checked inside its run).
- bench_frame_dissect, bench_trainstep_dissect and bench_kernel complete
  at a small size with no timed call past its budget.
- bench_kernel's tables equal the JAX script's construction (tile of each
  pair, starts, counts, the depth row), and the plain K1 on one small
  table agrees with log_tpu's `_raster_core` in interpret mode within
  tests/test_torch_kernels_plain.py's tolerance (5e-3 without stats: the
  JAX kernel composites in bf16).
- `Corrector.get` / `step` equal log_tpu's over 120 steps to 1e-6.
- check_sharded_fullscale's bucket overflow and exchange-length matrix at
  2 gloo ranks on a tiny tree equal log_tpu's sharded render on the
  2-device virtual mesh, exactly.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.model.corrector import Corrector as CorrectorJax
from log_tpu.ops import rasterize_tiled as rt_jax
from log_tpu_torch.model import train_step as ts
from log_tpu_torch.model.block_render import (block_size_for, block_stages,
                                              build_block_cache,
                                              render_blocks)
from log_tpu_torch.model.corrector import Corrector
from log_tpu_torch.model.gaussian import next_capacity
from log_tpu_torch.ops import rasterize_tiled as rt
from log_tpu_torch.scripts import _common as C
from log_tpu_torch.scripts import (bench_frame_dissect, bench_kernel,
                                   bench_trainstep_dissect,
                                   check_sharded_fullscale)
from log_tpu_torch.utils import jax_random
from log_tpu_torch.utils.synth_tree import build_scene, pad_scene, tree_sizes

H, W, FOCAL = 64, 256, 120.0
N_ROOTS = 1500


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    for name in ("LOG_TPU_COMPACT", "LOG_TPU_IDENTITY_STEP",
                 "LOG_TPU_PACK_PAIRS", "LOG_TPU_TILESTART"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def scene():
    n = tree_sizes(N_ROOTS)[2]
    cap = next_capacity(n)
    params, tree, leaf = pad_scene(
        *build_scene(N_ROOTS, jax_random.prng_key(5), "cpu"), cap,
        "root_major")
    return params, tree, leaf, n, cap


def _cam(theta=0.7):
    return C.camera_device(C.make_cam(theta, H, W, FOCAL), "cpu")


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("cached_cull", [False, True])
def test_flat_slice_chain_equals_fused_prepare_render(scene, cached_cull):
    params, tree, leaf, n, cap = scene
    cam = _cam()
    R = next_capacity(N_ROOTS, 256)
    w_full = (ts.fused_root_cull(params, tree, cam, n, H, W,
                                 prep_max_pairs=1 << 16, check_scale=4,
                                 n_roots=R) if cached_cull else None)
    kw = dict(k_visible=next_capacity(n, 256), max_pairs=1 << 16,
              check_scale=4, n_roots=R, prep_max_pairs=1 << 16)
    want = ts.fused_prepare_render(
        params, tree, cam, n, leaf, 3.0, 20, torch.zeros(3), H, W,
        sh_degree=0, stage_has_tree=True, num_levels=3,
        cut_method="flat_slice", w_full=w_full, **kw)
    stages = ts.flat_slice_stages(
        params, tree, cam, n, leaf, 3.0, 20, torch.zeros(3), H, W,
        kw["k_visible"], 0, "antialias", kw["max_pairs"], 4, R, "tiled",
        kw["prep_max_pairs"], False, not cached_cull, w_full)
    assert [s for s, _ in stages] == ["cut", "act", "compact", "check",
                                      "pairs", "kernel"]
    snaps = C.stage_chain(stages)
    s = snaps[-1]
    assert _same((s["render"], s["alpha"], s["counts"], s["pair_total"]),
                 want)
    assert int(want[2][0] + want[2][1]) > 500 and float(want[0].std()) > 0.01
    # a stage replayed on its saved state gives its output again
    i = [name for name, _ in stages].index("pairs")
    again = dict(snaps[i])
    stages[i][1](again)
    assert _same(again["pairs"][:3], s["pairs"][:3])


def test_block_and_cull_chains_equal_their_functions(scene):
    params, tree, leaf, n, cap = scene
    cam = _cam(1.9)
    R = next_capacity(N_ROOTS, 256)
    cull = ts.root_cull_stages(params, tree, cam, n, H, W,
                               prep_max_pairs=1 << 16, check_scale=4,
                               n_roots=R)
    w_full = C.stage_chain(cull)[-1]["w_full"]
    assert torch.equal(w_full, ts.fused_root_cull(
        params, tree, cam, n, H, W, prep_max_pairs=1 << 16, check_scale=4,
        n_roots=R))
    S = block_size_for(cap, 1024)
    cols, meta = build_block_cache(params, tree, leaf, n, S)
    args = (cols, meta, cam, 3.0, 20, torch.zeros(3), H, W, cap // S,
            next_capacity(n, 256), 1 << 16, w_full)
    s = C.stage_chain(block_stages(*args))[-1]
    want = render_blocks(*args)
    assert _same((s["render"], s["alpha"], s["counts"]), want)
    assert int(want[2][3]) > 0 and float(want[0].std()) > 0.01


def test_frame_dissect_runs_small():
    out = bench_frame_dissect.run(
        phases=("stages", "blocks", "cull", "demand"), n_roots=600,
        reps=1, h=32, w=128, focal=60.0, device="cpu")
    fs, bl = out["flat_slice"], out["blocks"]
    assert fs["chain_equal"] and bl["chain_equal"]
    assert not out["budget_overflow"]
    assert fs["demand"] <= fs["max_pairs"] and bl["demand"] <= bl["max_pairs"]
    assert [r["stage"] for r in fs["stages"]] == [
        "cut", "act", "compact", "compact_k6", "check", "pairs", "kernel"]
    assert {r["stage"] for r in fs["phases"]} == {
        "full", "prefix23", "nocheck", "f2nok", "fused2", "nocull", "check8"}
    for row in fs["stages"] + bl["stages"] + [fs["sum"]]:
        assert row["host_ms"] >= 0 and row["device_ms"] is None
    assert out["cull"]["branches_equal_on_alive_rows"]
    assert out["cull"]["has_seg_starts"]
    assert {(r["tile_h"], r["bbox"]) for r in out["demand"]["rows"]} == {
        (t, b) for t in (8, 16, 32) for b in (False, True)}


def test_trainstep_dissect_runs_small():
    """The prefixes at a small size; the full prefix's result (loss,
    parameters, moments, counters) equals fused_prepare_train_step's bit
    for bit after a warm-up step ("full_equals_step")."""
    out = bench_trainstep_dissect.run(n_points=500, reps=1, warmup=1, h=32,
                                      w=128, focal=30.0, device="cpu")
    assert [r["stage"] for r in out["prefixes"]] == list(
        bench_trainstep_dissect.PREFIXES)
    assert not out["budget_overflow"] and out["full_equals_step"]
    assert out["pairs_measured"] <= out["max_pairs"]
    assert set(out["itemized"]) == {"prep", "compact", "render_fwd",
                                    "ssim_fwd", "render_bwd",
                                    "optimizer_tail", "ssim_bwd_extra"}


def _jax_tables(tiles_x, tiles_y, cpt, opac, px, py):
    """scripts/bench_kernel.py's make_pairs with its draws replaced by the
    given px, py (jax.random's bits cannot be reproduced)."""
    num_tiles = tiles_x * tiles_y
    A = num_tiles * cpt * rt_jax.PAIR_CHUNK
    tile_of = jnp.arange(A, dtype=jnp.int32) // (cpt * rt_jax.PAIR_CHUNK)
    inv = 1.0 / (6.0 ** 2)
    rows = [px, py, jnp.full((A,), inv), jnp.zeros((A,)), jnp.full((A,), inv),
            jnp.full((A,), float(opac)), jnp.full((A,), 0.7),
            jnp.full((A,), 0.4), jnp.full((A,), 0.2),
            jnp.arange(A, dtype=jnp.float32), jnp.zeros((A,))]
    A2 = ((A + (1 << 15) - 1) // (1 << 15)) * (1 << 15)
    rows = [jnp.pad(r, (0, A2 - A)) for r in rows]
    starts = jnp.arange(num_tiles, dtype=jnp.int32) * (cpt * rt_jax.PAIR_CHUNK)
    counts = jnp.full((num_tiles,), cpt * rt_jax.PAIR_CHUNK, jnp.int32)
    return tile_of, rows, starts, counts


def test_bench_kernel_tables_match_jax():
    tiles_x, tiles_y, cpt, opac = 2, 2, 2, 0.9
    gen = torch.Generator().manual_seed(0)
    rows, starts, counts, A = bench_kernel.make_pairs(tiles_x, tiles_y, cpt,
                                                      opac, gen, "cpu")
    tile_of, _, _ = bench_kernel.tile_tables(tiles_x * tiles_y, cpt, "cpu")
    tile_j, rows_j, starts_j, counts_j = _jax_tables(
        tiles_x, tiles_y, cpt, opac, jnp.asarray(rows[0][:A].numpy()),
        jnp.asarray(rows[1][:A].numpy()))
    np.testing.assert_array_equal(tile_of.numpy(), np.asarray(tile_j))
    np.testing.assert_array_equal(starts.numpy(), np.asarray(starts_j))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    for r in range(2, 11):  # the deterministic rows, depth (9) among them
        np.testing.assert_array_equal(rows[r].numpy(), np.asarray(rows_j[r]))
    # the draws: each pair near its own tile's centre
    ty, tx = tile_of // tiles_x, tile_of % tiles_x
    assert (rows[0][:A] - (tx * 128 + 64)).abs().max() <= 40
    assert (rows[1][:A] - (ty * 8 + 4)).abs().max() <= 3
    bg = torch.zeros(3)
    got = rt.rasterize_forward(rt.pack_rows(rows), starts, counts, bg,
                               tiles_x, tiles_y, False)
    want = rt_jax._raster_core(rt_jax.pack_rows(tuple(rows_j), True),
                               starts_j, counts_j, jnp.zeros(3), tiles_x,
                               tiles_y, False, True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=5e-3)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=5e-3)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want[5]))
    assert float(got[0].std()) > 0.01


def test_bench_kernel_runs_small():
    out = bench_kernel.run(cpts=(1, 2), reps=1, h=16, w=256, device="cpu")
    assert [(r["chunks_per_tile"], r["exit"]) for r in out["rows"]] == [
        (1, "no exit"), (1, "fast exit"), (2, "no exit"), (2, "fast exit")]
    assert all(r["chunks_composited_mean"] <= r["chunks_per_tile"]
               for r in out["rows"])


def test_corrector_get_and_step_match_jax():
    rng = np.random.default_rng(11)
    got, want = Corrector(True), CorrectorJax(True)
    for c in (got, want):
        c.init(4)
    np.testing.assert_array_equal(got.get(2), want.get(2))
    for i in range(120):
        view = int(rng.integers(0, 5))  # 4 is past the table: no update
        grad = rng.standard_normal(3).astype(np.float32) * 0.1
        got.step(view, grad)
        want.step(view, grad)
        for v in range(4):
            np.testing.assert_allclose(got.get(v), want.get(v), rtol=0,
                                       atol=1e-6)
    np.testing.assert_array_equal(got.steps, want.steps)
    assert np.isfinite(got.values).all() and not np.allclose(got.values, 1.0)
    empty = Corrector(False)
    np.testing.assert_array_equal(empty.get(0), np.ones(3, np.float32))
    empty.step(0, np.ones(3, np.float32))
    assert empty.values.shape == (0, 3)


def test_check_sharded_fullscale_matches_jax_at_2_ranks():
    from log_tpu.parallel import sharded_render as sr_jax
    from log_tpu.render.renderer import camera_device as camera_jax
    from log_tpu.utils.synth_tree import padded_model_device
    from log_tpu.utils.synth_tree import tree_sizes as tree_sizes_jax

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    n_roots, frames = 600, 1
    n = tree_sizes_jax(n_roots)[2]
    cap = next_capacity(n)
    params_j, tree_j, _ = padded_model_device(jax.random.PRNGKey(3), n_roots,
                                              cap, "root_major")
    scene = ({k: np.array(v) for k, v in params_j.items()},
             {k: np.array(v) for k, v in tree_j.items()}, n)
    out = check_sharded_fullscale.run(
        n_roots, frames, 2, h=H, w=W, focal=FOCAL, threads=1, scene=scene,
        timeout_s=300, device="cpu")
    assert out["max_overflow"] == 0 and out["ranks_agree"]
    cfg_j = sr_jax.ShardedRenderConfig(**out["config"])
    p2 = sr_jax.interleave_shard_rows(params_j, 2)
    t2 = sr_jax.interleave_shard_rows(tree_j, 2)
    for i, fr in enumerate(out["frames"]):
        cam = C.make_cam(2 * math.pi * i / 32, H, W, FOCAL)
        _, _, stats_j = sr_jax.sharded_render_frame(
            p2, t2, camera_jax(cam), n, 3.0, 20, jnp.zeros(3), cfg_j)
        stats_j = np.asarray(stats_j)
        assert fr["bucket_overflow"] == int(stats_j[2]) == 0
        np.testing.assert_array_equal(np.array(fr["lens"]).reshape(-1),
                                      stats_j[3:])
        assert [fr["cut"], fr["pairs_exchanged"]] == stats_j[:2].tolist()
        assert fr["pairs_exchanged"] > 0
