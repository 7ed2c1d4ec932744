"""The port's benchmark (log_tpu_torch/scripts/bench.py) against bench.py,
on the CPU.

One small scene: JAX's padded_model_device(PRNGKey(0), 2,000 roots, cap,
"root_major") (10,800 points) and the port's pad_scene of the same
unpadded arrays; one orbit of 5 cameras at 64x128 with the focal scaled
from 1,400 at 1920 wide.

- The port's run(device="cpu") on that scene (3 frames, 1 repeat, the four
  cells) gives the counts that JAX's fused_root_cull + fused_prepare_render
  (w_full) and fused_root_cull + render_blocks give with bench.py's
  arguments (bench.py:150-162, 214-231): the sizing frames' leaf and node
  cut and pair demand, and the eligible blocks at the sizing cameras, all
  equal; bench.py's sizing formulas applied to JAX's counts give the
  port's k_vis, max_pairs, k_blocks, cap_sort and n_roots_bucket; the
  realistic search tries bench.py's candidates scaled by the focal against
  300,000 points scaled to the scene's 10,800 and finds the same cut at
  every candidate, so the same pick. JAX's pair budgets are cut from
  bench.py's 1 << 21 and 1 << 19 to 1 << 16, which holds every demand here
  (checked): the counts are unclamped demands, and the interpret-mode
  kernels' cost grows with the budget.
- The JSON line has every key of bench.py's, at the top level and per cell
  (parsed from bench.py's AST); no cell overflows, every frame is finite.
- A budget forced below the first frame's demand is raised, and a slice
  bucket forced below the cut is re-sized: the cell ends with
  budget_rebumped (k_vis_resized) true, no overflow, and its frames keep
  every pair: each equals the frame at a budget and bucket with room to
  spare.
- A cell whose slice bucket or budget cannot be raised past its demand
  raises after the last try, and a failing block cache raises out of
  run: no cell falls back.
"""
import ast
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.model import block_render as br_jax
from log_tpu.model import train_step as ts_jax
from log_tpu.render.renderer import camera_device as camera_jax
from log_tpu.utils.synth_tree import build_scene_device, padded_model_device
from log_tpu_torch.model.gaussian import next_capacity
from log_tpu_torch.ops import pick_max_pairs
from log_tpu_torch.scripts import bench, bench_frame_dissect
from log_tpu_torch.scripts import _common as C
from log_tpu_torch.utils.synth_tree import pad_scene, tree_sizes

REPO = Path(__file__).resolve().parent.parent
N_ROOTS = 2000
H, W = 64, 128
FOCAL = 1400.0 * W / 1920
FRAMES = 3
JAX_BUDGET = 1 << 16
# the re-bump tests' scene (at 32x128: a cut of ~200 points, ~270 pairs)
# and the budget and slice bucket forced below them
SMALL_ROOTS, LOW_BUDGET, LOW_BUCKET = 1000, 128, 64
N = tree_sizes(N_ROOTS)[2]
CAP = next_capacity(N)
# 300,000 points of the 3.24M-point tree, scaled to this scene
TARGET = 300_000 * N // tree_sizes(bench.N_ROOTS)[2]
CANDIDATES = tuple(c * FOCAL / bench.FOCAL for c in bench.FIND_CANDIDATES)
ENV = {"LOG_TPU_PACK_SORT_KEYS": "0"}
UNSET = ("LOG_TPU_QUADFORM", "LOG_TPU_FASTEXP", "LOG_TPU_PACK_PAIRS",
         "LOG_TPU_COMPACT", "LOG_TPU_TILE_H", "LOG_TPU_TILESTART",
         "LOG_TPU_CUMPROD", "LOG_TPU_BACKEND")


def _pinned(mp):
    for name in UNSET:
        mp.delenv(name, raising=False)
    for name, value in ENV.items():
        mp.setenv(name, value)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def unpadded(_one_thread):
    params, tree = build_scene_device(jax.random.PRNGKey(0), N_ROOTS)
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in tree.items()})


def _on_jax_scene(mp, unpadded):
    """The port's bench on JAX's unpadded arrays, padded by pad_scene
    (bench_frame_dissect.make_scene's contract)."""
    def make_scene(n_roots, layout, dev, seed=C.SEED):
        return (*pad_scene(*unpadded, CAP, layout), N, CAP)

    mp.setattr(bench_frame_dissect, "make_scene", make_scene)


@pytest.fixture(scope="module")
def port(unpadded):
    with pytest.MonkeyPatch.context() as mp:
        _pinned(mp)
        _on_jax_scene(mp, unpadded)
        mp.setattr(bench, "REALISTIC_CUT", TARGET)
        return bench.run(N_ROOTS, frames=FRAMES, repeats=1, h=H, w=W,
                         focal=FOCAL, device="cpu")


def _cams():
    return [camera_jax(C.make_cam(2 * math.pi * i / (FRAMES + 2), H, W,
                                  FOCAL))
            for i in range(FRAMES + 2)]


@pytest.fixture(scope="module")
def jax_bench():
    """bench.py's sizing calls on JAX (measure, measure_blocks and
    find_min_res_for_cut), at JAX_BUDGET."""
    with pytest.MonkeyPatch.context() as mp:
        _pinned(mp)
        params, tree, leaf = padded_model_device(jax.random.PRNGKey(0),
                                                 N_ROOTS, CAP, "root_major")
        n_roots_bucket = min(next_capacity(N_ROOTS), CAP)
        cap_sort = min(CAP, -(-N // (1 << 18)) * (1 << 18))
        # at this size the alive bucket is the capacity: bench.py's cull over
        # cap_sort and its full_cap cull are one function
        assert cap_sort == CAP
        cams = _cams()
        common = dict(
            n_alive=jnp.int32(N), is_leaf_opt=leaf,
            current_depth=jnp.int32(20),
            background=jnp.zeros(3, jnp.float32), image_height=H,
            image_width=W, sh_degree=0, stage_has_tree=True, num_levels=3,
            backend="tiled", check_scale=4, cut_method="flat_slice",
            n_roots=n_roots_bucket, prep_backend="tiled",
            prep_max_pairs=JAX_BUDGET, cap_sort=cap_sort)
        culls = {}

        def root_cull(i):
            if i not in culls:
                culls[i] = ts_jax.fused_root_cull(
                    params, tree, cams[i], jnp.int32(N), H, W,
                    prep_backend="tiled", prep_max_pairs=JAX_BUDGET,
                    check_scale=4, n_roots=n_roots_bucket, cap_sort=cap_sort)
            return culls[i]

        def fused(min_res, w_full):
            return np.asarray(ts_jax.fused_prepare_render(
                params, tree, cams[0], k_visible=min(1 << 21, CAP),
                max_pairs=JAX_BUDGET, w_full=w_full,
                min_resolution_pixel=jnp.float32(min_res), **common)[2])

        cuts = {mr: int(fused(mr, None)[:2].sum()) for mr in CANDIDATES}
        pick = next((mr for mr in CANDIDATES if cuts[mr] <= TARGET),
                    CANDIDATES[-1])
        S = br_jax.block_size_for(CAP)
        cols, meta = br_jax.build_block_cache(params, tree, leaf,
                                              jnp.int32(N), S)
        B = CAP // S
        out = {"cuts": cuts, "pick": pick, "B": B,
               "n_roots_bucket": n_roots_bucket, "cap_sort": cap_sort}
        for key, min_res in (("headline", 3.0), ("blocks_cull4", 3.0),
                             ("secondary", pick),
                             ("secondary_blocks_cull4", pick)):
            if "blocks" not in key:
                out[key] = fused(min_res, root_cull(0))
                continue
            c = [np.asarray(br_jax.render_blocks(
                cols, meta, cams[i], jnp.float32(min_res), jnp.int32(20),
                jnp.zeros(3, jnp.float32), H, W, k_blocks=B,
                k_visible=min(1 << 21, CAP), max_pairs=JAX_BUDGET,
                w_full=root_cull(i))[2])
                for i in sorted({min(i, FRAMES + 1)
                                 for i in bench.BLOCK_SIZING_CAMS})]
            out[key] = np.concatenate([c[0][:3], [max(x[3] for x in c)]])
        culled = [int(np.asarray(w).sum()) for w in culls.values()]
    return out, culled


def test_counts_and_sizing_equal_the_jax_bench(port, jax_bench):
    want, culled = jax_bench
    # the cull kept some roots and dropped others
    assert all(0 < k < N for k in culled)
    assert port["capacity"] == CAP and port["cap_sort"] == want["cap_sort"]
    assert port["n_roots_bucket"] == want["n_roots_bucket"]
    assert port["realistic_cut"] == TARGET
    assert port["realistic_cuts"] == {f"{k:g}": v
                                      for k, v in want["cuts"].items()}
    assert port["realistic_min_res"] == want["pick"]
    for key in bench.CELLS:
        cell, c = port[key], want[key]
        assert c[2] < JAX_BUDGET, (key, c)
        assert (cell["cut"], cell["sizing_demand"]) == (int(c[:2].sum()),
                                                        int(c[2])), key
        k_vis = min(next_capacity(int(cell["cut"] * 1.2), 1 << 15), CAP)
        assert cell["k_vis"] == k_vis, key
        if "blocks" in key:
            assert cell["blocks_eligible"] == int(c[3]), key
            assert cell["blocks_total"] == want["B"]
            assert cell["k_blocks"] == min(
                want["B"], max(16, -(-int(int(c[3]) * 1.3) // 16) * 16))
            assert cell["max_pairs"] == pick_max_pairs(
                int(max(int(c[2]), 1) * 1.1), per_point=1), key
        else:
            assert cell["max_pairs"] == min(
                pick_max_pairs(k_vis, per_point=6),
                pick_max_pairs(int(int(c[2]) * 1.1), per_point=1)), key
    assert port["headline"]["min_res_pixel"] == 3.0
    assert port["secondary"]["label"] == (
        f"realistic_minres{want['pick']:g}_cullfirst_perframe")


def _bench_py_keys():
    """The top-level keys of bench.py's JSON line and each cell's (the
    dicts measure and measure_blocks return, with measure_honest's
    budget_rebumped)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    funcs = {f.name: f for f in ast.walk(tree)
             if isinstance(f, ast.FunctionDef)}

    def returned(name):
        keys = set()
        for node in ast.walk(funcs[name]):
            if isinstance(node, ast.Return) and isinstance(node.value,
                                                           ast.Dict):
                keys |= {k.value for k in node.value.keys if k is not None}
        return keys

    top = set()
    for node in ast.walk(funcs["main"]):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
                == "dumps" and isinstance(node.args[0], ast.Dict)):
            for k, v in zip(node.args[0].keys, node.args[0].values):
                top |= {k.value} if k is not None else returned(v.func.id)
    cell = returned("measure") | {"budget_rebumped"}
    assert {"metric", "value", "secondary", "hbm_limit_gb"} <= top
    assert {"label", "fps", "pairs_measured", "cull_every"} <= cell
    return top, cell, returned("measure_blocks")


def test_json_line_has_every_key_of_bench_py(port):
    top, cell, blocks = _bench_py_keys()
    assert top <= set(port), top - set(port)
    assert port["metric"] == f"full_frame_fps_{W}x{H}_{N}pts_tree_cut"
    assert port["headline_label"] == "minres3_cullfirst_perframe"
    assert port["value"] == port["headline"]["fps"]
    assert port["vs_baseline"] == port["value"] / 30.0
    for key in bench.CELLS:
        got = port[key]
        want = cell | (blocks if "blocks" in key else set())
        assert want <= set(got), (key, want - set(got))
        for name in ("ms_per_frame_runs", "device_ms_per_frame",
                     "busy_share", "launches_per_frame", "syncs_per_frame",
                     "top_device_ops", "peak_gb", "cull_pairs"):
            assert name in got, (key, name)
        assert not (got["budget_overflow"] or got["cut_overflow"]
                    or got["blocks_overflow"]), key
        assert got["images_finite"] and got["image_std"] > 0.01, key
        assert got["pairs_measured"] <= got["max_pairs"]
        assert max(got["cut_per_frame"]) <= got["k_vis"]
        assert 0 < got["cull_pairs"] <= got["cull_budget"]
        assert len(got["ms_per_frame_runs"]) == 1
        assert got["cull_every"] == (4 if "blocks" in key else 1)
    assert port["blocks_cull4"]["label"] == "minres3_blocks_cull4"


def _small_headline(mp, patch):
    """The headline cell alone on a 1,000-root scene at 32x128, with a
    sizing helper patched; returns (cell, the last timed camera's frame at
    the cell's bucket and budget, the same frame with room to spare)."""
    _pinned(mp)
    patch(mp)
    seen = {}
    real_cell = bench.timed_cell

    def keep(scene, make_frame, cull, sizes, budget, *args, **kw):
        cell = real_cell(scene, make_frame, cull, sizes, budget, *args, **kw)
        seen.update(scene=scene, make_frame=make_frame, cull=cull,
                    sizes=dict(sizes))
        return cell

    mp.setattr(bench, "timed_cell", keep)
    out = bench.run(SMALL_ROOTS, frames=FRAMES, repeats=1, h=32, w=W,
                    focal=FOCAL, cells=("headline",), device="cpu")
    cell, scene = out["headline"], seen["scene"]
    cam = scene.cams[FRAMES + 1]
    w = seen["cull"](cam)
    got = seen["make_frame"](seen["sizes"])(cam, w, cell["max_pairs"])[0]
    roomy = seen["make_frame"]({"k_vis": scene.cap})(cam, w, 1 << 20)[0]
    return cell, got, roomy


def test_rebump_keeps_every_pair(monkeypatch):
    def low_budget(mp):
        mp.setattr(bench, "fused_budget", lambda k_vis, demand: LOW_BUDGET)

    cell, got, roomy = _small_headline(monkeypatch, low_budget)
    assert cell["sizing_max_pairs"] == LOW_BUDGET < cell["sizing_demand"]
    assert cell["budget_rebumped"] and not cell["budget_overflow"]
    assert cell["pairs_measured"] <= cell["max_pairs"]
    assert not cell["k_vis_resized"]
    assert torch.equal(got, roomy)


def test_cut_past_the_slice_bucket_is_resized(monkeypatch):
    real = bench.k_vis_for
    calls = []

    def small_first(cut, cap):
        calls.append(cut)
        return LOW_BUCKET if len(calls) == 1 else real(cut, cap)

    cell, got, roomy = _small_headline(
        monkeypatch, lambda mp: mp.setattr(bench, "k_vis_for", small_first))
    assert len(calls) == 2 and min(cell["cut_per_frame"]) > LOW_BUCKET
    assert cell["k_vis_resized"] and not cell["cut_overflow"]
    assert cell["k_vis"] == real(calls[1], cell["cap_sort"])
    assert cell["k_vis"] >= max(cell["cut_per_frame"])
    assert not cell["budget_overflow"]
    assert torch.equal(got, roomy)


@pytest.mark.parametrize("bucket", ["k_vis", "max_pairs"])
def test_a_cell_that_still_overflows_raises(bucket, monkeypatch):
    _pinned(monkeypatch)
    if bucket == "k_vis":
        monkeypatch.setattr(bench, "k_vis_for", lambda cut, cap: LOW_BUCKET)
    else:
        monkeypatch.setattr(bench, "fused_budget", lambda k, d: LOW_BUDGET)
        monkeypatch.setattr(C, "budget_for_demand", lambda need: LOW_BUDGET)
    with pytest.raises(RuntimeError, match="still overflowing"):
        bench.run(600, frames=1, repeats=1, h=32, w=W, focal=FOCAL,
                  cells=("headline",), device="cpu")


def test_a_failing_block_cache_raises(monkeypatch):
    from log_tpu_torch.model import block_render

    def broken(*args, **kwargs):
        raise RuntimeError("block cache failed")

    monkeypatch.setattr(block_render, "build_block_cache", broken)
    calls = []
    real = bench.fused_cell
    monkeypatch.setattr(bench, "fused_cell",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    with pytest.raises(RuntimeError, match="block cache failed"):
        bench.run(600, frames=FRAMES, repeats=1, h=32, w=128, focal=FOCAL,
                  device="cpu")
    assert not calls  # no cell ran, so none came back under another label


def test_sizing_helpers_are_bench_py_formulas():
    for cut in (0, 1000, 30_000, 1_605_030, 3_000_000):
        assert bench.k_vis_for(cut, 4_194_304) == min(
            next_capacity(int(cut * 1.2), 1 << 15), 4_194_304)
    for n_elig in (0, 5, 451, 1024):
        assert bench.k_blocks_for(n_elig, 1024) == min(
            1024, max(16, -(-int(n_elig * 1.3) // 16) * 16))
    assert bench.cap_sort_for(3_240_000, 4_194_304) == 3_407_872
    assert bench.n_roots_bucket(600_000, 4_194_304) == 786_432
    assert bench.fused_budget(2_097_152, 3_431_045) == pick_max_pairs(
        int(3_431_045 * 1.1), per_point=1)
    assert bench.fused_budget(32_768, 0) == pick_max_pairs(32_768, 6)
    assert bench.block_budget(0) == pick_max_pairs(1, per_point=1)
    assert tree_sizes(bench.N_ROOTS)[2] == 3_240_000
