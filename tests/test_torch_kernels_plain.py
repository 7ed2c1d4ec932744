"""Plain versions of the port's kernels (K4 pack, K3 expand, K1 composite)
and the binning around them, against log_tpu on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests
do. Integer results (pair counts, keys, sorted order, tile ranges, totals)
and copies (K3, K4) must be bit-exact. The sort-key environment knobs of
the JAX package are pinned: LOG_TPU_PACK_SORT_KEYS=0 selects its exact
(tile, depth, gid) sort, LOG_TPU_TILESTART and LOG_TPU_COMPACT unset.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.dataset.synthetic import random_gaussians, ring_cameras
from log_tpu.ops import expand_pallas as ep_jax
from log_tpu.ops import rasterize_tiled as rt_jax
from log_tpu.ops.projection import project_gaussians as project_jax
from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.ops import rasterize_tiled as rt
from log_tpu_torch.ops.expand import expand_with_keys, expand_with_keys_plain
from log_tpu_torch.ops.projection import Splats
from log_tpu_torch.ops.rasterize_ref import rasterize as rasterize_oracle

H, W = 32, 256  # 2 x 4 tiles of 8 x 128


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    monkeypatch.setenv("LOG_TPU_PACK_SORT_KEYS", "0")
    monkeypatch.delenv("LOG_TPU_TILESTART", raising=False)
    monkeypatch.delenv("LOG_TPU_COMPACT", raising=False)
    monkeypatch.delenv("LOG_TPU_BACKEND", raising=False)


def _scene(n=90, seed=3, extent=0.8):
    rng = np.random.default_rng(seed)
    s = random_gaussians(n, rng, extent=extent)
    pc = prepare_camera(ring_cameras(3, H, W, focal=200.0)[1], 1, 0.01, 100.0)
    tan_fovx = math.tan(pc["FoVx"] * 0.5)
    tan_fovy = math.tan(pc["FoVy"] * 0.5)
    arrays = dict(
        xyz=s["xyz"], colors=s["colors"], opacity=s["opacity"],
        scaling=s["scaling"], rotation=s["rotation"],
        means2d_offset=np.zeros((n, 2), np.float32),
        world_view=pc["world_view_transform"],
        full_proj=pc["full_proj_transform"],
        background=np.asarray([0.1, 0.2, 0.3], np.float32),
    )
    static = dict(focal_x=W / (2 * tan_fovx), focal_y=H / (2 * tan_fovy),
                  tan_fovx=tan_fovx, tan_fovy=tan_fovy, image_height=H,
                  image_width=W)
    return arrays, static


def _jax_splats(arrays, static, tight=True, mask=None):
    return project_jax(
        jnp.asarray(arrays["xyz"]), jnp.asarray(arrays["scaling"]),
        jnp.asarray(arrays["rotation"]), jnp.asarray(arrays["opacity"]),
        jnp.asarray(arrays["world_view"]), jnp.asarray(arrays["full_proj"]),
        use_filter=True, tight_radius=tight,
        active_mask=None if mask is None else jnp.asarray(mask), **static,
    )


def _torch_splats(sj):
    return Splats(*(torch.from_numpy(np.array(f)) for f in sj))


# --------------------------------------------------------------- K4 pack
def test_pack_rows_plain_matches_pallas():
    rng = np.random.default_rng(0)
    A = rt_jax.PACK_CHUNK
    rows = [rng.normal(size=A).astype(np.float32) for _ in range(10)]
    ids = rng.integers(0, 1 << 30, A).astype(np.int32)
    want = np.asarray(rt_jax.pack_rows(
        tuple(jnp.asarray(r) for r in rows) + (jnp.asarray(ids.astype(np.float32)),),
        interpret=True,
    ))
    got = rt.pack_rows([torch.from_numpy(r) for r in rows]
                       + [torch.from_numpy(ids)]).numpy()
    assert got.shape == (16, A + rt.PAIR_CHUNK)
    np.testing.assert_array_equal(got[:10, :A], want[:10, :A])
    # int32 rows are carried as raw bits, exact beyond 2^24
    np.testing.assert_array_equal(got[10, :A].view(np.int32), ids)
    np.testing.assert_array_equal(got[11:], 0.0)
    np.testing.assert_array_equal(got[:, A:], 0.0)
    np.testing.assert_array_equal(want[11:], 0.0)


# ------------------------------------------------------------- K3 expand
def _runs(rng, P, n_valid, A, tiles_x, tiles_y, big=False):
    w = rng.integers(1, tiles_x + 1, P)
    h = rng.integers(1, (tiles_y if big else 3) + 1, P)
    x0 = rng.integers(0, tiles_x - w + 1)
    y0 = rng.integers(0, tiles_y - h + 1)
    counts = np.where(np.arange(P) < n_valid, w * h, 0)
    csum = np.cumsum(counts)
    offs = np.minimum(csum - counts, A).astype(np.int32)
    total = int(min(csum[-1], A))
    geo = (x0 + 32 * (y0 + 512 * w)).astype(np.int32)
    return offs, geo, total, int(csum[-1])


@pytest.mark.parametrize("big", [False, True])
def test_expand_plain_matches_pallas(big):
    """big=True overflows the budget: demand > A, offsets clamp to A."""
    rng = np.random.default_rng(1 + big)
    P, n_valid, A = 1024, 700, 4096
    tiles_x, tiles_y = 4, 16
    offs, geo, total, demand = _runs(rng, P, n_valid, A, tiles_x, tiles_y, big)
    assert (demand > A) == big
    vals = rng.normal(size=(10, P)).astype(np.float32)
    gid = rng.permutation(P).astype(np.int32)
    vals13 = np.concatenate([vals, offs[None].astype(np.float32),
                             geo[None].astype(np.float32),
                             gid[None].astype(np.float32)])
    rows_j, tile_j, depth_j = ep_jax.expand_pallas_with_keys(
        jnp.asarray(vals13), jnp.asarray(offs), jnp.asarray(total), A,
        tiles_x, tiles_x * tiles_y, interpret=True,
    )
    ints = torch.from_numpy(np.stack([offs, geo, gid]))
    got = expand_with_keys(torch.from_numpy(vals), ints,
                           torch.tensor(total, dtype=torch.int32), A,
                           tiles_x, tiles_x * tiles_y)
    rows_j = np.asarray(rows_j)
    # rows are compared up to `total`: past it the pairs are dead (sentinel
    # keys) and the Pallas window leaves zeros in the chunk that straddles
    # `total`, where the port copies the last run
    np.testing.assert_array_equal(got[0].numpy()[:, :total],
                                  rows_j[:10, :total])
    np.testing.assert_array_equal(got[1].numpy()[:, :total],
                                  rows_j[10:13, :total].astype(np.int32))
    np.testing.assert_array_equal(got[2].numpy(),
                                  np.asarray(tile_j).astype(np.int32))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(depth_j))
    # the tail past `total` carries the sentinels
    assert (got[2].numpy()[total:] == tiles_x * tiles_y).all()
    assert (got[3].numpy()[total:] == np.float32(3e38)).all()


def test_expand_wrapper_uses_plain_on_cpu():
    rng = np.random.default_rng(5)
    offs, geo, total, _ = _runs(rng, 64, 40, 512, 2, 4)
    vals = torch.from_numpy(rng.normal(size=(10, 64)).astype(np.float32))
    ints = torch.from_numpy(np.stack([offs, geo, np.arange(64, dtype=np.int32)]))
    t = torch.tensor(total, dtype=torch.int32)
    for a, b in zip(expand_with_keys(vals, ints, t, 512, 2, 8),
                    expand_with_keys_plain(vals, ints, t, 512, 2, 8)):
        assert torch.equal(a, b)
    # past `total` every column copies the last run (zero-length tail runs
    # start at `total`, the last one covers [total, A))
    got = expand_with_keys_plain(vals, ints, t, 512, 2, 8)
    assert (got[0][:, total:] == vals[:, -1:]).all()


# --------------------------------------------------------------- binning
@pytest.mark.parametrize("A", [4096, 512])
def test_binning_matches_jax(A):
    """A = 512 truncates: the demand exceeds the budget."""
    arrays, static = _scene(n=300)
    n = arrays["xyz"].shape[0]
    prefix = np.arange(n) < n - 7
    sj = _jax_splats(arrays, static, mask=prefix)
    gid = (np.arange(n) * 3 + 5).astype(np.int32)
    es_j = rt_jax.expand_sort_pairs(
        sj, jnp.asarray(arrays["colors"]), H, W, A, runs_tail_only=True,
        active_prefix=jnp.asarray(prefix), interpret=True,
        gid_ids=jnp.asarray(gid),
    )
    es = rt.expand_sort_pairs(
        _torch_splats(sj), torch.from_numpy(arrays["colors"]), H, W, A,
        runs_tail_only=True, active_prefix=torch.from_numpy(prefix),
        gid_ids=torch.from_numpy(gid),
    )
    assert int(es["total"]) == int(es_j["total"])
    assert (int(es["total"]) > A) == (A == 512)
    assert es["num_tiles"] == es_j["num_tiles"] == 8
    tile_s = es["tile_s"].numpy()
    np.testing.assert_array_equal(tile_s, np.asarray(es_j["tile_s"]))
    np.testing.assert_array_equal(es["real"].numpy(), np.asarray(es_j["real"]))
    n_real = int((tile_s < 8).sum())
    assert n_real > 100
    np.testing.assert_array_equal(es["gid_s"].numpy()[:n_real],
                                  np.asarray(es_j["gid_s"])[:n_real])
    vals_j = np.stack([np.asarray(v) for v in es_j["values_s"]])
    np.testing.assert_array_equal(es["values_s"].numpy()[:, :n_real],
                                  vals_j[:, :n_real])
    # past the real pairs the order among sentinel-tile pairs is free
    np.testing.assert_array_equal(np.sort(es["gid_s"].numpy()[n_real:]),
                                  np.sort(np.asarray(es_j["gid_s"])[n_real:]))

    pk = rt.pack_sorted_pairs(es["tile_s"], es["gid_s"], es["values_s"],
                              es["tiles_x"], es["tiles_y"])
    pk_j = rt_jax.pack_sorted_pairs(es_j["tile_s"], es_j["gid_s"],
                                    es_j["values_s"], es_j["tiles_x"],
                                    es_j["tiles_y"], interpret=True)
    np.testing.assert_array_equal(pk["tile_start"].numpy(),
                                  np.asarray(pk_j["tile_start"]))
    np.testing.assert_array_equal(pk["tile_count"].numpy(),
                                  np.asarray(pk_j["tile_count"]))
    pd, pd_j = pk["pair_data"].numpy(), np.asarray(pk_j["pair_data"])
    np.testing.assert_array_equal(pd[:10, :n_real], pd_j[:10, :n_real])
    np.testing.assert_array_equal(pd[10, :n_real].view(np.int32),
                                  pd_j[10, :n_real].astype(np.int32))


# ------------------------------------------------------------ K1 composite
def _jax_pairs(A=4096, n=90, seed=3):
    arrays, static = _scene(n=n, seed=seed)
    sj = _jax_splats(arrays, static)
    pk = rt_jax.build_pairs(sj, jnp.asarray(arrays["colors"]), H, W, A,
                            runs_tail_only=True, interpret=True)
    pd = np.array(pk["pair_data"])
    port_pd = pd.copy()
    port_pd[10] = pd[10].astype(np.int32).view(np.float32)
    return pk, pd, port_pd, arrays["background"]


# tolerance against the TPU kernel's math, tightened from the 1e-2 of
# tests/test_rasterize_tiled.py to what holds: with stats it runs the
# cumprod as exp(tri @ log(1 - alpha)) in f32 (1.2e-7 measured); without,
# that matmul and the color accumulation run in bf16 (~0.4% relative,
# 3e-3 measured)
K1_TOL = {False: 5e-3, "weights": 1e-6, True: 1e-6}


@pytest.mark.parametrize("with_stats", [False, "weights", True])
def test_composite_plain_matches_pallas(with_stats):
    pk, pd, port_pd, bg = _jax_pairs()
    tx, ty = pk["tiles_x"], pk["tiles_y"]
    want = rt_jax._run_forward(
        jnp.asarray(pd), pk["tile_start"], pk["tile_count"], jnp.asarray(bg),
        tx, ty, with_stats, True,
    )
    got = rt.rasterize_forward(
        torch.from_numpy(port_pd),
        torch.from_numpy(np.array(pk["tile_start"])),
        torch.from_numpy(np.array(pk["tile_count"])), torch.from_numpy(bg),
        tx, ty, with_stats,
    )
    color, tfinal, pid, pwp, pair_w, cend = (np.asarray(x) for x in want)
    tol = K1_TOL[with_stats]
    np.testing.assert_allclose(got[0].numpy(), color, atol=tol)
    np.testing.assert_allclose(got[1].numpy(), tfinal, atol=tol)
    np.testing.assert_array_equal(got[5].numpy(), cend)
    np.testing.assert_allclose(got[4].numpy(), pair_w[0], atol=tol)
    np.testing.assert_allclose(got[3].numpy(), pwp, atol=tol)
    # argmax contributor: this scene has no weight ties, so ids are equal
    np.testing.assert_array_equal(got[2].numpy(), pid)
    if with_stats is True:
        assert (pid >= 0).mean() > 0.3
    else:
        assert (got[2].numpy() == -1).all() and (pid == -1).all()


# ------------------------------------------------------------ end to end
def test_rasterize_tiled_matches_jax_and_oracle():
    arrays, static = _scene(n=80, seed=11)
    n = arrays["xyz"].shape[0]
    mask = np.arange(n) < n - 9
    kw = dict(max_pairs=4096, runs_tail_only=True, tight_radius=True,
              with_stats=True, use_filter=True)
    got = rt.rasterize_tiled(**{k: torch.from_numpy(np.asarray(v))
                                for k, v in arrays.items()},
                             active_mask=torch.from_numpy(mask), **static, **kw)
    want = rt_jax.rasterize_tiled(**{k: jnp.asarray(v) for k, v in arrays.items()},
                                  active_mask=jnp.asarray(mask), interpret=True,
                                  **static, **kw)
    for key in ("render", "alpha", "point_weight_pixel", "point_weight"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(got["radii"].numpy(), np.asarray(want["radii"]))
    np.testing.assert_array_equal(got["point_id_pixel"].numpy(),
                                  np.asarray(want["point_id_pixel"]))

    # against the port's own oracle: the tiled path bins splats to their
    # (tight) rectangles, the oracle evaluates every pixel, so contributions
    # just outside a rectangle (<= opacity * exp(-4.5)) may differ
    oracle = rasterize_oracle(**{k: torch.from_numpy(np.asarray(v))
                                 for k, v in arrays.items()},
                              active_mask=torch.from_numpy(mask),
                              use_filter=True, **static)
    for key in ("render", "alpha", "point_weight"):
        np.testing.assert_allclose(got[key].numpy(), oracle[key].numpy(),
                                   atol=1e-2, err_msg=key)
    assert (got["point_id_pixel"] != oracle["point_id_pixel"]).float().mean() < 0.02
