"""The port's rasterizer backward (K2's plain version and the autograd chain
through K1, K4, the sort and K3) against log_tpu on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do;
LOG_TPU_PACK_SORT_KEYS=0 pins its exact (tile, depth, gid) pair sort.

Tolerances: K2's plain version computes the TPU kernel's recurrence with a
cumprod where the TPU kernel takes exp(triangular @ log(1 - alpha)), so the
two agree to f32 rounding (1e-4 of the largest gradient). The end-to-end
gradients agree with jax.grad to 1e-3 of the largest; against the port's
own oracle rasterizer the JAX suite's 2e-2 applies (the tiled path bins
splats to their rectangles, the oracle evaluates every pixel).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.dataset.base import prepare_camera as prepare_camera_jax
from log_tpu.dataset.synthetic import random_gaussians, ring_cameras
from log_tpu.ops import rasterize_tiled as rt_jax
from log_tpu.ops.projection import project_gaussians as project_jax
from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.ops import rasterize_tiled as rt
from log_tpu_torch.ops.rasterize_ref import rasterize as rasterize_oracle

H, W = 32, 256  # 2 x 4 tiles of 8 x 128


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    monkeypatch.setenv("LOG_TPU_PACK_SORT_KEYS", "0")
    monkeypatch.delenv("LOG_TPU_TILESTART", raising=False)
    monkeypatch.delenv("LOG_TPU_COMPACT", raising=False)
    monkeypatch.delenv("LOG_TPU_BACKEND", raising=False)


def _camera(h, w, focal=200.0):
    pc = prepare_camera(ring_cameras(3, h, w, focal=focal)[1], 1, 0.01, 100.0)
    tx = math.tan(pc["FoVx"] * 0.5)
    ty = math.tan(pc["FoVy"] * 0.5)
    return pc, dict(focal_x=w / (2 * tx), focal_y=h / (2 * ty), tan_fovx=tx,
                    tan_fovy=ty, image_height=h, image_width=w)


def _backward_case(n=120, seed=4, A=4096):
    """JAX pairs, its forward (for tfinal and cend) and random cotangents."""
    rng = np.random.default_rng(seed)
    s = random_gaussians(n, rng, extent=0.8)
    pc, static = _camera(H, W)
    sj = project_jax(
        jnp.asarray(s["xyz"]), jnp.asarray(s["scaling"]),
        jnp.asarray(s["rotation"]), jnp.asarray(s["opacity"]),
        jnp.asarray(pc["world_view_transform"]),
        jnp.asarray(pc["full_proj_transform"]), use_filter=True, **static,
    )
    pk = rt_jax.build_pairs(sj, jnp.asarray(s["colors"]), H, W, A,
                            interpret=True)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    tx, ty = pk["tiles_x"], pk["tiles_y"]
    _, tfinal, _, _, _, cend = rt_jax._run_forward(
        pk["pair_data"], pk["tile_start"], pk["tile_count"], jnp.asarray(bg),
        tx, ty, True, True,
    )
    Hp, Wp = tfinal.shape
    dcolor = rng.normal(size=(3, Hp, Wp)).astype(np.float32)
    dalpha = rng.normal(size=(Hp, Wp)).astype(np.float32)
    return pk, np.asarray(tfinal), np.asarray(cend), dcolor, dalpha, bg


def test_backward_plain_matches_pallas():
    pk, tfinal, cend, dcolor, dalpha, bg = _backward_case()
    tx, ty = pk["tiles_x"], pk["tiles_y"]
    want = np.asarray(rt_jax._run_backward(
        pk["pair_data"], pk["tile_start"], pk["tile_count"],
        jnp.asarray(cend), jnp.asarray(tfinal), jnp.asarray(dcolor),
        jnp.asarray(dalpha), jnp.asarray(bg), tx, ty, True,
    ))
    pd = np.array(pk["pair_data"])
    pd[10] = pd[10].astype(np.int32).view(np.float32)  # port: raw id bits
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = rt.rasterize_backward(
        t(pd), t(np.asarray(pk["tile_start"])),
        t(np.asarray(pk["tile_count"])), t(cend), t(tfinal), t(dcolor),
        t(dalpha), t(bg), tx, ty,
    ).numpy()
    assert got.shape == want.shape == pd.shape
    scale = np.abs(want[:9]).max()
    assert scale > 0 and (np.abs(want[:9]) > 1e-3 * scale).sum() > 300
    np.testing.assert_allclose(got[:9], want[:9], atol=1e-4 * scale, rtol=0)
    np.testing.assert_array_equal(got[9:], 0.0)


def test_backward_plain_stops_at_cend():
    """Pairs past a tile's composited chunks get no gradient (their weight
    and transmittance suffix are zero in the forward that stopped there)."""
    pk, tfinal, cend, dcolor, dalpha, bg = _backward_case(n=400, seed=6,
                                                          A=8192)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    pd = np.array(pk["pair_data"])
    pd[10] = pd[10].astype(np.int32).view(np.float32)
    args = (t(pd), t(np.asarray(pk["tile_start"])),
            t(np.asarray(pk["tile_count"])))
    full = rt.rasterize_backward(*args, t(cend), t(tfinal), t(dcolor),
                                 t(dalpha), t(bg), pk["tiles_x"],
                                 pk["tiles_y"]).numpy()
    cut = rt.rasterize_backward(*args, t(np.minimum(cend, 1)), t(tfinal),
                                t(dcolor), t(dalpha), t(bg), pk["tiles_x"],
                                pk["tiles_y"]).numpy()
    start = np.asarray(pk["tile_start"])
    first = (start // rt.PAIR_CHUNK + 1) * rt.PAIR_CHUNK  # end of chunk 0
    for ti in np.flatnonzero(cend > 1):
        cols = np.arange(first[ti], start[ti] + np.asarray(pk["tile_count"])[ti])
        np.testing.assert_array_equal(cut[:, cols], 0.0)
    assert np.abs(full).max() > 0


# ------------------------------------------------- end-to-end gradients
def _smooth_scene(h=32, w=48, n=8, seed=5):
    """The JAX suite's gradient scene (tests/test_rasterize_tiled.py):
    every gaussian covers the image above the alpha cutoff."""
    rng = np.random.default_rng(seed)
    cam = ring_cameras(3, h, w)[1]
    pc = prepare_camera_jax(cam, 1, 0.01, 100.0)
    tx = math.tan(pc["FoVx"] * 0.5)
    ty = math.tan(pc["FoVy"] * 0.5)
    base = dict(
        world_view=pc["world_view_transform"],
        full_proj=pc["full_proj_transform"],
        background=np.asarray([0.3, 0.1, 0.2], np.float32),
    )
    static = dict(focal_x=w / (2 * tx), focal_y=h / (2 * ty), tan_fovx=tx,
                  tan_fovy=ty, image_height=h, image_width=w)
    inputs = dict(
        xyz=(rng.normal(size=(n, 3)) * 0.15).astype(np.float32),
        colors=rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32),
        opacity=rng.uniform(0.3, 0.7, n).astype(np.float32),
        scaling=np.full((n, 3), 0.8, np.float32),
        means2d_offset=np.zeros((n, 2), np.float32),
    )
    rotation = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (n, 1))
    target = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    return inputs, rotation, base, static, target


NAMES = ("xyz", "colors", "opacity", "scaling", "means2d_offset")


def _torch_grads(raster, inputs, rotation, base, static, target, **kw):
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in inputs.items()}
    out = raster(rotation=torch.from_numpy(rotation),
                 **{k: torch.from_numpy(np.asarray(v)) for k, v in base.items()},
                 **leaves, **static, **kw)
    loss = ((out["render"] - torch.from_numpy(target)) ** 2).sum() \
        + (out["alpha"] * 0.1).sum()
    loss.backward()
    return {k: leaves[k].grad.numpy() for k in NAMES}


def _jax_grads(inputs, rotation, base, static, target, **kw):
    def loss(*args):
        out = rt_jax.rasterize_tiled(
            **dict(zip(NAMES, args)), rotation=jnp.asarray(rotation),
            **{k: jnp.asarray(v) for k, v in base.items()}, **static, **kw,
        )
        return jnp.sum((out["render"] - jnp.asarray(target)) ** 2) \
            + jnp.sum(out["alpha"] * 0.1)
    grads = jax.grad(loss, argnums=tuple(range(len(NAMES))))(
        *(jnp.asarray(inputs[k]) for k in NAMES)
    )
    return {k: np.asarray(g) for k, g in zip(NAMES, grads)}


def test_rasterize_tiled_grads_match_jax():
    """Training's mode (full stats). Without stats the JAX frame kernel
    composites in bf16, so its saved tfinal is off by bf16 rounding."""
    case = _smooth_scene()
    got = _torch_grads(rt.rasterize_tiled, *case, max_pairs=2048)
    want = _jax_grads(*case, max_pairs=2048, with_stats=True, interpret=True)
    for name in NAMES:
        scale = np.abs(want[name]).max()
        assert scale > 0, name
        np.testing.assert_allclose(got[name], want[name], atol=1e-3 * scale,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("with_stats", [False, "weights"])
def test_rasterize_tiled_grads_independent_of_stats(with_stats):
    """The stats modes change no gradient: the port composites in f32 in
    every mode."""
    case = _smooth_scene()
    want = _torch_grads(rt.rasterize_tiled, *case, max_pairs=2048)
    got = _torch_grads(rt.rasterize_tiled, *case, max_pairs=2048,
                       with_stats=with_stats)
    for name in NAMES:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_rasterize_tiled_grads_match_oracle():
    case = _smooth_scene()
    got = _torch_grads(rt.rasterize_tiled, *case, max_pairs=2048)
    want = _torch_grads(rasterize_oracle, *case)
    for name in NAMES:
        scale = max(np.abs(want[name]).max(), 1e-3)
        np.testing.assert_allclose(got[name], want[name], atol=2e-2 * scale,
                                   rtol=0, err_msg=name)


def test_background_grad():
    """d_background = sum(tfinal * d_color) per channel."""
    inputs, rotation, base, static, target = _smooth_scene()
    bg = torch.from_numpy(base["background"]).requires_grad_(True)
    out = rt.rasterize_tiled(
        rotation=torch.from_numpy(rotation),
        world_view=torch.from_numpy(np.asarray(base["world_view"])),
        full_proj=torch.from_numpy(np.asarray(base["full_proj"])),
        background=bg, max_pairs=2048,
        **{k: torch.from_numpy(v) for k, v in inputs.items()}, **static,
    )
    out["render"].sum().backward()
    want = (1.0 - out["alpha"].detach()).sum()
    np.testing.assert_allclose(bg.grad.numpy(), [want] * 3, rtol=1e-5)
