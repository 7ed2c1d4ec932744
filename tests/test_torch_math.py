"""log_tpu_torch math (gaussian_math, sh, projection) against log_tpu.

The same numpy inputs, made from a seed, go through both packages; results
must agree to float32 tolerance (rtol 1e-5 / atol 1e-5: the two compute
the same closed forms in float32, in possibly different operation order).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.dataset.base import prepare_camera as prepare_camera_jax
from log_tpu.dataset.base import rescale_camera as rescale_camera_jax
from log_tpu.dataset.synthetic import random_gaussians, ring_cameras
from log_tpu.model.activation import Activation as ActivationJax
from log_tpu.ops import gaussian_math as gm_jax
from log_tpu.ops import projection as proj_jax
from log_tpu.ops import sh as sh_jax
from log_tpu_torch.dataset.base import prepare_camera, rescale_camera
from log_tpu_torch.model.activation import Activation
from log_tpu_torch.ops import gaussian_math as gm
from log_tpu_torch.ops import projection as proj
from log_tpu_torch.ops import sh

RTOL, ATOL = 1e-5, 1e-5
H, W = 48, 64


def _camera(seed=0):
    cam = ring_cameras(5, H, W)[seed % 5]
    pc = prepare_camera(cam, 1, 0.01, 100.0)
    tan_fovx = math.tan(pc["FoVx"] * 0.5)
    tan_fovy = math.tan(pc["FoVy"] * 0.5)
    return pc, dict(focal_x=W / (2 * tan_fovx), focal_y=H / (2 * tan_fovy),
                    tan_fovx=tan_fovx, tan_fovy=tan_fovy)


def _close(got, want, rtol=RTOL, atol=ATOL, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=err_msg)


def test_prepare_camera_matches():
    cam = ring_cameras(3, H, W)[1]
    a = prepare_camera(cam, 2, 0.01, 100.0)
    b = prepare_camera_jax(cam, 2, 0.01, 100.0)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    r, rj = rescale_camera(cam, 3), rescale_camera_jax(cam, 3)
    assert (r["H"], r["W"]) == (rj["H"], rj["W"])
    np.testing.assert_array_equal(r["K"], rj["K"])


@pytest.mark.parametrize("scaling", ["exp", "sigmoid", "tanh"])
def test_activation_matches(scaling):
    rng = np.random.default_rng(4)
    n = 64
    params = {
        "xyz": rng.normal(size=(n, 3)).astype(np.float32),
        "colors": rng.normal(size=(n, 3)).astype(np.float32),
        "scaling": rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32),
        "opacity": rng.normal(size=(n, 1)).astype(np.float32),
        "rotation": rng.normal(size=(n, 4)).astype(np.float32),
        "shs": rng.normal(size=(n, 3, 3)).astype(np.float32),
    }
    center = np.asarray([0.5, -2.0, 1.0], np.float32)
    got = Activation(scaling).activate(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(center), 1,
    )
    want = ActivationJax(scaling).activate(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(center), 1
    )
    for key in want:
        _close(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_math_matches(seed):
    rng = np.random.default_rng(seed)
    n = 257
    s = random_gaussians(n, rng, extent=0.9)
    pc, k = _camera(seed)
    wv = pc["world_view_transform"]
    fp = pc["full_proj_transform"]
    t = {key: torch.from_numpy(v) for key, v in s.items()}
    j = {key: jnp.asarray(v) for key, v in s.items()}
    twv, tfp = torch.from_numpy(wv), torch.from_numpy(fp)
    jwv, jfp = jnp.asarray(wv), jnp.asarray(fp)

    _close(gm.quat_to_rotmat(t["rotation"]),
           gm_jax.quat_to_rotmat(j["rotation"]))
    _close(gm.build_cov3d(t["scaling"], t["rotation"]),
           gm_jax.build_cov3d(j["scaling"], j["rotation"]))
    _close(gm.transform_point(t["xyz"], twv),
           gm_jax.transform_point(j["xyz"], jwv))
    p, w = gm.project_ndc(t["xyz"], tfp)
    pj, wj = gm_jax.project_ndc(j["xyz"], jfp)
    _close(p, pj)
    _close(w, wj)
    np.testing.assert_array_equal(gm.frustum_flag(p).numpy(),
                                  np.asarray(gm_jax.frustum_flag(pj)))
    cov = gm.build_cov3d(t["scaling"], t["rotation"])
    covj = gm_jax.build_cov3d(j["scaling"], j["rotation"])
    # cov2d entries are O(1e3) px^2 products of many float32 terms, so the
    # comparison is relative (1e-4) with a matching absolute floor
    c2 = gm.ewa_cov2d(cov, t["xyz"], twv, **k)
    c2j = gm_jax.ewa_cov2d(covj, j["xyz"], jwv, **k)
    for a, b in zip(c2, c2j):
        _close(a, b, rtol=1e-4, atol=1e-3)
    for mode in ("clamp", "add", "none"):
        for a, b in zip(gm.dilate_cov2d(*c2, mode=mode),
                        gm_jax.dilate_cov2d(*c2j, mode=mode)):
            _close(a, b, rtol=1e-4, atol=1e-3)
    _close(gm.cov2d_radius(*gm.dilate_cov2d(*c2)),
           gm_jax.cov2d_radius(*gm_jax.dilate_cov2d(*c2j)), rtol=1e-4)
    for a, b in zip(gm.inverse_cov2d(*gm.dilate_cov2d(*c2)),
                    gm_jax.inverse_cov2d(*gm_jax.dilate_cov2d(*c2j))):
        _close(a, b, rtol=1e-4, atol=1e-4)
    _close(gm.ndc_to_pix(p[:, 0], W), gm_jax.ndc_to_pix(pj[:, 0], W))
    _close(
        gm.compute_radius2d(t["xyz"], t["scaling"], t["rotation"], twv, tfp,
                            **k),
        gm_jax.compute_radius2d(j["xyz"], j["scaling"], j["rotation"], jwv,
                                jfp, **k),
        rtol=1e-4, atol=1e-4,
    )


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_eval_sh_matches(degree):
    rng = np.random.default_rng(degree)
    n = 129
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    coef = rng.normal(size=(n, (degree + 1) ** 2 - 1, 3)).astype(np.float32)
    _close(sh.eval_sh(torch.from_numpy(dirs), torch.from_numpy(coef), degree),
           sh_jax.eval_sh(jnp.asarray(dirs), jnp.asarray(coef), degree))
    rgb = rng.random((n, 3)).astype(np.float32)
    _close(sh.rgb_to_sh(torch.from_numpy(rgb)), sh_jax.rgb_to_sh(rgb))
    _close(sh.sh_to_rgb(torch.from_numpy(rgb)), sh_jax.sh_to_rgb(rgb))
    assert sh.num_sh_coeffs(degree) == sh_jax.num_sh_coeffs(degree)


@pytest.mark.parametrize("mode,use_filter,tight", [
    ("antialias", True, False), ("antialias", False, True),
    ("original", False, False),
])
def test_project_gaussians_matches(mode, use_filter, tight):
    rng = np.random.default_rng(7)
    n = 300
    s = random_gaussians(n, rng, extent=1.2)
    pc, k = _camera(2)
    mask = rng.random(n) > 0.2
    offset = (rng.normal(size=(n, 2)) * 1e-3).astype(np.float32)
    args = dict(image_height=H, image_width=W, mode=mode,
                use_filter=use_filter, tight_radius=tight, **k)
    a = proj.project_gaussians(
        torch.from_numpy(s["xyz"]), torch.from_numpy(s["scaling"]),
        torch.from_numpy(s["rotation"]), torch.from_numpy(s["opacity"]),
        torch.from_numpy(pc["world_view_transform"]),
        torch.from_numpy(pc["full_proj_transform"]),
        means2d_offset=torch.from_numpy(offset),
        active_mask=torch.from_numpy(mask), **args,
    )
    b = proj_jax.project_gaussians(
        jnp.asarray(s["xyz"]), jnp.asarray(s["scaling"]),
        jnp.asarray(s["rotation"]), jnp.asarray(s["opacity"]),
        jnp.asarray(pc["world_view_transform"]),
        jnp.asarray(pc["full_proj_transform"]),
        means2d_offset=jnp.asarray(offset), active_mask=jnp.asarray(mask),
        **args,
    )
    np.testing.assert_array_equal(a.valid.numpy(), np.asarray(b.valid))
    _close(a.pix_xy, b.pix_xy, rtol=1e-5, atol=1e-3)
    _close(a.conic, b.conic, rtol=1e-4, atol=1e-5)
    _close(a.opacity, b.opacity)
    _close(a.depth, b.depth)
    # radius is ceil()ed: a float32 rounding difference may move it by 1
    assert np.abs(a.radius.numpy() - np.asarray(b.radius)).max() <= 1.0
    assert (a.radius.numpy() != np.asarray(b.radius)).mean() < 0.01
    assert proj.NEAR_Z == proj_jax.NEAR_Z
    assert (proj.ALPHA_MIN, proj.ALPHA_MAX, proj.T_EPS) == (
        proj_jax.ALPHA_MIN, proj_jax.ALPHA_MAX, proj_jax.T_EPS)
