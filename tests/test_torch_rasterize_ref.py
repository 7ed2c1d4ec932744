"""The port's oracle rasterizer against log_tpu.ops.rasterize_ref.

Every output of the contract is compared on the same seeded scene. Images
and weights agree to 1e-5 (float32 compositing of the same chunked
recurrence, summed in another order); the argmax contributor map and the
radii must be equal.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.dataset.synthetic import random_gaussians, ring_cameras
from log_tpu.ops.rasterize_ref import rasterize as rasterize_jax
from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.ops.rasterize_ref import rasterize

H, W = 32, 48


def _args(n, seed, mode, use_filter):
    rng = np.random.default_rng(seed)
    s = random_gaussians(n, rng, extent=0.8)
    pc = prepare_camera(ring_cameras(3, H, W)[1], 1, 0.01, 100.0)
    tan_fovx = math.tan(pc["FoVx"] * 0.5)
    tan_fovy = math.tan(pc["FoVy"] * 0.5)
    arrays = dict(
        xyz=s["xyz"], colors=s["colors"], opacity=s["opacity"],
        scaling=s["scaling"], rotation=s["rotation"],
        means2d_offset=np.zeros((n, 2), np.float32),
        world_view=pc["world_view_transform"],
        full_proj=pc["full_proj_transform"],
        background=np.asarray([0.1, 0.2, 0.3], np.float32),
        active_mask=rng.random(n) > 0.1,
    )
    static = dict(focal_x=W / (2 * tan_fovx), focal_y=H / (2 * tan_fovy),
                  tan_fovx=tan_fovx, tan_fovy=tan_fovy, image_height=H,
                  image_width=W, mode=mode, use_filter=use_filter)
    return arrays, static


@pytest.mark.parametrize("mode,use_filter,chunk", [
    ("antialias", True, 32), ("antialias", False, 16), ("original", True, 64),
])
def test_oracle_matches_jax(mode, use_filter, chunk):
    arrays, static = _args(70, 3, mode, use_filter)
    got = rasterize(**{k: torch.from_numpy(np.asarray(v))
                       for k, v in arrays.items()}, chunk=chunk, **static)
    want = rasterize_jax(**{k: jnp.asarray(v) for k, v in arrays.items()},
                         chunk=chunk, **static)
    assert set(got) == set(want)
    for key in ("render", "alpha", "point_weight_pixel", "point_weight",
                "depth_cam"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    np.testing.assert_array_equal(got["radii"].numpy(),
                                  np.asarray(want["radii"]))
    pid, pid_j = got["point_id_pixel"].numpy(), np.asarray(want["point_id_pixel"])
    # equal except where two contributors' weights tie within rounding
    assert (pid != pid_j).mean() < 0.01
    assert got["point_id_pixel"].dtype == torch.int32
