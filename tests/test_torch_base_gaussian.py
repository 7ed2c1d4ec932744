"""The port's BaseGaussian (the vanilla 3DGS model without a tree) against
the JAX package's, on the same numpy-seeded scene: 2,000 random Gaussians
(random_gaussians, default_rng(0)) and 64x96 cameras.

create_from_record and load_state_dict give bit-equal arrays, the frustum
keep masks are equal, and a frame through render_one (both packages'
oracles below 16,384 points on the CPU) agrees to 1e-5; vis takes the
two-phase path in both (neither model has render_fused), its 8-bit frames
equal up to one unit where the oracles round across a step.
"""
import math

import numpy as np
import pytest
import torch

import log_tpu.dataset.base as base_jax
from log_tpu.dataset.synthetic import random_gaussians as random_gaussians_jax
from log_tpu.model.base_gaussian import BaseGaussian as BaseGaussianJax
from log_tpu.render.renderer import NaiveRendererAndLoss as RendererJax
from log_tpu_torch.dataset.synthetic import random_gaussians
from log_tpu_torch.model.base_gaussian import BaseGaussian
from log_tpu_torch.model.model_utils import get_module_by_str
from log_tpu_torch.render.renderer import CAMERA_KEYS, NaiveRendererAndLoss
from log_tpu_torch.utils.synth_tree import build_checkpoint

H, W = 64, 96
N = 2000
FRAME_ATOL = 1e-5


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def camera(theta, dist=4.0, height=1.0, focal=80.0):
    eye = np.array([dist * math.cos(theta), dist * math.sin(theta), height])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]])
    cam = {"K": K, "R": R, "T": -R @ eye[:, None], "W": W, "H": H,
           "center": eye.reshape(3, 1)}
    return base_jax.prepare_camera(cam, 1, 0.01, 100.0)


@pytest.fixture(scope="module")
def scene():
    got = random_gaussians(N, np.random.default_rng(0))
    want = random_gaussians_jax(N, np.random.default_rng(0))
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    return got


@pytest.fixture(scope="module")
def models(scene):
    return (BaseGaussianJax.create_from_record(scene, sh_degree=1),
            BaseGaussian.create_from_record(scene, sh_degree=1, device="cpu"))


def assert_state_equal(mj, mt):
    assert mt.keys == mj.keys
    assert (mt.num_points, mt.capacity) == (mj.num_points, mj.capacity)
    a, b = mj.to_numpy(), mt.to_numpy()
    for k in a:
        assert b[k].dtype == a[k].dtype
        assert np.array_equal(_bits(b[k]), _bits(a[k])), k


@pytest.mark.parametrize("sh_degree", [0, 1, 2])
def test_create_from_record_bit_equal(scene, sh_degree):
    record = dict(scene)
    if sh_degree == 2:  # a record with its own SH coefficients
        record["shs"] = np.random.default_rng(1).normal(
            0, 0.1, (N, 8, 3)).astype(np.float32)
    mj = BaseGaussianJax.create_from_record(record, sh_degree=sh_degree)
    mt = BaseGaussian.create_from_record(record, sh_degree=sh_degree,
                                         device="cpu")
    assert_state_equal(mj, mt)
    assert mt.get("xyz").device.type == "cpu"


def test_load_state_dict_equal(models):
    mj, _ = models
    state = {f"gaussian.{k}": v for k, v in mj.to_numpy().items()}
    want = BaseGaussianJax(sh_degree=1)
    want.load_state_dict(state)
    got = BaseGaussian(sh_degree=1, device="cpu")
    got.load_state_dict({k: torch.from_numpy(v.copy())
                         for k, v in state.items()})
    assert_state_equal(want, got)
    # shape-tolerant: a LoD tree's checkpoint loads its parameter arrays
    ckpt = build_checkpoint(300, seed=1)
    want.load_state_dict(ckpt)
    got.load_state_dict(ckpt)
    assert_state_equal(want, got)
    assert got.num_points == ckpt["gaussian.xyz"].shape[0]


def test_surface(models):
    _, mt = models
    assert mt.gaussian is mt and mt.tree.num_nodes == 0
    assert get_module_by_str(mt, "tree.min_resolution_pixel") == 3.0
    assert get_module_by_str(mt, "tree.missing") is None
    mt.set_state(enable_sh=True)
    assert mt.active_sh_degree == 1
    mt.set_state(active_sh_degree=5)
    assert mt.active_sh_degree == 1
    mt.set_state(active_sh_degree=0)
    mt.train()
    assert mt.training
    mt.eval()
    assert not mt.training
    mt.prepare(camera(0.0))
    assert mt.visibility_flag is not None
    mt.clear()
    assert mt.visibility_flag is None


@pytest.mark.parametrize("theta", [0.0, 1.1, 2.5])
def test_prepare_from_camera_masks_equal(models, theta):
    mj, mt = models
    # dist 1.2 puts the camera inside the cloud: many rows fail the test
    for dist in (4.0, 1.2):
        cam = camera(theta, dist=dist)
        want = np.asarray(mj.prepare_from_camera(cam)["keep_mask"])
        got = mt.prepare_from_camera(cam)["keep_mask"].numpy()
        assert got.shape == (mt.capacity,) and np.array_equal(got, want)
        assert not got[mt.num_points:].any()
        assert 0 < got.sum() < N or dist == 4.0


def test_render_one_oracle_frames(models):
    mj, mt = models
    rj = RendererJax(split="demo", background=(1.0, 1.0, 1.0))
    rt = NaiveRendererAndLoss(split="demo", background=(1.0, 1.0, 1.0),
                              device="cpu")
    for m in (mj, mt):
        m.set_state(active_sh_degree=1)
    cam = camera(0.7, dist=3.0)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    mj.prepare_from_camera(cam)
    mt.prepare_from_camera(cam)
    want = rj.render_one(mj, cam, bg)
    got = rt.render_one(mt, cam, bg)
    for key in ("render", "alpha"):
        d = np.abs(got[key].numpy() - np.asarray(want[key]))
        assert d.max() <= FRAME_ATOL, (key, d.max())
    assert float(np.asarray(want["alpha"]).max()) > 0.5


def test_vis_two_phase(models):
    mj, mt = models
    for m in (mj, mt):
        m.eval()
        m.set_state(enable_sh=True)
    assert not hasattr(mt, "render_fused")
    rj = RendererJax(split="demo", background=(1.0, 1.0, 1.0))
    rt = NaiveRendererAndLoss(split="demo", background=(1.0, 1.0, 1.0),
                              device="cpu")
    cams = [camera(2.0, dist=3.5)]
    batch = {"camera": {k: np.stack([c[k] for c in cams])
                        for k in CAMERA_KEYS}}
    want = rj.vis(batch, mj)
    got = rt.vis(batch, mt)
    assert got["render"].shape == (1, 3, H, W)
    for key in ("render", "alpha"):
        d = np.abs(got[key] - want[key])
        assert d.max() <= 1.0 / 255 + 1e-6, key
        assert (d > 0).mean() <= 1e-3, key
    # the frame of render_one after prepare, 8-bit
    mt.prepare_from_camera(cams[0])
    one = rt.render_one(mt, cams[0], rt.background)["render"]
    one8 = (torch.clamp(one, 0, 1) * 255).to(torch.uint8).numpy() / 255.0
    assert np.array_equal(got["render"][0], one8.astype(np.float32))
