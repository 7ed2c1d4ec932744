"""The viewer's scene and the vanilla model on the card, against the plain
torch versions of the kernels.

Marked `cuda`: each test skips without a CUDA device. Run them on the GPU
machine with

    python -m pytest tests/test_torch_viewer_cuda.py -q -m cuda --noconftest

check_viewer's scene (2,000 random Gaussians, a BaseGaussian at 360x480)
through ViewerState.render_bgr launches K4, K3 and K1 once each and agrees
with the all-plain frame to 2 units of 8 bits (FRAME_MAX_ABS of
chip_smoke.py) and with the oracle to 2e-2 (1e-3 on average); the vanilla
orbit's first frame (the synthetic tree's 600k roots at 1920x1088 through
NaiveRendererAndLoss.vis) does the same within its pair budget.
"""
import contextlib
import math

import numpy as np
import pytest
import torch

from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.ops import expand as ex
from log_tpu_torch.ops import kernels, pick_max_pairs
from log_tpu_torch.ops import rasterize_tiled as rt
from log_tpu_torch.render.renderer import CAMERA_KEYS

pytestmark = pytest.mark.cuda
FRAME_MAX_ABS = 2.0 / 255.0 + 1e-6
KERNELS = ("pack_rows", "expand_with_keys", "rasterize_fwd")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@contextlib.contextmanager
def plain_versions():
    """K4, K3 and K1 replaced by their plain torch versions."""
    saved = (ex.expand_with_keys, rt.pack_rows, rt.rasterize_forward)
    ex.expand_with_keys = ex.expand_with_keys_plain
    rt.pack_rows, rt.rasterize_forward = (rt.pack_rows_plain,
                                          rt.rasterize_forward_plain)
    try:
        yield
    finally:
        ex.expand_with_keys, rt.pack_rows, rt.rasterize_forward = saved


def counted(fn):
    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES)


def test_check_viewer_scene(cuda, monkeypatch):
    from log_tpu_torch.apps import check_viewer

    state = check_viewer.make_state(cuda)
    view = (*check_viewer.ONESHOT_VIEW, np.zeros(3))
    kern, launches = counted(lambda: state.render_bgr(*view))
    assert all(launches[k] == 1 for k in KERNELS), launches
    assert launches["rasterize_bwd"] == launches["rasterize_fwd_packed"] == 0
    with plain_versions():
        plain, launches = counted(lambda: state.render_bgr(*view))
    assert sum(launches.values()) == 0
    d = np.abs(kern.astype(np.float64) - plain) / 255.0
    assert d.max() <= FRAME_MAX_ABS and kern.std() > 20
    # the oracle on the card, before 8-bit quantization
    camera = state.camera(*view)
    state.model.prepare_from_camera(camera)
    bg = np.ones(3, np.float32)
    tiled = state.renderer.render_one(state.model, camera, bg)
    assert int(tiled["pair_total"]) <= tiled["max_pairs"]
    monkeypatch.setenv("LOG_TPU_BACKEND", "reference")
    ref = state.renderer.render_one(state.model, camera, bg)
    err = (tiled["render"] - ref["render"]).abs()
    assert float(err.max()) < 2e-2 and float(err.mean()) < 1e-3


def test_vanilla_orbit_first_frame(cuda):
    from log_tpu_torch.model.base_gaussian import BaseGaussian
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.synth_tree import build_checkpoint, roots_record

    n_roots, h, w, focal = 600_000, 1088, 1920, 1400.0
    model = BaseGaussian.create_from_record(
        roots_record(build_checkpoint(n_roots, seed=0), n_roots), sh_degree=1,
        device=cuda)
    model.eval()
    model.set_state(enable_sh=True)
    # the serving orbit's first camera (chip_smoke.make_cam(0))
    pos = np.array([22.0, 0.0, 18.0])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    pc = prepare_camera({"K": np.array([[focal, 0, w / 2], [0, focal, h / 2],
                                        [0, 0, 1]]),
                         "R": R, "T": (-R @ pos).reshape(3, 1), "H": h, "W": w,
                         "center": pos.reshape(3, 1)}, 1, 0.01, 1000.0)
    batch = {"camera": {k: np.asarray(pc[k])[None] for k in CAMERA_KEYS}}
    renderer = NaiveRendererAndLoss(split="demo", device=cuda)
    kern, launches = counted(lambda: renderer.vis(batch, model)["render"][0])
    assert all(launches[k] == 1 for k in KERNELS), launches
    with plain_versions():
        plain = renderer.vis(batch, model)["render"][0]
    assert kern.shape == (3, h, w) and kern.std() > 0.05
    assert np.abs(kern - plain).max() <= FRAME_MAX_ABS
    model.prepare_from_camera(pc)
    out = renderer.render_one(model, pc, renderer.background)
    assert out["max_pairs"] == pick_max_pairs(model.capacity)
    assert 0 < int(out["pair_total"]) <= out["max_pairs"]
    assert math.isfinite(float(out["render"].sum()))
