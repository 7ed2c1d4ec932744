"""The masked training path of the port against log_tpu's, on the CPU.

`MaskForeground` (validation crops the render and the GT to the mask's box,
the GT composited over the background), `_fg_mask_bbox` (the training box
with the reference's padding), one step with a foreground mask (crop_loss:
the GT composited over the step background inside the mask, the loss
restricted to the box) and one with an ignore mask (has_mask), both on
LOG_TPU_BACKEND=reference; `ImageDataset(foreground_mask=, mask_ignore=)`
on a scene written by the test; and the trainer's hand-off of the batch
mask. Inputs come from numpy seeds. Limits of the steps:
tests/test_torch_train_step.py's (loss to 1e-5, first moments to 1e-3 of
each key's largest, parameters to 1e-6 where the gradient is above 1e-4 of
its key's largest, integer counters equal, float counters to 1e-4).
"""
import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from log_tpu.dataset import colmap as colmap_jax
from log_tpu.dataset.synthetic import SyntheticDataset as SyntheticJax
from log_tpu.model.level_of_gaussian import _fg_mask_bbox as bbox_jax
from log_tpu.render.renderer import MaskForeground as MaskForegroundJax
from log_tpu_torch.dataset import colmap
from log_tpu_torch.model.counter import COUNTER_KEYS
from log_tpu_torch.model.level_of_gaussian import _fg_mask_bbox
from log_tpu_torch.render.renderer import MaskForeground

from test_torch_dataset import _dataset, _write_scene
from test_torch_train_step import (KEYS, TH, TW, _train_models, _views,
                                   assert_counters_close,
                                   assert_moments_close, assert_params_close)


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
    monkeypatch.setenv("LOG_TPU_BACKEND", "reference")
    for name in ("LOG_TPU_COMPACT", "LOG_TPU_IDENTITY_STEP",
                 "LOG_TPU_PACK_SORT_KEYS"):
        monkeypatch.delenv(name, raising=False)


def _box_mask(rng, h, w):
    """A float mask of ones in a random box (at least 12 x 20 pixels)."""
    t = int(rng.integers(0, h - 12))
    l_ = int(rng.integers(0, w - 20))
    b = int(rng.integers(t + 12, h + 1))
    r = int(rng.integers(l_ + 20, w + 1))
    m = np.zeros((h, w), np.float32)
    m[t:b, l_:r] = 1.0
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_foreground_processing_matches_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = 20 + seed * 7, 26 + seed * 11
    img = rng.random((1, h, w, 3)).astype(np.float32)
    batch = {"image": img, "mask": _box_mask(rng, h, w)[None]}
    pred = rng.random((3, h, w)).astype(np.float32)
    for bg in ((1.0, 1.0, 1.0), tuple(rng.random(3))):
        port = MaskForeground(split="val", background=bg, device="cpu")
        ref = MaskForegroundJax(split="val", background=bg)
        assert port.foreground_crop and ref.foreground_crop
        gt = port.process_gt(batch)
        want = ref.process_gt(batch)
        assert gt.shape == want.shape and gt.dtype == want.dtype
        np.testing.assert_array_equal(gt, want)
        np.testing.assert_array_equal(port.process_pred(batch, pred),
                                      ref.process_pred(batch, pred))
        for pad in (0, 3):
            assert (MaskForeground.bound_from_mask(batch["mask"][..., None],
                                                   pad)
                    == MaskForegroundJax.bound_from_mask(
                        batch["mask"][..., None], pad))


@pytest.mark.parametrize("case", ["box", "empty", "edge", "flat"])
def test_fg_mask_bbox_matches_jax(case):
    rng = np.random.default_rng(4)
    h, w = 48, 160
    m = {"box": _box_mask(rng, h, w), "empty": np.zeros((h, w), np.float32),
         "edge": np.pad(np.ones((6, 9), np.float32), ((h - 6, 0), (w - 9, 0))),
         "flat": _box_mask(rng, h, w).reshape(-1)}[case]
    got, box = _fg_mask_bbox(m, h, w, "cpu")
    want, box_j = bbox_jax(m, h, w)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.uint8 and got.shape == (1, h, w)
    np.testing.assert_array_equal(box, np.asarray(box_j))


def _state(model):
    sd = model.state_dict()
    n = model.num_points
    return ({k: sd[f"gaussian.{k}"] for k in KEYS},
            {mk: {k: sd[f"optimizer.{mk}.{k}"] for k in KEYS}
             for mk in ("exp_avg", "exp_avg_sq")},
            {k: sd[f"counter.{k}"] for k in COUNTER_KEYS}, n)


@pytest.mark.parametrize("kind", ["fg_mask", "mask_ignore"])
def test_masked_step_matches_jax(kind):
    """One training_iteration of each package with the mask (the first
    step of a model: its own prepare pass, then the step)."""
    port, ref = _train_models()
    pc, gt, bg, vi = _views()[1]
    mask = _box_mask(np.random.default_rng(9), TH, TW)
    met_p, aux_p = port.training_iteration(pc, gt, bg, view_index=vi,
                                           **{kind: mask})
    met_j, aux_j = ref.training_iteration(pc, gt, bg, view_index=vi,
                                          **{kind: mask})
    for key in ("loss", "l1", "ssim"):
        assert abs(float(met_p[key]) - float(met_j[key])) <= 1e-5, key
    # the mask moved the loss: the same step without it differs
    plain_p, _ = _train_models()[0].training_iteration(pc, gt, bg,
                                                       view_index=vi)
    assert abs(float(plain_p["loss"]) - float(met_p["loss"])) > 1e-3
    p_p, m_p, c_p, n = _state(port)
    p_j, m_j, c_j, _ = _state(ref)
    assert_moments_close(m_p, m_j, n)
    assert_params_close(p_p, p_j, m_j, n)
    assert_counters_close(c_p, c_j, n)


# ----------------------------------------------------------- the dataset
H, W = 64, 80


@pytest.fixture(scope="module")
def mask_scene(tmp_path_factory):
    """A 4-view scene on a white background, its foreground masks by
    thresholding that background (masks/cam/<name>.png) and ignore masks
    (the same, inverted, under ignore/images/cam/<name>.png)."""
    ds = SyntheticJax(n_gaussians=50, n_views=4, H=H, W=W, seed=2)
    root = str(tmp_path_factory.mktemp("mask_scene"))
    _write_scene(root, ".png", ds)
    for i in range(len(ds.cameras)):
        img = cv2.imread(os.path.join(root, "images", "cam", f"{i:04d}.png"))
        fg = (img.min(axis=2) < 250).astype(np.uint8) * 255
        assert 0 < fg.mean() < 255
        for sub, m in (("masks/cam", fg),
                       ("ignore/images/cam", 255 - fg)):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
            cv2.imwrite(os.path.join(root, sub, f"{i:04d}.png"), m)
    return root


@pytest.mark.parametrize("kw", [
    {"foreground_mask": "masks"},
    {"mask_ignore": {"path": "ignore", "type": "foreground"}},
    {"mask_ignore": {"path": "ignore", "type": "background"}},
], ids=["foreground_mask", "mask_ignore", "mask_ignore_background"])
def test_image_dataset_masks_match_jax(mask_scene, kw, tmp_path):
    key = "mask" if "foreground_mask" in kw else "mask_ignore"
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "theirs")
    shutil.copytree(mask_scene, ours)
    shutil.copytree(mask_scene, theirs)
    port_ds = _dataset(colmap, ours, ".png", **kw)
    jax_ds = _dataset(colmap_jax, theirs, ".png", **kw)
    for scale in (1, 2, 4):
        port_ds.set_state(scale=scale)
        jax_ds.set_state(scale=scale)
        for i in range(len(jax_ds)):
            a, b = port_ds[i], jax_ds[i]
            assert key in a and key in b, (scale, i)
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
            np.testing.assert_array_equal(a["image"], b["image"])
            if key == "mask":
                assert a[key].shape == a["image"].shape[:2]


# ------------------------------------------------------ the trainer hand-off
class _Recorder:
    """A model that records what the trainer hands to training_iteration."""

    device = torch.device("cpu")

    def __init__(self):
        from types import SimpleNamespace

        self.tree = SimpleNamespace(min_resolution_pixel=3.0)
        self.calls = []

    def training_iteration(self, camera, gt, background, **kw):
        self.calls.append(kw)
        return {"loss": torch.zeros(())}, {"render": torch.zeros(3, 1, 1)}


@pytest.mark.parametrize("crop", [True, False])
def test_trainer_hands_the_mask_to_the_step(crop, tmp_path):
    """With a foreground_crop renderer (MaskForeground) the batch's "mask"
    reaches training_iteration as fg_mask, in both packages; with the plain
    renderer it does not. mask_ignore goes through either way."""
    from log_tpu.render.renderer import NaiveRendererAndLoss as NaiveJax
    from log_tpu.utils.config import CfgNode
    from log_tpu.utils.trainer import Trainer as TrainerJax
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.trainer import Trainer
    from log_tpu_torch.dataset.base import prepare_camera
    from log_tpu_torch.render.renderer import CAMERA_KEYS

    rng = np.random.default_rng(3)
    h, w = 32, 64
    pc = prepare_camera({"K": np.array([[60.0, 0, w / 2], [0, 60.0, h / 2],
                                        [0, 0, 1]]),
                         "R": np.eye(3), "T": np.array([[0.0], [0.0], [5.0]]),
                         "H": h, "W": w, "center": np.zeros((3, 1))},
                        1, 0.01, 100.0)
    batch = {"camera": {k: np.asarray(pc[k])[None] for k in CAMERA_KEYS},
             "image": rng.uniform(size=(1, h, w, 3)).astype(np.float32),
             "mask": _box_mask(rng, h, w)[None],
             "mask_ignore": _box_mask(rng, h, w)[None],
             "index": np.asarray([0])}
    got = {}
    for name, trainer_cls, render in (
            ("port", Trainer, MaskForeground if crop
             else NaiveRendererAndLoss),
            ("jax", TrainerJax, MaskForegroundJax if crop else NaiveJax)):
        model = _Recorder()
        kw = {"device": "cpu"} if name == "port" else {}
        if name == "jax":
            exp = str(tmp_path / "jax")
            trainer = trainer_cls(CfgNode({"exp": exp}), model,
                                  render(**kw), logdir=exp)
            os.close(trainer._exp_lock_fd)
        else:
            trainer = trainer_cls({}, model, render(**kw))
        trainer.global_iterations = 1  # past the logging step
        trainer.training_step(model, batch)
        (call,) = model.calls
        got[name] = call
    for name, call in got.items():
        np.testing.assert_array_equal(call["mask_ignore"],
                                      batch["mask_ignore"][0])
        if crop:
            np.testing.assert_array_equal(call["fg_mask"], batch["mask"][0])
        else:
            assert call.get("fg_mask") is None, name
