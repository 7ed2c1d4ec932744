"""The depth pass's kernel pair and the pinned spill tier on the card.

Marked `cuda`: each test skips without a CUDA device. Run them on the GPU
machine with

    python -m pytest tests/test_torch_depth_spill_cuda.py -q -m cuda --noconftest

- K1 without stats on the depth pass's colors ((camera depth, world z, 1),
  not in [0, 1]) and K2 on that K1's cend and tfinal, against their plain
  versions on the same inputs: colors and transmittance to 5e-3 of the
  largest color at most and 1e-6 of it on average (K1's sequential
  products against the plain cumprod, as in test_torch_kernels_cuda.py),
  per-pair gradients to 1e-3 of the largest;
- the depth loss's gradient bit for bit from run to run, and within 1e-4
  of the CPU's largest;
- the spill tier: moments to pinned host tensors and back, gathered rows
  uploaded without blocking and updated rows scattered after their copy
  landed; three spilled steps equal three device-path steps bit for bit.
"""
import math

import numpy as np
import pytest
import torch

from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.ops import kernels
from log_tpu_torch.ops import rasterize_tiled as rt
from log_tpu_torch.utils.config import load_object
from log_tpu_torch.utils.synth_tree import build_checkpoint

from test_torch_kernels_cuda import H, W, _bits, _pairs

pytestmark = pytest.mark.cuda
KEYS = ("xyz", "colors", "scaling", "opacity", "rotation", "shs")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def test_depth_colors_k1_without_stats_then_k2(cuda):
    splats, _col, A = _pairs(cuda)
    ones = torch.ones_like(splats.depth)
    cols = torch.stack([splats.depth, 2.0 + splats.depth, ones], dim=-1)
    pk = rt.build_pairs(splats, cols, H, W, A)
    bg = torch.tensor([0.2, 0.5, 0.7], device=cuda)
    fargs = (pk["pair_data"], pk["tile_start"], pk["tile_count"], bg,
             pk["tiles_x"], pk["tiles_y"], False)
    before = dict(kernels.LAUNCHES)
    fwd = rt.rasterize_forward(*fargs)
    plain = rt.rasterize_forward_plain(*fargs)
    torch.cuda.synchronize()
    top = float(cols.max())
    assert top > 3.0  # depth colors, not in [0, 1]
    for a, b in zip(fwd[:2], plain[:2]):
        assert (a - b).abs().max() <= 5e-3 * top
        assert (a - b).abs().mean() <= 1e-6 * top
    assert torch.equal(fwd[5], plain[5])
    g = torch.Generator(device=cuda).manual_seed(4)
    dcolor = torch.randn(fwd[0].shape, device=cuda, generator=g)
    dalpha = torch.randn(fwd[1].shape, device=cuda, generator=g)
    bargs = (pk["pair_data"], pk["tile_start"], pk["tile_count"], fwd[5],
             fwd[1], dcolor, dalpha, bg, pk["tiles_x"], pk["tiles_y"])
    got = rt.rasterize_backward(*bargs)
    want = rt.rasterize_backward_plain(*bargs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rasterize_fwd"] == before["rasterize_fwd"] + 1
    assert kernels.LAUNCHES["rasterize_bwd"] == before["rasterize_bwd"] + 1
    scale = want[:9].abs().max()
    assert scale > 0
    assert (got[:9] - want[:9]).abs().max() <= 1e-3 * scale
    assert torch.equal(_bits(got), _bits(rt.rasterize_backward(*bargs)))


def test_depth_patch_loss_reproducible(cuda):
    """The depth loss's gradient on the card is the same bit for bit from
    run to run (overlapping patches add up in a fixed order) and agrees
    with the CPU's."""
    from log_tpu_torch.render.loss import depth_patch_loss, draw_patch_offsets

    rng = np.random.default_rng(5)
    pred = rng.uniform(2.0, 30.0, (96, 160)).astype(np.float32)
    gt = rng.uniform(0.0, 1.0, (96, 160)).astype(np.float32)
    acc = rng.uniform(0.4, 1.0, (96, 160)).astype(np.float32)
    rows, cols = draw_patch_offsets(96, 160, np.random.default_rng(7))
    grads = []
    for dev in (cuda, cuda, "cpu"):
        p = torch.tensor(pred, device=dev, requires_grad=True)
        loss = depth_patch_loss(p, torch.tensor(gt, device=dev),
                                torch.tensor(acc, device=dev), rows, cols)
        (g,) = torch.autograd.grad(loss, p)
        grads.append(g.cpu())
    assert torch.equal(_bits(grads[0]), _bits(grads[1]))
    scale = grads[2].abs().max()
    assert scale > 0 and (grads[0] - grads[2]).abs().max() <= 1e-4 * scale


# ------------------------------------------------------------ spill tier
MODEL_ARGS = {
    "use_view_correction": False,
    "gaussian": {"xyz_scale": 1.0, "sh_degree": 1},
    "optimizer": {
        "optimize_keys": list(KEYS), "opt_all_levels": True,
        "lr_dict": {"xyz": 0.00016, "xyz_final": 0.0000016, "xyz_scale": 1.0,
                    "colors": 0.0025, "shs": 0.000125, "scaling": 0.005,
                    "opacity": 0.05, "rotation": 0.001, "max_steps": 600},
    },
    "tree": {"max_child": 4, "max_level": 30},
    "densify_and_remove": {},
}


def _model(device):
    ckpt = build_checkpoint(300, seed=2)
    for key in KEYS:
        for mk in ("exp_avg", "exp_avg_sq"):
            ckpt[f"optimizer.{mk}.{key}"] = np.zeros_like(ckpt[f"gaussian.{key}"])
    ckpt["optimizer.global_steps"] = np.float32(0)
    model = load_object("LoG.model.level_of_gaussian.LoG", MODEL_ARGS,
                        device=device)
    model.load_state_dict(ckpt, split="train")
    model.set_state(enable_sh=True)
    model.training_setup()
    return model


def _steps(model, n=3, h=64, w=256):
    rng = np.random.default_rng(11)
    for i in range(n):
        theta = 0.4 + 0.9 * i
        pos = np.array([22 * math.cos(theta), 22 * math.sin(theta), 18.0])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        pc = prepare_camera({"K": np.array([[100.0, 0, w / 2],
                                            [0, 100.0, h / 2], [0, 0, 1]]),
                             "R": R, "T": (-R @ pos).reshape(3, 1), "H": h,
                             "W": w, "center": pos.reshape(3, 1)},
                            1, 0.01, 1000.0)
        gt = rng.integers(0, 256, (3, h, w), dtype=np.uint8)
        model.prepare_from_camera(pc)
        model.train_step(pc, gt, np.zeros(3, np.float32), view_index=0)


def test_pinned_spill_round_trip(cuda):
    model = _model(cuda)
    opt = model.optimizer
    before = {mk: {k: v.clone() for k, v in opt.moments[mk].items()}
              for mk in ("exp_avg", "exp_avg_sq")}
    for v in before["exp_avg"].values():
        v.normal_()
    opt.moments["exp_avg"] = {k: v.clone() for k, v in before["exp_avg"].items()}
    opt.to_host(("exp_avg",))
    host = opt.host_moments["exp_avg"]
    assert opt.moments["exp_avg"] == {}
    for k, v in host.items():
        assert v.is_pinned() and torch.equal(v, before["exp_avg"][k].cpu())
    index = np.array([5, 0, 7, model.capacity, 3], np.int32)
    rows = opt.host_gather(index)["exp_avg"]
    assert all(v.is_pinned() for v in rows.values())
    new = {k: v.to(cuda, non_blocking=True) + 1.0 for k, v in rows.items()}
    mask = torch.tensor([True, False, True, False, True], device=cuda)
    opt.host_scatter(index, {"exp_avg": new}, mask)
    for k, v in host.items():
        want = before["exp_avg"][k].cpu()
        want[[5, 7, 3]] += 1.0
        assert torch.equal(v, want), k


def test_spilled_steps_equal_device_steps(cuda, monkeypatch):
    monkeypatch.setenv("LOG_TPU_IDENTITY_STEP", "0")
    ref = _model(cuda)
    _steps(ref)
    spill = _model(cuda)
    spill.optimizer.to_host(("exp_avg_sq", "exp_avg"))
    _steps(spill)
    want, got = ref.state_dict(), spill.state_dict()
    assert set(got) == set(want)
    for key, val in want.items():
        assert np.array_equal(np.asarray(got[key]), np.asarray(val)), key
    assert np.abs(got["optimizer.exp_avg_sq.xyz"]).sum() > 0
