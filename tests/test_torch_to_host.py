"""The 8-bit handoff to the host (ops/to_host.py, csrc/to_host.cu).

`vis` returns a frame's render, alpha and mask, and `Trainer.training_step`
its output GT, as host float32 arrays on the levels k / 255. On the card one
`to_host` launch writes them into pinned host memory; each value has to be
the plain version's bit for bit (the device quantize, a copy to the host,
numpy's float32 division), NaN, infinities and out-of-range values
included. The CPU test holds the CPU path to the old arithmetic; the tests
marked `cuda` skip without a CUDA device. Run them on the GPU machine with

    python -m pytest tests/test_torch_to_host.py -q -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from log_tpu_torch.ops import kernels, to_host

CAM_KEYS = ("camera_center", "world_view_transform", "full_proj_transform",
            "image_width", "image_height", "FoVx", "FoVy", "K", "R", "T")
H, W = 32, 124   # W not a multiple of 16: the frame is a strided view


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _model(split: str, device):
    """A 200-root synthetic tree (1,080 points), SH 1, flat_slice."""
    from log_tpu_torch.utils.config import load_object
    from log_tpu_torch.utils.synth_tree import build_checkpoint

    args = {
        "use_view_correction": True,
        "gaussian": {"xyz_scale": 1.0, "sh_degree": 1},
        "optimizer": {"optimize_keys": ["xyz", "colors", "scaling",
                                        "opacity", "rotation", "shs"],
                      "opt_all_levels": True,
                      "lr_dict": {"xyz": 1.6e-4, "colors": 2.5e-3,
                                  "shs": 1.25e-4, "scaling": 5e-3,
                                  "opacity": 0.05, "rotation": 1e-3,
                                  "max_steps": 600}},
        "tree": {"max_child": 4, "cut_method": "flat_slice"},
        "densify_and_remove": {},
    }
    model = load_object("LoG.model.level_of_gaussian.LoG", args,
                        device=str(device))
    if split == "train":
        model.view_correction.init(2)
        model.load_state_dict(build_checkpoint(200, seed=3))
        model.set_state(enable_sh=True)
        model.set_stage("tree")
        model.training_setup()
    else:
        model.load_state_dict(build_checkpoint(200, seed=3))
        model.set_state(enable_sh=True)
        model.eval()
    return model


def _camera(angle: float):
    from log_tpu_torch.dataset.base import prepare_camera

    pos = np.array([22.0 * np.sin(angle), -22.0 * np.cos(angle), 18.0])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0, 0, 1.0])
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd])
    return prepare_camera({"K": np.array([[40.0, 0, W / 2], [0, 40.0, H / 2],
                                          [0, 0, 1]]),
                           "R": R, "T": (-R @ pos).reshape(3, 1), "H": H,
                           "W": W, "center": pos.reshape(3, 1)}, 1, 0.01,
                          1000.0)


def _batch(n: int = 1, image=None):
    cams = [_camera(0.3 * i) for i in range(n)]
    batch = {"camera": {k: np.stack([np.asarray(c[k]) for c in cams])
                        for k in CAM_KEYS},
             "index": np.arange(n)}
    if image is not None:
        batch["image"] = image
    return batch


def _captured(model):
    """Wrap model.render_fused: each frame's render and alpha, cloned."""
    frames, inner = [], model.render_fused

    def render_fused(*a, **kw):
        out = inner(*a, **kw)
        frames.append({k: out[k].clone() for k in ("render", "alpha")})
        return out

    model.render_fused = render_fused
    return frames


def _old_frame(x: torch.Tensor) -> np.ndarray:
    """The frame's arithmetic before the kernel, written out."""
    q = (torch.clamp(x, 0, 1) * 255).to(torch.uint8).cpu()
    return q.numpy().astype(np.float32) / 255.0


def _bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return (a.dtype == b.dtype == np.float32 and a.shape == b.shape
            and np.array_equal(a.view(np.int32), b.view(np.int32)))


def _plain(src: torch.Tensor) -> np.ndarray:
    """to_host_plain of one plane into a plain CPU tensor, as src's
    shape."""
    out = torch.empty(src.shape, dtype=torch.float32)
    to_host.to_host_plain([(src, (out,))])
    return out.numpy()


def _step_image(rng, n=1):
    return rng.integers(0, 256, (n, H, W, 3), dtype=np.uint8)


def test_cpu_path_is_the_plain_version(monkeypatch):
    """The dequantize table is numpy's float32 division at every level; on
    CPU tensors vis and training_step return what they returned before the
    kernel, bit for bit."""
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.trainer import Trainer

    levels = np.arange(256, dtype=np.uint8)
    assert _bits_equal(to_host.DEQUANT, levels.astype(np.float32) / 255.0)
    assert _bits_equal(_plain(torch.from_numpy(levels).reshape(1, 256)),
                       to_host.DEQUANT.reshape(1, 256))

    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    model = _model("demo", "cpu")
    frames = _captured(model)
    renderer = NaiveRendererAndLoss(split="demo", device="cpu")
    out = renderer.vis(_batch(2), model)
    assert list(out) == ["render", "alpha", "mask"]
    want = {"render": np.stack([_old_frame(f["render"]) for f in frames]),
            "alpha": np.stack([_old_frame(f["alpha"]) for f in frames])}
    assert want["render"].shape == (2, 3, H, W)
    assert want["render"].std() > 0.01
    assert _bits_equal(out["render"], want["render"])
    assert _bits_equal(out["alpha"], want["alpha"])
    assert _bits_equal(out["mask"], want["alpha"])
    assert not np.shares_memory(out["alpha"], out["mask"])

    model = _model("train", "cpu")
    renderer = NaiveRendererAndLoss(split="train", use_randback=True,
                                    device="cpu")
    trainer = Trainer({}, model, renderer, seed=5)
    trainer.set_gt_cache(True)
    image = np.random.default_rng(0).uniform(size=(1, H, W, 3))
    trainer.global_iterations = 1
    _, step_out, _ = trainer.training_step(model, _batch(1, image))
    gt8 = (np.clip(image[0], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    assert _bits_equal(step_out["gt"],
                       gt8.transpose(2, 0, 1).astype(np.float32) / 255.0)


def _special_floats() -> torch.Tensor:
    """Every k / 255 as float32 with its two neighbours, the infinities,
    NaN, zeros of both signs, a subnormal, negatives and values above 1,
    and uniform draws around [0, 1]."""
    k = torch.from_numpy((np.arange(256, dtype=np.float64) / 255)
                         .astype(np.float32))
    inf = torch.tensor(float("inf"))
    odd = torch.tensor([float("nan"), float("inf"), float("-inf"), 0.0, -0.0,
                        1e-45, -1e-45, -1.0, -1e-30, 1.0, 1.0000001, 2.0,
                        255.0, 1e30, -1e30, 0.5, 0.999999])
    draws = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.25, 1.25, 4099).astype(np.float32))
    return torch.cat([k, torch.nextafter(k, inf), torch.nextafter(k, -inf),
                      odd, draws])


def _launch(src: torch.Tensor, n_dst: int = 1, offset: int = 0):
    """to_host of one plane into n_dst pinned destinations that start
    `offset` elements into their buffers; returns them as numpy arrays of
    src's shape."""
    bufs = [torch.empty(src.numel() + offset, dtype=torch.float32,
                        pin_memory=True) for _ in range(n_dst)]
    outs = [b[offset:] for b in bufs]
    to_host.to_host([(src, tuple(outs))])
    torch.cuda.current_stream().synchronize()
    return [o.numpy().reshape(src.shape) for o in outs]


def _layouts(flat: torch.Tensor):
    """The same values as 2-d and 3-d planes: contiguous, sizes not a
    multiple of 4, and strided views of padded buffers."""
    n = flat.numel()
    yield flat.reshape(1, n)
    yield flat[: (n // 3) * 3].reshape(3, 1, n // 3)
    yield flat[:3 * 7 * 13].reshape(3, 7, 13)
    yield flat[:1].reshape(1, 1)
    pad = torch.zeros((3, 11, 29), dtype=flat.dtype, device=flat.device)
    pad[:, :9, :23] = flat[:3 * 9 * 23].reshape(3, 9, 23)
    yield pad[:, :9, :23]
    yield pad[1, 2:9, 4:20]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_to_host_is_the_plain_version(cuda, dtype):
    """to_host against to_host_plain on the card, bit for bit: float32
    planes through the quantize (every level and its neighbours, NaN,
    infinities, negatives, values above 1), uint8 planes at all 256
    values; contiguous and strided sources, sizes not a multiple of 4,
    one and two destinations, destinations off 16-byte alignment."""
    if dtype == "float32":
        flat = _special_floats().to(cuda)
    else:
        rng = np.random.default_rng(2)
        flat = torch.from_numpy(np.concatenate([
            np.arange(256, dtype=np.uint8),
            rng.integers(0, 256, 1031, dtype=np.uint8)])).to(cuda)
    kernels.reset_launches()
    launches = 0
    for src in _layouts(flat):
        want = _plain(src)
        for n_dst, offset in ((1, 0), (2, 0), (1, 1), (2, 3)):
            got = _launch(src, n_dst, offset)
            launches += 1
            for g in got:
                assert _bits_equal(g, want), (tuple(src.shape), n_dst,
                                              offset)
    assert kernels.LAUNCHES["to_host"] == launches


@pytest.mark.cuda
def test_to_host_refuses_what_it_cannot_write(cuda):
    src = torch.zeros((3, 4, 4), device=cuda)
    with pytest.raises(ValueError, match="pinned"):
        to_host.to_host([(src, (torch.empty(48),))])
    with pytest.raises(ValueError, match="bad source"):
        to_host.to_host([(src.double(), (torch.empty(48, pin_memory=True),))])
    with pytest.raises(ValueError, match="one device"):
        to_host.to_host([(src, (torch.empty(48, pin_memory=True),)),
                         (src.cpu(), (torch.empty(48),))])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2])
def test_vis_frames_on_the_card(cuda, n, monkeypatch):
    """vis at B = 1 and 2: C-contiguous float32 arrays of the old shapes,
    equal bit for bit to the old arithmetic on the frames rendered, a mask
    that does not alias alpha, one to_host launch a camera and one wait."""
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss

    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    model = _model("demo", cuda)
    renderer = NaiveRendererAndLoss(split="demo", device=cuda)
    renderer.vis(_batch(n), model)          # sizes the frame's buckets
    frames = _captured(model)
    kernels.reset_launches()
    out = renderer.vis(_batch(n), model)
    assert kernels.LAUNCHES["to_host"] == n
    assert list(out) == ["render", "alpha", "mask"]
    shapes = {"render": (n, 3, H, W), "alpha": (n, H, W), "mask": (n, H, W)}
    for key, shape in shapes.items():
        a = out[key]
        assert a.dtype == np.float32 and a.shape == shape
        assert a.flags["C_CONTIGUOUS"]
    want_r = np.stack([_old_frame(f["render"]) for f in frames])
    want_a = np.stack([_old_frame(f["alpha"]) for f in frames])
    assert want_r.std() > 0.01
    assert _bits_equal(out["render"], want_r)
    assert _bits_equal(out["alpha"], want_a)
    assert _bits_equal(out["mask"], want_a)
    assert not np.shares_memory(out["alpha"], out["mask"])


@pytest.mark.cuda
def test_kept_frame_holds_its_values(cuda, monkeypatch):
    """A frame the caller keeps is not overwritten by 5 later vis calls:
    PyTorch's pinned cache never hands its blocks out while they live."""
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss

    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    model = _model("demo", cuda)
    renderer = NaiveRendererAndLoss(split="demo", device=cuda)
    bgs = np.random.default_rng(4).uniform(size=(6, 3)).astype(np.float32)
    kept = renderer.vis(_batch(1), model, background=bgs[0])
    copies = {k: v.copy() for k, v in kept.items()}
    later = [renderer.vis(_batch(1), model, background=bg)["render"]
             for bg in bgs[1:]]
    assert any(not np.array_equal(r, copies["render"]) for r in later)
    for key, value in copies.items():
        assert np.array_equal(kept[key], value), key


@pytest.mark.cuda
def test_step_gt_on_the_card(cuda, monkeypatch):
    """training_step's output GT is the 8-bit GT / 255 in float32, bit for
    bit, written by one to_host launch a step from the device GT (a cache
    miss, then a hit)."""
    from log_tpu_torch.render.renderer import NaiveRendererAndLoss
    from log_tpu_torch.utils.trainer import Trainer

    monkeypatch.setenv("LOG_TPU_BACKEND", "tiled")
    model = _model("train", cuda)
    renderer = NaiveRendererAndLoss(split="train", use_randback=True,
                                    device=cuda)
    trainer = Trainer({}, model, renderer, seed=5)
    trainer.set_gt_cache(True)
    rng = np.random.default_rng(6)
    images = [_step_image(rng) for _ in range(2)]
    for step in range(4):
        image = images[step % 2]
        batch = _batch(1, image)
        batch["index"] = np.asarray([step % 2])
        trainer.global_iterations = step + 1
        kernels.reset_launches()
        _, out, _ = trainer.training_step(model, batch)
        assert kernels.LAUNCHES["to_host"] == 1
        gt = out["gt"]
        assert gt.flags["C_CONTIGUOUS"]
        assert _bits_equal(
            gt, image[0].transpose(2, 0, 1).astype(np.float32) / 255.0)
