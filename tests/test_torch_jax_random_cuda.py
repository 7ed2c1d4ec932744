"""utils/jax_random.py's torch draws on the card against its numpy
versions on the host (the JAX package's random numbers; the CPU tests hold
both against jax.random itself).

Marked `cuda`: each test skips without a CUDA device. Run them on the GPU
machine with

    python -m pytest tests/test_torch_jax_random_cuda.py -q -m cuda \
        --noconftest

`uniform` at the device densify's shape (2, 4,194,304: the 3.24M tree's
capacity) and at build_scene's ranges, `randint` as the depth step draws
its patch corners, and `normal`, each bit for bit. (chip_smoke.py's cli
phase holds the densify's own draw in a training run the same way.)
"""
import numpy as np
import pytest
import torch

from log_tpu_torch.render.loss import draw_patch_offsets
from log_tpu_torch.utils import jax_random as jr

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same_bits(got, want):
    got = got.cpu().numpy()
    if got.dtype.kind == "f":
        return np.array_equal(got.view(np.uint32), want.view(np.uint32))
    return np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 - 1])
def test_uniform_on_the_card(cuda, seed):
    key = jr.prng_key(seed)
    shape = (2, 1 << 22)
    assert _same_bits(jr.uniform(key, shape, device=cuda),
                      jr.np_uniform(key, shape))
    for lo, hi in ((-30.0, 30.0), (0.08, 0.25), (0.3, 0.95)):
        assert _same_bits(jr.uniform(key, (4097, 3), lo, hi, cuda),
                          jr.np_uniform(key, (4097, 3), lo, hi))


@pytest.mark.parametrize("hw", [(64, 80), (256, 320), (1088, 1920)])
def test_patch_corners_on_the_card(cuda, hw):
    h, w = hw
    for step in (1, 500, 1151):
        rows, cols = draw_patch_offsets(h, w, jr.prng_key(step), cuda)
        assert rows.device.type == "cuda" and rows.dtype == torch.int64
        k_r, k_c = jr.np_split(jr.prng_key(step))
        assert _same_bits(rows, jr.np_randint(k_r, (64,), 0, max(h - 64, 1)))
        assert _same_bits(cols, jr.np_randint(k_c, (64,), 0, max(w - 64, 1)))


def test_normal_on_the_card(cuda):
    key = jr.prng_key(5)
    assert _same_bits(jr.normal(key, (1 << 20, 4), cuda),
                      jr.np_normal(key, (1 << 20, 4)))

