"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`: each test skips without a CUDA device (no nvcc or GPU on a
CPU-only host). Run them on the GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

K4 and K3 are copies and must be bit-exact; K1 composites sequentially per
pixel where the plain version takes a cumprod per chunk: products round
differently, so a pair may cross the alpha >= 1/255 or T >= 1e-4 gate in
one and not the other (<= ~4e-3 on a pixel); colors and transmittance agree
to 5e-3 at most and 1e-6 on average, argmax ids and pair weights up to
those rare flips.
"""
import math

import numpy as np
import pytest
import torch

from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.ops import kernels
from log_tpu_torch.ops import rasterize_tiled as rt
from log_tpu_torch.ops.expand import expand_with_keys, expand_with_keys_plain
from log_tpu_torch.ops.projection import project_gaussians

pytestmark = pytest.mark.cuda
H, W = 256, 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _bits(t):
    return t.contiguous().view(-1).view(torch.int32)


def _pairs(device, n=4000, seed=0, A=1 << 16):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    scl = rng.uniform(0.01, 0.08, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    op = rng.uniform(0.3, 0.95, n).astype(np.float32)
    col = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    K = np.array([[400.0, 0, W / 2], [0, 400.0, H / 2], [0, 0, 1]])
    cam = {"K": K, "R": np.eye(3), "T": np.array([[0.0], [0.0], [4.0]]),
           "H": H, "W": W, "center": np.array([[0.0], [0.0], [-4.0]])}
    pc = prepare_camera(cam, 1, 0.01, 100.0)
    t = lambda a: torch.from_numpy(np.asarray(a)).to(device)  # noqa: E731
    tx, ty = math.tan(pc["FoVx"] / 2), math.tan(pc["FoVy"] / 2)
    splats = project_gaussians(
        t(xyz), t(scl), t(q), t(op), t(pc["world_view_transform"]),
        t(pc["full_proj_transform"]), W / (2 * tx), H / (2 * ty), tx, ty, H,
        W, tight_radius=True,
    )
    return splats, t(col), A


def test_pack_rows_kernel_exact(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    A = 3 * (1 << 15)
    rows = [torch.randn(A, device=cuda, generator=g) for _ in range(10)]
    rows.append(torch.randint(0, 1 << 30, (A,), device=cuda, generator=g,
                              dtype=torch.int32))
    before = kernels.LAUNCHES["pack_rows"]
    got = rt.pack_rows(rows)
    assert kernels.LAUNCHES["pack_rows"] == before + 1
    assert torch.equal(_bits(got), _bits(rt.pack_rows_plain(rows)))


@pytest.mark.parametrize("A", [1 << 16, 1 << 12])
def test_expand_kernel_exact(cuda, A, monkeypatch):
    """A = 4096 overflows the budget: the tail clamps to A."""
    splats, col, _ = _pairs(cuda)
    calls = []

    def record(*args):
        calls.append(args)
        return expand_with_keys(*args)

    monkeypatch.setattr(rt, "expand_with_keys", record)
    es = rt.expand_sort_pairs(splats, col, H, W, A, runs_tail_only=True)
    assert (int(es["total"]) > A) == (A == 1 << 12)
    args = calls[0]
    for a, b in zip(expand_with_keys(*args), expand_with_keys_plain(*args)):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("with_stats", [False, "weights", True])
def test_rasterize_forward_kernel(cuda, with_stats):
    splats, col, A = _pairs(cuda)
    pk = rt.build_pairs(splats, col, H, W, A, runs_tail_only=True)
    args = (pk["pair_data"], pk["tile_start"], pk["tile_count"],
            torch.tensor([0.1, 0.2, 0.3], device=cuda), pk["tiles_x"],
            pk["tiles_y"], with_stats)
    got = rt.rasterize_forward(*args)
    want = rt.rasterize_forward_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got[:2], want[:2]):
        assert (a - b).abs().max() < 5e-3
        assert (a - b).abs().mean() < 1e-6
    assert (got[2] != want[2]).float().mean() < 1e-3
    assert ((got[4] - want[4]).abs() > 1e-6).float().mean() < 1e-3
    assert torch.equal(got[5], want[5])


def test_wrappers_reject_cpu_mixing(cuda):
    rows = [torch.zeros(8, device=cuda), torch.zeros(8)]
    with pytest.raises(ValueError):
        rt.pack_rows(rows)
