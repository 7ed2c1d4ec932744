"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`: each test skips without a CUDA device (no nvcc or GPU on a
CPU-only host). Run them on the GPU machine with

    python -m pytest tests/test_torch_kernels_cuda.py -q -m cuda

K4, K3, K3p and K6 are copies and must be bit-exact (K6 also at the edges
of its contract and over back-to-back calls); K1 (and K5) composites
sequentially per pixel where the plain version takes a cumprod per chunk: products round
differently, so a pair may cross the alpha >= 1/255 or T >= 1e-4 gate in
one and not the other (<= ~4e-3 on a pixel); colors and transmittance agree
to 5e-3 at most and 1e-6 on average, argmax ids and pair weights up to
those rare flips. K2 recovers each pair's transmittance by division where
the plain version divides by a suffix cumprod; per-pair gradients agree to
1e-3 of the largest, and the kernel's fixed-order block sums make it
bit-reproducible.
"""
import math

import numpy as np
import pytest
import torch

from log_tpu_torch.dataset.base import prepare_camera
from log_tpu_torch.ops import expand as expand_mod
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

    monkeypatch.setattr(expand_mod, "expand_with_keys", record)
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


def _backward_args(cuda, n=4000, seed=1):
    splats, col, A = _pairs(cuda, n=n, seed=seed)
    pk = rt.build_pairs(splats, col, H, W, A)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)
    fwd = rt.rasterize_forward(pk["pair_data"], pk["tile_start"],
                               pk["tile_count"], bg, pk["tiles_x"],
                               pk["tiles_y"], True)
    g = torch.Generator(device=cuda).manual_seed(seed)
    dcolor = torch.randn(fwd[0].shape, device=cuda, generator=g)
    dalpha = torch.randn(fwd[1].shape, device=cuda, generator=g)
    return (pk["pair_data"], pk["tile_start"], pk["tile_count"], fwd[5],
            fwd[1], dcolor, dalpha, bg, pk["tiles_x"], pk["tiles_y"])


def test_rasterize_backward_kernel(cuda):
    args = _backward_args(cuda)
    before = kernels.LAUNCHES["rasterize_bwd"]
    got = rt.rasterize_backward(*args)
    again = rt.rasterize_backward(*args)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rasterize_bwd"] == before + 2
    want = rt.rasterize_backward_plain(*args)
    scale = want[:9].abs().max()
    assert scale > 0
    assert (got[:9] - want[:9]).abs().max() <= 1e-3 * scale
    assert torch.equal(got[9:], torch.zeros_like(got[9:]))
    assert torch.equal(_bits(got), _bits(again))  # deterministic


def test_rasterize_tiled_grads_kernel_vs_cpu(cuda):
    """The autograd chain (K1, K2, K4, the sort, K3) on the card against
    the same chain through the plain versions on the CPU."""
    rng = np.random.default_rng(2)
    n = 600
    inputs = {
        "xyz": rng.uniform(-1, 1, (n, 3)), "colors": rng.uniform(0, 1, (n, 3)),
        "opacity": rng.uniform(0.3, 0.95, n),
        "scaling": rng.uniform(0.01, 0.08, (n, 3)),
        "means2d_offset": np.zeros((n, 2)),
    }
    q = rng.normal(size=(n, 4))
    K = np.array([[400.0, 0, W / 2], [0, 400.0, H / 2], [0, 0, 1]])
    pc = prepare_camera({"K": K, "R": np.eye(3), "T": np.array([[0.0], [0.0], [4.0]]),
                         "H": H, "W": W, "center": np.array([[0.0], [0.0], [-4.0]])},
                        1, 0.01, 100.0)
    tx, ty = math.tan(pc["FoVx"] / 2), math.tan(pc["FoVy"] / 2)
    grads = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
        leaves = {k: t(v).requires_grad_(True) for k, v in inputs.items()}
        out = rt.rasterize_tiled(
            rotation=t(q / np.linalg.norm(q, axis=1, keepdims=True)),
            world_view=t(pc["world_view_transform"]),
            full_proj=t(pc["full_proj_transform"]), focal_x=W / (2 * tx),
            focal_y=H / (2 * ty), tan_fovx=tx, tan_fovy=ty,
            background=t([0.1, 0.2, 0.3]), image_height=H, image_width=W,
            max_pairs=1 << 16, **leaves,
        )
        (out["render"].square().sum() + out["alpha"].sum()).backward()
        grads[str(dev)] = {k: v.grad.cpu() for k, v in leaves.items()}
    for k in inputs:
        want, got = grads["cpu"][k], grads["cuda"][k]
        assert (got - want).abs().max() <= 1e-3 * want.abs().max(), k


def test_wrappers_reject_cpu_mixing(cuda):
    rows = [torch.zeros(8, device=cuda), torch.zeros(8)]
    with pytest.raises(ValueError):
        rt.pack_rows(rows)
    args = list(_backward_args(cuda, n=200))
    args[5] = args[5].cpu()  # dcolor on the host
    with pytest.raises(ValueError):
        rt.rasterize_backward(*args)


# ------------------------------------------------------------ K3p, K5, K6
def _packed_input(cuda, P, n_valid, A, seed=0, tiles_x=4, tiles_y=16):
    """A (16, P + 768) K3p input as the column render path builds it."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    w = torch.randint(1, tiles_x + 1, (P,), device=cuda, generator=g)
    h = torch.randint(1, 4, (P,), device=cuda, generator=g)
    x0 = torch.randint(0, 1 << 20, (P,), device=cuda, generator=g) % (
        tiles_x - w + 1)
    y0 = torch.randint(0, 1 << 20, (P,), device=cuda, generator=g) % (
        tiles_y - h + 1)
    counts = torch.where(torch.arange(P, device=cuda) < n_valid, w * h, 0)
    csum = torch.cumsum(counts, 0)
    offs = torch.clamp(csum - counts, max=A).to(torch.float32)
    total = torch.clamp(csum[-1], max=A).to(torch.int32)
    geo = (x0 + 32 * (y0 + 512 * w)).to(torch.float32)
    rows = [torch.randn(P, device=cuda, generator=g) for _ in range(10)]
    rows += [offs, geo, torch.randperm(P, device=cuda, generator=g).float(),
             offs, torch.cat([offs[1:], offs.new_full((1,), float(A))])]
    packed = rt.pack_rows([r.contiguous() for r in rows], 16,
                          expand_mod.PACKED_SPARE)
    packed[expand_mod.ROW_OFFS:expand_mod.ROW_NEXT + 1, P:] = float(A)
    return packed, total, tiles_x, tiles_x * tiles_y


@pytest.mark.parametrize("n_valid", [20000, 1, 0])
def test_expand_packed_kernel_exact(cuda, n_valid):
    """K3p against its plain version, bit-exact everywhere (both copy the
    last run past `total`). n_valid = 0: an empty-tail window, every run
    zero-length and total = 0."""
    P, A = rt.PACK_CHUNK, 1 << 16
    packed, total, tiles_x, num_tiles = _packed_input(cuda, P, n_valid, A)
    before = kernels.LAUNCHES["expand_packed"]
    got = expand_mod.expand_packed_with_keys(packed, P, total, A, tiles_x,
                                             num_tiles)
    assert kernels.LAUNCHES["expand_packed"] == before + 1
    want = expand_mod.expand_packed_with_keys_plain(packed, P, total, A,
                                                    tiles_x, num_tiles)
    for a, b in zip(got, want):
        assert torch.equal(_bits(a), _bits(b))
    assert int((got[1] < num_tiles).sum()) == int(total)


def test_rasterize_forward_packed_kernel(cuda):
    """K5 against its plain version on the column path's packed records;
    K1's tolerances (sequential compositing vs a cumprod per chunk)."""
    from log_tpu_torch.ops.projection import SplatCols

    splats, col, A = _pairs(cuda)
    cols = SplatCols(px=splats.pix_xy[:, 0].contiguous(),
                     py=splats.pix_xy[:, 1].contiguous(),
                     cxx=splats.conic[:, 0].contiguous(),
                     cxy=splats.conic[:, 1].contiguous(),
                     cyy=splats.conic[:, 2].contiguous(),
                     opacity=splats.opacity, depth=splats.depth,
                     radius=splats.radius, valid=splats.valid)
    es = rt.expand_sort_pairs(cols, tuple(col.T.contiguous()), H, W, A,
                              runs_tail_only=True, inference_pack=True)
    starts = torch.searchsorted(
        es["tile_s"], torch.arange(es["num_tiles"] + 1, dtype=torch.int32,
                                   device=cuda)).to(torch.int32)
    pd = rt.pack_rows(list(es["packed6"]), rt.P_N_ROWS, rt.PAIR_CHUNK)
    args = (pd, starts[:-1], starts[1:] - starts[:-1],
            torch.tensor([0.1, 0.2, 0.3], device=cuda), es["tiles_x"],
            es["tiles_y"])
    before = kernels.LAUNCHES["rasterize_fwd_packed"]
    got = rt.rasterize_forward_packed(*args)
    assert kernels.LAUNCHES["rasterize_fwd_packed"] == before + 1
    want = rt.rasterize_forward_packed_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert (a - b).abs().max() < 5e-3
        assert (a - b).abs().mean() < 1e-5
    assert float(got[1].min()) < 0.5


@pytest.mark.parametrize("density,k_frac", [(0.13, 0.25), (0.8, 0.5),
                                            (0.02, 0.05), (1.0, 1.0),
                                            (0.0, 0.5)])
def test_stream_compact_kernel_exact(cuda, density, k_frac):
    """K6 against its plain version: bit-exact, with NaN payloads, int32
    values past 2^24, a capacity that is not a block multiple, more kept
    rows than k and fewer."""
    from log_tpu_torch.ops.compact import (stream_compact_cols,
                                           stream_compact_cols_plain)

    g = torch.Generator(device=cuda).manual_seed(int(density * 100))
    cap = 3 * 8192 * 17 + 77
    k = max(128, int(cap * k_frac) // 128 * 128)
    keep = torch.rand(cap, device=cuda, generator=g) < density
    px = torch.randn(cap, device=cuda, generator=g) * 500
    px[::7] = float("nan")
    cols = {
        "px": px,
        "p1": torch.randint(-(1 << 31), 1 << 31, (cap,), device=cuda,
                            generator=g, dtype=torch.int64).to(torch.int32),
        "big": torch.arange(cap, device=cuda, dtype=torch.int32) + (1 << 24),
    }
    before = kernels.LAUNCHES["stream_compact"]
    got = stream_compact_cols(cols, keep, k)
    assert kernels.LAUNCHES["stream_compact"] == before + 1
    want = stream_compact_cols_plain(cols, keep, k)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for n in cols:
        assert torch.equal(_bits(got[0][n]), _bits(want[0][n])), n
    assert int(got[2].sum()) == min(k, int(keep.sum()))


# --------------------------------------- K1 / K2 footprint culling, staging
def _adversarial(cuda, seed, pstride_mult4=False, misalign=False,
                 packed=False):
    """tests/test_torch_footprint.py's 2 x 2 tiles on the card: boxes
    ending on patch borders, op = f32(1/255) and just below, thin,
    degenerate and NaN conics, tile-wide splats, a run of 10 chunks that
    saturates mid-chunk. Its pstride is not a multiple of 4 (4-byte
    copies); pstride_mult4 pads it to one (16-byte copies), misalign
    places the array 4 bytes past a 16-byte boundary (4-byte copies).
    packed: the same records as K5's (8, pstride) bf16 words, log-opacities
    at and next to ln f32(1/255)."""
    from test_torch_footprint import _packed_tile_pairs, _tile_pairs

    pair, ts, tc, tiles_x, tiles_y = (_packed_tile_pairs if packed
                                      else _tile_pairs)(seed)
    rows, ps = pair.shape
    if pstride_mult4:
        ps = (ps + 3) // 4 * 4
    flat = torch.zeros(rows * ps + 4, device=cuda)
    off = 1 if misalign else 0
    data = flat[off:off + rows * ps].view(rows, ps)
    data[:, :pair.shape[1]] = pair.to(cuda)
    assert (data.data_ptr() % 16 == 0) != misalign
    return (data, ts.to(cuda), tc.to(cuda),
            torch.tensor([0.1, 0.2, 0.3], device=cuda), tiles_x, tiles_y)


@pytest.mark.parametrize("with_stats", [False, "weights", True])
@pytest.mark.parametrize("seed", [3, 4])
def test_rasterize_forward_adversarial(cuda, with_stats, seed):
    """K1 on adversarial records against its plain version (K1's
    tolerances), and the same bits from the 16-byte and 4-byte copies."""
    args = _adversarial(cuda, seed)
    got = rt.rasterize_forward(*args, with_stats)
    want = rt.rasterize_forward_plain(*args, with_stats)
    torch.cuda.synchronize()
    assert torch.equal(got[5], want[5])
    assert int(got[5][1]) < 10  # tile 1 stopped on saturation
    for a, b in zip(got[:2], want[:2]):
        assert (a - b).abs().max() < 5e-3
        assert (a - b).abs().mean() < 1e-5
    assert (got[2] != want[2]).float().mean() < 1e-2
    assert ((got[4] - want[4]).abs() > 1e-6).float().mean() < 1e-2
    for variant in ({"pstride_mult4": True}, {"misalign": True},
                    {"pstride_mult4": True, "misalign": True}):
        other = rt.rasterize_forward(*_adversarial(cuda, seed, **variant),
                                     with_stats)
        n = args[0].shape[1]
        for a, b in zip(got, other):
            if a.dim() == 1 and a.numel() != b.numel():  # pair_w
                b = b[:n]
            assert torch.equal(_bits(a), _bits(b)), variant


def denormal_tile(n_opaque=20, n_soft=600):
    """K2's inputs for one 8 x 128 tile whose every pixel is covered by
    n_opaque pairs of alpha 0.99, then n_soft of alpha 0.3: the final
    transmittance of K1's sequential f32 product (emulated here) falls to
    ~1e-40 and then stays at the smallest denormal, which rounds back to
    itself when multiplied by 0.7. Returns the args of
    rasterize_backward."""
    from log_tpu_torch.ops import rasterize_tiled as rt

    n = n_opaque + n_soft
    A = -(-n // rt.PAIR_CHUNK) * rt.PAIR_CHUNK
    pair = np.zeros((rt.N_ROWS, A + rt.PAIR_CHUNK), np.float32)
    pair[rt.ROW_PX, :n], pair[rt.ROW_PY, :n] = 64.0, 4.0
    pair[rt.ROW_CXX, :n] = pair[rt.ROW_CYY, :n] = 1e-4
    pair[rt.ROW_OPAC, :n] = [0.999] * n_opaque + [0.3] * n_soft
    pair[rt.ROW_R:rt.ROW_B + 1, :n] = 0.5
    ys, xs = np.mgrid[0:rt.TILE_H, 0:rt.TILE_W].astype(np.float32)
    T = np.ones((rt.TILE_H, rt.TILE_W), np.float32)
    for k in range(n):  # K1's sequential product, in f32
        dx, dy = pair[rt.ROW_PX, k] - xs, pair[rt.ROW_PY, k] - ys
        power = np.float32(-0.5) * (pair[rt.ROW_CXX, k] * dx * dx
                                    + pair[rt.ROW_CYY, k] * dy * dy)
        alpha = np.minimum(np.float32(0.99),
                           pair[rt.ROW_OPAC, k] * np.exp(power))
        T = T * np.where(alpha >= np.float32(1 / 255), 1 - alpha,
                         np.float32(1)).astype(np.float32)
    t = torch.from_numpy
    return (t(pair), torch.zeros(1, dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32),
            torch.tensor([A // rt.PAIR_CHUNK], dtype=torch.int32),
            t(T), torch.full((3, rt.TILE_H, rt.TILE_W), 0.1),
            torch.zeros(rt.TILE_H, rt.TILE_W), torch.zeros(3), 1, 1)


def test_rasterize_backward_denormal_transmittance(cuda):
    """K2 where K1's transmittance stuck at a denormal (F10): no gradient
    for those pixels, as the plain version; a few layers above the normal
    range keep their gradients, to the K2 tolerance."""
    for kw in ({}, {"n_opaque": 2, "n_soft": 10}):
        args = denormal_tile(**kw)
        dev_args = [a.to(cuda) if isinstance(a, torch.Tensor) else a
                    for a in args]
        got = rt.rasterize_backward(*dev_args).cpu()
        want = rt.rasterize_backward_plain(*args)
        assert torch.isfinite(got).all()
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-3 * max(scale, 1e-30)
        assert (scale > 0) == bool(kw)


@pytest.mark.parametrize("seed", [3, 4])
def test_rasterize_backward_adversarial(cuda, seed):
    """K2 on adversarial records: within 1e-3 of the plain version's
    largest gradient where that is finite (the plain version turns NaN
    conics into NaN rows, the kernel into zeros), bit-identical across two
    launches and across the 16-byte and 4-byte copies."""
    args = _adversarial(cuda, seed)
    fwd = rt.rasterize_forward(*args, True)
    g = torch.Generator(device=cuda).manual_seed(seed)
    dcolor = torch.randn(fwd[0].shape, device=cuda, generator=g)
    dalpha = torch.randn(fwd[1].shape, device=cuda, generator=g)
    bargs = (args[0], args[1], args[2], fwd[5], fwd[1], dcolor, dalpha,
             args[3], args[4], args[5])
    got = rt.rasterize_backward(*bargs)
    again = rt.rasterize_backward(*bargs)
    want = rt.rasterize_backward_plain(*bargs)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))
    finite = torch.isfinite(want).all(dim=0)
    scale = want[:9, finite].abs().max()
    assert scale > 0
    assert (got[:9, finite] - want[:9, finite]).abs().max() <= 1e-3 * scale
    assert torch.isfinite(got).all()
    n = args[0].shape[1]
    for variant in ({"pstride_mult4": True}, {"misalign": True}):
        a2 = _adversarial(cuda, seed, **variant)
        other = rt.rasterize_backward(a2[0], a2[1], a2[2], fwd[5], fwd[1],
                                      dcolor, dalpha, a2[3], a2[4], a2[5])
        assert torch.equal(_bits(got), _bits(other[:, :n])), variant


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_rasterize_forward_packed_adversarial(cuda, seed):
    """K5 on packed adversarial records against its plain version (K5's
    tolerances), and the same bits from the 16-byte and 4-byte copies."""
    args = _adversarial(cuda, seed, packed=True)
    before = kernels.LAUNCHES["rasterize_fwd_packed"]
    got = rt.rasterize_forward_packed(*args)
    assert kernels.LAUNCHES["rasterize_fwd_packed"] == before + 1
    want = rt.rasterize_forward_plain(*args, False, packed=True)
    torch.cuda.synchronize()
    assert int(want[5][1]) < 10  # tile 1 stopped on saturation
    for a, b in zip(got, want[:2]):
        assert (a - b).abs().max() < 5e-3
        assert (a - b).abs().mean() < 1e-5
    for variant in ({"pstride_mult4": True}, {"misalign": True},
                    {"pstride_mult4": True, "misalign": True}):
        other = rt.rasterize_forward_packed(
            *_adversarial(cuda, seed, packed=True, **variant))
        for a, b in zip(got, other):
            assert torch.equal(_bits(a), _bits(b)), variant


def _compact_inputs(cuda, cap, density, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    keep = torch.rand(cap, device=cuda, generator=g) < density
    px = torch.randn(cap, device=cuda, generator=g) * 500
    px[::7] = float("nan")
    cols = {
        "px": px,
        "p1": torch.randint(-(1 << 31), 1 << 31, (cap,), device=cuda,
                            generator=g, dtype=torch.int64).to(torch.int32),
        "big": torch.arange(cap, device=cuda, dtype=torch.int32) + (1 << 24),
    }
    return cols, keep


def _same_compaction(got, want):
    return (torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
            and all(torch.equal(_bits(got[0][n]), _bits(want[0][n]))
                    for n in want[0]))


# (cap, k, keep density) at the edges of K6's contract (also replayed
# against another version of the kernel by torch_ab_k1_k2.py)
COMPACT_EDGE_CASES = (
    (5000, 0, 0.5),               # k = 0
    (3 * 1024 + 5, 3 * 1024 + 5, 0.7),  # k = cap
    (1, 1, 1.0), (1, 1, 0.0),     # cap = 1
    (70001, 10000, 0.9),          # more kept rows than k
    (1024 * 40 + 1000, 2048, 0.01),  # fewer, cap not a multiple of 1024
    (9_000_017, 3_000_000, 0.3),  # more than 32 tiles per block
)


@pytest.mark.parametrize("cap,k,density", COMPACT_EDGE_CASES)
def test_stream_compact_kernel_edges(cuda, cap, k, density):
    """K6's one cooperative launch at the edges of its contract, bit-exact
    against its plain version."""
    from log_tpu_torch.ops.compact import (stream_compact_cols,
                                           stream_compact_cols_plain)

    cols, keep = _compact_inputs(cuda, cap, density, cap % 1000)
    before = kernels.LAUNCHES["stream_compact"]
    got = stream_compact_cols(cols, keep, k)
    assert kernels.LAUNCHES["stream_compact"] == before + 1
    want = stream_compact_cols_plain(cols, keep, k)
    assert _same_compaction(got, want)
    assert int(got[2].sum()) == min(k, int(keep.sum()))


def test_stream_compact_kernel_sixteen_columns(cuda):
    """More than 8 columns take the kernel's 16-column instantiation."""
    from log_tpu_torch.ops.compact import (stream_compact_cols,
                                           stream_compact_cols_plain)

    cols, keep = _compact_inputs(cuda, 50_001, 0.4, 7)
    g = torch.Generator(device=cuda).manual_seed(8)
    for i in range(13):
        cols[f"x{i}"] = torch.randn(keep.shape[0], device=cuda, generator=g)
    assert len(cols) == 16
    got = stream_compact_cols(cols, keep, 30_000)
    assert _same_compaction(got, stream_compact_cols_plain(cols, keep, 30_000))


def test_stream_compact_kernel_back_to_back(cuda):
    """50 calls on one stream with a different mask (and k) each, launched
    back to back and only then compared: every one bit-exact against its
    plain version, so no state carries over from one call to the next."""
    from log_tpu_torch.ops.compact import (stream_compact_cols,
                                           stream_compact_cols_plain)

    cap = 3 * 8192 * 17 + 77
    cols, _ = _compact_inputs(cuda, cap, 0.5, 0)
    g = torch.Generator(device=cuda).manual_seed(1)
    runs = []
    for i in range(50):
        density = (i % 10) / 9.0
        keep = torch.rand(cap, device=cuda, generator=g) < density
        k = [cap, cap // 2, 128, 0][i % 4]
        runs.append((keep, k, stream_compact_cols(cols, keep, k)))
    torch.cuda.synchronize()
    for keep, k, got in runs:
        assert _same_compaction(got, stream_compact_cols_plain(cols, keep, k))
