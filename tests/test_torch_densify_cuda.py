"""The device densify functions on the card against the same functions on
the CPU (which tests/test_torch_densify.py holds against log_tpu).

Marked `cuda`: each test skips without a CUDA device. Run them on the GPU
machine with

    python -m pytest tests/test_torch_densify_cuda.py -q -m cuda --noconftest

Flags must be equal, the keep guard must take the lower row among equal
weights (a stable sort; torch.topk on CUDA promises no order among ties),
and the rebuilt arrays must agree to 1e-6 (the bisection's float32 math
may contract differently on the card).
"""
import numpy as np
import pytest
import torch

from log_tpu_torch.model import densify_device as dd
from log_tpu_torch.model.counter import init_counter
from log_tpu_torch.model.gaussian import next_capacity

pytestmark = pytest.mark.cuda
KEYS = ("xyz", "colors", "scaling", "opacity", "rotation", "shs")
CAP, N = 4096, 3500


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _state(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(CAP, 4))
    params = {
        "xyz": rng.normal(size=(CAP, 3)),
        "colors": rng.normal(size=(CAP, 3)),
        "scaling": np.log(rng.uniform(0.002, 0.3, (CAP, 3))),
        "opacity": rng.normal(size=(CAP, 1)),
        "rotation": q / np.linalg.norm(q, axis=1, keepdims=True),
        "shs": 0.1 * rng.normal(size=(CAP, 3, 3)),
    }
    params["scaling"][:200] = np.log(0.1)  # equal scales on all axes
    counter = init_counter(CAP)
    counter.update(
        weights_max=rng.uniform(0, 1, CAP), grad_sum=rng.uniform(0, 0.01, CAP),
        radii_max_max=rng.integers(0, 2000, CAP),
        area_sum=rng.integers(0, 5, CAP), visible_count=rng.integers(0, 8, CAP),
        create_steps=rng.integers(0, 200, CAP),
        radius3d_min=rng.uniform(1e-4, 1e-3, CAP))
    counter = {k: v.astype(init_counter(1)[k].dtype) for k, v in counter.items()}
    tree = {"node_index": np.where(rng.uniform(size=CAP) < 0.7, -1,
                                   rng.integers(0, 50, CAP)),
            "depth": rng.integers(0, 4, CAP)}
    rand_u = rng.uniform(size=(2, CAP))
    f32 = {k: v.astype(np.float32) for k, v in params.items()}
    i32 = {k: v.astype(np.int32) for k, v in tree.items()}
    return f32, counter, i32, rand_u.astype(np.float32)


def _on(d, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in d.items()}


@pytest.mark.parametrize("mode", ["split_by_2d", "split_by_3d"])
def test_init_stage_flags_cuda_equal_cpu(cuda, mode):
    params, counter, _, rand_u = _state()
    args = (1.0, 1.0, 0.1, 4.0, 16.0, 50, 0.0002)
    outs = [dd.init_stage_flags(_on(params, dev), _on(counter, dev), N,
                                torch.from_numpy(rand_u).to(dev), *args,
                                mode=mode)
            for dev in ("cpu", cuda)]
    for a, b in zip(outs[0][:3], outs[1][:3]):
        assert torch.equal(a, b.cpu())


def test_keep_guard_ties_cuda(cuda):
    """Every weight equal and under the threshold: the 16 lowest rows
    stay, as jax.lax.top_k keeps them."""
    params, counter, _, rand_u = _state()
    counter["weights_max"][:] = 0.01
    out = dd.init_stage_flags(_on(params, cuda), _on(counter, cuda), N,
                              torch.from_numpy(rand_u).to(cuda), 1.0, 1.0,
                              0.1, 4.0, 16.0, 50, 0.0002)
    kept = torch.nonzero(~out[1][:N]).flatten().cpu()
    assert kept.tolist() == list(range(16))


@pytest.mark.parametrize("sort_method", ["radii", "opacity", "grad"])
def test_depth_stage_flags_cuda_equal_cpu(cuda, sort_method):
    params, counter, tree, _ = _state(1)
    counter["create_steps"][:] = 1000
    outs = [dd.depth_stage_flags(_on(params, dev), _on(counter, dev),
                                 _on(tree, dev), N, 20, 100, 0.0002, 6, 0.3,
                                 20000, sort_method=sort_method)
            for dev in ("cpu", cuda)]
    assert torch.equal(outs[0][0], outs[1][0].cpu())
    assert torch.equal(outs[0][1], outs[1][1].cpu())
    assert bool(outs[1][2]["over"])


def test_rebuild_split_remove_cuda_close_to_cpu(cuda):
    params, counter, _, _ = _state(2)
    rng = np.random.default_rng(3)
    alive = np.arange(CAP) < N
    flag_split = (rng.uniform(size=CAP) < 0.1) & alive
    flag_split[:200:3] = alive[:200:3]  # equal-scale parents among them
    flag_remove = (rng.uniform(size=CAP) < 0.2) & alive & ~flag_split
    mom = {mk: {k: rng.normal(size=v.shape).astype(np.float32)
                for k, v in params.items()} for mk in ("exp_avg", "exp_avg_sq")}
    n_split = int(flag_split.sum())
    new_n = N - int(flag_remove.sum()) + 4 * n_split
    kw = dict(new_cap=next_capacity(new_n),
              s_cap=next_capacity(n_split, 256), n_child=4,
              remove_split=False, keys=KEYS, scaling_decay=0.9,
              radius3d_max_fill=-1.0)
    outs = [dd.rebuild_split_remove(
        _on(params, dev), {mk: _on(v, dev) for mk, v in mom.items()},
        _on(counter, dev), torch.from_numpy(flag_split).to(dev),
        torch.from_numpy(flag_remove).to(dev), N, **kw)
        for dev in ("cpu", cuda)]
    assert int(outs[0][3]) + int(outs[0][4]) == new_n
    for i in range(3):
        flat_c = outs[0][i] if i != 1 else {
            f"{mk}.{k}": v for mk, d in outs[0][1].items() for k, v in d.items()}
        flat_g = outs[1][i] if i != 1 else {
            f"{mk}.{k}": v for mk, d in outs[1][1].items() for k, v in d.items()}
        for key, a in flat_c.items():
            b = flat_g[key].cpu()
            if a.is_floating_point():
                torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6,
                                           msg=key)
            else:
                assert torch.equal(a, b), key
