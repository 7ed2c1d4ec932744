"""log_tpu_torch/utils/jax_random.py against jax.random, on the CPU.

Both versions of each draw (the torch one, here on CPU tensors, and the
numpy reference) are held against jax.random itself:
- `split`, `uniform` and `randint` bit for bit: `uniform` at (2, cap) as
  the device densify draws it (cap 1, 4097, 65539 and 2**20; seeds 0, 7
  and 2**31 - 1) and at the ranges that `build_scene_device` draws;
  `randint` as `depth_patch_loss` calls it, at H, W of 64, 65, 320 and
  1088 (the port's `draw_patch_offsets`);
- `normal` within NORMAL_ULPS float32 ulps (the log1p inside XLA's erf_inv
  is XLA's own float32 approximation; at most 3 ulps in these draws);
- `np_exp` (XLA's float32 exp, which the port's LR schedule uses) bit for
  bit over a dense range, and the port's `expon_lr` equal to the JAX
  package's at every step of three schedules.

The JAX version and the two PRNG settings the module reproduces are pinned:
an upgrade that changes them fails here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from log_tpu.model.sparse_optimizer import expon_lr as expon_lr_jax
from log_tpu_torch.model.sparse_optimizer import expon_lr
from log_tpu_torch.render import loss
from log_tpu_torch.utils import jax_random as jr

SEEDS = (0, 7, 2 ** 31 - 1)
NORMAL_ULPS = 4


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _ordered(a):
    """float32 as integers that step by one per ulp across zero."""
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def test_pinned_jax_prng_config():
    assert jax.__version__ == jr.JAX_VERSION
    assert jax.config.jax_default_prng_impl == jr.PRNG_IMPL
    assert jax.config.jax_threefry_partitionable == jr.THREEFRY_PARTITIONABLE


@pytest.mark.parametrize("seed", SEEDS + (123456789,))
def test_prng_key_and_split(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(jr.prng_key(seed), np.asarray(key))
    for n in (2, 3, 10):
        want = np.asarray(jax.random.split(key, n))
        np.testing.assert_array_equal(jr.split(jr.prng_key(seed), n), want)
        np.testing.assert_array_equal(jr.np_split(jr.prng_key(seed), n),
                                      want)
    # a split key splits again as JAX's does
    sub = np.asarray(jax.random.split(jax.random.split(key)[1], 4))
    np.testing.assert_array_equal(jr.split(jr.split(jr.prng_key(seed))[1],
                                           4), sub)


@pytest.mark.parametrize("cap", [1, 4097, 65539, 1 << 20])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_keep_draws(cap, seed):
    want = _bits(jax.random.uniform(jax.random.PRNGKey(seed), (2, cap)))
    key = jr.prng_key(seed)
    got = jr.uniform(key, (2, cap), device="cpu")
    assert got.dtype == torch.float32 and got.shape == (2, cap)
    np.testing.assert_array_equal(_bits(got.numpy()), want)
    np.testing.assert_array_equal(_bits(jr.np_uniform(key, (2, cap))), want)


@pytest.mark.parametrize("lo,hi", [(-30.0, 30.0), (0.08, 0.25),
                                   (0.3, 0.95), (0.6, 1.4), (0.0, 2.0)])
def test_uniform_ranges(lo, hi):
    """XLA contracts the scale into a fused multiply-add; the port rounds
    it once too."""
    for seed in SEEDS:
        want = _bits(jax.random.uniform(jax.random.PRNGKey(seed), (3, 20001),
                                        minval=lo, maxval=hi))
        key = jr.prng_key(seed)
        np.testing.assert_array_equal(
            _bits(jr.uniform(key, (3, 20001), lo, hi, device="cpu").numpy()),
            want)
        np.testing.assert_array_equal(
            _bits(jr.np_uniform(key, (3, 20001), lo, hi)), want)


@pytest.mark.parametrize("hw", [(64, 64), (65, 320), (320, 1088),
                                (1088, 65)])
def test_patch_corners_as_depth_patch_loss_draws(hw):
    """log_tpu/render/loss.py: kr, kc = split(key); rows = randint(kr,
    (64,), 0, max(H - 64, 1)); cols likewise from kc over W."""
    H, W = hw
    for step in (0, 1, 999, 2 ** 31 - 1):
        key = jax.random.PRNGKey(step)
        kr, kc = jax.random.split(key)
        want_r = np.asarray(jax.random.randint(kr, (64,), 0, max(H - 64, 1)))
        want_c = np.asarray(jax.random.randint(kc, (64,), 0, max(W - 64, 1)))
        rows, cols = loss.draw_patch_offsets(H, W, jr.prng_key(step), "cpu")
        assert rows.dtype == torch.int64 and rows.shape == (64,)
        np.testing.assert_array_equal(rows.numpy(), want_r)
        np.testing.assert_array_equal(cols.numpy(), want_c)
        k_r, k_c = jr.np_split(jr.prng_key(step))
        np.testing.assert_array_equal(
            jr.np_randint(k_r, (64,), 0, max(H - 64, 1)), want_r)
        np.testing.assert_array_equal(
            jr.np_randint(k_c, (64,), 0, max(W - 64, 1)), want_c)


@pytest.mark.parametrize("lo,hi", [(0, 1), (-5, 3), (0, 70000),
                                   (-(2 ** 31), 2 ** 31 - 1), (3, 3)])
def test_randint_spans(lo, hi):
    """Spans past 2**16 (the multiplier's product wraps in uint32), the
    whole int32 range and an empty one."""
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.randint(key, (5000,), lo, hi))
    np.testing.assert_array_equal(
        jr.randint(jr.prng_key(11), (5000,), lo, hi, "cpu").numpy(), want)
    np.testing.assert_array_equal(
        jr.np_randint(jr.prng_key(11), (5000,), lo, hi), want)


@pytest.mark.parametrize("shape", [(400_000,), (1000, 4, 3)])
def test_normal_within_stated_ulps(shape):
    for seed in SEEDS:
        want = _ordered(jax.random.normal(jax.random.PRNGKey(seed), shape))
        key = jr.prng_key(seed)
        got = jr.normal(key, shape, device="cpu").numpy()
        ref = jr.np_normal(key, shape)
        assert got.shape == ref.shape == shape
        assert np.abs(_ordered(got) - want).max() <= NORMAL_ULPS
        assert np.abs(_ordered(ref) - want).max() <= NORMAL_ULPS
        np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_exp_and_lr_schedule_bit_for_bit():
    x = np.concatenate([np.linspace(-104, 88, 400001),
                        np.linspace(-14, -8, 100001)]).astype(np.float32)
    np.testing.assert_array_equal(_bits(jr.np_exp(x)),
                                  _bits(jax.jit(jnp.exp)(x)))
    for lr, final, max_steps in ((1.6e-4, 1.6e-6, 600), (5e-3, 5e-3, 600),
                                 (1e-3, 1e-5, 30000)):
        for step in range(0, 1300, 3):
            want = np.float32(expon_lr_jax(step, lr, final,
                                           max_steps=max_steps))
            assert np.float32(expon_lr(step, lr, final,
                                       max_steps=max_steps)) == want, step
