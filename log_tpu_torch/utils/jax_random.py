"""The JAX package's random numbers: `jax.random` of JAX 0.9.0 under its
defaults `jax_default_prng_impl = "threefry2x32"` and
`jax_threefry_partitionable = True`, bit for bit.

The JAX package draws its densify keep mask with `jax.random.uniform`
(`log_tpu/model/level_of_gaussian.py`, `_update_init_stage_device`), its
depth patch corners with `jax.random.randint` (`log_tpu/render/loss.py`,
`depth_patch_loss`) and its synthetic bench scene with `uniform` and
`normal` (`log_tpu/utils/synth_tree.py`). The port draws the same numbers
here, so that one config and seed train the same model in both packages.

A key is two uint32 words, held on the host as a numpy (2,) uint32 array
(`prng_key(seed)`: [seed >> 32, seed & 0xFFFFFFFF]). The words of a draw of
`shape` are `b1 ^ b2`, where (b1, b2) is threefry2x32(key, (hi, lo)) of
each element's flat index i = (hi << 32) + lo. `uniform` keeps the top 23
bits as the mantissa of a float in [1, 2), subtracts 1 and scales;
`randint` draws two such word arrays from `split(key)` and reduces them by
the span (`jax/_src/random.py`, `_randint`); `normal` is
`sqrt(2) * erfinv(u)` on `uniform(nextafter(-1, 0), 1)`.

XLA on the CPU contracts `floats * (maxval - minval) + minval` and the
steps of its float32 `erf_inv` polynomial (Giles' approximation, the
coefficients below) into fused multiply-adds, each rounded once. torch and
numpy have no fused multiply-add, so `_fma32` forms the exact product in
float64 and rounds the sum to odd before rounding it to float32, which is
the once-rounded result. `np_exp` is XLA's float32 exp, fused the same
way, which the JAX package's LR schedule (`expon_lr`) evaluates: the
port's schedule takes it, so that the two packages' LRs are equal.

Each draw has two versions:
- the torch one (`split`, `uniform`, `randint`, `normal`) hashes on the
  device it is given, emulating uint32 in int64 with `& 0xFFFFFFFF`, so a
  draw of millions of words never crosses the host;
- the numpy one (`np_split`, `np_uniform`, `np_randint`, `np_normal`) in
  native uint32, the plain reference that the tests and `chip_smoke.py`
  hold the torch version against.

`uniform`, `randint` and `split` equal `jax.random` bit for bit. `normal`
differs from it only through the `log1p` inside the erfinv, which XLA
approximates in float32 and the port takes in float64: at most 3 ulps of
the result, at about 1% of the values (`tests/test_torch_jax_random.py`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

JAX_VERSION = "0.9.0"
PRNG_IMPL = "threefry2x32"
THREEFRY_PARTITIONABLE = True

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_ONE_F32_BITS = 0x3F800000  # 1.0f: the exponent bits of [1, 2)
# XLA's float32 erf_inv: Horner coefficients for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2_F32 = float(np.float32(math.sqrt(2)))
# XLA's float32 exp on the CPU: Cephes' range reduction and polynomial
_LOG2E = 1.44269504088896341
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2**64."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} outside [0, 2**64)")
    return np.array([seed >> 32, seed & MASK], np.uint32)


def _key_words(key) -> tuple[int, int]:
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"a key is a (2,) uint32 array, got {k.dtype} "
                         f"{k.shape}")
    return int(k[0]), int(k[1])


# ------------------------------------------------------------------ numpy
def _np_threefry(key, x0: np.ndarray, x1: np.ndarray):
    """threefry2x32 of the count pairs (x0, x1) (uint32 arrays)."""
    k0, k1 = _key_words(key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + np.uint32(ks[0])
    x1 = x1 + np.uint32(ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + np.uint32(ks[(i + 1) % 3])
        x1 = x1 + np.uint32((ks[(i + 2) % 3] + i + 1) & MASK)
    return x0, x1


def _np_counts(n: int):
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(MASK)).astype(np.uint32))


def np_random_bits(key, shape) -> np.ndarray:
    """jax.random.bits(key, shape) (uint32)."""
    b0, b1 = _np_threefry(key, *_np_counts(math.prod(shape)))
    return (b0 ^ b1).reshape(shape)


def np_split(key, n: int = 2) -> np.ndarray:
    """jax.random.split(key, n): (n, 2) uint32 keys."""
    b0, b1 = _np_threefry(key, *_np_counts(n))
    return np.stack([b0, b1], axis=1)


def _np_fma32(a, b, c) -> np.ndarray:
    """a * b + c of float32 values, rounded once to float32."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)  # exact
    c = np.asarray(c, np.float64)
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)  # s + err == p + c exactly
    even = (s.view(np.int64) & 1) == 0
    s = np.where((err != 0) & even,
                 np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def np_uniform(key, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    bits = np_random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(_ONE_F32_BITS)).view(
        np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, _np_fma32(floats, hi - lo, lo))


def _span(minval: int, maxval: int) -> tuple[int, int]:
    """(span, 2**32 mod span): the reduction's modulus and multiplier,
    each product wrapped to 32 bits as JAX's uint32 arithmetic wraps."""
    if not (-(1 << 31) <= minval < 1 << 31 and -(1 << 31) <= maxval < 1 << 31):
        raise ValueError("randint bounds outside int32")
    span = 1 if maxval <= minval else maxval - minval
    mult = (1 << 16) % span
    return span, ((mult * mult) & MASK) % span


def np_randint(key, shape, minval: int, maxval: int) -> np.ndarray:
    """jax.random.randint(key, shape, minval, maxval) (int32)."""
    minval, maxval = int(minval), int(maxval)
    span, mult = (np.uint32(v) for v in _span(minval, maxval))
    k_hi, k_lo = np_split(key)
    higher, lower = np_random_bits(k_hi, shape), np_random_bits(k_lo, shape)
    offset = ((higher % span) * mult + lower % span) % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)


def np_erfinv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 erf_inv."""
    x = np.asarray(x, np.float32)
    w = (-np.log1p((-x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    root = np.sqrt(w.astype(np.float64)).astype(np.float32)
    w = np.where(lt, w - np.float32(2.5), root - np.float32(3.0))
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _np_fma32(p, w, np.where(lt, np.float32(a), np.float32(b)))
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x)


def np_exp(x) -> np.ndarray:
    """XLA's float32 exp on the CPU, where the JAX package evaluates its
    LR schedule (`expon_lr`): Cephes' exp with every multiply-add fused,
    subnormal results flushed to zero."""
    f = np.float32
    x = np.clip(np.asarray(x, f), f(-104.0), f(88.72283935546875))
    n = np.clip(np.floor(_np_fma32(x, f(_LOG2E), f(0.5))), f(-127), f(127))
    r = _np_fma32(-f(_LN2_HI), n, x)
    r = _np_fma32(-f(_LN2_LO), n, r)
    z = _np_fma32(r, f(_EXP_POLY[0]), f(_EXP_POLY[1]))
    for c in _EXP_POLY[2:]:
        z = _np_fma32(z, r, f(c))
    z = f(1.0) + _np_fma32(z, r * r, r)
    # XLA's CPU code flushes subnormals to zero: 2**-127, and the results
    tiny = np.finfo(f).tiny
    scale = np.ldexp(f(1.0), n.astype(np.int32))
    y = z * np.where(scale < tiny, f(0.0), scale)
    y = np.where(np.abs(y) < tiny, f(0.0), y)
    return np.maximum(y, x)


def np_normal(key, shape) -> np.ndarray:
    """jax.random.normal(key, shape) (float32)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np_uniform(key, shape, lo, 1.0)
    return np.float32(_SQRT2_F32) * np_erfinv(u)


# ------------------------------------------------------------------ torch
def _threefry(key, x0: torch.Tensor, x1: torch.Tensor):
    """threefry2x32 of the count pairs (x0, x1): int64 tensors holding
    uint32 values; every sum and rotation is masked back to 32 bits."""
    k0, k1 = _key_words(key)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & MASK
    return x0, x1


def _counts(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & MASK


def random_bits(key, shape, device) -> torch.Tensor:
    """jax.random.bits(key, shape) on `device`: uint32 values in int64."""
    b0, b1 = _threefry(key, *_counts(math.prod(shape), device))
    return (b0 ^ b1).reshape(shape)


def split(key, n: int = 2) -> np.ndarray:
    """jax.random.split(key, n): (n, 2) uint32 keys. Keys are host words,
    so the hash runs on the host's torch."""
    b0, b1 = _threefry(key, *_counts(n, "cpu"))
    return torch.stack([b0, b1], dim=1).numpy().astype(np.uint32)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
           ) -> torch.Tensor:
    """a * b + c of float32 tensors, rounded once to float32."""
    p = a.double() * b.double()  # exact
    c = c.double()
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)  # s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, math.inf, -math.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


def uniform(key, shape, minval=0.0, maxval=1.0, device="cuda"
            ) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval) on
    `device`."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(
        torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    if lo == 0 and hi == 1:  # the scale is exact
        return floats
    lo_t = torch.tensor(lo, device=device)
    span = torch.tensor(hi - lo, device=device)
    return torch.maximum(lo_t, _fma32(floats, span, lo_t))


def randint(key, shape, minval: int, maxval: int, device="cuda"
            ) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval) on `device` (int32
    values in int64: the rows and columns index tensors)."""
    minval, maxval = int(minval), int(maxval)
    span, mult = _span(minval, maxval)
    k_hi, k_lo = split(key)
    higher = random_bits(k_hi, shape, device)
    lower = random_bits(k_lo, shape, device)
    offset = (((higher % span) * mult) & MASK) + lower % span
    return minval + (offset & MASK) % span


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv on x's device."""
    w = (-torch.log1p((-x * x).double())).float()
    lt = w < 5.0
    # the float32 sqrt of torch's CPU kernels is not correctly rounded;
    # the float64 one rounded to float32 is
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)

    def coef(i):
        return torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i]).float()

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma32(p, w, coef(i))
    return torch.where(x.abs() == 1, x * math.inf, p * x)


def normal(key, shape, device="cuda") -> torch.Tensor:
    """jax.random.normal(key, shape) (float32) on `device`."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return _SQRT2_F32 * erfinv(u)
