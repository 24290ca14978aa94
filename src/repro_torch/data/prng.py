"""The reference's random draws in numpy, bit for bit.

The JAX package draws its synthetic batches with ``jax.random`` under
the default ``threefry2x32`` implementation with
``jax_threefry_partitionable=True`` (the default since JAX 0.5). The
card's machine has no JAX, so the port keeps its own copy of the draws
the data pipeline makes: a key is two uint32 words, and

  ``key(seed)``            ``jax.random.PRNGKey(seed)``: [0, seed]
  ``fold_in(k, d)``        the hash of the counter pair (0, d) under k
  ``split(k, n)``          the hashes of counters (0, i), i < n
  ``random_bits(k, shape)`` the hashes of the row-major flat index i,
                           as 64 bits (hi, lo), XORed word with word
  ``randint``              two such draws folded into [lo, hi) with
                           jax's double-width modulus (uint32 wrap)
  ``uniform``              23 random mantissa bits ORed into 1.0, minus 1
  ``bernoulli``            ``uniform < p``
  ``normal``               ``sqrt(2) erf_inv(u)``, u uniform in
                           [nextafter(-1, 0), 1)

All arithmetic is uint32 with wrap-around, as XLA's. Only float32 and
int32 results are ported (what the pipeline draws; JAX's 64-bit mode
is off in the reference).

``normal`` follows XLA's CPU program for ``jax.random.normal`` op for
op: ``erf_inv`` is XLA's single-precision polynomial (Giles), its
``log1p`` the Cephes rational function below sqrt(2) - 1 and
``log(1 + x)`` above, that ``log`` Cephes's range reduction and
polynomial as XLA's CPU backend emits it, and the multiply-adds XLA
fuses are fused here too (``_fma``: the product is exact in float64,
the sum rounded once there and once to float32). Numpy's own ``log1p``
is up to 2 ulp from XLA's.
"""
from __future__ import annotations

import math

import numpy as np

U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << U32(d)) | (x >> U32(32 - d))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2), as ``jax._src.prng._threefry2x32_lowering``."""
    k1, k2 = U32(k1), U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ U32(0x1BD11BDA))
    x = [np.asarray(x1, U32) + ks[0], np.asarray(x2, U32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3]
        x[1] = x[1] + U32(i + 1)
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s key data for 0 <= seed < 2**31."""
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside [0, 2**31)")
    return np.array([0, seed], U32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    y1, y2 = threefry2x32(k[0], k[1], np.zeros(1, U32),
                          np.array([data & 0xFFFFFFFF], U32))
    return np.array([y1[0], y2[0]], U32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """(num, 2) keys."""
    y1, y2 = threefry2x32(k[0], k[1], np.zeros(num, U32),
                          np.arange(num, dtype=U32))
    return np.stack([y1, y2], axis=1)


def random_bits(k: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element: the partitionable layout, each
    element's counter its row-major flat index as (hi, lo) words."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64)
    y1, y2 = threefry2x32(k[0], k[1], (idx >> np.uint64(32)).astype(U32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(U32))
    return (y1 ^ y2).reshape(shape)


def randint(k: np.ndarray, shape: tuple[int, ...], minval: int,
            maxval: int) -> np.ndarray:
    """int32 in [minval, maxval) as ``jax.random.randint``: two draws,
    higher and lower, reduced by ``span`` with the multiplier
    2**32 % span computed as (2**16 % span)**2 % span in uint32 (it
    wraps to 0 for spans above 2**16, as XLA's does)."""
    info = np.iinfo(np.int32)
    if not info.min <= minval <= maxval <= info.max:
        raise ValueError(f"randint: [{minval}, {maxval}) is not an int32 "
                         "range")
    k1, k2 = split(k)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.array([max(maxval - minval, 1)], U32)
    mult = np.array([2 ** 16], U32) % span
    mult = (mult * mult) % span
    offset = ((higher % span) * mult + lower % span) % span
    return (np.int32(minval) + offset.astype(np.int32)).astype(np.int32)


def uniform(k: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """float32 in [0, 1)."""
    bits = (random_bits(k, shape) >> U32(9)) | \
        np.array(1.0, np.float32).view(U32)
    return np.maximum(np.float32(0.0), bits.view(np.float32) -
                      np.float32(1.0))


def bernoulli(k: np.ndarray, p: float, shape: tuple[int, ...]
              ) -> np.ndarray:
    return uniform(k, shape) < np.float32(p)


F32 = np.float32
# XLA's ErfInv32 (Giles, "Approximating the erfinv function"): the
# coefficients for w < 5 and for w >= 5, highest degree first.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# XLA's Log1p below sqrt(2) - 1 (Cephes): x - x^2/2 + x^3 P(x)/Q(x).
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
# Cephes's logf polynomial on [sqrt(1/2) - 1, sqrt(2) - 1], and ln 2
# split in two.
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LN2_LO, _LN2_HI = F32(-2.12194440e-4), F32(0.693359375)


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded as one fused multiply-add (a float32
    product is exact in float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def _log(v: np.ndarray) -> np.ndarray:
    """Natural log of positive float32 ``v`` as XLA's CPU backend
    computes it: v = m 2^e with m in [sqrt(1/2), sqrt(2)), a degree-8
    polynomial in m - 1 evaluated in three parts, e ln 2 added in two."""
    v = np.maximum(v, F32(np.finfo(F32).tiny))
    bits = v.view(np.int32)
    e = ((bits >> 23) - 0x7F).astype(F32) + F32(1)
    m = ((bits & ~0x7F800000) | F32(0.5).view(np.int32)).view(F32)
    low = m < F32(0.707106781186547524)
    e = e - np.where(low, F32(1), F32(0))
    m = (m - F32(1)) + np.where(low, m, F32(0))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma(_fma(F32(p[0]), m, F32(p[1])), m, F32(p[2]))
    y1 = _fma(_fma(F32(p[3]), m, F32(p[4])), m, F32(p[5]))
    y2 = _fma(_fma(F32(p[6]), m, F32(p[7])), m, F32(p[8]))
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * _LN2_LO)
    m = (m - x2 * F32(0.5)) + y
    return m + e * _LN2_HI


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, F32(c))
    return p


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's Log1p in float32: Cephes's rational function where |x| <
    sqrt(2) - 1, log(1 + x) elsewhere."""
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + _fma(F32(-0.5), x2, small)
    with np.errstate(divide="ignore", invalid="ignore"):
        large = _log(x + F32(1))
    return np.where(np.abs(x) < F32(0.41421356237309504880), small, large)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's ErfInv32 of float32 ``x`` in (-1, 1); +-1 give +-inf."""
    w = -_log1p(-x * x)
    lt = w < F32(5)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, w - F32(2.5), np.sqrt(w) - F32(3))
    p = np.where(lt, F32(_ERFINV_LT5[0]), F32(_ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, F32(a), F32(b)))
    return np.where(np.abs(x) == F32(1), x * F32(np.inf), p * x)


def normal(k: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """float32 standard normal draws, ``jax.random.normal(k, shape)``:
    uniform bits scaled onto [nextafter(-1, 0), 1) (the scale, 1 minus
    that bound, rounds to 2 in float32), clamped at the bound, then
    sqrt(2) erf_inv."""
    bits = (random_bits(k, shape) >> U32(9)) | \
        np.array(1.0, F32).view(U32)
    lo = np.nextafter(F32(-1), F32(0))
    u = np.maximum(lo, (bits.view(F32) - F32(1)) * F32(2) + lo)
    return F32(np.sqrt(2)) * erf_inv(u)
