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

All arithmetic is uint32 with wrap-around, as XLA's. Only float32 and
int32 results are ported (what the pipeline draws; JAX's 64-bit mode
is off in the reference).
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
