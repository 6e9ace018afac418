"""The part of JAX's PRNG that tpudet's trainer draws from, in numpy.

tpudet keys its device augmentation with
``jax.random.fold_in(jax.random.PRNGKey(seed ^ 0x5EED), step)``, splits that
key in six and draws ``jax.random.uniform`` values from the pieces
(``tpudet/models/base.py:171-182``, ``tpudet/data/device_augment.py:82-111``).
These functions give the same bits for the same seed and step: JAX's
partitionable threefry-2x32 (its default), with keys as ``uint32[2]`` arrays.

  * ``key(seed)``: ``[0, seed mod 2^32]`` (JAX without 64-bit types);
  * ``fold_in(key, data)``: threefry of the counter pair ``(0, data)``;
  * ``split(key, n)``: threefry of the counters ``(0, i)``, ``i < n``;
  * ``uniform(key, shape, minval, maxval)``: threefry of ``(0, i)`` over the
    flat index ``i`` of ``shape``, 32 bits ``out0 ^ out1``, the top 23 as the
    mantissa of a float32 in ``[1, 2)``, minus 1, then
    ``u * (maxval - minval) + minval`` rounded once (XLA fuses it into a
    fused multiply-add) and clamped at ``minval``.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds of the key ``k`` (``uint32[2]``) over the
    counter words ``x0``, ``x1`` (``uint32`` arrays of one shape)."""
    k0, k1 = np.uint32(k[0]), np.uint32(k[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = (x[1] + ks[(i + 2) % 3]) + np.uint32(i + 1)  # array sums wrap silently
    return x[0], x[1]


def key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed that fits in 32 bits."""
    return np.asarray([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``."""
    out0, out1 = threefry2x32(k, np.zeros(1, np.uint32),
                              np.asarray([int(data) & 0xFFFFFFFF], np.uint32))
    return np.asarray([out0[0], out1[0]], np.uint32)


def split(k: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.split(k, n)``: ``uint32[n, 2]``."""
    out0, out1 = threefry2x32(k, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return np.stack([out0, out1], -1)


def bits(k: np.ndarray, shape) -> np.ndarray:
    """32 random bits for each entry of ``shape`` (``uint32``)."""
    n = int(np.prod(shape, dtype=np.int64))
    out0, out1 = threefry2x32(k, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return (out0 ^ out1).reshape(shape)


def uniform(k: np.ndarray, shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, minval=minval, maxval=maxval)`` in
    float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    mant = (bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    u = mant.view(np.float32) - np.float32(1.0)
    # the product of two float32 is exact in float64: one rounding, as the FMA
    scaled = (u.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)
