"""The reference's default parameter initialisation, reproduced in numpy.

The JAX reference initialises a module it has no checkpoint for with
``module.init(jax.random.PRNGKey(seed), ...)``: flax folds the parameter's
path into the key, and ``lecun_normal`` draws a truncated normal from the
Threefry-2x32 counter generator.  This module computes the same numbers
without JAX, so a tracker that runs without trained re-ID weights assigns
the ids the reference assigns:

* keys: ``PRNGKey(seed)`` is ``[seed >> 32, seed & 0xffffffff]``;
  ``fold_in(key, d)`` hashes the counter pair ``(0, d)``;
* flax's static fold-in: SHA-1 of the scope path and the rng counter (no
  separators, flax's default), its first 4 bytes big-endian;
* random bits (``jax_threefry_partitionable``, on by default): Threefry-2x32
  of the 64-bit iota over the flattened shape, the two output words XORed;
* ``uniform``: 23 random mantissa bits over [1, 2), minus 1, scaled to
  [minval, maxval);
* ``truncated_normal``: ``sqrt(2) * erfinv(u)`` for u uniform in
  ``[erf(lower / sqrt 2), erf(upper / sqrt 2))``, clamped inside the bounds;
  ``erfinv`` is Giles' single-precision polynomial, the one XLA uses;
* products followed by a sum round once, as XLA's CPU code fuses them;
* ``lecun_normal``: that normal at (-2, 2), times
  ``sqrt(1 / fan_in) / 0.87962566103423978``.

Every step runs in float32 as the reference does; the one difference is in
``erfinv``'s and ``log1p``'s last bits (``tests/test_torch_checkpoint.py``
states the largest).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, as XLA's CPU code contracts it (the
    float64 product of two float32 values is exact)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)).astype(np.float32)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block function (20 rounds) of ``key`` (2,) uint32 on
    the counter words x0, x1 (uint32 arrays of one shape)."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [x0.astype(np.uint32) + ks[0], x1.astype(np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (threefry) as (2,) uint32."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``."""
    o0, o1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([data & 0xFFFFFFFF], np.uint32))
    return np.array([o0[0], o1[0]], np.uint32)


def fold_in_path(key: np.ndarray, path: tuple) -> np.ndarray:
    """flax's ``LazyRng`` fold-in of static data (scope names and rng counters)."""
    if not path:
        return key
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, byteorder="big"))
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def random_bits32(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element (the partitionable Threefry layout)."""
    n = math.prod(shape)
    lo = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (lo >> np.uint64(32)).astype(np.uint32), lo.astype(np.uint32))
    return (b0 ^ b1).reshape(shape)


def uniform(key: np.ndarray, shape: tuple[int, ...], minval, maxval) -> np.ndarray:
    """``jax.random.uniform`` in float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits32(key, shape) >> np.uint32(9)) | np.float32(1.0).view(np.uint32)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: np.ndarray) -> np.ndarray:
    """Giles' single-precision inverse error function, in float32."""
    x = np.asarray(x, np.float32)
    w = -np.log1p((-x * x).astype(np.float64)).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0])).astype(np.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, np.float32(a), np.float32(b)))
    out = p * x
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, out).astype(np.float32)


def truncated_normal(key: np.ndarray, lower: float, upper: float, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.truncated_normal`` in float32."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    a = np.float32(math.erf(float(lo / sqrt2)))
    b = np.float32(math.erf(float(hi / sqrt2)))
    out = sqrt2 * erfinv32(uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)), np.nextafter(hi, np.float32(-np.inf)))


def lecun_normal(key: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """flax's default Dense kernel init for a (fan_in, fan_out) kernel."""
    variance = np.float32(1.0 / shape[0])
    stddev = np.sqrt(variance) / np.float32(0.87962566103423978)
    return (truncated_normal(key, -2.0, 2.0, shape) * stddev).astype(np.float32)


def dense_init(seed: int, path: tuple[str, ...], in_dim: int, out_dim: int) -> tuple[np.ndarray, np.ndarray]:
    """(kernel (in_dim, out_dim), bias (out_dim,)) of a flax ``nn.Dense`` at the
    scope ``path`` of a module initialised with ``PRNGKey(seed)``: the kernel
    takes the scope's first ``params`` draw, the bias is zero."""
    key = fold_in_path(prng_key(seed), (*path, 1))
    return lecun_normal(key, (in_dim, out_dim)), np.zeros(out_dim, np.float32)
