"""Shared pseudo-random codebooks for relative entropy coding, without JAX.

Counterpart of ``recombiner_tpu/coding/codebook.py``. The codebook is part of
the bitstream format: 2^bits standard-normal vectors per level, of width
max_group_size, expanded from the artifact's seed on both sides.

- "threefry" reproduces ``jax.random.normal(fold_in(key(seed), tag),
  (n, width), float32)`` in numpy, as JAX computes it with
  ``jax_threefry_partitionable=True``:
  threefry2x32 over a 64-bit iota split into (hi, lo) words, the two output
  words XORed into 32 random bits, those bits mapped onto the mantissa of a
  float in [1, 2), shifted onto [nextafter(-1, 0), 1), and sqrt(2) *
  erf_inv(u) with XLA's f32 Giles polynomial. The random bits are exact. The
  erf_inv step is an f32 emulation of XLA's polynomial: XLA's own log1p and
  its fused multiply-adds differ from numpy's in the last bits, so about 1%
  of entries differ by up to 3 ulp (pinned in tests/test_torch_codebook.py).
- "sobol": scrambled Sobol + Phi^{-1} from scipy, clamped to +-100, the same
  host code as the JAX package, so equal bit for bit.
"""

from __future__ import annotations

import numpy as np

LEVEL_TAGS = {"w": 0, "h": 1, "hh": 2}

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (the hash of ``jax._src.prng``) on
    uint32 arrays; returns the two output words (new arrays)."""
    k0, k1 = np.uint32(k0), np.uint32(k1)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0.astype(np.uint32) + ks[0]
    x1 = x1.astype(np.uint32) + ks[1]
    t = np.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, np.uint32(r), out=t)  # x1 = rotl(x1, r) ^ x0, in place
            np.right_shift(x1, np.uint32(32 - r), out=x1)
            x1 |= t
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3]
        x1 += np.uint32(i + 1)
    return x0, x1


def _key(seed: int):
    """``jax.random.key(seed)`` for threefry: the words (0, seed). Seeds are
    held to [0, 2^31): JAX without 64-bit mode takes the seed as an int32."""
    seed = int(seed)
    if not 0 <= seed < 2**31:
        raise ValueError(f"codebook seed {seed} outside [0, 2^31)")
    return np.uint32(0), np.uint32(seed)


def _fold_in(key, data: int):
    """``jax.random.fold_in``: hash the key over the counts (0, data)."""
    a, b = threefry2x32(key[0], key[1], np.array([0], np.uint32),
                        np.array([data], np.uint32))
    return a[0], b[0]


def threefry_bits(key, n: int, start: int = 0) -> np.ndarray:
    """32 random bits per element of elements ``start`` to ``start + n`` of
    a flat array, partitionable layout: counts are the 64-bit iota as (hi,
    lo) words."""
    lo = np.arange(start, start + n, dtype=np.uint64)
    hi = (lo >> np.uint64(32)).astype(np.uint32)
    b0, b1 = threefry2x32(key[0], key[1], hi, lo.astype(np.uint32))
    return b0 ^ b1


def _fma32(a, b, c) -> np.ndarray:
    """f32 fused multiply-add: the f64 product of two f32 values is exact."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
               1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
               2.83297682)


def erf_inv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erf_inv (M. Giles, "Approximating the erfinv function"),
    evaluated in f32 with fused multiply-adds in the Horner steps."""
    x = np.asarray(x, np.float32)
    # log1p of the f32 square, taken in f64 and rounded once: closest to
    # XLA's own log1p of the variants tried (98.97% of entries equal)
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0)).astype(np.float32)
    c = lambda i: np.where(lt, np.float32(_ERFINV_LT5[i]), np.float32(_ERFINV_GE5[i]))
    p = c(0).astype(np.float32)
    for i in range(1, len(_ERFINV_LT5)):
        p = _fma32(p, w, c(i))
    out = p * x
    return np.where(np.abs(x) == 1, x * np.finfo(np.float32).max, out).astype(np.float32)


# elements per chunk of threefry_normal: its temporaries stay in the cache
_CHUNK = 1 << 16


def threefry_normal(seed: int, tag: int, shape) -> np.ndarray:
    """``jax.random.normal(fold_in(key(seed), tag), shape, float32)``,
    computed a chunk of elements at a time (the same numbers as a whole)."""
    n = int(np.prod(shape))
    key = _fold_in(_key(seed), tag)
    one = np.float32(1.0)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    out = np.empty(n, np.float32)
    for start in range(0, n, _CHUNK):
        bits = threefry_bits(key, min(_CHUNK, n - start), start)
        floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - one
        u = np.maximum(lo, floats * (one - lo) + lo)
        out[start:start + bits.shape[0]] = np.float32(np.sqrt(2)) * erf_inv_f32(u)
    return out.reshape(shape)


def make_codebook(seed: int, level: str, n_samples: int, width: int,
                  kind: str = "threefry") -> np.ndarray:
    """(n_samples, width) float32 standard-normal codebook for one level."""
    if kind == "threefry":
        return threefry_normal(seed, LEVEL_TAGS[level], (n_samples, width))
    if kind == "sobol":
        from scipy.stats import norm, qmc

        sob = qmc.Sobol(d=width, scramble=True, seed=seed + 1000 * LEVEL_TAGS[level])
        eps = np.clip(norm.ppf(sob.random(n_samples)), -100.0, 100.0)
        return eps.astype(np.float32)
    raise ValueError(f"unknown codebook kind {kind!r}")
