"""Noise distributions, host-side (keygen/encrypt-time, off the device path).

A numpy copy of `learn_fhe_tpu/utils/distributions.py` (the samplers the
TFHE and FHEW slices use): every sampler takes the caller's `np.random.Generator` and
draws in the same order and with the same shapes, so keys and ciphertexts
made from one seed are bit-identical across the two packages.

- binary():   0/1 from a uniform f64 threshold at 0.5
- zo(rho):    -1/0/+1 with P(+-1) = rho/2 each
- dg(std, n): discrete Gaussian over [-floor(n*std), +floor(n*std)] from a
              CDF table built with the Abramowitz-Stegun 7.1.26 erf series
- tdg(std):   torus Gaussian: fractional part of a normal, scaled by 2^64
- uniform_t64, uniform_zq: uniform torus values, uniform residues
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


def binary(rng: np.random.Generator, size) -> np.ndarray:
    v = rng.random(size)
    return np.where(v <= 0.5, 0, 1).astype(np.int64)


def tdg(std_dev: float, rng: np.random.Generator, size) -> np.ndarray:
    """Torus Gaussian as u64 (`distribution.rs:49-54`)."""
    v = rng.normal(0.0, std_dev, size)
    frac = v - np.round(v)
    return np.round(frac * float(2**64)).astype(np.int64).astype(np.uint64)


def uniform_t64(rng: np.random.Generator, size) -> np.ndarray:
    return rng.integers(0, 1 << 64, size=size, dtype=np.uint64)


def zo(rho: float, rng: np.random.Generator, size) -> np.ndarray:
    """-1/0/+1 with P(+-1) = rho/2 each."""
    assert rho <= 1.0
    v = rng.random(size)
    out = np.zeros(np.shape(v), dtype=np.int64)
    out[v <= rho] = 1
    out[v <= rho / 2.0] = -1
    return out


def _erf_as(x: np.ndarray) -> np.ndarray:
    """Abramowitz-Stegun 7.1.26 erf approximation (`distribution.rs:24-40`)."""
    p = 0.3275911
    a1, a2, a3, a4, a5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429
    t = 1.0 / (1.0 + p * np.abs(x))
    pos = 1.0 - (((((a5 * t + a4) * t) + a3) * t + a2) * t + a1) * t * np.exp(-x * x)
    return np.where(x >= 0, pos, -pos)


@lru_cache(maxsize=None)
def _dg_table(std_dev: float, n: int) -> tuple[np.ndarray, int]:
    cdf = lambda x: (1.0 + _erf_as(np.asarray(x / (std_dev * np.sqrt(2.0))))) / 2.0  # noqa: E731
    max_v = int(np.floor(n * std_dev))
    xs = np.arange(-max_v, max_v + 1, dtype=np.float64)
    weights = cdf(xs + 0.5) - cdf(xs - 0.5)
    return weights / weights.sum(), max_v


def dg(std_dev: float, n: int, rng: np.random.Generator, size) -> np.ndarray:
    """Discrete Gaussian with support +-floor(n*std_dev)."""
    weights, max_v = _dg_table(std_dev, n)
    idx = rng.choice(len(weights), size=size, p=weights)
    return (idx - max_v).astype(np.int64)


def uniform_zq(q: int, rng: np.random.Generator, size) -> np.ndarray:
    return rng.integers(0, q, size=size, dtype=np.uint64)
