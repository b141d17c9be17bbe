"""Noise distributions, host-side (keygen/encrypt-time, off the device path).

A numpy copy of `learn_fhe_tpu/utils/distributions.py` (the samplers the
TFHE slice uses): every sampler takes the caller's `np.random.Generator` and
draws in the same order and with the same shapes, so keys and ciphertexts
made from one seed are bit-identical across the two packages.

- binary():   0/1 from a uniform f64 threshold at 0.5
- tdg(std):   torus Gaussian: fractional part of a normal, scaled by 2^64
- uniform_t64: uniform torus values
"""

from __future__ import annotations

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
