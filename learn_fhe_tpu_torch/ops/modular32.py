"""Arithmetic mod primes q < 2^31: host Shoup constants and plain torch ops.

Counterpart of `learn_fhe_tpu/ops/modular32.py`. There every u32 op returns a
fully reduced residue, so the plain versions here compute the same values
directly in int64 (`(a * b) % q` is exact: both operands are < 2^31). The
CUDA kernels do the u32 Shoup arithmetic itself (`csrc/modular32.cuh`).

Carriers: residues and Shoup duals are stored as int32 holding the u32 bit
pattern (residues are < 2^31, so their int32 value is exact); the functions
below take and return int64 values in [0, q).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .modular import neg_mod as neg_mod32  # noqa: F401  (the same on int32 residues)


@dataclass(frozen=True)
class Zq32Params:
    """Precomputed reduction constants for one odd modulus q < 2^31."""

    q: int
    neg_q_inv: int = field(init=False)  # -q^-1 mod 2^32 (REDC)
    r1: int = field(init=False)  # 2^32 mod q
    r2: int = field(init=False)  # 2^64 mod q (enter/leave Montgomery)
    barrett_m: int = field(init=False)  # floor(2^32 / q)

    def __post_init__(self):
        assert self.q % 2 == 1 and 1 < self.q < (1 << 31)
        object.__setattr__(self, "neg_q_inv", (-pow(self.q, -1, 1 << 32)) % (1 << 32))
        object.__setattr__(self, "r1", (1 << 32) % self.q)
        object.__setattr__(self, "r2", (1 << 64) % self.q)
        object.__setattr__(self, "barrett_m", (1 << 32) // self.q)


def shoup32(w: int | np.ndarray, q: int) -> np.ndarray:
    """w' = floor(w * 2^32 / q) as u32 (host precompute for constants w < q)."""
    if q < (1 << 31):
        w_arr = np.asarray(w, dtype=np.uint64)
        return ((w_arr << np.uint64(32)) // np.uint64(q)).astype(np.uint32)
    w_arr = np.asarray(w, dtype=np.uint64).astype(object)
    return np.asarray((w_arr << 32) // q).astype(np.uint32)


def u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor holding the u32 bit pattern."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def shoup32_dual(w: torch.Tensor, q) -> torch.Tensor:
    """Shoup duals floor(w * 2^32 / q) of reduced residues, on w's device
    (counterpart of `shoup32_device`); int32 bit patterns. q is an int or a
    tensor broadcasting against w (one prime per slice)."""
    return u32_bits((w.long() << 32) // q)


def add_mod32(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    return (a + b) % q


def sub_mod32(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    return (a - b) % q


def mul_mod32(a: torch.Tensor, b, q: int) -> torch.Tensor:
    """a * b mod q: the value of both `mul_shoup32` (b a constant with its
    Shoup dual) and `mul_mod32` (Montgomery) in the JAX package."""
    return (a * b) % q


def mul_shoup32(a: torch.Tensor, w: torch.Tensor, w_shoup: torch.Tensor, q: int) -> torch.Tensor:
    """a * w mod q, w a constant with its Shoup dual; the dual only sets how
    the kernels compute it."""
    del w_shoup
    return (a.long() * w.long()) % q


def sum_mod32(x: torch.Tensor, q: int, axis: int = 0) -> torch.Tensor:
    """Sum of reduced values mod q along an axis."""
    return x.long().sum(axis) % q


def small_u32_to_mod32(x: torch.Tensor, q: int) -> torch.Tensor:
    """Residue of a small signed value (|x| < q; a gadget digit, or a
    binary key coefficient), i.e. the sign-fold x < 0 ? x + q : x."""
    x = x.long()
    return torch.where(x < 0, x + q, x)


def i64_to_mod32(x: torch.Tensor, q: int) -> torch.Tensor:
    """Residue mod q of a torus value read as signed two's complement (the
    centered lift); int64's floor modulo is exactly that."""
    return x % q
