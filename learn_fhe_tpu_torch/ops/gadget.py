"""Signed base-2^B gadget decomposition and power-up, on the torus and mod q.

Counterpart of the T64 and Zq functions of `learn_fhe_tpu/ops/gadget.py`, which
reproduce the reference bit for bit (`util/src/misc/decompose.rs:115-135`):
digits live in (-B/2, B/2], produced by the branch-free carry
((limb-1 | v) & limb) >> (log_b-1). Torus values are int64 bit patterns, so
every logical right shift is masked (`shr_u64`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .modular import as_i64, generic_mul_mod, shr_u64  # noqa: F401  (as_i64, shr_u64: re-exported)


@dataclass(frozen=True)
class Gadget:
    """Base-2^B gadget for modulus q (q=0 means the 2^64 torus).

    rounding_bits = log_q - log_b*d, with log_q = ceil(log2(q)) for Zq and 64
    for the torus (`decompose.rs:50-81`).
    """

    q: int  # 0 => T64 torus (mod 2^64)
    log_b: int
    d: int
    log_q: int = field(init=False)
    rounding_bits: int = field(init=False)

    def __post_init__(self):
        log_q = 64 if self.q == 0 else (self.q - 1).bit_length()
        if self.q and (1 << log_q) < self.q:
            log_q += 1
        object.__setattr__(self, "log_q", log_q)
        object.__setattr__(self, "rounding_bits", max(log_q - self.log_b * self.d, 0))

    @property
    def log_bases(self) -> list[int]:
        return [self.rounding_bits + i * self.log_b for i in range(self.d)]

    @property
    def bases(self) -> np.ndarray:
        """Gadget powers B^i * 2^rounding_bits (reduced mod q if q > 0)."""
        if self.q:
            return np.array([pow(2, bits, self.q) for bits in self.log_bases], dtype=np.uint64)
        return np.array([(1 << bits) % (1 << 64) for bits in self.log_bases], dtype=np.uint64)


def decompose_t64(x: torch.Tensor, gadget: Gadget) -> torch.Tensor:
    """Signed digits of torus values (`decompose.rs:124-135`): (d, *x.shape)
    int64, each in (-B/2, B/2]."""
    log_b = gadget.log_b
    mask = (1 << log_b) - 1
    bits = gadget.rounding_bits
    v = x
    if bits:
        v = shr_u64(v + ((1 << bits) >> 1), bits)
    digits = []
    for _ in range(gadget.d):
        limb = v & mask
        v = shr_u64(v, log_b)
        carry = (((limb - 1) | v) & limb) >> (log_b - 1)
        v = v + carry
        digits.append(limb - (carry << log_b))
    return torch.stack(digits, dim=0)


def decompose_t64_supports_u32(gadget: Gadget) -> bool:
    """True when the torus decomposition never touches the low u64 word:
    rounding adds 2^(rb-1) with rb-1 >= 32 and all digits fit 31 bits."""
    return gadget.q == 0 and gadget.rounding_bits >= 33 and gadget.log_b * gadget.d <= 31


def decompose_t64_u32(x_hi: torch.Tensor, gadget: Gadget) -> torch.Tensor:
    """u32 form of `decompose_t64` for rounding_bits >= 33, which reads only
    the high word of each torus value.

    x_hi: the high 32 bits as int64 in [0, 2^32). Returns (d, *shape) int32
    digits, the two's-complement u32 digits of the JAX package.
    """
    assert decompose_t64_supports_u32(gadget)
    log_b = gadget.log_b
    mask = (1 << log_b) - 1
    rb = gadget.rounding_bits
    v = ((x_hi + (1 << (rb - 33))) & 0xFFFFFFFF) >> (rb - 32)  # u32 add wraps
    digits = []
    for _ in range(gadget.d):
        limb = v & mask
        v = v >> log_b
        carry = (((limb - 1) | v) & limb) >> (log_b - 1)
        v = v + carry
        digits.append(limb - (carry << log_b))
    return torch.stack(digits, dim=0).to(torch.int32)


def power_up_t64(x: torch.Tensor, gadget: Gadget) -> torch.Tensor:
    """x * 2^(rounding_bits + i*log_b) wrapping mod 2^64; shape (d, *x.shape)."""
    return torch.stack([x * as_i64(int(b)) for b in gadget.bases], dim=0)


# ---------------------------------------------------------------------------
# Zq gadget (`learn_fhe_tpu/ops/gadget.py:65-137, 200`): digits as residues
# in [0, q), limb + carry * (q - B), from the centered lift of the rounded
# shift (`decompose.rs:91-112`). Values are int64 holding u64 values.
# ---------------------------------------------------------------------------


def rounding_shr_zq(x: torch.Tensor, gadget: Gadget) -> torch.Tensor:
    """(x + 2^bits/2 mod q) >> bits on reduced values (`decompose.rs:92-95`)."""
    bits = gadget.rounding_bits
    if bits == 0:
        return x
    half = ((1 << bits) >> 1) % gadget.q
    s = x + half
    return torch.where(s >= gadget.q, s - gadget.q, s) >> bits


def decompose_zq(x: torch.Tensor, gadget: Gadget) -> torch.Tensor:
    """Signed digits of reduced x mod q as residues: (d, *x.shape) int64."""
    q, log_b = gadget.q, gadget.log_b
    mask, b_by_2, neg_b = (1 << log_b) - 1, 1 << (log_b - 1), q - (1 << log_b)
    v = rounding_shr_zq(x, gadget)
    v = torch.where(v < (q >> 1), v, v - q)  # two's-complement u64 lift
    digits = []
    for _ in range(gadget.d):
        limb = v & mask
        carry = ((limb + (v & 1)) > b_by_2).long()
        v = shr_u64(v, log_b) + carry
        digits.append(limb + carry * neg_b)
    return torch.stack(digits, dim=0)


def decompose_zq_supports_u32(gadget: Gadget) -> bool:
    """The u32 walk gives the u64 walk's digits when q < 2^31 and the digit
    span fits 31 bits."""
    return 0 < gadget.q < (1 << 31) and gadget.log_b * gadget.d <= 31


def decompose_zq32(x: torch.Tensor, gadget: Gadget) -> torch.Tensor:
    """u32 form of `decompose_zq` for q < 2^31, log_b * d <= 31: the same
    steps on values wrapped to 32 bits (int64 in [0, 2^32), so >> is the
    logical shift). Returns (d, *x.shape) int32 residues."""
    q, log_b = gadget.q, gadget.log_b
    mask, b_by_2, neg_b = (1 << log_b) - 1, 1 << (log_b - 1), q - (1 << log_b)
    x = rounding_shr_zq(x.long(), gadget)
    v = torch.where(x < (q >> 1), x, x - q) & 0xFFFFFFFF
    digits = []
    for _ in range(gadget.d):
        limb = v & mask
        carry = ((limb + (v & 1)) > b_by_2).long()
        v = (v >> log_b) + carry
        digits.append(limb + carry * neg_b)
    return torch.stack(digits, dim=0).to(torch.int32)


def power_up_zq(x: torch.Tensor, gadget: Gadget) -> torch.Tensor:
    """x * B^i * 2^rounding_bits mod q for i < d, x reduced: (d, *x.shape)
    int64."""
    return torch.stack([generic_mul_mod(x, int(b), gadget.q) for b in gadget.bases], dim=0)
