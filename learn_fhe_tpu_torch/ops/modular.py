"""Arithmetic mod q on u64 values carried as int64 (the subset of
`learn_fhe_tpu/ops/modular.py` that the FHEW slice uses).

Every modulus here is below 2^31 (the FHEW ciphertext prime, the LWE key
switch's 2^16, Z_2N), so reduced values and the product of two of them fit
int64 and the plain torch ops compute the JAX package's values exactly. The
modulus switches reproduce the reference's f64 rounding (`zq.rs:128-140`):
one multiply, then one divide, as separate IEEE operations.
"""

from __future__ import annotations

import torch


def add_mod(a: torch.Tensor, b, q: int) -> torch.Tensor:
    """(a + b) mod q, inputs reduced."""
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub_mod(a: torch.Tensor, b, q: int) -> torch.Tensor:
    """(a - b) mod q, inputs reduced."""
    d = a - b
    return torch.where(d < 0, d + q, d)


def neg_mod(a: torch.Tensor, q: int) -> torch.Tensor:
    """(-a) mod q, input reduced; 0 stays 0."""
    return torch.where(a == 0, a, q - a)


def from_i64(v: torch.Tensor, q: int) -> torch.Tensor:
    """Signed values into [0, q) (torch's % takes the divisor's sign)."""
    return v % q


def to_center_i64(a: torch.Tensor, q: int) -> torch.Tensor:
    """Centered lift: a if a < q/2 else a - q (`zq.rs:71-77`)."""
    return torch.where(a < (q >> 1), a, a - q)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Rust f64::round(): half away from zero (torch.round is half-even)."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


def _scaled(a: torch.Tensor, q: int, q_prime: int) -> torch.Tensor:
    return (a.double() * float(q_prime)) / float(q)


def mod_switch(a: torch.Tensor, q: int, q_prime: int) -> torch.Tensor:
    """round(a * q'/q) mod q', f64 rounding half away from zero."""
    return _round_half_away(_scaled(a, q, q_prime)).long() % q_prime


def mod_switch_odd(a: torch.Tensor, q: int, q_prime: int) -> torch.Tensor:
    """Round down then force odd, except round to nearest when the floor is
    0 (`zq.rs:132-140`)."""
    scaled = _scaled(a, q, q_prime)
    fl = torch.floor(scaled)
    out = torch.where(fl == 0.0, _round_half_away(scaled).long(), fl.long() | 1)
    return out % q_prime


def modular_dot(x: torch.Tensor, mat: torch.Tensor, q: int) -> torch.Tensor:
    """sum_k x[..., k] * mat[k] mod q, mat (K,) or (K, M), reduced inputs.
    Each product is reduced before the sum, which needs q < 2^31."""
    assert q < 1 << 31
    if mat.dim() == 1:
        return ((x * mat) % q).sum(-1) % q
    return ((x[..., :, None] * mat) % q).sum(-2) % q
