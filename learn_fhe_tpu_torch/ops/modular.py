"""Arithmetic mod q on u64 values carried as int64
(`learn_fhe_tpu/ops/modular.py`).

Reduced values are below q < 2^63, so they are non-negative int64; int64's
add and multiply wrap like u64's, and every logical right shift is masked
(`shr_u64`). Below 2^31 the product of two residues fits int64 and the plain
`%` computes the JAX package's values. Above it the u64 engine's products
take the JAX package's own route: the high word of a 64 x 64 product from
four 32-bit limb products (`mulhi64`), Shoup products against constants and
Montgomery reduction (REDC) for the rest. Every function returns the
canonical residue in [0, q), so the results are bit-identical to the JAX
package's. The CUDA kernels compute the same values with `__umul64hi`
(`csrc/u64.cuh`).

The modulus switches reproduce the reference's f64 rounding
(`zq.rs:128-140`): the int64 -> f64 conversion, one multiply, then one
divide, as separate IEEE operations.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def as_i64(v: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    v %= 1 << 64
    return v - (1 << 64) if v >= 1 << 63 else v


def shr_u64(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64-carried u64 values."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (64 - k)) - 1)


def _csub(r: torch.Tensor, q: int) -> torch.Tensor:
    """r mod q for a u64 r < 2q (int64 r < 0 when r >= 2^63)."""
    return torch.where((r >= q) | (r < 0), r - q, r)


def add_mod(a: torch.Tensor, b, q: int) -> torch.Tensor:
    """(a + b) mod q, inputs reduced."""
    return _csub(a + b, q)


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


def to_center_u64(a: torch.Tensor, q: int) -> torch.Tensor:
    """Centered lift as two's-complement u64 (`zq.rs:83-89`): the int64
    values of `to_center_i64`, whose bits are the u64's."""
    return to_center_i64(a, q)


def is_pow2(q: int) -> bool:
    return q & (q - 1) == 0


# ---------------------------------------------------------------------------
# The u64 engine (q < 2^63): Shoup and Montgomery products on 32-bit limbs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ZqParams:
    """Reduction constants for one odd modulus q < 2^63."""

    q: int
    neg_q_inv: int = field(init=False)  # -q^-1 mod 2^64 (REDC)
    r1: int = field(init=False)  # 2^64 mod q (Montgomery one)
    r2: int = field(init=False)  # 2^128 mod q (enter / leave Montgomery)

    def __post_init__(self):
        assert self.q % 2 == 1 and 1 < self.q < (1 << 63)
        object.__setattr__(self, "neg_q_inv", (-pow(self.q, -1, 1 << 64)) % (1 << 64))
        object.__setattr__(self, "r1", (1 << 64) % self.q)
        object.__setattr__(self, "r2", (1 << 128) % self.q)


def shoup_precompute(w, q: int) -> np.ndarray:
    """w' = floor(w * 2^64 / q) as u64, for Shoup constant products."""
    w_arr = np.asarray(w, dtype=object)
    out = np.array([(int(v) << 64) // q for v in w_arr.reshape(-1)], dtype=np.uint64)
    return out.reshape(w_arr.shape)


def mulhi64(a: torch.Tensor, b) -> torch.Tensor:
    """High 64 bits of the 128-bit product of u64 a and b: four products of
    32-bit limbs, each wrapping int64 where it exceeds 2^63."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    a_lo, a_hi = a & MASK32, shr_u64(a, 32)
    b_lo, b_hi = b & MASK32, shr_u64(b, 32)
    ll, lh, hl, hh = a_lo * b_lo, a_lo * b_hi, a_hi * b_lo, a_hi * b_hi
    mid = shr_u64(ll, 32) + (lh & MASK32) + (hl & MASK32)
    return hh + shr_u64(lh, 32) + shr_u64(hl, 32) + shr_u64(mid, 32)


def mul_shoup(a: torch.Tensor, w, w_shoup, q: int) -> torch.Tensor:
    """a * w mod q for a constant w with its Shoup dual w' (int64 bits):
    a*w - floor(a*w' / 2^64)*q, both wrapping, then one conditional
    subtract. Exact for q < 2^63."""
    return _csub(a * w - mulhi64(a, w_shoup) * q, q)


def _redc(t_hi: torch.Tensor, t_lo: torch.Tensor, q: int, neg_q_inv: int) -> torch.Tensor:
    """t * 2^-64 mod q, below 2q, for t = t_hi * 2^64 + t_lo < q * 2^64."""
    m = t_lo * as_i64(neg_q_inv)
    return t_hi + mulhi64(m, q) + (t_lo != 0).long()


def mont_mul(a_mont: torch.Tensor, b, zq: ZqParams) -> torch.Tensor:
    """a_mont * b * 2^-64 mod q: the plain product a * b mod q when a_mont
    is a in the Montgomery domain."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a_mont.device)
    return _csub(_redc(mulhi64(a_mont, b), a_mont * b, zq.q, zq.neg_q_inv), zq.q)


def mul_mod(a: torch.Tensor, b, zq: ZqParams) -> torch.Tensor:
    """a * b mod q by two REDC passes (the second by 2^128 mod q)."""
    return mont_mul(mont_mul(a, b, zq), zq.r2, zq)


def to_montgomery(a: torch.Tensor, zq: ZqParams) -> torch.Tensor:
    """a * 2^64 mod q."""
    return mont_mul(a, zq.r2, zq)


def generic_mul_mod(a: torch.Tensor, b, q: int) -> torch.Tensor:
    """a * b mod q for a power of two or an odd q < 2^63: a mask for powers
    of two, the int64 product for odd q below 2^31, Montgomery above. An
    even q that is not a power of two raises, as the JAX package does."""
    if is_pow2(q):
        return (a * b) & (q - 1)
    if q % 2 == 0:
        raise NotImplementedError("even non-power-of-two modulus")
    if q < 1 << 31:
        return (a * b) % q
    return mul_mod(a, b, ZqParams(q))


def barrett_reduce_u64(a: torch.Tensor, q: int) -> torch.Tensor:
    """Any u64 (int64 bits) into [0, q): floor(a/q) by the high word against
    floor(2^64/q), then up to two corrections."""
    r = a - mulhi64(a, as_i64((1 << 64) // q)) * q
    return _csub(_csub(r, q), q)


def sum_mod(x: torch.Tensor, q: int, axis: int = 0) -> torch.Tensor:
    """The sum of reduced values mod q along an axis: a raw (wrapping) u64
    sum where it cannot overflow, else a log-depth tree of modular adds."""
    if is_pow2(q):
        return x.sum(axis) & (q - 1)
    if x.shape[axis] * (q - 1) < 1 << 63:
        return x.sum(axis) % q
    if x.shape[axis] * (q - 1) < 1 << 64:
        return barrett_reduce_u64(x.sum(axis), q)
    x = x.movedim(axis, 0)
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, torch.zeros_like(x[:1])])
        h = x.shape[0] // 2
        x = add_mod(x[:h], x[h:], q)
    return x[0]


def modular_dot(x: torch.Tensor, mat: torch.Tensor, q: int) -> torch.Tensor:
    """sum_k x[..., k] * mat[k] mod q, mat (K,) or (K, M), reduced inputs:
    each product reduced, then the modular sum."""
    if mat.dim() == 1:
        return sum_mod(generic_mul_mod(x, mat, q), q, axis=-1)
    return sum_mod(generic_mul_mod(x[..., :, None], mat, q), q, axis=-2)
