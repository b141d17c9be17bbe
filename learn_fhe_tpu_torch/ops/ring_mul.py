"""Exact negacyclic ring multiplication for NON-NTT moduli.

Counterpart of `learn_fhe_tpu/ops/ring_mul.py`. The reference dispatches
ring muls on the modulus class: NTT for prime q, recursive Karatsuba for
power-of-two q and plain `i64` polynomials (`util/src/ring.rs:256-264`).
Here, as in the JAX package, the exact integer product comes from the
multi-prime CRT engine (`ops/torus_crt.py`): both operands are embedded mod
k NTT-friendly 31-bit primes, multiplied negacyclically per prime, and the
centered integer result is Garner-reconstructed mod 2^64. The plan takes
just enough primes for the declared coefficient bounds, the same plan the
JAX package takes, so the outputs are bit-identical.

Tensors are (..., n) int64 holding the u64 bit patterns (`utils/interop`).
On the card each prime is one K-POLYMUL launch (`ntt32.negacyclic_mul32`;
the primes are 31-bit, so its fused route) and the k residue planes one
K-GARNER launch, which takes up to 5 primes (the pow2 product at log_q = 64
needs 5 at n = 128 and at n = 2^14); on the CPU the plain versions of the
same calls run. At n = 1 the product is a wrapping int64 multiply, on
either device: K-POLYMUL takes 2 <= n <= 2^14.
"""

from __future__ import annotations

import torch

from .modular32 import i64_to_mod32
from .ntt32 import negacyclic_mul32
from .torus_crt import garner_to_u64, torus_crt_plan


def _crt_mul_u64(a: torch.Tensor, b: torch.Tensor, bound_bits: int) -> torch.Tensor:
    """Wrapping-u64 view of the exact centered negacyclic product of two
    centered two's-complement operands (int64 carriers)."""
    if a.shape[-1] == 1:
        return a * b  # the exact product, which the plan bounds, mod 2^64
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a, b = a.expand(shape), b.expand(shape)
    plan = torus_crt_plan(shape[-1], bound_bits)
    coeffs = [
        negacyclic_mul32(i64_to_mod32(a, q).int().contiguous(), i64_to_mod32(b, q).int().contiguous(), p)
        for q, p in zip(plan.primes, plan.plans)
    ]
    return garner_to_u64(torch.stack(coeffs), plan)


def negacyclic_mul_i64(a: torch.Tensor, b: torch.Tensor, bound_a_bits: int, bound_b_bits: int) -> torch.Tensor:
    """Exact a(X)*b(X) mod (X^n+1) over the INTEGERS, int64 in and out.

    |a_i| <= 2^bound_a_bits and |b_i| <= 2^bound_b_bits must hold; the result
    magnitude n*2^(bound_a+bound_b) must fit i64. Replaces the reference's
    `NegaCyclicRing<i64>` Karatsuba mul (`util/src/ring.rs:284-288`), e.g.
    the sk^2 ring square in CKKS keygen (`scheme/ckks/src/ckks.rs:78-80`)."""
    n = a.shape[-1]
    bound_bits = (n - 1).bit_length() + bound_a_bits + bound_b_bits + 1
    assert bound_bits <= 62, "result would overflow i64"
    return _crt_mul_u64(a.long(), b.long(), bound_bits)


def negacyclic_mul_pow2(a: torch.Tensor, b: torch.Tensor, log_q: int) -> torch.Tensor:
    """Exact a(X)*b(X) mod (X^n+1, 2^log_q), 1 <= log_q <= 64, on int64
    tensors holding the u64 values.

    The power-of-two-modulus branch of the reference's mul dispatch
    (`util/src/ring.rs:256-264` -> Karatsuba). Operands are centered before
    embedding so the plan needs primes covering only n * 2^(2*log_q-2)."""
    assert 1 <= log_q <= 64
    n = a.shape[-1]

    def center(x: torch.Tensor) -> torch.Tensor:
        x = x.long()
        if log_q == 64:
            return x
        # x >= 2^(log_q-1) as u64: a value at or past 2^63 reads negative
        high = (x < 0) | (x >= 1 << (log_q - 1))
        return torch.where(high, x + -(1 << log_q), x)  # - 2^log_q, wrapping as in u64

    # centered |coef| <= 2^(log_q-1); +1 slack on each bound for the <= edge
    bound_bits = (n - 1).bit_length() + 2 * log_q
    out = _crt_mul_u64(center(a), center(b), bound_bits)
    if log_q == 64:
        return out
    return out & ((1 << log_q) - 1)
