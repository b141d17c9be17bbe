"""TLWE: LWE over the discretized torus Z/2^64 (`learn_fhe_tpu/models/tfhe/tlwe.py`).

Torus values are int64 bit patterns: additions, dot products and gadget
digits wrap exactly as u64 does and need no reduction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops.gadget import decompose_t64, power_up_t64, shr_u64
from ...utils.distributions import binary, tdg, uniform_t64
from ...utils.interop import resolve_device, u64_to_torch
from .params import TlweParams


class TlweCiphertext(NamedTuple):
    a: torch.Tensor  # (..., n) int64
    b: torch.Tensor  # (...,) int64


class TlweKeySwitchingKey(NamedTuple):
    a: torch.Tensor  # (d, n_from, n_to)
    b: torch.Tensor  # (d, n_from)


def add(ct0: TlweCiphertext, ct1: TlweCiphertext) -> TlweCiphertext:
    return TlweCiphertext(ct0.a + ct1.a, ct0.b + ct1.b)


def sub(ct0: TlweCiphertext, ct1: TlweCiphertext) -> TlweCiphertext:
    return TlweCiphertext(ct0.a - ct1.a, ct0.b - ct1.b)


def sk_gen(params: TlweParams, rng: np.random.Generator) -> np.ndarray:
    """Binary secret (`tlwe.rs:96-98`)."""
    return binary(rng, params.n)


def encode(params: TlweParams, m: torch.Tensor) -> torch.Tensor:
    """Shift into the top bits (`tlwe.rs:113-116`)."""
    return m.long() << params.log_delta


def decode(params: TlweParams, pt: torch.Tensor) -> torch.Tensor:
    return shr_u64(pt, params.log_delta) % params.p


def _round(pt: torch.Tensor, bits: int) -> torch.Tensor:
    """rounding_shr then shift back (`decompose.rs:120-122`)."""
    return shr_u64(pt + ((1 << bits) >> 1), bits) << bits


def _dot_sk(a: torch.Tensor, sk: np.ndarray) -> torch.Tensor:
    return (a * torch.as_tensor(np.asarray(sk, dtype=np.int64), device=a.device)).sum(-1)


def sk_encrypt(
    params: TlweParams, sk: np.ndarray, pt: torch.Tensor, rng: np.random.Generator
) -> TlweCiphertext:
    a = u64_to_torch(uniform_t64(rng, (*pt.shape, params.n)), pt.device)
    e = u64_to_torch(tdg(params.std_dev, rng, tuple(pt.shape)), pt.device)
    return TlweCiphertext(a, _dot_sk(a, sk) + e + pt)


def decrypt(params: TlweParams, sk: np.ndarray, ct: TlweCiphertext) -> torch.Tensor:
    """Rounded phase (`tlwe.rs:134-142`)."""
    return _round(ct.b - _dot_sk(ct.a, sk), params.log_delta)


def ksk_gen(
    params: TlweParams,
    sk0: np.ndarray,
    sk1: np.ndarray,
    rng: np.random.Generator,
    device: torch.device | str | None = None,
) -> TlweKeySwitchingKey:
    """Encrypt power_up(-sk1) under sk0 (`tlwe.rs:100-111`), on `device`
    (by default the current CUDA device; see `resolve_device`)."""
    neg_sk1 = torch.as_tensor(-np.asarray(sk1, dtype=np.int64), device=resolve_device(device))
    pt = power_up_t64(neg_sk1, params.gadget)  # (d, n_from)
    ct = sk_encrypt(params, sk0, pt, rng)
    return TlweKeySwitchingKey(ct.a, ct.b)


def key_switch(
    params: TlweParams, ksk: TlweKeySwitchingKey, ct: TlweCiphertext
) -> TlweCiphertext:
    """Wrapping decompose-dot (`tlwe.rs:144-153`).

    When the gadget digits fit int8 (log_b <= 7, so +B/2 <= 64) the product
    runs as 8 int8 matrix products against balanced byte limbs of the key,
    with exact int32 accumulation and wrapping recombination: bit-identical
    to the u64 dot. The key's b column rides along as column n_to."""
    limbs = decompose_t64(ct.a, params.gadget).movedim(0, -2)  # (..., d, n_from)
    flat = limbs.reshape(*limbs.shape[:-2], -1)  # (..., d*n_from)
    d, n_from, n_to = ksk.a.shape
    K = d * n_from
    if params.log_b <= 7 and K * (1 << (params.log_b - 1)) < (1 << 23):
        key = torch.cat([ksk.a.reshape(K, n_to), ksk.b.reshape(K, 1)], dim=1)
        out = _mxu_wrapping_dot(flat, key)
        return TlweCiphertext(out[..., :n_to], out[..., n_to] + ct.b)
    a = (flat[..., :, None] * ksk.a.reshape(K, n_to)).sum(-2)
    b = (flat * ksk.b.reshape(K)).sum(-1)
    return TlweCiphertext(a, b + ct.b)


def _mxu_wrapping_dot(digits: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """sum_k digits[..., k] * key[k, :] mod 2^64 with |digit| <= 127.

    key: int64 -> 8 balanced base-256 int8 limbs (exact mod 2^64). Each limb
    product accumulates exactly in int32 (the caller's gate bounds
    K * max|digit| * 128 < 2^31)."""
    batch = digits.shape[:-1]
    dig8 = digits.reshape(-1, digits.shape[-1]).to(torch.int8)
    t = key
    out = None
    for j in range(8):
        limb = ((t + 128) & 255) - 128  # balanced digit in [-128, 128)
        t = (t - limb) >> 8
        term = _int8_matmul(dig8, limb.to(torch.int8)) * (1 << (8 * j))  # wraps
        out = term if out is None else out + term
    return out.reshape(*batch, key.shape[1])


def _int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact (M, K) int8 @ (K, n) int8 -> (M, n) int64.

    On the card this is `torch._int_mm` (int8 tensor cores, int32
    accumulation), the counterpart of the JAX package's i8 `dot_general`;
    it needs M > 16 and K, n multiples of 8, so the operands are zero-padded.
    On the CPU it is an int64 matmul of the same limbs."""
    if x.device.type == "cpu":
        return torch.matmul(x.long(), w.long())
    m, k = x.shape
    n = w.shape[1]
    mp, kp, np_ = max(-(-m // 8) * 8, 32), -(-k // 8) * 8, -(-n // 8) * 8
    xp = torch.zeros((mp, kp), dtype=torch.int8, device=x.device)
    xp[:m, :k] = x
    wp = torch.zeros((kp, np_), dtype=torch.int8, device=w.device)
    wp[:k, :n] = w
    return torch._int_mm(xp, wp)[:m, :n].long()
