"""LWE over Z_q, batched (`learn_fhe_tpu/models/fhew/lwe.py`).

Ciphertext = (a: (..., n), b: (...,)) int64 holding values in [0, q). Secret
keys are host numpy int64 vectors; sampling is host work and draws from the
caller's generator in the JAX package's order. The threshold (share) API
mirrors `lwe.rs:163-238`: shares are functions of a common mask from the
common reference string, and merging is addition.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from ...ops.gadget import decompose_zq, power_up_zq
from ...ops.modular import (
    _round_half_away,
    add_mod,
    from_i64,
    mod_switch,
    mod_switch_odd,
    modular_dot,
    neg_mod,
    sub_mod,
    to_center_i64,
)
from ...utils.distributions import dg, uniform_zq
from ...utils.interop import resolve_device, u64_to_torch
from .params import LweParams


class LweCiphertext(NamedTuple):
    a: torch.Tensor  # (..., n)
    b: torch.Tensor  # (...,)


class LweKeySwitchingKey(NamedTuple):
    a: torch.Tensor  # (d, n_from, n_to)
    b: torch.Tensor  # (d, n_from)


def add(params: LweParams, ct0: LweCiphertext, ct1: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(add_mod(ct0.a, ct1.a, params.q), add_mod(ct0.b, ct1.b, params.q))


def sub(params: LweParams, ct0: LweCiphertext, ct1: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(sub_mod(ct0.a, ct1.a, params.q), sub_mod(ct0.b, ct1.b, params.q))


def double(params: LweParams, ct: LweCiphertext) -> LweCiphertext:
    return add(params, ct, ct)


def neg(params: LweParams, ct: LweCiphertext) -> LweCiphertext:
    return LweCiphertext(neg_mod(ct.a, params.q), neg_mod(ct.b, params.q))


def ct_mod_switch(ct: LweCiphertext, q: int, q_prime: int) -> LweCiphertext:
    return LweCiphertext(mod_switch(ct.a, q, q_prime), mod_switch(ct.b, q, q_prime))


def ct_mod_switch_odd(ct: LweCiphertext, q: int, q_prime: int) -> LweCiphertext:
    return LweCiphertext(mod_switch_odd(ct.a, q, q_prime), mod_switch_odd(ct.b, q, q_prime))


def sk_gen(params: LweParams, rng: np.random.Generator) -> np.ndarray:
    """Secret key ~ dg(3.2, 6)^n, host int64 (`lwe.rs:103-106`)."""
    return dg(3.2, 6, rng, params.n)


def encode(params: LweParams, m: torch.Tensor) -> torch.Tensor:
    """round(centered(m) * q/p) mod q in f64 (`lwe.rs:121-124`)."""
    mc = to_center_i64(m.long(), params.p).double()
    return _round_half_away(mc * params.delta).long() % params.q


def decode(params: LweParams, pt: torch.Tensor) -> torch.Tensor:
    """round(centered(pt) / delta) mod p (`lwe.rs:126-128`)."""
    ptc = to_center_i64(pt, params.q).double()
    return _round_half_away(ptc / params.delta).long() % params.p


def _sk_q(params: LweParams, sk: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(sk, dtype=np.int64) % params.q, device=device)


def sk_encrypt(params: LweParams, sk: np.ndarray, pt: torch.Tensor, rng: np.random.Generator) -> LweCiphertext:
    """b = <a, sk> + pt + e with fresh uniform a (`lwe.rs:130-140`); pt may
    carry any batch shape."""
    shape = tuple(pt.shape)
    a = u64_to_torch(uniform_zq(params.q, rng, (*shape, params.n)), pt.device)
    e = from_i64(torch.as_tensor(dg(3.2, 6, rng, shape), device=pt.device), params.q)
    b = add_mod(add_mod(modular_dot(a, _sk_q(params, sk, pt.device), params.q), pt, params.q), e, params.q)
    return LweCiphertext(a, b)


def decrypt(params: LweParams, sk: np.ndarray, ct: LweCiphertext) -> torch.Tensor:
    """pt = b - <a, sk> (`lwe.rs:142-149`)."""
    return sub_mod(ct.b, modular_dot(ct.a, _sk_q(params, sk, ct.a.device), params.q), params.q)


def ksk_gen(
    params: LweParams,
    sk0: np.ndarray,
    sk1: np.ndarray,
    rng: np.random.Generator,
    device: torch.device | str | None = None,
) -> LweKeySwitchingKey:
    """Encrypt power_up(-sk1) under sk0 (`lwe.rs:108-119`), rows (d, n_from),
    on `device` (by default the current CUDA device; see `resolve_device`)."""
    neg_sk1 = from_i64(torch.as_tensor(-np.asarray(sk1, dtype=np.int64), device=resolve_device(device)), params.q)
    ct = sk_encrypt(params, sk0, power_up_zq(neg_sk1, params.gadget), rng)
    return LweKeySwitchingKey(ct.a, ct.b)


def key_switch(params: LweParams, ksk: LweKeySwitchingKey, ct: LweCiphertext) -> LweCiphertext:
    """Decompose ct.a and dot against the key rows (`lwe.rs:151-160`).

    The (..., d * n_from) x (d * n_from, n_to) product is a float64 matmul:
    CUDA has no int64 one. Digits and key are below q, so every partial sum
    is an integer below d * n_from * q^2, which the check keeps under 2^53:
    the product is exact in any summation order."""
    d, n_from, n_to = ksk.a.shape
    k = d * n_from
    if k * (params.q - 1) ** 2 >= 1 << 53:
        raise ValueError(f"key_switch: {k} terms below q={params.q} may round in float64")
    limbs = decompose_zq(ct.a, params.gadget).movedim(0, -2)  # (..., d, n_from)
    flat = limbs.reshape(*limbs.shape[:-2], k).double()
    key = torch.cat([ksk.a.reshape(k, n_to), ksk.b.reshape(k, 1)], dim=1).double()
    out = torch.matmul(flat, key).long() % params.q
    return LweCiphertext(out[..., :n_to], add_mod(out[..., n_to], ct.b, params.q))


# -- threshold / multi-party API (`lwe.rs:163-238`) --------------------------


def _dot_sk(params: LweParams, a: torch.Tensor, sk: np.ndarray) -> torch.Tensor:
    return modular_dot(a, _sk_q(params, sk, a.device), params.q)


def sk_share_encrypt(
    params: LweParams, a: torch.Tensor, sk: np.ndarray, pt: torch.Tensor, rng: np.random.Generator
) -> torch.Tensor:
    """b-share <a, sk> + pt + e under the common mask a."""
    e = from_i64(torch.as_tensor(dg(3.2, 6, rng, tuple(pt.shape)), device=pt.device), params.q)
    return add_mod(add_mod(_dot_sk(params, a, sk), pt, params.q), e, params.q)


def encryption_share_merge(params: LweParams, a: torch.Tensor, shares: Iterable[torch.Tensor]) -> LweCiphertext:
    b = None
    for s in shares:
        b = s if b is None else add_mod(b, s, params.q)
    return LweCiphertext(a, b)


def share_decrypt(params: LweParams, sk: np.ndarray, a: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
    """Noisy partial decryption <a, sk_i> + e (`lwe.rs:194-203`)."""
    e = from_i64(torch.as_tensor(dg(3.2, 6, rng, tuple(a.shape[:-1])), device=a.device), params.q)
    return add_mod(_dot_sk(params, a, sk), e, params.q)


def decryption_share_merge(params: LweParams, b: torch.Tensor, shares: Iterable[torch.Tensor]) -> torch.Tensor:
    acc = None
    for s in shares:
        acc = s if acc is None else add_mod(acc, s, params.q)
    return sub_mod(b, acc, params.q)


def ksk_share_gen(
    params: LweParams, crs_a: torch.Tensor, sk0: np.ndarray, sk1: np.ndarray, rng: np.random.Generator
) -> torch.Tensor:
    """b-shares (d, n_from) of a key switching key under the common rows
    crs_a (d, n_from, n) (`lwe.rs:214-226`)."""
    neg_sk1 = from_i64(torch.as_tensor(-np.asarray(sk1, dtype=np.int64), device=crs_a.device), params.q)
    return sk_share_encrypt(params, crs_a, sk0, power_up_zq(neg_sk1, params.gadget), rng)


def ksk_share_merge(params: LweParams, crs_a: torch.Tensor, shares: Iterable[torch.Tensor]) -> LweKeySwitchingKey:
    ct = encryption_share_merge(params, crs_a, shares)
    return LweKeySwitchingKey(ct.a, ct.b)
