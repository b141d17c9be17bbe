"""TLWE: LWE over the discretized torus Z/2^64 (`learn_fhe_tpu/models/tfhe/tlwe.py`).

Torus values are int64 bit patterns: additions, dot products and gadget
digits wrap exactly as u64 does and need no reduction.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops.gadget import decompose_t64, power_up_t64, shr_u64
from ...utils import kernels
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


def _mxu_route(params: TlweParams, k: int) -> bool:
    """Whether the contraction takes the int8 limb route, as the JAX package
    chooses it (`learn_fhe_tpu/models/tfhe/tlwe.py:107`): the digits fit
    int8 (log_b <= 7: +B/2 <= 64) and every limb sum stays below 2^31."""
    return params.log_b <= 7 and k * (1 << (params.log_b - 1)) < (1 << 23)


def key_switch(
    params: TlweParams, ksk: TlweKeySwitchingKey, ct: TlweCiphertext
) -> TlweCiphertext:
    """Wrapping decompose-dot (`tlwe.rs:144-153`).

    When the gadget digits fit int8 the product runs as 8 int8 products
    against balanced byte limbs of the key, with exact int32 sums and
    wrapping recombination: bit-identical to the u64 dot. On a CUDA tensor
    that is K6 (`csrc/tfhe_keyswitch.cu`, counter `key_switch.launches`);
    on a CPU tensor its plain version, `key_switch_ref`. Where the digits do
    not fit (log_b = 8), the u64 product on either device, as the JAX
    package chooses it (counter `key_switch.u64_calls`)."""
    d, n_from, n_to = ksk.a.shape
    if ct.a.is_cpu or not _mxu_route(params, d * n_from):
        return key_switch_ref(params, ksk, ct)
    batch = ct.b.shape
    out = _k6(params, ksk, ct.a.reshape(-1, n_from).contiguous(), ct.b.reshape(-1).contiguous(), 1, 0, "key_switch")
    key_switch.launches += 1
    return TlweCiphertext(out.a.reshape(*batch, n_to), out.b.reshape(batch))


key_switch.launches = key_switch.u64_calls = 0


def key_switch_ref(params: TlweParams, ksk: TlweKeySwitchingKey, ct: TlweCiphertext) -> TlweCiphertext:
    """Plain version of K6 without the extract (either device): the limb
    products of `_mxu_wrapping_dot`, or the u64 product where the digits do
    not fit int8. The key's b column rides along as column n_to."""
    limbs = decompose_t64(ct.a, params.gadget).movedim(0, -2)  # (..., d, n_from)
    flat = limbs.reshape(*limbs.shape[:-2], -1)  # (..., d*n_from)
    d, n_from, n_to = ksk.a.shape
    K = d * n_from
    if _mxu_route(params, K):
        key = torch.cat([ksk.a.reshape(K, n_to), ksk.b.reshape(K, 1)], dim=1)
        out = _mxu_wrapping_dot(flat, key)
        return TlweCiphertext(out[..., :n_to], out[..., n_to] + ct.b)
    if not ct.a.is_cpu:
        key_switch.u64_calls += 1
    a = (flat[..., :, None] * ksk.a.reshape(K, n_to)).sum(-2)
    b = (flat * ksk.b.reshape(K)).sum(-1)
    return TlweCiphertext(a, b + ct.b)


def _sample_extract(acc_a: torch.Tensor, acc_b: torch.Tensor) -> TlweCiphertext:
    """Coefficient 0 of a (..., k, N) accumulator as a flat k*N TLWE
    ciphertext (`tglwe.sample_extract(params, acc, 0)`): mask [a_0, -a_{N-1},
    .., -a_1] per ring component, body b_0."""
    a = torch.cat([acc_a[..., :1], -acc_a[..., 1:].flip(-1)], dim=-1)
    return TlweCiphertext(a.reshape(*a.shape[:-2], -1), acc_b[..., 0])


def extract_key_switch(params: TlweParams, ksk: TlweKeySwitchingKey, acc) -> TlweCiphertext:
    """The PBS's last step: `key_switch(params, ksk, sample_extract(acc, 0))`
    of a blind rotation's accumulator acc (a (..., k, N), b (..., N) int64),
    bit for bit. On a CUDA tensor one launch of K6 (`lft_tfhe_key_switch`,
    counter `.launches`), which forms the extracted mask as it reads acc.a;
    on a CPU tensor the plain version. Where the digits do not fit int8,
    the extract and the u64 product on either device (counted by
    `key_switch.u64_calls` on the card)."""
    *batch, k, n_big = acc.a.shape
    d, n_from, n_to = ksk.a.shape
    if acc.a.is_cpu or not _mxu_route(params, d * n_from):
        return extract_key_switch_ref(params, ksk, acc)
    if k * n_big != n_from:
        raise ValueError(f"extract_key_switch: the accumulator's k*N = {k * n_big} differs from the key's n_from = {n_from}")
    out = _k6(params, ksk, acc.a.reshape(-1, n_from), acc.b.reshape(-1, n_big), n_big, n_big, "extract_key_switch")
    extract_key_switch.launches += 1
    return TlweCiphertext(out.a.reshape(*batch, n_to), out.b.reshape(batch))


extract_key_switch.launches = 0


def extract_key_switch_ref(params: TlweParams, ksk: TlweKeySwitchingKey, acc) -> TlweCiphertext:
    """Plain version of `extract_key_switch` (either device): the extract,
    then `key_switch_ref`."""
    return key_switch_ref(params, ksk, _sample_extract(acc.a, acc.b))


def _k6(params: TlweParams, ksk: TlweKeySwitchingKey, a: torch.Tensor, b: torch.Tensor, b_stride: int, n_big: int, name: str):
    """Launch K6 on (B, n_from) masks a (the accumulator's (B, k*N) when
    n_big > 0) and the b column b (row r at r * b_stride); returns new
    (B, n_to), (B,) int64 tensors."""
    d, n_from, n_to = ksk.a.shape
    B = a.shape[0]
    kernels.require(f"{name} a", a, torch.int64, (B, n_from))
    kernels.require(f"{name} b", b, torch.int64)
    if b.numel() != B * b_stride:
        raise ValueError(f"{name}: expected {B * b_stride} values of b, got {b.numel()}")
    kernels.require(f"{name} ksk.a", ksk.a, torch.int64, (d, n_from, n_to))
    kernels.require(f"{name} ksk.b", ksk.b, torch.int64, (d, n_from))
    out = TlweCiphertext(a.new_empty((B, n_to)), a.new_empty((B,)))
    if B:
        kernels.launch(
            "lft_tfhe_key_switch", a.data_ptr(), b.data_ptr(), b_stride, ksk.a.data_ptr(), ksk.b.data_ptr(),
            out.a.data_ptr(), out.b.data_ptr(), B, n_from, n_to, n_big, params.log_b, params.d, params.gadget.rounding_bits,
        )  # fmt: skip
    return out


def _mxu_wrapping_dot(digits: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """sum_k digits[..., k] * key[k, :] mod 2^64 with |digit| <= 127.

    key: int64 -> 8 balanced base-256 int8 limbs (exact mod 2^64). Each limb
    product is exact (the caller's gate bounds K * max|digit| * 128 < 2^31)."""
    batch = digits.shape[:-1]
    dig = digits.reshape(-1, digits.shape[-1])
    t = key
    out = None
    for j in range(8):
        limb = ((t + 128) & 255) - 128  # balanced digit in [-128, 128)
        t = (t - limb) >> 8
        term = _limb_matmul(dig, limb) * (1 << (8 * j))  # wraps
        out = term if out is None else out + term
    return out.reshape(*batch, key.shape[1])


def _limb_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact (M, K) @ (K, n) of int8-range values -> (M, n) int64, on either
    device: a float64 product, exact because every sum is below 2^31 (the
    gate of `_mxu_route`), far inside float64's 2^53."""
    return torch.matmul(x.double(), w.double()).long()
