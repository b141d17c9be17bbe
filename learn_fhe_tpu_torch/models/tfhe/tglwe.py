"""TGLWE: ring-LWE over the torus (`learn_fhe_tpu/models/tfhe/tglwe.py`).

Ciphertext = (a: (..., k, N), b: (..., N)) int64. Ring products with the
binary secret go through the exact CRT torus multiplier
(`ops.torus_crt.negacyclic_mul_t64_crt`: the fused polymul kernel per prime,
then the Garner kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops.gadget import shr_u64
from ...ops.poly import monomial_mul_t64
from ...ops.torus_crt import negacyclic_mul_t64_crt
from ...utils.distributions import binary, tdg, uniform_t64
from ...utils.interop import u64_to_torch
from .params import TglweParams, TlweParams
from .tlwe import TlweCiphertext


class TglweCiphertext(NamedTuple):
    a: torch.Tensor  # (..., k, N)
    b: torch.Tensor  # (..., N)


def add(ct0: TglweCiphertext, ct1: TglweCiphertext) -> TglweCiphertext:
    return TglweCiphertext(ct0.a + ct1.a, ct0.b + ct1.b)


def sub(ct0: TglweCiphertext, ct1: TglweCiphertext) -> TglweCiphertext:
    return TglweCiphertext(ct0.a - ct1.a, ct0.b - ct1.b)


def sk_gen(params: TglweParams, rng: np.random.Generator) -> np.ndarray:
    """Binary key, chunked into k rings of degree N (`tglwe.rs:40-44,76-78`)."""
    return binary(rng, (params.k, params.big_n))


def encode(params: TglweParams, m: torch.Tensor) -> torch.Tensor:
    return m.long() << params.log_delta


def decode(params: TglweParams, pt: torch.Tensor) -> torch.Tensor:
    return shr_u64(pt, params.log_delta) % params.p


def _dot_sk(a: torch.Tensor, sk: np.ndarray) -> torch.Tensor:
    """sum_i a_i (*) s_i over the k ring components."""
    sk_t = torch.as_tensor(np.asarray(sk, dtype=np.int64), device=a.device)  # (k, N)
    return negacyclic_mul_t64_crt(sk_t, a, log_b=2).sum(-2)  # binary secret


def sk_encrypt(
    params: TglweParams, sk: np.ndarray, pt: torch.Tensor, rng: np.random.Generator
) -> TglweCiphertext:
    shape = tuple(pt.shape[:-1])
    a = u64_to_torch(uniform_t64(rng, (*shape, params.k, params.big_n)), pt.device)
    e = u64_to_torch(tdg(params.std_dev, rng, (*shape, params.big_n)), pt.device)
    return TglweCiphertext(a, _dot_sk(a, sk) + e + pt)


def decrypt(params: TglweParams, sk: np.ndarray, ct: TglweCiphertext) -> torch.Tensor:
    mu_star = ct.b - _dot_sk(ct.a, sk)
    bits = params.log_delta
    return shr_u64(mu_star + ((1 << bits) >> 1), bits) << bits


def rotate(ct: TglweCiphertext, i) -> TglweCiphertext:
    """Multiply every component by X^i (`tglwe.rs:61-67`); i is an int or a
    tensor of one shift per ciphertext (shape ct.b.shape[:-1])."""
    i = torch.as_tensor(i, device=ct.b.device)
    return TglweCiphertext(monomial_mul_t64(ct.a, i[..., None]), monomial_mul_t64(ct.b, i))


def sample_extract(params: TglweParams, ct: TglweCiphertext, i: int) -> TlweCiphertext:
    """Extract coefficient i as a flat big_n*k TLWE ciphertext
    (`tglwe.rs:115-127`)."""
    head = ct.a[..., : i + 1].flip(-1)
    tail = -ct.a[..., i + 1 :].flip(-1)
    a = torch.cat([head, tail], dim=-1)  # (..., k, N)
    return TlweCiphertext(a.reshape(*a.shape[:-2], params.k * params.big_n), ct.b[..., i])


def tlwe_view_params(params: TglweParams, log_b=None, d=None) -> TlweParams:
    return params.tlwe_view(log_b, d)
