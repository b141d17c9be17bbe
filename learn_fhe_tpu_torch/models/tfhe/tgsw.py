"""TGSW: gadget encryption of a torus scalar over TLWE vectors
(`learn_fhe_tpu/models/tfhe/tgsw.py`, reference `tgsw.rs`), for the scalar
CMux; the ring variant in tggsw.py is the bootstrapping workhorse.

Layout: R = (n+1)*d rows of TLWE ciphertexts, a: (..., R, n), b: (..., R).
Rows j*d..(j+1)*d (j < n) carry gadget powers added to a[:, j]; the last d
rows carry them on b (`tgsw.rs:70-86`). Torus values are int64 bit
patterns: the products and sums of the external product wrap as u64 does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops.gadget import decompose_t64, power_up_t64, shr_u64
from . import tlwe
from .params import TgswParams
from .tlwe import TlweCiphertext


class TgswCiphertext(NamedTuple):
    a: torch.Tensor  # (..., R, n) int64
    b: torch.Tensor  # (..., R)


def sk_encrypt(params: TgswParams, sk: np.ndarray, pt: torch.Tensor, rng: np.random.Generator) -> TgswCiphertext:
    """pt: (...,) torus scalars; R zero-encryptions plus gadget powers
    (`tgsw.rs:70-86`), on pt's device."""
    n, d = params.tlwe.n, params.d
    powers = power_up_t64(pt, params.gadget).movedim(0, -1)  # (..., d)
    shape = (*powers.shape[:-1], (n + 1) * d)
    zeros = tlwe.sk_encrypt(params.tlwe, sk, torch.zeros(shape, dtype=torch.int64, device=pt.device), rng)
    a, b = zeros.a, zeros.b
    for j in range(n):
        a[..., j * d : (j + 1) * d, j] += powers
    b[..., n * d :] += powers
    return TgswCiphertext(a, b)


def decrypt(params: TgswParams, sk: np.ndarray, ct: TgswCiphertext) -> torch.Tensor:
    """Decrypt the last row, rounding-shr by the top base (`tgsw.rs:88-95`)."""
    mu_star = ct.b[..., -1] - tlwe._dot_sk(ct.a[..., -1, :], sk)
    bits = params.gadget.log_bases[-1]
    return shr_u64(mu_star + ((1 << bits) >> 1), bits)


def external_product(params: TgswParams, ct0: TgswCiphertext, ct1: TlweCiphertext) -> TlweCiphertext:
    """decompose(a || b) dotted against the rows (`tgsw.rs:97-108`)."""
    ab = torch.cat([ct1.a, ct1.b[..., None]], dim=-1)  # (..., n+1)
    limbs = decompose_t64(ab, params.gadget).movedim(0, -1)  # (..., n+1, d)
    flat = limbs.reshape(*limbs.shape[:-2], -1)  # (..., R) component-major
    return TlweCiphertext((flat[..., :, None] * ct0.a).sum(-2), (flat * ct0.b).sum(-1))


def cmux(params: TgswParams, b: TgswCiphertext, ct0: TlweCiphertext, ct1: TlweCiphertext) -> TlweCiphertext:
    """ct0 + b (*) (ct1 - ct0) (`tgsw.rs:110-117`)."""
    prod = external_product(params, b, tlwe.sub(ct1, ct0))
    return tlwe.add(ct0, prod)
