"""RGSW gadget encryptions and the external product
(`learn_fhe_tpu/models/fhew/rgsw.py`).

An RGSW ciphertext is 2d RLWE rows on a leading axis, (a: (..., 2d, N),
b: (..., 2d, N)) in the coefficient basis: rows 0..d carry the gadget powers
in a, rows d..2d in b (`rgsw.rs:84-105`). For the blind rotation the key
lives in the evaluation basis with Shoup duals (`RgswEval`); an external
product is 2d forward NTTs of the accumulator's digits, a pointwise
contraction over the 2d rows and two inverse NTTs. `pk_encrypt_rgsw` and
`internal_product` (multi-key) are not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops.gadget import decompose_zq32, power_up_zq
from ...ops.modular import add_mod
from ...ops.modular32 import mul_shoup32, shoup32_dual, sum_mod32
from ...ops.ntt32 import intt32, ntt32
from .params import RgswParams
from .rlwe import RlweCiphertext, sk_encrypt


class RgswCiphertext(NamedTuple):
    a: torch.Tensor  # (..., 2d, N) int64
    b: torch.Tensor


class RgswEval(NamedTuple):
    """Evaluation-basis rows (int32) with their Shoup duals."""

    a: torch.Tensor  # (..., 2d, N)
    b: torch.Tensor
    a_dual: torch.Tensor
    b_dual: torch.Tensor


def sk_encrypt_rgsw(params: RgswParams, sk: np.ndarray, pt: torch.Tensor, rng: np.random.Generator) -> RgswCiphertext:
    """2d encryptions of zero, plus the gadget powers of pt (..., N) in the
    a part of rows 0..d and the b part of rows d..2d."""
    d = params.gadget.d
    zeros = sk_encrypt(
        params.rlwe, sk, torch.zeros((*pt.shape[:-1], 2 * d, params.n), dtype=torch.int64, device=pt.device), rng
    )
    powers = power_up_zq(pt, params.gadget).movedim(0, -2)  # (..., d, N)
    a, b = zeros.a, zeros.b
    a[..., :d, :] = add_mod(a[..., :d, :], powers, params.q)
    b[..., d:, :] = add_mod(b[..., d:, :], powers, params.q)
    return RgswCiphertext(a, b)


def to_eval(params: RgswParams, ct: RgswCiphertext) -> RgswEval:
    """The forward NTT of every row (K-NTT) and the Shoup duals."""
    ea = ntt32(ct.a.to(torch.int32).contiguous(), params.plan32)
    eb = ntt32(ct.b.to(torch.int32).contiguous(), params.plan32)
    return RgswEval(ea, eb, shoup32_dual(ea, params.q), shoup32_dual(eb, params.q))


def external_product(params: RgswParams, key: RgswEval, ct: RlweCiphertext) -> RlweCiphertext:
    """RGSW x RLWE -> RLWE (`rgsw.rs:116-128`); keeps the ciphertext's dtype
    (int32 residues or int64 values)."""
    out = _external_product32(params, key, ct)
    if ct.a.dtype == torch.int32:
        return out
    return RlweCiphertext(out.a.long(), out.b.long())


def _external_product32(params: RgswParams, key: RgswEval, ct: RlweCiphertext) -> RlweCiphertext:
    q = params.q
    la = decompose_zq32(ct.a, params.gadget)  # (d, ..., N)
    lb = decompose_zq32(ct.b, params.gadget)
    limbs = torch.cat([la, lb], dim=0).movedim(0, -2).contiguous()  # (..., 2d, N)
    limbs_eval = ntt32(limbs, params.plan32)
    a_eval = sum_mod32(mul_shoup32(limbs_eval, key.a, key.a_dual, q), q, axis=-2)
    b_eval = sum_mod32(mul_shoup32(limbs_eval, key.b, key.b_dual, q), q, axis=-2)
    return RlweCiphertext(intt32(a_eval.to(torch.int32), params.plan32), intt32(b_eval.to(torch.int32), params.plan32))
