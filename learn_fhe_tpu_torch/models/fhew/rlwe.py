"""RLWE over R_q, batched (`learn_fhe_tpu/models/fhew/rlwe.py`).

Ciphertext = (a: (..., N), b: (..., N)) in the coefficient basis: int64
values in [0, q), or int32 residues inside the blind rotation. Key-switching
keys live in the evaluation basis with Shoup duals (int32), so a key switch
is d forward NTTs of the digit rows, a pointwise contraction and two inverse
NTTs. The products of key generation run on `ops.ntt32.negacyclic_mul32`.
The share / threshold API is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops.gadget import decompose_zq32, power_up_zq
from ...ops.modular import add_mod, from_i64, sub_mod
from ...ops.modular32 import add_mod32, mul_shoup32, shoup32_dual, sum_mod32
from ...ops.ntt32 import intt32, negacyclic_mul32, ntt32
from ...ops.poly import automorphism_i64, automorphism_zq, sample_extract_a
from ...utils.distributions import dg, uniform_zq
from ...utils.interop import resolve_device, u64_to_torch
from .lwe import LweCiphertext
from .params import RlweParams


class RlweCiphertext(NamedTuple):
    a: torch.Tensor  # (..., N)
    b: torch.Tensor  # (..., N)


class RlweKeySwitchingKey(NamedTuple):
    """Rows enc(-sk1 * B^i) in the evaluation basis, int32 with Shoup duals."""

    a_eval: torch.Tensor  # (d, N)
    b_eval: torch.Tensor  # (d, N)
    a_dual: torch.Tensor
    b_dual: torch.Tensor


class RlweAutoKey(NamedTuple):
    t: int
    ksk: RlweKeySwitchingKey


def sk_gen(params: RlweParams, rng: np.random.Generator) -> np.ndarray:
    return dg(3.2, 6, rng, params.n)


def _mul_sk(params: RlweParams, a: torch.Tensor, sk: np.ndarray) -> torch.Tensor:
    """a * sk mod (X^N+1, q) for every row of a (int64 values)."""
    sk_q = from_i64(torch.as_tensor(np.asarray(sk, dtype=np.int64), device=a.device), params.q)
    a32 = a.to(torch.int32).contiguous()
    return negacyclic_mul32(a32, sk_q.to(torch.int32).expand(a32.shape).contiguous(), params.plan32).long()


def sk_encrypt(params: RlweParams, sk: np.ndarray, pt: torch.Tensor, rng: np.random.Generator) -> RlweCiphertext:
    """b = a*sk + e + pt (`rlwe.rs:146-156`); pt may be batched (..., N)."""
    shape = tuple(pt.shape)
    a = u64_to_torch(uniform_zq(params.q, rng, shape), pt.device)
    e = from_i64(torch.as_tensor(dg(3.2, 6, rng, shape), device=pt.device), params.q)
    return RlweCiphertext(a, add_mod(add_mod(_mul_sk(params, a, sk), e, params.q), pt, params.q))


def decrypt(params: RlweParams, sk: np.ndarray, ct: RlweCiphertext) -> torch.Tensor:
    return sub_mod(ct.b.long(), _mul_sk(params, ct.a.long(), sk), params.q)


def make_ksk(params: RlweParams, ct: RlweCiphertext) -> RlweKeySwitchingKey:
    """A coefficient-basis key ciphertext into the evaluation basis (the
    forward NTT kernel) with Shoup duals."""
    ea = ntt32(ct.a.to(torch.int32).contiguous(), params.plan32)
    eb = ntt32(ct.b.to(torch.int32).contiguous(), params.plan32)
    return RlweKeySwitchingKey(ea, eb, shoup32_dual(ea, params.q), shoup32_dual(eb, params.q))


def ksk_gen(
    params: RlweParams,
    sk0: np.ndarray,
    sk1: np.ndarray,
    rng: np.random.Generator,
    device: torch.device | str | None = None,
) -> RlweKeySwitchingKey:
    """Rows enc_{sk0}(-sk1 * B^i) (`rlwe.rs:109-120`), on `device` (by
    default the current CUDA device)."""
    neg_sk1 = from_i64(torch.as_tensor(-np.asarray(sk1, dtype=np.int64), device=resolve_device(device)), params.q)
    ct = sk_encrypt(params, sk0, power_up_zq(neg_sk1, params.gadget), rng)
    return make_ksk(params, ct)


def ak_gen(
    params: RlweParams,
    t: int,
    sk: np.ndarray,
    rng: np.random.Generator,
    device: torch.device | str | None = None,
) -> RlweAutoKey:
    """Automorphism key: from sk o (X -> X^t) back to sk (`rlwe.rs:122-132`)."""
    assert t != 0
    return RlweAutoKey(t, ksk_gen(params, sk, automorphism_i64(np.asarray(sk), t), rng, device))


def key_switch(params: RlweParams, ksk: RlweKeySwitchingKey, ct: RlweCiphertext) -> RlweCiphertext:
    """a' = sum_i digit_i(a) * ksk.a_i, b' = sum_i digit_i(a) * ksk.b_i + b
    (`rlwe.rs:177-186`); keeps the ciphertext's dtype (int32 residues in,
    int32 out, as the JAX package keeps u32)."""
    out = _key_switch32(params, ksk, ct)
    if ct.a.dtype == torch.int32:
        return out
    return RlweCiphertext(out.a.long(), out.b.long())


def _key_switch32(params: RlweParams, ksk: RlweKeySwitchingKey, ct: RlweCiphertext) -> RlweCiphertext:
    q = params.q
    limbs_eval = ntt32(decompose_zq32(ct.a, params.gadget).contiguous(), params.plan32)  # (d, ..., N)

    def rows(t: torch.Tensor) -> torch.Tensor:
        """Key rows (..., d, N) with the digit axis first, any batch axes of
        the key (one key per ciphertext in the blind rotation) against the
        ciphertext's leading batch axes."""
        key_batch = t.shape[:-2]
        return t.movedim(-2, 0).reshape(t.shape[-2], *key_batch, *[1] * (limbs_eval.dim() - 2 - len(key_batch)), t.shape[-1])

    a_eval = sum_mod32(mul_shoup32(limbs_eval, rows(ksk.a_eval), rows(ksk.a_dual), q), q, axis=0)
    b_eval = sum_mod32(mul_shoup32(limbs_eval, rows(ksk.b_eval), rows(ksk.b_dual), q), q, axis=0)
    a = intt32(a_eval.to(torch.int32), params.plan32)
    b = add_mod32(intt32(b_eval.to(torch.int32), params.plan32).long(), ct.b.long(), q)
    return RlweCiphertext(a, b.to(torch.int32))


def automorphism(params: RlweParams, ak: RlweAutoKey, ct: RlweCiphertext) -> RlweCiphertext:
    """Map X -> X^t, then switch back to sk (`rlwe.rs:188-191`)."""
    ct_auto = RlweCiphertext(automorphism_zq(ct.a, ak.t, params.q), automorphism_zq(ct.b, ak.t, params.q))
    return key_switch(params, ak.ksk, ct_auto)


def sample_extract(params: RlweParams, ct: RlweCiphertext, i: int) -> LweCiphertext:
    """Coefficient i as an N-dimensional LWE ciphertext (`rlwe.rs:193-202`)."""
    assert 0 <= i < params.n
    return LweCiphertext(sample_extract_a(ct.a, i, params.q), ct.b[..., i])
