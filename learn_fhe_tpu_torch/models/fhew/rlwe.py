"""RLWE over R_q, batched (`learn_fhe_tpu/models/fhew/rlwe.py`).

Ciphertext = (a: (..., N), b: (..., N)) in the coefficient basis: int64
values in [0, q), or int32 residues inside the u32 blind rotation.
Key-switching keys live in the evaluation basis: int32 with Shoup duals on
the u32 engine, int64 in the Montgomery domain (duals None) on the u64
engine, so a key switch is d forward NTTs of the digit rows, a pointwise
contraction and two inverse NTTs. The products of key generation and
encryption run on K-POLYMUL (`negacyclic_mul32`) below 2^31 and on
K-POLYMUL64 (`negacyclic_mul64`) above; the u64 key switch on the card is
K-EXTPROD64 (`rgsw.external_product64`).

The threshold (multi-party) API (`rlwe.rs:219-324`): shares are
encryptions under a common mask `a` from the CRS, and merging is addition.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch

from ...ops.gadget import decompose_zq32, power_up_zq
from ...ops.modular import _round_half_away, add_mod, from_i64, sub_mod, to_center_i64
from ...ops.modular32 import add_mod32, mul_shoup32, shoup32_dual, sum_mod32
from ...ops.ntt import negacyclic_mul64, ntt64_mont
from ...ops.ntt32 import intt32, negacyclic_mul32, ntt32
from ...ops.poly import automorphism_i64, automorphism_zq, sample_extract_a
from ...utils import kernels
from ...utils.distributions import dg, uniform_zq, zo
from ...utils.interop import resolve_device, u64_to_torch
from .lwe import LweCiphertext
from .params import RlweParams


class RlweCiphertext(NamedTuple):
    a: torch.Tensor  # (..., N)
    b: torch.Tensor  # (..., N)


class RlweKeySwitchingKey(NamedTuple):
    """Rows enc(-sk1 * B^i) in the evaluation basis: int32 with Shoup duals
    (u32 engine), or int64 in the Montgomery domain with the duals None."""

    a_eval: torch.Tensor  # (d, N)
    b_eval: torch.Tensor  # (d, N)
    a_dual: torch.Tensor | None = None
    b_dual: torch.Tensor | None = None


class RlweAutoKey(NamedTuple):
    t: int
    ksk: RlweKeySwitchingKey


def add(params: RlweParams, ct0: RlweCiphertext, ct1: RlweCiphertext) -> RlweCiphertext:
    return RlweCiphertext(add_mod(ct0.a, ct1.a, params.q), add_mod(ct0.b, ct1.b, params.q))


def sub(params: RlweParams, ct0: RlweCiphertext, ct1: RlweCiphertext) -> RlweCiphertext:
    return RlweCiphertext(sub_mod(ct0.a, ct1.a, params.q), sub_mod(ct0.b, ct1.b, params.q))


# -- keygen / encode / encrypt / decrypt -------------------------------------


def sk_gen(params: RlweParams, rng: np.random.Generator) -> np.ndarray:
    return dg(3.2, 6, rng, params.n)


def _polymul(params: RlweParams, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b mod (X^N+1, q) row by row, b broadcast to a's shape (int64
    values): K-POLYMUL's path below 2^31, K-POLYMUL64 above."""
    b = b.expand(a.shape)
    if params.q < 1 << 31:
        a32, b32 = a.to(torch.int32).contiguous(), b.to(torch.int32).contiguous()
        return negacyclic_mul32(a32, b32, params.plan32).long()
    return negacyclic_mul64(a.contiguous(), b.contiguous(), params.plan)


def _sk_q(params: RlweParams, sk: np.ndarray, device) -> torch.Tensor:
    return from_i64(torch.as_tensor(np.asarray(sk, dtype=np.int64), device=device), params.q)


def _dg_q(params: RlweParams, rng: np.random.Generator, shape, device) -> torch.Tensor:
    return from_i64(torch.as_tensor(dg(3.2, 6, rng, shape), device=device), params.q)


def encode(params: RlweParams, m: torch.Tensor) -> torch.Tensor:
    """round(centered(m) * q/p) mod q in f64."""
    mc = to_center_i64(m.long(), params.p).double()
    return _round_half_away(mc * params.delta).long() % params.q


def decode(params: RlweParams, pt: torch.Tensor) -> torch.Tensor:
    ptc = to_center_i64(pt, params.q).double()
    return _round_half_away(ptc / params.delta).long() % params.p


def sk_encrypt(params: RlweParams, sk: np.ndarray, pt: torch.Tensor, rng: np.random.Generator) -> RlweCiphertext:
    """b = a*sk + e + pt (`rlwe.rs:146-156`); pt may be batched (..., N)."""
    shape = tuple(pt.shape)
    a = u64_to_torch(uniform_zq(params.q, rng, shape), pt.device)
    e = _dg_q(params, rng, shape, pt.device)
    return RlweCiphertext(a, add_mod(add_mod(_polymul(params, a, _sk_q(params, sk, pt.device)), e, params.q), pt, params.q))


def pk_gen(params: RlweParams, sk: np.ndarray, rng: np.random.Generator, device=None) -> RlweCiphertext:
    """pk = an encryption of zero (`rlwe.rs:98-101`), on `device` (by default
    the current CUDA device; see `resolve_device`)."""
    return sk_encrypt(params, sk, torch.zeros(params.n, dtype=torch.int64, device=resolve_device(device)), rng)


def pk_encrypt(params: RlweParams, pk: RlweCiphertext, pt: torch.Tensor, rng: np.random.Generator) -> RlweCiphertext:
    """a = pk.a*u + e0, b = pk.b*u + e1 + pt with u ~ zo(0.5)
    (`rlwe.rs:158-170`); pt may be batched (..., N)."""
    shape, dev, q = tuple(pt.shape), pt.device, params.q
    u = from_i64(torch.as_tensor(zo(0.5, rng, shape), device=dev), q)
    e0 = _dg_q(params, rng, shape, dev)
    e1 = _dg_q(params, rng, shape, dev)
    a = add_mod(_polymul(params, u, pk.a), e0, q)
    b = add_mod(add_mod(_polymul(params, u, pk.b), e1, q), pt, q)
    return RlweCiphertext(a, b)


def decrypt(params: RlweParams, sk: np.ndarray, ct: RlweCiphertext) -> torch.Tensor:
    a = ct.a.long()
    return sub_mod(ct.b.long(), _polymul(params, a, _sk_q(params, sk, a.device)), params.q)


# -- key switching / automorphism / extraction -------------------------------


def _to_eval_mont(params: RlweParams, x: torch.Tensor) -> torch.Tensor:
    """The forward NTT into the Montgomery domain (K-NTT64's Montgomery
    instance, one launch)."""
    return ntt64_mont(x.contiguous(), params.plan)


def make_ksk(params: RlweParams, ct: RlweCiphertext) -> RlweKeySwitchingKey:
    """A coefficient-basis key ciphertext into the evaluation basis: int32
    with Shoup duals (the forward NTT kernel) where the u32 engine takes the
    parameters, else int64 in the Montgomery domain."""
    if params.use_u32:
        ea = ntt32(ct.a.to(torch.int32).contiguous(), params.plan32)
        eb = ntt32(ct.b.to(torch.int32).contiguous(), params.plan32)
        return RlweKeySwitchingKey(ea, eb, shoup32_dual(ea, params.q), shoup32_dual(eb, params.q))
    return RlweKeySwitchingKey(_to_eval_mont(params, ct.a), _to_eval_mont(params, ct.b))


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
    (`rlwe.rs:177-186`). On the u32 engine it keeps the ciphertext's dtype
    (int32 residues in, int32 out, as the JAX package keeps u32). The key
    may carry leading batch axes, one key per ciphertext. On the u64 engine
    a CUDA ciphertext goes through K-EXTPROD64."""
    if params.use_u32 and ksk.a_dual is not None:
        out = _key_switch32(params, ksk, ct)
        if ct.a.dtype == torch.int32:
            return out
        return RlweCiphertext(out.a.long(), out.b.long())
    from .rgsw import external_product64, key_rows

    batch = ct.a.shape[:-1]
    ka, kb, idx = key_rows(ksk.a_eval, ksk.b_eval, batch, ct.a.device)
    flat = RlweCiphertext(ct.a.reshape(-1, params.n).contiguous(), ct.b.reshape(-1, params.n).contiguous())
    out = external_product64(params.gadget, params.plan, ka, kb, idx, flat, key_switch=True)
    return RlweCiphertext(out.a.reshape(*batch, params.n), out.b.reshape(*batch, params.n))


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


def sample_extract(params: RlweParams, ct: RlweCiphertext, i: int, b_add: int = 0) -> LweCiphertext:
    """Coefficient i as an N-dimensional LWE ciphertext (`rlwe.rs:193-202`),
    int64, of ct (a, b (..., N): int32 residues or int64), with b_add (a
    keyword the JAX package lacks, 0 <= b_add < q) added to b mod q.

    On a CUDA tensor one launch of K-EXTRACT (`csrc/rlwe_extract.cu`,
    counter `.launches`); on a CPU tensor the plain version."""
    assert 0 <= i < params.n
    if not 0 <= b_add < params.q:
        raise ValueError(f"sample_extract: b_add must lie in [0, q), got {b_add}")
    if ct.a.is_cpu:
        return sample_extract_ref(params, ct, i, b_add)
    name, n = "sample_extract", params.n
    batch = ct.b.shape[:-1]
    a, b = ct.a.reshape(-1, n), ct.b.reshape(-1, n)
    if a.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: expected int32 or int64, got {a.dtype}")
    B = a.shape[0]
    kernels.require(f"{name} ct.a", a, a.dtype, (B, n))
    kernels.require(f"{name} ct.b", b, a.dtype, (B, n))
    out = LweCiphertext(a.new_empty((B, n), dtype=torch.int64), a.new_empty((B,), dtype=torch.int64))
    if B:
        kernels.launch(
            "lft_rlwe_extract", a.data_ptr(), b.data_ptr(), out.a.data_ptr(), out.b.data_ptr(), a.dtype == torch.int64,
            B, n.bit_length() - 1, i, params.q, b_add,
        )  # fmt: skip
        sample_extract.launches += 1
    return LweCiphertext(out.a.reshape(*batch, n), out.b.reshape(batch))


sample_extract.launches = 0


def sample_extract_ref(params: RlweParams, ct: RlweCiphertext, i: int, b_add: int = 0) -> LweCiphertext:
    """Plain version of `sample_extract` (either device): `sample_extract_a`
    and b[i], int64, with `add_mod` of b_add where it is not 0."""
    b = ct.b[..., i].long()
    return LweCiphertext(sample_extract_a(ct.a.long(), i, params.q), add_mod(b, b_add, params.q) if b_add else b)


# -- threshold / multi-party API (`rlwe.rs:219-324`) -------------------------


def share_encrypt(
    params: RlweParams, a: torch.Tensor, sk: np.ndarray, pt: torch.Tensor, rng: np.random.Generator
) -> torch.Tensor:
    """b-share = a*sk + e + pt under the common a (`rlwe.rs:239-249`)."""
    e = _dg_q(params, rng, tuple(pt.shape), pt.device)
    sk_q = _sk_q(params, sk, pt.device)
    return add_mod(add_mod(_polymul(params, a.expand(pt.shape), sk_q), e, params.q), pt, params.q)


def encryption_share_merge(params: RlweParams, a: torch.Tensor, shares: Iterable[torch.Tensor]) -> RlweCiphertext:
    b = None
    for s in shares:
        b = s if b is None else add_mod(b, s, params.q)
    return RlweCiphertext(a, b)


def pk_share_gen(params: RlweParams, a: torch.Tensor, sk: np.ndarray, rng: np.random.Generator) -> torch.Tensor:
    return share_encrypt(params, a, sk, torch.zeros(params.n, dtype=torch.int64, device=a.device), rng)


def pk_share_merge(params: RlweParams, a: torch.Tensor, shares: Iterable[torch.Tensor]) -> RlweCiphertext:
    return encryption_share_merge(params, a, shares)


def share_decrypt(params: RlweParams, sk: np.ndarray, a: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
    e = _dg_q(params, rng, tuple(a.shape), a.device)
    return add_mod(_polymul(params, a, _sk_q(params, sk, a.device)), e, params.q)


def decryption_share_merge(params: RlweParams, b: torch.Tensor, shares: Iterable[torch.Tensor]) -> torch.Tensor:
    acc = None
    for s in shares:
        acc = s if acc is None else add_mod(acc, s, params.q)
    return sub_mod(b, acc, params.q)


def ksk_share_gen(
    params: RlweParams, crs_a: torch.Tensor, sk0: np.ndarray, sk1: np.ndarray, rng: np.random.Generator
) -> torch.Tensor:
    """b-shares (d, N) of enc(-sk1 * B^i) under the common rows a (`rlwe.rs:280-292`)."""
    neg_sk1 = from_i64(torch.as_tensor(-np.asarray(sk1, dtype=np.int64), device=crs_a.device), params.q)
    return share_encrypt(params, crs_a, sk0, power_up_zq(neg_sk1, params.gadget), rng)


def ksk_share_merge(params: RlweParams, crs_a: torch.Tensor, shares: Iterable[torch.Tensor]) -> RlweKeySwitchingKey:
    """The merged key switching key in the u64 engine's residency (the JAX
    package's `ksk_share_merge` makes no duals)."""
    ct = encryption_share_merge(params, crs_a, shares)
    return RlweKeySwitchingKey(_to_eval_mont(params, ct.a), _to_eval_mont(params, ct.b))


def ak_share_gen(
    params: RlweParams, t: int, crs_a: torch.Tensor, sk: np.ndarray, rng: np.random.Generator
) -> torch.Tensor:
    return ksk_share_gen(params, crs_a, sk, automorphism_i64(np.asarray(sk), t), rng)


def ak_share_merge(params: RlweParams, t: int, crs_a: torch.Tensor, shares: Iterable[torch.Tensor]) -> RlweAutoKey:
    return RlweAutoKey(t, ksk_share_merge(params, crs_a, shares))
