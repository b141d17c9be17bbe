"""RGSW gadget encryptions and the external and internal products
(`learn_fhe_tpu/models/fhew/rgsw.py`).

An RGSW ciphertext is 2d RLWE rows on a leading axis, (a: (..., 2d, N),
b: (..., 2d, N)) in the coefficient basis: rows 0..d carry the gadget powers
in a, rows d..2d in b (`rgsw.rs:84-105`). For the products the key lives in
the evaluation basis (`RgswEval`): int32 with Shoup duals on the u32 engine,
int64 in the Montgomery domain on the u64 engine (duals None), the residency
the JAX package keeps. An external product is 2d forward NTTs of the
ciphertext's digit rows, a pointwise contraction over the rows and two
inverse NTTs; on the u64 engine a CUDA ciphertext goes through K-EXTPROD64
(`external_product64`, `csrc/fhew_u64.cu`), which also runs the u64 key
switch and every row of an internal product.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops.gadget import Gadget, decompose_zq, decompose_zq32, power_up_zq
from ...ops.modular import add_mod, mont_mul, sub_mod, sum_mod, to_montgomery
from ...ops.modular32 import mul_shoup32, shoup32_dual, sum_mod32
from ...ops.ntt import NttPlan, intt64_ref, ntt64, ntt64_ref, table_pointers
from ...ops.ntt32 import intt32, ntt32
from ...utils import kernels
from .params import RgswParams
from .rlwe import RlweCiphertext, decrypt as rlwe_decrypt, pk_encrypt, sk_encrypt


class RgswCiphertext(NamedTuple):
    a: torch.Tensor  # (..., 2d, N) int64
    b: torch.Tensor


class RgswEval(NamedTuple):
    """Evaluation-basis rows: int32 with Shoup duals (u32 engine), or int64
    in the Montgomery domain with the duals None (u64 engine)."""

    a: torch.Tensor  # (..., 2d, N)
    b: torch.Tensor
    a_dual: torch.Tensor | None = None
    b_dual: torch.Tensor | None = None


def add(params: RgswParams, ct0: RgswCiphertext, ct1: RgswCiphertext) -> RgswCiphertext:
    return RgswCiphertext(add_mod(ct0.a, ct1.a, params.q), add_mod(ct0.b, ct1.b, params.q))


def sub(params: RgswParams, ct0: RgswCiphertext, ct1: RgswCiphertext) -> RgswCiphertext:
    return RgswCiphertext(sub_mod(ct0.a, ct1.a, params.q), sub_mod(ct0.b, ct1.b, params.q))


def encode(params: RgswParams, m: torch.Tensor) -> torch.Tensor:
    """Raw embed of Z_p values into Z_q, no delta scaling (`rgsw.rs:54-59`)."""
    return m.long() % params.q


def decode(params: RgswParams, pt: torch.Tensor) -> torch.Tensor:
    return pt % params.p


def _add_powers(params: RgswParams, zeros: RlweCiphertext, pt: torch.Tensor) -> RgswCiphertext:
    """2d encryptions of zero plus the gadget powers of pt (..., N) in the a
    part of rows 0..d and the b part of rows d..2d."""
    d = params.gadget.d
    powers = power_up_zq(pt, params.gadget).movedim(0, -2)  # (..., d, N)
    a, b = zeros.a, zeros.b
    a[..., :d, :] = add_mod(a[..., :d, :], powers, params.q)
    b[..., d:, :] = add_mod(b[..., d:, :], powers, params.q)
    return RgswCiphertext(a, b)


def _zeros(params: RgswParams, pt: torch.Tensor) -> torch.Tensor:
    return torch.zeros((*pt.shape[:-1], 2 * params.gadget.d, params.n), dtype=torch.int64, device=pt.device)


def sk_encrypt_rgsw(params: RgswParams, sk: np.ndarray, pt: torch.Tensor, rng: np.random.Generator) -> RgswCiphertext:
    return _add_powers(params, sk_encrypt(params.rlwe, sk, _zeros(params, pt), rng), pt)


def pk_encrypt_rgsw(params: RgswParams, pk: RlweCiphertext, pt: torch.Tensor, rng: np.random.Generator) -> RgswCiphertext:
    return _add_powers(params, pk_encrypt(params.rlwe, pk, _zeros(params, pt), rng), pt)


def decrypt_rgsw(params: RgswParams, sk: np.ndarray, ct: RgswCiphertext) -> torch.Tensor:
    """Decrypt the last row, then the rounding shift by the top gadget base
    (`rgsw.rs:107-114`)."""
    pt = rlwe_decrypt(params.rlwe, sk, RlweCiphertext(ct.a[..., -1, :], ct.b[..., -1, :]))
    bits = params.gadget.log_bases[-1]
    return add_mod(pt, ((1 << bits) >> 1) % params.q, params.q) >> bits


def to_eval(params: RgswParams, ct: RgswCiphertext) -> RgswEval:
    """The forward NTT of every row (K-NTT, or K-NTT64), with the Shoup
    duals on the u32 engine and into the Montgomery domain on the u64."""
    if params.use_u32:
        ea = ntt32(ct.a.to(torch.int32).contiguous(), params.plan32)
        eb = ntt32(ct.b.to(torch.int32).contiguous(), params.plan32)
        return RgswEval(ea, eb, shoup32_dual(ea, params.q), shoup32_dual(eb, params.q))
    zq = params.plan.zq
    return RgswEval(
        to_montgomery(ntt64(ct.a.contiguous(), params.plan), zq), to_montgomery(ntt64(ct.b.contiguous(), params.plan), zq)
    )


def external_product(params: RgswParams, key: RgswEval, ct: RlweCiphertext) -> RlweCiphertext:
    """RGSW x RLWE -> RLWE (`rgsw.rs:116-128`). The u32 engine keeps the
    ciphertext's dtype (int32 residues or int64 values); the u64 engine runs
    K-EXTPROD64 on CUDA tensors. The key may carry leading batch axes, one
    key per ciphertext."""
    if params.use_u32 and key.a_dual is not None:
        out = _external_product32(params, key, ct)
        if ct.a.dtype == torch.int32:
            return out
        return RlweCiphertext(out.a.long(), out.b.long())
    batch = ct.a.shape[:-1]
    ka, kb, idx = key_rows(key.a, key.b, batch, ct.a.device)
    flat = RlweCiphertext(ct.a.reshape(-1, params.n).contiguous(), ct.b.reshape(-1, params.n).contiguous())
    out = external_product64(params.gadget, params.plan, ka, kb, idx, flat, key_switch=False)
    return RlweCiphertext(out.a.reshape(*batch, params.n), out.b.reshape(*batch, params.n))


def _external_product32(params: RgswParams, key: RgswEval, ct: RlweCiphertext) -> RlweCiphertext:
    q = params.q
    la = decompose_zq32(ct.a, params.gadget)  # (d, ..., N)
    lb = decompose_zq32(ct.b, params.gadget)
    limbs = torch.cat([la, lb], dim=0).movedim(0, -2).contiguous()  # (..., 2d, N)
    limbs_eval = ntt32(limbs, params.plan32)
    a_eval = sum_mod32(mul_shoup32(limbs_eval, key.a, key.a_dual, q), q, axis=-2)
    b_eval = sum_mod32(mul_shoup32(limbs_eval, key.b, key.b_dual, q), q, axis=-2)
    return RlweCiphertext(intt32(a_eval.to(torch.int32), params.plan32), intt32(b_eval.to(torch.int32), params.plan32))


def internal_product(params: RgswParams, key: RgswEval, ct: RgswCiphertext) -> RgswCiphertext:
    """RGSW x RGSW -> RGSW, used to merge multi-key brk shares
    (`rgsw.rs:130-150`): every row of ct through an external product with
    key. key (..., 2d, N) and ct (..., 2d, N) share their leading axes (one
    key per RGSW ciphertext)."""
    if params.use_u32 and key.a_dual is not None:
        rows_key = RgswEval(*(t[..., None, :, :] for t in key))
        out = _external_product32(params, rows_key, RlweCiphertext(ct.a, ct.b))
        return RgswCiphertext(out.a.long(), out.b.long())
    keys = key.a.shape[:-2]
    ka = key.a.reshape(-1, *key.a.shape[-2:]).contiguous()
    kb = key.b.reshape(-1, *key.b.shape[-2:]).contiguous()
    rows = ct.a.shape[-2]
    idx = torch.arange(ka.shape[0], dtype=torch.int32, device=ct.a.device).repeat_interleave(rows)
    flat = RlweCiphertext(ct.a.reshape(-1, params.n).contiguous(), ct.b.reshape(-1, params.n).contiguous())
    out = external_product64(params.gadget, params.plan, ka, kb, idx, flat, key_switch=False)
    shape = (*keys, rows, params.n)
    return RgswCiphertext(out.a.reshape(shape), out.b.reshape(shape))


def key_rows(ka: torch.Tensor, kb: torch.Tensor, batch: tuple, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A key (R, N), or one per ciphertext (*batch, R, N), as K-EXTPROD64's
    (K, R, N) rows and the (M,) key index of each of the M ciphertexts."""
    m = int(np.prod(batch, dtype=np.int64))
    if ka.dim() == 2:
        return ka[None].contiguous(), kb[None].contiguous(), torch.zeros(m, dtype=torch.int32, device=device)
    if tuple(ka.shape[:-2]) != tuple(batch):
        raise ValueError(f"key batch {tuple(ka.shape[:-2])} does not match the ciphertexts' {tuple(batch)}")
    rows = ka.shape[-2:]
    idx = torch.arange(m, dtype=torch.int32, device=device)
    return ka.reshape(m, *rows).contiguous(), kb.reshape(m, *rows).contiguous(), idx


# -- K-EXTPROD64 ----------------------------------------------------------------


def external_product64_ref(
    gadget: Gadget,
    plan: NttPlan,
    key_a: torch.Tensor,
    key_b: torch.Tensor,
    key_idx: torch.Tensor,
    ct: RlweCiphertext,
    key_switch: bool,
) -> RlweCiphertext:
    """Plain version of `external_product64`: for each ciphertext i of ct
    (M, N), the external product (key_switch False: the digits of a, then
    of b, 2d rows) or the key switch (True: the digits of a, d rows; b +=
    ct.b) with key rows key_a[key_idx[i]], key_b[key_idx[i]] (evaluation
    basis, Montgomery domain): the JAX package's u64 branch, with its
    Montgomery product per row and modular sum."""
    q, zq = plan.q, plan.zq
    limbs = decompose_zq(ct.a, gadget)  # (d, M, N)
    if not key_switch:
        limbs = torch.cat([limbs, decompose_zq(ct.b, gadget)])  # (2d, M, N)
    limbs_eval = ntt64_ref(limbs, plan)
    i = key_idx.long()
    a = intt64_ref(sum_mod(mont_mul(key_a[i].movedim(-2, 0), limbs_eval, zq), q, axis=0), plan)
    b = intt64_ref(sum_mod(mont_mul(key_b[i].movedim(-2, 0), limbs_eval, zq), q, axis=0), plan)
    return RlweCiphertext(a, add_mod(b, ct.b, q) if key_switch else b)


def external_product64(
    gadget: Gadget,
    plan: NttPlan,
    key_a: torch.Tensor,
    key_b: torch.Tensor,
    key_idx: torch.Tensor,
    ct: RlweCiphertext,
    key_switch: bool,
) -> RlweCiphertext:
    """K-EXTPROD64: the u64 external product (or key switch) of M RLWE
    ciphertexts ct (M, N), ciphertext i against key rows key_idx[i] of
    key_a, key_b (K, R, N) with R = 2d (d for a key switch), one 512-thread
    block per ciphertext, one launch. On CPU tensors, the plain version. A
    key index outside the key leaves that output as its input and ORs 1 into
    the kernel error word (`kernels.error_word`); the callers build the
    indices in range."""
    if ct.a.is_cpu:
        return external_product64_ref(gadget, plan, key_a, key_b, key_idx, ct, key_switch)
    name, n = "external_product64", plan.n
    m = ct.a.shape[0]
    rows = gadget.d if key_switch else 2 * gadget.d
    if not 1 <= plan.log_n <= kernels.MAX_LOG_N:
        raise ValueError(f"{name}: the kernel takes 2 <= N <= {1 << kernels.MAX_LOG_N}, got {n}")
    if rows * (plan.q - 1) ** 2 >= plan.q << 64 or gadget.log_b * gadget.d > 64:
        raise ValueError(f"{name}: {rows} row products below q={plan.q} overflow one REDC, or the digits span 64 bits")
    kernels.require(f"{name} ct.a", ct.a, torch.int64, (m, n))
    kernels.require(f"{name} ct.b", ct.b, torch.int64, (m, n))
    kernels.require(f"{name} key_idx", key_idx, torch.int32, (m,))
    kernels.require(f"{name} key_a", key_a, torch.int64, (key_a.shape[0], rows, n))
    kernels.require(f"{name} key_b", key_b, torch.int64, key_a.shape)
    out = RlweCiphertext(torch.empty_like(ct.a), torch.empty_like(ct.b))
    if m:
        kernels.launch(
            "lft_external_product64", ct.a.data_ptr(), ct.b.data_ptr(), out.a.data_ptr(), out.b.data_ptr(),
            key_idx.data_ptr(), m, key_a.data_ptr(), key_b.data_ptr(), key_a.shape[0], rows, int(key_switch),
            *table_pointers(plan, ct.a.get_device()), plan.log_n, plan.q, plan.zq.neg_q_inv, plan.n_inv,
            plan.n_inv_shoup, *gadget_args(gadget), kernels.error_word(ct.a.device).data_ptr(),
        )  # fmt: skip
        external_product64.launches += 1
    return out


external_product64.launches = 0


def gadget_args(g: Gadget) -> tuple[int, int, int, int]:
    """A Zq gadget as the kernels take it: log_b, d, rounding bits, 2^(bits-1) mod q."""
    return g.log_b, g.d, g.rounding_bits, ((1 << g.rounding_bits) >> 1) % g.q
