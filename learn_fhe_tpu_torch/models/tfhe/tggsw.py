"""TGGSW: ring gadget encryption over TGLWE, and the blind-rotation step
(`learn_fhe_tpu/models/tfhe/tggsw.py`).

Layout: R = (k+1)*d rows of TGLWE ciphertexts, a: (..., R, k, N),
b: (..., R, N); rows j*d..(j+1)*d (j < k) carry gadget powers on a[.., j, :],
the last d rows on b (`tggsw.rs:73-89`).

The key lives in the multi-prime CRT NTT domain with Shoup duals
(`TggswEval`). The JAX package keeps one array per prime; the port stacks
the K primes on an axis just before the row axis, so the key of one
blind-rotation step is one contiguous block.

Kernel (`csrc/tfhe_step.cu`): `cmux_rotate` is the whole step in one launch,
replacing the Pallas step kernel `bench/pallas_step_experiment.py:202`
(`pallas_step`). `cmux_rotate_ref` is its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...ops.gadget import (
    decompose_t64,
    decompose_t64_supports_u32,
    decompose_t64_u32,
    power_up_t64,
    shr_u64,
)
from ...ops.modular32 import mul_mod32, shoup32_dual, small_u32_to_mod32, sub_mod32
from ...ops.ntt32 import intt32_ref, ntt32_ref
from ...ops.torus_crt import (
    TorusCrtPlan,
    crt_tables,
    garner_to_u64_ref,
    required_bound_bits,
    torus_crt_plan,
    torus_to_eval,
)
from ...utils import kernels
from .params import TggswParams
from .tglwe import TglweCiphertext, sk_encrypt as tglwe_sk_encrypt


def _crt_plan(params: TggswParams) -> TorusCrtPlan:
    rows = (params.k + 1) * params.d
    return torus_crt_plan(
        params.big_n, required_bound_bits(params.big_n, params.gadget.log_b, rows)
    )


class TggswCiphertext(NamedTuple):
    a: torch.Tensor  # (..., R, k, N) int64
    b: torch.Tensor  # (..., R, N)


class TggswEval(NamedTuple):
    """CRT-NTT residues of the rows with their Shoup duals, int32."""

    av: torch.Tensor  # (..., K, R, k, N) mod q_i
    ad: torch.Tensor  # Shoup duals of av
    bv: torch.Tensor  # (..., K, R, N)
    bd: torch.Tensor


def sk_encrypt(
    params: TggswParams, sk: np.ndarray, pt: torch.Tensor, rng: np.random.Generator
) -> TggswCiphertext:
    """pt: (..., N) torus poly; R zero-encryptions plus gadget powers
    (`tggsw.rs:73-89`)."""
    k, d, n = params.k, params.d, params.big_n
    powers = power_up_t64(pt, params.gadget).movedim(0, -2)  # (..., d, N)
    shape = (*powers.shape[:-2], (k + 1) * d, n)
    zeros = tglwe_sk_encrypt(
        params.tglwe, sk, torch.zeros(shape, dtype=torch.int64, device=pt.device), rng
    )
    a, b = zeros.a, zeros.b
    for j in range(k):
        a[..., j * d : (j + 1) * d, j, :] += powers
    b[..., k * d :, :] += powers
    return TggswCiphertext(a, b)


def to_eval(params: TggswParams, ct: TggswCiphertext) -> TggswEval:
    """Key-side transform: per-prime NTT residues (the forward NTT kernel)
    with Shoup duals, the prime axis moved next to the row axis."""
    plan = _crt_plan(params)
    q = torch.tensor(plan.primes, device=ct.a.device)

    def residues_and_duals(x: torch.Tensor, axis: int) -> tuple[torch.Tensor, torch.Tensor]:
        ev = torus_to_eval(x, plan)  # (K, ...)
        dual = shoup32_dual(ev, q.reshape(-1, *[1] * (ev.dim() - 1)))
        return ev.movedim(0, axis).contiguous(), dual.movedim(0, axis).contiguous()

    av, ad = residues_and_duals(ct.a, -4)
    bv, bd = residues_and_duals(ct.b, -3)
    return TggswEval(av, ad, bv, bd)


def _decompose_rows(params: TggswParams, ct: TglweCiphertext) -> torch.Tensor:
    """Stacked digits of (a_0..a_{k-1}, b), component-major: (..., R, N);
    int32 on the u32 path, else int64."""
    ab = torch.cat([ct.a, ct.b[..., None, :]], dim=-2)  # (..., k+1, N)
    if decompose_t64_supports_u32(params.gadget):
        limbs = decompose_t64_u32(shr_u64(ab, 32), params.gadget)  # (d, ..., k+1, N)
    else:
        limbs = decompose_t64(ab, params.gadget)
    limbs = limbs.movedim(0, -2)  # (..., k+1, d, N)
    return limbs.reshape(*limbs.shape[:-3], -1, params.big_n)


def cmux_rotate_ref(
    params: TggswParams,
    key: TggswEval,
    acc: TglweCiphertext,
    exps: torch.Tensor,
    mon_v: torch.Tensor,
    mon_d: torch.Tensor,
) -> TglweCiphertext:
    """Plain blind-rotation step, in place: acc += (X^s - 1) (*) ExtProd(key, acc)
    with s = exps mod 2N per ciphertext.

    key: one step's TggswEval (av (K, R, k, N), ...); acc: a (B, k, N),
    b (B, N); exps (B,); mon_v/mon_d: the (K, 2N, N) monomial table, of which
    row s is the NTT image of X^s (the duals are only the kernel's concern).
    Same algebra as the JAX `cmux_rotate`, which receives the gathered rows."""
    del mon_d
    plan = _crt_plan(params)
    s = exps % (2 * params.big_n)
    limbs = _decompose_rows(params, acc)  # (B, R, N) centered digits
    a_res, b_res = [], []
    for i, (q, p) in enumerate(zip(plan.primes, plan.plans)):
        le = ntt32_ref(small_u32_to_mod32(limbs, q).int(), p).long()
        e_a = mul_mod32(le[..., :, None, :], key.av[i].long(), q).sum(-3) % q  # (B, k, N)
        e_b = mul_mod32(le, key.bv[i].long(), q).sum(-2) % q  # (B, N)
        mv = mon_v[i][s].long()  # (B, N)
        a_res.append(intt32_ref(sub_mod32(mul_mod32(e_a, mv[:, None, :], q), e_a, q).int(), p))
        b_res.append(intt32_ref(sub_mod32(mul_mod32(e_b, mv, q), e_b, q).int(), p))
    acc.a.add_(garner_to_u64_ref(torch.stack(a_res), plan))
    acc.b.add_(garner_to_u64_ref(torch.stack(b_res), plan))
    return acc


def cmux_rotate(
    params: TggswParams,
    key: TggswEval,
    acc: TglweCiphertext,
    exps: torch.Tensor,
    mon_v: torch.Tensor,
    mon_d: torch.Tensor,
) -> TglweCiphertext:
    """One blind-rotation step, in place (see `cmux_rotate_ref`).

    On the card it is one launch of the step kernel, one block per
    ciphertext; the kernel takes k=1, d=1, the u32 decomposition, N <= 2048
    and at most 4 CRT primes, and raises on anything else."""
    if acc.a.device.type == "cpu":
        return cmux_rotate_ref(params, key, acc, exps, mon_v, mon_d)
    plan = _crt_plan(params)
    g = params.gadget
    n, kk = params.big_n, plan.k
    if params.k != 1 or params.d != 1 or not decompose_t64_supports_u32(g):
        raise ValueError("cmux_rotate: the step kernel takes k=1, d=1 and rounding_bits >= 33")
    if n > 1 << kernels.MAX_LOG_N or kk > kernels.MAX_PRIMES:
        raise ValueError(f"cmux_rotate: the step kernel takes N <= 2048 and <= 4 primes (N={n}, K={kk})")
    batch = acc.b.shape[0]
    kernels.require("cmux_rotate acc.a", acc.a, torch.int64, (batch, 1, n))
    kernels.require("cmux_rotate acc.b", acc.b, torch.int64, (batch, n))
    kernels.require("cmux_rotate exps", exps, torch.int64, (batch,))
    for name, t in zip(("av", "ad"), (key.av, key.ad)):
        kernels.require(f"cmux_rotate key.{name}", t, torch.int32, (kk, 2, 1, n))
    for name, t in zip(("bv", "bd"), (key.bv, key.bd)):
        kernels.require(f"cmux_rotate key.{name}", t, torch.int32, (kk, 2, n))
    kernels.require("cmux_rotate mon_v", mon_v, torch.int32, (kk, 2 * n, n))
    kernels.require("cmux_rotate mon_d", mon_d, torch.int32, (kk, 2 * n, n))
    t = crt_tables(plan, acc.a.device)
    if batch:
        kernels.launch(
            "lft_tfhe_step", acc.a, acc.b, exps, batch, key.av, key.ad, key.bv, key.bd,
            mon_v, mon_d, t.psi, t.psi_s, t.psi_inv, t.psi_inv_s, plan.plans[0].log_n,
            g.log_b, g.rounding_bits, plan.kernel_consts,
        )  # fmt: skip
        cmux_rotate.launches += 1
    return acc


cmux_rotate.launches = 0
