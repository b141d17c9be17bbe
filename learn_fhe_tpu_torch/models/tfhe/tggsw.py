"""TGGSW: ring gadget encryption over TGLWE, and the blind-rotation step
(`learn_fhe_tpu/models/tfhe/tggsw.py`).

Layout: R = (k+1)*d rows of TGLWE ciphertexts, a: (..., R, k, N),
b: (..., R, N); rows j*d..(j+1)*d (j < k) carry gadget powers on a[.., j, :],
the last d rows on b (`tggsw.rs:73-89`).

The key lives in the multi-prime CRT NTT domain with Shoup duals
(`TggswEval`). The JAX package keeps one array per prime; the port stacks
the K primes on an axis just before the row axis, so the key of one
blind-rotation step is one contiguous block.

Kernel (`csrc/tfhe_step.cu`), replacing the Pallas step kernel
`bench/pallas_step_experiment.py:202` (`pallas_step`): `cmux_rotate` is one
whole step in one launch, `blind_rotate_steps` all n steps of a blind
rotation from one C call. `cmux_rotate_ref` is the plain version of both.
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


def _step_kernel_args(
    name: str,
    params: TggswParams,
    key: TggswEval,
    acc: TglweCiphertext,
    exps: torch.Tensor,
    mon_v: torch.Tensor,
    mon_d: torch.Tensor,
    stacked: bool,
) -> tuple:
    """Check the operands of the step kernel, for one step or (stacked) for
    all n steps of a rotation, with key and exps carrying a leading step
    axis; return the C entry point's arguments after `exps`: the key, the
    monomial table, the twiddles and the constants. The kernel takes k=1,
    d=1, the u32 decomposition, N <= 2048 and at most 4 CRT primes, and
    this raises on anything else."""
    plan = _crt_plan(params)
    g = params.gadget
    n, kk = params.big_n, plan.k
    if params.k != 1 or params.d != 1 or not decompose_t64_supports_u32(g):
        raise ValueError(f"{name}: the step kernel takes k=1, d=1 and rounding_bits >= 33")
    if n > 1 << kernels.MAX_LOG_N or kk > kernels.MAX_PRIMES:
        raise ValueError(f"{name}: the step kernel takes N <= 2048 and <= 4 primes (N={n}, K={kk})")
    batch = acc.b.shape[0]
    steps = (exps.shape[0],) if stacked else ()
    kernels.require(f"{name} acc.a", acc.a, torch.int64, (batch, 1, n))
    kernels.require(f"{name} acc.b", acc.b, torch.int64, (batch, n))
    kernels.require(f"{name} exps", exps, torch.int64, (*steps, batch))
    for kname, t in zip(("av", "ad"), (key.av, key.ad)):
        kernels.require(f"{name} key.{kname}", t, torch.int32, (*steps, kk, 2, 1, n))
    for kname, t in zip(("bv", "bd"), (key.bv, key.bd)):
        kernels.require(f"{name} key.{kname}", t, torch.int32, (*steps, kk, 2, n))
    kernels.require(f"{name} mon_v", mon_v, torch.int32, (kk, 2 * n, n))
    kernels.require(f"{name} mon_d", mon_d, torch.int32, (kk, 2 * n, n))
    t = crt_tables(plan, acc.a.device)
    return (
        *(x.data_ptr() for x in (*key, mon_v, mon_d, *t)), plan.plans[0].log_n, g.log_b, g.rounding_bits,
        plan.kernel_consts.ctypes.data,
    )  # fmt: skip


def cmux_rotate(
    params: TggswParams,
    key: TggswEval,
    acc: TglweCiphertext,
    exps: torch.Tensor,
    mon_v: torch.Tensor,
    mon_d: torch.Tensor,
) -> TglweCiphertext:
    """One blind-rotation step, in place (see `cmux_rotate_ref`): on the card
    one launch of the step kernel (`lft_tfhe_step`)."""
    if acc.a.device.type == "cpu":
        return cmux_rotate_ref(params, key, acc, exps, mon_v, mon_d)
    args = _step_kernel_args("cmux_rotate", params, key, acc, exps, mon_v, mon_d, stacked=False)
    batch = acc.b.shape[0]
    if batch:
        kernels.launch("lft_tfhe_step", acc.a.data_ptr(), acc.b.data_ptr(), exps.data_ptr(), batch, *args)
        cmux_rotate.launches += 1
    return acc


def blind_rotate_steps(
    params: TggswParams,
    brk: TggswEval,
    acc: TglweCiphertext,
    exps: torch.Tensor,
    mon_v: torch.Tensor,
    mon_d: torch.Tensor,
) -> TglweCiphertext:
    """All n blind-rotation steps, in place: step i is `cmux_rotate` with
    row i of the stacked key brk (n, K, 2, ...) and of exps (n, B).

    On the card the operands are checked once and one C call
    (`lft_tfhe_blind_rotate`) launches the step kernel n times on the
    current stream, so no Python runs between steps. On the CPU it loops
    `cmux_rotate_ref`, its plain version."""
    if acc.a.device.type == "cpu":
        for i in range(exps.shape[0]):
            key_i = TggswEval(brk.av[i], brk.ad[i], brk.bv[i], brk.bd[i])
            cmux_rotate_ref(params, key_i, acc, exps[i], mon_v, mon_d)
        return acc
    args = _step_kernel_args("blind_rotate_steps", params, brk, acc, exps, mon_v, mon_d, stacked=True)
    steps, batch = exps.shape[0], acc.b.shape[0]
    if batch and steps:
        kernels.launch("lft_tfhe_blind_rotate", acc.a.data_ptr(), acc.b.data_ptr(), exps.data_ptr(), steps, batch, *args)
        blind_rotate_steps.launches += steps
    return acc


cmux_rotate.launches = 0
blind_rotate_steps.launches = 0
