"""CKKS homomorphic encoding-matrix evaluation: CoeffToSlot / SlotToCoeff,
the linear-transform half of bootstrapping (`learn_fhe_tpu/models/ckks/
bootstrapping.py`; reference `scheme/ckks/src/bootstrapping.rs`).

The sfft factor matrices are pre-multiplied in chunks of r (`:23-31`), the
rotation keys harvested from the BSGS plans (`:56-71`), and each chunk is
applied by `_bsgs_apply`: the ciphertext's mask hoisted once, each baby
step's rotation a read through an evaluation-slot permutation inside
K-RNS-MAC (no permuted copy), each giant group's diagonal products summed
inside the inverse transforms that consume them (`rns_intt_mac`), then one
rescale and the giant-step rotation. Every output is the JAX package's, bit
for bit: products of canonical residues summed mod q are the same in any
order and grouping.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache

import numpy as np
import torch

from ...ops.rns import rescale_k, rns_intt_mac, rns_ntt, rns_plan
from ...utils.dd import DDC
from ...utils.interop import resolve_device
from ...utils.matrix import bsgs_plan, mat_product
from . import ckks as C
from .ckks import CkksCiphertext, CkksParams, CkksRotKey
from .sfft import sfft_fmats, sifft_fmats


@dataclass(frozen=True)
class BootstrapParams:
    params: CkksParams
    r: int  # factors pre-multiplied in chunks of r (`bootstrapping.rs:23-31`)

    @cached_property
    def sfft_mats(self) -> list[dict[int, DDC]]:
        return _chunked(sfft_fmats(self.params.l), self.r, self.params.l)

    @cached_property
    def sifft_mats(self) -> list[dict[int, DDC]]:
        return _chunked(sifft_fmats(self.params.l), self.r, self.params.l)


def _chunked(mats, r, n):
    return [mat_product(mats[i : i + r], n) for i in range(0, len(mats), r)]


@dataclass
class BootstrapKey:
    bp: BootstrapParams
    rtk: dict[int, CkksRotKey]
    # Evaluation-basis encoded diagonals (over ct.qs + ps, on the keys'
    # device), keyed as the JAX package keys them: ((tag, chunk), diagonal
    # index, giant step, level basis). The host encode of a diagonal (a
    # double-double sifft) runs once per key.
    pt_cache: dict = None

    def __post_init__(self):
        if self.pt_cache is None:
            self.pt_cache = {}


def rotation_indices(bp: BootstrapParams) -> list[int]:
    """The BSGS plans' rotation indices, nonzero and sorted
    (`bootstrapping.rs:56-71`)."""
    needed: set[int] = set()
    for mat in [*bp.sfft_mats, *bp.sifft_mats]:
        plan = bsgs_plan(list(mat.keys()))
        needed.update(plan.keys())
        for js in plan.values():
            needed.update(js)
    needed.discard(0)
    return sorted(needed)


def key_gen(bp: BootstrapParams, sk: np.ndarray, rng: np.random.Generator, device=None) -> BootstrapKey:
    """Rotation keys for exactly the harvested indices, in one batch (the
    JAX package's draws), on `device` (see `resolve_device`)."""
    rtk = C.rtk_gen_many(bp.params, sk, rotation_indices(bp), rng, resolve_device(device))
    return BootstrapKey(bp, rtk)


def slot_to_coeff(bk: BootstrapKey, ct: CkksCiphertext) -> CkksCiphertext:
    return _mul_mats(bk, bk.bp.sfft_mats, ct, "sfft")


def coeff_to_slot(bk: BootstrapKey, ct: CkksCiphertext) -> CkksCiphertext:
    return _mul_mats(bk, bk.bp.sifft_mats, ct, "sifft")


def _mul_mats(bk: BootstrapKey, mats, ct: CkksCiphertext, tag: str) -> CkksCiphertext:
    for chunk, mat in reversed(list(enumerate(mats))):
        ct = _mul_mat(bk, mat, ct, (tag, chunk))
    return ct


def _pt_eval(qs: tuple, pt: torch.Tensor) -> torch.Tensor:
    return rns_ntt(pt, rns_plan(qs, pt.shape[-1]))


def _bsgs_apply(
    params: CkksParams,
    items: tuple,  # ((i, (j, ...)), ...): the BSGS plan
    ct: CkksCiphertext,
    baby_rtks: tuple,  # CkksRotKey per nonzero baby j (plan order)
    giant_rtks: tuple,  # CkksRotKey per nonzero giant i (items order)
    pts: tuple,  # per item: tuple of (L+P, N) evaluation-basis diagonals
) -> CkksCiphertext:
    """One BSGS sparse-diagonal matrix application (the JAX package's
    `_bsgs_apply`, `bootstrapping.py:103-182`): the mask base-extended and
    transformed once (hoisting); per baby step j, W[j] = the key's dot with
    the hoisted mask read through sigma_j, b's and a's sums in one
    K-RNS-MAC launch, kept in the evaluation basis; per giant group, the
    diagonals' products with the W[j] (P-carrying) and with b read through
    sigma_j (q basis) summed inside their inverse transforms, the P part
    rescaled away; then a rescale and the giant-step rotation."""
    qs = ct.qs
    ps = params.ps
    qps = qs + ps
    n = ct.a.shape[-1]
    plan_qp, plan_q = rns_plan(qps, n), rns_plan(qs, n)
    L = len(qs)
    idx = [params.qps.index(q) for q in qps]
    dev = ct.a.device

    ae = C._ks_hoist(params, ct.a, qs)  # (..., D, L+P, N)
    # NTT(ct.a) over the q basis for the key-switch-free (j = 0) diagonal
    # products: with one digit it is the first L hoisted rows (made
    # contiguous once); with dnum digits each row mixes one digit only, so
    # transform a directly
    ae_q = ae[..., 0, :L, :].contiguous() if ae.shape[-3] == 1 else rns_ntt(ct.a, plan_q)
    be = rns_ntt(ct.b, plan_q)

    W, perm = {}, {}  # j -> (2, ..., L+P, N): ksk_b . ae[sigma_j], ksk_a . ae[sigma_j]
    for rtk in baby_rtks:
        perm[rtk.j] = C._eval_perm(n, params.pow5(rtk.j), dev)
        ksk_b = C._ksk_digits(params, rtk.ksk.b, L, idx)
        ksk_a = C._ksk_digits(params, rtk.ksk.a, L, idx)
        W[rtk.j] = C._ks_dot(ksk_b, ae, plan_qp, perm[rtk.j], ksk_a)

    giants = {rtk.j: rtk for rtk in giant_rtks}
    out = None
    for (i, ijs), pt_group in zip(items, pts):
        # q basis: b's sum over every j (be through sigma_j), a's over j = 0
        b_i = rns_intt_mac([be] * len(ijs), [pt[:L] for pt in pt_group], plan_q,
                           perms=[perm.get(j) for j in ijs])  # fmt: skip
        a_q = None
        if 0 in ijs:
            a_q = rns_intt_mac([ae_q], [pt_group[ijs.index(0)][:L]], plan_q)
        babies = [(W[j], pt) for j, pt in zip(ijs, pt_group) if j != 0]
        if babies:  # the P-carrying sums of b and a, one launch, rescaled by P with the q-basis sums added in its launch
            kba = rns_intt_mac([w for w, _ in babies], [pt for _, pt in babies], plan_qp)
            b_i, a_i = rescale_k(kba, qps, len(ps), add=(b_i, a_q))
        else:
            a_i = torch.zeros_like(b_i) if a_q is None else a_q
        part = C.rescale_ct(CkksCiphertext(b_i, a_i, qs))
        moved = part if i == 0 else C.rotate(params, giants[i], part)
        out = moved if out is None else C.add(out, moved)
    return out


@lru_cache(maxsize=None)
def _plan(indices: tuple[int, ...]) -> tuple[tuple, tuple, tuple]:
    """A matrix's BSGS plan as `_bsgs_apply` takes it, its baby and its giant
    steps, made once per matrix: the search over every split (`bsgs_plan`)
    costs tens of milliseconds of host time a chunk at N=2^13."""
    plan = bsgs_plan(list(indices))
    items = tuple(sorted((i, tuple(sorted(jss))) for i, jss in plan.items()))
    babies = tuple(sorted({j for _, jss in items for j in jss if j != 0}))
    giants = tuple(sorted({i for i, _ in items if i != 0}))
    return items, babies, giants


def _mul_mat(bk: BootstrapKey, mat: dict[int, DDC], ct: CkksCiphertext, mat_key: tuple) -> CkksCiphertext:
    """BSGS sparse-diagonal apply (`bootstrapping.rs:90-108`) through
    `_bsgs_apply`; the diagonals encoded over the full QP basis and cached in
    the evaluation basis under stable keys."""
    params = bk.bp.params
    items, babies, giants = _plan(tuple(mat.keys()))
    qps = ct.qs + params.ps
    pts = []
    for i, ijs in items:
        group = []
        for j in ijs:
            key = (mat_key, (i + j) % params.l, i, ct.qs)
            pt = bk.pt_cache.get(key)
            if pt is None:
                diag = mat[(i + j) % params.l].roll(i)  # rot_iter(-i)
                # encoded at the scale of the prime this chunk's rescale
                # drops, so the ciphertext's scale is invariant through the
                # transform (the JAX package's `_mul_mat`)
                pt = _pt_eval(qps, C.encode(params, diag, qps, scale_int=ct.qs[-1], device=ct.b.device))
                bk.pt_cache[key] = pt
            group.append(pt)
        pts.append(tuple(group))
    return _bsgs_apply(
        params,
        items,
        ct,
        tuple(bk.rtk[j] for j in babies),
        tuple(bk.rtk[i % params.l] for i in giants),
        tuple(pts),
    )
