"""Batched negacyclic NTT over Z_q[X]/(X^N+1) for odd primes q < 2^63, on
u64 values carried as int64 (`learn_fhe_tpu/ops/ntt.py`).

The merged-twist DIT/DIF transform of the JAX package: the forward
(Cooley-Tukey, layer 0 first) takes normal order to bit-reversed order with
the plan's table psi_br[k] = psi_{2N}^{bitrev(k)}, the inverse
(Gentleman-Sande) takes it back and scales by 1/N. Every twiddle product is
a Shoup product and every operation is exact mod q, so the evaluation-basis
values agree element for element with the JAX package's, and keys move
between the two packages as they are.

Kernels (`csrc/ntt64.cu`, K-NTT64 and K-POLYMUL64, on the row passes of
`csrc/u64_rows.cuh`), each beside its plain radix-2 version:
- `ntt64` / `intt64` replace the XLA fusions of `ntt` (`ntt.py:135`) and
  `intt` (`:189`): the first pass reads device memory, the last writes it;
- `ntt64_mont` is `ntt64` with its output in the Montgomery domain, the
  conversion done in the kernel's last pass: the XLA fusion of
  `to_montgomery(ntt(x))` in the JAX package's jitted `rgsw.to_eval`
  (`models/fhew/rgsw.py:116-131`) and `rlwe._to_eval_mont`
  (`models/fhew/rlwe.py:148-150`), the multi-key path's calls of K-NTT64;
- `negacyclic_mul64` replaces `negacyclic_mul` (`:261`): both forward
  transforms, the pointwise Montgomery product and the inverse in one
  launch (at N=2048 a block per row pair, its rows brought into shared
  memory by bulk copies).
Each wrapper runs the plain version only for CPU tensors; a CUDA tensor goes
to the kernel, or the wrapper raises. Below q < 2^62 the kernels run their
lazy instance (`lazy_butterflies`), above it the eager one, as the C side
chooses; both return the canonical residues.

Past N = 2048 (2^12 .. 2^16: `bench.py --metric ntt`'s ring N = 2^14 among
them) `ntt64`, `intt64` and `negacyclic_mul64` run on K-RNS-NTT with one
limb (`ops/rns.py`, whose one-prime plan holds this plan's tables): the
transforms are one `rns_ntt` / `rns_intt` launch, counted there; the product
is one `rns_ntt` launch for each operand and one `rns_intt_mac` of one term,
whose final scale N^-1 2^64 undoes its REDC. Past 2^13 those instances are
lazy only, so a prime of 2^62 or more raises there. `ntt64_mont` stays at
N <= 2048.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..utils import kernels
from ..utils.interop import u64_to_torch
from ..utils.primes import mod_inverse, two_adic_generator
from .modular import ZqParams, add_mod, as_i64, mul_mod, mul_shoup, shoup_precompute, sub_mod, to_montgomery


def bit_reverse_indices(n: int) -> np.ndarray:
    """Permutation j -> bitrev_{log n}(j)."""
    log_n = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


@dataclass(frozen=True, eq=False)
class NttPlan:
    """Host twiddle tables for one (q, n)."""

    q: int
    n: int
    log_n: int
    zq: ZqParams
    psi_br: np.ndarray  # (n,) u64: psi_{2n}^{bitrev(k)}
    psi_br_shoup: np.ndarray
    psi_inv_br: np.ndarray  # elementwise inverse of psi_br
    psi_inv_br_shoup: np.ndarray
    n_inv: int
    n_inv_shoup: int
    r1_shoup: int  # Shoup dual of 2^64 mod q (zq.r1): K-NTT64's Montgomery output


@lru_cache(maxsize=None)
def ntt_plan(q: int, n: int) -> NttPlan:
    assert n & (n - 1) == 0
    log_n = n.bit_length() - 1
    assert (q - 1) % (2 * n) == 0, f"q={q} is not NTT-friendly for n={n}"
    psi = two_adic_generator(q, log_n + 1)  # order 2n
    pows = [1]
    for _ in range(n - 1):
        pows.append(pows[-1] * psi % q)
    rev = bit_reverse_indices(n)
    psi_br = np.array(pows, dtype=np.uint64)[rev]  # `fft/zq.rs:58-67`
    psi_inv_br = np.array([mod_inverse(p, q) for p in pows], dtype=np.uint64)[rev]
    n_inv = mod_inverse(n % q, q)
    return NttPlan(
        q=q,
        n=n,
        log_n=log_n,
        zq=ZqParams(q),
        psi_br=psi_br,
        psi_br_shoup=shoup_precompute(psi_br, q),
        psi_inv_br=psi_inv_br,
        psi_inv_br_shoup=shoup_precompute(psi_inv_br, q),
        n_inv=n_inv,
        n_inv_shoup=int(shoup_precompute(n_inv, q)),
        r1_shoup=int(shoup_precompute((1 << 64) % q, q)),
    )


class PlanTables(NamedTuple):
    """A plan's twiddle tables as (n,) int64 tensors on one device."""

    psi: torch.Tensor
    psi_s: torch.Tensor
    psi_inv: torch.Tensor
    psi_inv_s: torch.Tensor


@lru_cache(maxsize=None)
def plan_tables(plan: NttPlan, device: torch.device) -> PlanTables:
    return PlanTables(
        *(u64_to_torch(getattr(plan, f), device) for f in ("psi_br", "psi_br_shoup", "psi_inv_br", "psi_inv_br_shoup"))
    )


# ---------------------------------------------------------------------------
# Plain versions: radix-2 layers, written from the JAX semantics.
# ---------------------------------------------------------------------------


def ntt64_ref(x: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Forward negacyclic NTT over the last axis (normal -> bit-reversed)."""
    n, q = plan.n, plan.q
    t = plan_tables(plan, x.device)
    batch = x.shape[:-1]
    out = x
    for layer in range(plan.log_n):
        m = 1 << layer
        x4 = out.reshape(*batch, m, 2, n >> (layer + 1))
        u, v = x4[..., 0, :], x4[..., 1, :]
        tv = mul_shoup(v, t.psi[m : 2 * m, None], t.psi_s[m : 2 * m, None], q)
        out = torch.stack([add_mod(u, tv, q), sub_mod(u, tv, q)], dim=-2).reshape(*batch, n)
    return out


def intt64_ref(x: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Inverse negacyclic NTT over the last axis (bit-reversed -> normal)."""
    n, q = plan.n, plan.q
    t = plan_tables(plan, x.device)
    batch = x.shape[:-1]
    out = x
    for layer in reversed(range(plan.log_n)):
        m = 1 << layer
        x4 = out.reshape(*batch, m, 2, n >> (layer + 1))
        u, v = x4[..., 0, :], x4[..., 1, :]
        d = mul_shoup(sub_mod(u, v, q), t.psi_inv[m : 2 * m, None], t.psi_inv_s[m : 2 * m, None], q)
        out = torch.stack([add_mod(u, v, q), d], dim=-2).reshape(*batch, n)
    return mul_shoup(out, plan.n_inv, as_i64(plan.n_inv_shoup), q)


def ntt64_mont_ref(x: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """The forward NTT into the Montgomery domain: to_montgomery(ntt64_ref(x))."""
    return to_montgomery(ntt64_ref(x, plan), plan.zq)


def pointwise_mul(a: torch.Tensor, b: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Pointwise product in the evaluation basis (Montgomery, plain torch)."""
    return mul_mod(a, b, plan.zq)


def negacyclic_mul64_ref(a: torch.Tensor, b: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Negacyclic product mod q: INTT(NTT(a) * NTT(b))."""
    return intt64_ref(pointwise_mul(ntt64_ref(a, plan), ntt64_ref(b, plan), plan), plan)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name: str, x: torch.Tensor, plan: NttPlan) -> int:
    if not 1 <= plan.log_n <= kernels.MAX_LOG_N:  # K-NTT64's rings; past them `_one_limb`'s
        raise ValueError(f"{name}: the kernel takes 2 <= n <= {1 << kernels.MAX_LOG_N}, got {plan.n}")
    kernels.require(name, x, torch.int64)
    if x.dim() == 0 or x.shape[-1] != plan.n:
        raise ValueError(f"{name}: last axis must be n={plan.n}, got {tuple(x.shape)}")
    return x.numel() // plan.n


@lru_cache(maxsize=None)
def table_pointers(plan: NttPlan, device: int) -> tuple[int, int, int, int]:
    """Device pointers of the plan's tables on CUDA device `device`, which
    `plan_tables`' cache keeps alive."""
    return tuple(t.data_ptr() for t in plan_tables(plan, torch.device("cuda", device)))


def _consts(plan: NttPlan) -> tuple[int, int, int, int]:
    """q, -q^-1 mod 2^64, 1/N and its Shoup dual, as the C entry points take them."""
    return plan.q, plan.zq.neg_q_inv, plan.n_inv, plan.n_inv_shoup


def lazy_butterflies(q: int) -> bool:
    """Whether the u64 kernels run their lazy instance at q, as
    `lft64::lazy_ok` (`csrc/u64.cuh`) chooses it: Harvey's butterflies keep
    forward values below 4q, which must stay below 2^64, so q < 2^62. A
    prime in [2^62, 2^63) takes the eager instance. The cost model of the
    bounds counts the instance's butterflies by it."""
    return q < 1 << 62


def _transform(fn, entry: str, x: torch.Tensor, plan: NttPlan, *consts: int) -> torch.Tensor:
    """Launch K-NTT64 entry point `entry` on every row of x, counted on fn."""
    rows = _check(fn.__name__, x, plan)
    if x.data_ptr() % 16:
        raise ValueError(f"{fn.__name__}: the kernel reads rows in 16-byte loads; x is not 16-byte aligned")
    y = torch.empty_like(x)
    if rows:
        kernels.launch(entry, x.data_ptr(), y.data_ptr(), *table_pointers(plan, x.get_device()), rows, plan.log_n, *_consts(plan), *consts)
        fn.launches += 1
        fn.by_rows[rows] += 1
    return y


def _one_limb(plan: NttPlan):
    """The one-prime RNS plan of K-RNS-NTT past K-NTT64's rings, or None
    where K-NTT64 takes the plan."""
    if plan.log_n <= kernels.MAX_LOG_N:
        return None
    from .rns import rns_plan

    return rns_plan((plan.q,), plan.n)


def ntt64(x: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Forward NTT of every row of x (int64 residues in [0, q))."""
    if x.is_cpu:
        return ntt64_ref(x, plan)
    if (rp := _one_limb(plan)) is not None:
        from .rns import rns_ntt

        return rns_ntt(x.unsqueeze(-2), rp).squeeze(-2)
    return _transform(ntt64, "lft_ntt64_fwd", x, plan)


def ntt64_mont(x: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Forward NTT of every row of x into the Montgomery domain (y 2^64 mod
    q), the evaluation-basis keys' form: one launch."""
    if x.is_cpu:
        return ntt64_mont_ref(x, plan)
    return _transform(ntt64_mont, "lft_ntt64_fwd_mont", x, plan, plan.zq.r1, plan.r1_shoup)


def intt64(x: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Inverse NTT of every row of x (int64 residues in [0, q))."""
    if x.is_cpu:
        return intt64_ref(x, plan)
    if (rp := _one_limb(plan)) is not None:
        from .rns import rns_intt

        return rns_intt(x.unsqueeze(-2), rp).squeeze(-2)
    return _transform(intt64, "lft_ntt64_inv", x, plan)


# The ring at which K-POLYMUL64 brings its rows in by bulk copies
# (`lft64::rows::kBulkLogN`), which need 16-byte aligned rows.
BULK_LOG_N = 11


def negacyclic_mul64(a: torch.Tensor, b: torch.Tensor, plan: NttPlan) -> torch.Tensor:
    """Row-wise negacyclic product mod q of two equal-shape residue tensors."""
    if a.is_cpu:
        return negacyclic_mul64_ref(a, b, plan)
    if (rp := _one_limb(plan)) is not None:
        from .rns import rns_intt_mac, rns_ntt

        kernels.require("negacyclic_mul64", b, torch.int64, a.shape)
        ea, eb = (rns_ntt(t.unsqueeze(-2), rp) for t in (a, b))
        return rns_intt_mac([ea], [eb], rp).squeeze(-2)
    rows = _check("negacyclic_mul64", a, plan)
    kernels.require("negacyclic_mul64", b, torch.int64, a.shape)
    if plan.log_n == BULK_LOG_N and (a.data_ptr() % 16 or b.data_ptr() % 16):
        raise ValueError("negacyclic_mul64: at N=2048 the kernel brings rows in by 16-byte bulk copies; a or b is not 16-byte aligned")
    y = torch.empty_like(a)
    if rows:
        kernels.launch(
            "lft_negacyclic_mul64", a.data_ptr(), b.data_ptr(), y.data_ptr(), *table_pointers(plan, a.get_device()),
            rows, plan.log_n, *_consts(plan), plan.zq.r2,
        )  # fmt: skip
        negacyclic_mul64.launches += 1
        negacyclic_mul64.by_rows[rows] += 1
    return y


@lru_cache(maxsize=None)
def eval_exponents(n: int) -> np.ndarray:
    """Root exponent per forward-NTT output slot: out[j] = a(psi^{e[j]})
    (`learn_fhe_tpu/ops/ntt.py:206`): a host mirror of the forward DIT
    stages run on a(X) = X over a small NTT-friendly prime, its slot values
    matched against the psi power table. The slot -> root map depends on the
    butterfly index structure alone, so it holds for every prime."""
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    log_n = n.bit_length() - 1
    from ..utils.primes import two_adic_primes

    q = next(two_adic_primes(31, log_n + 1))
    psi = two_adic_generator(q, log_n + 1)
    pow_list = []
    acc = 1
    for _ in range(2 * n):
        pow_list.append(acc)
        acc = acc * psi % q
    psi_br = np.array(pow_list[:n], dtype=object)[bit_reverse_indices(n)]
    out = np.zeros(n, dtype=object)
    out[1] = 1  # a(X) = X
    for layer in range(log_n):
        m = 1 << layer
        x = out.reshape(m, 2, n >> (layer + 1))
        u, v = x[:, 0, :], x[:, 1, :]
        tv = (v * psi_br[m : 2 * m, None]) % q
        out = np.stack([(u + tv) % q, (u - tv) % q], axis=1).reshape(n)
    pos_of_value = {v: k for k, v in enumerate(pow_list)}
    e = np.array([pos_of_value[int(v)] for v in out], dtype=np.int64)
    assert (e % 2 == 1).all() and len(set(e.tolist())) == n
    return e


@lru_cache(maxsize=None)
def eval_automorphism_perm(n: int, t: int) -> np.ndarray:
    """Permutation sigma with NTT(automorphism_t(x)) == NTT(x)[sigma]
    (`learn_fhe_tpu/ops/ntt.py:245`): slot j of the transformed automorphism
    holds a(root^t), the slot whose exponent is e[j] t mod 2n."""
    assert t % 2 == 1
    e = eval_exponents(n)
    pos = {int(exp): j for j, exp in enumerate(e)}
    return np.array([pos[int(exp) * t % (2 * n)] for exp in e], dtype=np.int64)


# launches, and launches by row count (the shapes a path launches them at)
for _fn in (ntt64, ntt64_mont, intt64, negacyclic_mul64):
    _fn.launches, _fn.by_rows = 0, Counter()

# The JAX package's names.
ntt, intt, negacyclic_mul = ntt64, intt64, negacyclic_mul64
