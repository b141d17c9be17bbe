"""Exact negacyclic torus (Z/2^64) polynomial products via multi-prime CRT NTTs.

Counterpart of `learn_fhe_tpu/ops/torus_crt.py`: the same 31-bit primes, the
same Garner tables and the same monomial evaluation table. A row-contracted
digit x torus product is recovered exactly mod 2^64 whenever its coefficients
are bounded by 2^(bound_bits-1) < Q/2, Q the product of the plan's primes.

Kernel (`csrc/torus_crt.cu`, device code in `csrc/torus_crt.cuh`):
`garner_to_u64` is the Garner mixed-radix walk, the recombination by prefix
products mod 2^64 and the centered lift, one thread per coefficient with
native u64 arithmetic in place of the JAX package's u32 limb planes, one
instance per prime count up to 5. The same device function is the tail of
the blind-rotation step kernel, which takes at most 4 primes.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import cached_property, lru_cache

import numpy as np
import torch

from ..utils import kernels
from ..utils.primes import mod_inverse, two_adic_generator, two_adic_primes
from .gadget import as_i64
from .modular32 import i64_to_mod32, mul_mod32, shoup32, small_u32_to_mod32, sub_mod32
from .ntt import bit_reverse_indices
from .ntt32 import Ntt32Plan, PlanTables, negacyclic_mul32, ntt32, ntt32_plan, pointwise_mul32, stack_tables

_PRIME_BITS = 31
_MAX_LOG_N = 14


def required_bound_bits(n: int, log_b: int, rows: int) -> int:
    """Bits of the worst-case |coefficient| of a row-contracted digit*torus
    negacyclic product: rows * n * 2^(log_b-1) * 2^63."""
    return 1 + (rows - 1).bit_length() + (n - 1).bit_length() + (log_b - 1) + 63


@dataclass(frozen=True, eq=False)
class TorusCrtPlan:
    n: int
    primes: tuple[int, ...]
    plans: tuple[Ntt32Plan, ...]
    # Garner tables: garner_inv[i][j] = Shoup pair of q_j^-1 mod q_i (j < i)
    garner_inv: tuple[tuple[tuple[int, int], ...], ...]
    half_digits: tuple[int, ...]  # mixed-radix digits of (Q-1)//2
    q_mod_2_64: int  # Q mod 2^64
    q_prefix_mod_2_64: tuple[int, ...]  # prod(q_0..q_{i-1}) mod 2^64

    @property
    def k(self) -> int:
        return len(self.primes)

    @cached_property
    def kernel_consts(self) -> np.ndarray:
        """The plan's constants in the u64 layout `load_crt_consts` reads
        (`csrc/torus_crt.cuh`), w = `kernels.GARNER_MAX_PRIMES` slots a
        field: k; q, n_inv, its Shoup dual, the digits of (Q-1)/2 and the
        prefix products at 1 + t w + i; Q mod 2^64 at 1 + 5 w; the Garner
        inverses and their duals at 2 + 5 w (+ w^2) + w i + j. Slots of
        absent primes stay 0."""
        w = kernels.GARNER_MAX_PRIMES
        if self.k > w:
            raise ValueError(f"the kernels take at most {w} primes, this plan has {self.k}")
        c = np.zeros(2 + 5 * w + 2 * w * w, dtype=np.uint64)
        c[0] = self.k
        inv_at = 2 + 5 * w
        for i, (q, p) in enumerate(zip(self.primes, self.plans)):
            fields = (q, p.n_inv, p.n_inv_shoup, self.half_digits[i], self.q_prefix_mod_2_64[i])
            for t, v in enumerate(fields):
                c[1 + t * w + i] = v
            for j, (inv, inv_s) in enumerate(self.garner_inv[i]):
                c[inv_at + w * i + j] = inv
                c[inv_at + w * w + w * i + j] = inv_s
        c[1 + 5 * w] = self.q_mod_2_64
        return c


@lru_cache(maxsize=None)
def torus_crt_plan(n: int, bound_bits: int) -> TorusCrtPlan:
    """Plan with the fewest 31-bit primes covering 2^(bound_bits+1) <= Q."""
    stream = two_adic_primes(_PRIME_BITS, _MAX_LOG_N + 1)
    primes: list[int] = []
    q_prod = 1
    while q_prod < (1 << (bound_bits + 1)):
        p = next(stream)
        primes.append(p)
        q_prod *= p
    primes_t = tuple(primes)
    k = len(primes_t)

    garner_inv = tuple(
        tuple(
            (
                mod_inverse(primes_t[j] % primes_t[i], primes_t[i]),
                int(shoup32(mod_inverse(primes_t[j] % primes_t[i], primes_t[i]), primes_t[i])[()]),
            )
            for j in range(i)
        )
        for i in range(k)
    )

    # mixed-radix digits of H = (Q-1)//2: H = h0 + h1*q0 + h2*q0*q1 + ...
    h = (q_prod - 1) // 2
    half_digits = []
    rem = h
    for qi in primes_t:
        half_digits.append(rem % qi)
        rem //= qi
    assert rem == 0

    prefix = []
    acc = 1
    for qi in primes_t:
        prefix.append(acc % (1 << 64))
        acc *= qi

    return TorusCrtPlan(
        n=n,
        primes=primes_t,
        plans=tuple(ntt32_plan(q, n) for q in primes_t),
        garner_inv=garner_inv,
        half_digits=tuple(half_digits),
        q_mod_2_64=q_prod % (1 << 64),
        q_prefix_mod_2_64=tuple(prefix),
    )


@lru_cache(maxsize=None)
def crt_tables(plan: TorusCrtPlan, device: torch.device) -> PlanTables:
    """Twiddle tables of every prime of the plan, stacked (K, n), on device."""
    return stack_tables(plan.plans, device)


@lru_cache(maxsize=None)
def monomial_eval_table(n: int, bound_bits: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-precomputed evaluation-basis monomials for every X^s, s in [0, 2n).

    Returns (values, duals), each (k, 2n, n) u32: values[i, s, j] =
    psi_i^{(2*bitrev(j)+1)*s mod 2n}, the forward-NTT image of X^s under
    prime i, and the matching Shoup duals.
    """
    plan = torus_crt_plan(n, bound_bits)
    rev = bit_reverse_indices(n)
    exps = (np.arange(2 * n)[:, None] * (2 * rev[None, :] + 1)) % (2 * n)  # (2n, n)
    vals, duals = [], []
    for q in plan.primes:
        psi = two_adic_generator(q, n.bit_length())  # order 2n
        psi_pows = np.empty(2 * n, dtype=np.uint64)
        acc = 1
        for t in range(2 * n):
            psi_pows[t] = acc
            acc = acc * psi % q
        v = psi_pows[exps].astype(np.uint32)
        vals.append(v)
        duals.append(shoup32(v, q))
    return np.stack(vals), np.stack(duals)


def torus_to_eval(x: torch.Tensor, plan: TorusCrtPlan) -> torch.Tensor:
    """NTT residues of a full-range torus polynomial (centered lift):
    (..., n) int64 -> (K, ..., n) int32."""
    return torch.stack(
        [ntt32(i64_to_mod32(x, q).int(), p) for q, p in zip(plan.primes, plan.plans)]
    )


def small_to_eval(x: torch.Tensor, plan: TorusCrtPlan, bound_bits: int = 31) -> torch.Tensor:
    """NTT residues of a small centered polynomial (gadget digits, |coef| <
    2^bound_bits <= 2^31): the sign fold per prime, then K-NTT. x: (..., n)
    int32 or int64 -> (K, ..., n) int32."""
    assert bound_bits <= 31
    return torch.stack(
        [ntt32(small_u32_to_mod32(x, q).int(), p) for q, p in zip(plan.primes, plan.plans)]
    )


def eval_mul(a: torch.Tensor, b: torch.Tensor, plan: TorusCrtPlan) -> torch.Tensor:
    """Evaluation-basis pointwise products per prime of stacked residues
    (K, ..., n) int32 -> (K, ..., n) int32; the JAX package's `eval_mul`
    takes and returns one array per prime."""
    return torch.stack([pointwise_mul32(x, y, p) for x, y, p in zip(a, b, plan.plans)])


def garner_to_u64_ref(coeffs: torch.Tensor, plan: TorusCrtPlan) -> torch.Tensor:
    """Plain Garner reconstruction: coefficient residues (K, ...) int32 ->
    wrapping u64 (as int64) with the centered lift (subtract Q when the value
    exceeds (Q-1)/2). The JAX package's `garner_to_u64(..., intt_first=False)`."""
    c = coeffs.long()
    v: list[torch.Tensor] = []
    for i, qi in enumerate(plan.primes):
        t = c[i]
        for j in range(i):
            vj = torch.where(v[j] >= qi, v[j] - qi, v[j])  # q_j < 2 q_i
            t = mul_mod32(sub_mod32(t, vj, qi), plan.garner_inv[i][j][0], qi)
        v.append(t)
    value = v[0]
    for i in range(1, plan.k):
        value = value + v[i] * as_i64(plan.q_prefix_mod_2_64[i])
    over = torch.zeros_like(value, dtype=torch.bool)
    for i in range(plan.k):  # lexicographic (v_{k-1}, ..., v_0) > digits of (Q-1)/2
        h = plan.half_digits[i]
        over = (v[i] > h) | ((v[i] == h) & over)
    return value - over.long() * as_i64(plan.q_mod_2_64)


def garner_to_u64(coeffs: torch.Tensor, plan: TorusCrtPlan) -> torch.Tensor:
    """Garner reconstruction of coefficient residues (K, ...) int32 -> int64,
    K <= 5; on the card one K-GARNER launch (`.launches`, and by K in
    `.by_primes`)."""
    if coeffs.is_cpu:
        return garner_to_u64_ref(coeffs, plan)
    consts = plan.kernel_consts
    kernels.require("garner_to_u64", coeffs, torch.int32)
    if coeffs.dim() == 0 or coeffs.shape[0] != plan.k:
        raise ValueError(f"garner_to_u64: expected {plan.k} residue planes, got {tuple(coeffs.shape)}")
    out = coeffs.new_empty(coeffs.shape[1:], dtype=torch.int64)
    if out.numel():
        kernels.launch("lft_garner_to_u64", coeffs.data_ptr(), out.data_ptr(), out.numel(), consts.ctypes.data)
        garner_to_u64.launches += 1
        garner_to_u64.by_primes[plan.k] += 1
    return out


garner_to_u64.launches = 0
garner_to_u64.by_primes = Counter()


def negacyclic_mul_t64_crt(
    a_small: torch.Tensor, b: torch.Tensor, log_b: int, rows: int = 1
) -> torch.Tensor:
    """Exact a(X)*b(X) mod (X^N+1, 2^64): a_small centered with
    |coef| <= 2^(log_b-1), b arbitrary torus; the two broadcast together.

    Per prime one fused product (`negacyclic_mul32`), then one Garner pass."""
    n = a_small.shape[-1]
    if n == 1:
        return a_small * b
    plan = torus_crt_plan(n, required_bound_bits(n, log_b, rows))
    shape = torch.broadcast_shapes(a_small.shape, b.shape)
    a_small, b = a_small.expand(shape), b.expand(shape)
    coeffs = [
        negacyclic_mul32(
            small_u32_to_mod32(a_small, q).int().contiguous(),
            i64_to_mod32(b, q).int().contiguous(),
            p,
        )
        for q, p in zip(plan.primes, plan.plans)
    ]
    return garner_to_u64(torch.stack(coeffs), plan)
