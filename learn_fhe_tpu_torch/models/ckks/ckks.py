"""CKKS (RNS variant, eprint 2018/1073) -- reference `scheme/ckks/src/ckks.rs`,
port of `learn_fhe_tpu/models/ckks/ckks.py` up to its key switch.

Ciphertexts are (b, a) pairs of stacked-limb RNS polynomials (..., L, N) of
u64 residues carried as int64, with any leading batch axes; the level (the
active prime basis `qs`) travels beside them. Keys and randomness are drawn
on the host from the caller's numpy Generator in the JAX package's order, so
one seed makes bit-identical keys and ciphertexts in both packages; what
they make goes to the current CUDA device unless the caller passes
device="cpu". On the card every transform, product sum, base conversion and
rescale is a kernel of `ops/rns.py`.

Hybrid key switching (`ckks.rs:154-162,284-293`): ksk = enc_{QP}(P * sk'),
stored in the evaluation basis; key_switch extends the target mask to base
QP, multiplies, and rescales the P-part away.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, lru_cache
from itertools import islice

import numpy as np
import torch

from ...ops.modular import shoup_precompute
from ...ops.ntt import eval_automorphism_perm
from ...ops.poly import automorphism_i64, automorphism_map
from ...ops.rns import (
    RnsPlan,
    extend_bases,
    mul_shoup_v,
    neg_mod_v,
    rescale_k,
    rns_add,
    rns_from_i64,
    rns_intt,
    rns_mac,
    rns_mul,
    rns_neg,
    rns_ntt,
    rns_plan,
    rns_sub,
    rns_tables,
)
from ...utils.crt import bigints_to_rns, rns_to_bigints
from ...utils.dd import DDC
from ...utils.distributions import dg, uniform_zq, zo
from ...utils.interop import resolve_device, torch_to_u64, u64_to_torch
from ...utils.primes import two_adic_primes
from .sfft import sfft, sifft


@dataclass(frozen=True)
class CkksParams:
    """L q-primes + auxiliary p-primes; the scale is the last q prime
    (`ckks.rs:20-35`).

    Defaults reproduce the reference: uniform log_qi-bit primes and |P| = |Q|
    single-digit key switching. The optional fields are the JAX package's
    production extension:

    - log_qis: per-prime bit-width ladder, bottom (q0) to top;
    - log_ps: explicit auxiliary primes;
    - dnum: hybrid key-switch digit count (Han-Ki, eprint 2019/688): the Q
      basis splits into dnum groups of alpha primes and the ksk carries one
      ciphertext per digit.
    """

    log_n: int
    log_qi: int
    big_l: int
    log_qis: tuple | None = None  # per-prime ladder, bottom -> top
    log_ps: tuple | None = None  # aux primes; default big_l copies of log_qi
    dnum: int | None = None  # key-switch digits; None = 1 (reference)

    def __post_init__(self):
        assert self.log_n >= 1 and self.big_l > 1
        if self.log_qis is not None:
            assert len(self.log_qis) == self.big_l

    @cached_property
    def _prime_streams(self) -> dict:
        """One descending prime stream per distinct bit width, shared by qs
        then ps so equal-width primes never collide."""
        sizes = set(self.log_qis or ()) | set(self.log_ps or ())
        sizes |= {self.log_qi}
        return {s: two_adic_primes(s, self.log_n + 1) for s in sizes}

    @cached_property
    def qs(self) -> tuple[int, ...]:
        if self.log_qis is None:
            return tuple(islice(two_adic_primes(self.log_qi, self.log_n + 1), self.big_l))
        return tuple(next(self._prime_streams[s]) for s in self.log_qis)

    @cached_property
    def ps(self) -> tuple[int, ...]:
        if self.log_qis is None and self.log_ps is None:
            it = two_adic_primes(self.log_qi, self.log_n + 1)
            return tuple(islice(it, self.big_l, 2 * self.big_l))
        self.qs  # force qs to consume its share of the shared streams first
        log_ps = self.log_ps or (self.log_qi,) * self.big_l
        return tuple(next(self._prime_streams[s]) for s in log_ps)

    @property
    def qps(self) -> tuple[int, ...]:
        return self.qs + self.ps

    @property
    def num_digits(self) -> int:
        return self.dnum or 1

    @property
    def alpha(self) -> int:
        """Primes per key-switch digit."""
        return -(-self.big_l // self.num_digits)

    def digit_slices(self, level_l: int) -> tuple:
        """(start, stop) limb ranges of each active digit at a level with
        level_l live primes."""
        a = self.alpha
        return tuple((s, min(s + a, level_l)) for s in range(0, level_l, a))

    def digit_factor(self, d: int) -> int:
        """P * B_d, B_d = (Q/Q_d) [(Q/Q_d)^-1 mod Q_d], the CRT basis element
        of digit d over the full q basis."""
        s, e = self.digit_slices(self.big_l)[d]
        big_q = 1
        for q in self.qs:
            big_q *= q
        q_d = 1
        for q in self.qs[s:e]:
            q_d *= q
        q_hat = big_q // q_d
        return self.big_p * q_hat * pow(q_hat % q_d, -1, q_d)

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def l(self) -> int:  # noqa: E743
        """Slot count N/2 (`ckks.rs:45-47`)."""
        return 1 << (self.log_n - 1)

    @property
    def scale(self) -> int:
        return self.qs[-1]

    @cached_property
    def big_p(self) -> int:
        out = 1
        for p in self.ps:
            out *= p
        return out

    def pow5(self, j: int) -> int:
        return pow(5, j, 2 * self.n)

    def plan(self, qs: tuple[int, ...]) -> RnsPlan:
        return rns_plan(qs, self.n)


@dataclass(frozen=True)
class CkksCiphertext:
    """RNS ciphertext: b and a of shape (..., L, N) over the level qs."""

    b: torch.Tensor
    a: torch.Tensor
    qs: tuple


@dataclass(frozen=True)
class CkksKeySwitchingKey:
    """Ciphertext over the full QP basis encrypting P * sk' (per digit with
    dnum), in the evaluation basis: (2L, N), or (D, 2L, N) with digits."""

    b: torch.Tensor
    a: torch.Tensor
    qs: tuple


@dataclass(frozen=True)
class CkksRotKey:
    ksk: CkksKeySwitchingKey
    j: int


def _select(x: torch.Tensor, idx: list[int], axis: int) -> torch.Tensor:
    """x's entries idx along axis (a fresh tensor), or x where idx takes them all in order."""
    if idx == list(range(x.shape[axis])):
        return x
    return x.index_select(axis % x.dim(), torch.tensor(idx, device=x.device))


def to_level(ct: CkksCiphertext, qs: tuple) -> CkksCiphertext:
    """Keep only the limbs in qs (`rns.rs:148-158`)."""
    if ct.qs == qs:
        return ct
    idx = [ct.qs.index(q) for q in qs]
    return CkksCiphertext(_select(ct.b, idx, -2), _select(ct.a, idx, -2), qs)


def _align(ct0: CkksCiphertext, ct1: CkksCiphertext):
    qs = tuple(q for q in ct0.qs if q in ct1.qs)
    return to_level(ct0, qs), to_level(ct1, qs), qs


def add(ct0: CkksCiphertext, ct1: CkksCiphertext) -> CkksCiphertext:
    ct0, ct1, qs = _align(ct0, ct1)
    plan = rns_plan(qs, ct0.b.shape[-1])
    return CkksCiphertext(rns_add(ct0.b, ct1.b, plan), rns_add(ct0.a, ct1.a, plan), qs)


def sub(ct0: CkksCiphertext, ct1: CkksCiphertext) -> CkksCiphertext:
    ct0, ct1, qs = _align(ct0, ct1)
    plan = rns_plan(qs, ct0.b.shape[-1])
    return CkksCiphertext(rns_sub(ct0.b, ct1.b, plan), rns_sub(ct0.a, ct1.a, plan), qs)


# -- keygen -------------------------------------------------------------------


def sk_gen(params: CkksParams, rng: np.random.Generator) -> np.ndarray:
    """sk ~ zo(0.5) (`ckks.rs:139-141`), host int64."""
    return zo(0.5, rng, params.n)


def sk_gen_sparse(params: CkksParams, h: int, rng: np.random.Generator) -> np.ndarray:
    """Sparse ternary secret of Hamming weight exactly h."""
    assert 0 < h <= params.n
    sk = np.zeros(params.n, dtype=np.int64)
    idx = rng.choice(params.n, size=h, replace=False)
    sk[idx] = rng.choice(np.array([-1, 1]), size=h)
    return sk


def _i64(v, device) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.int64)).to(device)


def pk_gen(params: CkksParams, sk: np.ndarray, rng: np.random.Generator, device=None) -> CkksCiphertext:
    zero = torch.zeros((len(params.qs), params.n), dtype=torch.int64, device=resolve_device(device))
    return sk_encrypt(params, sk, zero, params.qs, rng)


def _sk_square(sk: np.ndarray) -> np.ndarray:
    """Negacyclic sk^2 over the integers (`ckks.rs:78-80`)."""
    n = len(sk)
    full = np.convolve(sk.astype(np.int64), sk.astype(np.int64))
    lo = full[:n].copy()
    hi = np.zeros(n, dtype=np.int64)
    hi[: 2 * n - 1 - n] = full[n:]
    return lo - hi


@lru_cache(maxsize=None)
def _digit_factors(params: CkksParams) -> tuple[np.ndarray, np.ndarray]:
    """(D, 2L, 1) P B_d mod each qps prime, and their Shoup duals."""
    qps = params.qps
    f = [[params.digit_factor(d) % q for q in qps] for d in range(params.num_digits)]
    fs = [[int(shoup_precompute(v, q)) for v, q in zip(row, qps)] for row in f]
    return np.array(f, dtype=np.uint64)[..., None], np.array(fs, dtype=np.uint64)[..., None]


def _ksk_pt(params: CkksParams, sk_prime_i64: torch.Tensor) -> torch.Tensor:
    """Per-digit ksk plaintexts (..., D, 2L, N) holding P B_d sk' over qps."""
    plan = params.plan(params.qps)
    pt = rns_from_i64(sk_prime_i64, plan)  # (..., 2L, N)
    dev = pt.device
    f, fs = _digit_factors(params)
    return mul_shoup_v(pt[..., None, :, :], u64_to_torch(f, dev), u64_to_torch(fs, dev), rns_tables(plan, dev).q)


def ksk_gen(
    params: CkksParams, sk: np.ndarray, sk_prime: np.ndarray, rng: np.random.Generator, device=None
) -> CkksKeySwitchingKey:
    """ksk = enc_{QP}(P B_d sk') per digit d (`ckks.rs:154-162`), in the
    evaluation basis; one digit keeps the reference's (2L, N) layout."""
    pts = _ksk_pt(params, _i64(sk_prime, resolve_device(device)))
    D = params.num_digits
    cts = [sk_encrypt(params, sk, pts[d], params.qps, rng) for d in range(D)]
    b = cts[0].b if D == 1 else torch.stack([ct.b for ct in cts])
    a = cts[0].a if D == 1 else torch.stack([ct.a for ct in cts])
    plan = params.plan(params.qps)
    return CkksKeySwitchingKey(rns_ntt(b, plan), rns_ntt(a, plan), params.qps)


def rlk_gen(params: CkksParams, sk: np.ndarray, rng, device=None) -> CkksKeySwitchingKey:
    return ksk_gen(params, sk, _sk_square(sk), rng, device)


def cjk_gen(params: CkksParams, sk: np.ndarray, rng, device=None) -> CkksKeySwitchingKey:
    return ksk_gen(params, sk, automorphism_i64(np.asarray(sk, dtype=np.int64), -1), rng, device)


def rtk_gen(params: CkksParams, sk: np.ndarray, j: int, rng, device=None) -> CkksRotKey:
    assert j != 0
    j = j % params.l
    sk_rot = automorphism_i64(np.asarray(sk, dtype=np.int64), params.pow5(j))
    return CkksRotKey(ksk_gen(params, sk, sk_rot, rng, device), j)


def _ksk_gen_core(params: CkksParams, sk_primes_i64, a, e_i64, sk_i64):
    """K keys at once: sk_primes (K, N), a (K, D, 2L, N), e (K, D, N) ->
    evaluation-basis (b, a), each (K, D, 2L, N)."""
    plan = params.plan(params.qps)
    pts = _ksk_pt(params, sk_primes_i64)
    e = rns_from_i64(e_i64, plan)
    sk_rns = rns_from_i64(sk_i64, plan)
    b = rns_add(rns_add(rns_neg(rns_mul(a, sk_rns, plan), plan), e, plan), pts, plan)
    return rns_ntt(b, plan), rns_ntt(a, plan)


def ksk_gen_many(
    params: CkksParams, sk: np.ndarray, sk_primes: np.ndarray, rng: np.random.Generator, device=None
) -> list[CkksKeySwitchingKey]:
    """K key-switching keys in one batch (the same draws as the JAX package's)."""
    dev = resolve_device(device)
    K, D, qps = len(sk_primes), params.num_digits, params.qps
    a = np.stack(
        [np.stack([np.stack([uniform_zq(q, rng, params.n) for q in qps]) for _ in range(D)]) for _ in range(K)]
    )
    e = np.stack([np.stack([dg(3.2, 6, rng, params.n) for _ in range(D)]) for _ in range(K)])
    b_eval, a_eval = _ksk_gen_core(params, _i64(sk_primes, dev), u64_to_torch(a, dev), _i64(e, dev), _i64(sk, dev))
    if D == 1:
        return [CkksKeySwitchingKey(b_eval[k, 0], a_eval[k, 0], qps) for k in range(K)]
    return [CkksKeySwitchingKey(b_eval[k], a_eval[k], qps) for k in range(K)]


def rtk_gen_many(
    params: CkksParams, sk: np.ndarray, js: list, rng: np.random.Generator, device=None
) -> dict[int, CkksRotKey]:
    """Rotation keys for all js in one batch (see ksk_gen_many)."""
    js = [j % params.l for j in js]
    sk_rots = np.stack([automorphism_i64(np.asarray(sk, dtype=np.int64), params.pow5(j)) for j in js])
    ksks = ksk_gen_many(params, sk, sk_rots, rng, device)
    return {j: CkksRotKey(k, j) for j, k in zip(js, ksks)}


# -- encode / decode (host; `ckks.rs:186-213`) ---------------------------------


def _lift(m, precision: str):
    from ...utils.f256 import FPC

    if isinstance(m, (DDC, FPC)):
        return m
    if precision == "f256":
        return FPC.from_complex(m)
    return DDC.from_complex(m)


def encode(
    params: CkksParams,
    m,
    qs: tuple | None = None,
    precision: str = "dd",
    scale_int: int | None = None,
    rounding: str = "nearest",
    device=None,
) -> torch.Tensor:
    """m: (l,) complex (np.complex128, DDC or FPC) -> RNS plaintext (L, N) on
    `device` (see `resolve_device`). Host math as the JAX package's: sifft
    in double-double ("dd") or 256-bit fixed point ("f256"), times the
    scale (scale_int overrides it), then round to nearest or, with
    rounding="trunc", toward zero as the reference's F256 -> BigInt does."""
    qs = params.qs if qs is None else qs
    z = _lift(m, precision)
    assert len(z) == params.l
    z = sifft(z).mul_int(params.scale if scale_int is None else scale_int)
    re, im = z.trunc_to_ints() if rounding == "trunc" else z.round_to_ints()
    return u64_to_torch(bigints_to_rns(re + im, qs), resolve_device(device))


def decode(params: CkksParams, pt: torch.Tensor, qs: tuple, precision: str = "dd", scale_int: int | None = None):
    """RNS plaintext (L, N) -> (l,) complex128 slots (an FPC with
    precision="f256"), on the host."""
    vals = rns_to_bigints(torch_to_u64(pt), qs)
    l, s = params.l, params.scale if scale_int is None else scale_int
    if precision == "f256":
        from ...utils.f256 import FPC

        return sfft(FPC.from_ints(vals[:l], vals[l:]).div_int(s))
    return sfft(DDC.from_ints(vals[:l], vals[l:]).div_int(s)).to_complex128()


# -- encrypt / decrypt ---------------------------------------------------------


def sk_encrypt(params: CkksParams, sk: np.ndarray, pt: torch.Tensor, qs: tuple, rng: np.random.Generator) -> CkksCiphertext:
    """b = -(a sk) + e + pt (`ckks.rs:215-225`), on pt's device."""
    dev = pt.device
    a = u64_to_torch(np.stack([uniform_zq(q, rng, params.n) for q in qs]), dev)
    e = _i64(dg(3.2, 6, rng, params.n), dev)
    plan = rns_plan(qs, params.n)
    sk_rns = rns_from_i64(_i64(sk, dev), plan)
    b = rns_add(rns_add(rns_neg(rns_mul(a, sk_rns, plan), plan), rns_from_i64(e, plan), plan), pt, plan)
    return CkksCiphertext(b, a, qs)


def pk_encrypt(params: CkksParams, pk: CkksCiphertext, pt: torch.Tensor, rng: np.random.Generator) -> CkksCiphertext:
    """(b, a) = (pk.b u + e1 + pt, pk.a u + e0) (`ckks.rs:227-239`), on pk's device."""
    qs, dev = pk.qs, pk.b.device
    plan = params.plan(qs)
    u = rns_from_i64(_i64(zo(0.5, rng, params.n), dev), plan)
    e0 = rns_from_i64(_i64(dg(3.2, 6, rng, params.n), dev), plan)
    e1 = rns_from_i64(_i64(dg(3.2, 6, rng, params.n), dev), plan)
    a = rns_add(rns_mul(pk.a, u, plan), e0, plan)
    b = rns_add(rns_add(rns_mul(pk.b, u, plan), e1, plan), pt, plan)
    return CkksCiphertext(b, a, qs)


def decrypt(params: CkksParams, sk: np.ndarray, ct: CkksCiphertext) -> torch.Tensor:
    """pt = b + a sk (`ckks.rs:241-248`), on ct's device."""
    plan = params.plan(ct.qs)
    sk_rns = rns_from_i64(_i64(sk, ct.b.device), plan)
    return rns_add(ct.b, rns_mul(ct.a, sk_rns, plan), plan)


# -- homomorphic ops ------------------------------------------------------------


def rescale_ct(ct: CkksCiphertext, k: int = 1) -> CkksCiphertext:
    return CkksCiphertext(rescale_k(ct.b, ct.qs, k), rescale_k(ct.a, ct.qs, k), ct.qs[:-k])


def _mul_pt(params: CkksParams, pt: torch.Tensor, ct: CkksCiphertext) -> CkksCiphertext:
    plan = params.plan(ct.qs)
    return rescale_ct(CkksCiphertext(rns_mul(pt, ct.b, plan), rns_mul(pt, ct.a, plan), ct.qs))


def mul_constant(params: CkksParams, m, ct: CkksCiphertext) -> CkksCiphertext:
    """encode(m) * ct, then rescale (`ckks.rs:250-253`)."""
    return _mul_pt(params, encode(params, m, ct.qs, device=ct.b.device), ct)


def add_constant(params: CkksParams, m, ct: CkksCiphertext) -> CkksCiphertext:
    """ct + encode(m): plaintext addition into b, no level consumed."""
    pt = encode(params, m, ct.qs, device=ct.b.device)
    return CkksCiphertext(rns_add(ct.b, pt, params.plan(ct.qs)), ct.a, ct.qs)


def mul(params: CkksParams, rlk: CkksKeySwitchingKey, ct0: CkksCiphertext, ct1: CkksCiphertext) -> CkksCiphertext:
    """Tensor + relinearize + rescale (`ckks.rs:255-267`): the four operands
    transformed once, the tensor's products summed in the evaluation basis
    (d1's two in one K-RNS-MAC launch), three inverse transforms, then the
    key switch of d2 and the rescale."""
    ct0, ct1, qs = _align(ct0, ct1)
    if ct0.b.shape != ct1.b.shape:
        b0, a0, b1, a1 = (t.contiguous() for t in torch.broadcast_tensors(ct0.b, ct0.a, ct1.b, ct1.a))
        ct0, ct1 = CkksCiphertext(b0, a0, qs), CkksCiphertext(b1, a1, qs)
    plan = params.plan(qs)
    ea0, eb0 = rns_ntt(ct0.a, plan), rns_ntt(ct0.b, plan)
    ea1, eb1 = rns_ntt(ct1.a, plan), rns_ntt(ct1.b, plan)
    d0 = rns_intt(rns_mac([eb0], [eb1], plan), plan)
    d1 = rns_intt(rns_mac([eb0, ea0], [ea1, eb1], plan), plan)
    d2 = rns_intt(rns_mac([ea0], [ea1], plan), plan)
    relin = _ks_finish(params, rlk, _ks_hoist(params, d2, qs), qs)  # (2, ..., L, N): b and a
    return rescale_ct(CkksCiphertext(rns_add(d0, relin[0], plan), rns_add(d1, relin[1], plan), qs))


@lru_cache(maxsize=None)
def _automorphism_index(n: int, t: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    src, sign = automorphism_map(n, t)
    return torch.from_numpy(src).to(device), torch.from_numpy(sign).to(device)


def _automorphism_rns(x: torch.Tensor, t: int, qs: tuple) -> torch.Tensor:
    src, sign = _automorphism_index(x.shape[-1], t, x.device)
    g = x[..., src]
    return torch.where(sign, neg_mod_v(g, rns_tables(rns_plan(qs, x.shape[-1]), x.device).q), g)


def conjugate(params: CkksParams, cjk: CkksKeySwitchingKey, ct: CkksCiphertext) -> CkksCiphertext:
    ct_conj = CkksCiphertext(_automorphism_rns(ct.b, -1, ct.qs), _automorphism_rns(ct.a, -1, ct.qs), ct.qs)
    return key_switch(params, cjk, ct_conj)


def rotate(params: CkksParams, rtk: CkksRotKey, ct: CkksCiphertext) -> CkksCiphertext:
    t = params.pow5(rtk.j)
    ct_rot = CkksCiphertext(_automorphism_rns(ct.b, t, ct.qs), _automorphism_rns(ct.a, t, ct.qs), ct.qs)
    return key_switch(params, rtk.ksk, ct_rot)


def hoisted_rotations(params: CkksParams, rtks: tuple, ct: CkksCiphertext, js: tuple) -> tuple:
    """Rotate one ciphertext by many indices at the cost of one base extension
    and one forward transform (eprint 2018/1043 §5.3): automorphisms act on
    the evaluation basis as a slot permutation (`ops/ntt.py`
    `eval_automorphism_perm`), so the extended, transformed mask is permuted
    per rotation and dotted with its eval-resident key."""
    qs = ct.qs
    plan_q = params.plan(qs)
    ae = _ks_hoist(params, ct.a, qs)  # (..., D, Lqp, N)
    n = ct.a.shape[-1]
    outs = []
    for rtk, j in zip(rtks, js):
        assert rtk.j == j % params.l
        t = params.pow5(j)
        perm = torch.from_numpy(eval_automorphism_perm(n, t)).to(ae.device)
        ba = _ks_finish(params, rtk.ksk, ae[..., perm], qs)
        outs.append(CkksCiphertext(rns_add(ba[0], _automorphism_rns(ct.b, t, qs), plan_q), ba[1], qs))
    return tuple(outs)


def _ks_hoist(params: CkksParams, a: torch.Tensor, qs: tuple) -> torch.Tensor:
    """Digit-decompose a over the active level and base-extend every digit
    to the full qs + ps basis, transformed: (..., D_active, Lqp, N)."""
    qps = qs + params.ps
    outs = []
    for s, e in params.digit_slices(len(qs)):
        src = qs[s:e]
        rest = tuple(q for q in qps if q not in src)
        x = a[..., s:e, :]
        ext = torch.cat([x, extend_bases(x, src, rest)], dim=-2)
        have = src + rest
        outs.append(_select(ext, [have.index(q) for q in qps], -2))
    ext = outs[0].unsqueeze(-3) if len(outs) == 1 else torch.stack(outs, dim=-3)
    return rns_ntt(ext, params.plan(qps))


def _ksk_digits(params: CkksParams, arr: torch.Tensor, n_active: int, idx: list[int]) -> torch.Tensor:
    """Active-level view of one ksk component: (D_active, Lqp_active, N), a
    fresh tensor where the level selects limbs."""
    d_active = len(params.digit_slices(n_active))
    a3 = arr[None] if arr.dim() == 2 else arr
    return _select(a3[:d_active], idx, -2)


def _ks_finish(params: CkksParams, ksk: CkksKeySwitchingKey, ae: torch.Tensor, qs: tuple) -> torch.Tensor:
    """The digit contraction of ae (..., D, Lqp, N) against both ksk
    components (one K-RNS-MAC launch), their inverse transforms and the
    rescale by P: (2, ..., L, N), the switched b (without the source's b)
    and a."""
    qps = qs + params.ps
    plan = params.plan(qps)
    idx = [params.qps.index(q) for q in qps]
    ksk_b = _ksk_digits(params, ksk.b, len(qs), idx)
    ksk_a = _ksk_digits(params, ksk.a, len(qs), idx)
    D = ae.shape[-3]
    xs = [ae[..., d, :, :].contiguous() for d in range(D)]
    acc = rns_mac(xs, [ksk_b[d] for d in range(D)], plan, [ksk_a[d] for d in range(D)])
    return rescale_k(rns_intt(acc, plan), qps, len(params.ps))


def key_switch(params: CkksParams, ksk: CkksKeySwitchingKey, ct: CkksCiphertext) -> CkksCiphertext:
    """Digit-decompose a, extend each digit to QP, dot with the per-digit
    ksk, rescale P away (`ckks.rs:284-293`; Han-Ki digits with params.dnum)."""
    ba = _ks_finish(params, ksk, _ks_hoist(params, ct.a, ct.qs), ct.qs)
    return CkksCiphertext(rns_add(ba[0], ct.b, params.plan(ct.qs)), ba[1], ct.qs)
