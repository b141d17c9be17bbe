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
from ...ops.poly import automorphism_i64
from ...ops.rns import (
    RnsPlan,
    automorphism_rns,
    base_convert,
    mul_shoup_v,
    rescale_k,
    rns_add,
    rns_from_i64,
    rns_intt_mac,
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


@lru_cache(maxsize=None)
def _index(idx: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """An index list on a device, made once: a copy from the host each call
    would wait for the device's queue to drain."""
    return torch.tensor(idx, device=device)


def _select(x: torch.Tensor, idx: list[int], axis: int) -> torch.Tensor:
    """x's entries idx along axis (a fresh tensor), or x where idx takes them all in order."""
    if idx == list(range(x.shape[axis])):
        return x
    return x.index_select(axis % x.dim(), _index(tuple(idx), x.device))


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
    """b and a added in one K-RNS-ADD launch."""
    ct0, ct1, qs = _align(ct0, ct1)
    b, a = rns_add((ct0.b, ct0.a), (ct1.b, ct1.a), rns_plan(qs, ct0.b.shape[-1]))
    return CkksCiphertext(b, a, qs)


def sub(ct0: CkksCiphertext, ct1: CkksCiphertext) -> CkksCiphertext:
    ct0, ct1, qs = _align(ct0, ct1)
    b, a = rns_sub((ct0.b, ct0.a), (ct1.b, ct1.a), rns_plan(qs, ct0.b.shape[-1]))
    return CkksCiphertext(b, a, qs)


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


def _tensor(ct0: CkksCiphertext, ct1: CkksCiphertext, plan: RnsPlan) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tensor product's d0, d1, d2 of two ciphertexts of one shape over
    `plan`'s primes (the level, or a rank's limbs of it): the four operands
    transformed once, the products summed in the evaluation basis inside
    their three inverse transforms (d1's two products in one launch)."""
    ea0, eb0 = rns_ntt(ct0.a, plan), rns_ntt(ct0.b, plan)
    ea1, eb1 = rns_ntt(ct1.a, plan), rns_ntt(ct1.b, plan)
    d0 = rns_intt_mac([eb0], [eb1], plan)
    d1 = rns_intt_mac([eb0, ea0], [ea1, eb1], plan)
    d2 = rns_intt_mac([ea0], [ea1], plan)
    return d0, d1, d2


def _broadcast(ct0: CkksCiphertext, ct1: CkksCiphertext, qs: tuple) -> tuple[CkksCiphertext, CkksCiphertext]:
    """Both ciphertexts at one shape (their leading axes broadcast), contiguous."""
    if ct0.b.shape == ct1.b.shape:
        return ct0, ct1
    b0, a0, b1, a1 = (t.contiguous() for t in torch.broadcast_tensors(ct0.b, ct0.a, ct1.b, ct1.a))
    return CkksCiphertext(b0, a0, qs), CkksCiphertext(b1, a1, qs)


def _mul_finish(params: CkksParams, ba: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor, qs: tuple) -> CkksCiphertext:
    """The end of `mul` from the key switch's sums (2, ..., L + P, N) over
    qs + ps, before the division by P, and the tensor's d0 and d1 over qs:
    the rescale by P with d0 and d1 added in its launch, the rescale by the
    last q. Every step is per coefficient, so the same call serves a block
    of columns."""
    b, a = rescale_k(ba, qs + params.ps, len(params.ps), add=(d0, d1))
    return rescale_ct(CkksCiphertext(b, a, qs))


def mul(params: CkksParams, rlk: CkksKeySwitchingKey, ct0: CkksCiphertext, ct1: CkksCiphertext) -> CkksCiphertext:
    """Tensor + relinearize + rescale (`ckks.rs:255-267`): the tensor's d0,
    d1, d2 (`_tensor`), the key switch of d2 and the rescale."""
    ct0, ct1, qs = _align(ct0, ct1)
    ct0, ct1 = _broadcast(ct0, ct1, qs)
    d0, d1, d2 = _tensor(ct0, ct1, params.plan(qs))
    return _mul_finish(params, _ks_sums(params, rlk, _ks_hoist(params, d2, qs), qs), d0, d1, qs)


def _automorphism_rns(x, t: int, qs: tuple):
    """X -> X^t of x (..., L, N), or of a pair (b, a) in one launch
    (K-AUTOMORPH); a pair whose parts differ in shape (a batched b beside
    an unbatched a) takes one launch a part."""
    if isinstance(x, tuple) and x[0].shape != x[1].shape:
        return tuple(automorphism_rns(v, t, qs) for v in x)
    return automorphism_rns(x, t, qs)


@lru_cache(maxsize=None)
def _eval_perm(n: int, t: int, device: torch.device) -> torch.Tensor:
    """`eval_automorphism_perm(n, t)` as the int32 (n,) table K-RNS-MAC's
    gathered instances read, on a device."""
    return torch.from_numpy(eval_automorphism_perm(n, t).astype(np.int32)).to(device)


def conjugate(params: CkksParams, cjk: CkksKeySwitchingKey, ct: CkksCiphertext) -> CkksCiphertext:
    b, a = _automorphism_rns((ct.b, ct.a), -1, ct.qs)
    return key_switch(params, cjk, CkksCiphertext(b, a, ct.qs))


def rotate(params: CkksParams, rtk: CkksRotKey, ct: CkksCiphertext) -> CkksCiphertext:
    b, a = _automorphism_rns((ct.b, ct.a), params.pow5(rtk.j), ct.qs)
    return key_switch(params, rtk.ksk, CkksCiphertext(b, a, ct.qs))


def hoisted_rotations(params: CkksParams, rtks: tuple, ct: CkksCiphertext, js: tuple) -> tuple:
    """Rotate one ciphertext by many indices at the cost of one base extension
    and one forward transform (eprint 2018/1043 §5.3): automorphisms act on
    the evaluation basis as a slot permutation (`ops/ntt.py`
    `eval_automorphism_perm`), so each rotation dots the extended,
    transformed mask, read through its permutation (K-RNS-MAC's gathered
    instance: no permuted copy), with its eval-resident key."""
    qs = ct.qs
    ae = _ks_hoist(params, ct.a, qs)  # (..., D, Lqp, N)
    n = ct.a.shape[-1]
    outs = []
    for rtk, j in zip(rtks, js):
        assert rtk.j == j % params.l
        t = params.pow5(j)
        b, a = _ks_finish(params, rtk.ksk, ae, qs, _eval_perm(n, t, ae.device), add=(_automorphism_rns(ct.b, t, qs), None))
        outs.append(CkksCiphertext(b, a, qs))
    return tuple(outs)


def _ks_extend(params: CkksParams, a: torch.Tensor, qs: tuple, digits: tuple[int, int] | None = None) -> torch.Tensor:
    """Digit-decompose a (..., L, N) over the active level and base-extend
    each digit of the range `digits` (start, stop; default every active
    digit) to the full qs + ps basis, in the coefficient basis:
    (..., D', Lqp, N), each digit's limbs and their extension in QP order.
    One K-BASECONV launch a digit writes both into the digit's rows of one
    tensor (the JAX package's concatenate, permute and stack). Every step
    is per coefficient, so the same call serves a block of columns holding
    every limb."""
    qps = qs + params.ps
    slices = params.digit_slices(len(qs))
    chosen = slices if digits is None else slices[digits[0] : digits[1]]
    out = torch.empty((*a.shape[:-2], len(chosen), len(qps), a.shape[-1]), dtype=a.dtype, device=a.device)
    for d, (s, e) in enumerate(chosen):
        src = qs[s:e]
        rest = tuple(q for q in qps if q not in src)
        base_convert(a[..., s:e, :], src, rest, out=out[..., d, :, :], rows=tuple(qps.index(q) for q in rest), own=tuple(range(s, e)))
    return out


def _ks_hoist(params: CkksParams, a: torch.Tensor, qs: tuple, digits: tuple[int, int] | None = None) -> torch.Tensor:
    """`_ks_extend`, transformed: (..., D', Lqp, N) in the evaluation basis."""
    return rns_ntt(_ks_extend(params, a, qs, digits), params.plan(qs + params.ps))


def _ksk_digits(params: CkksParams, arr: torch.Tensor, n_active: int, idx: list[int]) -> torch.Tensor:
    """Active-level view of one ksk component: (D_active, Lqp_active, N), a
    fresh tensor where the level selects limbs."""
    d_active = len(params.digit_slices(n_active))
    a3 = arr[None] if arr.dim() == 2 else arr
    return _select(a3[:d_active], idx, -2)


def _digits(ae: torch.Tensor) -> list[torch.Tensor]:
    """The D digits of a hoisted mask (..., D, Lqp, N), each contiguous."""
    return [ae[..., d, :, :].contiguous() for d in range(ae.shape[-3])]


def _ks_dot(ksk_sel: torch.Tensor, ae: torch.Tensor, plan: RnsPlan, perm=None, ksk_z=None) -> torch.Tensor:
    """sum_d ksk[d] * ae[d] in the evaluation basis (the digit contraction)
    in one K-RNS-MAC launch: ksk_sel (D, Lqp, N), ae (..., D, Lqp, N). With
    perm (an `_eval_perm` table), ae read through it, as the JAX package's
    `_ks_dot(ksk, ae[..., perm])`; with ksk_z (shaped as ksk_sel), both
    sums, stacked: (2, ..., Lqp, N)."""
    D = ae.shape[-3]
    zs = None if ksk_z is None else [ksk_z[d] for d in range(D)]
    return rns_mac(_digits(ae), [ksk_sel[d] for d in range(D)], plan, zs, None if perm is None else [perm] * D)


def _ks_macs(ae: torch.Tensor, ksk_b: torch.Tensor, ksk_a: torch.Tensor, plan: RnsPlan, perm=None) -> torch.Tensor:
    """The digit contraction of ae (..., D, Lqp', N), read through perm where
    given (`_eval_perm`), against both key components' rows (D, Lqp', N)
    inside their inverse transforms (one `rns_intt_mac` launch) over
    `plan`'s primes (the QP basis, or a rank's rows of it): (2, ..., Lqp',
    N), b and a before the division by P."""
    D = ae.shape[-3]
    perms = None if perm is None else [perm] * D
    return rns_intt_mac(_digits(ae), [ksk_b[d] for d in range(D)], plan, [ksk_a[d] for d in range(D)], perms)


def ksk_rows(params: CkksParams, ksk: CkksKeySwitchingKey, qs: tuple, rows: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """b and a of ksk at the active digits of level qs and the primes
    `rows` (a sub-basis of qs + ps, in its order): (D_active, len(rows), N)
    each, fresh tensors where a selection is made."""
    idx = [params.qps.index(q) for q in rows]
    return _ksk_digits(params, ksk.b, len(qs), idx), _ksk_digits(params, ksk.a, len(qs), idx)


def _ks_sums(params: CkksParams, ksk: CkksKeySwitchingKey, ae: torch.Tensor, qs: tuple, perm=None) -> torch.Tensor:
    """`_ks_macs` of ae against the level's rows of ksk: (2, ..., L + P, N)."""
    qps = qs + params.ps
    return _ks_macs(ae, *ksk_rows(params, ksk, qs, qps), params.plan(qps), perm)


def _ks_finish(params: CkksParams, ksk: CkksKeySwitchingKey, ae: torch.Tensor, qs: tuple, perm=None, add=None):
    """`_ks_sums`, then the rescale by P: the switched b and a, (2, ..., L,
    N), or with `add` (a pair, either entry None: the source's b) the pair
    of parts, each add in the rescale's launch where it has the part's
    shape (`rescale_finish`)."""
    return rescale_k(_ks_sums(params, ksk, ae, qs, perm), qs + params.ps, len(params.ps), add)


def key_switch(params: CkksParams, ksk: CkksKeySwitchingKey, ct: CkksCiphertext) -> CkksCiphertext:
    """Digit-decompose a, extend each digit to QP, dot with the per-digit
    ksk, rescale P away (`ckks.rs:284-293`; Han-Ki digits with params.dnum)."""
    b, a = _ks_finish(params, ksk, _ks_hoist(params, ct.a, ct.qs), ct.qs, add=(ct.b, None))
    return CkksCiphertext(b, a, ct.qs)
