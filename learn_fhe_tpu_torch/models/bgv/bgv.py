"""BGV: exact leveled arithmetic over Z_t with SIMD slot packing
(`learn_fhe_tpu/models/bgv/bgv.py`).

Ciphertexts are (b, a) pairs of stacked-limb RNS polynomials (..., L, N) of
u64 residues carried as int64, with any leading batch axes; the level (the
active prime basis `qs`) and the plaintext `factor` travel beside them.
Keys and randomness are drawn on the host from the caller's numpy Generator
in the JAX package's order, so one seed makes bit-identical keys and
ciphertexts in both packages; what they make goes to the current CUDA device
unless the caller passes device="cpu".

Scheme shape (BGV '12 / GHS '12, RNS form):

- phase(ct) = b + a s = m + t e (mod Q): the plaintext rides the low bits.
- Modulus switching drops the last limb exactly (`ops/rns.py::drop_limbs_t`):
  subtract the unique d with d = x (mod q_last), d = 0 (mod t), then
  divide; the plaintext gains q_last^-1 mod t, which `factor` records and
  decrypt undoes.
- Key switching is the CKKS hybrid (extend to QP, multiply the
  evaluation-basis ksk = enc(P sk'), divide P away) with the division by P
  as len(ps) t-corrected drops, so `factor` is untouched.
- SIMD: t = 65537 splits R_t into N slots at the odd powers of a primitive
  2N-th root; encode/decode are host NTTs mod t in power-of-5 slot order,
  so `rotate` cyclically rotates each of the two length-N/2 slot rows.

On the card a `mul` is four forward K-RNS-NTT, the tensor's d0, d1 and d2
summed inside their inverse (`rns_intt_mac`), the key switch of d2 (K-BASECONV
from qs to ps, one K-RNS-NTT over QP, one `rns_intt_mac` with both key
components), and one K-BGV-DROP launch that drops P from b and a, adds d0
and d1, and drops the last q. `rotate`/`conjugate` permute b and a in one
K-AUTOMORPH launch before the same key switch, whose drop adds the permuted
b. A key's rows at a lower level are selected once and kept with the key.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from itertools import islice

import numpy as np
import torch

from ...ops.ntt32 import ntt32_plan
from ...ops.poly import automorphism_i64
from ...ops.rns import (
    RnsPlan,
    _col,
    automorphism_rns,
    base_convert,
    drop_limbs_t,
    mul_shoup_v,
    rns_add,
    rns_from_i64,
    rns_intt_mac,
    rns_mul,
    rns_neg,
    rns_ntt,
    rns_plan,
    rns_sub,
    rns_tables,
)
from ...utils.crt import rns_to_bigints
from ...utils.distributions import dg, uniform_zq, zo
from ...utils.interop import resolve_device, torch_to_u64, u64_to_torch
from ...utils.primes import mod_inverse, two_adic_primes


@dataclass(frozen=True)
class BgvParams:
    """big_l q-primes + big_l auxiliary p-primes (hybrid ksk), one descending
    two-adic stream, like CkksParams; t is the plaintext modulus (prime,
    2N | t-1 so R_t splits into N slots)."""

    log_n: int
    t: int = 65537
    log_qi: int = 45
    big_l: int = 4

    def __post_init__(self):
        assert self.log_n >= 1 and self.big_l > 1
        assert self.log_qi <= 46, "t-correction products must fit i64 lanes"
        assert (self.t - 1) % (2 << self.log_n) == 0, "need 2N | t-1 for SIMD slots"

    @cached_property
    def qs(self) -> tuple[int, ...]:
        return tuple(islice(two_adic_primes(self.log_qi, self.log_n + 1), self.big_l))

    @cached_property
    def ps(self) -> tuple[int, ...]:
        it = two_adic_primes(self.log_qi, self.log_n + 1)
        return tuple(islice(it, self.big_l, 2 * self.big_l))

    @property
    def qps(self) -> tuple[int, ...]:
        return self.qs + self.ps

    @property
    def n(self) -> int:
        return 1 << self.log_n

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
class BgvCiphertext:
    b: torch.Tensor  # (..., L, N) int64
    a: torch.Tensor
    qs: tuple  # the level
    factor: int = 1  # accumulated q^-1 mod t applied to the plaintext


@dataclass(frozen=True, eq=False)
class BgvKeySwitchingKey:
    """enc_{QP}(P sk') in the evaluation basis: b and a (2L, N) over qs (the
    full QP basis). `rows` gives a level's rows of both, selected once."""

    b: torch.Tensor
    a: torch.Tensor
    qs: tuple
    _levels: dict = field(default_factory=dict, init=False, repr=False, compare=False)

    def rows(self, basis: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        """b and a at the limbs of `basis` (a sub-basis of qs), contiguous:
        the stored tensors where basis is all of qs, else copies made at the
        first call for that basis and kept."""
        if basis == self.qs:
            return self.b, self.a
        if basis not in self._levels:
            idx = torch.tensor([self.qs.index(q) for q in basis], device=self.b.device)
            self._levels[basis] = (self.b.index_select(-2, idx), self.a.index_select(-2, idx))
        return self._levels[basis]


@dataclass(frozen=True)
class BgvRotKey:
    ksk: BgvKeySwitchingKey
    j: int


# -- keygen ---------------------------------------------------------------------


def _i64(v, device) -> torch.Tensor:
    return torch.from_numpy(np.array(v, dtype=np.int64)).to(device)


def sk_gen(params: BgvParams, rng: np.random.Generator) -> np.ndarray:
    return zo(0.5, rng, params.n)


def _sk_square(sk: np.ndarray) -> np.ndarray:
    """Negacyclic sk^2 over the integers."""
    n = len(sk)
    full = np.convolve(sk.astype(np.int64), sk.astype(np.int64))
    lo = full[:n].copy()
    hi = np.zeros(n, dtype=np.int64)
    hi[: n - 1] = full[n:]
    return lo - hi


def sk_encrypt(params: BgvParams, sk: np.ndarray, pt: torch.Tensor, qs: tuple, rng: np.random.Generator) -> BgvCiphertext:
    """b = -(a s) + t e + pt over basis qs, on pt's device."""
    dev = pt.device
    a = u64_to_torch(np.stack([uniform_zq(q, rng, params.n) for q in qs]), dev)
    e = _i64(dg(3.2, 6, rng, params.n), dev)
    plan = rns_plan(qs, params.n)
    sk_rns = rns_from_i64(_i64(sk, dev), plan)
    te = rns_from_i64(e * params.t, plan)
    return BgvCiphertext(rns_add(rns_add(rns_neg(rns_mul(a, sk_rns, plan), plan), te, plan), pt, plan), a, qs)


def pk_gen(params: BgvParams, sk: np.ndarray, rng: np.random.Generator, device=None) -> BgvCiphertext:
    zero = torch.zeros((len(params.qs), params.n), dtype=torch.int64, device=resolve_device(device))
    return sk_encrypt(params, sk, zero, params.qs, rng)


def pk_encrypt(params: BgvParams, pk: BgvCiphertext, pt: torch.Tensor, rng: np.random.Generator) -> BgvCiphertext:
    """(b, a) = (pk.b u + t e1 + pt, pk.a u + t e0), on pk's device: u
    transformed once and both products summed inside one inverse transform."""
    qs, dev = pk.qs, pk.b.device
    plan = params.plan(qs)
    u = rns_ntt(rns_from_i64(_i64(zo(0.5, rng, params.n), dev), plan), plan)
    te0 = rns_from_i64(_i64(dg(3.2, 6, rng, params.n), dev) * params.t, plan)
    te1 = rns_from_i64(_i64(dg(3.2, 6, rng, params.n), dev) * params.t, plan)
    bu, au = rns_intt_mac([u], [rns_ntt(pk.b, plan)], plan, [rns_ntt(pk.a, plan)])
    return BgvCiphertext(rns_add(rns_add(bu, te1, plan), pt, plan), rns_add(au, te0, plan), qs)


def _ksk_pt(params: BgvParams, sk_prime: torch.Tensor) -> torch.Tensor:
    """P sk' over qps."""
    qps = params.qps
    plan = params.plan(qps)
    dev = sk_prime.device
    p_mod = [params.big_p % q for q in qps]
    p_dual = [(w << 64) // q for w, q in zip(p_mod, qps)]
    return mul_shoup_v(rns_from_i64(sk_prime, plan), _col(p_mod, dev), _col(p_dual, dev), rns_tables(plan, dev).q)


def ksk_gen(
    params: BgvParams, sk: np.ndarray, sk_prime: np.ndarray, rng: np.random.Generator, device=None
) -> BgvKeySwitchingKey:
    pt = _ksk_pt(params, _i64(sk_prime, resolve_device(device)))
    ct = sk_encrypt(params, sk, pt, params.qps, rng)
    plan = params.plan(params.qps)
    return BgvKeySwitchingKey(rns_ntt(ct.b, plan), rns_ntt(ct.a, plan), params.qps)


def rlk_gen(params: BgvParams, sk: np.ndarray, rng, device=None) -> BgvKeySwitchingKey:
    return ksk_gen(params, sk, _sk_square(sk), rng, device)


def rtk_gen(params: BgvParams, sk: np.ndarray, j: int, rng, device=None) -> BgvRotKey:
    assert j % (params.n // 2) != 0
    j = j % (params.n // 2)
    sk_rot = automorphism_i64(np.asarray(sk, dtype=np.int64), params.pow5(j))
    return BgvRotKey(ksk_gen(params, sk, sk_rot, rng, device), j)


def cjk_gen(params: BgvParams, sk: np.ndarray, rng, device=None) -> BgvKeySwitchingKey:
    return ksk_gen(params, sk, automorphism_i64(np.asarray(sk, dtype=np.int64), -1), rng, device)


# -- encode / decode (host) ---------------------------------------------------------


def _bitrev(k: int, bits: int) -> int:
    r = 0
    for b in range(bits):
        r |= ((k >> b) & 1) << (bits - 1 - b)
    return r


@lru_cache(maxsize=None)
def _slot_order(t: int, n: int, log_n: int) -> np.ndarray:
    """Slot j -> evaluation position, in power-of-5 order: rows j < n/2 at
    exponents 5^j mod 2n, rows j >= n/2 at -5^j, so the automorphism
    X -> X^{5^v} rotates each half cyclically. The merged-twist transform
    evaluates position k at psi^{2 bitrev(k) + 1}."""
    pos = {(2 * _bitrev(k, log_n) + 1) % (2 * n): k for k in range(n)}
    order = np.empty(n, dtype=np.int64)
    half = n // 2
    for r in range(half):
        e5 = pow(5, r, 2 * n)
        order[r] = pos[e5]
        order[half + r] = pos[2 * n - e5]
    return order


def _host_ntt_t(x: np.ndarray, t: int, n: int) -> np.ndarray:
    """Host radix-2 merged-twist NTT mod t over the last axis (the
    butterflies of `ops/ntt32.py`, in numpy)."""
    plan = ntt32_plan(t, n)
    psi = plan.psi_br.astype(np.uint64)
    out = x.astype(np.uint64) % t
    for l in range(n.bit_length() - 1):  # noqa: E741
        m, half = 1 << l, n >> (l + 1)
        v = out.reshape(*x.shape[:-1], m, 2, half)
        u_, w_ = v[..., 0, :], v[..., 1, :]
        tv = (w_ * psi[m : 2 * m][:, None]) % t
        out = np.stack([(u_ + tv) % t, (u_ + (t - tv)) % t], axis=-2).reshape(x.shape)
    return out


def _host_intt_t(x: np.ndarray, t: int, n: int) -> np.ndarray:
    plan = ntt32_plan(t, n)
    psi_inv = plan.psi_inv_br.astype(np.uint64)
    out = x.astype(np.uint64) % t
    for l in range(n.bit_length() - 2, -1, -1):  # noqa: E741
        m, half = 1 << l, n >> (l + 1)
        v = out.reshape(*x.shape[:-1], m, 2, half)
        u_, w_ = v[..., 0, :], v[..., 1, :]
        s = (u_ + w_) % t
        dd = ((u_ + (t - w_)) % t * psi_inv[m : 2 * m][:, None]) % t
        out = np.stack([s, dd], axis=-2).reshape(x.shape)
    return (out * np.uint64(plan.n_inv)) % t


def encode(params: BgvParams, m: np.ndarray, device=None) -> torch.Tensor:
    """Slot values (..., N) ints in [0, t) -> RNS plaintext (..., L_top, N) on
    `device` (see `resolve_device`)."""
    m = np.asarray(m)
    assert m.shape[-1] == params.n
    order = _slot_order(params.t, params.n, params.log_n)
    ev = np.zeros(m.shape, dtype=np.uint64)
    ev[..., order] = m.astype(np.uint64) % params.t
    coeffs = _host_intt_t(ev, params.t, params.n)
    return rns_from_i64(_i64(coeffs.astype(np.int64), resolve_device(device)), params.plan(params.qs))


def encode_coeffs(params: BgvParams, m: np.ndarray, device=None) -> torch.Tensor:
    """Coefficient encoding (no slot transform)."""
    return rns_from_i64(_i64(m, resolve_device(device)), params.plan(params.qs))


def _phase_mod_t(phase: np.ndarray, qs: tuple, t: int) -> np.ndarray:
    """Centered CRT lift mod t (host, exact big ints), over any leading axes."""
    lead = phase.shape[:-2]
    flat = phase.reshape((-1,) + phase.shape[-2:])
    outs = [np.array([v % t for v in rns_to_bigints(sl, qs)], dtype=np.int64) for sl in flat]
    return np.stack(outs).reshape(lead + (phase.shape[-1],))


def decrypt_coeffs(params: BgvParams, sk: np.ndarray, ct: BgvCiphertext) -> np.ndarray:
    plan = params.plan(ct.qs)
    sk_rns = rns_from_i64(_i64(sk, ct.a.device), plan)
    phase = rns_add(ct.b, rns_mul(ct.a, sk_rns, plan), plan)
    m = _phase_mod_t(torch_to_u64(phase), ct.qs, params.t)
    if ct.factor != 1:
        m = (m * mod_inverse(ct.factor, params.t)) % params.t
    return m


def decrypt(params: BgvParams, sk: np.ndarray, ct: BgvCiphertext) -> np.ndarray:
    """Decrypt to slot values (..., N) in [0, t)."""
    coeffs = decrypt_coeffs(params, sk, ct)
    order = _slot_order(params.t, params.n, params.log_n)
    ev = _host_ntt_t(coeffs % params.t, params.t, params.n)
    return ev[..., order].astype(np.int64)


# -- homomorphic ops ------------------------------------------------------------


def to_level(ct: BgvCiphertext, qs: tuple) -> BgvCiphertext:
    """Limb-intersection drop WITHOUT division: valid only on fresh
    encryptions (the phase is unchanged mod the smaller Q while |phase| <
    Q'/2). Prefer mod_switch."""
    if ct.qs == qs:
        return ct
    idx = torch.tensor([ct.qs.index(q) for q in qs], device=ct.b.device)
    return BgvCiphertext(ct.b.index_select(-2, idx), ct.a.index_select(-2, idx), qs, ct.factor)


def _align(ct0: BgvCiphertext, ct1: BgvCiphertext) -> tuple:
    assert ct0.qs == ct1.qs, "mod_switch operands to a common level first"
    assert ct0.factor == ct1.factor, "plaintext factors must match for add/sub"
    return ct0.qs


def add(ct0: BgvCiphertext, ct1: BgvCiphertext) -> BgvCiphertext:
    """b and a added in one K-RNS-ADD launch."""
    qs = _align(ct0, ct1)
    b, a = rns_add((ct0.b, ct0.a), (ct1.b, ct1.a), rns_plan(qs, ct0.b.shape[-1]))
    return BgvCiphertext(b, a, qs, ct0.factor)


def sub(ct0: BgvCiphertext, ct1: BgvCiphertext) -> BgvCiphertext:
    qs = _align(ct0, ct1)
    b, a = rns_sub((ct0.b, ct0.a), (ct1.b, ct1.a), rns_plan(qs, ct0.b.shape[-1]))
    return BgvCiphertext(b, a, qs, ct0.factor)


def _drop(b: torch.Tensor, a: torch.Tensor, qs: tuple, t: int, k: int, add=(None, None), then: int = 0):
    """b and a each through `drop_limbs_t(.., qs, t, k, add, then)`: one launch
    for both where they and the adds have the launch's shapes, else (the
    operands broadcast against each other) the same steps part by part."""
    mid = (*b.shape[:-2], len(qs) - k, b.shape[-1])
    if b.shape == a.shape and all(x is None or x.shape == mid for x in add):
        return drop_limbs_t((b.contiguous(), a.contiguous()), qs, t, k, tuple(None if x is None else x.contiguous() for x in add), then)
    out = []
    for x, y in zip((b, a), add):
        x = drop_limbs_t(x.contiguous(), qs, t, k)
        if y is not None:
            x = rns_add(x, y, rns_plan(qs[: len(qs) - k], x.shape[-1]))
        out.append(drop_limbs_t(x.contiguous(), qs[: len(qs) - k], t, then) if then else x)
    return tuple(out)


def mod_switch(params: BgvParams, ct: BgvCiphertext) -> BgvCiphertext:
    """Drop the last q limb: noise shrinks about q_last-fold (plus the
    additive t ||s||-sized correction term); the plaintext factor gains
    q_last^-1."""
    b, a = _drop(ct.b, ct.a, ct.qs, params.t, 1)
    f = ct.factor * mod_inverse(ct.qs[-1] % params.t, params.t) % params.t
    return BgvCiphertext(b, a, ct.qs[:-1], f)


def _ks_extend(params: BgvParams, d2: torch.Tensor, qs: tuple) -> torch.Tensor:
    """d2 (..., L, N) over qs extended to qs + ps, in the coefficient basis:
    (..., L + P, N), d2's limbs and their extension written by one
    K-BASECONV launch (the JAX package's concatenate). Per coefficient, so
    the same call serves a block of columns holding every limb."""
    L, P = len(qs), len(params.ps)
    out = torch.empty((*d2.shape[:-2], L + P, d2.shape[-1]), dtype=d2.dtype, device=d2.device)
    return base_convert(d2.contiguous(), qs, params.ps, out=out, rows=tuple(range(L, L + P)), own=tuple(range(L)))


def _ks_macs(ext: torch.Tensor, kb: torch.Tensor, ka: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """ext (..., Lqp', N) transformed (K-RNS-NTT) and dotted with both key
    components' rows (Lqp', N) inside their inverse transform (one
    `rns_intt_mac` launch), over `plan`'s primes (the QP basis, or a rank's
    rows of it): (2, ..., Lqp', N), b and a before the division by P."""
    return rns_intt_mac([rns_ntt(ext, plan)], [kb], plan, [ka])


def _ks_sums(params: BgvParams, ksk: BgvKeySwitchingKey, d2: torch.Tensor, qs: tuple) -> torch.Tensor:
    """d2 (..., L, N) over qs extended to qs + ps, transformed and dotted
    with both key components: (2, ..., L + P, N), before the division by P."""
    qps = qs + params.ps
    return _ks_macs(_ks_extend(params, d2, qs), *ksk.rows(qps), params.plan(qps))


def key_switch(params: BgvParams, ksk: BgvKeySwitchingKey, ct: BgvCiphertext) -> BgvCiphertext:
    """Switch (b, a) under sk' to under sk (the a part through the ksk); the
    division by P (exact t-corrected drops) and the add of b in one launch."""
    ba = _ks_sums(params, ksk, ct.a, ct.qs)
    b, a = _drop(ba[0], ba[1], ct.qs + params.ps, params.t, len(params.ps), (ct.b, None))
    return BgvCiphertext(b, a, ct.qs, ct.factor)


def _tensor(b0, a0, b1, a1, plan: RnsPlan) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tensor product's d0, d1, d2 over `plan`'s primes (the level, or a
    rank's limbs of it), the four operands of one shape."""
    eb0, ea0 = rns_ntt(b0, plan), rns_ntt(a0, plan)
    eb1, ea1 = rns_ntt(b1, plan), rns_ntt(a1, plan)
    d0 = rns_intt_mac([eb0], [eb1], plan)
    d1 = rns_intt_mac([eb0, ea0], [ea1, eb1], plan)
    d2 = rns_intt_mac([ea0], [ea1], plan)
    return d0, d1, d2


def _operands(ct0: BgvCiphertext, ct1: BgvCiphertext) -> tuple[torch.Tensor, ...]:
    """b0, a0, b1, a1 at one shape (their leading axes broadcast)."""
    b0, a0, b1, a1 = ct0.b, ct0.a, ct1.b, ct1.a
    if not b0.shape == a0.shape == b1.shape == a1.shape:
        b0, a0, b1, a1 = (x.contiguous() for x in torch.broadcast_tensors(b0, a0, b1, a1))
    return b0, a0, b1, a1


def _mul_finish(params: BgvParams, ba: torch.Tensor, d0: torch.Tensor, d1: torch.Tensor, qs: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """The end of `mul` from the key switch's sums (2, ..., L + P, N) over
    qs + ps and the tensor's d0, d1: the division by P, the adds, and the
    mod-switch drop, in one K-BGV-DROP launch. Per coefficient, so the same
    call serves a block of columns."""
    return _drop(ba[0], ba[1], qs + params.ps, params.t, len(params.ps), (d0, d1), then=1)


def _mul_factor(params: BgvParams, ct0: BgvCiphertext, ct1: BgvCiphertext) -> int:
    return (ct0.factor * ct1.factor * mod_inverse(ct0.qs[-1] % params.t, params.t)) % params.t


def mul(params: BgvParams, rlk: BgvKeySwitchingKey, ct0: BgvCiphertext, ct1: BgvCiphertext) -> BgvCiphertext:
    """Tensor + relinearize + mod-switch; output factor f0 f1 q_last^-1."""
    assert ct0.qs == ct1.qs, "mod_switch operands to a common level first"
    qs = ct0.qs
    d0, d1, d2 = _tensor(*_operands(ct0, ct1), params.plan(qs))
    b, a = _mul_finish(params, _ks_sums(params, rlk, d2, qs), d0, d1, qs)
    return BgvCiphertext(b, a, qs[:-1], _mul_factor(params, ct0, ct1))


def _pt_at(params: BgvParams, m: np.ndarray, ct: BgvCiphertext) -> torch.Tensor:
    return encode(params, m, ct.b.device)[..., : len(ct.qs), :].contiguous()


def mul_plain(params: BgvParams, m: np.ndarray, ct: BgvCiphertext) -> BgvCiphertext:
    """ct * encode(m): no relinearization, no level change, factor unchanged."""
    pt = _pt_at(params, m, ct)
    plan = params.plan(ct.qs)
    return BgvCiphertext(rns_mul(pt, ct.b, plan), rns_mul(pt, ct.a, plan), ct.qs, ct.factor)


def add_plain(params: BgvParams, m: np.ndarray, ct: BgvCiphertext) -> BgvCiphertext:
    """ct + encode(m), compensating the ciphertext's plaintext factor."""
    pt = _pt_at(params, (np.asarray(m, dtype=np.int64) * ct.factor) % params.t, ct)
    return BgvCiphertext(rns_add(ct.b, pt, params.plan(ct.qs)), ct.a, ct.qs, ct.factor)


def _auto_ks(params: BgvParams, ksk: BgvKeySwitchingKey, ct: BgvCiphertext, t5: int) -> BgvCiphertext:
    """The automorphism X -> X^t5 of b and a (one K-AUTOMORPH launch), then the
    key switch, whose drop adds the permuted b."""
    if ct.b.shape == ct.a.shape:
        mb, ma = automorphism_rns((ct.b, ct.a), t5, ct.qs)
    else:
        mb, ma = automorphism_rns(ct.b, t5, ct.qs), automorphism_rns(ct.a, t5, ct.qs)
    ba = _ks_sums(params, ksk, ma, ct.qs)
    b, a = _drop(ba[0], ba[1], ct.qs + params.ps, params.t, len(params.ps), (mb, None))
    return BgvCiphertext(b, a, ct.qs, ct.factor)


def rotate(params: BgvParams, rtk: BgvRotKey, ct: BgvCiphertext) -> BgvCiphertext:
    """Rotate each length-N/2 slot row left by rtk.j (decode[r] <- old r+j)."""
    return _auto_ks(params, rtk.ksk, ct, params.pow5(rtk.j))


def conjugate(params: BgvParams, cjk: BgvKeySwitchingKey, ct: BgvCiphertext) -> BgvCiphertext:
    """Swap the two slot rows (the automorphism X -> X^-1)."""
    return _auto_ks(params, cjk, ct, -1)
