"""EvalMod and the full CKKS bootstrap (`learn_fhe_tpu/models/ckks/evalmod.py`),
beyond the reference's scope (its bootstrapping.rs stops at the linear
transforms):

    mod_raise -> coeff_to_slot -> eval_mod (sine) -> slot_to_coeff

eval_mod approximates x mod 1 (slots carry t = w/c + I with integer I,
|I| <= K, |w/c| small) as (1/2pi) sin(2pi t), evaluated as a Chebyshev
interpolant of cos(2pi (t - 1/4) / 2^r) on |t| <= K+1 followed by r
double-angle squarings (cos 2a = 2 cos^2 a - 1), eprint 2018/153 §5 /
2018/1043. The Chebyshev evaluation uses the recursive Paterson-Stockmeyer
split p = q T_g + r (one ciphertext mul per split level), and tracks each
ciphertext's true scale exactly (`Fraction`), correcting it inside each
encoded constant's integer scale. Those integer scales decide every
ciphertext, so the tracking is the JAX package's, step for step.

Everything composes the port's ops (`ckks.mul`, `conjugate`, the constant
multiply `_mul_pt_eval`, the linear transforms of `bootstrapping.py`);
`mod_raise` is one K-BASECONV launch from the bottom limb.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from fractions import Fraction
from functools import cached_property

import numpy as np
import torch

from ...ops.rns import base_convert, rescale_k, rns_add, rns_intt_mac, rns_ntt
from . import ckks as C
from .bootstrapping import BootstrapKey, _pt_eval, coeff_to_slot, slot_to_coeff
from .ckks import CkksCiphertext, CkksKeySwitchingKey, CkksParams

# ---------------------------------------------------------------------------
# Host-side Chebyshev toolkit (numpy, exact recurrences)
# ---------------------------------------------------------------------------


def cheb_interpolate(f, degree: int) -> np.ndarray:
    """Chebyshev interpolation coefficients of f on [-1, 1] at the
    Chebyshev points (numpy's chebinterpolate)."""
    return np.polynomial.chebyshev.chebinterpolate(f, degree)


def cheb_eval_host(coeffs: np.ndarray, t):
    return np.polynomial.chebyshev.chebval(t, coeffs)


def cheb_split(p: np.ndarray, g: int) -> tuple[np.ndarray, np.ndarray]:
    """Write p = q * T_g + r in the Chebyshev basis with deg q = deg p - g,
    deg r < g, using T_g*T_j = (T_{g+j} + T_{|g-j|}) / 2."""
    D = len(p) - 1
    assert D >= g
    q = np.zeros(D - g + 1)
    q[0] = p[g]
    q[1:] = 2.0 * p[g + 1 :]
    # r = p - q*T_g expanded back into the Chebyshev basis
    qTg = np.zeros(D + 1)
    qTg[g] += q[0]
    for j in range(1, len(q)):
        qTg[g + j] += q[j] / 2.0
        qTg[abs(g - j)] += q[j] / 2.0
    r = p.copy()
    r[: len(qTg)] -= qTg
    return q, r[:g]


# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

# LRU over (params, value, qs, scale_int, eval_basis, device): one bootstrap
# at L levels touches ~50 constants per level, so the cap holds several
# parameter sets while bounding device-buffer residency for long sweeps.
_CONST_CACHE_MAX = 4096
_const_cache: OrderedDict = OrderedDict()


def _const(
    params: CkksParams,
    value: complex,
    qs,
    eval_basis: bool = False,
    scale_int: int | None = None,
    device=None,
) -> torch.Tensor:
    """Encoded constant vector [value]*l at basis qs and integer scale
    `scale_int` (default params.scale) on `device`, cached: EvalMod re-uses
    the same ~50 Chebyshev/offset constants every bootstrap. With
    eval_basis=True the cached array is transformed, saving a forward
    transform inside every constant multiply."""
    F = params.scale if scale_int is None else int(scale_int)
    device = torch.device(device)
    key = (params, complex(value), tuple(qs), F, eval_basis, device)
    pt = _const_cache.get(key)
    if pt is None:
        pt = C.encode(params, np.full(params.l, value, dtype=np.complex128), qs, scale_int=F, device=device)
        if eval_basis:
            pt = _pt_eval(tuple(qs), pt)
        _const_cache[key] = pt
        while len(_const_cache) > _CONST_CACHE_MAX:
            _const_cache.popitem(last=False)
    else:
        _const_cache.move_to_end(key)
    return pt


def _add_pt(params: CkksParams, pt: torch.Tensor, ct: CkksCiphertext) -> CkksCiphertext:
    return CkksCiphertext(rns_add(ct.b, pt, params.plan(ct.qs)), ct.a, ct.qs)


def add_const(params: CkksParams, ct: CkksCiphertext, value: float) -> CkksCiphertext:
    """ct + value (plaintext add: no level, no key)."""
    return _add_pt(params, _const(params, value, ct.qs, device=ct.b.device), ct)


def mul_const(params: CkksParams, ct: CkksCiphertext, value: complex) -> CkksCiphertext:
    """ct * scalar constant (one level); the constant is encoded at the
    prime being dropped (F = qs[-1]), so a ciphertext at true scale S stays
    at exactly S through the multiply and rescale, and rides the
    evaluation-basis cache."""
    F = ct.qs[-1]
    return _mul_pt_eval(params, _const(params, value, ct.qs, eval_basis=True, scale_int=F, device=ct.b.device), ct)


def _mul_pt_eval(params: CkksParams, pt_eval: torch.Tensor, ct: CkksCiphertext) -> CkksCiphertext:
    """ct times an evaluation-basis plaintext, then the rescale: b and a
    stacked through one forward transform and one inverse transform whose
    first pass makes the products (the plaintext a key broadcast over them),
    one rescale of both."""
    plan = params.plan(ct.qs)
    ba = rns_intt_mac([rns_ntt(torch.stack([ct.b, ct.a]), plan)], [pt_eval], plan)
    ba = rescale_k(ba, ct.qs, 1)
    return CkksCiphertext(ba[0], ba[1], ct.qs[:-1])


# -- exact scale tracking ----------------------------------------------------
#
# An RNS rescale divides by qs[-1], not by params.scale; with a descending
# prime stream every drop multiplies the true scale of a fixed-scale reading
# by scale/q, one-sided. Tracked exactly (Fraction) and corrected inside each
# encoded constant, the drift cancels to the constants' integer-rounding
# floor instead of compounding across the evaluation depth.


@dataclass
class _SCt:
    """Host-side scale-tracked ciphertext: slots hold P/S for EXACT S."""

    ct: CkksCiphertext
    S: Fraction


def _smul_const(params: CkksParams, x: _SCt, value, S_target: Fraction) -> _SCt:
    """x * value, encoding the constant at F = round(q_drop * S_target / S)
    so the result's true scale lands on S_target (exactly tracked)."""
    q = x.ct.qs[-1]
    F = round(Fraction(q) * S_target / x.S)
    pt = _const(params, value, x.ct.qs, eval_basis=True, scale_int=F, device=x.ct.b.device)
    return _SCt(_mul_pt_eval(params, pt, x.ct), x.S * F / q)


def _sadd_const(params: CkksParams, x: _SCt, value: float) -> _SCt:
    """x + value, the constant encoded at round(S): exact at any scale."""
    pt = _const(params, value, x.ct.qs, scale_int=round(x.S), device=x.ct.b.device)
    return _SCt(_add_pt(params, pt, x.ct), x.S)


def _smul(params: CkksParams, rlk: CkksKeySwitchingKey, x: _SCt, y: _SCt) -> _SCt:
    qs = tuple(q for q in x.ct.qs if q in y.ct.qs)
    return _SCt(C.mul(params, rlk, x.ct, y.ct), x.S * y.S / qs[-1])


_ALIGN_TOL = Fraction(1, 1 << 45)


def _sadd(x: _SCt, y: _SCt) -> _SCt:
    assert abs(x.S / y.S - 1) < _ALIGN_TOL, float(x.S / y.S - 1)
    return _SCt(C.add(x.ct, y.ct), x.S)


def _ssub(x: _SCt, y: _SCt) -> _SCt:
    assert abs(x.S / y.S - 1) < _ALIGN_TOL, float(x.S / y.S - 1)
    return _SCt(C.sub(x.ct, y.ct), x.S)


def _double(ct: CkksCiphertext) -> CkksCiphertext:
    return C.add(ct, ct)


# ---------------------------------------------------------------------------
# Homomorphic Chebyshev evaluation
# ---------------------------------------------------------------------------


@dataclass
class _ChebCtx:
    params: CkksParams
    rlk: CkksKeySwitchingKey
    powers: dict  # j -> _SCt of T_j(t)

    def T(self, j: int) -> _SCt:
        """Scale-tracked ciphertext of T_j(t), built on demand via
        T_{a+b} = 2 T_a T_b - T_{|a-b|} with a power-of-two ladder (depth
        log j). For non-power j the higher-level T_{|a-b|} operand is
        scale-aligned onto the product's exact scale by a 1.0 constant
        multiply, which makes the subtraction exact."""
        if j in self.powers:
            return self.powers[j]
        assert j >= 2
        half = 1 << (j.bit_length() - 1)
        a, b = (half, j - half) if j != half else (half // 2, half // 2)
        ta, tb = self.T(a), self.T(b)
        prod = _smul(self.params, self.rlk, ta, tb)
        out = _SCt(_double(prod.ct), prod.S)
        if a == b:
            out = _sadd_const(self.params, out, -1.0)  # T_{2a} = 2 T_a^2 - 1
        else:
            tm = _smul_const(self.params, self.T(abs(a - b)), 1.0, out.S)
            out = _ssub(out, tm)
        self.powers[j] = out
        return out

    def eval(self, coeffs: np.ndarray, baby: int, S_target: Fraction) -> _SCt:
        """Recursive PS evaluation of sum coeffs[k] T_k; the result's true
        scale is ~S_target for leaf-only polynomials and exactly tracked for
        split nodes (the residual branch adopts the product branch's exact
        scale, so every addition aligns)."""
        coeffs = np.trim_zeros(np.asarray(coeffs, dtype=np.float64), "b")
        if len(coeffs) == 0:
            coeffs = np.zeros(1)
        D = len(coeffs) - 1
        if D < baby:
            # direct: constant muls of the cached T_j (one level) + adds
            out = None
            for k in range(1, D + 1):
                if coeffs[k] == 0.0:
                    continue
                term = _smul_const(self.params, self.T(k), float(coeffs[k]), S_target)
                out = term if out is None else _sadd(out, term)
            if out is None:
                out = _smul_const(self.params, self.T(1), 0.0, S_target)
            return _sadd_const(self.params, out, float(coeffs[0]))
        g = 1 << (D.bit_length() - 1)  # largest power of two <= D
        q, r = cheb_split(coeffs, g)
        # back-solve the q branch's target so q_ct * T_g lands exactly on
        # S_target: the dropped prime at the product is the last limb of the
        # lower-level operand (levels are prefix bases of params.qs)
        tg = self.T(g)
        l_al = min(self._level(q, baby), len(tg.ct.qs))
        q_drop = self.params.qs[l_al - 1]
        q_ct = self.eval(q, baby, S_target * q_drop / tg.S)
        prod = _smul(self.params, self.rlk, q_ct, tg)
        r_ct = self.eval(r, baby, prod.S)
        return _sadd(prod, r_ct)

    def _level(self, coeffs: np.ndarray, baby: int) -> int:
        """Predicted level (len(qs)) of eval(coeffs, baby): eval's structure
        on the T cache without its ciphertext ops."""
        coeffs = np.trim_zeros(np.asarray(coeffs, dtype=np.float64), "b")
        if len(coeffs) == 0:
            coeffs = np.zeros(1)
        D = len(coeffs) - 1
        if D < baby:
            ks = [k for k in range(1, D + 1) if coeffs[k] != 0.0] or [1]
            return min(len(self.T(k).ct.qs) for k in ks) - 1
        g = 1 << (D.bit_length() - 1)
        q, _ = cheb_split(coeffs, g)
        return min(self._level(q, baby), len(self.T(g).ct.qs)) - 1


def eval_chebyshev(
    params: CkksParams,
    rlk: CkksKeySwitchingKey,
    ct_t: CkksCiphertext,
    coeffs: np.ndarray,
    baby: int = 8,
) -> CkksCiphertext:
    """Evaluate sum_k coeffs[k] T_k(t) on a ciphertext whose slots hold t in
    [-1, 1] (fresh-scale input)."""
    S0 = Fraction(params.scale)
    ctx = _ChebCtx(params, rlk, {1: _SCt(ct_t, S0)})
    return ctx.eval(coeffs, baby, S0).ct


# ---------------------------------------------------------------------------
# EvalMod: remove the q0-multiples a mod-raise introduced
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EvalModParams:
    """x -> c * (1/2pi) sin(2pi x / c) config: slots hold x = w + c*I."""

    k: int = 12  # |I| <= k
    r: int = 3  # double-angle squarings
    degree: int = 30  # Chebyshev degree before doubling
    # The cubic arcsine correction: w ~ (c/2pi)(u + u^3/6) on the sine
    # output u, for 2 extra levels.
    arcsin: bool = False
    # The EvalMod chain's working scale (log2); None runs it at params.scale.
    log_work_scale: int | None = None

    def work_scale(self, params: CkksParams) -> Fraction:
        if self.log_work_scale is None:
            return Fraction(params.scale)
        return Fraction(1 << self.log_work_scale)

    @cached_property
    def cheb_coeffs(self) -> np.ndarray:
        # f(s) = cos(2pi ((k+1) s - 1/4) / 2^r) on s in [-1, 1]
        kp1 = self.k + 1
        f = lambda s: np.cos(2 * np.pi * (kp1 * s - 0.25) / (1 << self.r))  # noqa: E731
        return cheb_interpolate(f, self.degree)


def _eval_mod_real_s(
    params: CkksParams,
    rlk: CkksKeySwitchingKey,
    x: _SCt,
    em: EvalModParams,
    c: float,
    S_out: Fraction | None = None,
) -> _SCt:
    """Scale-tracked core: slots hold s = x / (c*(k+1)) in [-1, 1] for real
    x = w + c*I; returns slots ~ w at true scale ~S_out (default
    params.scale). The chain runs at em.work_scale."""
    if S_out is None:
        S_out = Fraction(params.scale)
    ctx = _ChebCtx(params, rlk, {1: x})
    cos_ct = ctx.eval(em.cheb_coeffs, 8, em.work_scale(params))
    for _ in range(em.r):  # cos 2a = 2 cos^2 a - 1
        sq = _smul(params, rlk, cos_ct, cos_ct)
        cos_ct = _sadd_const(params, _SCt(_double(sq.ct), sq.S), -1.0)
    # slots u ~ cos(2pi x/c - pi/2) = sin(2pi x/c)
    if em.arcsin:
        # w ~ (c/2pi) asin(u) to cubic order, factored u * (A + (A/6) u^2)
        # with A = c/2pi; the inner branch's scale target back-solved so the
        # final product lands exactly on S_out
        l_cos = len(cos_ct.ct.qs)
        assert l_cos >= 4, f"arcsin correction needs 3 levels, have {l_cos - 1}"
        A = c / (2 * np.pi)
        S_p = S_out * params.qs[l_cos - 3] / cos_ct.S
        u2 = _smul(params, rlk, cos_ct, cos_ct)
        p = _sadd_const(params, _smul_const(params, u2, A / 6.0, S_p), A)
        return _smul(params, rlk, p, cos_ct)
    # scale by c/2pi and land the true scale exactly on S_out
    return _smul_const(params, cos_ct, c / (2 * np.pi), S_out)


def eval_mod_real(
    params: CkksParams,
    rlk: CkksKeySwitchingKey,
    ct_s: CkksCiphertext,
    em: EvalModParams,
    c: float,
) -> CkksCiphertext:
    """Fresh-scale wrapper over the scale-tracked core."""
    return _eval_mod_real_s(params, rlk, _SCt(ct_s, Fraction(params.scale)), em, c).ct


def _cts_scale(params: CkksParams, ct: CkksCiphertext) -> Fraction:
    """True scale of a CoeffToSlot output: each BSGS chunk multiplies by
    diagonals encoded at the then-top prime's scale and rescales that prime
    away, so the fresh-encode scale survives unchanged."""
    del ct
    return Fraction(params.scale)


def eval_mod(
    params: CkksParams,
    rlk: CkksKeySwitchingKey,
    cjk: CkksKeySwitchingKey,
    ct: CkksCiphertext,
    em: EvalModParams,
    c: float,
    S_in: Fraction | None = None,
    S_out: Fraction | None = None,
) -> CkksCiphertext:
    """Complex slots z = x + i y with x, y = w + c*I each: EvalMod of the
    real and imaginary parts apart (through the conjugate), recombined. S_in
    is the input's exact tracked scale (default: a CoeffToSlot output's);
    S_out the exact scale the output lands on (default params.scale)."""
    if S_in is None:
        S_in = _cts_scale(params, ct)
    conj = C.conjugate(params, cjk, ct)
    sc = 1.0 / (2.0 * c * (em.k + 1))
    S0 = em.work_scale(params)
    s_re = _smul_const(params, _SCt(C.add(ct, conj), S_in), sc, S0)
    s_im = _smul_const(params, _SCt(C.sub(ct, conj), S_in), sc * -1j, S0)
    w_re = _eval_mod_real_s(params, rlk, s_re, em, c, S_out)
    w_im = _eval_mod_real_s(params, rlk, s_im, em, c, S_out)
    return _sadd(w_re, _smul_const(params, w_im, 1j, w_re.S)).ct


# ---------------------------------------------------------------------------
# ModRaise + full bootstrap
# ---------------------------------------------------------------------------


def mod_raise(params: CkksParams, ct: CkksCiphertext) -> CkksCiphertext:
    """Exact embed of a bottom-level ciphertext into the full q-basis: from
    one source limb the approximate base extension (`rns.rs:331-345`) is
    exact, so the phase becomes c_centered + q0*I with small integer I. b
    and a are extended in one K-BASECONV launch (lq = 1), which writes the
    extension and q0's own limb into their rows in params.qs order (q0 need
    not be qs[0] in general)."""
    assert len(ct.qs) == 1, "mod_raise expects an exhausted (single-limb) ct"
    q0 = ct.qs[0]
    target = params.qs
    rest = tuple(q for q in target if q != q0)
    ba = torch.stack([ct.b, ct.a])
    out = torch.empty((*ba.shape[:-2], len(target), ba.shape[-1]), dtype=ba.dtype, device=ba.device)
    own = (target.index(q0),) if q0 in target else None
    base_convert(ba, (q0,), rest, out=out, rows=tuple(target.index(q) for q in rest), own=own)
    return CkksCiphertext(out[0], out[1], target)


def bootstrap(
    params: CkksParams,
    bk: BootstrapKey,
    rlk: CkksKeySwitchingKey,
    cjk: CkksKeySwitchingKey,
    ct: CkksCiphertext,
    em: EvalModParams = EvalModParams(),
    S_in: Fraction | None = None,
    S_out: Fraction | None = None,
) -> CkksCiphertext:
    """Full CKKS bootstrap: an exhausted ciphertext (basis (q0,)) returns at
    a high level carrying the same message (approximately). S_in: the exact
    scale the input's message is encoded at (default params.scale); S_out:
    the exact scale the output lands on."""
    if S_in is None:
        S_in = Fraction(params.scale)
    q0 = ct.qs[0]
    c = float(q0 / S_in)  # slot units per q0 wrap
    raised = mod_raise(params, ct)
    slots = coeff_to_slot(bk, raised)
    cleaned = eval_mod(params, rlk, cjk, slots, em, c, S_in=S_in, S_out=S_out)
    return slot_to_coeff(bk, cleaned)
