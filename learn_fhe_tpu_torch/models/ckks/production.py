"""The production CKKS bootstrap configuration
(`learn_fhe_tpu/models/ckks/production.py`): secure, deep and fast at once.

Beyond the reference's pedagogical fixture (`scheme/ckks/src/ckks.rs:
303-345`), the configuration a deployment needs:

- a per-prime bit-width LADDER (CkksParams.log_qis): the EvalMod band's
  primes where its rescale noise wall needs them, cheaper primes at the
  transform and user levels;
- multi-digit hybrid key switching (CkksParams.dnum, Han-Ki eprint
  2019/688), so |P| is about alpha primes instead of |Q|, which is what
  brings the HES 128-bit bound within reach;
- a DENSE ternary secret (zo(0.5)), the only kind `utils/security.py`
  certifies; its mod-raise wrap bound K grows as sqrt(N) (h_eff ~ N/2).

N = 2^16 is the smallest ring hosting a certified bootstrap with >= 4 user
levels: at 2^15 the 881-bit bound leaves nothing past a dense-key EvalMod.
Its keys (38 rotation keys x 15 digits x 32 limbs x 2^16, about 19 GB) fit
the H100's 80 GB. The level simulator mirrors evalmod.py's scale-tracked
evaluator drop for drop, so a ladder is laid out without a ciphertext op.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import cached_property

import numpy as np

from ...utils.security import estimate
from .bootstrapping import BootstrapParams
from .ckks import CkksParams
from .evalmod import EvalModParams, cheb_split


# -- level-consumption simulator ------------------------------------------------
#
# Mirrors the exact drop structure of evalmod.py's scale-tracked evaluator
# (checked against the port's bootstrap in tests/test_torch_production.py).


def _t_depth(j: int, cache: dict) -> int:
    """Levels consumed below T_1 to build T_j (mirror of _ChebCtx.T)."""
    if j <= 1:
        return 0
    if j in cache:
        return cache[j]
    half = 1 << (j.bit_length() - 1)
    a, b = (half, j - half) if j != half else (half // 2, half // 2)
    d = max(_t_depth(a, cache), _t_depth(b, cache)) + 1
    cache[j] = d
    return d


def _eval_depth(coeffs: np.ndarray, baby: int, cache: dict) -> int:
    """Levels consumed by _ChebCtx.eval (mirror of _ChebCtx._level)."""
    coeffs = np.trim_zeros(np.asarray(coeffs, dtype=np.float64), "b")
    if len(coeffs) == 0:
        coeffs = np.zeros(1)
    big_d = len(coeffs) - 1
    if big_d < baby:
        ks = [k for k in range(1, big_d + 1) if coeffs[k] != 0.0] or [1]
        return max(_t_depth(k, cache) for k in ks) + 1  # const mul
    g = 1 << (big_d.bit_length() - 1)
    q, _ = cheb_split(coeffs, g)
    return max(_eval_depth(q, baby, cache), _t_depth(g, cache)) + 1


def cheb_levels(em: EvalModParams, baby: int = 8) -> int:
    """Levels one _eval_mod_real_s chain consumes below its input."""
    cache: dict = {}
    d = _eval_depth(em.cheb_coeffs, baby, cache)
    d += em.r  # double-angle squarings
    d += 3 if em.arcsin else 1  # arcsine factorization vs final const mul
    return d


def eval_mod_levels(em: EvalModParams, baby: int = 8) -> int:
    """Total levels eval_mod consumes: the s_re/s_im scale-correction const
    mul, the (parallel) real chains, and the 1j recombination mul."""
    return 1 + cheb_levels(em, baby) + 1


def wrap_bound(h: int, sigma_mult: float = 6.0) -> int:
    """Mod-raise wrap count bound K for a ternary key with Hamming weight h:
    each phase coefficient of a*sk is a sum of h uniform (-q0/2, q0/2) terms
    (std q0*sqrt(h/12)), so |I| <= sigma_mult * sqrt(h/12) per coefficient
    except with probability ~erfc(sigma_mult/sqrt(2)) per coefficient."""
    return max(4, math.ceil(sigma_mult * math.sqrt(h / 12.0)))


# -- the production configuration ------------------------------------------------


@dataclass(frozen=True)
class ProductionConfig:
    """A fully-specified bootstrap deployment at the HES 128-bit bound."""

    log_n: int = 16
    user_levels: int = 4  # levels usable AFTER the bootstrap returns
    # The r05 RETUNE (ARCHITECTURE §22): the measured noise wall lives in
    # the ops at the LOW user/q0 landing scale, so the user band moved up
    # to 52 bits (sweep: +6.09 bits at N=2^10) and the q0/user gap
    # tightened to 3 (every gap bit is a precision bit; 3 bits still buys
    # |m| <= 4 headroom, 13x above the amp-0.3 spec's max |m| ~ 1.05).
    # Raising the landing scale also FLATTENS the ring-size slope from
    # 1.68 to 0.5 bits/log_n-step (measured N=2^10 vs 2^12), which is what
    # makes >= 20 bits reachable at N=2^16 at all.
    log_q0: int = 55
    # EvalMod-band prime size: the response is a KINK at 58 (em60 measured
    # -3.66 bits, em56 +0.31) — 56 is on the flat side and its 38 saved
    # ladder bits are what fit the raised user band inside HES-128.
    log_em: int = 56
    log_mid: int = 52  # CtS/StC transform-band prime size
    log_user: int = 52  # user-band prime size (the post-bootstrap levels)
    log_p: int = 59  # aux primes
    alpha: int = 2  # primes per key-switch digit (P = alpha log_p-bit primes)
    chunk_r: int = 5  # sfft factors pre-multiplied per CtS/StC chunk
    dense_h: int | None = None  # None = h_eff of zo(0.5) = N/2
    sigma_mult: float = 6.0
    arcsin: bool = True
    cheb_degree: int = 30
    baby: int = 8
    # Overrides for the precision-model sensitivity sweeps (precision.py):
    # pin the double-angle count / wrap bound instead of deriving them.
    force_r: int | None = None
    force_k: int | None = None

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def h(self) -> int:
        # zo(0.5): nonzero with probability 1/2
        return self.dense_h if self.dense_h is not None else self.n // 2

    @cached_property
    def em(self) -> EvalModParams:
        k = self.force_k if self.force_k is not None else wrap_bound(
            self.h, self.sigma_mult
        )
        # double-angle count: scale the cosine argument down until the
        # Chebyshev band (k+1)/2^r covers at most ~2 periods, keeping the
        # interpolation degree flat as K grows with dense keys
        r = (
            self.force_r
            if self.force_r is not None
            else max(3, math.ceil(math.log2((k + 1) / 2.0)))
        )
        return EvalModParams(
            k=k,
            r=r,
            degree=self.cheb_degree,
            arcsin=self.arcsin,
            log_work_scale=self.log_em,
        )

    @property
    def n_transform(self) -> int:
        """Rescales per linear half (CtS or StC): one per factor chunk."""
        log_l = self.log_n - 1
        return -(-log_l // self.chunk_r)

    @cached_property
    def ladder(self) -> tuple[int, ...]:
        """Prime bit widths bottom -> top: q0 | user | StC | EvalMod | CtS.
        rescale drops from the TOP, and the pipeline runs CtS first, so the
        stage order reverses along the ladder."""
        n_em = eval_mod_levels(self.em, self.baby)
        return (
            (self.log_q0,)
            + (self.log_user,) * self.user_levels
            + (self.log_mid,) * self.n_transform  # StC band
            + (self.log_em,) * n_em
            + (self.log_mid,) * self.n_transform  # CtS band
        )

    @cached_property
    def params(self) -> CkksParams:
        ladder = self.ladder
        big_l = len(ladder)
        # P within ~2 bits of the largest digit product keeps the hybrid
        # key-switch noise at sqrt(dnum*N)*sigma*Q_d/P ~ 2^12 absolute —
        # negligible against the >= 2^40 running scales
        assert self.log_p * self.alpha + 2 >= max(ladder) * self.alpha - (
            2 * self.alpha
        )
        return CkksParams(
            log_n=self.log_n,
            log_qi=self.log_em,
            big_l=big_l,
            log_qis=ladder,
            log_ps=(self.log_p,) * self.alpha,
            dnum=-(-big_l // self.alpha),
        )

    @cached_property
    def bootstrap_params(self) -> BootstrapParams:
        return BootstrapParams(self.params, r=self.chunk_r)

    def security(self):
        """HES-standard estimate of the FULL key-switching modulus QP with
        the dense ternary secret — the instance every key in the deployment
        lives in."""
        log_qp = sum(math.log2(q) for q in self.params.qps)
        return estimate(self.n, log_qp)

    def summary(self) -> dict:
        est = self.security()
        return {
            "log_n": self.log_n,
            "levels_total": len(self.ladder),
            "user_levels": self.user_levels,
            "eval_mod_levels": eval_mod_levels(self.em, self.baby),
            "k_wraps": self.em.k,
            "double_angles": self.em.r,
            "ladder": self.ladder,
            "log_qp": round(sum(math.log2(q) for q in self.params.qps), 1),
            "security_bits": est.security_bits,
            "meets_128": est.meets(128),
        }


def production_config(log_n: int = 16, **kw) -> ProductionConfig:
    cfg = ProductionConfig(log_n=log_n, **kw)
    est = cfg.security()
    assert est.meets(128), (
        f"config breaks the HES 128-bit bound: {est.security_bits} bits at "
        f"log_qp={sum(math.log2(q) for q in cfg.params.qps):.0f}, N=2^{log_n}"
    )
    return cfg
