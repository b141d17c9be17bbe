"""The empirical precision model of the production ladder bootstrap
(`learn_fhe_tpu/models/ckks/precision.py`): predicted output bits as a
function of the configuration's knobs (K, r, working-scale bits, q0/user
gap, ring size), calibrated against measured ladder bootstrap runs and
refusing predictions where a calibration residual passes VALIDATION_TOL.

One deliberate divergence from the JAX package: `em_gain_evalmod_regime`
takes the starting em as an optional keyword and then raises ValueError
where the target passes EM_PEAK (the measured em response peaks there);
without it the function is the JAX package's.

Model form (bits, higher = better):

    bits(cfg) = C0
              - S_RING * (log_n - 13)        # ring+key+wrap growth along the
                                             #   production family (K ~ sqrt(N)
                                             #   is collinear with log_n, so
                                             #   the family slope absorbs it)
              - A_R * (r - r_family(log_n))  # extra double-angles vs family
              + em_term(log_em)              # KINK at 58: S_EM_UP*(em-58)
                                             #   above, S_EM_DN*(58-em) below
              - S_GAP * (log_q0 - log_user - 5)  # q0/user gap bits
              + U52 * max(0, min(log_user, 52) - 40) / 12  # low-scale-op relief

The constants are fitted in `fit()` from the MEASURED table and the module
refuses predictions when the residual on any calibration point exceeds
VALIDATION_TOL bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# -- measured calibration data (see ARCHITECTURE §20/§22 for provenance) -----
#
# Family probes: bench/production_bootstrap_probe.py --log-n {10,11,12,13},
# defaults (amp 0.3, user_levels 4 except 2^13 r04 run), CPU, 2026-08-20.
# Each entry: (log_n, r, K, log_em, gap_bits, log_user, measured_bits)
FAMILY_RUNS = [
    (10, 5, 40, 58, 5, 40, 22.8),
    (11, 5, 56, 58, 5, 40, 21.3),
    (12, 6, 79, 58, 5, 40, 18.9),
    (13, 6, 111, 58, 5, 40, 17.9),
]

# Sensitivity sweep at log_n=10 (bench/precision_sweep.py --log-n 10,
# 2026-08-20). The ring matters: at log_n=6 the arcsin-quintic MODEL FLOOR
# (~23-25 bits, scale-invariant) binds instead of the noise wall, so knob
# deltas measured there are contaminated; N=2^10 (wall ~23 vs floor ~29) is
# the smallest noise-bound sweep ring. Measured one-knob deltas vs base:
#
#   base   (em58, gap5, user40):       23.09 bits
#   user52 (log_user 52, log_q0 57):   29.18 bits  (+6.09 — the noise wall
#          is dominated by ops at the LOW user/q0 landing scale, not the
#          58-bit EvalMod chain)
#   em60   (log_em 60):                19.43 bits  (-3.66 — BIGGER EvalMod
#          primes LOSE: the EvalMod band's rescale rounding is proportional
#          to the prime size while the coefficient amplitude is fixed, so
#          raising log_em raises the wall faster than it raises headroom)
#   em56   (log_em 56):                23.40 bits  (+0.31 — the response is
#          a KINK, not a line: at 58 the em-band rescale term is already
#          below the dominant landing-scale noise, so lowering buys almost
#          nothing while raising costs ~1.8 bits/bit)
SWEEP_RUNS = [
    ("base", 23.09),
    ("user52", 29.18),
    ("em60", 19.43),
    ("em56", 23.40),
]
SWEEP_BASE_BITS: float | None = None  # set by record_sweep()
SWEEP_DELTAS: dict[str, float] = {}

# Retuned-family probes (the r05 flagship knobs: user52 + gap3 + em56,
# 2026-08-20): bench/production_bootstrap_probe.py / production_stage_probe
# --log-user 52 --log-q0 55 [--log-em ..]. MEASURED bootstrap bits:
#
#   N=2^10: 25.6 (user_levels=4; 23.0 after 4 user squarings)
#   N=2^12: 24.6 (user_levels=4; 22.6 after squarings)
#   N=2^14: 20.43 (stage probe, user_levels=2)
#   N=2^16: 15.7  (user_levels=4; 14.1 after squarings) — FAIL vs >= 20
#
# TWO REGIMES, not one slope. Below ~2^12 the landing-scale noise binds
# and the user52 lift flattens the slope to 0.5 bits/log_n; above 2^12
# EvalMod's internally-generated error takes over (own-error attribution:
# CtS/StC are exact at 41/31 bits, EvalMod binds at every ring >= 2^12)
# and the slope steepens to 2.1-2.35 bits/step, consistent with
#
#     err_evalmod ∝ 4^r * (K+1) * sqrt(N) * 2^-log_em
#
# (per-squaring rescale rounding at the em working scale, amplified by the
# r double-angles, the c*(K+1) output scaling, and sqrt(N) accumulation).
# Measured knob response IN THIS REGIME: em56 -> em58 at 2^14 = +1.94
# end-to-end bits (+0.95/bit — the em sign FLIPS vs the landing-bound
# ring10 sweep where em60 lost 3.66). The 0.5-slope extrapolation from
# the first two rings predicted 22.6 at 2^16 and measured 15.7 — the
# two-ring extrapolation is recorded here as a calibration failure; any
# flagship claim must rest on an EXECUTED run at the target ring
# (PRODUCTION_r05.json is the ledger).
RETUNED_RUNS = [
    (10, 25.6),
    (12, 24.6),
    (14, 20.43),
    (16, 15.7),
]

# Flagship attempts at the target ring N=2^16 (full user_levels=4 runs,
# PRODUCTION_r05.json): (chunk_r, log_em, log_p, measured_bits). Attempt 2
# VALIDATED the in-regime em slope at the target ring itself — predicted
# 15.7 + EM_SLOPE_EVALMOD*4 = 19.4, measured 19.6 (+0.2) — and showed
# chunk_r is precision-NEUTRAL (CtS/StC own-errors are exact; only the
# ladder bits it frees matter).
FLAGSHIP_ATTEMPTS_N16 = [
    (5, 56, 59, 15.7),
    (8, 60, 60, 19.6),
]
EM_SLOPE_EVALMOD = 0.93  # bits per em bit, validated 56->60 at N=2^16

# ...but the slope is only linear while rescale noise dominates: the em
# response PEAKS near 60. Measured em family at N=2^14 (stage probes,
# user_levels=2): 56 -> 20.43, 58 -> 22.37, 60 -> 24.15, 61 -> 23.36.
# At em61 EvalMod's own error (2.27e-09) is within 2x of the
# em-INDEPENDENT approximation floor (1.28e-09, the degree-30 arcsin
# Chebyshev truncation), so pushing em past 60 buys nothing and a growing
# em-proportional term costs ~0.8 bits. This falsified the em61@chunk8
# flagship prescription (predicted 20.5) before a 3 h target-ring run —
# use EM_PEAK, not the linear slope, for any config at em >= 60. The
# remaining lever at the target ring is the floor itself (degree/arcsin),
# which costs ~1 EvalMod level the HES-128 budget only affords via
# alpha=1 (net predicted ~0-2 bits; unexecuted).
EM_PEAK = 60
EM14_FAMILY = [(56, 20.43), (58, 22.37), (60, 24.15), (61, 23.36)]


def retuned_bits(log_n: int) -> float:
    """MEASURED bootstrap bits of the retuned flagship family (linear
    interpolation between measured rings; no extrapolation beyond them)."""
    xs = [n for n, _ in RETUNED_RUNS]
    ys = [b for _, b in RETUNED_RUNS]
    if not xs[0] <= log_n <= xs[-1]:
        raise ValueError(
            f"log_n {log_n} outside the measured retuned family "
            f"[{xs[0]}, {xs[-1]}] — run the probe, don't extrapolate"
        )
    import numpy as _np

    return float(_np.interp(log_n, xs, ys))


def em_gain_evalmod_regime(d_em_bits: float, *, from_em: float | None = None) -> float:
    """Measured em response where EvalMod binds (rings >= ~2^13):
    +0.95 bits per em bit (em56 -> em58 at 2^14).

    The slope is linear only up to EM_PEAK (EM14_FAMILY: em61 lost 0.79
    bits against em60). Given the starting em (`from_em`), a move whose
    target passes EM_PEAK raises ValueError, as `retuned_bits` refuses to
    extrapolate; without it the slope applies unguarded, as in the JAX
    package (`learn_fhe_tpu/models/ckks/precision.py:151`)."""
    if from_em is not None and from_em + d_em_bits > EM_PEAK:
        raise ValueError(
            f"em {from_em} -> {from_em + d_em_bits} passes EM_PEAK = {EM_PEAK}: "
            "the linear em slope does not hold there (EM14_FAMILY)"
        )
    return 0.95 * d_em_bits

VALIDATION_TOL = 1.2  # bits


def r_family(log_n: int, sigma_mult: float = 6.0) -> int:
    """The double-angle count the production family derives at log_n
    (production.py: K = 6*sqrt(h/12), h = N/2, r = ceil(log2((K+1)/2)))."""
    h = (1 << log_n) // 2
    k = max(4, math.ceil(sigma_mult * math.sqrt(h / 12.0)))
    return max(3, math.ceil(math.log2((k + 1) / 2.0)))


@dataclass(frozen=True)
class PrecisionModel:
    c0: float  # bits at the (log_n=13, family-r, em58, gap5, user40) anchor
    s_ring: float  # bits lost per log_n step along the family
    a_r: float  # bits lost per extra double-angle at fixed ring
    s_em_up: float  # bits LOST per em bit above 58 (measured -1.83/bit)
    s_em_dn: float  # bits gained per em bit below 58 (measured +0.155/bit)
    s_gap: float  # bits lost per q0/user gap bit
    u52: float  # bits gained raising log_user 40 -> 52 (low-scale-op relief)

    def predict(
        self,
        log_n: int,
        r: int | None = None,
        log_em: int = 58,
        log_q0: int = 45,
        log_user: int = 40,
    ) -> float:
        r = r if r is not None else r_family(log_n)
        gap = log_q0 - log_user
        # the em response is a KINK at 58 (measured: em60 -3.66, em56 +0.31)
        em_term = (
            self.s_em_up * (log_em - 58)
            if log_em >= 58
            else self.s_em_dn * (58 - log_em)
        )
        return (
            self.c0
            - self.s_ring * (log_n - 13)
            - self.a_r * (r - r_family(log_n))
            + em_term
            - self.s_gap * (gap - 5)
            + self.u52 * max(0.0, min(log_user, 52) - 40) / 12.0
        )

    def residuals(self) -> list[tuple[str, float]]:
        out = []
        for log_n, r, _k, em, gap, lu, bits in FAMILY_RUNS:
            pred = self.predict(log_n, r=r, log_em=em, log_q0=lu + gap, log_user=lu)
            out.append((f"family_n{log_n}", pred - bits))
        return out

    def validated(self) -> bool:
        return all(abs(d) <= VALIDATION_TOL for _, d in self.residuals())


def fit(
    a_r: float | None = None,
    s_em_up: float | None = None,
    s_em_dn: float | None = None,
    s_gap: float | None = None,
    u52: float | None = None,
) -> PrecisionModel:
    """Fit the ring slope + anchor from the family runs (least squares along
    log_n, using each run's actual r), taking the knob slopes from the
    measured sweep deltas (or explicit overrides)."""
    a_r = a_r if a_r is not None else _slope_from_sweep("r+1", "r+2", default=1.15)
    up = SWEEP_DELTAS.get("em60")
    s_em_up = s_em_up if s_em_up is not None else (up / 2.0 if up is not None else -1.0)
    dn = SWEEP_DELTAS.get("em56")
    s_em_dn = s_em_dn if s_em_dn is not None else (dn / 2.0 if dn is not None else 0.0)
    s_gap = s_gap if s_gap is not None else _gap_slope(default=1.0)
    u52 = u52 if u52 is not None else SWEEP_DELTAS.get("user52", 0.0)

    # family: bits + a_r*(r - r_family) = c0 - s_ring*(log_n - 13)
    xs, ys = [], []
    for log_n, r, _k, _em, _gap, _lu, bits in FAMILY_RUNS:
        xs.append(log_n - 13)
        ys.append(bits + a_r * (r - r_family(log_n)))
    n = len(xs)
    mx, my = sum(xs) / n, sum(ys) / n
    s_ring = -sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / sum(
        (x - mx) ** 2 for x in xs
    )
    c0 = my + s_ring * mx  # anchor at x = 0 (log_n = 13)
    return PrecisionModel(
        c0=c0, s_ring=s_ring, a_r=a_r, s_em_up=s_em_up, s_em_dn=s_em_dn,
        s_gap=s_gap, u52=u52,
    )


def _slope_from_sweep(k1: str, k2: str, default: float) -> float:
    d1, d2 = SWEEP_DELTAS.get(k1), SWEEP_DELTAS.get(k2)
    if d1 is None:
        return default
    if d2 is None:
        return -d1
    return -(d1 + d2 / 2.0) / 2.0  # average per-step loss over +1/+2


def _gap_slope(default: float) -> float:
    g3, g7 = SWEEP_DELTAS.get("gap3"), SWEEP_DELTAS.get("gap7")
    vals = []
    if g3 is not None:
        vals.append(g3 / 2.0)
    if g7 is not None:
        vals.append(-g7 / 2.0)
    return sum(vals) / len(vals) if vals else default


def record_sweep(records: list[dict]) -> None:
    """Ingest bench/precision_sweep.py JSON lines: sets SWEEP_BASE_BITS and
    the per-variant deltas."""
    global SWEEP_BASE_BITS
    base = next(r for r in records if r.get("variant") == "base")
    SWEEP_BASE_BITS = base["bits"]
    for r in records:
        if "bits" in r and r["variant"] != "base":
            SWEEP_DELTAS[r["variant"]] = r["bits"] - base["bits"]


# default-populate from the committed N=2^10 sweep table
record_sweep([{"variant": n, "bits": b} for n, b in SWEEP_RUNS])
