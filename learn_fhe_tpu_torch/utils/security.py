"""Lattice-parameter security estimation (`learn_fhe_tpu/utils/security.py`),
host arithmetic only.

The HomomorphicEncryption.org standard tables (Albrecht et al.,
"Homomorphic Encryption Security Standard", 2018, Table 1: uniform-ternary
secret, classical attack costs from the lwe-estimator), interpolated
linearly in n between rows, the reported security rounded down:

- the tables give the MAXIMUM total modulus log2(Q) admissible at a ring
  dimension for a target security level;
- h-sparse secrets are weaker than uniform ternary at equal (n, Q) and the
  tables do not cover them: such an estimate carries `sparse_h` and a
  warning, never a certification;
- binary (torus) secrets take the ternary table as a close proxy.

The same numbers as the JAX package's module, which the CPU tests check.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# HomomorphicEncryption.org standard, Table 1 (uniform ternary secret,
# classical cost model): n -> {security_bits: max log2(Q)}.
_HES_TERNARY_CLASSICAL: dict[int, dict[int, int]] = {
    1024: {128: 27, 192: 19, 256: 14},
    2048: {128: 54, 192: 37, 256: 29},
    4096: {128: 109, 192: 75, 256: 58},
    8192: {128: 218, 192: 152, 256: 118},
    16384: {128: 438, 192: 305, 256: 237},
    32768: {128: 881, 192: 611, 256: 476},
}

_LEVELS = (256, 192, 128)


def _max_log_q(n: int, level: int) -> float:
    """Largest admissible log2(Q) at ring dimension n for `level`-bit
    security, interpolating the standard's rows linearly in n."""
    rows = sorted(_HES_TERNARY_CLASSICAL)
    if n <= rows[0]:
        # extrapolate down proportionally (admissible modulus ~ linear in n);
        # this stays conservative because the true curve is slightly convex
        return _HES_TERNARY_CLASSICAL[rows[0]][level] * (n / rows[0])
    for lo, hi in zip(rows, rows[1:]):
        if n <= hi:
            f = (n - lo) / (hi - lo)
            a = _HES_TERNARY_CLASSICAL[lo][level]
            b = _HES_TERNARY_CLASSICAL[hi][level]
            return a + f * (b - a)
    # extrapolate up proportionally from the last row
    return _HES_TERNARY_CLASSICAL[rows[-1]][level] * (n / rows[-1])


@dataclass(frozen=True)
class SecurityEstimate:
    n: int
    log_q: float
    security_bits: float  # conservative classical estimate, ternary secret
    level: int | None  # highest standard level met (256/192/128), or None
    sparse_h: int | None = None  # set when the key is h-sparse (see warning)

    @property
    def warning(self) -> str | None:
        if self.sparse_h is not None:
            return (
                f"secret is {self.sparse_h}-sparse: the HES standard tables "
                "assume uniform ternary keys and hybrid attacks on sparse "
                "keys are strictly stronger — treat security_bits as an "
                "UPPER bound and run the external lattice-estimator"
            )
        return None

    def meets(self, target: int = 128) -> bool:
        return self.sparse_h is None and self.security_bits >= target


def estimate(n: int, log_q: float, *, h: int | None = None) -> SecurityEstimate:
    """Conservative classical security estimate for an RLWE instance with
    ring dimension n, total modulus log2(Q)=log_q, uniform ternary secret.
    Pass h for an h-sparse key: the figure is then only an upper bound and
    the estimate carries a warning (see module docstring)."""
    level = None
    for lv in _LEVELS:
        if log_q <= _max_log_q(n, lv):
            level = lv
            break
    if level is None:
        # below 128-bit: scale the 128-bit row's headroom into a bit count.
        # security falls roughly linearly as log_q grows past the bound.
        bound = _max_log_q(n, 128)
        bits = 128.0 * bound / log_q if log_q > 0 else float("inf")
    else:
        # inside a level: interpolate toward the next-stronger level's bound
        stronger = {128: 192, 192: 256}.get(level)
        if stronger is None:
            bits = float(level)
        else:
            b_here, b_up = _max_log_q(n, level), _max_log_q(n, stronger)
            f = (b_here - log_q) / max(b_here - b_up, 1e-9)
            bits = level + min(max(f, 0.0), 1.0) * (stronger - level)
    return SecurityEstimate(n=n, log_q=float(log_q), security_bits=round(bits, 1),
                            level=level, sparse_h=h)


def ckks_estimate(params, *, h: int | None = None) -> SecurityEstimate:
    """Security of a CkksParams instance: the RLWE instance the keys live in
    uses the FULL QP modulus (hybrid key-switching keys are encrypted under
    Q*P — `ckks.rs:154-162` — so QP is the binding modulus)."""
    log_qp = sum(math.log2(q) for q in params.qps)
    return estimate(params.n, log_qp, h=h)


def rlwe_estimate(params) -> SecurityEstimate:
    """Security of a FHEW RlweParams instance (single modulus q)."""
    return estimate(1 << params.log_n, math.log2(params.q))


def lwe_estimate(n: int, log_q: float) -> SecurityEstimate:
    """Plain-LWE estimate via the same table: the standard's rows are stated
    for RLWE dimension n but apply to LWE at equal dimension/modulus."""
    return estimate(n, log_q)
