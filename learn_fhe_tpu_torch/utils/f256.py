"""256-bit fixed-point complex vectors for the CKKS encode/decode endpoints
(`learn_fhe_tpu/utils/f256.py`).

The reference does its encode/decode math in F256, a 256-bit float wrapping
`astro_float::BigFloat` (`util/src/complex/f256.rs:15-19`), with C256 =
Complex<F256> (`util/src/complex.rs`). The fast default path here is the
double-double backend (`utils/dd.py`, ~106 significand bits), which covers
every reference test budget; this module is the drop-in *full-precision*
backend for when 106 bits is not enough (very large scales, precision-floor
measurements, parity experiments).

Representation: fixed point with F = 256 fractional bits, each component a
numpy object array of exact Python ints (value = int / 2**F).  All CKKS
encode inputs/outputs are O(1)-magnitude slot values and O(2**log_qi·L)
integers, so fixed point at 256 fractional bits strictly dominates a 256-bit
*float* mantissa throughout the encode pipeline (no exponent underflow in
range, every add exact, each mul rounds once at 2^-256).  Twiddles come from
mpmath at 320-bit working precision.

Host-only by design — the reference's F256 is likewise never touched by the
homomorphic hot path (SURVEY.md §7.1 "Host/NumPy is allowed only where the
reference itself is host-ish").
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

F_BITS = 256
_ONE = 1 << F_BITS
_HALF = 1 << (F_BITS - 1)


def _round_shift(v: int, k: int) -> int:
    """Round-to-nearest (half-up) of v / 2**k, exact in Python ints."""
    if k <= 0:
        return v << (-k)
    return (v + (1 << (k - 1))) >> k


def _f2fp(x: float) -> int:
    """Exact float -> fixed-point int (floats are dyadic rationals)."""
    num, den = float(x).as_integer_ratio()
    # den is a power of two; num * 2^F / den is exact whenever den <= 2^F
    if den <= _ONE:
        return num * (_ONE // den)
    return _round_shift(num, den.bit_length() - 1 - F_BITS)


_vec_f2fp = np.frompyfunc(_f2fp, 1, 1)
_vec_round = np.frompyfunc(lambda v: _round_shift(v, F_BITS), 1, 1)
_vec_float = np.frompyfunc(lambda v: float(v) / float(_ONE), 1, 1)


def _obj(a) -> np.ndarray:
    out = np.asarray(a, dtype=object)
    return out


class FPC:
    """Vectorized 256-bit fixed-point complex: two object arrays of ints."""

    __slots__ = ("re", "im")

    def __init__(self, re: np.ndarray, im: np.ndarray):
        self.re = _obj(re)
        self.im = _obj(im)

    # -- constructors ---------------------------------------------------------

    @classmethod
    def zeros(cls, shape) -> "FPC":
        return cls(np.full(shape, 0, dtype=object), np.full(shape, 0, dtype=object))

    @classmethod
    def from_complex(cls, z) -> "FPC":
        z = np.asarray(z, dtype=np.complex128)
        return cls(_vec_f2fp(z.real), _vec_f2fp(z.imag))

    @classmethod
    def from_ints(cls, re_ints, im_ints) -> "FPC":
        """Exact embed of integer sequences (any magnitude)."""
        re = _obj([int(v) << F_BITS for v in re_ints])
        im = _obj([int(v) << F_BITS for v in im_ints])
        return cls(re, im)

    # -- structure ------------------------------------------------------------

    @property
    def shape(self):
        return self.re.shape

    def __len__(self):
        return len(self.re)

    def __getitem__(self, idx) -> "FPC":
        return FPC(self.re[idx], self.im[idx])

    def __setitem__(self, idx, v: "FPC"):
        self.re[idx] = v.re
        self.im[idx] = v.im

    def copy(self) -> "FPC":
        return FPC(self.re.copy(), self.im.copy())

    def concat(self, other: "FPC") -> "FPC":
        return FPC(
            np.concatenate([self.re, other.re]), np.concatenate([self.im, other.im])
        )

    def roll(self, k: int) -> "FPC":
        return FPC(np.roll(self.re, k), np.roll(self.im, k))

    def tile(self, reps: int) -> "FPC":
        return FPC(np.tile(self.re, reps), np.tile(self.im, reps))

    # -- arithmetic (adds exact; one rounding per mul at 2^-256) --------------

    def __add__(self, o: "FPC") -> "FPC":
        return FPC(self.re + o.re, self.im + o.im)

    def __sub__(self, o: "FPC") -> "FPC":
        return FPC(self.re - o.re, self.im - o.im)

    def __neg__(self) -> "FPC":
        return FPC(-self.re, -self.im)

    def __mul__(self, o: "FPC") -> "FPC":
        ac = self.re * o.re
        bd = self.im * o.im
        ad = self.re * o.im
        bc = self.im * o.re
        return FPC(_vec_round(ac - bd), _vec_round(ad + bc))

    def conj(self) -> "FPC":
        return FPC(self.re, -self.im)

    def scale_pow2(self, k: int) -> "FPC":
        """Multiply by 2**k (k may be negative), round-to-nearest."""
        f = np.frompyfunc(lambda v: _round_shift(v, -k), 1, 1)
        return FPC(f(self.re), f(self.im))

    # scale_exact keeps DDC API parity for exactly-representable f64 scales
    def scale_exact(self, s: float) -> "FPC":
        m = (s).as_integer_ratio()
        num, den = m
        k = den.bit_length() - 1
        f = np.frompyfunc(lambda v: _round_shift(v * num, k), 1, 1)
        return FPC(f(self.re), f(self.im))

    def mul_int(self, s: int) -> "FPC":
        return FPC(self.re * int(s), self.im * int(s))

    def div_int(self, s: int) -> "FPC":
        s = int(s)
        h = s // 2
        f = np.frompyfunc(lambda v: (v + h) // s, 1, 1)
        return FPC(f(self.re), f(self.im))

    # -- conversion -----------------------------------------------------------

    def to_complex128(self) -> np.ndarray:
        return (_vec_float(self.re) + 1j * _vec_float(self.im)).astype(np.complex128)

    def round_to_ints(self) -> tuple[list[int], list[int]]:
        """Exact round-to-nearest of (re, im) to Python ints."""
        re = [_round_shift(int(v), F_BITS) for v in self.re.ravel()]
        im = [_round_shift(int(v), F_BITS) for v in self.im.ravel()]
        return re, im

    def trunc_to_ints(self) -> tuple[list[int], list[int]]:
        """Truncation toward zero — the reference's `BigInt::from(&F256)`
        semantics (`util/src/complex/f256.rs:213-238`: the mantissa is
        shifted with RoundingMode::None, no rounding step)."""
        t = lambda v: int(v) >> F_BITS if v >= 0 else -((-int(v)) >> F_BITS)
        return [t(v) for v in self.re.ravel()], [t(v) for v in self.im.ravel()]

    # -- precision accounting --------------------------------------------------

    def max_error_bits(self, o: "FPC") -> float:
        """log2 of the max |self - o| (fixed-point exact); -inf if equal."""
        d = self - o
        worst = 0
        for r, i in zip(d.re.ravel(), d.im.ravel()):
            worst = max(worst, abs(int(r)), abs(int(i)))
        if worst == 0:
            return float("-inf")
        return worst.bit_length() - F_BITS


@lru_cache(maxsize=None)
def cis_table_fp(denom: int, count: int) -> FPC:
    """cis(pi * j / denom) for j in 0..count, exact to 2^-256, via mpmath
    at 320-bit working precision (the reference caches the same table in
    F256, `scheme/ckks/src/sfft.rs:37-72`)."""
    import mpmath

    with mpmath.workprec(320):
        res, ims = [], []
        for j in range(count):
            x = mpmath.pi * j / denom
            res.append(int(mpmath.nint(mpmath.ldexp(mpmath.cos(x), F_BITS))))
            ims.append(int(mpmath.nint(mpmath.ldexp(mpmath.sin(x), F_BITS))))
    return FPC(_obj(res), _obj(ims))
