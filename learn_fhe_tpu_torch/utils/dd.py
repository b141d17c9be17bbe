"""Double-double (2x f64, ~106-bit) complex arithmetic, vectorized in numpy
(`learn_fhe_tpu/utils/dd.py`).

The reference does CKKS encode/decode in 256-bit floats (`util/src/complex/
f256.rs`, astro-float). Those endpoints are host work; what they need is
enough precision that encode/decode error stays far below the scheme's noise
(test budgets are 40/32/30 bits against a 55-bit scale). Double-double gives
~106 significand bits with fully vectorized f64 numpy ops -- two orders of
magnitude faster than a software MPFR and precise enough by >50 bits.
Twiddles are seeded from mpmath (exact to dd) once per size.

Error-free transforms: Dekker two_prod (no FMA assumed) + Knuth two_sum.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

_SPLIT = 134217729.0  # 2^27 + 1


def _two_sum(a, b):
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def _quick_two_sum(a, b):
    s = a + b
    err = b - (s - a)
    return s, err


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def _two_prod(a, b):
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    err = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, err


def dd_add(xh, xl, yh, yl):
    s, e = _two_sum(xh, yh)
    e = e + xl + yl
    return _quick_two_sum(s, e)


def dd_sub(xh, xl, yh, yl):
    return dd_add(xh, xl, -yh, -yl)


def dd_mul(xh, xl, yh, yl):
    p, e = _two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return _quick_two_sum(p, e)


def dd_div(xh, xl, yh, yl):
    q1 = xh / yh
    # r = x - q1*y
    ph, pl = dd_mul(q1, np.zeros_like(q1), yh, yl)
    rh, rl = dd_sub(xh, xl, ph, pl)
    q2 = rh / yh
    ph, pl = dd_mul(q2, np.zeros_like(q2), yh, yl)
    rh, rl = dd_sub(rh, rl, ph, pl)
    q3 = rh / yh
    s, e = _quick_two_sum(q1, q2)
    return dd_add(s, e, q3, np.zeros_like(q3))


@dataclass
class DDC:
    """Vectorized double-double complex: four f64 arrays."""

    re_h: np.ndarray
    re_l: np.ndarray
    im_h: np.ndarray
    im_l: np.ndarray

    # -- constructors ---------------------------------------------------------

    @classmethod
    def zeros(cls, shape) -> "DDC":
        z = np.zeros(shape)
        return cls(z.copy(), z.copy(), z.copy(), z.copy())

    @classmethod
    def from_f64(cls, re, im=None) -> "DDC":
        re = np.asarray(re, dtype=np.float64)
        im = np.zeros_like(re) if im is None else np.asarray(im, dtype=np.float64)
        return cls(re, np.zeros_like(re), im, np.zeros_like(im))

    @classmethod
    def from_complex(cls, z) -> "DDC":
        z = np.asarray(z, dtype=np.complex128)
        return cls.from_f64(z.real, z.imag)

    @classmethod
    def from_ints(cls, re_ints, im_ints) -> "DDC":
        """Exact embed of Python-int arrays (values up to ~2^106)."""
        re_h = np.array([float(v) for v in re_ints])
        re_l = np.array([float(v - int(h)) for v, h in zip(re_ints, re_h)])
        im_h = np.array([float(v) for v in im_ints])
        im_l = np.array([float(v - int(h)) for v, h in zip(im_ints, im_h)])
        return cls(re_h, re_l, im_h, im_l)

    # -- structure ------------------------------------------------------------

    @property
    def shape(self):
        return self.re_h.shape

    def __len__(self):
        return len(self.re_h)

    def __getitem__(self, idx) -> "DDC":
        return DDC(self.re_h[idx], self.re_l[idx], self.im_h[idx], self.im_l[idx])

    def __setitem__(self, idx, v: "DDC"):
        self.re_h[idx] = v.re_h
        self.re_l[idx] = v.re_l
        self.im_h[idx] = v.im_h
        self.im_l[idx] = v.im_l

    def copy(self) -> "DDC":
        return DDC(
            self.re_h.copy(), self.re_l.copy(), self.im_h.copy(), self.im_l.copy()
        )

    def concat(self, other: "DDC") -> "DDC":
        return DDC(
            np.concatenate([self.re_h, other.re_h]),
            np.concatenate([self.re_l, other.re_l]),
            np.concatenate([self.im_h, other.im_h]),
            np.concatenate([self.im_l, other.im_l]),
        )

    def roll(self, k: int) -> "DDC":
        return DDC(
            np.roll(self.re_h, k),
            np.roll(self.re_l, k),
            np.roll(self.im_h, k),
            np.roll(self.im_l, k),
        )

    def tile(self, reps: int) -> "DDC":
        return DDC(
            np.tile(self.re_h, reps),
            np.tile(self.re_l, reps),
            np.tile(self.im_h, reps),
            np.tile(self.im_l, reps),
        )

    # -- arithmetic -------------------------------------------------------------

    def __add__(self, o: "DDC") -> "DDC":
        rh, rl = dd_add(self.re_h, self.re_l, o.re_h, o.re_l)
        ih, il = dd_add(self.im_h, self.im_l, o.im_h, o.im_l)
        return DDC(rh, rl, ih, il)

    def __sub__(self, o: "DDC") -> "DDC":
        rh, rl = dd_sub(self.re_h, self.re_l, o.re_h, o.re_l)
        ih, il = dd_sub(self.im_h, self.im_l, o.im_h, o.im_l)
        return DDC(rh, rl, ih, il)

    def __neg__(self) -> "DDC":
        return DDC(-self.re_h, -self.re_l, -self.im_h, -self.im_l)

    def __mul__(self, o: "DDC") -> "DDC":
        # (a+bi)(c+di) = (ac - bd) + (ad + bc)i, each term in dd
        ac_h, ac_l = dd_mul(self.re_h, self.re_l, o.re_h, o.re_l)
        bd_h, bd_l = dd_mul(self.im_h, self.im_l, o.im_h, o.im_l)
        ad_h, ad_l = dd_mul(self.re_h, self.re_l, o.im_h, o.im_l)
        bc_h, bc_l = dd_mul(self.im_h, self.im_l, o.re_h, o.re_l)
        rh, rl = dd_sub(ac_h, ac_l, bd_h, bd_l)
        ih, il = dd_add(ad_h, ad_l, bc_h, bc_l)
        return DDC(rh, rl, ih, il)

    def conj(self) -> "DDC":
        return DDC(self.re_h, self.re_l, -self.im_h, -self.im_l)

    def scale_exact(self, s: float) -> "DDC":
        """Multiply by an exactly-representable f64 (e.g. powers of two)."""
        return DDC(self.re_h * s, self.re_l * s, self.im_h * s, self.im_l * s)

    def mul_dd_scalar(self, h: float, l: float) -> "DDC":
        rh, rl = dd_mul(self.re_h, self.re_l, np.float64(h), np.float64(l))
        ih, il = dd_mul(self.im_h, self.im_l, np.float64(h), np.float64(l))
        return DDC(rh, rl, ih, il)

    def div_dd_scalar(self, h: float, l: float) -> "DDC":
        hh = np.broadcast_to(np.float64(h), self.shape)
        ll = np.broadcast_to(np.float64(l), self.shape)
        rh, rl = dd_div(self.re_h, self.re_l, hh, ll)
        ih, il = dd_div(self.im_h, self.im_l, hh, ll)
        return DDC(rh, rl, ih, il)

    def scale_pow2(self, k: int) -> "DDC":
        """Multiply by 2**k exactly (backend-generic API shared with FPC)."""
        return self.scale_exact(2.0**k)

    def mul_int(self, s: int) -> "DDC":
        h, l = dd_scalar_from_int(int(s))
        return self.mul_dd_scalar(h, l)

    def div_int(self, s: int) -> "DDC":
        h, l = dd_scalar_from_int(int(s))
        return self.div_dd_scalar(h, l)

    # -- conversion ---------------------------------------------------------------

    def to_complex128(self) -> np.ndarray:
        return (self.re_h + self.re_l) + 1j * (self.im_h + self.im_l)

    def round_to_ints(self) -> tuple[list[int], list[int]]:
        """Exact round-to-nearest of (re, im) to Python ints."""

        def rnd(h, l):
            h, l = h.ravel(), l.ravel()
            if np.all(np.abs(h) < 2.0**62):  # the same steps in int64, half to even as round()
                n0 = np.rint(h)
                return (n0.astype(np.int64) + np.rint((h - n0) + l).astype(np.int64)).tolist()
            out = []
            for hh, lll in zip(h, l):
                n0 = int(round(hh))
                frac = (hh - n0) + lll
                out.append(n0 + int(round(frac)))
            return out

        return rnd(self.re_h, self.re_l), rnd(self.im_h, self.im_l)

    def trunc_to_ints(self) -> tuple[list[int], list[int]]:
        """Truncation toward zero (the reference's F256 -> BigInt semantics;
        see utils/f256.py:trunc_to_ints)."""

        def trc(h, l):
            out = []
            for hh, lll in zip(h.ravel(), l.ravel()):
                n0 = int(round(hh))
                frac = (hh - n0) + lll  # exact: |frac| < 1
                v = n0 + int(round(frac))
                r = (hh - v) + lll  # exact residual in (-1, 1)
                if v > 0 and r < 0:
                    v -= 1
                elif v < 0 and r > 0:
                    v += 1
                out.append(v)
            return out

        return trc(self.re_h, self.re_l), trc(self.im_h, self.im_l)


def dd_scalar_from_int(v: int) -> tuple[float, float]:
    """Exact dd representation of an integer up to ~2^106."""
    h = float(v)
    l = float(v - int(h))
    return h, l


@lru_cache(maxsize=None)
def cis_table_dd(denom: int, count: int) -> "DDC":
    """cis(pi * j / denom) for j in 0..count, exact to dd, via mpmath."""
    return cis_dd_at(denom, range(count))


def cis_dd_at(denom: int, js) -> "DDC":
    """cis(pi * j / denom) for each j of js, exact to dd, via mpmath: the
    entries of `cis_table_dd(denom, ...)` at js, value for value (each costs
    a 140-bit cosine and sine)."""
    import mpmath

    with mpmath.workprec(140):
        res, ims = [], []
        for j in js:
            x = mpmath.pi * j / denom
            c, s = mpmath.cos(x), mpmath.sin(x)
            res.append(c)
            ims.append(s)
        re_h = np.array([float(c) for c in res])
        re_l = np.array([float(c - mpmath.mpf(h)) for c, h in zip(res, re_h)])
        im_h = np.array([float(s) for s in ims])
        im_l = np.array([float(s - mpmath.mpf(h)) for s, h in zip(ims, im_h)])
    return DDC(re_h, re_l, im_h, im_l)
