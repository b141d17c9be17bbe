"""CKKS "special FFT" in powers-of-5 order (Algorithm 1 of eprint 2018/1043;
reference `scheme/ckks/src/sfft.rs`), on the host in double-double or 256-bit
fixed point (`learn_fhe_tpu/models/ckks/sfft.py`).

sfft: coefficients -> slot evaluations at zeta^{5^j}; sifft its inverse.
sfft_fmats/sifft_fmats: the factorization of the (inverse) decode matrix into
log N sparse-diagonal factors (V_0 of eprint 2018/1073), consumed by the
homomorphic CoeffToSlot/SlotToCoeff (`bootstrapping.py`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from ...ops.ntt import bit_reverse_indices
from ...utils.dd import DDC, cis_dd_at
from ...utils.matrix import mat_inv


@lru_cache(maxsize=None)
def _pow5(n: int) -> tuple[int, ...]:
    """5^j mod 4n for j in 0..n (`sfft.rs:60-64`)."""
    out, acc = [], 1
    for _ in range(n):
        out.append(acc)
        acc = acc * 5 % (4 * n)
    return tuple(out)


@lru_cache(maxsize=None)
def w_dd(n: int, conj: bool = False) -> DDC:
    """Twiddles cis(pi * (+-5^j mod 4n) / (2n)) for j in 0..n/2
    (`sfft.rs:39-72`): the JAX package's entries of cis_table_dd(2n, 4n),
    made only where they are read (an eighth of the table)."""
    pow5 = _pow5(n)
    idx = [((-p) % (4 * n)) if conj else (p % (4 * n)) for p in pow5[: n // 2]]
    return cis_dd_at(2 * n, idx)


@lru_cache(maxsize=None)
def w_fp(n: int, conj: bool = False):
    """Same twiddles in the 256-bit fixed-point backend (utils/f256.py)."""
    from ...utils.f256 import cis_table_fp

    table = cis_table_fp(2 * n, 4 * n)
    pow5 = _pow5(n)
    idx = [((-p) % (4 * n)) if conj else (p % (4 * n)) for p in pow5[: n // 2]]
    return table[np.array(idx)]


def _w_for(z, n: int, conj: bool = False):
    """Pick the twiddle table matching z's precision backend."""
    if isinstance(z, DDC):
        return w_dd(n, conj)
    return w_fp(n, conj)


def sfft(z):
    """Normal -> evaluation order (Alg 1 of 2018/1043, `sfft.rs:7-19`).
    Backend-generic: works on DDC (double-double) or FPC (256-bit)."""
    n = len(z)
    assert n & (n - 1) == 0
    z = z[np.asarray(bit_reverse_indices(n))]  # identity for n <= 2
    log_n = n.bit_length() - 1
    for log_m in range(log_n):
        m = 1 << log_m
        w = _w_for(z, 2 * m)
        x = z
        # chunks of 2m: reshape views via fancy indexing
        a_idx = (np.arange(n).reshape(-1, 2 * m)[:, :m]).ravel()
        b_idx = (np.arange(n).reshape(-1, 2 * m)[:, m:]).ravel()
        a = x[a_idx]
        b = x[b_idx]
        t = w.tile(n // (2 * m))
        tb = t * b
        x[a_idx] = a + tb
        x[b_idx] = a - tb
        z = x
    return z


def sifft(z):
    """Evaluation -> normal order, inverse (`sfft.rs:21-35`).
    Backend-generic: works on DDC (double-double) or FPC (256-bit)."""
    n = len(z)
    assert n & (n - 1) == 0
    z = z.copy()
    log_n = n.bit_length() - 1
    for log_m in reversed(range(log_n)):
        m = 1 << log_m
        w = _w_for(z, 2 * m, conj=True)
        a_idx = (np.arange(n).reshape(-1, 2 * m)[:, :m]).ravel()
        b_idx = (np.arange(n).reshape(-1, 2 * m)[:, m:]).ravel()
        a = z[a_idx]
        b = z[b_idx]
        t = w.tile(n // (2 * m))
        z[a_idx] = a + b
        z[b_idx] = (a - b) * t
    z = z[np.asarray(bit_reverse_indices(n))]
    return z.scale_pow2(-log_n)


def sfft_fmats(n: int) -> list[dict[int, DDC]]:
    """Sparse-diagonal factorization of the sfft matrix (V_0 of 2018/1073,
    `sfft.rs:75-94`): log n factors, each a dict offset -> diagonal."""
    assert n & (n - 1) == 0
    log_n = n.bit_length() - 1
    mats = []
    for log_k in range(log_n):
        m = 1 << (log_n - 1 - log_k)
        w = w_dd(2 * m)
        one = DDC.from_f64(np.ones(m))
        zero = DDC.zeros(m)
        diag_zero = one.concat(-w).tile(n // (2 * m))
        if log_k == 0:
            diag_neg = w.concat(one).tile(n // (2 * m))
            mats.append({0: diag_zero, (n - m) % n: diag_neg})
        else:
            diag_neg = zero.concat(one).tile(n // (2 * m))
            diag_pos = w.concat(zero).tile(n // (2 * m))
            mats.append({0: diag_zero, n - m: diag_neg, m: diag_pos})
    return mats


def sifft_fmats(n: int) -> list[dict[int, DDC]]:
    """Inverses of the reversed factors (`sfft.rs:97-99`)."""
    return [mat_inv(m, n) for m in reversed(sfft_fmats(n))]
