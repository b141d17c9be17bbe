"""Host-side CRT (big-integer) reconstruction and decomposition
(`learn_fhe_tpu/utils/crt.py`).

Mirrors `Rns::reconstruct` / `RnsRq::{from_bigint,into_bigint}`
(`util/src/ring/rns.rs:61-72,324-329`): exact Python-int arithmetic at the
encode/decode endpoints, off the device path. Residues are u64 numpy arrays.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .primes import mod_inverse


@lru_cache(maxsize=None)
def _crt_consts(qs: tuple[int, ...]):
    big_q = 1
    for q in qs:
        big_q *= q
    q_hats = [big_q // q for q in qs]
    q_hats_inv = [mod_inverse(h % q, q) for h, q in zip(q_hats, qs)]
    return big_q, q_hats, q_hats_inv


def rns_to_bigints(limbs: np.ndarray, qs: tuple[int, ...]) -> list[int]:
    """limbs: (L, N) u64 -> centered Python ints per coefficient
    (`rns.rs:324-329,354-365`)."""
    big_q, q_hats, q_hats_inv = _crt_consts(qs)
    limbs = np.asarray(limbs)
    out = []
    for j in range(limbs.shape[-1]):
        v = 0
        for i, q in enumerate(qs):
            v += q_hats[i] * (int(limbs[i, j]) * q_hats_inv[i] % q)
        v %= big_q
        if v >= big_q >> 1:
            v -= big_q
        out.append(v)
    return out


def bigints_to_rns(values: list[int], qs: tuple[int, ...], n: int | None = None) -> np.ndarray:
    """Python ints -> (L, N) u64 residues (floor mod, in int64 where every
    value fits, else per value)."""
    n = len(values) if n is None else n
    out = np.empty((len(qs), n), dtype=np.uint64)
    try:
        v = np.array(values[:n], dtype=np.int64)
    except OverflowError:
        v = np.array(values[:n], dtype=object)
    for i, q in enumerate(qs):
        out[i] = v % q
    return out
