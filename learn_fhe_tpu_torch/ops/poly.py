"""Negacyclic polynomial structure ops: automorphism, monomial multiplication
and extraction (`learn_fhe_tpu/ops/poly.py`), on the trailing coefficient
axis, broadcasting over leading batch axes. Mod-q values are int64 (or int32
residues) in [0, q); torus values are int64 bit patterns."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .modular import neg_mod


@lru_cache(maxsize=None)
def automorphism_map(n: int, t: int) -> tuple[np.ndarray, np.ndarray]:
    """Gather map for X -> X^t on Z[X]/(X^n+1): out[k] = -in[src[k]] where
    sign_neg[k], else in[src[k]] (`avec.rs:34-50`). t must be odd."""
    t = t % (2 * n)
    assert t % 2 == 1, "automorphism exponent must be odd"
    it = (np.arange(n) * t) % (2 * n)
    src = np.zeros(n, dtype=np.int64)
    sign_neg = np.zeros(n, dtype=bool)
    src[np.where(it < n, it, it - n)] = np.arange(n)
    sign_neg[np.where(it < n, it, it - n)] = it >= n
    return src, sign_neg


def automorphism_zq(a: torch.Tensor, t: int, q: int) -> torch.Tensor:
    """X -> X^t on a mod-q polynomial."""
    src, sign_neg = automorphism_map(a.shape[-1], t)
    gathered = a[..., torch.from_numpy(src).to(a.device)]
    return torch.where(torch.from_numpy(sign_neg).to(a.device), neg_mod(gathered, q), gathered)


def automorphism_t64(a: torch.Tensor, t: int) -> torch.Tensor:
    """X -> X^t on a torus polynomial (wrapping negation)."""
    src, sign_neg = automorphism_map(a.shape[-1], t)
    gathered = a[..., torch.from_numpy(src).to(a.device)]
    return torch.where(torch.from_numpy(sign_neg).to(a.device), -gathered, gathered)


def automorphism_i64(a: np.ndarray, t: int) -> np.ndarray:
    """Host automorphism of a signed coefficient vector (key generation)."""
    src, sign_neg = automorphism_map(a.shape[-1], t)
    out = a[..., src].copy()
    out[..., sign_neg] = -out[..., sign_neg]
    return out


def _rotate(a: torch.Tensor, i) -> tuple[torch.Tensor, torch.Tensor]:
    """a rotated right by i mod n, and where a(X) * X^i negates: i is an
    int or an integer tensor broadcasting against a.shape[:-1]
    (`ring.rs:299-313`)."""
    n = a.shape[-1]
    i = (torch.as_tensor(i, dtype=torch.int64, device=a.device) % (2 * n))[..., None]
    r = i % n
    idx = torch.arange(n, device=a.device)
    rolled = torch.gather(a, -1, ((idx - r) % n).expand(a.shape))
    return rolled, torch.where(i < n, idx < r, idx >= r)


def monomial_mul_zq(a: torch.Tensor, i, q: int) -> torch.Tensor:
    """a(X) * X^i mod (X^n+1, q); a batch of polynomials may each take its
    own shift."""
    rolled, neg = _rotate(a, i)
    return torch.where(neg, neg_mod(rolled, q), rolled)


def monomial_mul_t64(a: torch.Tensor, i) -> torch.Tensor:
    """a(X) * X^i mod X^n+1 on the torus (wrapping negation)."""
    rolled, neg = _rotate(a, i)
    return torch.where(neg, -rolled, rolled)


def sample_extract_a(a: torch.Tensor, i: int, q: int) -> torch.Tensor:
    """LWE mask of coefficient i of an RLWE mask (`rlwe.rs:193-202`):
    [a_i, a_{i-1}, .., a_0, -a_{n-1}, .., -a_{i+1}]."""
    head = a[..., : i + 1].flip(-1)
    tail = neg_mod(a[..., i + 1 :].flip(-1), q)
    return torch.cat([head, tail], dim=-1)
