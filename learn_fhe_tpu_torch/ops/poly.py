"""Negacyclic monomial multiplication on the torus ring (`learn_fhe_tpu/ops/poly.py`)."""

from __future__ import annotations

import torch


def monomial_mul_t64(a: torch.Tensor, i) -> torch.Tensor:
    """a(X) * X^i mod X^n+1 on the torus (wrapping negation).

    i is an int or an integer tensor broadcastable against a.shape[:-1], so a
    batch of polynomials can each take its own shift: rotate right by
    i mod n and negate the span that wrapped around (`ring.rs:299-313`).
    """
    n = a.shape[-1]
    i = (torch.as_tensor(i, dtype=torch.int64, device=a.device) % (2 * n))[..., None]
    r = i % n
    idx = torch.arange(n, device=a.device)
    rolled = torch.gather(a, -1, ((idx - r) % n).expand(a.shape))
    neg = torch.where(i < n, idx < r, idx >= r)
    return torch.where(neg, -rolled, rolled)
