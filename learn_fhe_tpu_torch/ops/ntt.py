"""Bit-reversal permutation shared by the NTT plans (`learn_fhe_tpu/ops/ntt.py`)."""

from __future__ import annotations

import numpy as np


def bit_reverse_indices(n: int) -> np.ndarray:
    """Permutation j -> bitrev_{log n}(j)."""
    log_n = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev
