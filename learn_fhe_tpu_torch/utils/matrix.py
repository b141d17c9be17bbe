"""Diagonal-sparse matrices and baby-step/giant-step planning
(`learn_fhe_tpu/utils/matrix.py`; reference `util/src/misc/matrix.rs`), host
code on double-double complex diagonals.

A matrix is a plain dict {offset j -> diagonal DDC of length n}, with
dense[i][(j+i) % n] = diag_j[i]. Products, unitary-scaled inverses and the
BSGS index plans are the planning work of CKKS's homomorphic linear
transforms (`models/ckks/bootstrapping.py`).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .dd import DDC


def mat_mul(a: dict[int, DDC], b: dict[int, DDC], n: int) -> dict[int, DDC]:
    """Diagonal group-by product (`matrix.rs:94-108`):
    (a*b)[(i+j) % n] += a_i . rot(b_j, i)."""
    acc: dict[int, DDC] = {}
    for i, da in a.items():
        for j, db in b.items():
            k = (i + j) % n
            term = da * db.roll(-i)  # rot_iter(i) = start at index i
            acc[k] = term if k not in acc else acc[k] + term
    return acc


def mat_product(mats: list[dict[int, DDC]], n: int) -> dict[int, DDC]:
    out = mats[0]
    for m in mats[1:]:
        out = mat_mul(out, m, n)
    return out


def mat_inv(mat: dict[int, DDC], n: int) -> dict[int, DDC]:
    """Unitary-scaled inverse: diag_k = conj(rot(diag_j, -j))/2 with k = n-j
    (`matrix.rs:71-84`)."""
    out = {}
    for j, diag in mat.items():
        k = (n - j) % n
        out[k] = diag.roll(-k).conj().scale_exact(0.5)
    return out


def mat_to_dense(mat: dict[int, DDC], n: int) -> np.ndarray:
    dense = np.zeros((n, n), dtype=np.complex128)
    for j, diag in mat.items():
        z = diag.to_complex128()
        for i in range(n):
            dense[i][(j + i) % n] = z[i]
    return dense


def bsgs_plan(indices: list[int]) -> dict[int, list[int]]:
    """Split diagonal offsets into giant steps i and baby steps j minimizing
    distinct rotations (`matrix.rs:45-52,125-150`). Returns {i: sorted js}."""
    indices = sorted(set(indices))
    max_j = max(indices) if indices else 0

    def plan(k: int) -> dict[int, set[int]]:
        out: dict[int, set[int]] = defaultdict(set)
        for idx in indices:
            out[(idx // k) * k].add(idx % k)
        return out

    def cost(p: dict[int, set[int]]) -> int:
        ijs = set(p.keys()) | set().union(*p.values())
        return len([j for j in ijs if j != 0])

    best = min(
        (plan(k) for k in range(1, max_j + 1)),
        key=cost,
        default={0: {j for j in indices}},
    )
    return {i: sorted(js) for i, js in sorted(best.items())}
