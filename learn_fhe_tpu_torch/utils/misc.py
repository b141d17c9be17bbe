"""Generic algebra helpers mirroring the reference's misc toolkit
(`util/src/misc.rs:12-84`): powers, horner, dot, hadamard — written over
caller-supplied operations so they work for plaintext arrays, RNS
polynomials, and homomorphic ciphertexts alike (the reference achieves the
same genericity through trait bounds). Counterpart of
`learn_fhe_tpu/utils/misc.py`, the same code: it touches no array."""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Sequence, TypeVar

T = TypeVar("T")
S = TypeVar("S")


def powers(base: T, mul: Callable[[T, T], T]) -> Iterator[T]:
    """base, base^2, base^3, ... (`misc.rs:12-17` starts the stream at the
    element itself; prepend an identity at the call site if needed)."""
    acc = base
    while True:
        yield acc
        acc = mul(acc, base)


def horner(
    coeffs: Sequence[S],
    x: T,
    mul: Callable[[T, S], T] | Callable[[T, T], T],
    add: Callable[[T, S], T] | Callable[[T, T], T],
) -> T:
    """Evaluate sum_i coeffs[i] * x^i by Horner's rule, highest power first
    internally (`misc.rs:19-27`). mul(acc, x) and add(acc, coeff) supply the
    algebra; for homomorphic evaluation pass ciphertext ops."""
    it = reversed(coeffs)
    acc = next(it)
    for c in it:
        acc = add(mul(x, acc), c)
    return acc


def dot(lhs: Iterable[T], rhs: Iterable[S], mul, add) -> T:
    """sum_i lhs_i * rhs_i with caller algebra (`misc.rs:44-62`); lengths
    must match exactly (the reference's izip_eq contract)."""
    l = list(lhs)
    r = list(rhs)
    assert len(l) == len(r), (len(l), len(r))
    acc = mul(l[0], r[0])
    for a, b in zip(l[1:], r[1:]):
        acc = add(acc, mul(a, b))
    return acc


def hadamard(lhs: Iterable[T], rhs: Iterable[S], mul) -> list[T]:
    """Elementwise products (`misc.rs:64-84`)."""
    l = list(lhs)
    r = list(rhs)
    assert len(l) == len(r)
    return [mul(a, b) for a, b in zip(l, r)]
