"""Host-side prime search and multiplicative-group utilities.

Capabilities mirror the reference's `util/src/zq.rs:99-140,325-342` (generator
search, two-adic generators, NTT-friendly prime streams) but run as plain
Python host code: prime search is keygen-time work, never on the device path.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Iterator

# Deterministic Miller-Rabin witness set for all n < 2^64.
_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


@lru_cache(maxsize=None)
def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin primality test for n < 2^64."""
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@lru_cache(maxsize=None)
def generator(q: int) -> int:
    """Smallest g in [1, q-1) with g^((q-1)/2) == -1 mod q.

    Same search order as the reference (`zq.rs:99-105`), so derived twiddle
    tables agree with it for any given prime.
    """
    order = q - 1
    for g in range(1, order):
        if pow(g, order >> 1, q) == order:
            return g
    raise ValueError(f"no generator found for q={q}")


def two_adic_generator(q: int, log_n: int) -> int:
    """Element of order 2^log_n in Zq^* (`zq.rs:107-109`)."""
    return pow(generator(q), (q - 1) >> log_n, q)


def two_adic_primes(bits: int, log_n: int) -> Iterator[int]:
    """Stream of primes q ~ 2^bits with q = 1 mod 2^log_n, descending.

    Matches the reference's candidate ordering (`zq.rs:325-335`): candidates
    are (k << log_n) + 1 for k descending in [2^(bits-log_n-1), 2^(bits-log_n)).
    """
    assert bits > log_n
    lo, hi = 1 << (bits - log_n - 1), 1 << (bits - log_n)
    for k in range(hi - 1, lo - 1, -1):
        q = (k << log_n) + 1
        if is_prime(q):
            yield q


def mod_inverse(a: int, q: int) -> int:
    """Modular inverse via Python's built-in extended gcd."""
    return pow(a, -1, q)
