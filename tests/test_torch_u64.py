"""Port vs JAX: the u64 engine's modular arithmetic and NTT on the CPU.

`learn_fhe_tpu_torch/ops/{modular,ntt}.py` carry u64 values as int64 and
build the 64 x 64 -> 128 products from 32-bit limbs; the JAX package works
on uint64. The same numpy-seeded inputs go through both, at the multi-key
sets' 54- and 55-bit primes (and a 62-bit one), with edge values: 0, q - 1,
2^54, and operands whose products come near 2^110. Everything is exact, so
every comparison is equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.ops import modular as jmod  # noqa: E402
from learn_fhe_tpu.ops import ntt as jntt  # noqa: E402
from learn_fhe_tpu.utils.primes import two_adic_primes  # noqa: E402
from learn_fhe_tpu_torch.ops import modular as tmod  # noqa: E402
from learn_fhe_tpu_torch.ops import ntt as tntt  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u64, u64_to_torch  # noqa: E402

PRIMES = {
    "q54": next(two_adic_primes(54, 8)),  # `tests/test_fhew.py::multi_key_boot_params`
    "q55": next(two_adic_primes(55, 12)),  # `examples/multi_key_uint8.py --full`
    "q62": next(two_adic_primes(62, 9)),
}


def _operands(q: int, seed: int):
    """(a, b) of 4096 residues with the edge values up front: 0, 1, q - 1,
    2^54 mod q, and large pairs whose product is near 2^110 (or q^2)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, q, size=4096, dtype=np.uint64)
    b = rng.integers(0, q, size=4096, dtype=np.uint64)
    big = min(q - 1, (1 << 55) - 1)
    edges = [(0, q - 1), (1, q - 1), (q - 1, q - 1), ((1 << 54) % q, (1 << 54) % q), (big, big), (big - 1, q - 2), (q - 1, 0)]
    for i, (x, y) in enumerate(edges):
        a[i], b[i] = x, y
    return a, b


def _ops(q: int, a: np.ndarray, b: np.ndarray):
    """name -> (port result, JAX result) on the same operands."""
    jz, tz = jmod.ZqParams(q), tmod.ZqParams(q)
    ta, tb = u64_to_torch(a), u64_to_torch(b)
    ws = jmod.shoup_precompute(b, q)
    stack = a.reshape(16, 256)
    return {
        "mulhi64": (tmod.mulhi64(ta, tb), jmod.mulhi64(a, b)),
        "mul_shoup": (tmod.mul_shoup(ta, tb, u64_to_torch(ws), q), jmod.mul_shoup(a, b, ws, q)),
        "mul_mod": (tmod.mul_mod(ta, tb, tz), jmod.mul_mod(a, b, jz)),
        "to_montgomery": (tmod.to_montgomery(ta, tz), jmod.to_montgomery(a, jz)),
        "mont_mul": (tmod.mont_mul(ta, tb, tz), jmod.mont_mul(a, b, jz)),
        "redc": (tmod._redc(tmod.mulhi64(ta, tb), ta * tb, q, tz.neg_q_inv), jmod._redc(jmod.mulhi64(a, b), jnp.asarray(a) * jnp.asarray(b), q, jz.neg_q_inv)),
        "generic_mul_mod": (tmod.generic_mul_mod(ta, tb, q), jmod.generic_mul_mod(a, b, q)),
        "add_mod": (tmod.add_mod(ta, tb, q), jmod.add_mod(a, b, q)),
        "sub_mod": (tmod.sub_mod(ta, tb, q), jmod.sub_mod(a, b, q)),
        "neg_mod": (tmod.neg_mod(ta, q), jmod.neg_mod(a, q)),
        "to_center_u64": (tmod.to_center_u64(ta, q), jmod.to_center_u64(a, q)),
        "sum_mod": (tmod.sum_mod(u64_to_torch(stack), q, axis=0), jmod.sum_mod(jnp.asarray(stack), q, axis=0)),
        "barrett_reduce_u64": (tmod.barrett_reduce_u64(ta * tb, q), jmod.barrett_reduce_u64(jnp.asarray(a) * jnp.asarray(b), q)),
    }


@pytest.mark.parametrize("prime", list(PRIMES))
def test_u64_modular_ops_match_jax(prime):
    q = PRIMES[prime]
    a, b = _operands(q, q % 1000)
    for name, (got, want) in _ops(q, a, b).items():
        np.testing.assert_array_equal(torch_to_u64(got), np.asarray(want), err_msg=name)


def test_zq_params_and_shoup_duals_match_jax():
    for q in PRIMES.values():
        jz, tz = jmod.ZqParams(q), tmod.ZqParams(q)
        assert (tz.neg_q_inv, tz.r1, tz.r2) == (jz.neg_q_inv, jz.r1, jz.r2)
        w = np.array([0, 1, q - 1, q // 2], dtype=np.uint64)
        np.testing.assert_array_equal(tmod.shoup_precompute(w, q), jmod.shoup_precompute(w, q))


def test_modular_dot_and_sum_mod_at_every_modulus():
    """modular_dot and sum_mod against the JAX package at a power of two,
    a 28-bit prime and the 55-bit prime, including the tree sum where the
    raw u64 sum would overflow."""
    rng = np.random.default_rng(3)
    for q in (1 << 16, 268435399, PRIMES["q55"]):
        x = rng.integers(0, q, size=(5, 40), dtype=np.uint64)
        mat = rng.integers(0, q, size=(40, 3), dtype=np.uint64)
        got = tmod.modular_dot(u64_to_torch(x), u64_to_torch(mat), q)
        np.testing.assert_array_equal(torch_to_u64(got), np.asarray(jmod.modular_dot(jnp.asarray(x), jnp.asarray(mat), q)))
    q = PRIMES["q62"]
    x = rng.integers(q - 1000, q, size=(9, 7), dtype=np.uint64)  # 9 (q-1) >= 2^64: the modular tree
    got = tmod.sum_mod(u64_to_torch(x), q, axis=0)
    np.testing.assert_array_equal(torch_to_u64(got), np.asarray(jmod.sum_mod(jnp.asarray(x), q, axis=0)))


@pytest.mark.parametrize("n", [2, 4, 8, 16, 32, 64, 128, 256])
def test_ntt_intt_negacyclic_mul_match_jax(n):
    """The u64 NTT, its inverse and the negacyclic product at every ring
    N=2..256, under the 54-bit prime (N <= 128) and the 55-bit prime, with
    the same psi_br tables and the same bit-reversed evaluation order."""
    rng = np.random.default_rng(n)
    for name, q in PRIMES.items():
        if (q - 1) % (2 * n):
            continue
        jp, tp = jntt.ntt_plan(q, n), tntt.ntt_plan(q, n)
        np.testing.assert_array_equal(tp.psi_br, jp.psi_br)
        np.testing.assert_array_equal(tp.psi_inv_br_shoup, jp.psi_inv_br_shoup)
        assert (tp.n_inv, tp.n_inv_shoup) == (jp.n_inv, jp.n_inv_shoup)
        x = rng.integers(0, q, size=(3, n), dtype=np.uint64)
        y = rng.integers(0, q, size=(3, n), dtype=np.uint64)
        x[0, 0], y[-1, -1] = q - 1, q - 1
        tx, ty = u64_to_torch(x), u64_to_torch(y)
        for op, got, want in (
            ("ntt", tntt.ntt(tx, tp), jntt.ntt(jnp.asarray(x), jp)),
            ("intt", tntt.intt(tx, tp), jntt.intt(jnp.asarray(x), jp)),
            ("negacyclic_mul", tntt.negacyclic_mul(tx, ty, tp), jntt.negacyclic_mul(jnp.asarray(x), jnp.asarray(y), jp)),
            ("pointwise_mul", tntt.pointwise_mul(tx, ty, tp), jntt.pointwise_mul(jnp.asarray(x), jnp.asarray(y), jp)),
        ):
            np.testing.assert_array_equal(torch_to_u64(got), np.asarray(want), err_msg=f"{op} {name}")
        assert torch.equal(tntt.intt(tntt.ntt(tx, tp), tp), tx)
