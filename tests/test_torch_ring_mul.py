"""Port vs JAX: the exact ring products for moduli without an NTT
(`learn_fhe_tpu_torch/ops/ring_mul.py`), `torus_crt.eval_mul` and the
Garner reconstruction at 5 primes, on the CPU's plain path.

Every case of `tests/test_ring_mul.py` is held against the same exact
oracles that test uses (a Python-int schoolbook product over the integers,
and the wrapping u64 one); two of them also go through the JAX function, bit
for bit. The rest would cost JAX a compile each for nothing the oracle does
not already hold."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.ops import ring_mul as jring  # noqa: E402
from learn_fhe_tpu.ops import torus_crt as jcrt  # noqa: E402
from learn_fhe_tpu_torch.ops import ring_mul as tring  # noqa: E402
from learn_fhe_tpu_torch.ops import torus_crt as tcrt  # noqa: E402
from learn_fhe_tpu_torch.utils import kernels  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u64, u32_to_torch, u64_to_torch  # noqa: E402

from .helpers import schoolbook_negacyclic_mul_wrap64  # noqa: E402
from .test_ring_mul import _schoolbook_z  # noqa: E402


def _i64_case(log_n):
    n = 1 << log_n
    rng = np.random.default_rng(log_n)
    return rng.integers(-(1 << 20), 1 << 20, n), rng.integers(-(1 << 20), 1 << 20, n)


def _pow2_case(log_q, n=128):
    rng = np.random.default_rng(log_q)
    mask = np.uint64((1 << log_q) - 1)
    return rng.integers(0, 1 << 63, n, dtype=np.uint64) & mask, rng.integers(0, 1 << 63, n, dtype=np.uint64) & mask


# every case of tests/test_ring_mul.py, with its inputs from the same seeds
CASES = (
    [("i64", log_n) for log_n in (0, 1, 4, 8)]
    + [("sk_square", 256)]
    + [("pow2", log_q) for log_q in (8, 16, 30, 47, 64)]
    + [("pow2_batched", 64)]
)


@pytest.mark.parametrize("kind,arg", CASES)
def test_ring_mul_matches_the_exact_oracle(kind, arg):
    if kind == "i64":
        a, b = _i64_case(arg)
        got = tring.negacyclic_mul_i64(torch.from_numpy(a), torch.from_numpy(b), 20, 20)
        assert got.dtype == torch.int64 and got.tolist() == _schoolbook_z(a, b)
    elif kind == "sk_square":
        sk = np.random.default_rng(9).integers(-1, 2, arg)
        got = tring.negacyclic_mul_i64(torch.from_numpy(sk), torch.from_numpy(sk), 1, 1)
        assert got.tolist() == _schoolbook_z(sk, sk)
    elif kind == "pow2":
        a, b = _pow2_case(arg)
        got = torch_to_u64(tring.negacyclic_mul_pow2(u64_to_torch(a), u64_to_torch(b), arg))
        np.testing.assert_array_equal(got, schoolbook_negacyclic_mul_wrap64(a, b) & np.uint64((1 << arg) - 1))
    else:  # a batch of 5 at n = 64, log_q = 64
        rng = np.random.default_rng(1)
        a = rng.integers(0, 1 << 63, (5, arg), dtype=np.uint64)
        b = rng.integers(0, 1 << 63, (5, arg), dtype=np.uint64)
        got = torch_to_u64(tring.negacyclic_mul_pow2(u64_to_torch(a), u64_to_torch(b), 64))
        for i in range(5):
            np.testing.assert_array_equal(got[i], schoolbook_negacyclic_mul_wrap64(a[i], b[i]))


@pytest.mark.parametrize("kind,arg", [("pow2", 64), ("i64", 4)])
def test_ring_mul_matches_jax(kind, arg):
    """pow2 at log_q = 64 takes 5 primes, i64 at n = 16 one."""
    if kind == "pow2":
        a, b = _pow2_case(arg)
        want = np.asarray(jring.negacyclic_mul_pow2(jnp.asarray(a), jnp.asarray(b), arg))
        got = torch_to_u64(tring.negacyclic_mul_pow2(u64_to_torch(a), u64_to_torch(b), arg))
    else:
        a, b = _i64_case(arg)
        want = np.asarray(jring.negacyclic_mul_i64(jnp.asarray(a), jnp.asarray(b), 20, 20))
        got = tring.negacyclic_mul_i64(torch.from_numpy(a), torch.from_numpy(b), 20, 20).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("log_q", [63, 62])
def test_ring_mul_pow2_centers_at_the_top_bits(log_q):
    """log_q = 63 centers by 2^63, which int64 holds only as -2^63."""
    rng = np.random.default_rng(log_q)
    mask = np.uint64((1 << log_q) - 1)
    a, b = (rng.integers(0, 1 << 64, 32, dtype=np.uint64) & mask for _ in range(2))
    got = torch_to_u64(tring.negacyclic_mul_pow2(u64_to_torch(a), u64_to_torch(b), log_q))
    np.testing.assert_array_equal(got, schoolbook_negacyclic_mul_wrap64(a, b) & mask)


def test_eval_mul_matches_jax():
    plan, jplan = tcrt.torus_crt_plan(64, 142), jcrt.torus_crt_plan(64, 142)
    rng = np.random.default_rng(5)
    a = np.stack([rng.integers(0, q, size=(3, 64), dtype=np.uint32) for q in plan.primes])
    b = np.stack([rng.integers(0, q, size=(3, 64), dtype=np.uint32) for q in plan.primes])
    want = jcrt.eval_mul(tuple(jnp.asarray(x) for x in a), tuple(jnp.asarray(x) for x in b), jplan)
    got = tcrt.eval_mul(u32_to_torch(a), u32_to_torch(b), plan)
    assert plan.k == 5 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), np.stack([np.asarray(w) for w in want]))


def test_garner_at_5_primes_matches_jax():
    plan, jplan = tcrt.torus_crt_plan(128, 142), jcrt.torus_crt_plan(128, 142)
    assert plan.primes == jplan.primes and plan.k == 5
    rng = np.random.default_rng(6)
    res = [rng.integers(0, q, size=(2, 128), dtype=np.uint32) for q in plan.primes]
    want = jcrt.garner_to_u64(tuple(jnp.asarray(r) for r in res), jplan, intt_first=False)
    np.testing.assert_array_equal(torch_to_u64(tcrt.garner_to_u64_ref(u32_to_torch(np.stack(res)), plan)), np.asarray(want))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_kernel_consts_layout(k):
    """The constants K-GARNER and K-STEP read (`csrc/torus_crt.cuh::
    load_crt_consts`), read back at the offsets that reader uses: the
    layout is positional, and a slot read at the wrong offset gives wrong
    values without any error."""
    plan = tcrt.torus_crt_plan(256, 31 * k - 3)
    assert plan.k == k
    c, w = plan.kernel_consts, kernels.GARNER_MAX_PRIMES
    assert c.dtype == np.uint64 and c.shape == (2 + 5 * w + 2 * w * w,) and c[0] == k
    fields = (plan.primes, [p.n_inv for p in plan.plans], [p.n_inv_shoup for p in plan.plans], plan.half_digits, plan.q_prefix_mod_2_64)
    for t, values in enumerate(fields):
        assert list(c[1 + t * w : 1 + t * w + w]) == list(values) + [0] * (w - k)
    assert c[1 + 5 * w] == plan.q_mod_2_64
    inv = c[2 + 5 * w :].reshape(2, w, w)
    for i in range(w):
        for j in range(w):
            pair = plan.garner_inv[i][j] if j < i < k else (0, 0)
            assert (inv[0, i, j], inv[1, i, j]) == pair


def test_kernel_consts_refuse_6_primes():
    plan = tcrt.torus_crt_plan(256, 31 * 6 - 3)
    assert plan.k == 6
    with pytest.raises(ValueError, match="at most 5 primes"):
        plan.kernel_consts
