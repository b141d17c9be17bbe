"""Port vs JAX: CRT plans, the monomial table, Garner, the CRT torus product
and the torus gadget decomposition. Exact equality everywhere."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.ops import gadget as jgadget  # noqa: E402
from learn_fhe_tpu.ops import torus_crt as jcrt  # noqa: E402
from learn_fhe_tpu_torch.ops import gadget as tgadget  # noqa: E402
from learn_fhe_tpu_torch.ops import torus_crt as tcrt  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import (  # noqa: E402
    torch_to_u32,
    torch_to_u64,
    u32_to_torch,
    u64_to_torch,
)

# (n, log_b, rows): the blind-rotation step's plan and keygen's binary-key plan
PLANS = [(256, 23, 2), (2048, 23, 2), (256, 2, 1), (2048, 2, 1)]


@pytest.mark.parametrize("n,log_b,rows", PLANS)
def test_crt_plan_matches_jax(n, log_b, rows):
    bound = tcrt.required_bound_bits(n, log_b, rows)
    assert bound == jcrt.required_bound_bits(n, log_b, rows)
    tp, jp = tcrt.torus_crt_plan(n, bound), jcrt.torus_crt_plan(n, bound)
    for f in ("primes", "garner_inv", "half_digits", "q_mod_2_64", "q_prefix_mod_2_64"):
        assert getattr(tp, f) == getattr(jp, f), f
    consts = tp.kernel_consts
    assert consts[0] == tp.k and list(consts[1 : 1 + tp.k]) == list(tp.primes)


def test_monomial_eval_table_matches_jax():
    bound = tcrt.required_bound_bits(256, 23, 2)
    tv, td = tcrt.monomial_eval_table(256, bound)
    jv, jd = jcrt.monomial_eval_table(256, bound)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("n,log_b,rows", [(256, 23, 2), (256, 2, 1)])
def test_garner_to_u64_matches_jax(n, log_b, rows):
    bound = tcrt.required_bound_bits(n, log_b, rows)
    jplan, tplan = jcrt.torus_crt_plan(n, bound), tcrt.torus_crt_plan(n, bound)
    rng = np.random.default_rng(3)
    res = [rng.integers(0, q, size=(5, n), dtype=np.uint32) for q in jplan.primes]
    want = jcrt.garner_to_u64(tuple(jnp.asarray(r) for r in res), jplan, intt_first=False)
    got = tcrt.garner_to_u64(u32_to_torch(np.stack(res)), tplan)
    np.testing.assert_array_equal(torch_to_u64(got), np.asarray(want))
    # the centered lift at its edge: (Q-1)/2 stays, (Q+1)/2 becomes -(Q-1)/2
    q_prod = math.prod(tplan.primes)
    values = [0, 1, (q_prod - 1) // 2, (q_prod + 1) // 2, q_prod - 1]
    edge = np.array([[v % q for v in values] for q in tplan.primes], dtype=np.uint32)
    got = tcrt.garner_to_u64(u32_to_torch(edge), tplan)
    lifted = [v if v <= (q_prod - 1) // 2 else v - q_prod for v in values]
    assert got.tolist() == [tgadget.as_i64(v) for v in lifted]


@pytest.mark.parametrize("log_b,shape_a", [(23, (3, 256)), (2, (1, 256))])
def test_negacyclic_mul_t64_crt_matches_jax(log_b, shape_a):
    rng = np.random.default_rng(log_b)
    half = 1 << (log_b - 1)
    a = rng.integers(-half + 1, half + 1, size=shape_a).astype(np.int64)
    b = rng.integers(0, 1 << 64, size=(3, 256), dtype=np.uint64)
    want = np.asarray(
        jcrt.negacyclic_mul_t64_crt(jnp.asarray(a.astype(np.uint64)), jnp.asarray(b), log_b)
    )
    got = tcrt.negacyclic_mul_t64_crt(torch.from_numpy(a), u64_to_torch(b), log_b)
    np.testing.assert_array_equal(torch_to_u64(got), want)


@pytest.mark.parametrize("log_b,d", [(23, 1), (10, 3), (4, 5), (8, 8)])
def test_decompose_t64_matches_jax(log_b, d):
    g = tgadget.Gadget(0, log_b, d)
    jg = jgadget.Gadget(0, log_b, d)
    assert (g.rounding_bits, list(g.bases)) == (jg.rounding_bits, list(jg.bases))
    rng = np.random.default_rng(d)
    x = rng.integers(0, 1 << 64, size=(4, 64), dtype=np.uint64)
    x[0, :4] = [0, (1 << 64) - 1, 1 << 63, (1 << 63) - 1]
    want = np.asarray(jgadget.decompose_t64(jnp.asarray(x), jg))
    got = tgadget.decompose_t64(u64_to_torch(x), g)
    np.testing.assert_array_equal(torch_to_u64(got), want)
    np.testing.assert_array_equal(
        torch_to_u64(tgadget.power_up_t64(u64_to_torch(x), g)),
        np.asarray(jgadget.power_up_t64(jnp.asarray(x), jg)),
    )
    if tgadget.decompose_t64_supports_u32(g):
        hi = (x >> np.uint64(32)).astype(np.uint32)
        want32 = np.asarray(jgadget.decompose_t64_u32(jnp.asarray(hi), jg))
        got32 = tgadget.decompose_t64_u32(torch.from_numpy(hi.astype(np.int64)), g)
        np.testing.assert_array_equal(torch_to_u32(got32), want32)
