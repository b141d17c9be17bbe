"""Port vs JAX past N = 2048: the u32 transforms of K-NTT, intt32 and
K-POLYMUL at the Pallas kernels' own N = 2^14 (and 2^12, 2^13), and the u64
engine's `ntt64` / `intt64` / `negacyclic_mul64`, which run on K-RNS-NTT
with one limb there.

The port's functions run their plain versions here (CPU tensors); the
kernels' pass schedule at these rings is modelled on the CPU
(`test_torch_ntt32._kernel_model`, one row a block), and the kernels
themselves are held against the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` N1, N2).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.ops import ntt as jntt64  # noqa: E402
from learn_fhe_tpu.ops import ntt32 as jntt  # noqa: E402
from learn_fhe_tpu_torch.ops import ntt as tntt64  # noqa: E402
from learn_fhe_tpu_torch.ops import ntt32 as tntt  # noqa: E402
from learn_fhe_tpu_torch.ops import rns as trns  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u32, torch_to_u64, u32_to_torch, u64_to_torch  # noqa: E402
from learn_fhe_tpu_torch.utils.primes import two_adic_primes  # noqa: E402

from .test_torch_ntt32 import _kernel_model  # noqa: E402

LOG_NS = (12, 13, 14)
Q31 = next(two_adic_primes(31, 15))  # 2^30 < q < 2^31: K-POLYMUL's product
Q28 = next(two_adic_primes(28, 15))  # FHEW's and bench_scaling's size: the three-launch route
Q55 = next(two_adic_primes(55, 15))  # bench.py's u64 NTT metric


@pytest.mark.parametrize("log_n", LOG_NS)
@pytest.mark.parametrize("q", [Q31, Q28], ids=["q31", "q28"])
def test_ntt32_past_2048_matches_jax(log_n, q):
    n = 1 << log_n
    jp, tp = jntt.ntt32_plan(q, n), tntt.ntt32_plan(q, n)
    rng = np.random.default_rng(log_n)
    a = rng.integers(0, q, size=(2, n), dtype=np.uint32)
    b = rng.integers(0, q, size=(2, n), dtype=np.uint32)
    a[0, 0], b[-1, -1] = q - 1, q - 1
    ta, tb = u32_to_torch(a), u32_to_torch(b)
    fwd = tntt.ntt32(ta, tp)
    np.testing.assert_array_equal(torch_to_u32(fwd), np.asarray(jntt.ntt32(jnp.asarray(a), jp)))
    np.testing.assert_array_equal(torch_to_u32(tntt.intt32(ta, tp)), np.asarray(jntt.intt32(jnp.asarray(a), jp)))
    np.testing.assert_array_equal(torch_to_u32(tntt.intt32(fwd, tp)), a)
    want = np.asarray(jntt.negacyclic_mul32(jnp.asarray(a), jnp.asarray(b), jp))
    np.testing.assert_array_equal(torch_to_u32(tntt.negacyclic_mul32(ta, tb, tp)), want)
    prod = np.asarray(jntt.pointwise_mul32(jnp.asarray(a), jnp.asarray(b), jp))
    np.testing.assert_array_equal(torch_to_u32(tntt.pointwise_mul32(ta, tb, tp)), prod)


@pytest.mark.parametrize("log_n", LOG_NS)
def test_kernel_schedule_model_past_2048(log_n):
    """The kernels' schedule at one row a block (N / 8 threads of up to
    1024, the row in dynamic shared memory): 2 rows, edge values, the
    K-POLYMUL product, against the JAX package."""
    n = 1 << log_n
    jp, tp = jntt.ntt32_plan(Q31, n), tntt.ntt32_plan(Q31, n)
    rng = np.random.default_rng(100 + log_n)
    a = rng.integers(0, Q31, size=(2, n), dtype=np.uint32)
    b = rng.integers(0, Q31, size=(2, n), dtype=np.uint32)
    a[0, 0], a[-1, -1], b[0, -1], b[-1, 0] = 0, Q31 - 1, Q31 - 1, 0
    np.testing.assert_array_equal(_kernel_model("fwd", tp, a), np.asarray(jntt.ntt32(jnp.asarray(a), jp)))
    np.testing.assert_array_equal(_kernel_model("inv", tp, a), np.asarray(jntt.intt32(jnp.asarray(a), jp)))
    want = np.asarray(jntt.negacyclic_mul32(jnp.asarray(a), jnp.asarray(b), jp))
    np.testing.assert_array_equal(_kernel_model("mul", tp, a, b), want)


@pytest.mark.parametrize("log_n", LOG_NS)
def test_ntt64_past_2048_matches_jax(log_n):
    n = 1 << log_n
    jp, tp = jntt64.ntt_plan(Q55, n), tntt64.ntt_plan(Q55, n)
    rng = np.random.default_rng(200 + log_n)
    a = rng.integers(0, Q55, size=(2, n), dtype=np.uint64)
    b = rng.integers(0, Q55, size=(2, n), dtype=np.uint64)
    ta, tb = u64_to_torch(a), u64_to_torch(b)
    fwd = tntt64.ntt64(ta, tp)
    np.testing.assert_array_equal(torch_to_u64(fwd), np.asarray(jntt64.ntt(jnp.asarray(a), jp)))
    np.testing.assert_array_equal(torch_to_u64(tntt64.intt64(ta, tp)), np.asarray(jntt64.intt(jnp.asarray(a), jp)))
    np.testing.assert_array_equal(torch_to_u64(tntt64.intt64(fwd, tp)), a)
    want = np.asarray(jntt64.negacyclic_mul(jnp.asarray(a), jnp.asarray(b), jp))
    np.testing.assert_array_equal(torch_to_u64(tntt64.negacyclic_mul64(ta, tb, tp)), want)


@pytest.mark.parametrize("log_n", (12, 14, 16))
def test_one_limb_route_matches_ntt64(log_n):
    """Past 2048 the u64 wrappers run K-RNS-NTT on the one-prime plan: its
    tables are the NttPlan's, and its plain transforms, and the product as
    the wrapper makes it (two forward transforms, one `rns_intt_mac` of one
    term), give `ntt64_ref`'s, `intt64_ref`'s and `negacyclic_mul64_ref`'s
    values."""
    n = 1 << log_n
    q = next(two_adic_primes(55, log_n + 1))
    tp, rp = tntt64.ntt_plan(q, n), trns.rns_plan((q,), n)
    for f in ("psi_br", "psi_br_shoup", "psi_inv_br", "psi_inv_br_shoup"):
        np.testing.assert_array_equal(getattr(rp, f)[0], getattr(tp, f))
    assert (int(rp.n_inv[0, 0]), int(rp.n_inv_shoup[0, 0])) == (tp.n_inv, tp.n_inv_shoup)
    rng = np.random.default_rng(300 + log_n)
    a = u64_to_torch(rng.integers(0, q, size=(2, n), dtype=np.uint64))
    b = u64_to_torch(rng.integers(0, q, size=(2, n), dtype=np.uint64))
    ea, eb = (trns.rns_ntt_ref(t.unsqueeze(-2), rp) for t in (a, b))
    assert torch.equal(ea.squeeze(-2), tntt64.ntt64_ref(a, tp))
    assert torch.equal(trns.rns_intt_ref(a.unsqueeze(-2), rp).squeeze(-2), tntt64.intt64_ref(a, tp))
    assert torch.equal(trns.rns_intt_mac_ref([ea], [eb], rp).squeeze(-2), tntt64.negacyclic_mul64_ref(a, b, tp))


def test_wrappers_take_2_to_the_14_and_no_more():
    """A non-CPU tensor past 2^14 is refused by the ring check before any
    launch; at 2^14 the ring is taken and the device check refuses a tensor
    that is not on the card (here a meta tensor)."""
    big = torch.empty((1, 1 << 15), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="n <= 16384"):
        tntt.ntt32(big, tntt.ntt32_plan(next(two_adic_primes(31, 16)), 1 << 15))
    at = torch.empty((1, 1 << 14), dtype=torch.int32, device="meta")
    for fn in (tntt.ntt32, tntt.intt32):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(at, tntt.ntt32_plan(Q31, 1 << 14))
    with pytest.raises(ValueError, match="CUDA device"):
        tntt.negacyclic_mul32(at, at, tntt.ntt32_plan(Q31, 1 << 14))
