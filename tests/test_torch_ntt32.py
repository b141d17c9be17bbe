"""Port vs JAX: the u32 negacyclic NTT, its inverse and the polymul.

Exact equality everywhere (integer arithmetic). The port's functions run
their plain versions here because the tensors lie on the CPU; the CUDA
kernels are held against those plain versions on the card
(`chip_smoke.py`, `tests/test_torch_cuda.py`).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.ops import ntt32 as jntt  # noqa: E402
from learn_fhe_tpu.ops.torus_crt import required_bound_bits, torus_crt_plan  # noqa: E402
from learn_fhe_tpu_torch.ops import ntt32 as tntt  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u32, u32_to_torch  # noqa: E402


def _step_primes(n: int) -> tuple[int, ...]:
    """The primes of the blind-rotation step's CRT plan (B=2^23, R=2)."""
    return torus_crt_plan(n, required_bound_bits(n, 23, 2)).primes


def test_ntt32_plan_tables_match_jax():
    for n in (64, 2048):
        for q in _step_primes(n):
            jp, tp = jntt.ntt32_plan(q, n), tntt.ntt32_plan(q, n)
            for f in ("psi_br", "psi_br_shoup", "psi_inv_br", "psi_inv_br_shoup"):
                np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
            assert (tp.n_inv, tp.n_inv_shoup) == (jp.n_inv, jp.n_inv_shoup)
            for f in ("q", "neg_q_inv", "r1", "r2", "barrett_m"):
                assert getattr(tp.zq, f) == getattr(jp.zq, f)


@pytest.mark.parametrize("n", [64, 256, 2048])
def test_ntt32_intt32_polymul_match_jax(n):
    rng = np.random.default_rng(n)
    for q in _step_primes(n):
        jp, tp = jntt.ntt32_plan(q, n), tntt.ntt32_plan(q, n)
        a = rng.integers(0, q, size=(3, n), dtype=np.uint32)
        b = rng.integers(0, q, size=(3, n), dtype=np.uint32)
        ta, tb = u32_to_torch(a), u32_to_torch(b)
        fwd = tntt.ntt32(ta, tp)
        np.testing.assert_array_equal(torch_to_u32(fwd), np.asarray(jntt.ntt32(jnp.asarray(a), jp)))
        np.testing.assert_array_equal(
            torch_to_u32(tntt.intt32(ta, tp)), np.asarray(jntt.intt32(jnp.asarray(a), jp))
        )
        np.testing.assert_array_equal(torch_to_u32(tntt.intt32(fwd, tp)), a)
        want = np.asarray(jntt.negacyclic_mul32(jnp.asarray(a), jnp.asarray(b), jp))
        np.testing.assert_array_equal(torch_to_u32(tntt.negacyclic_mul32(ta, tb, tp)), want)


def _pallas_ntt_experiment():
    path = Path(__file__).resolve().parents[1] / "bench" / "pallas_ntt14_experiment.py"
    spec = importlib.util.spec_from_file_location("pallas_ntt14_experiment", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ntt32_matches_pallas_kernels_interpret():
    """The Pallas forward and polymul kernels the port's CUDA kernels
    replace, run in interpret mode at N=256, batch tile 8."""
    mod = _pallas_ntt_experiment()
    n, tb = 256, 8
    q = _step_primes(n)[0]
    jp, tp = jntt.ntt32_plan(q, n), tntt.ntt32_plan(q, n)
    W, WS, WI, WIS, MASK = mod.dense_tables(jp)
    call_fwd, call_polymul = mod.make_kernels(
        q, n, jp.log_n, tb, int(jp.n_inv), int(jp.n_inv_shoup), True
    )
    rng = np.random.default_rng(5)
    a = rng.integers(0, q, size=(2 * tb, n), dtype=np.uint32)
    b = rng.integers(0, q, size=(2 * tb, n), dtype=np.uint32)
    got_fwd = np.asarray(call_fwd(jnp.asarray(a), W, WS, MASK))
    np.testing.assert_array_equal(torch_to_u32(tntt.ntt32(u32_to_torch(a), tp)), got_fwd)
    got_pm = np.asarray(call_polymul(jnp.asarray(a), jnp.asarray(b), W, WS, WI, WIS, MASK))
    port_pm = tntt.negacyclic_mul32(u32_to_torch(a), u32_to_torch(b), tp)
    np.testing.assert_array_equal(torch_to_u32(port_pm), got_pm)


def test_wrappers_take_plain_version_only_on_cpu():
    """On the CPU each wrapper returns its plain version's result and counts
    no kernel launch."""
    n = 64
    q = _step_primes(n)[0]
    tp = tntt.ntt32_plan(q, n)
    x = u32_to_torch(np.random.default_rng(1).integers(0, q, size=(2, n), dtype=np.uint32))
    before = (tntt.ntt32.launches, tntt.intt32.launches, tntt.negacyclic_mul32.launches)
    assert torch.equal(tntt.ntt32(x, tp), tntt.ntt32_ref(x, tp))
    assert torch.equal(tntt.intt32(x, tp), tntt.intt32_ref(x, tp))
    assert torch.equal(tntt.negacyclic_mul32(x, x, tp), tntt.negacyclic_mul32_ref(x, x, tp))
    after = (tntt.ntt32.launches, tntt.intt32.launches, tntt.negacyclic_mul32.launches)
    assert after == before
