"""Port vs JAX on the CPU: the plain versions of K6 (the TFHE PBS's sample
extract and key switch) and of K-FHEW-PRE (the FHEW gate preamble), and the
FHEW LWE key switch where its sums pass 2^53.

Inputs are drawn from numpy seeds at small rings (N <= 256) and go through
the JAX package and the port; every comparison is bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import learn_fhe_tpu.models.fhew as jfhew  # noqa: E402
import learn_fhe_tpu.models.tfhe as jtfhe  # noqa: E402
from learn_fhe_tpu.models.fhew import bootstrapping as jboot  # noqa: E402
from learn_fhe_tpu.models.fhew import lwe as jlwe  # noqa: E402
from learn_fhe_tpu.models.tfhe import tglwe as jtglwe  # noqa: E402
from learn_fhe_tpu.models.tfhe import tlwe as jtlwe  # noqa: E402
from learn_fhe_tpu.parallel.batch import _fhew_preamble as jax_preamble  # noqa: E402
from learn_fhe_tpu.utils.primes import two_adic_primes  # noqa: E402
import learn_fhe_tpu_torch.models.fhew as fhew  # noqa: E402
from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot  # noqa: E402
from learn_fhe_tpu_torch.models.fhew import lwe  # noqa: E402
from learn_fhe_tpu_torch.models.tfhe import tglwe, tlwe  # noqa: E402
from learn_fhe_tpu_torch.parallel.batch import _fhew_preamble  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u64, u64_to_torch  # noqa: E402


def _u64(rng, shape, q=None):
    if q is None:
        return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)
    return rng.integers(0, q, size=shape, dtype=np.uint64)


# log_b = 4 takes the int8 limb route (K6's), log_b = 8 the u64 product: the
# JAX package's two routes (`learn_fhe_tpu/models/tfhe/tlwe.py:107`)
@pytest.mark.parametrize("log_b,d,k,big_n", [(4, 5, 1, 256), (4, 5, 2, 64), (8, 3, 1, 128)])
def test_extract_key_switch_ref_matches_jax(log_b, d, k, big_n):
    rng = np.random.default_rng(log_b * 100 + k)
    n_to, batch = 24, (3, 2)
    jp = jtfhe.TlweParams(log_p=2, padding=1, n=n_to, std_dev=1e-8, log_b=log_b, d=d)
    tp = tlwe.TlweParams(log_p=2, padding=1, n=n_to, std_dev=1e-8, log_b=log_b, d=d)
    jgp = jtfhe.TglweParams(log_p=2, padding=1, big_n=big_n, k=k, std_dev=1e-15)
    ka, kb = _u64(rng, (d, k * big_n, n_to)), _u64(rng, (d, k * big_n))
    acc_a, acc_b = _u64(rng, (*batch, k, big_n)), _u64(rng, (*batch, big_n))
    acc_a[0, 0, 0, :3] = [0, 1, (1 << 64) - 1]  # 0 and the extremes through the negation
    ext = jtglwe.sample_extract(jgp, jtglwe.TglweCiphertext(jnp.asarray(acc_a), jnp.asarray(acc_b)), 0)
    want = jtlwe.key_switch(jp, jtlwe.TlweKeySwitchingKey(jnp.asarray(ka), jnp.asarray(kb)), ext)
    ksk = tlwe.TlweKeySwitchingKey(u64_to_torch(ka), u64_to_torch(kb))
    acc = tglwe.TglweCiphertext(u64_to_torch(acc_a), u64_to_torch(acc_b))
    for fn in (tlwe.extract_key_switch_ref, tlwe.extract_key_switch):
        got = fn(tp, ksk, acc)
        assert got.a.shape == (*batch, n_to) and got.b.shape == batch
        np.testing.assert_array_equal(torch_to_u64(got.a), np.asarray(want.a))
        np.testing.assert_array_equal(torch_to_u64(got.b), np.asarray(want.b))


def _fhew_params(mod, engine):
    """The 28-bit u32 engine (q_ks = 2^16) or the 55-bit u64 one (q_ks =
    2^20, the multi-key full set's LWE), at N = 128."""
    if engine == "u32":
        q, lwe_p = next(two_adic_primes(28, 8)), mod.LweParams(q=1 << 16, p=4, n=16, log_b=4, d=4)
    else:
        q, lwe_p = next(two_adic_primes(55, 8)), mod.LweParams(q=1 << 20, p=4, n=24, log_b=5, d=4)
    rlwe_p = mod.RlweParams(q=q, p=4, log_n=7, log_b=7, d=4)
    return mod.BootstrapParams(mod.RgswParams(rlwe_p, log_b=7, d=4), lwe_p, w=5)


@pytest.mark.parametrize("engine", ["u32", "u64"])
@pytest.mark.parametrize("per_ct_lut", [False, True])
def test_preamble_ref_matches_jax(engine, per_ct_lut):
    jp, tp = _fhew_params(jfhew, engine), _fhew_params(fhew, engine)
    rng = np.random.default_rng(7 + per_ct_lut + 2 * (engine == "u64"))
    n, n_lwe, d, batch = tp.n, tp.lwe_s.n, tp.lwe_s.gadget.d, 9
    ka, kb = _u64(rng, (d, n, n_lwe), tp.big_q_ks), _u64(rng, (d, n), tp.big_q_ks)
    a, b = _u64(rng, (batch, n), tp.big_q), _u64(rng, (batch,), tp.big_q)
    a[0, :2], b[0] = [0, tp.big_q - 1], tp.big_q - 1
    f = _u64(rng, (batch, n) if per_ct_lut else (n,), tp.big_q)
    f[..., :2] = 0  # a zero LUT value through the negations
    jkey = jboot.BootstrapKey(jnp.asarray(ka), jnp.asarray(kb), *([None] * 6))
    want_a, want_f = jax_preamble(jp, jkey, jnp.asarray(f), jlwe.LweCiphertext(jnp.asarray(a), jnp.asarray(b)))
    key = boot.BootstrapKey(u64_to_torch(ka), u64_to_torch(kb), *([None] * 6))
    ct = lwe.LweCiphertext(u64_to_torch(a), u64_to_torch(b))
    for fn in (boot.preamble_ref, _fhew_preamble):
        got_a, got_f = fn(tp, key, u64_to_torch(f), ct)
        assert got_f.dtype == (torch.int32 if engine == "u32" else torch.int64)
        np.testing.assert_array_equal(got_a.numpy().astype(np.uint64), np.asarray(want_a))
        np.testing.assert_array_equal(got_f.long().numpy().astype(np.uint64), np.asarray(want_f).astype(np.uint64))


# k (q_ks - 1)^2 >= 2^53: the port's float64 product raised here before
@pytest.mark.parametrize("q_ks,log_b,n_from", [(1 << 20, 5, 2100), (1 << 32, 8, 16)])
def test_lwe_key_switch_past_2_53_matches_jax(q_ks, log_b, n_from):
    d, n_to, batch = 4, 8, 3
    assert d * n_from * (q_ks - 1) ** 2 >= 1 << 53
    rng = np.random.default_rng(q_ks.bit_length())
    jp = jfhew.LweParams(q=q_ks, p=4, n=n_to, log_b=log_b, d=d)
    tp = fhew.LweParams(q=q_ks, p=4, n=n_to, log_b=log_b, d=d)
    ka, kb = _u64(rng, (d, n_from, n_to), q_ks), _u64(rng, (d, n_from), q_ks)
    a, b = _u64(rng, (batch, n_from), q_ks), _u64(rng, (batch,), q_ks)
    want = jlwe.key_switch(
        jp, jlwe.LweKeySwitchingKey(jnp.asarray(ka), jnp.asarray(kb)), jlwe.LweCiphertext(jnp.asarray(a), jnp.asarray(b))
    )
    got = lwe.key_switch(
        tp, lwe.LweKeySwitchingKey(u64_to_torch(ka), u64_to_torch(kb)), lwe.LweCiphertext(u64_to_torch(a), u64_to_torch(b))
    )
    np.testing.assert_array_equal(torch_to_u64(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(torch_to_u64(got.b), np.asarray(want.b))
