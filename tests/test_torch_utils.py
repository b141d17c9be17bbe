"""Port vs JAX: `learn_fhe_tpu_torch/utils/{serialization,noise,misc,
profiling}.py` on the CPU.

- serialization: a TFHE key the JAX package saves loads into the port, and
  through `utils/interop` equals the port's own key from the same seed; a
  CKKS ciphertext the port saves reloads typed, and the JAX package's `load`
  reads the same bits; the port's FHEW key round-trips with its None fields
  and its dtypes.
- noise: the meters give the JAX package's bits on the same ciphertexts;
  the port's two profiles pass the JAX test's own bounds
  (`tests/test_parallel.py::test_noise_profilers_pin_growth`). Its gate and
  PBS batches are held bit for bit against JAX by `test_torch_fhew.py` and
  `test_torch_tfhe_pbs.py`.
- misc: the helpers give the JAX package's values, and a homomorphic Horner
  on the port's CKKS matches to the JAX test's 1e-6.
- profiling: a CPU trace of one port call, and the device branch of
  `summarize` on a trace file laid out as CUDA activity writes it.
"""

import json
from itertools import islice
from types import SimpleNamespace as NS

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import learn_fhe_tpu.models.fhew as jfhew  # noqa: E402
import learn_fhe_tpu.models.tfhe as jtfhe  # noqa: E402
from learn_fhe_tpu.models.ckks import ckks as JC  # noqa: E402
from learn_fhe_tpu.utils import misc as jmisc  # noqa: E402
from learn_fhe_tpu.utils import noise as jnoise  # noqa: E402
from learn_fhe_tpu.utils import serialization as jser  # noqa: E402
from learn_fhe_tpu.utils.primes import two_adic_primes  # noqa: E402
import learn_fhe_tpu_torch.models.fhew as fhew  # noqa: E402
import learn_fhe_tpu_torch.models.tfhe as tfhe  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import ckks as TC  # noqa: E402
from learn_fhe_tpu_torch.ops import ring_mul  # noqa: E402
from learn_fhe_tpu_torch.utils import misc, noise, profiling, serialization  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import bootstrap_key_from_numpy, torch_to_u64, u64_to_torch  # noqa: E402


def _fhew_params(mod):
    """`tests/test_parallel.py::test_noise_meters`' fixture: N=128, n=16, w=5."""
    q = next(two_adic_primes(28, 8))
    return mod.BootstrapParams(
        mod.RgswParams(mod.RlweParams(q=q, p=4, log_n=7, log_b=7, d=4), log_b=7, d=4),
        mod.LweParams(q=1 << 16, p=4, n=16, log_b=4, d=4),
        w=5,
    )


@pytest.fixture(scope="module")
def fhew_env():
    params = _fhew_params(fhew)
    rng = np.random.default_rng(31)
    sk = fhew.rlwe.sk_gen(params.rlwe, rng)
    return params, sk, fhew.key_gen(params, sk, rng, "cpu"), rng


# -- serialization ----------------------------------------------------------------


def test_jax_saved_tfhe_key_loads_equal_to_the_ports_keygen(tmp_path):
    """`tests/test_distributed.py:133-140`'s parameters (N=128, n=32, d=2)."""

    def params(mod):
        return mod.BootstrapParams(
            mod.TlweParams(log_p=2, padding=1, n=32, std_dev=1e-7, log_b=4, d=5),
            mod.TggswParams(mod.TglweParams(log_p=2, padding=1, big_n=128, k=1, std_dev=1e-14), log_b=8, d=2),
        )

    jrng, rng = np.random.default_rng(5), np.random.default_rng(5)
    jz, z = jtfhe.tlwe.sk_gen(params(jtfhe).tlwe, jrng), tfhe.tlwe.sk_gen(params(tfhe).tlwe, rng)
    path = str(tmp_path / "key.npz")
    jser.save(path, bk=jtfhe.key_gen(params(jtfhe), jz, jrng))
    types = {"BootstrapKey": NS, "TggswEval": NS, "TlweKeySwitchingKey": NS}
    loaded = serialization.load(path, reconstruct=types, device="cpu")["bk"]
    assert loaded.brk.av[0].device.type == "cpu"
    got = bootstrap_key_from_numpy(loaded, device="cpu")
    want = tfhe.key_gen(params(tfhe), z, rng, "cpu")
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_port_saved_ckks_ciphertext_reloads_typed_and_in_jax(tmp_path):
    params = TC.CkksParams(log_n=4, log_qi=45, big_l=3)
    rng = np.random.default_rng(4)
    sk = TC.sk_gen(params, rng)
    m = rng.standard_normal(params.l) + 1j * rng.standard_normal(params.l)
    ct = TC.sk_encrypt(params, sk, TC.encode(params, m, device="cpu"), params.qs, rng)
    path = str(tmp_path / "ct.npz")
    serialization.save(path, ct=ct)
    loaded = serialization.load(path, reconstruct={"CkksCiphertext": TC.CkksCiphertext}, device="cpu")["ct"]
    assert isinstance(loaded, TC.CkksCiphertext) and loaded.qs == ct.qs
    assert torch.equal(loaded.b, ct.b) and torch.equal(loaded.a, ct.a)
    assert np.max(np.abs(TC.decode(params, TC.decrypt(params, sk, loaded), loaded.qs) - m)) < 1e-6
    in_jax = jser.load(path, reconstruct={"CkksCiphertext": JC.CkksCiphertext})["ct"]
    assert isinstance(in_jax, JC.CkksCiphertext) and in_jax.qs == ct.qs
    np.testing.assert_array_equal(np.asarray(in_jax.b).view(np.uint64), torch_to_u64(ct.b))
    np.testing.assert_array_equal(np.asarray(in_jax.a).view(np.uint64), torch_to_u64(ct.a))


def test_fhew_key_round_trip(fhew_env, tmp_path):
    """The checkpoint `chip_smoke.py` U1 makes on the card: every field with
    its dtype (int32 residues, int64 values, bool signs) and its None."""
    *_, key, _ = fhew_env
    path = str(tmp_path / "fhew.npz")
    serialization.save(path, key=key, note="fixture", level=(1, 2))
    state = serialization.load(path, reconstruct={"BootstrapKey": fhew.BootstrapKey}, device="cpu")
    assert state["note"] == "fixture" and state["level"] == (1, 2)
    loaded = state["key"]
    assert isinstance(loaded, fhew.BootstrapKey)
    for f in fhew.BootstrapKey._fields:
        x, y = getattr(key, f), getattr(loaded, f)
        assert (x is None and y is None) or (y.dtype == x.dtype and torch.equal(x, y)), f


# -- noise ------------------------------------------------------------------------


def test_noise_meters_match_jax():
    jparams, params = _fhew_params(jfhew), _fhew_params(fhew)
    rng = np.random.default_rng(12)
    sk = jfhew.rlwe.sk_gen(jparams.rlwe, rng)
    m = rng.integers(0, 4, 8).astype(np.uint64)
    jct = jfhew.lwe.sk_encrypt(jparams.lwe_z, np.asarray(sk), jfhew.lwe.encode(jparams.lwe_z, jnp.asarray(m)), rng)
    ct = fhew.lwe.LweCiphertext(u64_to_torch(np.asarray(jct.a)), u64_to_torch(np.asarray(jct.b)))
    want = jnoise.fhew_noise_bits(jparams, np.asarray(sk), jct, m.astype(int))
    got = noise.fhew_noise_bits(params, np.asarray(sk), ct, torch.from_numpy(m.astype(np.int64)))
    np.testing.assert_array_equal(got, want)
    assert noise.fhew_noise_bits(params, sk, fhew.lwe.LweCiphertext(ct.a[0], ct.b[0]), int(m[0])) == want[0]

    tp = jtfhe.TlweParams(log_p=2, padding=1, n=64, std_dev=1.34e-7, log_b=4, d=5)
    z = jtfhe.tlwe.sk_gen(tp, rng)
    ms = rng.integers(0, 4, 8).astype(np.uint64)
    jt = jtfhe.tlwe.sk_encrypt(tp, z, jtfhe.tlwe.encode(tp, jnp.asarray(ms)), rng)
    tct = tfhe.tlwe.TlweCiphertext(u64_to_torch(np.asarray(jt.a)), u64_to_torch(np.asarray(jt.b)))
    np.testing.assert_array_equal(noise.tfhe_noise_bits(tp, z, tct, u64_to_torch(ms)), jnoise.tfhe_noise_bits(tp, z, jt, ms))

    want_m = rng.standard_normal(6) + 1j * rng.standard_normal(6)
    got_m = want_m + 2.0**-20
    assert noise.ckks_precision_bits(torch.from_numpy(want_m), torch.from_numpy(got_m)) == jnoise.ckks_precision_bits(want_m, got_m)
    assert noise.ckks_precision_bits(want_m, want_m) == 200.0


def test_noise_profiles_pin_growth(fhew_env):
    """The JAX test's bounds: a fresh budget > 15 bits, every gate's in
    (4, 15) and depth-independent (spread < 6); TFHE fresh > 12 bits and
    after a PBS in (5, 15)."""
    params, sk, key, rng = fhew_env
    log = noise.fhew_gate_chain_profile(params, key, sk, depth=5, rng=rng)
    bits = log.bits()
    assert len(bits) == 6 and bits[0] > 15, log.summary()
    gate_bits = bits[1:]
    assert all(4 < b < 15 for b in gate_bits), log.summary()
    assert max(gate_bits) - min(gate_bits) < 6, log.summary()

    tparams = tfhe.BootstrapParams(
        tfhe.TlweParams(log_p=2, padding=1, n=64, std_dev=1.34e-7, log_b=4, d=5),
        tfhe.TggswParams(tfhe.TglweParams(log_p=2, padding=1, big_n=256, k=1, std_dev=2.85e-15), log_b=23, d=1),
    )
    z = tfhe.tlwe.sk_gen(tparams.tlwe, rng)
    tlog = noise.tfhe_pbs_io_profile(tparams, tfhe.key_gen(tparams, z, rng, "cpu"), z, rng)
    tb = tlog.bits()
    assert tb[0] > 12 and 5 < tb[1] < 15, tlog.summary()
    assert "after PBS" in tlog.summary()


# -- misc -------------------------------------------------------------------------


def test_misc_helpers_match_jax():
    mul, add = (lambda x, y: x * y), (lambda x, y: x + y)
    assert list(islice(misc.powers(3, mul), 6)) == list(islice(jmisc.powers(3, mul), 6)) == [3, 9, 27, 81, 243, 729]
    assert misc.horner([1, 2, 3, 4], 5, mul, add) == jmisc.horner([1, 2, 3, 4], 5, mul, add) == 1 + 2 * 5 + 3 * 25 + 4 * 125
    assert misc.dot([1, 2, 3], [4, 5, 6], mul, add) == jmisc.dot([1, 2, 3], [4, 5, 6], mul, add) == 32
    assert misc.hadamard([1, 2, 3], [4, 5, 6], mul) == jmisc.hadamard([1, 2, 3], [4, 5, 6], mul) == [4, 10, 18]
    with pytest.raises(AssertionError):
        misc.dot([1, 2], [1], mul, add)


def test_homomorphic_horner():
    """`tests/test_ckks.py::test_homomorphic_horner` on the port's CKKS: p(x)
    = 1 + 2x + x^2 by the generic horner, and the powers stream."""
    params = TC.CkksParams(log_n=5, log_qi=45, big_l=5)
    rng = np.random.default_rng(14)
    sk = TC.sk_gen(params, rng)
    rlk = TC.rlk_gen(params, sk, rng, device="cpu")
    m = (rng.standard_normal(params.l) + 1j * rng.standard_normal(params.l)) * 0.5
    ct = TC.sk_encrypt(params, sk, TC.encode(params, m, device="cpu"), params.qs, rng)

    def mul(x, acc):
        if isinstance(acc, TC.CkksCiphertext):
            return TC.mul(params, rlk, x, acc)
        return TC.mul_constant(params, np.full(params.l, acc), x)

    def add(acc, c):
        fresh = TC.sk_encrypt(params, sk, TC.encode(params, np.full(params.l, complex(c)), acc.qs, device="cpu"), acc.qs, rng)
        return TC.add(acc, fresh)

    out = misc.horner([1.0, 2.0, 1.0], ct, mul=mul, add=add)
    got = TC.decode(params, TC.decrypt(params, sk, out), out.qs)
    assert np.max(np.abs(got - (1 + 2 * m + m * m))) < 1e-6
    pws = list(islice(misc.powers(ct, lambda a, b: TC.mul(params, rlk, a, b)), 3))
    for k, p in enumerate(pws, start=1):
        assert np.max(np.abs(TC.decode(params, TC.decrypt(params, sk, p), p.qs) - m**k)) < 1e-5, k


# -- profiling --------------------------------------------------------------------


def test_profiling_summarizes_a_cpu_trace(tmp_path):
    """On the CPU the trace has no device events: summarize sums the
    top-level operators of one ring product (its residues by remainder,
    the per-prime planes stacked)."""
    with pytest.raises(FileNotFoundError):
        profiling.summarize(str(tmp_path))
    a = torch.from_numpy(np.random.default_rng(2).integers(-100, 100, (2, 64)))
    with profiling.trace(str(tmp_path / "t")):
        ring_mul.negacyclic_mul_i64(a, a, 7, 7)
    stats = profiling.summarize(str(tmp_path / "t"))
    names = {s.kind: s.count for s in stats}
    assert {"aten::remainder", "aten::stack"} <= names.keys() and min(names.values()) >= 1
    assert [s.total_ms for s in stats] == sorted((s.total_ms for s in stats), reverse=True)
    assert "aten::remainder" in str(stats[[s.kind for s in stats].index("aten::remainder")])


def test_profiling_sums_device_events_of_the_newest_trace(tmp_path):
    """A trace as CUDA activity writes it: kernels, copies and sets are
    summed by name; the runtime's host calls and the CPU operators are not;
    only the newest file counts."""
    old = {"traceEvents": [{"ph": "X", "cat": "kernel", "name": "stale", "ts": 0, "dur": 9, "pid": 0, "tid": 0}]}
    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 0, "dur": 50, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1, "dur": 5, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize", "ts": 7, "dur": 40, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "garner_kernel<5>", "ts": 10, "dur": 3.0, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "garner_kernel<5>", "ts": 20, "dur": 3.5, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "negacyclic_mul32_kernel<14>", "ts": 30, "dur": 8.0, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 40, "dur": 1.0, "pid": 0, "tid": 7},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 41, "pid": 0, "tid": 7},
    ]
    (tmp_path / "a.0.pt.trace.json").write_text(json.dumps(old))
    newest = tmp_path / "b.1.pt.trace.json"
    newest.write_text(json.dumps({"traceEvents": events}))
    import os

    os.utime(newest, (2e9, 2e9))
    got = [(s.kind, s.count, s.total_ms) for s in profiling.summarize(str(tmp_path))]
    assert got == [
        ("negacyclic_mul32_kernel<14>", 1, 0.008),
        ("garner_kernel<5>", 2, 0.0065),
        ("Memcpy HtoD (Pageable -> Device)", 1, 0.001),
    ]
    assert [s.kind for s in profiling.summarize(str(tmp_path), min_count=2)] == ["garner_kernel<5>"]
