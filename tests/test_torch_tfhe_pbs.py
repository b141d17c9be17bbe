"""Port vs JAX: TFHE key generation from one seed, the key switch, and the
whole batched programmable bootstrap. Ciphertexts must be bit-identical."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import learn_fhe_tpu.models.tfhe as jtfhe  # noqa: E402
from learn_fhe_tpu.models.tfhe import tlwe as jtlwe  # noqa: E402
from learn_fhe_tpu.parallel.batch import tfhe_pbs_batch_device as jax_pbs_batch_device  # noqa: E402
import learn_fhe_tpu_torch.models.tfhe as tfhe  # noqa: E402
from learn_fhe_tpu_torch.models.tfhe import tggsw, tglwe, tlwe  # noqa: E402
from learn_fhe_tpu_torch.parallel.batch import tfhe_pbs_batch  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import (  # noqa: E402
    bootstrap_key_from_numpy,
    torch_to_u32,
    torch_to_u64,
    u64_to_torch,
)

REPO = Path(__file__).resolve().parents[1]


def _params(mod, log_p, n, big_n, tlwe_std, tglwe_std):
    return mod.BootstrapParams(
        mod.TlweParams(log_p=log_p, padding=1, n=n, std_dev=tlwe_std, log_b=4, d=5),
        mod.TggswParams(
            mod.TglweParams(log_p=log_p, padding=1, big_n=big_n, k=1, std_dev=tglwe_std),
            log_b=23,
            d=1,
        ),
    )


# `tests/test_tfhe.py::pbs_env`: N=256, n=64
PBS_ENV = dict(log_p=2, n=64, big_n=256, tlwe_std=1.34e-7, tglwe_std=2.85e-15)
# the reference fixture (`bootstrapping.rs:141-152`)
REFERENCE = dict(
    log_p=4, n=1024, big_n=2048, tlwe_std=1.339775301998614e-7, tglwe_std=2.845267479601915e-15
)


def _keys(cfg, seed):
    """JAX and port keys from the same seed, drawn in the same order."""
    jparams, params = _params(jtfhe, **cfg), _params(tfhe, **cfg)
    jrng, rng = np.random.default_rng(seed), np.random.default_rng(seed)
    jz, z = jtlwe.sk_gen(jparams.tlwe, jrng), tlwe.sk_gen(params.tlwe, rng)
    np.testing.assert_array_equal(jz, z)
    jkey = jax.tree.map(np.asarray, jtfhe.key_gen(jparams, jz, jrng))
    key = tfhe.key_gen(params, z, rng, "cpu")
    return jparams, params, z, jkey, key


@pytest.fixture(scope="module")
def env():
    return _keys(PBS_ENV, 17)


def _assert_keys_equal(key, jkey):
    for name, axis in (("av", 1), ("ad", 1), ("bv", 1), ("bd", 1)):
        want = np.stack(getattr(jkey.brk, name), axis=axis)
        np.testing.assert_array_equal(torch_to_u32(getattr(key.brk, name)), want)
    np.testing.assert_array_equal(torch_to_u64(key.ksk.a), jkey.ksk.a)
    np.testing.assert_array_equal(torch_to_u64(key.ksk.b), jkey.ksk.b)
    np.testing.assert_array_equal(torch_to_u32(key.mon_v), np.stack(jkey.mon_v))
    np.testing.assert_array_equal(torch_to_u32(key.mon_d), np.stack(jkey.mon_d))


def test_key_gen_bit_identical(env):
    _, _, _, jkey, key = env
    _assert_keys_equal(key, jkey)


def test_bootstrap_key_from_numpy_round_trip(env):
    _, params, _, jkey, key = env
    carried = bootstrap_key_from_numpy(jkey, device="cpu")
    for got, want in zip(jax.tree.leaves(tuple(carried)), jax.tree.leaves(tuple(key))):
        assert torch.equal(got, want)
    _assert_keys_equal(carried, jkey)
    module = tfhe.TfheBootstrap(params, carried)
    assert {n for n, _ in module.named_buffers()} >= {"brk_av", "ksk_a", "mon_v"}
    for got, want in zip(jax.tree.leaves(tuple(module.key)), jax.tree.leaves(tuple(carried))):
        assert got is want


@pytest.mark.parametrize("log_b,d", [(4, 5), (7, 4), (8, 8)])
def test_key_switch_matches_jax(log_b, d):
    """The int8-limb product (log_b <= 7) and the plain u64 dot (log_b=8,
    where a +128 digit does not fit int8) against the JAX key switch."""
    rng = np.random.default_rng(log_b)
    n_from, n_to = 64, 32
    ka = rng.integers(0, 1 << 64, size=(d, n_from, n_to), dtype=np.uint64)
    kb = rng.integers(0, 1 << 64, size=(d, n_from), dtype=np.uint64)
    ca = rng.integers(0, 1 << 64, size=(6, n_from), dtype=np.uint64)
    cb = rng.integers(0, 1 << 64, size=(6,), dtype=np.uint64)
    jparams = jtfhe.TlweParams(log_p=4, padding=1, n=n_to, std_dev=1e-8, log_b=log_b, d=d)
    params = tfhe.TlweParams(log_p=4, padding=1, n=n_to, std_dev=1e-8, log_b=log_b, d=d)
    want = jtlwe.key_switch(
        jparams,
        jtlwe.TlweKeySwitchingKey(jnp.asarray(ka), jnp.asarray(kb)),
        jtlwe.TlweCiphertext(jnp.asarray(ca), jnp.asarray(cb)),
    )
    got = tlwe.key_switch(
        params,
        tlwe.TlweKeySwitchingKey(u64_to_torch(ka), u64_to_torch(kb)),
        tlwe.TlweCiphertext(u64_to_torch(ca), u64_to_torch(cb)),
    )
    np.testing.assert_array_equal(torch_to_u64(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(torch_to_u64(got.b), np.asarray(want.b))


def test_blind_rotate_steps_matches_jax(env):
    """The n steps of `blind_rotate_steps` (on CPU tensors, its plain loop)
    against the JAX `blind_rotate`, with exponents 0, N, 2N-1 and 2N."""
    jparams, params, _, jkey, key = env
    n, big_n = params.tlwe.n, params.big_n
    rng = np.random.default_rng(5)
    a2n = rng.integers(0, 2 * big_n + 1, size=(3, n))
    a2n[0, :4] = [0, big_n, 2 * big_n - 1, 2 * big_n]
    b2n = rng.integers(0, 2 * big_n + 1, size=3)
    tab = tfhe.lut_table(params.tlwe.log_p, big_n, lambda v: 3 * v + 1)
    want = jtfhe.blind_rotate(
        jparams,
        jkey,
        jtfhe.tglwe.encode(jparams.tglwe, jnp.asarray(tab)),
        jnp.asarray(a2n),
        jnp.asarray(b2n),
    )

    b = torch.from_numpy(b2n)
    acc0 = tglwe.TglweCiphertext(
        torch.zeros((3, 1, big_n), dtype=torch.int64),
        tglwe.encode(params.tglwe, u64_to_torch(tab)).expand(3, big_n),
    )
    acc = tglwe.rotate(acc0, (-b) % (2 * big_n))
    exps = torch.from_numpy(a2n).t().contiguous()
    out = tggsw.blind_rotate_steps(params.tggsw, key.brk, acc, exps, key.mon_v, key.mon_d)
    assert out.a is acc.a and out.b is acc.b  # updated in place
    np.testing.assert_array_equal(torch_to_u64(out.a), np.asarray(want.a))
    np.testing.assert_array_equal(torch_to_u64(out.b), np.asarray(want.b))


def _pbs_check(jparams, params, z, jkey, key, batch, rng):
    """Encrypt `batch` messages once, bootstrap them with the identity LUT in
    both packages, require identical ciphertexts that decrypt to the input."""
    p = params.tlwe.p
    ms = np.arange(batch, dtype=np.uint64) % p
    jcts = jtlwe.sk_encrypt(jparams.tlwe, z, jtlwe.encode(jparams.tlwe, jnp.asarray(ms)), rng)
    tab = tfhe.lut_table(params.tlwe.log_p, params.big_n, lambda v: v)

    v_enc = jtfhe.tglwe.encode(jparams.tglwe, jnp.asarray(tab))
    a2n, b2n = jtfhe.mod_switch_2n(jcts, jparams.big_n)
    want = jax_pbs_batch_device(jparams, jkey, v_enc, a2n, b2n)

    cts = tlwe.TlweCiphertext(u64_to_torch(jcts.a), u64_to_torch(jcts.b))
    got = tfhe_pbs_batch(params, key, u64_to_torch(tab), cts)
    np.testing.assert_array_equal(torch_to_u64(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(torch_to_u64(got.b), np.asarray(want.b))
    decoded = tlwe.decode(params.tlwe, tlwe.decrypt(params.tlwe, z, got))
    np.testing.assert_array_equal(decoded.numpy(), ms.astype(np.int64))
    return cts, tab, got


def test_pbs_batch_matches_jax(env):
    jparams, params, z, jkey, key = env
    cts, tab, got = _pbs_check(jparams, params, z, jkey, key, 8, np.random.default_rng(1))
    module_out = tfhe.TfheBootstrap(params, key)(u64_to_torch(tab), cts)
    assert torch.equal(module_out.a, got.a) and torch.equal(module_out.b, got.b)


@pytest.mark.slow
def test_pbs_reference_fixture_matches_jax():
    """The reference fixture (N=2048, n=1024): keys and a batch-4 PBS."""
    jparams, params, z, jkey, key = _keys(REFERENCE, 23)
    _assert_keys_equal(key, jkey)
    _pbs_check(jparams, params, z, jkey, key, 4, np.random.default_rng(2))


def test_port_imports_no_jax():
    """Importing every module of the port leaves JAX out of the process."""
    pkg = REPO / "learn_fhe_tpu_torch"
    mods = sorted(
        ".".join(f.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for f in pkg.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'learn_fhe_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert len(mods) >= 15
