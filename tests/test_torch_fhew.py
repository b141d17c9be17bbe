"""Port vs JAX: the FHEW gate bootstrap on the CPU, at the small fixture of
`tests/test_fhew.py::small_boot_params` (N=128, n=16, w=5, q=268432897).

The same inputs, made from a numpy seed, go through the JAX package and the
port's plain path. Everything is exact integer arithmetic mod q (and the
f64 modulus switches decode exactly), so every comparison is equality."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import learn_fhe_tpu.models.fhew as jfhew  # noqa: E402
from learn_fhe_tpu.models.fhew import bootstrapping as jboot  # noqa: E402
from learn_fhe_tpu.models.fhew import gates as jgates  # noqa: E402
from learn_fhe_tpu.models.fhew import lwe as jlwe  # noqa: E402
from learn_fhe_tpu.models.fhew import rgsw as jrgsw  # noqa: E402
from learn_fhe_tpu.models.fhew import rlwe as jrlwe  # noqa: E402
from learn_fhe_tpu.ops import gadget as jgadget  # noqa: E402
from learn_fhe_tpu.ops import modular as jmodular  # noqa: E402
from learn_fhe_tpu.ops import poly as jpoly  # noqa: E402
from learn_fhe_tpu.parallel.batch import fhew_gate_batch as jax_gate_batch  # noqa: E402
from learn_fhe_tpu.utils.primes import two_adic_primes  # noqa: E402
import learn_fhe_tpu_torch.models.fhew as fhew  # noqa: E402
from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot  # noqa: E402
from learn_fhe_tpu_torch.models.fhew import gates, lwe, rgsw, rlwe  # noqa: E402
from learn_fhe_tpu_torch.ops import gadget, modular, poly  # noqa: E402
from learn_fhe_tpu_torch.parallel.batch import fhew_gate_batch  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import (  # noqa: E402
    fhew_bootstrap_key_from_numpy,
    torch_to_u32,
    torch_to_u64,
    u32_to_torch,
    u64_to_torch,
)


def _params(mod, bits, log_n, n_lwe, w):
    q = next(two_adic_primes(bits, log_n + 1))
    rlwe_p = mod.RlweParams(q=q, p=4, log_n=log_n, log_b=7, d=4)
    return mod.BootstrapParams(
        mod.RgswParams(rlwe_p, log_b=7, d=4), mod.LweParams(q=1 << 16, p=4, n=n_lwe, log_b=4, d=4), w=w
    )


SMALL = dict(bits=28, log_n=7, n_lwe=16, w=5)  # `tests/test_fhew.py::small_boot_params`
REFERENCE = dict(bits=28, log_n=9, n_lwe=100, w=10)  # `bench.py:289-295`, `boolean.rs:225-239`


def _keys(cfg, seed):
    """JAX and port keys from one seed, drawn in the same order."""
    jparams, params = _params(jfhew, **cfg), _params(fhew, **cfg)
    jrng, rng = np.random.default_rng(seed), np.random.default_rng(seed)
    jz, z = jrlwe.sk_gen(jparams.rlwe, jrng), rlwe.sk_gen(params.rlwe, rng)
    np.testing.assert_array_equal(jz, z)
    jkey = jax.tree.map(np.asarray, jboot.key_gen(jparams, jz, jrng))
    key = fhew.key_gen(params, z, rng, "cpu")
    return jparams, params, z, jkey, key


@pytest.fixture(scope="module")
def env():
    return _keys(SMALL, 11)


def _np(t: torch.Tensor) -> np.ndarray:
    """A port tensor as the JAX package's numpy dtype: int32 residues as u32,
    int64 values as u64."""
    return torch_to_u32(t) if t.dtype == torch.int32 else torch_to_u64(t) if t.dtype == torch.int64 else t.numpy()


def _assert_keys_equal(key, jkey):
    for f in fhew.BootstrapKey._fields:
        np.testing.assert_array_equal(_np(getattr(key, f)), np.asarray(getattr(jkey, f)), err_msg=f)


def test_key_gen_bit_identical(env):
    _, params, _, jkey, key = env
    _assert_keys_equal(key, jkey)
    assert key.brk_a.shape == (params.lwe_s.n, 8, params.n) and key.ak_a.shape == (params.w + 1, 4, params.n)


def test_fhew_bootstrap_key_from_numpy_round_trip(env):
    *_, jkey, key = env
    carried = fhew_bootstrap_key_from_numpy(jkey, device="cpu")
    for f in fhew.BootstrapKey._fields:
        assert torch.equal(getattr(carried, f), getattr(key, f)), f


def _u64(rng, q, shape):
    return rng.integers(0, q, size=shape, dtype=np.uint64)


def _op_decompose_zq32(env, rng):
    jparams, params, *_ = env
    q = params.big_q
    x = _u64(rng, q, (3, params.n))
    x[0, :4] = [0, 1, q - 1, q // 2]
    want = jgadget.decompose_zq32(jnp.asarray(x), jparams.rgsw.gadget)
    return torch_to_u32(gadget.decompose_zq32(u64_to_torch(x), params.rgsw.gadget)), want


def _op_decompose_zq_lwe(env, rng):
    jparams, params, *_ = env
    x = _u64(rng, params.big_q_ks, (3, 40))
    x[0, :4] = [0, 1, params.big_q_ks - 1, params.big_q_ks // 2]
    want = jgadget.decompose_zq(jnp.asarray(x), jparams.lwe_s.gadget)
    return torch_to_u64(gadget.decompose_zq(u64_to_torch(x), params.lwe_s.gadget)), want


def _op_automorphism_zq(env, rng):
    jparams, params, *_ = env
    q = params.big_q
    x = _u64(rng, q, (2, params.n))
    x[0, :3] = [0, 1, q - 1]
    got = [torch_to_u64(poly.automorphism_zq(u64_to_torch(x), t, q)) for t in params.ak_t]
    want = [np.asarray(jpoly.automorphism_zq(jnp.asarray(x), t, q)) for t in jparams.ak_t]
    return np.stack(got), np.stack(want)


def _op_monomial_mul_zq(env, rng):
    _, params, *_ = env
    q, n = params.big_q, params.n
    x = _u64(rng, q, (6, n))
    shifts = np.array([0, 1, n - 1, n, n + 3, 2 * n - 1])
    want = np.stack([np.asarray(jpoly.monomial_mul_zq(jnp.asarray(x[i]), int(s), q)) for i, s in enumerate(shifts)])
    return torch_to_u64(poly.monomial_mul_zq(u64_to_torch(x), torch.from_numpy(shifts), q)), want


def _op_sample_extract_a(env, rng):
    _, params, *_ = env
    q = params.big_q
    x = _u64(rng, q, (3, params.n))
    x[0, :2] = 0
    got = [torch_to_u64(poly.sample_extract_a(u64_to_torch(x), i, q)) for i in (0, 5, params.n - 1)]
    want = [np.asarray(jpoly.sample_extract_a(jnp.asarray(x), i, q)) for i in (0, 5, params.n - 1)]
    return np.stack(got), np.stack(want)


def _op_mod_switch(env, rng):
    """Q -> Q_ks on random values, and 2^16 -> 2^8, where v = 128 + 256k is
    a tie that rounds away from zero."""
    _, params, *_ = env
    x = _u64(rng, params.big_q, (64,))
    x[:3] = [0, 1, params.big_q - 1]
    ties = np.array([0, 127, 128, 129, 384, 65408, 65535], dtype=np.uint64)
    got = np.concatenate(
        [
            torch_to_u64(modular.mod_switch(u64_to_torch(x), params.big_q, params.big_q_ks)),
            torch_to_u64(modular.mod_switch(u64_to_torch(ties), 1 << 16, 1 << 8)),
        ]
    )
    want = np.concatenate(
        [
            np.asarray(jmodular.mod_switch(jnp.asarray(x), params.big_q, params.big_q_ks)),
            np.asarray(jmodular.mod_switch(jnp.asarray(ties), 1 << 16, 1 << 8)),
        ]
    )
    return got, want


def _op_mod_switch_odd(env, rng):
    """Q_ks -> 2N, with floor 0 (v < 2^16 / 2N, rounded to nearest, 0.5 away
    from zero) and the forced-odd floors."""
    _, params, *_ = env
    q_ks, two_n = params.big_q_ks, params.q
    step = q_ks // two_n
    x = _u64(rng, q_ks, (64,))
    x[:8] = [0, 1, step // 2 - 1, step // 2, step - 1, step, 3 * step // 2, q_ks - 1]
    got = torch_to_u64(modular.mod_switch_odd(u64_to_torch(x), q_ks, two_n))
    return got, np.asarray(jmodular.mod_switch_odd(jnp.asarray(x), q_ks, two_n))


def _op_lwe_key_switch(env, rng):
    jparams, params, _, jkey, key = env
    a = _u64(rng, params.big_q_ks, (5, params.n))
    b = _u64(rng, params.big_q_ks, (5,))
    want = jlwe.key_switch(
        jparams.lwe_s, jlwe.LweKeySwitchingKey(jnp.asarray(jkey.ksk_a), jnp.asarray(jkey.ksk_b)),
        jlwe.LweCiphertext(jnp.asarray(a), jnp.asarray(b)),
    )  # fmt: skip
    got = lwe.key_switch(
        params.lwe_s, lwe.LweKeySwitchingKey(key.ksk_a, key.ksk_b), lwe.LweCiphertext(u64_to_torch(a), u64_to_torch(b))
    )
    return np.concatenate([_np(got.a).ravel(), _np(got.b)]), np.concatenate([np.asarray(want.a).ravel(), np.asarray(want.b)])


def _ct(rng, params, batch):
    return (_u64(rng, params.big_q, (batch, params.n)), _u64(rng, params.big_q, (batch, params.n)))


def _op_external_product(env, rng):
    jparams, params, _, jkey, key = env
    a, b = _ct(rng, params, 3)
    e = 5
    jk = jrgsw.RgswEval(*(jnp.asarray(getattr(jkey, f)[e]) for f in ("brk_a", "brk_b", "brk_ad", "brk_bd")))
    want = jax.jit(jrgsw.external_product, static_argnums=0)(
        jparams.rgsw, jk, jrlwe.RlweCiphertext(jnp.asarray(a), jnp.asarray(b))
    )
    k = rgsw.RgswEval(key.brk_a[e], key.brk_b[e], key.brk_ad[e], key.brk_bd[e])
    got = rgsw.external_product(params.rgsw, k, rlwe.RlweCiphertext(u64_to_torch(a), u64_to_torch(b)))
    return np.stack([_np(got.a), _np(got.b)]), np.stack([np.asarray(want.a), np.asarray(want.b)])


def _op_rlwe_key_switch(env, rng):
    jparams, params, _, jkey, key = env
    a, b = _ct(rng, params, 3)
    i = 2
    jk = jrlwe.RlweKeySwitchingKey(*(jnp.asarray(getattr(jkey, f)[i]) for f in ("ak_a", "ak_b", "ak_ad", "ak_bd")))
    want = jax.jit(jrlwe.key_switch, static_argnums=0)(
        jparams.rlwe, jk, jrlwe.RlweCiphertext(jnp.asarray(a), jnp.asarray(b))
    )
    k = rlwe.RlweKeySwitchingKey(key.ak_a[i], key.ak_b[i], key.ak_ad[i], key.ak_bd[i])
    got = rlwe.key_switch(params.rlwe, k, rlwe.RlweCiphertext(u64_to_torch(a), u64_to_torch(b)))
    return np.stack([_np(got.a), _np(got.b)]), np.stack([np.asarray(want.a), np.asarray(want.b)])


def _op_rlwe_automorphism(env, rng):
    jparams, params, _, jkey, key = env
    a, b = _ct(rng, params, 2)
    i = 3
    jk = jrlwe.RlweKeySwitchingKey(*(jnp.asarray(getattr(jkey, f)[i]) for f in ("ak_a", "ak_b", "ak_ad", "ak_bd")))
    want = jrlwe.automorphism(
        jparams.rlwe, jrlwe.RlweAutoKey(jparams.ak_t[i], jk), jrlwe.RlweCiphertext(jnp.asarray(a), jnp.asarray(b))
    )
    k = rlwe.RlweKeySwitchingKey(key.ak_a[i], key.ak_b[i], key.ak_ad[i], key.ak_bd[i])
    got = rlwe.automorphism(
        params.rlwe, rlwe.RlweAutoKey(params.ak_t[i], k), rlwe.RlweCiphertext(u64_to_torch(a), u64_to_torch(b))
    )
    return np.stack([_np(got.a), _np(got.b)]), np.stack([np.asarray(want.a), np.asarray(want.b)])


OPS = {
    "decompose_zq32": _op_decompose_zq32,
    "decompose_zq_lwe": _op_decompose_zq_lwe,
    "automorphism_zq": _op_automorphism_zq,
    "monomial_mul_zq": _op_monomial_mul_zq,
    "sample_extract_a": _op_sample_extract_a,
    "mod_switch": _op_mod_switch,
    "mod_switch_odd": _op_mod_switch_odd,
    "lwe_key_switch": _op_lwe_key_switch,
    "external_product": _op_external_product,
    "rlwe_key_switch": _op_rlwe_key_switch,
    "rlwe_automorphism": _op_rlwe_automorphism,
}


@pytest.mark.parametrize("op", list(OPS))
def test_op_matches_jax(env, op):
    got, want = OPS[op](env, np.random.default_rng(len(op)))
    np.testing.assert_array_equal(got, np.asarray(want))


def _odd_masks(params, rng, batch):
    return 2 * rng.integers(0, params.n, size=(batch, params.lwe_s.n)) + 1


def test_schedule_matches_jax(env):
    """build_schedule + fuse_schedule on 64 random odd masks: the same pairs
    as the JAX package's, whose tail is padded with (-1, -1) to its trimmed
    length; `schedule` on a CPU tensor gives the same."""
    jparams, params, *_ = env
    a = _odd_masks(params, np.random.default_rng(3), 64)
    a[0, :3] = [1, params.q - 1, 5]
    ops, idxs = boot.build_schedule(params, a)
    jops, jidxs = jboot.build_schedule(jparams, a)
    np.testing.assert_array_equal(ops, jops)
    np.testing.assert_array_equal(idxs, jidxs)
    e_idx, a_idx = boot.fuse_schedule(ops, idxs)
    je, ja = jboot.fuse_schedule(jops, jidxs)
    L = e_idx.shape[1]
    assert L <= je.shape[1] and (e_idx[:, -1] >= 0).any() | (a_idx[:, -1] >= 0).any()
    np.testing.assert_array_equal(e_idx, je[:, :L])
    np.testing.assert_array_equal(a_idx, ja[:, :L])
    assert (je[:, L:] == -1).all() and (ja[:, L:] == -1).all()
    te, ta = boot.schedule(params, torch.from_numpy(a))
    np.testing.assert_array_equal(te.numpy(), e_idx)
    np.testing.assert_array_equal(ta.numpy(), a_idx)


def test_blind_rotate_core_fused_ref_matches_jax(env):
    """The plain walk over a batch of 3 against the JAX scan per ciphertext."""
    jparams, params, _, jkey, key = env
    rng = np.random.default_rng(4)
    a2n = _odd_masks(params, rng, 3)
    f_prime = _u64(rng, params.big_q, (3, params.n))
    e_idx, a_idx = boot.fuse_schedule(*boot.build_schedule(params, a2n))
    acc = rlwe.RlweCiphertext(torch.zeros((3, params.n), dtype=torch.int32), u32_to_torch(f_prime.astype(np.uint32)))
    got = boot.blind_rotate_core_fused(params, key, torch.from_numpy(e_idx), torch.from_numpy(a_idx), acc)
    assert got.a.dtype == torch.int32 and got.a.shape == (3, params.n)
    for i in range(3):
        fp = jnp.asarray(f_prime[i])
        want = jboot.blind_rotate_core_fused(
            jparams, jkey, jnp.asarray(e_idx[i]), jnp.asarray(a_idx[i]), jboot.RlweCiphertext(jnp.zeros_like(fp), fp)
        )
        np.testing.assert_array_equal(torch_to_u32(got.a[i]).astype(np.uint64), np.asarray(want.a))
        np.testing.assert_array_equal(torch_to_u32(got.b[i]).astype(np.uint64), np.asarray(want.b))


TRUTH = {
    "and": lambda a, b: a & b,
    "nand": lambda a, b: 1 - (a & b),
    "or": lambda a, b: a | b,
    "nor": lambda a, b: 1 - (a | b),
    "xor": lambda a, b: a ^ b,
    "xnor": lambda a, b: 1 - (a ^ b),
}


def _encrypt(jparams, z, m, rng):
    """JAX ciphertexts of the bits m under z, and the port's copies of them."""
    lz = jparams.lwe_z
    jct = jlwe.sk_encrypt(lz, z, jlwe.encode(lz, jnp.asarray(np.asarray(m, dtype=np.uint64))), rng)
    return jct, lwe.LweCiphertext(u64_to_torch(np.asarray(jct.a)), u64_to_torch(np.asarray(jct.b)))


def _decrypt_bits(params, z, ct):
    return gates.decode_bool(params, lwe.decrypt(params.lwe_z, z, ct)).long().numpy()


def _gate_check(jparams, params, z, jkey, key, name, m0, m1, rng):
    jc0, c0 = _encrypt(jparams, z, m0, rng)
    jc1, c1 = _encrypt(jparams, z, m1, rng)
    want = jax_gate_batch(jparams, jkey, name, jc0, jc1)
    got = fhew_gate_batch(params, key, name, c0, c1)
    np.testing.assert_array_equal(_np(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(_np(got.b), np.asarray(want.b))
    np.testing.assert_array_equal(_decrypt_bits(params, z, got), TRUTH[name](np.asarray(m0), np.asarray(m1)))


@pytest.mark.parametrize("name", list(TRUTH))
def test_gate_batch_matches_jax(env, name):
    """fhew_gate_batch over the 4 input pairs, twice: bit-identical
    ciphertexts that decrypt to the truth table. (A batch of 8 is the shape
    the JAX package pads the 7-gate batch below to, so its compiled walk is
    shared.)"""
    jparams, params, z, jkey, key = env
    m0, m1 = [0, 0, 1, 1] * 2, [0, 1, 0, 1] * 2
    _gate_check(jparams, params, z, jkey, key, name, m0, m1, np.random.default_rng(len(name)))


def test_mixed_gate_batch_matches_jax(env):
    """gate_batch over all 7 gates (majority with 3 inputs) in one bootstrap,
    and `not_`, against the JAX package's gate_batch."""
    jparams, params, z, jkey, key = env
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, size=(7, 3))
    jspecs, specs, want_bits = [], [], []
    for (name, fn), (x, y, c) in zip([*TRUTH.items(), ("majority", None)], bits):
        cts = [_encrypt(jparams, z, v, rng) for v in (x, y, c)]
        n_in = 3 if fn is None else 2
        jspecs.append((name, *(j for j, _ in cts[:n_in])))
        specs.append((name, *(t for _, t in cts[:n_in])))
        want_bits.append(int(x + y + c >= 2) if fn is None else int(fn(x, y)))
    want = jgates.gate_batch(jparams, jkey, jspecs)
    got = gates.gate_batch(params, key, specs)
    for g, w, m in zip(got, want, want_bits):
        np.testing.assert_array_equal(_np(g.a), np.asarray(w.a))
        np.testing.assert_array_equal(_np(g.b), np.asarray(w.b))
        assert int(_decrypt_bits(params, z, g)) == m
    one = gates.gate(params, key, *specs[-1])  # majority alone: the same bootstrap as in the batch
    assert torch.equal(one.a, got[-1].a) and torch.equal(one.b, got[-1].b)
    jct, ct = _encrypt(jparams, z, 1, rng)
    got_not, want_not = gates.not_(params, ct), jgates.not_(jparams, jct)
    np.testing.assert_array_equal(_np(got_not.b), np.asarray(want_not.b))
    assert int(_decrypt_bits(params, z, got_not)) == 0


def test_gate_luts_are_cached_and_never_written(env):
    """`gates.lut_poly` makes one tensor per (Q, N, table, device) and hands
    the same one out again, so no gate call copies a LUT from the host; a
    gate batch of one gate (its one (N,) LUT read for every ciphertext) and
    one of mixed gates leave every cached LUT as it was."""
    jparams, params, z, _, key = env
    nand = gates.lut_poly(params, gates.GATE_TABLES["nand"])
    assert gates.lut_poly(params, gates.GATE_TABLES["nand"], "cpu") is nand
    assert nand.shape == (params.n,) and not torch.equal(gates.lut_poly(params, gates.GATE_TABLES["and"]), nand)
    before = {name: gates.lut_poly(params, t).clone() for name, t in gates.GATE_TABLES.items()}
    rng = np.random.default_rng(12)
    cts = [_encrypt(jparams, z, [0, 1, 1, 0], rng)[1] for _ in range(3)]
    same = gates.gate_batch(params, key, [("nand", cts[0], cts[1]), ("nand", cts[1], cts[2])])
    mixed = gates.gate_batch(params, key, [("xor", cts[0], cts[1]), ("majority", *cts)])
    for name, t in gates.GATE_TABLES.items():
        assert torch.equal(gates.lut_poly(params, t), before[name]), name
    assert list(_decrypt_bits(params, z, same[0])) == [1, 0, 0, 1] and list(_decrypt_bits(params, z, mixed[0])) == [0, 0, 0, 0]


def test_bootstrap_matches_the_batch_pipeline(env):
    """`bootstrap` on a batch and on one ciphertext gives what
    `fhew_bootstrap_batch` (held against the JAX package above) gives."""
    from learn_fhe_tpu_torch.parallel.batch import fhew_bootstrap_batch

    jparams, params, z, _, key = env
    _, ct = _encrypt(jparams, z, [0, 1, 1], np.random.default_rng(6))
    f = gates.lut_poly(params, gates.GATE_TABLES["and"])
    want = fhew_bootstrap_batch(params, key, f, ct)
    got = boot.bootstrap(params, key, f, ct)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    one = boot.bootstrap(params, key, f, lwe.LweCiphertext(ct.a[1], ct.b[1]))
    assert one.a.shape == (params.n,) and torch.equal(one.a, want.a[1]) and torch.equal(one.b, want.b[1])


def test_unported_moduli_raise():
    """The port takes every odd q < 2^63 with a 2N-th root of unity: above
    2^31 on the u64 engine (a 45-bit prime here). The moduli it does not
    take raise when their NTT plan is made: q >= 2^63, and a q with no
    2N-th root of unity."""
    q45 = next(two_adic_primes(45, 8))
    params = fhew.RlweParams(q=q45, p=4, log_n=7, log_b=7, d=4)
    assert not params.use_u32 and params.plan.q == q45
    for q in (next(two_adic_primes(64, 8)), (1 << 31) - 1):
        with pytest.raises(AssertionError):
            fhew.RlweParams(q=q, p=4, log_n=7, log_b=7, d=4).plan


@pytest.mark.slow
def test_reference_fixture_matches_jax():
    """The reference fixture (N=512, n=100, w=10): keys and one NAND batch."""
    jparams, params, z, jkey, key = _keys(REFERENCE, 0)
    _assert_keys_equal(key, jkey)
    _gate_check(jparams, params, z, jkey, key, "nand", [0, 0, 1, 1], [0, 1, 0, 1], np.random.default_rng(1))
