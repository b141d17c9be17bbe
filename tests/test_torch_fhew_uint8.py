"""Port vs JAX: the encrypted types FhewBool and FhewU8 on the CPU.

At `tests/test_fhew.py::small_boot_params` (u32 engine: q = 268432897,
N=128, B=2^7, d=4; LWE n=16; w=5), both packages make their key from one
seed and encrypt the same values from one seed; every circuit then runs in
both, gate round by gate round, and every output bit's LWE ciphertext must
be bit-identical, and decrypt to the wrapping u8 (or boolean) answer. The
JAX side runs with `gate_pad=(16, 64)`, which pads each gate batch for its
jit cache and changes no real gate's output; the port ignores the field.

The multi-key case takes the 54-bit fixture of
`tests/test_torch_fhew_multikey.py` (u64 engine), whose key and public key
that file holds bit-identical to the JAX package's: here the port's are
handed to both packages.

The 64-lane sweeps of `tests/test_uint8.py` are marked `slow`: they repeat
the circuits above on more lanes.
"""

from dataclasses import replace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import learn_fhe_tpu.models.fhew as J  # noqa: E402
from learn_fhe_tpu.utils.primes import two_adic_primes  # noqa: E402
import learn_fhe_tpu_torch.models.fhew as T  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u64  # noqa: E402


def _small(mod):
    q = next(two_adic_primes(28, 8))
    rlwe_p = mod.RlweParams(q=q, p=4, log_n=7, log_b=7, d=4)
    return mod.BootstrapParams(mod.RgswParams(rlwe_p, log_b=7, d=4), mod.LweParams(q=1 << 16, p=4, n=16, log_b=4, d=4), w=5)


@pytest.fixture(scope="module")
def env():
    jparams, tparams = replace(_small(J), gate_pad=(16, 64)), _small(T)
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    jz, tz = J.rlwe.sk_gen(jparams.rlwe, jrng), T.rlwe.sk_gen(tparams.rlwe, trng)
    jkey = J.key_gen(jparams, jz, jrng)
    tkey = T.key_gen(tparams, tz, trng, "cpu")
    return (jparams, jz, jkey), (tparams, tz, tkey)


def _same_bits(tbits, jbits):
    for i, (t, j) in enumerate(zip(tbits, jbits)):
        np.testing.assert_array_equal(torch_to_u64(t.ct.a), np.asarray(j.ct.a), err_msg=f"bit {i} a")
        np.testing.assert_array_equal(torch_to_u64(t.ct.b), np.asarray(j.ct.b), err_msg=f"bit {i} b")


def _u8_pair(env, seed, *values):
    """FhewU8 encryptions of `values` in both packages from one seed."""
    (jparams, jz, jkey), (tparams, tz, tkey) = env
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    js = [J.FhewU8.sk_encrypt(jparams, jkey, jz, v, jrng) for v in values]
    ts = [T.FhewU8.sk_encrypt(tparams, tkey, tz, v, trng) for v in values]
    for t, j in zip(ts, js):
        _same_bits(t.bits, j.bits)
    return js, ts


def _check(env, t, j, want):
    """t (port) and j (JAX) bit-identical, and t decrypts to want."""
    _same_bits(t.bits, j.bits)
    got = t.decrypt(env[1][1])
    np.testing.assert_array_equal(got, want)


def test_boolean_adders_match_jax(env):
    """The cases of `tests/test_fhew.py::test_boolean_adders` as the lanes of
    vectorized FhewBools: half adder and subtractor on the 4 input pairs,
    full adder and subtractor on the 8 triples, select on both selectors."""
    (jparams, jz, jkey), (tparams, tz, tkey) = env
    a = np.array([0, 0, 1, 1, 0, 0, 1, 1], dtype=bool)
    b = np.array([0, 1, 0, 1, 0, 1, 0, 1], dtype=bool)
    c = np.array([0, 0, 0, 0, 1, 1, 1, 1], dtype=bool)
    jrng, trng = np.random.default_rng(8), np.random.default_rng(8)
    ja, jb, jc = (J.FhewBool.sk_encrypt(jparams, jkey, jz, m, jrng) for m in (a, b, c))
    ta, tb, tc = (T.FhewBool.sk_encrypt(tparams, tkey, tz, m, trng) for m in (a, b, c))
    ai, bi, ci = a.astype(int), b.astype(int), c.astype(int)
    cases = [
        (ta.overflowing_add(tb), ja.overflowing_add(jb), ((ai + bi) % 2, ai + bi >= 2)),
        (ta.overflowing_sub(tb), ja.overflowing_sub(jb), ((ai - bi) % 2, ai - bi < 0)),
        (ta.carrying_add(tb, tc), ja.carrying_add(jb, jc), ((ai + bi + ci) % 2, ai + bi + ci >= 2)),
        (ta.borrowing_sub(tb, tc), ja.borrowing_sub(jb, jc), ((ai - bi - ci) % 2, ai - bi - ci < 0)),
        ((tc.select(ta, tb),), (jc.select(ja, jb),), (np.where(c, b, a),)),
    ]
    for touts, jouts, wants in cases:
        _same_bits(touts, jouts)
        for t, want in zip(touts, wants):
            np.testing.assert_array_equal(t.decrypt(tz), np.asarray(want, dtype=bool))


def test_u8_roundtrip_matches_jax(env):
    values = (0, 1, 0x5A, 0xFF)
    _, ts = _u8_pair(env, 1, *values)
    assert [t.decrypt(env[1][1]) for t in ts] == list(values)


def test_u8_add_sub_neg_match_jax(env):
    a, b = 177, 103
    (ja, jb), (ta, tb) = _u8_pair(env, 2, a, b)
    _check(env, ta.wrapping_add(tb), ja.wrapping_add(jb), (a + b) % 256)
    _check(env, ta.wrapping_sub(tb), ja.wrapping_sub(jb), (a - b) % 256)
    _check(env, tb.wrapping_sub(ta), jb.wrapping_sub(ja), (b - a) % 256)
    _check(env, ta.wrapping_neg(), ja.wrapping_neg(), (-a) % 256)
    (jx, jy), (tx, ty) = _u8_pair(env, 3, 200, 100)
    (ts, tc), (js, jc) = tx.overflowing_add(ty), jx.overflowing_add(jy)
    _check(env, ts, js, 300 % 256)
    _same_bits([tc], [jc])
    assert tc.decrypt(env[1][1]) is True


def test_u8_mul_matches_jax(env):
    a, b = 23, 11
    (ja, jb), (ta, tb) = _u8_pair(env, 4, a, b)
    _check(env, ta.wrapping_mul(tb), ja.wrapping_mul(jb), (a * b) % 256)


def test_u8_div_rem_matches_jax(env):
    a, b = 180, 7
    (ja, jb), (ta, tb) = _u8_pair(env, 5, a, b)
    (tq, tr), (jq, jr) = ta.div_rem(tb), ja.div_rem(jb)
    _check(env, tq, jq, a // b)
    _check(env, tr, jr, a % b)


def test_vectorized_u8_lanes_match_jax(env):
    """One FhewU8 holding 8 values: add and mul lane-parallel (8 lanes, as
    the boolean test's, so that the JAX side compiles fewer batch shapes)."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, size=8).astype(np.uint8)
    b = rng.integers(1, 256, size=8).astype(np.uint8)
    (ja, jb), (ta, tb) = _u8_pair(env, 6, a, b)
    _check(env, ta + tb, ja + jb, a + b)
    _check(env, ta * tb, ja * jb, a * b)


@pytest.mark.slow
def test_u8_sweep_matches_jax(env):
    """`tests/test_uint8.py`'s 64-lane sweep (with the div/rem edge lanes a=0,
    a<b, b=1, a=b=255) through add, sub, neg, mul and div_rem."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, size=64).astype(np.uint8)
    b = rng.integers(1, 256, size=64).astype(np.uint8)
    a[:4], b[:4] = [0, 5, 123, 255], [7, 200, 1, 255]
    (ja, jb), (ta, tb) = _u8_pair(env, 7, a, b)
    ai, bi = a.astype(int), b.astype(int)
    _check(env, ta + tb, ja + jb, (ai + bi) % 256)
    _check(env, ta - tb, ja - jb, (ai - bi) % 256)
    _check(env, ta.wrapping_neg(), ja.wrapping_neg(), (-ai) % 256)
    _check(env, ta * tb, ja * jb, (ai * bi) % 256)
    (tq, tr), (jq, jr) = ta.div_rem(tb), ja.div_rem(jb)
    _check(env, tq, jq, ai // bi)
    _check(env, tr, jr, ai % bi)


def test_multikey_pk_encrypted_u8_add_and_threshold_decrypt():
    """FhewU8.wrapping_add of two pk-encrypted values under the 54-bit
    multi-key fixture (u64 engine): the port's merged key and pk (bit-equal
    to the JAX package's, `tests/test_torch_fhew_multikey.py`) in both
    packages, bit-identical outputs and decryption shares, and the
    threshold decryption."""
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as tboot

    q = next(two_adic_primes(54, 8))
    tparams = T.BootstrapParams(
        T.RgswParams(T.RlweParams(q=q, p=4, log_n=7, log_b=6, d=9), log_b=6, d=9),
        T.LweParams(q=1 << 16, p=4, n=16, log_b=4, d=4),
        w=5,
    )
    jparams = J.BootstrapParams(
        J.RgswParams(J.RlweParams(q=q, p=4, log_n=7, log_b=6, d=9), log_b=6, d=9),
        J.LweParams(q=1 << 16, p=4, n=16, log_b=4, d=4),
        w=5,
        gate_pad=(16, 64),
    )
    rng = np.random.default_rng(5)
    crs = T.crs_gen(tparams, rng, "cpu")
    sks = [T.rlwe.sk_gen(tparams.rlwe, rng) for _ in range(2)]
    pk = T.rlwe.pk_share_merge(tparams.rlwe, crs.pk_a, [T.rlwe.pk_share_gen(tparams.rlwe, crs.pk_a, sk, rng) for sk in sks])
    tkey = tboot.key_share_merge(tparams, crs, [tboot.key_share_gen(tparams, crs, sk, pk, rng) for sk in sks])

    def to_jax(t):
        if t is None:
            return None
        return jnp.asarray(t.numpy()) if t.dtype in (torch.bool, torch.int32) else jnp.asarray(torch_to_u64(t))

    jkey = J.BootstrapKey(*(to_jax(t) for t in tkey))
    jpk = J.rlwe.RlweCiphertext(to_jax(pk.a), to_jax(pk.b))
    a, b = 201, 77
    outs = []
    for M, params, key, p in ((J, jparams, jkey, jpk), (T, tparams, tkey, pk)):
        rng = np.random.default_rng(12)
        x, y = M.FhewU8.pk_encrypt(params, key, p, a, rng), M.FhewU8.pk_encrypt(params, key, p, b, rng)
        s = x.wrapping_add(y)
        shares = [s.share_decrypt(sk, rng) for sk in sks]
        outs.append((s, shares, s.decryption_share_merge(shares)))
    (js, jshares, jgot), (ts, tshares, tgot) = outs
    _same_bits(ts.bits, js.bits)
    for tp, jp in zip(tshares, jshares):
        for t, j in zip(tp, jp):
            np.testing.assert_array_equal(torch_to_u64(t), np.asarray(j))
    assert tgot == jgot == (a + b) % 256
