"""The port's CKKS (`learn_fhe_tpu_torch/models/ckks`) against the JAX
package's (`learn_fhe_tpu/models/ckks/ckks.py`), on the CPU's plain path:
one seed's keys, ciphertexts and every homomorphic op bit for bit, and the
decoded complex128 slots equal (the same host double-double code), on the
`tests/test_ckks.py` fixture (N=32, L=8, 55-bit primes) and the
`tests/test_ckks_dnum.py` fixture (a 45/55-bit ladder, two 55-bit p-primes,
3 key-switch digits). Also the key carry-over from the JAX package
(`utils/interop.py`), a batch axis, and the entry points' device."""

from types import SimpleNamespace as NS

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learn_fhe_tpu.models.ckks import ckks as JC  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import ckks as TC  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import (  # noqa: E402
    ckks_ciphertext_from_numpy,
    ckks_ksk_from_numpy,
    torch_to_u64,
    u64_to_torch,
)


def _same(j, t):
    np.testing.assert_array_equal(torch_to_u64(t), np.asarray(j))


def _same_ct(j, t):
    assert j.qs == t.qs
    _same(j.b, t.b)
    _same(j.a, t.a)


def _sample(l, rng):
    return rng.random(l) + 1j * rng.random(l)


class Pair:
    """Two Generators from one seed: one feeds the JAX package, one the port;
    both must draw the same numbers in the same order."""

    def __init__(self, seed):
        self.j, self.t = np.random.default_rng(seed), np.random.default_rng(seed)


@pytest.fixture(scope="module")
def env():
    jp = JC.CkksParams(log_n=5, log_qi=55, big_l=8)
    tp = TC.CkksParams(log_n=5, log_qi=55, big_l=8)
    assert (jp.qs, jp.ps) == (tp.qs, tp.ps)
    r = Pair(9)
    sk = JC.sk_gen(jp, r.j)
    np.testing.assert_array_equal(TC.sk_gen(tp, r.t), sk)
    e = NS(jp=jp, tp=tp, sk=sk, r=r)
    e.jpk, e.tpk = JC.pk_gen(jp, sk, r.j), TC.pk_gen(tp, sk, r.t, device="cpu")
    e.jrlk, e.trlk = JC.rlk_gen(jp, sk, r.j), TC.rlk_gen(tp, sk, r.t, device="cpu")
    e.jcjk, e.tcjk = JC.cjk_gen(jp, sk, r.j), TC.cjk_gen(tp, sk, r.t, device="cpu")
    e.js = (1, 5, jp.l - 1)
    e.jrtk = {j: JC.rtk_gen(jp, sk, j, r.j) for j in e.js}
    e.trtk = {j: TC.rtk_gen(tp, sk, j, r.t, device="cpu") for j in e.js}
    ms = [_sample(jp.l, r.j) for _ in range(jp.big_l)]
    for m in ms:
        np.testing.assert_array_equal(_sample(tp.l, r.t), m)
    e.ms = ms
    e.jcts = [JC.pk_encrypt(jp, e.jpk, JC.encode(jp, m), r.j) for m in ms]
    e.tcts = [TC.pk_encrypt(tp, e.tpk, TC.encode(tp, m, device="cpu"), r.t) for m in ms]
    return e


def test_keys_match_jax(env):
    _same_ct(env.jpk, env.tpk)
    for jk, tk in [(env.jrlk, env.trlk), (env.jcjk, env.tcjk), *((env.jrtk[j].ksk, env.trtk[j].ksk) for j in env.js)]:
        _same_ct(jk, tk)
    assert all(env.trtk[j].j == env.jrtk[j].j for j in env.js)
    assert env.trlk.b.device.type == "cpu"


def test_rtk_gen_many_matches_jax(env):
    r = Pair(11)
    jk = JC.rtk_gen_many(env.jp, env.sk, [1, 3, 7], r.j)
    tk = TC.rtk_gen_many(env.tp, env.sk, [1, 3, 7], r.t, device="cpu")
    assert sorted(jk) == sorted(tk)
    for j in jk:
        _same_ct(jk[j].ksk, tk[j].ksk)


def test_encrypt_decrypt_encode_decode_match_jax(env):
    jp, tp, sk = env.jp, env.tp, env.sk
    for jct, tct, m in zip(env.jcts, env.tcts, env.ms):
        _same_ct(jct, tct)
        jpt, tpt = JC.decrypt(jp, sk, jct), TC.decrypt(tp, sk, tct)
        _same(jpt, tpt)
        got = TC.decode(tp, tpt, tct.qs)
        np.testing.assert_array_equal(got, JC.decode(jp, jpt, jct.qs))
        assert np.max(np.abs(got - m)) < 2.0**-40
    r = Pair(12)
    m = _sample(jp.l, r.j)
    r.t.random(tp.l), r.t.random(tp.l)
    pt = TC.encode(tp, m, device="cpu")
    _same(JC.encode(jp, m), pt)
    _same_ct(JC.sk_encrypt(jp, sk, JC.encode(jp, m), jp.qs, r.j), TC.sk_encrypt(tp, sk, pt, tp.qs, r.t))


def test_add_sub_constants_match_jax(env):
    jp, tp = env.jp, env.tp
    (j0, j1), (t0, t1) = env.jcts[:2], env.tcts[:2]
    _same_ct(JC.add(j0, j1), TC.add(t0, t1))
    _same_ct(JC.sub(j0, j1), TC.sub(t0, t1))
    c = env.ms[2]
    _same_ct(JC.mul_constant(jp, c, j0), TC.mul_constant(tp, c, t0))
    _same_ct(JC.add_constant(jp, c, j0), TC.add_constant(tp, c, t0))
    mid_j, mid_t = JC.mul_constant(jp, c, j1), TC.mul_constant(tp, c, t1)
    _same_ct(JC.add(j0, mid_j), TC.add(t0, mid_t))  # two levels aligned


def test_mul_chain_to_the_last_level_matches_jax(env):
    """big_l - 1 = 7 muls, down to one limb, every ciphertext bit for bit;
    the decoded slots after 6 (`ckks.rs:359-377`, 32 bits) equal too."""
    jp, tp = env.jp, env.tp
    jacc, tacc, want = env.jcts[0], env.tcts[0], env.ms[0]
    for i, (jct, tct, m) in enumerate(zip(env.jcts[1:], env.tcts[1:], env.ms[1:])):
        jacc, tacc, want = JC.mul(jp, env.jrlk, jacc, jct), TC.mul(tp, env.trlk, tacc, tct), want * m
        _same_ct(jacc, tacc)
        if i == 5:
            got = TC.decode(tp, TC.decrypt(tp, env.sk, tacc), tacc.qs)
            np.testing.assert_array_equal(got, JC.decode(jp, JC.decrypt(jp, env.sk, jacc), jacc.qs))
            assert np.max(np.abs(got - want)) < 2.0**-32
    assert len(tacc.qs) == 1


def test_rotate_conjugate_hoisted_match_jax(env):
    jp, tp = env.jp, env.tp
    jct, tct = env.jcts[0], env.tcts[0]
    _same_ct(JC.conjugate(jp, env.jcjk, jct), TC.conjugate(tp, env.tcjk, tct))
    for j in env.js:
        out = TC.rotate(tp, env.trtk[j], tct)
        _same_ct(JC.rotate(jp, env.jrtk[j], jct), out)
        got = TC.decode(tp, TC.decrypt(tp, env.sk, out), out.qs)
        assert np.max(np.abs(got - np.roll(env.ms[0], -j))) < 2.0**-40
    jh = JC.hoisted_rotations(jp, tuple(env.jrtk[j] for j in env.js), jct, env.js)
    th = TC.hoisted_rotations(tp, tuple(env.trtk[j] for j in env.js), tct, env.js)
    for a, b in zip(jh, th):
        _same_ct(a, b)


def test_key_switch_at_a_partial_level_matches_jax(env):
    jp, tp = env.jp, env.tp
    jct = JC.to_level(env.jcts[1], jp.qs[:5])
    tct = TC.to_level(env.tcts[1], tp.qs[:5])
    _same_ct(jct, tct)
    _same_ct(JC.key_switch(jp, env.jrtk[1].ksk, jct), TC.key_switch(tp, env.trtk[1].ksk, tct))
    _same_ct(JC.rescale_ct(jct, 2), TC.rescale_ct(tct, 2))


def test_a_batch_axis_matches_each_ciphertext(env):
    """A (3, L, N) batch through mul, rotate and decrypt gives each
    ciphertext's JAX result."""
    jp, tp = env.jp, env.tp
    stack = lambda cts: TC.CkksCiphertext(torch.stack([c.b for c in cts]), torch.stack([c.a for c in cts]), cts[0].qs)  # noqa: E731
    t0, t1 = stack(env.tcts[0:3]), stack(env.tcts[3:6])
    prod = TC.mul(tp, env.trlk, t0, t1)
    rot = TC.rotate(tp, env.trtk[5], t0)
    pts = TC.decrypt(tp, env.sk, prod)
    for i in range(3):
        jprod = JC.mul(jp, env.jrlk, env.jcts[i], env.jcts[3 + i])
        _same(jprod.b, prod.b[i])
        _same(jprod.a, prod.a[i])
        _same(JC.decrypt(jp, env.sk, jprod), pts[i])
        jrot = JC.rotate(jp, env.jrtk[5], env.jcts[i])
        _same(jrot.b, rot.b[i])
        _same(jrot.a, rot.a[i])


def test_keys_carried_from_jax_give_the_same_outputs(env):
    """The JAX package's keys and ciphertexts, as numpy, carried into the
    port: the same outputs as the port's own keys."""
    np_leaves = lambda x: NS(b=np.asarray(x.b), a=np.asarray(x.a), qs=x.qs)  # noqa: E731
    rlk = ckks_ksk_from_numpy(np_leaves(env.jrlk), device="cpu")
    ct0 = ckks_ciphertext_from_numpy(np_leaves(env.jcts[0]), device="cpu")
    ct1 = ckks_ciphertext_from_numpy(np_leaves(env.jcts[1]), device="cpu")
    for a, b in ((rlk, env.trlk), (ct0, env.tcts[0])):
        assert torch.equal(a.b, b.b) and torch.equal(a.a, b.a) and a.qs == b.qs
    _same_ct(JC.mul(env.jp, env.jrlk, env.jcts[0], env.jcts[1]), TC.mul(env.tp, rlk, ct0, ct1))


def test_ksk_from_numpy_checks_its_shape():
    with pytest.raises(ValueError):
        ckks_ksk_from_numpy(NS(b=np.zeros((3, 8), np.uint64), a=np.zeros((3, 8), np.uint64), qs=(1, 2)), device="cpu")
    ct = ckks_ciphertext_from_numpy(NS(b=np.ones((2, 4), np.uint64), a=np.zeros((2, 4), np.uint64), qs=(3, 5)), device="cpu")
    assert torch.equal(ct.b, u64_to_torch(np.ones((2, 4), np.uint64))) and ct.qs == (3, 5)



def test_logistic_example_on_the_cpu():
    """`learn_fhe_tpu_torch/examples/ckks_logistic.py` at its default ring:
    its classifications agree with the cleartext model's, as the JAX
    example requires."""
    from learn_fhe_tpu_torch.examples.ckks_logistic import run

    out = run(10, "cpu", say=lambda *_: None)
    assert out["agree"] == 1.0 and out["err_poly"] < 1e-4


@pytest.mark.slow
@pytest.mark.parametrize("log_n", [10, 13])
def test_mul_rotate_at_production_rings_match_jax(log_n):
    """`tests/test_ckks_large.py`'s rings (N=2^10, the reference's largest,
    and 2^13, the benchmarked one): keys, a mul and a rotation bit for bit."""
    jp, tp = JC.CkksParams(log_n=log_n, log_qi=55, big_l=8), TC.CkksParams(log_n=log_n, log_qi=55, big_l=8)
    r = Pair(7)
    sk = JC.sk_gen(jp, r.j)
    TC.sk_gen(tp, r.t)
    jrlk, trlk = JC.rlk_gen(jp, sk, r.j), TC.rlk_gen(tp, sk, r.t, device="cpu")
    jrtk, trtk = JC.rtk_gen(jp, sk, 5, r.j), TC.rtk_gen(tp, sk, 5, r.t, device="cpu")
    _same_ct(jrlk, trlk)
    m = (r.j.standard_normal(jp.l) + 1j * r.j.standard_normal(jp.l)) * 0.5
    r.t.standard_normal(tp.l), r.t.standard_normal(tp.l)
    jct = JC.sk_encrypt(jp, sk, JC.encode(jp, m), jp.qs, r.j)
    tct = TC.sk_encrypt(tp, sk, TC.encode(tp, m, device="cpu"), tp.qs, r.t)
    _same_ct(jct, tct)
    _same_ct(JC.mul(jp, jrlk, jct, jct), TC.mul(tp, trlk, tct, tct))
    _same_ct(JC.rotate(jp, jrtk, jct), TC.rotate(tp, trtk, tct))
