"""The port's CKKS bootstrap modules (`learn_fhe_tpu_torch/models/ckks/
bootstrapping.py`, `evalmod.py`) and the kernels they add (K-RNS-MAC's
gathered instances, K-AUTOMORPH) against the JAX package's, on the CPU's
plain path: every output ciphertext bit for bit. Keys and ciphertexts come
from one seed in both packages, at the `tests/test_ckks.py` fixture (N=32,
L=8, 55-bit primes, r=3), `tests/test_ckks_bootstrap.py`'s mod-raise setup
(N=32, L=4). The module-scoped fixture runs the JAX package's key
generation once a file; the Chebyshev evaluation is held in
`tests/test_torch_ckks_bootstrap_e2e.py`, where it shares the bootstrap's
JAX compiles."""

from types import SimpleNamespace as NS

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from learn_fhe_tpu.models.ckks import bootstrapping as JB  # noqa: E402
from learn_fhe_tpu.models.ckks import ckks as JC  # noqa: E402
from learn_fhe_tpu.models.ckks import evalmod as JE  # noqa: E402
from learn_fhe_tpu.ops import rns as JR  # noqa: E402
from learn_fhe_tpu.ops.ntt import eval_automorphism_perm  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import bootstrapping as TB  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import ckks as TC  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import evalmod as TE  # noqa: E402
from learn_fhe_tpu_torch.ops import rns as TR  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import ckks_bootstrap_key_from_numpy, torch_to_u64, u64_to_torch  # noqa: E402


def _same(j, t):
    np.testing.assert_array_equal(torch_to_u64(t), np.asarray(j))


def _same_ct(j, t):
    assert j.qs == t.qs
    _same(j.b, t.b)
    _same(j.a, t.a)


class Pair:
    """Two Generators from one seed: one feeds the JAX package, one the port."""

    def __init__(self, seed):
        self.j, self.t = np.random.default_rng(seed), np.random.default_rng(seed)


def _sample(l, rng):
    return rng.random(l) + 1j * rng.random(l)


@pytest.fixture(scope="module")
def env():
    """N=32, L=8, r=3: the key, the bootstrap key and a top-level
    ciphertext, each made in both packages from one seed."""
    jp, tp = JC.CkksParams(log_n=5, log_qi=55, big_l=8), TC.CkksParams(log_n=5, log_qi=55, big_l=8)
    r = Pair(9)
    sk = JC.sk_gen(jp, r.j)
    np.testing.assert_array_equal(TC.sk_gen(tp, r.t), sk)
    e = NS(jp=jp, tp=tp, sk=sk)
    e.jbp, e.tbp = JB.BootstrapParams(jp, r=3), TB.BootstrapParams(tp, r=3)
    e.jbk, e.tbk = JB.key_gen(e.jbp, sk, r.j), TB.key_gen(e.tbp, sk, r.t, device="cpu")
    m = _sample(jp.l, r.j)
    np.testing.assert_array_equal(_sample(tp.l, r.t), m)
    e.jct = JC.sk_encrypt(jp, sk, JC.encode(jp, m), jp.qs, r.j)
    e.tct = TC.sk_encrypt(tp, sk, TC.encode(tp, m, device="cpu"), tp.qs, r.t)
    _same_ct(e.jct, e.tct)
    return e


def test_key_gen_harvests_the_jax_rotation_indices(env):
    assert sorted(env.tbk.rtk) == sorted(env.jbk.rtk) == TB.rotation_indices(env.tbp)
    for j, jk in env.jbk.rtk.items():
        assert env.tbk.rtk[j].j == jk.j
        _same_ct(jk.ksk, env.tbk.rtk[j].ksk)


@pytest.mark.parametrize("tag", ["sifft", "sfft"])
def test_one_chunk_matches_jax(env, tag):
    """One BSGS chunk (`_mul_mat`, the last one, which the transforms apply
    first) at the top level."""
    jmats = env.jbp.sifft_mats if tag == "sifft" else env.jbp.sfft_mats
    tmats = env.tbp.sifft_mats if tag == "sifft" else env.tbp.sfft_mats
    k = len(jmats) - 1
    _same_ct(JB._mul_mat(env.jbk, jmats[k], env.jct, (tag, k)), TB._mul_mat(env.tbk, tmats[k], env.tct, (tag, k)))


@pytest.mark.parametrize("tag", ["sifft", "sfft"])
def test_coeff_to_slot_and_slot_to_coeff_match_jax(env, tag):
    """CoeffToSlot and SlotToCoeff whole (their two chunks) from the top
    level. (`tests/test_torch_ckks_bootstrap_e2e.py` runs them in a row
    inside the bootstrap.)"""
    jf, tf = (JB.coeff_to_slot, TB.coeff_to_slot) if tag == "sifft" else (JB.slot_to_coeff, TB.slot_to_coeff)
    _same_ct(jf(env.jbk, env.jct), tf(env.tbk, env.tct))


def test_hoisted_rotations_through_the_gathered_mac_match_jax(env):
    js = tuple(sorted(env.jbk.rtk)[:3])
    jh = JC.hoisted_rotations(env.jp, tuple(env.jbk.rtk[j] for j in js), env.jct, js)
    th = TC.hoisted_rotations(env.tp, tuple(env.tbk.rtk[j] for j in js), env.tct, js)
    for a, b in zip(jh, th):
        _same_ct(a, b)


def test_gathered_mac_matches_jax(env):
    """rns_mac / rns_intt_mac with perms against the JAX package's
    `_ks_dot(ksk, ae[..., perm])` and `rns_intt(rns_mul_eval(pt, be[...,
    perm]))`: one digit with z, a batch axis, a term without a table, and
    the identity's table."""
    jp, tp = env.jp, env.tp
    qs, qps, n = jp.qs, jp.qps, jp.n
    rng = np.random.default_rng(21)
    res = lambda basis, lead: np.stack([rng.integers(0, q, size=(*lead, n), dtype=np.uint64) for q in basis], axis=-2)  # noqa: E731
    ae, kb, ka = res(qps, (2, 1)), res(qps, (1,)), res(qps, (1,))
    be, pt0, pt1 = res(qs, (2,)), res(qs, ()), res(qs, ())
    plan_qp, plan_q = JR.rns_plan(qps, n), JR.rns_plan(qs, n)
    t_plan_qp, t_plan_q = TR.rns_plan(qps, n), TR.rns_plan(qs, n)
    for j in (0, 5, jp.l - 1):
        perm = eval_automorphism_perm(n, jp.pow5(j))
        tperm = TC._eval_perm(n, jp.pow5(j), torch.device("cpu"))
        assert tperm.dtype == torch.int32
        jw = [JC._ks_dot(k, ae[..., perm], plan_qp) for k in (kb, ka)]
        tw = TC._ks_dot(u64_to_torch(kb), u64_to_torch(ae), t_plan_qp, tperm, u64_to_torch(ka))
        _same(jw[0], tw[0])
        _same(jw[1], tw[1])
        jb = JR.rns_intt(
            JR.rns_add(JR.rns_mul_eval(pt1, be[..., perm], plan_q), JR.rns_mul_eval(pt0, be, plan_q), plan_q), plan_q
        )
        tb = TR.rns_intt_mac([u64_to_torch(be)] * 2, [u64_to_torch(pt1), u64_to_torch(pt0)], t_plan_q, perms=[tperm, None])
        _same(jb, tb)
        _same(JR.rns_mul_eval(pt1, be[..., perm], plan_q), TR.rns_mac([u64_to_torch(be)], [u64_to_torch(pt1)], t_plan_q, perms=[tperm]))


@pytest.mark.parametrize("t", [5, 25, 5**7, -1])
def test_automorphism_rns_matches_jax(env, t):
    rng = np.random.default_rng(abs(t))
    qs, n = env.jp.qs, env.jp.n
    x = np.stack([rng.integers(0, q, size=(2, n), dtype=np.uint64) for q in qs], axis=-2)
    x[..., 0] = 0
    want = JC._automorphism_rns(x, t, qs)
    _same(want, TR.automorphism_rns(u64_to_torch(x), t, qs))
    b, a = TR.automorphism_rns((u64_to_torch(x), u64_to_torch(x[::-1].copy())), t, qs)
    _same(want, b)
    _same(JC._automorphism_rns(x[::-1].copy(), t, qs), a)


def test_mod_raise_matches_jax():
    """`tests/test_ckks_bootstrap.py::test_mod_raise_phase`'s setup."""
    r = Pair(3)
    jp, tp = JC.CkksParams(log_n=5, log_qi=55, big_l=4), TC.CkksParams(log_n=5, log_qi=55, big_l=4)
    sk = JC.sk_gen(jp, r.j)
    TC.sk_gen(tp, r.t)
    m = (r.j.standard_normal(jp.l) + 1j * r.j.standard_normal(jp.l)) * 0.1
    r.t.standard_normal(tp.l), r.t.standard_normal(tp.l)
    jct = JC.to_level(JC.sk_encrypt(jp, sk, JC.encode(jp, m), jp.qs, r.j), (jp.qs[0],))
    tct = TC.to_level(TC.sk_encrypt(tp, sk, TC.encode(tp, m, device="cpu"), tp.qs, r.t), (tp.qs[0],))
    _same_ct(jct, tct)
    _same_ct(JE.mod_raise(jp, jct), TE.mod_raise(tp, tct))


def test_mul_const_and_add_const_match_jax(env):
    for v in (0.75, -1.25):
        _same_ct(JE.add_const(env.jp, env.jct, v), TE.add_const(env.tp, env.tct, v))
    for v in (0.5, 1j, -3.0 + 0.25j):
        _same_ct(JE.mul_const(env.jp, env.jct, v), TE.mul_const(env.tp, env.tct, v))


def test_bootstrap_key_from_numpy_gives_the_same_outputs(env):
    """The JAX package's BootstrapKey, carried over: the port's
    CoeffToSlot with it equals the JAX package's and the port's own."""
    leaves = jax.tree.map(np.asarray, env.jbk.rtk)
    bk = ckks_bootstrap_key_from_numpy(NS(bp=env.jbk.bp, rtk=leaves), device="cpu")
    assert bk.pt_cache == {} and bk.bp.r == 3 and bk.bp.params == env.tp
    assert sorted(bk.rtk) == sorted(env.jbk.rtk)
    jc = JB.coeff_to_slot(env.jbk, env.jct)
    _same_ct(jc, TB.coeff_to_slot(bk, env.tct))
