"""The port's CKKS (`learn_fhe_tpu_torch/models/ckks`) against the JAX
package's on the `tests/test_ckks_dnum.py` fixture (a 45/55-bit prime
ladder, two 55-bit p-primes, 3 key-switch digits), on the CPU's plain path:
keys, mul, rotate, conjugate and hoisted rotations bit for bit at levels
that cut a digit group, and a key with a digit axis carried over from the
JAX package (`utils/interop.py`)."""

from types import SimpleNamespace as NS

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learn_fhe_tpu.models.ckks import ckks as JC  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import ckks as TC  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import ckks_ksk_from_numpy  # noqa: E402

from .test_torch_ckks import Pair, _same_ct, _sample  # noqa: E402


@pytest.fixture(scope="module")
def dnum_env():
    kw = dict(log_n=5, log_qi=55, big_l=6, log_qis=(55, 45, 45, 55, 45, 45), log_ps=(55, 55), dnum=3)
    jp, tp = JC.CkksParams(**kw), TC.CkksParams(**kw)
    assert (jp.qs, jp.ps) == (tp.qs, tp.ps)
    r = Pair(41)
    sk = JC.sk_gen(jp, r.j)
    TC.sk_gen(tp, r.t)
    e = NS(jp=jp, tp=tp, sk=sk)
    e.jrlk, e.trlk = JC.rlk_gen(jp, sk, r.j), TC.rlk_gen(tp, sk, r.t, device="cpu")
    e.jrtk, e.trtk = JC.rtk_gen(jp, sk, 1, r.j), TC.rtk_gen(tp, sk, 1, r.t, device="cpu")
    e.jcjk, e.tcjk = JC.cjk_gen(jp, sk, r.j), TC.cjk_gen(tp, sk, r.t, device="cpu")
    e.jmany = JC.rtk_gen_many(jp, sk, [1, 3, 7], r.j)
    e.tmany = TC.rtk_gen_many(tp, sk, [1, 3, 7], r.t, device="cpu")
    m0, m1 = _sample(jp.l, r.j), _sample(jp.l, r.j)
    _sample(tp.l, r.t), _sample(tp.l, r.t)
    e.m0 = m0
    e.jct0 = JC.sk_encrypt(jp, sk, JC.encode(jp, m0), jp.qs, r.j)
    e.jct1 = JC.sk_encrypt(jp, sk, JC.encode(jp, m1), jp.qs, r.j)
    e.tct0 = TC.sk_encrypt(tp, sk, TC.encode(tp, m0, device="cpu"), tp.qs, r.t)
    e.tct1 = TC.sk_encrypt(tp, sk, TC.encode(tp, m1, device="cpu"), tp.qs, r.t)
    return e


def test_dnum_keys_match_jax(dnum_env):
    e = dnum_env
    assert e.trlk.b.shape[0] == 3  # per-digit keys
    for jk, tk in ((e.jrlk, e.trlk), (e.jrtk.ksk, e.trtk.ksk), (e.jcjk, e.tcjk)):
        _same_ct(jk, tk)
    for j in e.jmany:
        _same_ct(e.jmany[j].ksk, e.tmany[j].ksk)
    _same_ct(e.jct0, e.tct0)


def test_dnum_mul_rotate_conjugate_match_jax(dnum_env):
    e = dnum_env
    _same_ct(JC.mul(e.jp, e.jrlk, e.jct0, e.jct1), TC.mul(e.tp, e.trlk, e.tct0, e.tct1))
    _same_ct(JC.rotate(e.jp, e.jrtk, e.jct0), TC.rotate(e.tp, e.trtk, e.tct0))
    _same_ct(JC.conjugate(e.jp, e.jcjk, e.jct0), TC.conjugate(e.tp, e.tcjk, e.tct0))


@pytest.mark.parametrize("level", [5, 3, 2])
def test_dnum_partial_digit_levels_match_jax(dnum_env, level):
    """Levels 5 and 3 cut the alpha = 2 digit groups mid-digit."""
    e = dnum_env
    jct, tct = JC.to_level(e.jct0, e.jp.qs[:level]), TC.to_level(e.tct0, e.tp.qs[:level])
    out = TC.rotate(e.tp, e.trtk, tct)
    _same_ct(JC.rotate(e.jp, e.jrtk, jct), out)
    _same_ct(JC.mul(e.jp, e.jrlk, jct, JC.to_level(e.jct1, e.jp.qs[:level])), TC.mul(e.tp, e.trlk, tct, TC.to_level(e.tct1, e.tp.qs[:level])))
    got = TC.decode(e.tp, TC.decrypt(e.tp, e.sk, out), out.qs)
    assert np.max(np.abs(got - np.roll(e.m0, -1))) < 2.0**-28


@pytest.mark.parametrize("level", [6, 5])
def test_dnum_hoisted_rotations_match_jax(dnum_env, level):
    e = dnum_env
    js = (1, 3, 7)
    jct, tct = JC.to_level(e.jct0, e.jp.qs[:level]), TC.to_level(e.tct0, e.tp.qs[:level])
    jh = JC.hoisted_rotations(e.jp, tuple(e.jmany[j] for j in js), jct, js)
    th = TC.hoisted_rotations(e.tp, tuple(e.tmany[j] for j in js), tct, js)
    for a, b in zip(jh, th):
        _same_ct(a, b)


def test_dnum_keys_carried_from_jax(dnum_env):
    """A key with a digit axis, carried over from the JAX package."""
    e = dnum_env
    rtk = TC.CkksRotKey(ckks_ksk_from_numpy(NS(b=np.asarray(e.jrtk.ksk.b), a=np.asarray(e.jrtk.ksk.a), qs=e.jrtk.ksk.qs), device="cpu"), 1)
    assert rtk.ksk.b.shape == e.trtk.ksk.b.shape
    _same_ct(JC.rotate(e.jp, e.jrtk, e.jct0), TC.rotate(e.tp, rtk, e.tct0))
