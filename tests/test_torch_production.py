"""The port's certified production bootstrap configuration
(`learn_fhe_tpu_torch/models/ckks/production.py`), its precision model
(`precision.py`) and the security estimate (`utils/security.py`) against
the JAX package's, on the CPU; and the mini ladder of
`tests/test_production.py` (N = 2^6, dense key, dnum = 10) through the
port's plain path: keys, mod_raise and the CoeffToSlot chunk bit-identical
to the JAX package's, the whole bootstrap's levels and precision."""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learn_fhe_tpu.models.ckks import bootstrapping as JB  # noqa: E402
from learn_fhe_tpu.models.ckks import ckks as JC  # noqa: E402
from learn_fhe_tpu.models.ckks import evalmod as JE  # noqa: E402
from learn_fhe_tpu.models.ckks import precision as JP  # noqa: E402
from learn_fhe_tpu.models.ckks import production as JPr  # noqa: E402
from learn_fhe_tpu.models.fhew.params import RlweParams as JRlweParams  # noqa: E402
from learn_fhe_tpu.utils import security as JS  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import bootstrapping as TB  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import ckks as TC  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import evalmod as TE  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import precision as TP  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import production as TPr  # noqa: E402
from learn_fhe_tpu_torch.models.fhew.params import RlweParams as TRlweParams  # noqa: E402
from learn_fhe_tpu_torch.utils import security as TS  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u64  # noqa: E402
from learn_fhe_tpu_torch.utils.primes import two_adic_primes  # noqa: E402

CPU = "cpu"


def _fhew_params(mod):
    q = next(two_adic_primes(28, 10))
    return (JRlweParams if mod is JS else TRlweParams)(q=q, p=4, log_n=9, log_b=7, d=4)


# the calls of tests/test_security.py, each as (function name, args, kwargs)
_SECURITY_CASES = [
    *(("estimate", (4096, lq), {}) for lq in (109, 75, 58, 110)),
    ("estimate", (32768, 881), {}),
    *(("estimate", (8192, lq), {}) for lq in (60, 118, 152, 218, 300)),
    *(("estimate", (n, 100), {}) for n in (2048, 4096, 8192, 16384)),
    *(("estimate", (6144, lq), {}) for lq in (160, 170)),
    ("estimate", (8192, 200), {"h": 64}),
    ("estimate", (32768, 16 * 55), {}),
    ("estimate", (1 << 16, 1757.0), {}),
    ("estimate", (512, 0.0), {}),
    ("ckks_estimate", ("ckks13",), {}),
    ("ckks_estimate", ("ckks13",), {"h": 64}),
    ("rlwe_estimate", ("fhew",), {}),
    *(("lwe_estimate", (1024, lq), {}) for lq in (27, 54)),
]


@pytest.mark.parametrize("name,args,kw", _SECURITY_CASES)
def test_security_estimates_match_jax(name, args, kw):
    """estimate / ckks_estimate / rlwe_estimate / lwe_estimate on
    `tests/test_security.py`'s cases (and the flagship's N = 2^16, 1757
    bits): the same SecurityEstimate fields, warning and certification."""
    outs = []
    for mod, ckks in ((JS, JC), (TS, TC)):
        a = tuple(
            ckks.CkksParams(log_n=13, log_qi=55, big_l=8) if v == "ckks13" else _fhew_params(mod) if v == "fhew" else v
            for v in args
        )
        e = getattr(mod, name)(*a, **kw)
        outs.append((e.n, e.log_q, e.security_bits, e.level, e.sparse_h, e.warning, e.meets(128), e.meets(192)))
    assert outs[0] == outs[1]


# the knob sets of PRODUCTION_r05.json's runs (the flagship; the em family
# stage probes at user_levels = 2; attempt 2) and the r04 mini fixture's
_KNOBS = [
    {},
    {"log_em": 58, "user_levels": 2},
    {"log_em": 60, "user_levels": 2},
    {"log_em": 61, "user_levels": 2},
    {"chunk_r": 8, "log_em": 60, "log_p": 60},
    {"user_levels": 2, "chunk_r": 5, "log_q0": 45, "log_em": 58, "log_user": 40},
]


def _config_view(cfg, E):
    em = cfg.em
    return (
        cfg.ladder,
        cfg.n_transform,
        cfg.h,
        (em.k, em.r, em.degree, em.arcsin, em.log_work_scale),
        em.cheb_coeffs.tolist(),
        cfg.params.qs,
        cfg.params.ps,
        cfg.params.dnum,
        cfg.params.log_qis,
        cfg.bootstrap_params.r,
        cfg.summary(),
        E.cheb_levels(em, cfg.baby),
        E.eval_mod_levels(em, cfg.baby),
    )


@pytest.mark.parametrize("knobs", range(len(_KNOBS)))
@pytest.mark.parametrize("log_n", [6, 10, 13, 14, 16])
def test_production_config_matches_jax(log_n, knobs):
    """ProductionConfig's ladder, primes, digits, EvalMod parameters (its
    Chebyshev coefficients too), summary() and level simulator, and whether
    production_config certifies the configuration, at log_n 6..16 under
    each knob set of PRODUCTION_r05.json and the mini fixture's."""
    kw = _KNOBS[knobs]
    views, certified = [], []
    for mod in (JPr, TPr):
        views.append(_config_view(mod.ProductionConfig(log_n=log_n, **kw), mod))
        try:
            mod.production_config(log_n, **kw)
            certified.append(True)
        except AssertionError:
            certified.append(False)
    assert views[0] == views[1]
    assert certified[0] == certified[1]
    assert certified[1] == (log_n == 16)


def test_flagship_config_is_the_probe_record():
    """production_config(16) is the configuration of PRODUCTION_r05.json's
    knobs: N = 2^16, L = 30 (55 | 52 x 4 | 52 x 3 | 56 x 19 | 52 x 3), two
    59-bit p-primes, dnum 15, K = 314, r = 8, log QP 1757, 128.6 bits; and
    the port's wrap bound is the JAX package's."""
    cfg = TPr.production_config(16)
    s = cfg.summary()
    assert cfg.ladder == (55,) + (52,) * 4 + (52,) * 3 + (56,) * 19 + (52,) * 3
    assert (s["k_wraps"], s["double_angles"], s["eval_mod_levels"], s["log_qp"], s["security_bits"]) == (314, 8, 19, 1757.0, 128.6)
    assert cfg.params.dnum == 15 and cfg.params.alpha == 2 and [p.bit_length() for p in cfg.params.ps] == [59, 59]
    assert cfg.n_transform == 3 and 2 * cfg.n_transform + TPr.eval_mod_levels(cfg.em, cfg.baby) == 25
    for h in (64, 1000, 32768):
        assert TPr.wrap_bound(h) == JPr.wrap_bound(h)


def test_precision_model_matches_jax():
    """fit(), its residuals and validation, predict over the knobs,
    r_family, retuned_bits (and its refusal to extrapolate), the sweep
    deltas and em_gain_evalmod_regime without the keyword: the JAX
    package's values."""
    jm, tm = JP.fit(), TP.fit()
    assert vars(jm) == vars(tm)
    assert jm.residuals() == tm.residuals() and jm.validated() == tm.validated()
    assert vars(JP.fit(a_r=2.0, s_gap=0.5)) == vars(TP.fit(a_r=2.0, s_gap=0.5))
    for log_n in range(6, 18):
        assert JP.r_family(log_n) == TP.r_family(log_n)
        for kw in ({}, {"r": 9}, {"log_em": 56}, {"log_em": 60}, {"log_q0": 55, "log_user": 52}):
            assert jm.predict(log_n, **kw) == tm.predict(log_n, **kw)
    for log_n in (10, 11, 12.5, 14, 16):
        assert JP.retuned_bits(log_n) == TP.retuned_bits(log_n)
    for log_n in (9, 17):
        with pytest.raises(ValueError):
            TP.retuned_bits(log_n)
    assert JP.SWEEP_DELTAS == TP.SWEEP_DELTAS and JP.SWEEP_BASE_BITS == TP.SWEEP_BASE_BITS
    for d in (-4.0, 0.0, 2.0, 5.0):
        assert JP.em_gain_evalmod_regime(d) == TP.em_gain_evalmod_regime(d)


def test_em_gain_clamp_is_a_deliberate_divergence():
    """With the starting em given, a move past EM_PEAK raises ValueError
    (the em family peaks at 60: EM14_FAMILY's em61 lost 0.79 bits against
    em60), where the JAX package's function extrapolates the linear slope;
    a move up to the peak is the JAX package's value."""
    assert TP.EM_PEAK == JP.EM_PEAK == 60
    assert TP.em_gain_evalmod_regime(4.0, from_em=56) == JP.em_gain_evalmod_regime(4.0)
    assert TP.em_gain_evalmod_regime(-2.0, from_em=61) == JP.em_gain_evalmod_regime(-2.0)
    with pytest.raises(ValueError):
        TP.em_gain_evalmod_regime(5.0, from_em=56)
    assert JP.em_gain_evalmod_regime(5.0) == pytest.approx(4.75)  # the JAX package does not refuse


@pytest.mark.parametrize("log_mag", [40, 61, 70, 100])
def test_host_encode_helpers_match_jax(log_mag):
    """The encode's host steps at the production ring's sizes: DDC's
    round_to_ints (in int64 where |value| < 2^62, per value past it) and
    bigints_to_rns (in int64 where every value fits, per value past it)
    equal the JAX package's, ties to even included."""
    from learn_fhe_tpu.utils import crt as jcrt
    from learn_fhe_tpu.utils import dd as jdd
    from learn_fhe_tpu_torch.utils import crt as tcrt
    from learn_fhe_tpu_torch.utils import dd as tdd

    rng = np.random.default_rng(log_mag)
    h = rng.standard_normal(4096) * 2.0**log_mag
    h[:4] = [0.5, 1.5, 2.5, -2.5]
    low = rng.standard_normal(4096) * 2.0 ** (log_mag - 54)
    parts = (h.copy(), low.copy(), h[::-1].copy(), low[::-1].copy())
    want, got = jdd.DDC(*parts).round_to_ints(), tdd.DDC(*parts).round_to_ints()
    assert want == got
    qs = TPr.production_config(16).params.qps
    vals = got[0] + got[1]
    np.testing.assert_array_equal(tcrt.bigints_to_rns(vals, qs), jcrt.bigints_to_rns(vals, qs))


# -- the mini ladder (tests/test_production.py:48-67) --------------------------

_MINI = dict(log_n=6, user_levels=2, chunk_r=5, log_q0=45, log_em=58, log_user=40)
_SEED = 77


def _keys(mod_c, mod_b, cfg, rng, **dev):
    params = cfg.params
    sk = mod_c.sk_gen(params, rng)
    rlk = mod_c.rlk_gen(params, sk, rng, **dev)
    cjk = mod_c.cjk_gen(params, sk, rng, **dev)
    bk = mod_b.key_gen(cfg.bootstrap_params, sk, rng, **dev)
    return sk, rlk, cjk, bk


def _low(mod_c, params, sk, rng, s_user, amp=0.3):
    m = (rng.standard_normal(params.l) + 1j * rng.standard_normal(params.l)) * amp
    dev = {"device": CPU} if mod_c is TC else {}
    pt = mod_c.encode(params, m, (params.qs[0],), scale_int=int(s_user), **dev)
    return m, mod_c.sk_encrypt(params, sk, pt, (params.qs[0],), rng)


def _same(jx, tx):
    np.testing.assert_array_equal(torch_to_u64(tx), np.asarray(jx))


@pytest.fixture(scope="module")
def mini_pair():
    """The mini fixture's keys and an exhausted ciphertext, from seed 77 in
    both packages (the JAX test's draws)."""
    out = []
    for mod_pr, mod_c, mod_b, dev in ((JPr, JC, JB, {}), (TPr, TC, TB, {"device": CPU})):
        cfg = mod_pr.ProductionConfig(**_MINI)
        rng = np.random.default_rng(_SEED)
        sk, rlk, cjk, bk = _keys(mod_c, mod_b, cfg, rng, **dev)
        m, low = _low(mod_c, cfg.params, sk, rng, Fraction(1 << cfg.log_user))
        out.append((cfg, sk, rlk, cjk, bk, m, low))
    return out


def test_mini_ladder_keys_raise_and_coeff_to_slot_match_jax(mini_pair):
    """At the mini ladder (L = 19, dnum = 10 digits of 2 primes, dense
    key): the secret, rlk, cjk and every rotation key (b and a, all
    digits), the encryption, mod_raise and the CoeffToSlot chunk (its
    hoisted digits, baby steps through the slot permutations, giant-step
    rotations and rescales) bit-identical to the JAX package's."""
    (jcfg, jsk, jrlk, jcjk, jbk, jm, jlow), (tcfg, tsk, trlk, tcjk, tbk, tm, tlow) = mini_pair
    assert tcfg.params.dnum == 10 and len(tcfg.params.qs) == 19
    np.testing.assert_array_equal(jsk, tsk)
    assert np.array_equal(jm, tm)
    for jk, tk in ((jrlk, trlk), (jcjk, tcjk)):
        _same(jk.b, tk.b)
        _same(jk.a, tk.a)
    assert sorted(jbk.rtk) == sorted(tbk.rtk)
    for j in jbk.rtk:
        _same(jbk.rtk[j].ksk.b, tbk.rtk[j].ksk.b)
        _same(jbk.rtk[j].ksk.a, tbk.rtk[j].ksk.a)
    _same(jlow.b, tlow.b)
    _same(jlow.a, tlow.a)
    jr, tr = JE.mod_raise(jcfg.params, jlow), TE.mod_raise(tcfg.params, tlow)
    assert jr.qs == tr.qs == tcfg.params.qs
    _same(jr.b, tr.b)
    _same(jr.a, tr.a)
    mats = tcfg.bootstrap_params.sifft_mats
    assert len(mats) == 1  # log2(l) = 5 factors in one chunk of 5
    jc = JB._mul_mat(jbk, jcfg.bootstrap_params.sifft_mats[0], jr, ("sifft", 0))
    tc = TB._mul_mat(tbk, mats[0], tr, ("sifft", 0))
    assert jc.qs == tc.qs and len(tc.qs) == len(tr.qs) - 1
    _same(jc.b, tc.b)
    _same(jc.a, tc.a)


def _bits(got, want):
    return float(-np.log2(np.max(np.abs(got - want)) / np.max(np.abs(want))))


def test_mini_ladder_bootstrap_levels_and_precision():
    """The port's plain path alone (no JAX): the mini ladder's bootstrap
    consumes the levels the simulator predicts (2 n_transform +
    eval_mod_levels), lands at 1 + user_levels limbs, and decrypts at more
    than 20 relative bits, as `tests/test_production.py` asserts of the
    JAX package's."""
    cfg = TPr.ProductionConfig(**_MINI)
    params = cfg.params
    rng = np.random.default_rng(_SEED)
    sk, rlk, cjk, bk = _keys(TC, TB, cfg, rng, device=CPU)
    s_user = Fraction(1 << cfg.log_user)
    m, low = _low(TC, params, sk, rng, s_user)
    out = TE.bootstrap(params, bk, rlk, cjk, low, cfg.em, S_in=s_user, S_out=s_user)
    consumed = len(params.qs) - len(out.qs)
    assert consumed == 2 * cfg.n_transform + TPr.eval_mod_levels(cfg.em, cfg.baby)
    assert len(out.qs) == 1 + cfg.user_levels
    got = TC.decode(params, TC.decrypt(params, sk, out), out.qs, scale_int=int(s_user))
    assert _bits(got, m) > 20.0


@pytest.mark.slow
def test_mini_ladder_bootstrap_matches_jax(mini_pair):
    """The whole mini bootstrap (mod_raise, CoeffToSlot, EvalMod with the
    arcsine, SlotToCoeff) from the fixture's ciphertext: the port's output
    ciphertext bit-identical to the JAX package's."""
    (jcfg, jsk, jrlk, jcjk, jbk, _, jlow), (tcfg, _, trlk, tcjk, tbk, _, tlow) = mini_pair
    s_user = Fraction(1 << tcfg.log_user)
    jo = JE.bootstrap(jcfg.params, jbk, jrlk, jcjk, jlow, jcfg.em, S_in=s_user, S_out=s_user)
    to = TE.bootstrap(tcfg.params, tbk, trlk, tcjk, tlow, tcfg.em, S_in=s_user, S_out=s_user)
    assert jo.qs == to.qs
    _same(jo.b, to.b)
    _same(jo.a, to.a)
