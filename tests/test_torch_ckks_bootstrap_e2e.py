"""The port's whole CKKS bootstrap (`learn_fhe_tpu_torch/models/ckks/
evalmod.py::bootstrap`: mod_raise, CoeffToSlot, EvalMod, SlotToCoeff)
against the JAX package's on the CPU's plain path, bit for bit, at N=16,
L=16 q-primes of 55 bits, r=3 and the default EvalModParams, on a batch of
two exhausted ciphertexts made from one seed in both packages. In a file of
its own, so that a distributed run gives its JAX compiles a worker of their
own. The Chebyshev evaluation on its own (`tests/test_ckks_bootstrap.py::
test_eval_chebyshev_matches_host`'s 21 coefficients) runs here too, at the
bootstrap's parameters, whose JAX compiles it then shares."""

from types import SimpleNamespace as NS

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.models.ckks import bootstrapping as JB  # noqa: E402
from learn_fhe_tpu.models.ckks import ckks as JC  # noqa: E402
from learn_fhe_tpu.models.ckks import evalmod as JE  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import bootstrapping as TB  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import ckks as TC  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import evalmod as TE  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u64  # noqa: E402

PARAMS = dict(log_n=4, log_qi=55, big_l=16)
SEED = 17
BATCH = 2


def _same_ct(j, t):
    assert j.qs == t.qs
    np.testing.assert_array_equal(torch_to_u64(t.b), np.asarray(j.b))
    np.testing.assert_array_equal(torch_to_u64(t.a), np.asarray(j.a))


def _setup(C, B, params, rng, **dev):
    """Keys and a batch of exhausted ciphertexts, drawn in `bench.py`'s
    order (`bench_ckks_bootstrap`)."""
    sk = C.sk_gen(params, rng)
    rlk = C.rlk_gen(params, sk, rng, **dev)
    cjk = C.cjk_gen(params, sk, rng, **dev)
    bk = B.key_gen(B.BootstrapParams(params, r=3), sk, rng, **dev)
    ms = [(rng.standard_normal(params.l) + 1j * rng.standard_normal(params.l)) * 1e-4 for _ in range(BATCH)]
    lows = [C.to_level(C.sk_encrypt(params, sk, C.encode(params, m, **dev), params.qs, rng), (params.qs[0],)) for m in ms]
    return NS(params=params, sk=sk, rlk=rlk, cjk=cjk, bk=bk, ms=ms, lows=lows)


@pytest.fixture(scope="module")
def runs():
    j = _setup(JC, JB, JC.CkksParams(**PARAMS), np.random.default_rng(SEED))
    t = _setup(TC, TB, TC.CkksParams(**PARAMS), np.random.default_rng(SEED), device="cpu")
    j.low = JC.CkksCiphertext(jnp.stack([c.b for c in j.lows]), jnp.stack([c.a for c in j.lows]), j.lows[0].qs)
    t.low = TC.CkksCiphertext(torch.stack([c.b for c in t.lows]), torch.stack([c.a for c in t.lows]), t.lows[0].qs)
    j.out = JE.bootstrap(j.params, j.bk, j.rlk, j.cjk, j.low)
    t.out = TE.bootstrap(t.params, t.bk, t.rlk, t.cjk, t.low)
    return j, t


def test_bootstrap_matches_jax(runs):
    j, t = runs
    _same_ct(j.low, t.low)
    _same_ct(j.out, t.out)
    assert len(t.out.qs) >= 2, len(t.out.qs)


def test_bootstrap_decrypts_to_the_messages(runs):
    """Each of the batch's two outputs decodes to its message (the relative
    precision the JAX package's N=2^5 bootstraps hold, less a margin for the
    smaller ring)."""
    _, t = runs
    for i, m in enumerate(t.ms):
        one = TC.CkksCiphertext(t.out.b[i], t.out.a[i], t.out.qs)
        got = TC.decode(t.params, TC.decrypt(t.params, t.sk, one), one.qs)
        rel_bits = -np.log2(np.max(np.abs(got - m)) / np.max(np.abs(m)))
        assert rel_bits > 16.0, (i, rel_bits)


def test_eval_chebyshev_matches_jax(runs):
    """`test_eval_chebyshev_matches_host`'s evaluation (seed 5, slots in
    [-1, 1], 21 coefficients) on the bootstrap's keys, on a batch of two
    at the level EvalMod's chain starts from (the JAX side then reuses the
    bootstrap's compiles)."""
    j, t = runs
    rng = np.random.default_rng(5)
    x = ((rng.random(j.params.l) - 0.5) * 2).astype(np.complex128)
    coeffs = rng.standard_normal(21) * (0.5 ** np.arange(21))
    level = j.params.qs[: len(j.params.qs) - len(j.bk.bp.sifft_mats) - 1]
    jcts = [JC.to_level(JC.sk_encrypt(j.params, j.sk, JC.encode(j.params, x), j.params.qs, np.random.default_rng(s)), level) for s in (6, 7)]
    tcts = [
        TC.to_level(TC.sk_encrypt(t.params, t.sk, TC.encode(t.params, x, device="cpu"), t.params.qs, np.random.default_rng(s)), level)
        for s in (6, 7)
    ]
    jct = JC.CkksCiphertext(jnp.stack([c.b for c in jcts]), jnp.stack([c.a for c in jcts]), level)
    tct = TC.CkksCiphertext(torch.stack([c.b for c in tcts]), torch.stack([c.a for c in tcts]), level)
    _same_ct(jct, tct)
    _same_ct(JE.eval_chebyshev(j.params, j.rlk, jct, coeffs), TE.eval_chebyshev(t.params, t.rlk, tct, coeffs))
