"""The port's host planning of CKKS's linear transforms
(`learn_fhe_tpu_torch/utils/matrix.py`, `models/ckks/sfft.py`'s
`sfft_fmats`/`sifft_fmats`) against the JAX package's, host code only: every
diagonal's four double-double arrays equal, to the last word, at l = 2..512
slots, for the factors, their chunked products (r = 3, as `BootstrapParams`
makes them), their unitary-scaled inverses and the BSGS plans."""

import numpy as np
import pytest

from learn_fhe_tpu.models.ckks import sfft as JS
from learn_fhe_tpu.utils import matrix as JM
from learn_fhe_tpu_torch.models.ckks import sfft as TS
from learn_fhe_tpu_torch.utils import matrix as TM

SLOTS = [1 << k for k in range(1, 10)]


def _same_mat(jm, tm):
    assert sorted(jm) == sorted(tm)
    for j in jm:
        for f in ("re_h", "re_l", "im_h", "im_l"):
            np.testing.assert_array_equal(getattr(tm[j], f), getattr(jm[j], f))


def _chunks(mod, m, l, r=3):
    return [mod.mat_product(m[i : i + r], l) for i in range(0, len(m), r)]


@pytest.mark.parametrize("l", SLOTS)
def test_fmats_and_products_match_jax(l):
    jf, tf = JS.sfft_fmats(l), TS.sfft_fmats(l)
    ji, ti = JS.sifft_fmats(l), TS.sifft_fmats(l)
    assert len(jf) == len(tf) == len(ji) == len(ti) == l.bit_length() - 1
    for jm, tm in (*zip(jf, tf), *zip(ji, ti)):
        _same_mat(jm, tm)
    for jm, tm in (*zip(_chunks(JM, jf, l), _chunks(TM, tf, l)), *zip(_chunks(JM, ji, l), _chunks(TM, ti, l))):
        _same_mat(jm, tm)
        assert TM.bsgs_plan(list(tm)) == JM.bsgs_plan(list(jm))
        _same_mat(JM.mat_inv(jm, l), TM.mat_inv(tm, l))


@pytest.mark.parametrize("l", SLOTS[:6])
def test_mat_to_dense_and_products_match_jax(l):
    """mat_to_dense, and mat_mul of two factors in both orders; the dense
    products of the sfft factors and of the sifft factors are inverses."""
    jf, tf = JS.sfft_fmats(l), TS.sfft_fmats(l)
    for jm, tm in zip(jf, tf):
        np.testing.assert_array_equal(TM.mat_to_dense(tm, l), JM.mat_to_dense(jm, l))
    if len(tf) > 1:
        _same_mat(JM.mat_mul(jf[1], jf[0], l), TM.mat_mul(tf[1], tf[0], l))
        _same_mat(JM.mat_mul(jf[0], jf[1], l), TM.mat_mul(tf[0], tf[1], l))
    dense = TM.mat_to_dense(TM.mat_product(tf, l), l)
    dense_inv = TM.mat_to_dense(TM.mat_product(TS.sifft_fmats(l), l), l)
    assert np.allclose(dense @ dense_inv, np.eye(l), atol=1e-12)


def test_bsgs_plan_matches_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        idx = sorted(set(rng.integers(0, 512, size=rng.integers(1, 16)).tolist()))
        assert TM.bsgs_plan(idx) == JM.bsgs_plan(idx)
    assert TM.bsgs_plan([]) == JM.bsgs_plan([])
