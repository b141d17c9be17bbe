"""Port vs JAX: the blind-rotation step (`cmux_rotate`) and the TGGSW key
transform. Exact equality.

The step's Pallas kernel (`bench/pallas_step_experiment.py`) runs its whole
comparison at import time, so it cannot be imported here; it is held against
the JAX `tggsw.cmux_rotate` itself, which is what the port is held against.
The inputs are built the way that experiment builds them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.models.tfhe import tggsw as jtggsw  # noqa: E402
from learn_fhe_tpu.models.tfhe.params import TggswParams as JTggswParams  # noqa: E402
from learn_fhe_tpu.models.tfhe.params import TglweParams as JTglweParams  # noqa: E402
from learn_fhe_tpu.models.tfhe.tglwe import TglweCiphertext as JTglweCt  # noqa: E402
from learn_fhe_tpu.ops.modular32 import shoup32  # noqa: E402
from learn_fhe_tpu.ops.torus_crt import monomial_eval_table, required_bound_bits, torus_crt_plan  # noqa: E402
from learn_fhe_tpu_torch.models.tfhe import tggsw  # noqa: E402
from learn_fhe_tpu_torch.models.tfhe.params import TggswParams, TglweParams  # noqa: E402
from learn_fhe_tpu_torch.models.tfhe.tglwe import TglweCiphertext  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import (  # noqa: E402
    torch_to_u32,
    torch_to_u64,
    u32_to_torch,
    u64_to_torch,
)

N, B = 256, 4


def _params(cls_glwe, cls_ggsw, k=1, log_b=23, d=1):
    return cls_ggsw(cls_glwe(log_p=4, padding=1, big_n=N, k=k, std_dev=2.85e-15), log_b=log_b, d=d)


@pytest.mark.parametrize("k,log_b,d", [(1, 23, 1), (2, 12, 2)])
def test_cmux_rotate_matches_jax(k, log_b, d):
    jparams = _params(JTglweParams, JTggswParams, k, log_b, d)
    params = _params(TglweParams, TggswParams, k, log_b, d)
    R = (k + 1) * d
    bound = required_bound_bits(N, log_b, R)
    primes = torus_crt_plan(N, bound).primes
    rng = np.random.default_rng(k)
    acc_a = rng.integers(0, 1 << 64, size=(B, k, N), dtype=np.uint64)
    acc_b = rng.integers(0, 1 << 64, size=(B, N), dtype=np.uint64)
    av = [rng.integers(0, q, size=(R, k, N), dtype=np.uint32) for q in primes]
    bv = [rng.integers(0, q, size=(R, N), dtype=np.uint32) for q in primes]
    ad = [shoup32(v, q) for v, q in zip(av, primes)]
    bd = [shoup32(v, q) for v, q in zip(bv, primes)]
    mvals, mduals = monomial_eval_table(N, bound)
    s = rng.integers(0, 2 * N + 1, size=B)
    s[0] = 2 * N  # mod_switch_2n can round up to 2N, which is X^0
    rows = s % (2 * N)

    jkey = jtggsw.TggswEval(*(tuple(jnp.asarray(x) for x in leaf) for leaf in (av, ad, bv, bd)))
    want = jtggsw.cmux_rotate(
        jparams,
        jkey,
        JTglweCt(jnp.asarray(acc_a), jnp.asarray(acc_b)),
        tuple(jnp.asarray(mvals[i][rows]) for i in range(len(primes))),
        tuple(jnp.asarray(mduals[i][rows]) for i in range(len(primes))),
    )

    key = tggsw.TggswEval(
        u32_to_torch(np.stack(av, axis=-4)),
        u32_to_torch(np.stack(ad, axis=-4)),
        u32_to_torch(np.stack(bv, axis=-3)),
        u32_to_torch(np.stack(bd, axis=-3)),
    )
    acc = TglweCiphertext(u64_to_torch(acc_a), u64_to_torch(acc_b))
    out = tggsw.cmux_rotate(
        params, key, acc, torch.from_numpy(s), u32_to_torch(mvals), u32_to_torch(mduals)
    )
    assert out.a is acc.a and out.b is acc.b  # updated in place
    np.testing.assert_array_equal(torch_to_u64(out.a), np.asarray(want.a))
    np.testing.assert_array_equal(torch_to_u64(out.b), np.asarray(want.b))


def test_tggsw_encrypt_to_eval_match_jax():
    """sk_encrypt draws as the JAX package does, and to_eval lands every
    prime's residues and duals on the port's stacked prime axis."""
    jparams = _params(JTglweParams, JTggswParams)
    params = _params(TglweParams, TggswParams)
    sk = np.random.default_rng(9).integers(0, 2, size=(1, N))
    pt = np.zeros((3, N), dtype=np.uint64)
    pt[:, 0] = [0, 1, 1]
    jct = jtggsw.sk_encrypt(jparams, sk, jnp.asarray(pt), np.random.default_rng(4))
    ct = tggsw.sk_encrypt(params, sk, u64_to_torch(pt), np.random.default_rng(4))
    np.testing.assert_array_equal(torch_to_u64(ct.a), np.asarray(jct.a))
    np.testing.assert_array_equal(torch_to_u64(ct.b), np.asarray(jct.b))
    jev = jtggsw.to_eval(jparams, jct)
    ev = tggsw.to_eval(params, ct)
    for name, axis in (("av", -4), ("ad", -4), ("bv", -3), ("bd", -3)):
        want = np.stack([np.asarray(x) for x in getattr(jev, name)], axis=axis)
        np.testing.assert_array_equal(torch_to_u32(getattr(ev, name)), want)
