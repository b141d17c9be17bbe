"""Port vs JAX: the rest of TFHE -- TGSW, the TGGSW decrypt, external product
and CMux, the torus automorphism, TLWE/TGLWE add and sub, and the
reference-order (parity=True) blind rotation and bootstrap. Every
ciphertext must be bit-identical from one numpy seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import learn_fhe_tpu.models.tfhe as jtfhe  # noqa: E402
from learn_fhe_tpu.models.tfhe import tggsw as jtggsw  # noqa: E402
from learn_fhe_tpu.models.tfhe import tglwe as jtglwe  # noqa: E402
from learn_fhe_tpu.models.tfhe import tgsw as jtgsw  # noqa: E402
from learn_fhe_tpu.models.tfhe import tlwe as jtlwe  # noqa: E402
from learn_fhe_tpu.ops.poly import automorphism_t64 as j_automorphism_t64  # noqa: E402
import learn_fhe_tpu_torch.models.tfhe as tfhe  # noqa: E402
from learn_fhe_tpu_torch.models.tfhe import tggsw, tglwe, tgsw, tlwe  # noqa: E402
from learn_fhe_tpu_torch.ops.poly import automorphism_t64  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import (  # noqa: E402
    tggsw_ciphertext_from_numpy,
    tgsw_ciphertext_from_numpy,
    torch_to_u32,
    torch_to_u64,
    u64_to_torch,
)
from tests.test_torch_tfhe_pbs import PBS_ENV, _params  # noqa: E402


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(torch_to_u64(got), np.asarray(want))


def _torus(rng, shape):
    return rng.integers(0, 1 << 64, size=shape, dtype=np.uint64)


@pytest.mark.parametrize("t", [3, 5, 77, -1])
def test_automorphism_t64_matches_jax(t):
    x = _torus(np.random.default_rng(t % 100), (3, 64))
    _eq(automorphism_t64(u64_to_torch(x), t), j_automorphism_t64(jnp.asarray(x), t))


def test_tlwe_tglwe_add_sub_and_view():
    rng = np.random.default_rng(3)
    a0, a1 = _torus(rng, (4, 32)), _torus(rng, (4, 32))
    b0, b1 = _torus(rng, 4), _torus(rng, 4)
    j0, j1 = jtlwe.TlweCiphertext(jnp.asarray(a0), jnp.asarray(b0)), jtlwe.TlweCiphertext(jnp.asarray(a1), jnp.asarray(b1))
    c0 = tlwe.TlweCiphertext(u64_to_torch(a0), u64_to_torch(b0))
    c1 = tlwe.TlweCiphertext(u64_to_torch(a1), u64_to_torch(b1))
    for op, jop in ((tlwe.add, jtlwe.add), (tlwe.sub, jtlwe.sub)):
        got, want = op(c0, c1), jop(j0, j1)
        _eq(got.a, want.a)
        _eq(got.b, want.b)
    ga0, ga1 = _torus(rng, (2, 2, 64)), _torus(rng, (2, 2, 64))
    gb0, gb1 = _torus(rng, (2, 64)), _torus(rng, (2, 64))
    g0 = jtglwe.TglweCiphertext(jnp.asarray(ga0), jnp.asarray(gb0))
    g1 = jtglwe.TglweCiphertext(jnp.asarray(ga1), jnp.asarray(gb1))
    h0 = tglwe.TglweCiphertext(u64_to_torch(ga0), u64_to_torch(gb0))
    h1 = tglwe.TglweCiphertext(u64_to_torch(ga1), u64_to_torch(gb1))
    for op, jop in ((tglwe.add, jtglwe.add), (tglwe.sub, jtglwe.sub)):
        got, want = op(h0, h1), jop(g0, g1)
        _eq(got.a, want.a)
        _eq(got.b, want.b)
    gp = tfhe.TglweParams(log_p=8, padding=1, big_n=64, k=2, std_dev=1e-8)
    jgp = jtfhe.TglweParams(log_p=8, padding=1, big_n=64, k=2, std_dev=1e-8)
    for args in ((), (4, 5)):
        view, jview = tglwe.tlwe_view_params(gp, *args), jtglwe.tlwe_view_params(jgp, *args)
        assert (view.log_p, view.padding, view.n, view.std_dev, view.log_b, view.d) == (
            jview.log_p, jview.padding, jview.n, jview.std_dev, jview.log_b, jview.d,
        )  # fmt: skip


def test_tgsw_matches_jax():
    """`tests/test_tfhe.py::test_tgsw_product_cmux`'s fixture (n=32, B=2^8,
    d=7): encryption, decryption, the external product and both CMux
    branches, bit for bit; the carried-over ciphertext equal too."""
    tp = tfhe.TgswParams(tfhe.TlweParams(log_p=8, padding=1, n=32, std_dev=1e-9), log_b=8, d=7)
    jtp = jtfhe.TgswParams(jtfhe.TlweParams(log_p=8, padding=1, n=32, std_dev=1e-9), log_b=8, d=7)
    rng, jrng = np.random.default_rng(0), np.random.default_rng(0)
    sk = tlwe.sk_gen(tp.tlwe, rng)
    np.testing.assert_array_equal(sk, jtlwe.sk_gen(jtp.tlwe, jrng))
    pts = np.array([7, 0, 1], dtype=np.uint64)
    ct0 = tgsw.sk_encrypt(tp, sk, u64_to_torch(pts), rng)
    jct0 = jtgsw.sk_encrypt(jtp, sk, jnp.asarray(pts), jrng)
    _eq(ct0.a, jct0.a)
    _eq(ct0.b, jct0.b)
    carried = tgsw_ciphertext_from_numpy(jax.tree.map(np.asarray, jct0), "cpu")
    assert torch.equal(carried.a, ct0.a) and torch.equal(carried.b, ct0.b)
    _eq(tgsw.decrypt(tp, sk, ct0), jtgsw.decrypt(jtp, sk, jct0))
    msgs = np.array([13, 11, 22], dtype=np.uint64)
    ct1 = tlwe.sk_encrypt(tp.tlwe, sk, tlwe.encode(tp.tlwe, u64_to_torch(msgs)), rng)
    jct1 = jtlwe.sk_encrypt(jtp.tlwe, sk, jtlwe.encode(jtp.tlwe, jnp.asarray(msgs)), jrng)
    _eq(ct1.a, jct1.a)
    prod = tgsw.external_product(tp, ct0, ct1)
    jprod = jtgsw.external_product(jtp, jct0, jct1)
    _eq(prod.a, jprod.a)
    _eq(prod.b, jprod.b)
    assert int(tlwe.decode(tp.tlwe, tlwe.decrypt(tp.tlwe, sk, tlwe.TlweCiphertext(prod.a[0], prod.b[0])))) == 7 * 13 % 256
    # one selector bit per ciphertext of the batch: 0 picks ct_f, 1 picks ct_t
    ctf = tlwe.TlweCiphertext(ct1.a[[1, 1, 1]], ct1.b[[1, 1, 1]])
    ctt = tlwe.TlweCiphertext(ct1.a[[2, 2, 2]], ct1.b[[2, 2, 2]])
    jctf = jtlwe.TlweCiphertext(jct1.a[jnp.array([1, 1, 1])], jct1.b[jnp.array([1, 1, 1])])
    jctt = jtlwe.TlweCiphertext(jct1.a[jnp.array([2, 2, 2])], jct1.b[jnp.array([2, 2, 2])])
    out, jout = tgsw.cmux(tp, ct0, ctf, ctt), jtgsw.cmux(jtp, jct0, jctf, jctt)
    _eq(out.a, jout.a)
    _eq(out.b, jout.b)
    got = tlwe.decode(tp.tlwe, tlwe.decrypt(tp.tlwe, sk, out))
    np.testing.assert_array_equal(got[1:].numpy(), [11, 22])


def _tggsw_params(mod, n, log_p=8):
    return mod.TggswParams(mod.TglweParams(log_p=log_p, padding=1, big_n=n, k=1, std_dev=2.85e-15), log_b=23, d=1)


def _jax_eval(key: tggsw.TggswEval) -> jtggsw.TggswEval:
    """The port's TggswEval (prime axis before the row axis) as the JAX
    package's (one leaf per prime)."""

    def planes(x, axis):
        return tuple(jnp.asarray(torch_to_u32(x.select(axis, i))) for i in range(x.shape[axis]))

    return jtggsw.TggswEval(planes(key.av, -4), planes(key.ad, -4), planes(key.bv, -3), planes(key.bd, -3))


@pytest.mark.parametrize("n", [64, 256])
def test_tggsw_decrypt_external_product_cmux_match_jax(n):
    """TGGSW encryptions of 3 and of the bits 0 and 1 (made by the port,
    whose encryption and key transform `tests/test_torch_tggsw.py` holds
    against the JAX package's), their decryption, the external product with
    a TGLWE ciphertext and the CMux, at N=64 and 256."""
    gg, jgg = _tggsw_params(tfhe, n), _tggsw_params(jtfhe, n)
    rng = np.random.default_rng(n)
    sk = tglwe.sk_gen(gg.tglwe, rng)
    scalars = np.zeros((3, n), dtype=np.uint64)
    scalars[:, 0] = [3, 0, 1]
    ct = tggsw.sk_encrypt(gg, sk, u64_to_torch(scalars), rng)
    jct = jtggsw.TggswCiphertext(jnp.asarray(torch_to_u64(ct.a)), jnp.asarray(torch_to_u64(ct.b)))
    carried = tggsw_ciphertext_from_numpy(jax.tree.map(np.asarray, jct), "cpu")
    assert torch.equal(carried.a, ct.a) and torch.equal(carried.b, ct.b)
    got = tggsw.decrypt(gg, sk, ct)
    _eq(got, jtggsw.decrypt(jgg, sk, jct))
    np.testing.assert_array_equal(got.numpy(), scalars.astype(np.int64))
    key = tggsw.to_eval(gg, ct)
    jkey = _jax_eval(key)
    m = rng.integers(0, 256, size=(2, n), dtype=np.uint64)
    c = tglwe.sk_encrypt(gg.tglwe, sk, tglwe.encode(gg.tglwe, u64_to_torch(m)), rng)
    c0, c1 = tglwe.TglweCiphertext(c.a[0], c.b[0]), tglwe.TglweCiphertext(c.a[1], c.b[1])
    jc0, jc1 = (jtglwe.TglweCiphertext(jnp.asarray(torch_to_u64(x.a)), jnp.asarray(torch_to_u64(x.b))) for x in (c0, c1))
    # one compiled JAX CMux serves both: cmux(key, 0, c) = 0 + key (*) c
    jcmux = jax.jit(jtggsw.cmux, static_argnums=0)
    jzero = jtglwe.TglweCiphertext(jnp.zeros_like(jc0.a), jnp.zeros_like(jc0.b))
    for i, want_m in enumerate((m[0] * 3 % 256, m[0], m[1])):
        key_i = tggsw.TggswEval(*(x[i] for x in key))
        jkey_i = jtggsw.TggswEval(*(tuple(p[i] for p in leaf) for leaf in jkey))
        prod, jprod = tggsw.external_product(gg, key_i, c0), jcmux(jgg, jkey_i, jzero, jc0)
        _eq(prod.a, jprod.a)
        _eq(prod.b, jprod.b)
        out, jout = tggsw.cmux(gg, key_i, c0, c1), jcmux(jgg, jkey_i, jc0, jc1)
        _eq(out.a, jout.a)
        _eq(out.b, jout.b)
        dec = tglwe.decode(gg.tglwe, tglwe.decrypt(gg.tglwe, sk, out if i else prod))
        np.testing.assert_array_equal(dec.numpy(), want_m.astype(np.int64))


@pytest.fixture(scope="module")
def pbs_env():
    """`tests/test_torch_tfhe_pbs.py`'s N=256 fixture (n=64 steps): the
    port's keys from seed 17 (which that file holds against the JAX
    package's), carried into the JAX package's layout."""
    jparams, params = _params(jtfhe, **PBS_ENV), _params(tfhe, **PBS_ENV)
    rng = np.random.default_rng(17)
    z = tlwe.sk_gen(params.tlwe, rng)
    key = tfhe.key_gen(params, z, rng, "cpu")
    planes = lambda t: tuple(jnp.asarray(torch_to_u32(t[i])) for i in range(t.shape[0]))  # noqa: E731
    jkey = jtfhe.BootstrapKey(
        _jax_eval(key.brk),
        jtlwe.TlweKeySwitchingKey(jnp.asarray(torch_to_u64(key.ksk.a)), jnp.asarray(torch_to_u64(key.ksk.b))),
        planes(key.mon_v),
        planes(key.mon_d),
    )
    return jparams, params, z, jkey, key


def test_parity_blind_rotate_and_bootstrap_match_jax(pbs_env):
    """The reference-order blind rotation (parity=True) on exponents with 0,
    N, 2N-1 and 2N, and a whole parity bootstrap, bit for bit against the
    JAX package: 64 CMux steps, each an external product, with the real
    key at N=256; the parity bootstraps of all 4 messages decrypt to the
    identity LUT."""
    jparams, params, z, jkey, key = pbs_env
    n, big_n, p = params.tlwe.n, params.big_n, params.tlwe.p
    rng = np.random.default_rng(5)
    a2n = rng.integers(0, 2 * big_n + 1, size=n)
    a2n[:4] = [0, big_n, 2 * big_n - 1, 2 * big_n]
    b2n = int(rng.integers(0, 2 * big_n + 1))
    tab = tfhe.lut_table(params.tlwe.log_p, big_n, lambda v: 3 * v + 1)
    v_enc = tglwe.encode(params.tglwe, u64_to_torch(tab))
    want = jtfhe.blind_rotate(
        jparams, jkey, jtglwe.encode(jparams.tglwe, jnp.asarray(tab)), jnp.asarray(a2n), jnp.asarray(b2n), parity=True
    )
    got = tfhe.blind_rotate(params, key, v_enc, torch.from_numpy(a2n), torch.tensor(b2n), parity=True)
    _eq(got.a, want.a)
    _eq(got.b, want.b)

    lut = u64_to_torch(tfhe.lut_table(params.tlwe.log_p, big_n, lambda v: v))
    rng = np.random.default_rng(9)
    for m in range(p):
        ct = tlwe.sk_encrypt(params.tlwe, z, tlwe.encode(params.tlwe, torch.tensor(m)), rng)
        out = tfhe.bootstrap(params, key, lut, ct, parity=True)
        assert int(tlwe.decode(params.tlwe, tlwe.decrypt(params.tlwe, z, out))) == m
    jct = jtlwe.TlweCiphertext(jnp.asarray(torch_to_u64(ct.a)), jnp.asarray(torch_to_u64(ct.b)))
    jout = jtfhe.bootstrap(jparams, jkey, jnp.asarray(torch_to_u64(lut)), jct, parity=True)
    _eq(out.a, jout.a)
    _eq(out.b, jout.b)


def test_parity_blind_rotate_refuses_a_batch(pbs_env):
    _, params, _, _, key = pbs_env
    big_n = params.big_n
    v_enc = torch.zeros(big_n, dtype=torch.int64)
    a2n = torch.zeros((2, params.tlwe.n), dtype=torch.int64)
    with pytest.raises(ValueError, match="unbatched"):
        tfhe.blind_rotate(params, key, v_enc, a2n, torch.zeros(2, dtype=torch.int64), parity=True)
