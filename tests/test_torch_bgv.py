"""Port vs JAX: BGV at N=2^6, four q-primes and four p-primes of 45 bits,
t = 65537. Keys, encodings, ciphertexts, plaintext factors and decryptions
must be bit-identical from one numpy seed; every decryption must also equal
the numpy oracle mod t. One module-scoped set of keys serves every test.
The plain t-corrected limb drop (K-BGV-DROP's plain version) is held
against the JAX package's `_drop_limb` at 1..4 drops, and a model of the
kernel's arithmetic on its table against the plain version."""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import learn_fhe_tpu.models.bgv as G  # noqa: E402
from learn_fhe_tpu.models.bgv.bgv import _drop_limb as j_drop_limb  # noqa: E402
from learn_fhe_tpu.ops.rns import rns_add as j_rns_add  # noqa: E402
import learn_fhe_tpu_torch.models.bgv as B  # noqa: E402
from learn_fhe_tpu_torch.ops.rns import MAX_DROP_LIMBS, _drop_table, drop_limbs_t, drop_limbs_t_ref  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import (  # noqa: E402
    bgv_ciphertext_from_numpy,
    bgv_ksk_from_numpy,
    torch_to_u64,
    u64_to_torch,
)

ROTATIONS = (1, 3, 31)  # 1, 3 and N/2 - 1 at N = 2^6


def _params(mod, log_n=6, big_l=4):
    return mod.BgvParams(log_n=log_n, t=65537, log_qi=45, big_l=big_l)


@pytest.fixture(scope="module")
def env():
    """Both packages' keys from seed 41, drawn in one order: sk, pk, rlk, the
    rotation keys, cjk."""
    jp, p = _params(G), _params(B)
    jrng, rng = np.random.default_rng(41), np.random.default_rng(41)
    jsk, sk = G.sk_gen(jp, jrng), B.sk_gen(p, rng)
    return SimpleNamespace(
        jp=jp, p=p, jsk=jsk, sk=sk,
        jpk=G.pk_gen(jp, jsk, jrng), pk=B.pk_gen(p, sk, rng, "cpu"),
        jrlk=G.rlk_gen(jp, jsk, jrng), rlk=B.rlk_gen(p, sk, rng, "cpu"),
        jrtk={j: G.rtk_gen(jp, jsk, j, jrng) for j in ROTATIONS},
        rtk={j: B.rtk_gen(p, sk, j, rng, "cpu") for j in ROTATIONS},
        jcjk=G.cjk_gen(jp, jsk, jrng), cjk=B.cjk_gen(p, sk, rng, "cpu"),
    )  # fmt: skip


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(torch_to_u64(got), np.broadcast_to(np.asarray(want), tuple(got.shape)))


def _same_ct(ct, jct) -> None:
    assert ct.qs == jct.qs and ct.factor == jct.factor
    _eq(ct.b, jct.b)
    _eq(ct.a, jct.a)


def _same_ksk(ksk, jksk) -> None:
    assert ksk.qs == jksk.qs
    _eq(ksk.b, jksk.b)
    _eq(ksk.a, jksk.a)


def _msg(p, rng, shape=()):
    return rng.integers(0, p.t, size=shape + (p.n,), dtype=np.int64)


def _rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _pk_encrypt(e, ms, jrng, rng):
    """pk encryptions of the messages ms in both packages."""
    jcts = [G.pk_encrypt(e.jp, e.jpk, G.encode(e.jp, m), jrng) for m in ms]
    cts = [B.pk_encrypt(e.p, e.pk, B.encode(e.p, m, "cpu"), rng) for m in ms]
    for ct, jct in zip(cts, jcts):
        _same_ct(ct, jct)
    return cts, jcts


def test_keys_match_jax(env):
    e = env
    np.testing.assert_array_equal(e.sk, e.jsk)
    _same_ct(e.pk, e.jpk)
    _same_ksk(e.rlk, e.jrlk)
    for j in ROTATIONS:
        assert e.rtk[j].j == e.jrtk[j].j
        _same_ksk(e.rtk[j].ksk, e.jrtk[j].ksk)
    _same_ksk(e.cjk, e.jcjk)


def test_keys_and_ciphertexts_carry_over(env):
    e = env
    rtk = bgv_ksk_from_numpy(jax.tree.map(np.asarray, e.jrtk[3]), "cpu")
    assert rtk.j == e.rtk[3].j
    assert torch.equal(rtk.ksk.b, e.rtk[3].ksk.b) and torch.equal(rtk.ksk.a, e.rtk[3].ksk.a)
    rlk = bgv_ksk_from_numpy(jax.tree.map(np.asarray, e.jrlk), "cpu")
    assert rlk.qs == e.rlk.qs and torch.equal(rlk.b, e.rlk.b)
    jct = G.mod_switch(e.jp, e.jpk)
    ct = bgv_ciphertext_from_numpy(jax.tree.map(np.asarray, jct), "cpu")
    _same_ct(ct, jct)
    assert ct.factor != 1


def test_encode_matches_jax(env):
    e = env
    m = _msg(e.p, np.random.default_rng(1), (2,))
    _eq(B.encode(e.p, m, "cpu"), G.encode(e.jp, m))
    _eq(B.encode_coeffs(e.p, m, "cpu"), G.encode_coeffs(e.jp, m))


def test_encrypt_decrypt_match_jax(env):
    e = env
    jrng, rng = _rngs(2)
    m = _msg(e.p, rng)
    _msg(e.jp, jrng)
    ct = B.sk_encrypt(e.p, e.sk, B.encode(e.p, m, "cpu"), e.p.qs, rng)
    jct = G.sk_encrypt(e.jp, e.jsk, G.encode(e.jp, m), e.jp.qs, jrng)
    _same_ct(ct, jct)
    np.testing.assert_array_equal(B.decrypt(e.p, e.sk, ct), m)
    (pct,), (jpct,) = _pk_encrypt(e, [m], jrng, rng)
    got = B.decrypt(e.p, e.sk, pct)
    np.testing.assert_array_equal(got, G.decrypt(e.jp, e.jsk, jpct))
    np.testing.assert_array_equal(got, m)
    cct = B.sk_encrypt(e.p, e.sk, B.encode_coeffs(e.p, m, "cpu"), e.p.qs, rng)
    jcct = G.sk_encrypt(e.jp, e.jsk, G.encode_coeffs(e.jp, m), e.jp.qs, jrng)
    _same_ct(cct, jcct)
    np.testing.assert_array_equal(B.decrypt_coeffs(e.p, e.sk, cct), m)


def test_add_sub_match_jax(env):
    e = env
    jrng, rng = _rngs(3)
    ms = [_msg(e.p, rng) for _ in range(2)]
    [_msg(e.jp, jrng) for _ in range(2)]
    (c0, c1), (j0, j1) = _pk_encrypt(e, ms, jrng, rng)
    for op, jop, want in ((B.add, G.add, ms[0] + ms[1]), (B.sub, G.sub, ms[0] - ms[1])):
        out = op(c0, c1)
        _same_ct(out, jop(j0, j1))
        np.testing.assert_array_equal(B.decrypt(e.p, e.sk, out), want % e.p.t)


def test_mod_switch_to_one_limb_matches_jax(env):
    e = env
    jrng, rng = _rngs(4)
    m = _msg(e.p, rng)
    _msg(e.jp, jrng)
    (ct,), (jct,) = _pk_encrypt(e, [m], jrng, rng)
    for _ in range(len(e.p.qs) - 1):
        ct, jct = B.mod_switch(e.p, ct), G.mod_switch(e.jp, jct)
        _same_ct(ct, jct)
        np.testing.assert_array_equal(B.decrypt(e.p, e.sk, ct), m)
    assert len(ct.qs) == 1 and ct.factor != 1


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_plain_drop_matches_jax(env, k):
    """K-BGV-DROP's plain version at k drops from the 8 limbs of qs + ps (the
    key switch's division by P at k = 4), on residues holding 0, q/2, q/2 + 1
    and q - 1, against the JAX package's `_drop_limb` k times; and the fused
    add and last drop of a mul against the same steps one by one."""
    qps, t, n = env.p.qps, env.p.t, env.p.n
    rng = np.random.default_rng(k)
    x = np.stack([rng.integers(0, q, size=(2, n), dtype=np.uint64) for q in qps], axis=-2)
    x[0, :, :4] = np.array([[0, q // 2, q // 2 + 1, q - 1] for q in qps])
    want, basis = jnp.asarray(x), qps
    for _ in range(k):
        want, basis = j_drop_limb(want, basis, t), basis[:-1]
    got = drop_limbs_t_ref(u64_to_torch(x), qps, t, k)
    _eq(got, want)
    add = np.stack([rng.integers(0, q, size=(2, n), dtype=np.uint64) for q in basis], axis=-2)
    fused = drop_limbs_t((u64_to_torch(x), u64_to_torch(x[::-1].copy())), qps, t, k, (u64_to_torch(add), None), then=1)
    stepwise = j_drop_limb(j_rns_add(want, jnp.asarray(add), env.jp.plan(basis)), basis, t)
    _eq(fused[0], stepwise)
    _eq(fused[1], drop_limbs_t_ref(u64_to_torch(x[::-1].copy()), qps, t, k + 1))


def _drop_kernel_model(col: list[int], qs: tuple[int, ...], t: int, steps: int) -> list[int]:
    """`csrc/bgv.cu`'s drops on one column of Python ints, read from the
    table the wrapper uploads, with the kernel's u64 wrap-around: Barrett mod
    t, y_i = (x_i - rc) q_l^-1 - kc mod q_i by one Shoup product."""
    m, w64, mu = MAX_DROP_LIMBS, (1 << 64) - 1, (1 << 64) // t
    tab = [int(v) for v in _drop_table(qs, t, steps)]

    def mod_t(v):
        r = (v - ((v * mu) >> 64) * t) & w64
        return r - t if r >= t else r

    v, L = list(col), len(qs)
    for s in range(steps):
        st = m + s * (2 + 2 * m)
        ql, inv_t, r = tab[st], tab[st + 1], v[L - 1 - s]
        neg = r > ql >> 1
        mag = ql - r if neg else r
        rem = mod_t(mag)
        k = mod_t((t - (t - rem if neg and rem else rem)) * inv_t)
        kneg = k > t >> 1
        kmag = t - k if kneg else k
        for i in range(L - 1 - s):
            q, u, us = tab[i], tab[st + 2 + 2 * i], tab[st + 3 + 2 * i]
            a = (v[i] - (q - mag if neg else mag)) % q
            y = (a * u - (((a * us) >> 64) * q)) & w64
            assert y < 2 * q
            v[i] = (min(y, y - q & w64) - (q - kmag if kneg else kmag)) % q
    return v[: L - steps]


@pytest.mark.parametrize("k", [1, 4])
def test_drop_kernel_arithmetic_matches_plain(k):
    """K-BGV-DROP's arithmetic and table layout, modelled on the CPU: k drops
    from the 8 limbs of qs + ps on residues holding 0, q/2, q/2 + 1, q - 1
    and random values equal the plain version's."""
    p = _params(B)
    rng = np.random.default_rng(100 + k)
    x = np.stack([rng.integers(0, q, size=(2, 32), dtype=np.uint64) for q in p.qps], axis=-2)
    x[0, :, :4] = np.array([[0, q // 2, q // 2 + 1, q - 1] for q in p.qps])
    want = torch_to_u64(drop_limbs_t_ref(u64_to_torch(x), p.qps, p.t, k))
    for r in range(x.shape[0]):
        for c in range(x.shape[-1]):
            got = _drop_kernel_model([int(v) for v in x[r, :, c]], p.qps, p.t, k)
            assert got == [int(v) for v in want[r, :, c]], (r, c)


def test_mul_and_depth3_chain_match_jax(env):
    """big_l - 1 sequential products, each fresh operand brought down by
    mod_switch: ciphertexts and factors equal to the JAX package's at every
    depth, every decryption exact."""
    e = env
    jrng, rng = _rngs(5)
    ms = [_msg(e.p, rng) for _ in range(len(e.p.qs))]
    [_msg(e.jp, jrng) for _ in ms]
    cts, jcts = _pk_encrypt(e, ms, jrng, rng)
    acc_m, acc, jacc = ms[0], cts[0], jcts[0]
    for m, ct, jct in zip(ms[1:], cts[1:], jcts[1:]):
        while len(ct.qs) > len(acc.qs):
            ct, jct = B.mod_switch(e.p, ct), G.mod_switch(e.jp, jct)
        acc, jacc = B.mul(e.p, e.rlk, acc, ct), G.mul(e.jp, e.jrlk, jacc, jct)
        _same_ct(acc, jacc)
        acc_m = acc_m * m % e.p.t
        np.testing.assert_array_equal(B.decrypt(e.p, e.sk, acc), acc_m)
    assert len(acc.qs) == 1


def test_mul_plain_add_plain_match_jax(env):
    e = env
    jrng, rng = _rngs(6)
    m0, m1, m2 = (_msg(e.p, rng) for _ in range(3))
    [_msg(e.jp, jrng) for _ in range(3)]
    (ct,), (jct,) = _pk_encrypt(e, [m0], jrng, rng)
    ct, jct = B.mul_plain(e.p, m1, ct), G.mul_plain(e.jp, m1, jct)
    _same_ct(ct, jct)
    ct, jct = B.mod_switch(e.p, ct), G.mod_switch(e.jp, jct)
    ct, jct = B.add_plain(e.p, m2, ct), G.add_plain(e.jp, m2, jct)
    _same_ct(ct, jct)
    np.testing.assert_array_equal(B.decrypt(e.p, e.sk, ct), (m0 * m1 + m2) % e.p.t)


@pytest.mark.parametrize("j", ROTATIONS)
def test_rotate_matches_jax(env, j):
    e = env
    jrng, rng = _rngs(7)
    m = _msg(e.p, rng)
    _msg(e.jp, jrng)
    (ct,), (jct,) = _pk_encrypt(e, [m], jrng, rng)
    out = B.rotate(e.p, e.rtk[j], ct)
    _same_ct(out, G.rotate(e.jp, e.jrtk[j], jct))
    half = e.p.n // 2
    want = np.concatenate([np.roll(m[:half], -j), np.roll(m[half:], -j)])
    np.testing.assert_array_equal(B.decrypt(e.p, e.sk, out), want)


def test_conjugate_and_key_switch_match_jax(env):
    e = env
    jrng, rng = _rngs(8)
    m = _msg(e.p, rng)
    _msg(e.jp, jrng)
    (ct,), (jct,) = _pk_encrypt(e, [m], jrng, rng)
    out = B.conjugate(e.p, e.cjk, ct)
    _same_ct(out, G.conjugate(e.jp, e.jcjk, jct))
    half = e.p.n // 2
    np.testing.assert_array_equal(B.decrypt(e.p, e.sk, out), np.concatenate([m[half:], m[:half]]))
    # a lower level: the key's rows selected (and kept) for qs[:2] + ps
    ct, jct = B.mod_switch(e.p, B.mod_switch(e.p, ct)), G.mod_switch(e.jp, G.mod_switch(e.jp, jct))
    out = B.key_switch(e.p, e.rlk, ct)
    _same_ct(out, G.key_switch(e.jp, e.jrlk, jct))
    assert e.rlk.rows(ct.qs + e.p.ps)[0] is e.rlk.rows(ct.qs + e.p.ps)[0]


def test_batch_of_three_matches_jax(env):
    """A batch of 3 encrypted under one mask (the JAX package broadcasts a
    (L, N) a against a (3, L, N) b): mul and mod_switch bit for bit, and a
    rotation decrypting right."""
    e = env
    jrng, rng = _rngs(9)
    m = _msg(e.p, rng, (3,))
    _msg(e.jp, jrng, (3,))
    ct = B.sk_encrypt(e.p, e.sk, B.encode(e.p, m, "cpu"), e.p.qs, rng)
    jct = G.sk_encrypt(e.jp, e.jsk, G.encode(e.jp, m), e.jp.qs, jrng)
    assert tuple(ct.b.shape) == (3, 4, e.p.n) and tuple(ct.a.shape) == (4, e.p.n)
    _same_ct(ct, jct)
    np.testing.assert_array_equal(B.decrypt(e.p, e.sk, ct), m)
    # the JAX package's ops on each ciphertext alone, at shapes other tests compiled
    prod, low = B.mul(e.p, e.rlk, ct, ct), B.mod_switch(e.p, ct)
    for i in range(3):
        one = G.BgvCiphertext(jct.b[i], jct.a, jct.qs)
        for got, want in ((prod, G.mul(e.jp, e.jrlk, one, one)), (low, G.mod_switch(e.jp, one))):
            _same_ct(B.BgvCiphertext(got.b[i], got.a[i] if got.a.dim() == 3 else got.a, got.qs, got.factor), want)
    np.testing.assert_array_equal(B.decrypt(e.p, e.sk, prod), m * m % e.p.t)
    np.testing.assert_array_equal(B.decrypt(e.p, e.sk, low), m)
    half = e.p.n // 2
    want = np.concatenate([np.roll(m[:, :half], -1, -1), np.roll(m[:, half:], -1, -1)], axis=-1)
    np.testing.assert_array_equal(B.decrypt(e.p, e.sk, B.rotate(e.p, e.rtk[1], ct)), want)


@pytest.mark.slow
def test_larger_ring_matches_jax():
    """`tests/test_bgv.py::test_larger_ring` (N=2^9, three q-primes) in both
    packages: keys, a mul and a rotation by 7, bit for bit."""
    jp, p = _params(G, 9, 3), _params(B, 9, 3)
    jrng, rng = _rngs(43)
    jsk, sk = G.sk_gen(jp, jrng), B.sk_gen(p, rng)
    jrlk, rlk = G.rlk_gen(jp, jsk, jrng), B.rlk_gen(p, sk, rng, "cpu")
    _same_ksk(rlk, jrlk)
    m0, m1 = _msg(p, rng), _msg(p, rng)
    _msg(jp, jrng), _msg(jp, jrng)
    c0 = B.sk_encrypt(p, sk, B.encode(p, m0, "cpu"), p.qs, rng)
    c1 = B.sk_encrypt(p, sk, B.encode(p, m1, "cpu"), p.qs, rng)
    j0 = G.sk_encrypt(jp, jsk, G.encode(jp, m0), jp.qs, jrng)
    j1 = G.sk_encrypt(jp, jsk, G.encode(jp, m1), jp.qs, jrng)
    prod = B.mul(p, rlk, c0, c1)
    _same_ct(prod, G.mul(jp, jrlk, j0, j1))
    np.testing.assert_array_equal(B.decrypt(p, sk, prod), m0 * m1 % p.t)
    rtk, jrtk = B.rtk_gen(p, sk, 7, rng, "cpu"), G.rtk_gen(jp, jsk, 7, jrng)
    rot = B.rotate(p, rtk, c0)
    _same_ct(rot, G.rotate(jp, jrtk, j0))
    half = p.n // 2
    np.testing.assert_array_equal(B.decrypt(p, sk, rot), np.concatenate([np.roll(m0[:half], -7), np.roll(m0[half:], -7)]))
