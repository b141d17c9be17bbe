"""Port vs JAX: multi-key / threshold FHEW on the u64 engine, on the CPU, at
`tests/test_fhew.py::multi_key_boot_params` (q = next(two_adic_primes(54,
8)), N=128, B=2^6, d=9 so 2d = 18 digit rows; LWE n=16, q_ks=2^16; w=5; 2
parties; seed 5).

Both packages run the protocol from the same numpy seed: crs_gen, the
parties' secret keys and pk shares, the merged pk, each party's key share,
key_share_merge, then AND and XOR on the four input pairs of pk-encrypted
bits, and the decryption shares. Every sampler draws in the same order and
all arithmetic is exact, so each step is compared bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import learn_fhe_tpu.models.fhew as J  # noqa: E402
from learn_fhe_tpu.models.fhew import bootstrapping as jboot  # noqa: E402
from learn_fhe_tpu.utils.primes import two_adic_primes  # noqa: E402
import learn_fhe_tpu_torch.models.fhew as T  # noqa: E402
from learn_fhe_tpu_torch.models.fhew import bootstrapping as tboot  # noqa: E402
from learn_fhe_tpu_torch.models.fhew import gates, lwe, rgsw, rlwe  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import (  # noqa: E402
    fhew_bootstrap_key_from_numpy,
    fhew_crs_from_numpy,
    fhew_key_share_from_numpy,
    torch_to_u64,
    u64_to_torch,
)

PARTIES = 2
PAIRS = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _params(mod):
    q = next(two_adic_primes(54, 8))
    rlwe_p = mod.RlweParams(q=q, p=4, log_n=7, log_b=6, d=9)
    return mod.BootstrapParams(mod.RgswParams(rlwe_p, log_b=6, d=9), mod.LweParams(q=1 << 16, p=4, n=16, log_b=4, d=4), w=5)


def _protocol(M, params, device=None):
    """The protocol of `tests/test_fhew.py::test_multi_key_gates` in package
    M, up to the gates: everything each step made, and the generator."""
    rng = np.random.default_rng(5)
    crs = M.crs_gen(params, rng) if device is None else M.crs_gen(params, rng, device)
    sks = [M.rlwe.sk_gen(params.rlwe, rng) for _ in range(PARTIES)]
    pk_shares = [M.rlwe.pk_share_gen(params.rlwe, crs.pk_a, sk, rng) for sk in sks]
    pk = M.rlwe.pk_share_merge(params.rlwe, crs.pk_a, pk_shares)
    shares = [M.key_share_gen(params, crs, sk, pk, rng) for sk in sks]
    key = M.key_share_merge(params, crs, shares)
    return dict(crs=crs, sks=sks, pk_shares=pk_shares, pk=pk, shares=shares, key=key, rng=rng)


def _gates(M, params, run):
    """AND and XOR of the pk-encrypted input pairs in one gate batch, and
    each party's decryption shares of the 8 outputs."""
    rng, key, pk = run["rng"], run["key"], run["pk"]
    ins = [[M.FhewBool.pk_encrypt(params, key, pk, bool(m), rng) for m in pair] for pair in PAIRS]
    specs = [(name, x.ct, y.ct) for name in ("and", "xor") for x, y in ins]
    outs = M.gates.gate_batch(params, key, specs)
    shares = [[M.lwe.share_decrypt(params.lwe_z, sk, o.a, rng) for o in outs] for sk in run["sks"]]
    return ins, outs, shares


@pytest.fixture(scope="module")
def env():
    jparams, tparams = _params(J), _params(T)
    jrun, trun = _protocol(J, jparams), _protocol(T, tparams, "cpu")
    jg, tg = _gates(J, jparams, jrun), _gates(T, tparams, trun)
    return jparams, tparams, jrun, trun, jg, tg


def _eq(got: torch.Tensor, want, msg=""):
    np.testing.assert_array_equal(torch_to_u64(got), np.asarray(want), err_msg=msg)


def test_crs_pk_shares_and_merged_pk_match_jax(env):
    *_, jrun, trun, _, _ = env
    for f, got, want in zip(("pk_a", "ksk_a", "ak_a"), trun["crs"], jrun["crs"]):
        _eq(got, want, f)
    for sk_t, sk_j in zip(trun["sks"], jrun["sks"]):
        np.testing.assert_array_equal(sk_t, sk_j)
    for got, want in zip(trun["pk_shares"], jrun["pk_shares"]):
        _eq(got, want)
    _eq(trun["pk"].a, jrun["pk"].a)
    _eq(trun["pk"].b, jrun["pk"].b)


def test_key_shares_match_jax(env):
    """Each party's LWE key switching key share, its brk share (the RGSW of
    X^{s_j} under the merged pk, in the coefficient basis) and its
    automorphism key shares."""
    *_, jrun, trun, _, _ = env
    for p, (got, want) in enumerate(zip(trun["shares"], jrun["shares"])):
        _eq(got.ksk_b, want.ksk_b, f"party {p} ksk_b")
        _eq(got.brk.a, want.brk.a, f"party {p} brk.a")
        _eq(got.brk.b, want.brk.b, f"party {p} brk.b")
        _eq(got.ak_b, want.ak_b, f"party {p} ak_b")


def test_internal_product_chunk_matches_jax(env):
    """One chunk of the merge: party 0's brk RGSWs into the evaluation basis
    and every row of party 1's through an external product with them."""
    jparams, tparams, jrun, trun, _, _ = env
    lo, hi = 3, 9
    jm, js = jrun["shares"][0].brk, jrun["shares"][1].brk
    want = jboot._merge_chunk(jparams.rgsw, jm.a[lo:hi], jm.b[lo:hi], js.a[lo:hi], js.b[lo:hi])
    tm, ts = trun["shares"][0].brk, trun["shares"][1].brk
    got = tboot._merge_chunk(
        tparams.rgsw, rgsw.RgswCiphertext(tm.a[lo:hi], tm.b[lo:hi]), rgsw.RgswCiphertext(ts.a[lo:hi], ts.b[lo:hi])
    )
    _eq(got.a, want[0])
    _eq(got.b, want[1])


def test_merged_key_matches_jax_through_interop(env):
    """key_share_merge's key equals the JAX package's, carried over by
    `fhew_bootstrap_key_from_numpy` (u64 eval-Montgomery rows, no duals)."""
    *_, jrun, trun, _, _ = env
    carried = fhew_bootstrap_key_from_numpy(jax.tree.map(np.asarray, jrun["key"]), device="cpu")
    for f in T.BootstrapKey._fields:
        got, mine = getattr(carried, f), getattr(trun["key"], f)
        if got is None:
            assert mine is None and f.endswith("d"), f
            continue
        assert torch.equal(got, mine), f


def test_port_merge_of_jax_shares_gives_jax_key(env):
    """The port's key_share_merge run on the JAX package's CRS and shares."""
    jparams, tparams, jrun, _, _, _ = env
    crs = fhew_crs_from_numpy(jax.tree.map(np.asarray, jrun["crs"]), device="cpu")
    shares = [fhew_key_share_from_numpy(jax.tree.map(np.asarray, s), device="cpu") for s in jrun["shares"]]
    key = T.key_share_merge(tparams, crs, shares)
    jkey = jrun["key"]
    for f in ("ksk_a", "ksk_b", "brk_a", "brk_b", "ak_a", "ak_b"):
        _eq(getattr(key, f), getattr(jkey, f), f)
    np.testing.assert_array_equal(key.auto_src.numpy(), np.asarray(jkey.auto_src))
    assert key.brk_ad is None and jkey.brk_ad is None


def test_and_xor_on_all_input_pairs_match_jax(env):
    """The pk-encrypted inputs, AND and XOR on the four pairs in one gate
    batch (as LWE ciphertexts), the parties' decryption shares and the
    merged plaintexts: bit-identical, and the truth tables."""
    jparams, tparams, _, _, (jins, jouts, jshares), (tins, touts, tshares) = env
    for jpair, tpair in zip(jins, tins):
        for jb, tb in zip(jpair, tpair):
            _eq(tb.ct.a, jb.ct.a)
            _eq(tb.ct.b, jb.ct.b)
    truth = [a & b for a, b in PAIRS] + [a ^ b for a, b in PAIRS]
    for i, (jo, to) in enumerate(zip(jouts, touts)):
        _eq(to.a, jo.a, f"gate {i} a")
        _eq(to.b, jo.b, f"gate {i} b")
        for p in range(PARTIES):
            _eq(tshares[p][i], jshares[p][i], f"gate {i} party {p} share")
        pt = lwe.decryption_share_merge(tparams.lwe_z, to.b, [tshares[p][i] for p in range(PARTIES)])
        jpt = J.lwe.decryption_share_merge(jparams.lwe_z, jo.b, [jshares[p][i] for p in range(PARTIES)])
        _eq(pt, jpt, f"gate {i} plaintext")
        assert bool(gates.decode_bool(tparams, pt)) == bool(truth[i]), i


def _op_rlwe_sk_pk_encrypt_decrypt(jparams, tparams, rng_seed):
    """pk_gen, sk_encrypt, pk_encrypt and decrypt of encoded messages, at the
    54-bit prime (K-POLYMUL64's plain path)."""
    outs = []
    for M, params in ((J.rlwe, jparams.rlwe), (rlwe, tparams.rlwe)):
        rng = np.random.default_rng(rng_seed)
        z = M.sk_gen(params, rng)
        m = rng.integers(0, 4, size=(2, params.n)).astype(np.uint64)
        pt = M.encode(params, jnp.asarray(m) if M is J.rlwe else torch.from_numpy(m.astype(np.int64)))
        pk = M.pk_gen(params, z, rng) if M is J.rlwe else M.pk_gen(params, z, rng, "cpu")
        ct_sk, ct_pk = M.sk_encrypt(params, z, pt, rng), M.pk_encrypt(params, pk, pt, rng)
        outs.append([pt, pk.b, ct_sk.b, ct_pk.a, ct_pk.b, M.decode(params, M.decrypt(params, z, ct_pk))])
    return outs[1], outs[0]


def _op_rgsw_encrypt_products(jparams, tparams, rng_seed):
    """sk_encrypt_rgsw, pk_encrypt_rgsw, decrypt_rgsw, to_eval (Montgomery),
    the u64 external product, and the u64 key switch of an automorphism key."""
    outs = []
    for M, params in ((J, jparams), (T, tparams)):
        rng = np.random.default_rng(rng_seed)
        gp, rp = params.rgsw, params.rlwe
        z = M.rlwe.sk_gen(rp, rng)
        pk = M.rlwe.pk_gen(rp, z, rng) if M is J else M.rlwe.pk_gen(rp, z, rng, "cpu")
        m = np.zeros((2, params.n), dtype=np.uint64)
        m[:, 0] = [1, 3]
        pt = jnp.asarray(m) if M is J else torch.from_numpy(m.astype(np.int64))
        ct = M.rgsw.sk_encrypt_rgsw(gp, z, M.rgsw.encode(gp, pt), rng)
        ct_pk = M.rgsw.pk_encrypt_rgsw(gp, pk, M.rgsw.encode(gp, pt), rng)
        ev = M.rgsw.to_eval(gp, ct)
        acc = M.rlwe.sk_encrypt(rp, z, M.rlwe.encode(rp, pt[0]), rng)
        ext = (jax.jit(M.rgsw.external_product, static_argnums=0) if M is J else M.rgsw.external_product)(
            gp, M.rgsw.RgswEval(ev.a[1], ev.b[1]), acc
        )
        ak = M.rlwe.ak_gen(rp, 5, z, rng) if M is J else M.rlwe.ak_gen(rp, 5, z, rng, "cpu")
        auto = M.rlwe.automorphism(rp, ak, acc)
        outs.append([ct.a, ct_pk.b, M.rgsw.decrypt_rgsw(gp, z, ct_pk), ev.a, ext.a, ext.b, auto.a, auto.b])
    return outs[1], outs[0]


def _op_lwe_shares_and_neg(jparams, tparams, rng_seed):
    """The LWE share API at the big-Q LWE view and lwe.neg."""
    outs = []
    for M, params in ((J.lwe, jparams.lwe_z), (lwe, tparams.lwe_z)):
        rng = np.random.default_rng(rng_seed)
        a = rng.integers(0, params.q, size=(3, params.n), dtype=np.uint64)
        sk = rng.integers(-3, 4, size=params.n)
        ta = jnp.asarray(a) if M is J.lwe else u64_to_torch(a)
        pt = M.encode(params, jnp.asarray(np.array([0, 1, 3], dtype=np.uint64)) if M is J.lwe else torch.tensor([0, 1, 3]))
        share = M.sk_share_encrypt(params, ta, sk, pt, rng)
        ct = M.encryption_share_merge(params, ta, [share, share])
        dec = M.share_decrypt(params, sk, ta, rng)
        outs.append([share, M.decryption_share_merge(params, ct.b, [dec]), M.neg(params, ct).a])
    return outs[1], outs[0]


OPS = {
    "rlwe_sk_pk_encrypt_decrypt": _op_rlwe_sk_pk_encrypt_decrypt,
    "rgsw_encrypt_products": _op_rgsw_encrypt_products,
    "lwe_shares_and_neg": _op_lwe_shares_and_neg,
}


@pytest.mark.parametrize("op", list(OPS))
def test_u64_scheme_op_matches_jax(op):
    got, want = OPS[op](_params(J), _params(T), len(op))
    for i, (g, w) in enumerate(zip(got, want)):
        _eq(g, w, f"{op} output {i}")
