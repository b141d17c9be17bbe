"""The CKKS and BGV ring's element-wise stages against the JAX package, on
the CPU's plain path, bit for bit, on inputs made from a numpy seed:
`rns_add` / `rns_sub` / `rns_neg` (K-RNS-ADD's plain routes: pairs, an
(L, N) operand repeated over a batch, the values 0 and q - 1, the largest
prime a plan takes), `rescale_k` with the add that follows it (K-RESCALE's
add operand), the key switch's hoist in QP order at dnum 1, 2 and 3 below
the top level (K-BASECONV writing into its rows), `mod_raise` and BGV's
`key_switch`. Also the shapes the wrappers refuse on either device, and
models of the kernels' index arithmetic (a word's rows, the rescale's add
parts, K-BASECONV's launch plan and row tables) against the plain
versions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.models import bgv as JG  # noqa: E402
from learn_fhe_tpu.models.ckks import ckks as JC  # noqa: E402
from learn_fhe_tpu.models.ckks import evalmod as JE  # noqa: E402
from learn_fhe_tpu.ops import rns as JR  # noqa: E402
from learn_fhe_tpu_torch.models import bgv as TG  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import ckks as TC  # noqa: E402
from learn_fhe_tpu_torch.models.ckks import evalmod as TE  # noqa: E402
from learn_fhe_tpu_torch.ops import rns as TR  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u64, u64_to_torch  # noqa: E402
from learn_fhe_tpu_torch.utils.primes import two_adic_primes  # noqa: E402

N = 32
# 55-bit primes as CKKS draws them, and the largest primes a plan takes
# (K-RNS-NTT's eager instances: below 2^63)
P55 = tuple(x for _, x in zip(range(4), two_adic_primes(55, 6)))
P63 = tuple(x for _, x in zip(range(3), two_adic_primes(63, 6)))


def _residues(rng, qs, lead, n=N, edges=True):
    """(*lead, L, n) residues below each limb's prime; with edges, each
    limb's first values are 0 and q - 1."""
    x = np.stack([rng.integers(0, q, size=(*lead, n), dtype=np.uint64) for q in qs], axis=-2)
    if edges:
        for l, q in enumerate(qs):
            x[..., l, :2] = (0, q - 1)
    return x


def _same(want, got):
    np.testing.assert_array_equal(torch_to_u64(got), np.asarray(want))


OPS = {"add": (TR.rns_add, JR.rns_add), "sub": (TR.rns_sub, JR.rns_sub), "neg": (TR.rns_neg, JR.rns_neg)}


@pytest.mark.parametrize("qs", [P55, P63], ids=["55-bit", "63-bit"])
@pytest.mark.parametrize("op", sorted(OPS))
@pytest.mark.parametrize("layout", ["same", "b repeated", "a repeated", "pair"])
def test_elementwise_matches_jax(qs, op, layout):
    rng = np.random.default_rng(len(qs) * 100 + len(op) * 10 + len(layout))
    tplan, jplan = TR.rns_plan(qs, N), JR.rns_plan(qs, N)
    fn, jfn = OPS[op]
    lead_a = () if layout == "a repeated" else (3,)
    lead_b = () if layout == "b repeated" else (3,)
    a, b = _residues(rng, qs, lead_a), _residues(rng, qs, lead_b)
    if lead_a == lead_b:
        b[..., 2:4] = a[..., 2:4]  # equal values: a - b = 0
    if op == "neg":
        want = [jfn(jnp.asarray(a), jplan)]
        got = fn(u64_to_torch(a), tplan) if layout != "pair" else None
    else:
        want = [jfn(jnp.asarray(a), jnp.asarray(b), jplan)]
        got = fn(u64_to_torch(a), u64_to_torch(b), tplan) if layout != "pair" else None
    if layout == "pair":  # a ciphertext's b and a: one call
        a2, b2 = _residues(rng, qs, lead_a), _residues(rng, qs, lead_b)
        want.append(jfn(jnp.asarray(a2), jplan) if op == "neg" else jfn(jnp.asarray(a2), jnp.asarray(b2), jplan))
        xs = (u64_to_torch(a), u64_to_torch(a2))
        got = fn(xs, tplan) if op == "neg" else fn(xs, (u64_to_torch(b), u64_to_torch(b2)), tplan)
        assert isinstance(got, tuple) and len(got) == 2
    for w, g in zip(want, got if isinstance(got, tuple) else (got,)):
        _same(w, g)


def test_elementwise_on_a_block_of_columns_matches_jax():
    """A rank's block of the ring's columns (`parallel/limb.py`'s 2-D
    rotation adds (..., L, N / D) blocks under the level's plan)."""
    qs, rng = P55, np.random.default_rng(4)
    a, b = _residues(rng, qs, (2,), n=N // 4), _residues(rng, qs, (2,), n=N // 4)
    _same(JR.rns_add(jnp.asarray(a), jnp.asarray(b), JR.rns_plan(qs, N)), TR.rns_add(u64_to_torch(a), u64_to_torch(b), TR.rns_plan(qs, N)))


def test_elementwise_counts_calls_and_refuses_other_shapes():
    qs, rng = P55, np.random.default_rng(3)
    plan = TR.rns_plan(qs, N)
    a = u64_to_torch(_residues(rng, qs, (2, 3)))
    before = TR.rns_add.calls
    TR.rns_add(a, a[0, 0], plan)
    assert TR.rns_add.calls == before + 1 and TR.rns_add.launches == 0  # the CPU launches nothing
    for b in (
        u64_to_torch(_residues(rng, qs, (4,))),  # other leading axes
        u64_to_torch(_residues(rng, qs[:3], (2, 3))),  # other limbs
        u64_to_torch(_residues(rng, qs, (2, 3), n=N // 2)),  # another row length
        a.int(),  # not int64
    ):
        with pytest.raises(ValueError):
            TR.rns_add(a, b, plan)
    half = u64_to_torch(_residues(rng, qs, (), n=N // 2))
    with pytest.raises(ValueError):  # the parts of a pair share one ring
        TR.rns_sub((a, half), (a, half), plan)
    with pytest.raises(ValueError):
        TR.rns_neg((a, a, a), plan)
    # a strided operand is taken as its contiguous copy
    strided = a.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert torch.equal(TR.rns_add(a, strided, plan), TR.rns_add(a, a.clone(), plan))


@pytest.mark.parametrize("op", ["add", "sub"])
def test_elementwise_pair_of_two_layouts_matches_jax(op):
    """A ciphertext with a batched b and an unbatched a (an add of a batch of
    plaintexts to one ciphertext): each part of the pair broadcast as the
    JAX package's `rns_add` broadcasts it, in one call."""
    qs, rng = P55, np.random.default_rng(6)
    tplan, jplan = TR.rns_plan(qs, N), JR.rns_plan(qs, N)
    fn, jfn = OPS[op]
    b0, a0, b1, a1 = _residues(rng, qs, (3,)), _residues(rng, qs, ()), _residues(rng, qs, ()), _residues(rng, qs, ())
    got = fn((u64_to_torch(b0), u64_to_torch(a0)), (u64_to_torch(b1), u64_to_torch(a1)), tplan)
    _same(jfn(jnp.asarray(b0), jnp.asarray(b1), jplan), got[0])
    _same(jfn(jnp.asarray(a0), jnp.asarray(a1), jplan), got[1])
    got = fn((u64_to_torch(a1), u64_to_torch(b0)), (u64_to_torch(b0), u64_to_torch(a0)), tplan)
    _same(jfn(jnp.asarray(a1), jnp.asarray(b0), jplan), got[0])
    _same(jfn(jnp.asarray(b0), jnp.asarray(a0), jplan), got[1])


def test_elementwise_word_rows_model():
    """K-RNS-ADD's indexing (`rns_add_kernel`): 16-byte word i of the output
    is values 2i and 2i + 1 of row r = 2i / N, read from a's row r mod
    a_rows and b's r mod b_rows under limb r mod L: with `_add_layout`'s
    counts it is torch's broadcast of an (L, N) operand."""
    qs, rng = P55[:3], np.random.default_rng(5)
    L = len(qs)
    q = np.array(qs, dtype=np.uint64)
    for lead_a, lead_b in (((2, 3), (2, 3)), ((2, 3), ()), ((), (4,)), ((1, 1), (2,))):
        a, b = _residues(rng, qs, lead_a), _residues(rng, qs, lead_b)
        ta, tb = u64_to_torch(a), u64_to_torch(b)
        shape, rows, a_rows, b_rows = TR._add_layout("rns_add", ta, tb, L)
        af, bf = a.reshape(-1, N), b.reshape(-1, N)
        y = np.empty((rows, N), dtype=np.uint64)
        for i in range(rows * N // 2):
            r, c = 2 * i // N, 2 * i % N
            s = af[r % a_rows, c : c + 2] + bf[r % b_rows, c : c + 2]
            y[r, c : c + 2] = np.minimum(s, s - q[r % L])
        np.testing.assert_array_equal(y.reshape(shape), torch_to_u64(TR.rns_add(ta, tb, TR.rns_plan(qs, N))))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("adds", ["tensor", "pair", "pair, first None"])
def test_rescale_with_add_matches_jax(k, adds):
    qs = tuple(x for _, x in zip(range(5), two_adic_primes(55, 6)))
    rng = np.random.default_rng(k * 7 + len(adds))
    keep = qs[:-k]
    jkeep = JR.rns_plan(keep, N)
    x = _residues(rng, qs, (2, 2))
    want = JR.rescale_k(jnp.asarray(x), qs, k)
    if adds == "tensor":
        add = _residues(rng, keep, (2, 2))
        got = TR.rescale_k(u64_to_torch(x), qs, k, add=u64_to_torch(add))
        want = JR.rns_add(want, jnp.asarray(add), jkeep)
    else:
        parts = [_residues(rng, keep, (2,)), _residues(rng, keep, (2,))]
        if adds == "pair, first None":
            parts[0] = None
        got = TR.rescale_k(u64_to_torch(x), qs, k, add=tuple(None if p is None else u64_to_torch(p) for p in parts))
        assert isinstance(got, tuple) and len(got) == 2  # a pair of adds gives the pair of parts
        got = torch.stack(got)
        want = jnp.stack([w if p is None else JR.rns_add(w, jnp.asarray(p), jkeep) for w, p in zip(want, parts)])
    _same(want, got)
    # K-RESCALE's add indexing (`rescale_kernel`): output value i of block b
    # takes add0[i] for b < half, add1[i - half keep N] past it
    flat = torch_to_u64(TR.rescale_k(u64_to_torch(x), qs, k)).reshape(-1)
    blocks, half = x.shape[0] * x.shape[1], x.shape[1] if adds != "tensor" else x.shape[0] * x.shape[1]
    per = len(keep) * N
    add0 = add.reshape(-1) if adds == "tensor" else (None if parts[0] is None else parts[0].reshape(-1))
    add1 = None if adds == "tensor" else parts[1].reshape(-1)
    model = flat.copy()
    qk = np.array(keep, dtype=np.uint64)
    for i in range(blocks * per):
        b, l = i // per, (i % per) // N
        src = add0 if b < half else add1
        if src is not None:
            with np.errstate(over="ignore"):  # u64 wraps, as the kernel's
                s = model[i] + src[i if b < half else i - half * per]
                model[i] = min(s, s - qk[l])
    np.testing.assert_array_equal(model.reshape(np.asarray(want).shape), np.asarray(want))


@pytest.mark.parametrize("lead, add_lead, k", [((2,), (3,), 1), ((2, 3), (), 3)], ids=["batched add", "unbatched add"])
def test_rescale_with_a_broadcast_add_matches_jax(lead, add_lead, k):
    """An add whose leading axes are not the output part's (a batched b on
    the switch of an unbatched a, or the reverse) is added after the
    launch, broadcast as the JAX package's `rns_add` after `rescale_k`."""
    qs = tuple(x for _, x in zip(range(5), two_adic_primes(55, 6)))
    rng = np.random.default_rng(k + 40)
    keep = qs[:-k]
    x = _residues(rng, qs, lead)
    add = _residues(rng, keep, add_lead)
    want = JR.rescale_k(jnp.asarray(x), qs, k)
    b, a = TR.rescale_k(u64_to_torch(x), qs, k, add=(u64_to_torch(add), None))
    _same(JR.rns_add(want[0], jnp.asarray(add), JR.rns_plan(keep, N)), b)
    _same(want[1], a)


def test_rescale_add_refuses_other_shapes():
    qs, rng = tuple(x for _, x in zip(range(4), two_adic_primes(55, 6))), np.random.default_rng(9)
    x = u64_to_torch(_residues(rng, qs, (2, 3)))
    for add in (
        u64_to_torch(_residues(rng, qs[:-1], (3,))),  # neither the output's shape nor one K-RNS-ADD broadcasts
        (u64_to_torch(_residues(rng, qs[:-1], (2, 3))), None),  # the same for a pair's entry
        (u64_to_torch(_residues(rng, qs[:-1], (2, 3))).int(), None),  # not int64
        (None, None, None),
    ):
        with pytest.raises(ValueError):
            TR.rescale_k(x, qs, 1, add=add)
    with pytest.raises(ValueError):  # a pair needs a leading axis of 2
        TR.rescale_k(u64_to_torch(_residues(rng, qs, (3,))), qs, 1, add=(None, None))


@pytest.mark.parametrize("dnum", [1, 2, 3])
def test_ks_hoist_matches_jax_below_the_top(dnum):
    kw = dict(log_n=4, log_qi=55, big_l=6, dnum=dnum)
    jp, tp = JC.CkksParams(**kw), TC.CkksParams(**kw)
    qs = jp.qs[:5]  # below the top level: with dnum > 1 a digit's limbs sit between the others
    a = _residues(np.random.default_rng(dnum), qs, (2,), n=jp.n)
    want = JC._ks_hoist(jp, jnp.asarray(a), qs)
    got = TC._ks_hoist(tp, u64_to_torch(a), qs)
    _same(want, got)
    digits = len(tp.digit_slices(len(qs)))
    if digits > 1:  # a range of digits (the limb-sharded dnum ladder): the same rows
        part = TC._ks_extend(tp, u64_to_torch(a), qs, (1, digits))
        assert torch.equal(part, TC._ks_extend(tp, u64_to_torch(a), qs)[..., 1:, :, :])


def test_mod_raise_matches_jax():
    kw = dict(log_n=4, log_qi=55, big_l=6)
    jp, tp = JC.CkksParams(**kw), TC.CkksParams(**kw)
    q0 = jp.qs[0]
    rng = np.random.default_rng(21)
    b, a = (_residues(rng, (q0,), (2,), n=jp.n) for _ in range(2))
    want = JE.mod_raise(jp, JC.CkksCiphertext(jnp.asarray(b), jnp.asarray(a), (q0,)))
    got = TE.mod_raise(tp, TC.CkksCiphertext(u64_to_torch(b), u64_to_torch(a), (q0,)))
    assert got.qs == want.qs
    _same(want.b, got.b)
    _same(want.a, got.a)


def test_bgv_key_switch_matches_jax():
    kw = dict(log_n=5, t=65537, log_qi=45, big_l=3)
    jp, tp = JG.BgvParams(**kw), TG.BgvParams(**kw)
    rng = np.random.default_rng(33)
    kb, ka = (_residues(rng, jp.qps, (), n=jp.n) for _ in range(2))
    qs = jp.qs[:2]  # below the top: the key's level rows
    b, a = (_residues(rng, qs, (2,), n=jp.n) for _ in range(2))
    want = JG.key_switch(jp, JG.BgvKeySwitchingKey(jnp.asarray(kb), jnp.asarray(ka), jp.qps), JG.BgvCiphertext(jnp.asarray(b), jnp.asarray(a), qs))
    ksk = TG.BgvKeySwitchingKey(u64_to_torch(kb), u64_to_torch(ka), tp.qps)
    got = TG.key_switch(tp, ksk, TG.BgvCiphertext(u64_to_torch(b), u64_to_torch(a), qs))
    _same(want.b, got.b)
    _same(want.a, got.a)


def test_base_convert_launch_plan_model():
    """K-BASECONV's launches past `_conv_out_limbs` (`_conv_launches`): each
    slice of output primes into its rows of one tensor and x's limbs copied
    by the first launch alone, as the kernel stores them, equal the plain
    extension placed in those rows."""
    stream = two_adic_primes(50, 2)
    primes = tuple(next(stream) for _ in range(64 + 100))
    qs, ps = primes[:64], primes[64:]
    most = TR._conv_out_limbs(len(qs))
    assert most < len(ps)  # this case splits
    x = _residues(np.random.default_rng(8), qs, (2,), n=2)
    R = len(qs) + len(ps)
    rows = tuple(range(len(qs), R))[::-1]
    own = tuple(range(len(qs)))
    plan = TR._conv_launches(len(qs), len(ps), rows, own)
    assert [m for _, m, _, _ in plan] == [most, len(ps) - most] and [c for *_, c in plan] == [True, False]
    ref = torch_to_u64(TR.base_convert_ref(u64_to_torch(x), qs, ps))
    model = np.zeros((2, R, 2), dtype=np.uint64)
    for j, m, table, copy in plan:
        if copy:
            for k in range(len(qs)):
                model[:, table[k]] = x[:, k]
        for jj in range(m):
            model[:, table[len(qs) + jj]] = ref[:, j + jj]
    out = torch.zeros((2, R, 2), dtype=torch.int64)
    TR.base_convert(u64_to_torch(x), qs, ps, out=out, rows=rows, own=own)
    np.testing.assert_array_equal(model, torch_to_u64(out))
    # a lone launch without rows needs no table; a split one without rows takes rows 0..lp-1
    assert TR._conv_launches(8, 8, None, None) == [(0, 8, None, False)]
    assert [t[len(qs) :] for _, _, t, _ in TR._conv_launches(len(qs), len(ps), None, None)] == [
        tuple(range(most)),
        tuple(range(most, len(ps))),
    ]
    with pytest.raises(ValueError):  # a row twice
        TR.base_convert(u64_to_torch(x), qs, ps, out=out, rows=(0,) * len(ps), own=own)


@pytest.fixture(scope="module")
def ckks_keys():
    """Both packages' CKKS keys at N = 16 from seed 51, drawn in one order:
    sk, rlk, the rotation keys for 1 and 3."""
    kw = dict(log_n=4, log_qi=55, big_l=3)
    jp, tp = JC.CkksParams(**kw), TC.CkksParams(**kw)
    jrng, trng = np.random.default_rng(51), np.random.default_rng(51)
    sk = JC.sk_gen(jp, jrng)
    np.testing.assert_array_equal(TC.sk_gen(tp, trng), sk)
    js = (1, 3)
    return dict(
        jp=jp, tp=tp, js=js,
        jrlk=JC.rlk_gen(jp, sk, jrng), trlk=TC.rlk_gen(tp, sk, trng, device="cpu"),
        jrtk=tuple(JC.rtk_gen(jp, sk, j, jrng) for j in js), trtk=tuple(TC.rtk_gen(tp, sk, j, trng, device="cpu") for j in js),
    )  # fmt: skip


@pytest.mark.parametrize("batched", ["b", "a"])
@pytest.mark.parametrize("op", ["add", "sub", "key_switch", "rotate", "hoisted_rotations"])
def test_ckks_ops_on_a_ciphertext_of_two_shapes_match_jax(ckks_keys, op, batched):
    """A ciphertext whose b is batched and a is not (or the reverse), as
    adding a batch of plaintexts to one ciphertext makes: add and sub with
    an unbatched one, the key switch, a rotation and hoisted rotations,
    each against the JAX package bit for bit."""
    e = ckks_keys
    jp, tp, qs = e["jp"], e["tp"], e["jp"].qs
    rng = np.random.default_rng(len(op) + (10 if batched == "b" else 20))
    b, a = _residues(rng, qs, (2,) if batched == "b" else (), n=jp.n), _residues(rng, qs, (2,) if batched == "a" else (), n=jp.n)
    b1, a1 = _residues(rng, qs, (), n=jp.n), _residues(rng, qs, (), n=jp.n)
    jct, tct = JC.CkksCiphertext(jnp.asarray(b), jnp.asarray(a), qs), TC.CkksCiphertext(u64_to_torch(b), u64_to_torch(a), qs)
    jct1, tct1 = JC.CkksCiphertext(jnp.asarray(b1), jnp.asarray(a1), qs), TC.CkksCiphertext(u64_to_torch(b1), u64_to_torch(a1), qs)
    if op == "add":
        pairs = [(JC.add(jct, jct1), TC.add(tct, tct1)), (JC.add(jct1, jct), TC.add(tct1, tct))]
    elif op == "sub":
        pairs = [(JC.sub(jct1, jct), TC.sub(tct1, tct))]
    elif op == "key_switch":
        pairs = [(JC.key_switch(jp, e["jrlk"], jct), TC.key_switch(tp, e["trlk"], tct))]
    elif op == "rotate":
        pairs = [(JC.rotate(jp, e["jrtk"][1], jct), TC.rotate(tp, e["trtk"][1], tct))]
    else:
        pairs = list(zip(JC.hoisted_rotations(jp, e["jrtk"], jct, e["js"]), TC.hoisted_rotations(tp, e["trtk"], tct, e["js"])))
    for want, got in pairs:
        assert got.qs == want.qs
        _same(want.b, got.b)
        _same(want.a, got.a)


def test_bgv_ops_after_a_batch_of_plaintexts_match_jax():
    """BGV: a batch of plaintexts added to one ciphertext (a batched b, an
    unbatched a), then add and sub with an unbatched ciphertext and a
    rotation, each against the JAX package bit for bit."""
    kw = dict(log_n=5, t=65537, log_qi=45, big_l=3)
    jp, tp = JG.BgvParams(**kw), TG.BgvParams(**kw)
    jrng, trng = np.random.default_rng(61), np.random.default_rng(61)
    sk = JG.sk_gen(jp, jrng)
    np.testing.assert_array_equal(TG.sk_gen(tp, trng), sk)
    jrtk, trtk = JG.rtk_gen(jp, sk, 1, jrng), TG.rtk_gen(tp, sk, 1, trng, "cpu")
    rng = np.random.default_rng(62)
    qs = jp.qs
    b, a, b1, a1 = (_residues(rng, qs, (), n=jp.n) for _ in range(4))
    m = rng.integers(0, jp.t, size=(3, jp.n), dtype=np.int64)
    jct = JG.add_plain(jp, m, JG.BgvCiphertext(jnp.asarray(b), jnp.asarray(a), qs))
    tct = TG.add_plain(tp, m, TG.BgvCiphertext(u64_to_torch(b), u64_to_torch(a), qs))
    assert tuple(tct.b.shape) == (3, len(qs), jp.n) and tuple(tct.a.shape) == (len(qs), jp.n)
    jct1, tct1 = JG.BgvCiphertext(jnp.asarray(b1), jnp.asarray(a1), qs), TG.BgvCiphertext(u64_to_torch(b1), u64_to_torch(a1), qs)
    for want, got in (
        (jct, tct),
        (JG.add(jct, jct1), TG.add(tct, tct1)),
        (JG.sub(jct1, jct), TG.sub(tct1, tct)),
        (JG.rotate(jp, jrtk, jct), TG.rotate(tp, trtk, tct)),
    ):
        assert got.qs == want.qs and got.factor == want.factor
        _same(want.b, got.b)
        _same(want.a, got.a)
