"""The port's RNS u64 engine (`learn_fhe_tpu_torch/ops/rns.py`) against the
JAX package (`learn_fhe_tpu/ops/rns.py`), on the CPU's plain path: the
stacked-limb transforms, products, base extension and rescale, bit for bit,
on inputs made from a seed with numpy. Also the base extension's f64
overflow count against XLA's own sum, the fused multiply-add emulation it
rests on, the encode/decode twiddle tables, and `generic_mul_mod`'s even
moduli."""

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.models.ckks import ckks as JC  # noqa: E402
from learn_fhe_tpu.ops import modular as jmod  # noqa: E402
from learn_fhe_tpu.ops import rns as JR  # noqa: E402
from learn_fhe_tpu_torch.ops import modular as tmod  # noqa: E402
from learn_fhe_tpu_torch.ops import rns as TR  # noqa: E402
from learn_fhe_tpu_torch.utils import kernels  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u64, u64_to_torch  # noqa: E402
from learn_fhe_tpu_torch.utils.primes import two_adic_primes  # noqa: E402

# 55-bit NTT-friendly primes for N up to 2^13, as CKKS draws them: 8 q-primes
# then 8 p-primes, and a 45/55-bit ladder (tests/test_ckks_dnum.py)
_STREAM = two_adic_primes(55, 14)
PRIMES = tuple(next(_STREAM) for _ in range(24))
LADDER = JC.CkksParams(log_n=5, log_qi=55, big_l=6, log_qis=(55, 45, 45, 55, 45, 45), log_ps=(55, 55), dnum=3)


def _residues(rng, qs, shape):
    """(*shape[:-1], L, N) residues, limb l below qs[l]."""
    *lead, n = shape
    return np.stack([rng.integers(0, q, size=(*lead, n), dtype=np.uint64) for q in qs], axis=-2)


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(torch_to_u64(torch_out), np.asarray(jax_out))


@pytest.mark.parametrize("n", [2, 32, 256])
@pytest.mark.parametrize("limbs", [1, 3, 8])
def test_transforms_and_products_match_jax(n, limbs):
    rng = np.random.default_rng(n * 10 + limbs)
    qs = PRIMES[:limbs]
    x, y = _residues(rng, qs, (3, n)), _residues(rng, qs, (3, n))
    jplan, tplan = JR.rns_plan(qs, n), TR.rns_plan(qs, n)
    tx, ty = u64_to_torch(x), u64_to_torch(y)
    fwd = TR.rns_ntt(tx, tplan)
    _same(JR.rns_ntt(jnp.asarray(x), jplan), fwd)
    _same(JR.rns_intt(jnp.asarray(x), jplan), TR.rns_intt(tx, tplan))
    assert torch.equal(TR.rns_intt(fwd, tplan), tx)  # round trip
    _same(JR.rns_mul_eval(jnp.asarray(x), jnp.asarray(y), jplan), TR.rns_mul_eval(tx, ty, tplan))
    _same(JR.rns_mul(jnp.asarray(x), jnp.asarray(y), jplan), TR.rns_mul(tx, ty, tplan))
    # one operand broadcast over the batch (a key, a plaintext)
    _same(JR.rns_mul(jnp.asarray(x[0]), jnp.asarray(y), jplan), TR.rns_mul(tx[0], ty, tplan))


def test_rns_mac_sums_match_jax():
    """K-RNS-MAC's plain version: sums of K products, and two sums of one x."""
    rng = np.random.default_rng(5)
    qs, n = PRIMES[:8], 32
    xs = [_residues(rng, qs, (2, n)) for _ in range(3)]
    ys = [_residues(rng, qs, (2, n)) for _ in range(3)]
    zs = [_residues(rng, qs, (n,)) for _ in range(3)]
    jplan, tplan = JR.rns_plan(qs, n), TR.rns_plan(qs, n)

    def jdot(ws):
        acc = JR.rns_mul_eval(jnp.asarray(xs[0]), jnp.asarray(ws[0]), jplan)
        for x, w in zip(xs[1:], ws[1:]):
            acc = JR.rns_add(acc, JR.rns_mul_eval(jnp.asarray(x), jnp.asarray(w), jplan), jplan)
        return np.asarray(acc)

    t = lambda vs: [u64_to_torch(v) for v in vs]  # noqa: E731
    _same(jdot(ys), TR.rns_mac(t(xs), t(ys), tplan))
    both = TR.rns_mac(t(xs), t(ys), tplan, t(zs))
    _same(np.stack([jdot(ys), jdot(zs)]), both)


# a 45/55-bit ladder whose primes serve N up to 256
_L45, _L55 = two_adic_primes(45, 9), two_adic_primes(55, 9)
LADDER_256 = tuple(next(_L55 if b == 55 else _L45) for b in (55, 45, 45, 55, 45, 45, 55, 55))


@pytest.mark.parametrize(
    "n,terms,with_z,broadcast,ladder",
    [(2, 1, False, False, False), (32, 2, False, False, False), (32, 3, True, True, True), (256, 3, True, True, False), (256, 1, True, False, True)],
)
def test_rns_intt_mac_matches_jax(n, terms, with_z, broadcast, ladder):
    """rns_intt_mac (its plain path on the CPU) against the JAX package's
    rns_intt of the products' sum: rns_mul_eval of each term added in order
    (the tensor of `mul`), or `_ks_dot` where a key (L, N) is broadcast over
    the batch (the key switch); one sum, or two with z; 55-bit primes and a
    45/55-bit ladder."""
    qs = LADDER_256 if ladder else PRIMES[:8]
    rng = np.random.default_rng(n + terms * 10 + with_z)
    xs = [_residues(rng, qs, (2, n)) for _ in range(terms)]
    w_shape = (n,) if broadcast else (2, n)
    ws = [[_residues(rng, qs, w_shape) for _ in range(terms)] for _ in range(2 if with_z else 1)]
    jplan, tplan = JR.rns_plan(qs, n), TR.rns_plan(qs, n)

    def jsum(wk):
        if broadcast:
            return JC._ks_dot(jnp.asarray(np.stack(wk)), jnp.asarray(np.stack(xs, axis=-3)), jplan)
        acc = JR.rns_mul_eval(jnp.asarray(xs[0]), jnp.asarray(wk[0]), jplan)
        for x, w in zip(xs[1:], wk[1:]):
            acc = JR.rns_add(acc, JR.rns_mul_eval(jnp.asarray(x), jnp.asarray(w), jplan), jplan)
        return acc

    t = lambda vs: [u64_to_torch(v) for v in vs]  # noqa: E731
    want = np.stack([np.asarray(JR.rns_intt(jsum(wk), jplan)) for wk in ws])
    got = TR.rns_intt_mac(t(xs), t(ws[0]), tplan, t(ws[1]) if with_z else None)
    _same(want if with_z else want[0], got)


@pytest.mark.parametrize("lq,lp", [(8, 8), (3, 5)])
@pytest.mark.parametrize("n", [2, 32, 256])
def test_extend_bases_matches_jax(lq, lp, n):
    rng = np.random.default_rng(lq * 100 + n)
    qs, ps = PRIMES[:lq], PRIMES[8 : 8 + lp]
    x = _residues(rng, qs, (2, n))
    _same(JR.extend_bases(jnp.asarray(x), qs, ps), TR.extend_bases(u64_to_torch(x), qs, ps))
    # a slice of the limb axis, as rescale_k hands its dropped limbs over
    x2 = _residues(rng, PRIMES[:8], (2, n))
    tail = PRIMES[8 - lq : 8]
    _same(JR.extend_bases(jnp.asarray(x2[:, 8 - lq :]), tail, ps), TR.extend_bases(u64_to_torch(x2)[:, 8 - lq :], tail, ps))


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("n", [2, 32, 256])
def test_rescale_matches_jax(k, n):
    """k = 1 (the end of mul) and k = 8 (P away after the key switch, over
    the 16 limbs of qs + ps)."""
    rng = np.random.default_rng(k * 1000 + n)
    qs = PRIMES[:16] if k == 8 else PRIMES[:8]
    x = _residues(rng, qs, (3, n))
    _same(JR.rescale_k(jnp.asarray(x), qs, k), TR.rescale_k(u64_to_torch(x), qs, k))


@pytest.mark.parametrize("level", [6, 5, 4, 3, 2])
def test_rescale_on_a_ladder_matches_jax(level):
    """45/55-bit ladder: where the dropped prime is the larger, the kept limbs
    reduce it by Barrett; where smaller (drop[0] < q), they take it raw."""
    qs = LADDER.qs[:level]
    rng = np.random.default_rng(level)
    x = _residues(rng, qs, (2, 32))
    _same(JR.rescale_k(jnp.asarray(x), qs, 1), TR.rescale_k(u64_to_torch(x), qs, 1))
    if level > 2:
        _same(JR.rescale_k(jnp.asarray(x), qs, 2), TR.rescale_k(u64_to_torch(x), qs, 2))


def test_ladder_takes_both_rescale_branches():
    flags = [bool(TR.rescale_plan(LADDER.qs[:level], 1).barrett_m.any()) for level in range(2, 7)]
    raw = [not TR.rescale_plan(LADDER.qs[:level], 1).barrett_m.all() for level in range(2, 7)]
    assert any(flags) and any(raw)


@pytest.mark.parametrize("lq", [2, 8, 23])
def test_overflow_count_sums_equal_xla(lq):
    """The f64 sums behind u = round(sum v_i / q_i) (`rns.py:373-375`), at
    2^15 coefficients, value for value against the JAX expression jitted on
    the CPU; and the counts."""
    rng = np.random.default_rng(lq)
    qs = PRIMES[:lq]
    v = _residues(rng, qs, (2, 1 << 14))
    fracs = JR.base_extend_plan(qs, PRIMES[:1]).q_fracs
    want = np.asarray(jax.jit(lambda v: jnp.sum(v.astype(jnp.float64) * jnp.asarray(fracs), axis=-2))(jnp.asarray(v)))
    got = TR.overflow_sums(u64_to_torch(v), qs).numpy()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    np.testing.assert_array_equal(np.round(got), np.round(want))
    if lq == 8:  # and the whole extension at that size
        ps = PRIMES[8:16]
        _same(JR.extend_bases(jnp.asarray(v), qs, ps), TR.extend_bases(u64_to_torch(v), qs, ps))


def test_fma_f64_rounds_once():
    """fma_f64 against the exact a b + c rounded once, on random values of
    the base extension's range and on products next to a tie."""
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 62, size=4000).astype(np.float64)
    b = 1.0 / rng.integers(1 << 40, 1 << 55, size=4000).astype(np.float64)
    c = rng.random(4000) * 20
    a[:8], b[:8], c[:8] = 2.0**53 + 1, 1.0 + 2.0**-52, 1.0  # exact products past 53 bits
    got = TR.fma_f64(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, c)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "q,raises",
    [
        (1_000_006, True),  # even, below 2^31: the port's shortcut used to compute it
        ((1 << 40) + 2, True),  # even, above 2^31
        (1 << 20, False),  # a power of two
        (1_000_003, False),  # odd, below 2^31
        (next(two_adic_primes(55, 12)), False),  # odd, above
    ],
)
def test_generic_mul_mod_raises_on_even_moduli_as_jax(q, raises):
    rng = np.random.default_rng(q % 1000)
    a = rng.integers(0, q, size=64, dtype=np.uint64)
    b = rng.integers(0, q, size=64, dtype=np.uint64)
    if raises:
        with pytest.raises(NotImplementedError):
            jmod.generic_mul_mod(jnp.asarray(a), jnp.asarray(b), q)
        with pytest.raises(NotImplementedError):
            tmod.generic_mul_mod(u64_to_torch(a), u64_to_torch(b), q)
    else:
        _same(jmod.generic_mul_mod(jnp.asarray(a), jnp.asarray(b), q), tmod.generic_mul_mod(u64_to_torch(a), u64_to_torch(b), q))


@pytest.mark.parametrize("denom,count", [(4, 8), (64, 128), (1024, 2048)])
def test_dd_twiddles_equal_jax_mpmath(denom, count):
    """The port's encode/decode twiddles (mpmath at 140 bits) equal the JAX
    package's double for double."""
    from learn_fhe_tpu.utils.dd import cis_table_dd as jax_table
    from learn_fhe_tpu_torch.utils.dd import cis_table_dd

    want, got = jax_table(denom, count), cis_table_dd(denom, count)
    for f in ("re_h", "re_l", "im_h", "im_l"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("n,conj", [(2, False), (64, True), (1024, False), (1024, True)])
def test_sfft_twiddles_equal_jax(n, conj):
    """The sfft's twiddles, made only at the entries it reads, equal the JAX
    package's, taken from its whole cis_table_dd(2n, 4n)."""
    from learn_fhe_tpu.models.ckks.sfft import w_dd as jax_w
    from learn_fhe_tpu_torch.models.ckks.sfft import w_dd

    want, got = jax_w(n, conj), w_dd(n, conj)
    for f in ("re_h", "re_l", "im_h", "im_l"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("denom,count", [(4, 8), (128, 256)])
def test_f256_twiddles_equal_jax_mpmath(denom, count):
    from learn_fhe_tpu.utils.f256 import cis_table_fp as jax_table
    from learn_fhe_tpu_torch.utils.f256 import cis_table_fp

    want, got = jax_table(denom, count), cis_table_fp(denom, count)
    assert list(got.re) == list(want.re) and list(got.im) == list(want.im)


def test_eval_automorphism_tables_match_jax():
    from learn_fhe_tpu.ops import ntt as jntt
    from learn_fhe_tpu_torch.ops import ntt as tntt

    for n in (2, 32, 256):
        np.testing.assert_array_equal(tntt.eval_exponents(n), jntt.eval_exponents(n))
        for t in (3, 5, 2 * n - 1):
            np.testing.assert_array_equal(tntt.eval_automorphism_perm(n, t), jntt.eval_automorphism_perm(n, t))


_RNS = "_ZN40_GLOBAL__N__1a2b3c4d_8_rns64_cu_5e6f7a8b"


@pytest.mark.parametrize(
    "mangled,name",
    [
        (_RNS + "14rns_ntt_kernelILb0ELb1EEEvPKmPmNS_7StackedEii", "rns_ntt_kernel<false,true>"),
        (_RNS + "14rns_ntt_kernelILb1ELb1EEEvPKmPmNS_7StackedEii", "rns_ntt_kernel<true,true>"),
        (_RNS + "14rns_mac_kernelILb1EEEvNS_5TermsEPmixxiiPKmS5_S5_i", "rns_mac_kernel<true>"),
        (_RNS + "14rns_mac_kernelILi4EEEvNS_5TermsEPmNS_8MacShapeEiPKmS6_S6_", "rns_mac_kernel<4>"),
        (_RNS + "19rns_intt_mac_kernelILb1ELi13ELi1EEEvNS_5TermsEPmNS_7StackedENS_8MacShapeEi", "rns_intt_mac_kernel<true,13,1>"),
        (_RNS + "19rns_intt_mac_kernelILb1ELi13ELi2EEEvNS_5TermsEPmNS_7StackedENS_8MacShapeEi", "rns_intt_mac_kernel<true,13,2>"),
        (_RNS + "19rns_intt_mac_kernelILb0ELi0ELi0EEEvNS_5TermsEPmNS_7StackedENS_8MacShapeEi", "rns_intt_mac_kernel<false,0,0>"),
        (_RNS + "24rns_intt_mac_rows_kernelILb1ELi2EEEvNS_5TermsEPmNS_7StackedENS_8MacShapeEi", "rns_intt_mac_rows_kernel<true,2>"),
        (_RNS + "19base_convert_kernelEPKmPmNS_4ConvEiiixx", "base_convert_kernel"),
        (_RNS + "14rescale_kernelEPKmS1_PmNS_7RescaleEiiixmm", "rescale_kernel"),
        (_RNS + "14rns_ntt_kernelILb0ELb1ELi13EEEvPKmPmNS_7StackedEii", "rns_ntt_kernel<false,true,13>"),
        (_RNS + "14rns_ntt_kernelILb1ELb0ELi0EEEvPKmPmNS_7StackedEii", "rns_ntt_kernel<true,false,0>"),
        (_RNS + "19rns_ntt_rows_kernelILb1ELb1ELi2EEEvPKmPmNS_7StackedEii", "rns_ntt_rows_kernel<true,true,2>"),
        (_RNS + "19base_convert_kernelILi8EEEvPKmPmNS_4ConvEiiixx", "base_convert_kernel<8>"),
        (_RNS + "19base_convert_kernelILi0EEEvPKmPmNS_4ConvEiiixx", "base_convert_kernel<0>"),
        (_RNS + "26rns_intt_mac_gather_kernelILb1ELi13EEEvNS_11GatherTermsEPmNS_7StackedENS_8MacShapeEi", "rns_intt_mac_gather_kernel<true,13>"),
        (_RNS + "26rns_intt_mac_shared_kernelILi4EEEvNS_11GatherTermsEPmNS_7StackedENS_8MacShapeE", "rns_intt_mac_shared_kernel<4>"),
        (_RNS + "31rns_intt_mac_gather_rows_kernelILb0ELi0EEEvNS_11GatherTermsEPmNS_7StackedENS_8MacShapeEi", "rns_intt_mac_gather_rows_kernel<false,0>"),
        (_RNS + "21rns_mac_gather_kernelILi4EEEvNS_11GatherTermsEPmNS_8MacShapeEiPKmS5_S5_", "rns_mac_gather_kernel<4>"),
        (_RNS + "19automorphism_kernelILi4EEEvNS_5PartsEPKiPKmiii", "automorphism_kernel<4>"),
        (_RNS + "19rns_ntt_wide_kernelILb0ELi14EEEvPKmPmNS_7StackedEi", "rns_ntt_wide_kernel<false,14>"),
        (_RNS + "24rns_intt_mac_wide_kernelILi14ELi2EEEvNS_5TermsEPmNS_7StackedENS_8MacShapeE", "rns_intt_mac_wide_kernel<14,2>"),
        (_RNS + "28rns_intt_mac_resident_kernelILi16ELi0EEEvNS_5TermsEPmNS_7StackedENS_8MacShapeE", "rns_intt_mac_resident_kernel<16,0>"),
        (_RNS + "15bgv_drop_kernelILi8ELi4ELi1EEEvNS_9DropPartsEPKmiiixiyy", "bgv_drop_kernel<8,4,1>"),
    ],
)
def test_ptxas_report_names_the_rns_kernels(mangled, name):
    log = (
        f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {mangled}\n"
        "    512 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n"
    )
    assert kernels.ptxas_report(log) == {name: (40, 0, 0, 512)}


def test_wrappers_raise_rather_than_fall_back():
    """Without a card the wrappers take CPU tensors only to their plain
    versions; a tensor the kernel cannot take raises."""
    plan = TR.rns_plan(PRIMES[:2], 8)
    with pytest.raises(ValueError):
        TR._transform(TR.rns_ntt, "lft_rns_ntt_fwd", torch.zeros((2, 8), dtype=torch.int64), plan)
    with pytest.raises(ValueError):
        TR._batch_layout("base_convert", torch.zeros((2, 8), dtype=torch.int64), 2, 8)
    x = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        TR._mac_operands("rns_intt_mac", [x], [x], None, plan)
    # the gathered instances' tables and K-AUTOMORPH's rows
    with pytest.raises(ValueError):
        TR._perm_operands("rns_intt_mac", [torch.arange(8, dtype=torch.int32)], 1, 8)
    with pytest.raises(ValueError):
        TR._check_rows("automorphism_rns", x, 2, 8)
    assert TR._perm_operands("rns_mac", [None, None], 2, 8) is None


def test_gathered_sums_take_the_shared_x_instance_for_one_x_only():
    """rns_intt_mac's shared-x decision (`_shared_x`, `_row_instance`): the
    same tensor in every term is one x; views of one storage at another
    offset or with other strides, and a copy, are not; the instance takes
    lazy primes at N = 2^13 (ROW_LOG_N) and 1..ROW_TERMS terms; past 2^13
    the distinct-x instance takes every gathered sum."""
    n = 1 << TR.ROW_LOG_N
    base = torch.zeros((4, 2, n), dtype=torch.int64)
    x = base[:2]
    assert TR._shared_x([x]) and TR._shared_x([x, x, x]) and TR._shared_x([x, base[:2]])
    assert not TR._shared_x([x, base[1:3]])  # another offset of one storage
    assert not TR._shared_x([x, x.clone()])  # another storage
    wide = torch.zeros((2, 4, n), dtype=torch.int64)
    assert not TR._shared_x([wide[:, :2], wide[:, ::2]])  # one offset, other strides
    assert not TR._shared_x([base.view(8, n)[:1], base[0]])  # one offset, other shapes
    plan = TR.rns_plan(PRIMES[:2], n)
    assert TR._row_instance([x] * TR.ROW_TERMS, plan)
    assert not TR._row_instance([x] * (TR.ROW_TERMS + 1), plan)
    assert not TR._row_instance([x, base[1:3]], plan)
    assert not TR._row_instance([x], TR.rns_plan(PRIMES[:2], n // 2))
    stream = two_adic_primes(63, TR.ROW_LOG_N + 1)
    big = (next(stream), next(stream))
    assert min(big) >= 1 << 62
    assert not TR._row_instance([x], TR.rns_plan(big, n))  # eager primes
    stream = two_adic_primes(55, 17)
    for log_n in (14, 16):
        wide = torch.zeros((2, 2, 1 << log_n), dtype=torch.int64)
        assert not TR._row_instance([wide] * 2, TR.rns_plan((next(stream), next(stream)), 1 << log_n))


def test_ring_limits_of_the_transform_kernels():
    """K-RNS-NTT and rns_intt_mac take 2 <= N <= 2^16; past 2^13 only
    lazy primes (below 2^62), the instances there being lazy alone."""
    s55, s63 = two_adic_primes(55, 18), two_adic_primes(63, 18)
    for log_n in (1, 13, 14, 16):
        assert TR._check_ring("rns_ntt", TR.rns_plan((next(s55),), 1 << log_n))
    assert not TR._check_ring("rns_ntt", TR.rns_plan((next(s63),), 1 << 13))
    for log_n, stream in ((17, s55), (14, s63), (16, s63)):
        with pytest.raises(ValueError):
            TR._check_ring("rns_ntt", TR.rns_plan((next(stream),), 1 << log_n))


# the production ladder's widest primes (59-bit p-primes, 56-bit EvalMod band)
# past N = 2^13, where the kernels now run
_WIDE = {log_n: tuple(next(two_adic_primes(b, log_n + 1)) for b in (52, 56, 59)) for log_n in (14, 16)}


@pytest.mark.parametrize("log_n", [14, 16])
def test_transforms_and_fused_sums_past_2_13_match_jax(log_n):
    """The plain rns_ntt, rns_intt and rns_intt_mac (2 terms and z, the key
    broadcast; and the gathered form through an evaluation-slot
    permutation) on 2 rows of each of 52-, 56- and 59-bit primes at N =
    2^14 and 2^16, against the JAX package's rns_ntt, rns_intt and rns_intt
    of its rns_mul_eval sums."""
    from learn_fhe_tpu.ops.ntt import eval_automorphism_perm as jperm

    n, qs = 1 << log_n, _WIDE[log_n]
    rng = np.random.default_rng(log_n)
    x = _residues(rng, qs, (2, n))
    x[0, 0, 0], x[-1, -1, -1] = 0, qs[-1] - 1
    ys = [_residues(rng, qs, (n,)) for _ in range(2)]
    zs = [_residues(rng, qs, (n,)) for _ in range(2)]
    x2 = _residues(rng, qs, (2, n))
    jplan, tplan = JR.rns_plan(qs, n), TR.rns_plan(qs, n)
    tx = u64_to_torch(x)
    _same(JR.rns_ntt(jnp.asarray(x), jplan), TR.rns_ntt(tx, tplan))
    _same(JR.rns_intt(jnp.asarray(x), jplan), TR.rns_intt(tx, tplan))

    def jsum(xs, ws):
        acc = JR.rns_mul_eval(jnp.asarray(xs[0]), jnp.asarray(ws[0]), jplan)
        for xv, w in zip(xs[1:], ws[1:]):
            acc = JR.rns_add(acc, JR.rns_mul_eval(jnp.asarray(xv), jnp.asarray(w), jplan), jplan)
        return JR.rns_intt(acc, jplan)

    got = TR.rns_intt_mac([tx, u64_to_torch(x2)], [u64_to_torch(y) for y in ys], tplan, [u64_to_torch(z) for z in zs])
    _same(np.stack([jsum([x, x2], ys), jsum([x, x2], zs)]), got)
    perm = jperm(n, pow(5, 3, 2 * n))
    tperm = torch.from_numpy(perm.astype(np.int32))
    got = TR.rns_intt_mac([tx, tx], [u64_to_torch(y) for y in ys], tplan, perms=[None, tperm])
    _same(jsum([x, x[..., perm]], ys), got)
