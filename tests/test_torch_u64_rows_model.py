"""A model of the row passes of the redesigned K-POLYMUL64, K-EXTPROD64,
K-NTT64 and intt64 (`learn_fhe_tpu_torch/csrc/u64_rows.cuh`), held against
the port's plain versions and the JAX package on the CPU.

The kernels run only on a CUDA device, so this models in Python what they
do: the pass plan (head passes of 3 layers, then a last pass of 2), which
thread takes which item of which row, the shared-memory layout and the
bank pairs a half-warp's u64 accesses fall in (the wavefronts each pass
takes, as the design states them), Harvey's lazy ranges through those
passes with the values that reach the products unreduced, and
K-EXTPROD64's digit rows in groups (each group's products summed in 128
bits, one REDC per group, the group residues added mod q), and K-NTT64's
forward-only and intt64's inverse-only plans (the first pass from device
memory, the last to it) with K-NTT64's Montgomery output: one Shoup product
by 2^64 mod q on the lazy values, unreduced.
"""

from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import learn_fhe_tpu.models.fhew as jfhew  # noqa: E402
from learn_fhe_tpu.models.fhew import rgsw as jrgsw  # noqa: E402
from learn_fhe_tpu.models.fhew import rlwe as jrlwe  # noqa: E402
from learn_fhe_tpu.ops import ntt as jntt  # noqa: E402
from learn_fhe_tpu.utils.primes import two_adic_primes  # noqa: E402
from learn_fhe_tpu_torch.ops.gadget import Gadget, decompose_zq  # noqa: E402
from learn_fhe_tpu_torch.models import fhew as tfhew  # noqa: E402
from learn_fhe_tpu_torch.ops.modular import as_i64, to_montgomery  # noqa: E402
from learn_fhe_tpu_torch.ops.ntt import (  # noqa: E402
    intt64_ref,
    negacyclic_mul64_ref,
    ntt64_mont_ref,
    ntt64_ref,
    ntt_plan,
    plan_tables,
)
from tests.test_torch_fhew_walk64_model import _below, _csub, _mac128, _redc, _shoup_lazy  # noqa: E402

CPU = torch.device("cpu")
Q55 = next(two_adic_primes(55, 12))  # the full multi-key set's prime

# -- the plan, the layout and the launch shapes, as u64_rows.cuh and ntt64.cu have them


def at(row: int, w: int, log_n: int) -> int:
    """Value w of row `row`: rows of 2^log_n values one after the other."""
    return (row << log_n) + w


def last_width(log_n: int) -> int:
    return log_n if log_n < 2 else 2


def head_layers(log_n: int) -> int:
    return log_n - last_width(log_n)


def head_passes(log_n: int) -> int:
    return (head_layers(log_n) + 2) // 3


def head_width(log_n: int, p: int) -> int:
    return head_layers(log_n) - 3 * p if p == head_passes(log_n) - 1 else 3


def plan_of(log_n: int) -> list[tuple[int, int]]:
    """(l0, W) of every pass: the head passes, then the last."""
    return [(3 * p, head_width(log_n, p)) for p in range(head_passes(log_n))] + [(head_layers(log_n), last_width(log_n))]


POLYMUL_THREADS = 256


def ext_threads(log_n: int) -> int:
    return min(256, (1 << log_n) >> last_width(log_n))


def ext_group(log_n: int, rows: int, q: int) -> int:
    """The digit rows of a group: what fits beside acc in half an SM's
    shared memory, and on the lazy instance (q < 2^62) no more than G 4q <=
    2^64 - 1, so that unreduced products sum below q 2^64."""
    fit = min(rows, 115 * 1024 // 8 // (1 << log_n) - 2)
    return min(fit, ((1 << 64) - 1) // (4 * q)) if q < 1 << 62 else fit


def visits(threads: int, rows: int, log_items: int) -> list[list[tuple[int, int]]]:
    """Each thread's (item, row) in the order its pass loop takes them."""
    items = 1 << log_items
    wide = threads >= items
    out = []
    for t in range(threads):
        r0, step = (t >> log_items, threads >> log_items) if wide else (0, 1)
        out.append([(i, row) for i in range(t & (items - 1), items, threads) for row in range(r0, rows, step)])
    return out


def item_cols(i: int, log_n: int, l0: int, w: int) -> list[int]:
    log_h = log_n - l0 - w
    col = ((i >> log_h) << (log_n - l0)) + (i & ((1 << log_h) - 1))
    return [col + (m << log_h) for m in range(1 << w)]


# -- the bank model: a u64 access is served a half-warp per wavefront; its
# 16 lanes take one wavefront where they fall in 16 distinct bank pairs


def wavefronts(words: list) -> int:
    total = 0
    for half in (words[:16], words[16:]):
        pairs = defaultdict(set)
        for w in half:
            if w is not None:
                pairs[w % 16].add(w)
        total += max((len(s) for s in pairs.values()), default=0)
    return total


def warp_wavefronts(events: list[list]) -> list[int]:
    """Wavefronts of every warp access: events are lists of a word (or None)
    per thread, one list per access in lockstep."""
    out = []
    for lanes in events:
        for s in range(0, len(lanes), 32):
            warp = lanes[s : s + 32]
            if any(w is not None for w in warp):
                out.append(wavefronts(warp))
    return out


def pass_events(threads, rows, log_n, l0, w, row_of=lambda r: r, load=True, store=True):
    """The shared-memory accesses of one pass, in lockstep."""
    vs = visits(threads, rows, log_n - w)
    events = []
    for k in range(max(len(v) for v in vs)):
        for m in range(1 << w):
            lanes = []
            for v in vs:
                if k < len(v):
                    i, row = v[k]
                    lanes.append(at(row_of(row), item_cols(i, log_n, l0, w)[m], log_n))
                else:
                    lanes.append(None)
            events += [lanes] * (load + store)
    return events


def polymul_events(log_n: int) -> dict[str, list[list]]:
    """K-POLYMUL64's shared-memory accesses by pass: the head passes on a's
    and b's rows (the first loads from device memory), the middle (a, b in;
    the product out), the inverse head passes on the product (the last
    stores to device memory)."""
    threads, per = POLYMUL_THREADS, max(1, 2048 >> log_n)
    plan, events = plan_of(log_n), defaultdict(list)
    for p, (l0, w) in enumerate(plan[:-1]):
        events[l0] += pass_events(threads, 2 * per, log_n, l0, w, load=p > 0)
    if plan[:-1]:
        l0, w = plan[-1]
        for row_of in (lambda r: r, lambda r: per + r, lambda r: r):
            events[l0] += pass_events(threads, per, log_n, l0, w, row_of, store=False)
    for p, (l0, w) in reversed(list(enumerate(plan[:-1]))):
        events[l0] += pass_events(threads, per, log_n, l0, w, store=p > 0)
    return events


def extprod_events(rows: int, log_n: int, key_switch: bool, d: int) -> dict[str, list[list]]:
    """K-EXTPROD64's shared-memory accesses for one group of digit rows, by
    pass: acc in; the digit pass (acc read where an item's source row
    changes, buf written); the head passes; the contraction's reads of buf;
    the first inverse pass's writes of acc; the inverse head passes on acc."""
    threads, n = ext_threads(log_n), 1 << log_n
    gr = ext_group(log_n, rows, Q55)
    plan, events = plan_of(log_n), defaultdict(list)
    events["in"] = [[at(r, j, log_n) if j < n else None for j in range(t, t + threads)] for t in range(0, n, threads) for r in (0, 1)]
    l0, w = plan[0]
    vs = visits(threads, gr, log_n - w)
    cached = [None] * threads
    for k in range(max(len(v) for v in vs)):
        loads, stores = [[None] * threads for _ in range(1 << w)], [[None] * threads for _ in range(1 << w)]
        for t, v in enumerate(vs):
            if k < len(v):
                i, row = v[k]
                src = 0 if key_switch or row < d else 1
                cols = item_cols(i, log_n, l0, w)
                for m in range(1 << w):
                    if cached[t] != (cols[0], src):
                        loads[m][t] = at(src, cols[m], log_n)
                    stores[m][t] = at(row, cols[m], log_n)
                cached[t] = (cols[0], src)
        events[l0] += loads + stores
    for l0, w in plan[1:-1]:
        events[l0] += pass_events(threads, gr, log_n, l0, w)
    l0, items = plan[-1][0], n >> 2
    own = [[i for i in range(t, items, threads)] for t in range(threads)]
    for k in range(max(len(o) for o in own)):
        for rows_of in [range(gr), (0, 1)]:  # the contraction's reads; the first inverse pass's writes
            for r in rows_of:
                events[l0] += [[at(r, 4 * o[k] + m, log_n) if k < len(o) else None for o in own] for m in range(4)]
    for p, (l0, w) in reversed(list(enumerate(plan[:-1]))):
        events[l0] += pass_events(threads, 2, log_n, l0, w, store=p > 0)
    return events


# The wavefronts a warp's u64 access takes, by pass (l0; "in": acc's load),
# as the design states them at N = 2048: 2 (the least) but in the pass at
# l0 = 6, whose half-warp spans 4 groups of 4 values 32 apart, and the last
# pass, whose lanes are 4 values apart: 8. (An XOR layout that took 2
# everywhere measured slower; PERF.md.) At the other rings, at most 8.
AT_2048 = {"in": 2, 0: 2, 3: 2, 6: 8, 9: 8}


def test_layout_holds_every_value_once():
    for log_n in range(1, 12):
        n = 1 << log_n
        assert sorted(at(r, w, log_n) for r in range(3) for w in range(n)) == list(range(3 * n))


@pytest.mark.parametrize(
    "log_n,threads",
    [(k, POLYMUL_THREADS) for k in (1, 2, 3, 4, 5, 7, 8, 11)] + [(k, ext_threads(k)) for k in (1, 2, 3, 4, 5, 7, 8, 11)],
)
def test_passes_visit_every_value_once_with_the_reference_twiddles(log_n, threads):
    """Every pass of the plan, with the block's threads (K-POLYMUL64's, or
    K-EXTPROD64's: one per last-pass item) dealt over the items of 2 rows:
    each (row, item) is taken once, and the butterflies of each layer pair
    exactly ntt64_ref's values with its twiddle index 2^L + g, each value
    once."""
    n, rows = 1 << log_n, 2
    seen = defaultdict(list)  # (row, layer) -> (pair, twiddle index)
    layers = 0
    for l0, w in plan_of(log_n):
        taken = [x for v in visits(threads, rows, log_n - w) for x in v]
        assert sorted(taken) == [(i, r) for i in range(n >> w) for r in range(rows)]
        for i, row in taken:
            cols, g = item_cols(i, log_n, l0, w), i >> (log_n - l0 - w)
            for t in range(w):
                half = 1 << (w - 1 - t)
                for u in range(1 << t):
                    for j in range(half):
                        a = 2 * half * u + j
                        seen[row, l0 + t].append(((cols[a], cols[a + half]), (1 << (l0 + t)) + (g << t) + u))
        layers += w
    assert layers == log_n
    for (row, layer), pairs in seen.items():
        h = n >> (layer + 1)
        want = sorted(((g * 2 * h + j, g * 2 * h + h + j), (1 << layer) + g) for g in range(1 << layer) for j in range(h))
        assert sorted(pairs) == want


@pytest.mark.parametrize("log_n", [4, 6, 8, 11])
def test_shared_memory_accesses_take_the_stated_wavefronts(log_n):
    """Every warp access of K-POLYMUL64 and of K-EXTPROD64 (an external
    product of 10 rows and a key switch of 5) takes, pass by pass, the
    wavefronts the design states at N = 2048, and no more than 8 at the
    other rings."""
    passes = [polymul_events(log_n)] + [extprod_events(rows, log_n, ks, 5) for rows, ks in ((10, False), (5, True))]
    for events in passes:
        for l0, accesses in events.items():
            counts = set(warp_wavefronts(accesses))
            assert min(counts) >= 1
            if log_n == 11:
                assert counts == {AT_2048[l0]}, f"pass {l0}"
            else:
                assert max(counts) <= 8


# -- the arithmetic: the plan's passes on values, with Harvey's ranges


def _ult64(x: torch.Tensor, bound: int) -> bool:
    return _below(x, bound)


def model_pass(x: torch.Tensor, plan, l0: int, w: int, inverse: bool, lazy: bool) -> torch.Tensor:
    """One pass of W layers from l0 on rows x (..., N), as fwd_radix /
    inv_radix run them on each item; the lazy ranges checked per layer."""
    n, q, log_n = plan.n, plan.q, plan.log_n
    t = plan_tables(plan, CPU)
    tab, tab_s = (t.psi_inv, t.psi_inv_s) if inverse else (t.psi, t.psi_s)
    shape = x.shape
    v = list(x.reshape(*shape[:-1], 1 << l0, 1 << w, n >> (l0 + w)).unbind(-2))  # values m of every item
    g = torch.arange(1 << l0)
    for tt in reversed(range(w)) if inverse else range(w):
        half = 1 << (w - 1 - tt)
        for u in range(1 << tt):
            idx = (1 << (l0 + tt)) + (g << tt) + u
            wt, wst = tab[idx][:, None], tab_s[idx][:, None]
            for j in range(half):
                a = 2 * half * u + j
                x0, x1 = v[a], v[a + half]
                if inverse and lazy:
                    v[a], v[a + half] = _csub(x0 + x1, 2 * q), _shoup_lazy(x0 - x1 + 2 * q, wt, wst, q)
                elif inverse:
                    s, dd = x0 + x1, x0 - x1
                    v[a], v[a + half] = _csub(s, q), _csub(_shoup_lazy(torch.where(_ult_t(x0, x1), dd + q, dd), wt, wst, q), q)
                elif lazy:
                    y0, y1 = _csub(x0, 2 * q), _shoup_lazy(x1, wt, wst, q)
                    v[a], v[a + half] = y0 + y1, y0 - y1 + 2 * q
                else:
                    y1 = _csub(_shoup_lazy(x1, wt, wst, q), q)
                    dd = x0 - y1
                    v[a], v[a + half] = _csub(x0 + y1, q), torch.where(_ult_t(x0, y1), dd + q, dd)
        bound = (2 * q if inverse else 4 * q) if lazy else q
        assert all(_ult64(val, bound) for val in v), f"a value left [0, {bound // q}q)"
    return torch.stack(v, dim=-2).reshape(shape)


def _ult_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    sign = -(1 << 63)
    return (a ^ sign) < (b ^ sign)


def model_ntt(x, plan, lazy=True, reduce=True):
    """The forward passes; lazy values stay below 4q unless reduced."""
    for l0, w in plan_of(plan.log_n):
        x = model_pass(x, plan, l0, w, False, lazy)
    return _csub(_csub(x, 2 * plan.q), plan.q) if lazy and reduce else x


def model_intt(x, plan, lazy=True):
    for l0, w in reversed(plan_of(plan.log_n)):
        x = model_pass(x, plan, l0, w, True, lazy)
    return _csub(_shoup_lazy(x, plan.n_inv, as_i64(plan.n_inv_shoup), plan.q), plan.q)


def model_mul_mod(a, b, plan):
    """lft64::mul_mod: REDC(a b), then REDC of that times 2^128 mod q; each
    REDC's input below q 2^64 (checked), so a and b may be below 4q where
    16 q < 2^64."""
    hi, lo = _mac128(torch.zeros_like(a), torch.zeros_like(a), a, b)
    assert _below(hi, plan.q), "a product left the REDC bound"
    t = _redc(hi, lo, plan)
    r2 = torch.full_like(t, as_i64(plan.zq.r2))
    hi, lo = _mac128(torch.zeros_like(t), torch.zeros_like(t), t, r2)
    return _redc(hi, lo, plan)


def model_polymul(a, b, plan, lazy=True):
    """The forward transforms, left below 4q where q < 2^60 (reduced above),
    the product, the inverse."""
    reduce = lazy and plan.q >= 1 << 60
    fa, fb = model_ntt(a, plan, lazy, reduce), model_ntt(b, plan, lazy, reduce)
    return model_intt(model_mul_mod(fa, fb, plan), plan, lazy)


@pytest.mark.parametrize("bits,log_n", [(55, 4), (55, 6), (62, 8), (63, 8), (55, 11)])
def test_model_transforms_match_reference_and_jax(bits, log_n):
    """The plan's passes (lazy below 2^62, eager above, as lft64::lazy_ok
    picks) on random rows: forward, inverse and the product bit for bit
    against ntt64_ref / intt64_ref / negacyclic_mul64_ref and the JAX
    package's ntt / intt / negacyclic_mul."""
    n = 1 << log_n
    q = next(two_adic_primes(bits, 12))
    lazy = q < 1 << 62
    plan, jplan = ntt_plan(q, n), jntt.ntt_plan(q, n)
    rng = np.random.default_rng(bits + log_n)
    rows = 1 if log_n == 11 else 3
    a, b = (rng.integers(0, q, size=(rows, n), dtype=np.uint64) for _ in "ab")
    a[0, :2] = [0, q - 1]
    ta, tb = (torch.from_numpy(x.view(np.int64)) for x in (a, b))
    fwd = model_ntt(ta, plan, lazy)
    assert torch.equal(fwd, ntt64_ref(ta, plan))
    np.testing.assert_array_equal(fwd.numpy().view(np.uint64), np.asarray(jax.jit(jntt.ntt, static_argnums=1)(jnp.asarray(a), jplan)))
    inv = model_intt(ta, plan, lazy)
    assert torch.equal(inv, intt64_ref(ta, plan))
    np.testing.assert_array_equal(inv.numpy().view(np.uint64), np.asarray(jax.jit(jntt.intt, static_argnums=1)(jnp.asarray(a), jplan)))
    prod = model_polymul(ta, tb, plan, lazy)
    assert torch.equal(prod, negacyclic_mul64_ref(ta, tb, plan))
    jprod = jax.jit(jntt.negacyclic_mul, static_argnums=2)(jnp.asarray(a), jnp.asarray(b), jplan)
    np.testing.assert_array_equal(prod.numpy().view(np.uint64), np.asarray(jprod))


# -- K-EXTPROD64's digit rows in groups


def model_external_product(g, plan, a, b, ka, kb, group):
    """The external product as K-EXTPROD64 runs it: 2d digit rows (a's,
    then b's) `group` at a time; each row's transform, left below 4q (lazy),
    times the key rows, summed in 128 bits over the group (each sum below q
    2^64, checked); one REDC per group, the group residues added mod q;
    both inverse transforms."""
    q, rows = plan.q, 2 * g.d
    lazy = q < 1 << 62
    digits = torch.cat([decompose_zq(a, g), decompose_zq(b, g)]).movedim(0, 1)  # (B, 2d, N)
    res = [torch.zeros_like(a), torch.zeros_like(a)]
    for r0 in range(0, rows, group):
        gr = min(group, rows - r0)
        ev = model_ntt(digits[:, r0 : r0 + gr], plan, lazy, reduce=False)
        assert _below(ev, 4 * q if lazy else q)
        zero = torch.zeros_like(a)
        for o, key in enumerate((ka, kb)):
            hi, lo = zero, zero
            for r in range(gr):
                hi, lo = _mac128(hi, lo, ev[:, r], key[r0 + r])
            assert _below(hi, q), "a group's sum left the REDC bound"
            res[o] = _csub(res[o] + _redc(hi, lo, plan), q)
    return model_intt(res[0], plan, lazy), model_intt(res[1], plan, lazy)


@pytest.mark.parametrize("bits,log_n,log_b,d", [(54, 7, 6, 9), (62, 5, 40, 1)])
def test_extprod_groups_match_jax(bits, log_n, log_b, d):
    """The multi-key test fixture (54-bit q, N = 128, B = 2^6, d = 9: 18
    rows) in groups of 18 (what the kernel takes at N = 128), 5 (what it
    takes at N = 2048) and 4, and a 62-bit prime, whose groups hold one row
    (4q q must stay below q 2^64), bit for bit against the JAX package's
    u64 `rgsw.external_product`."""
    q = next(two_adic_primes(bits, log_n + 1))
    assert ext_group(11, 10, Q55) == 5
    groups = sorted({ext_group(log_n, 2 * d, q), 5, 4} if bits == 54 else {ext_group(log_n, 2 * d, q)})
    assert bits == 54 or groups == [1]
    params = jfhew.RgswParams(jfhew.RlweParams(q=q, p=4, log_n=log_n, log_b=log_b, d=d), log_b=log_b, d=d)
    n = 1 << log_n
    rng = np.random.default_rng(bits)
    a, b = (rng.integers(0, q, size=(2, n), dtype=np.uint64) for _ in "ab")
    a[0, :3], b[0, -2:] = [0, 1, q - 1], [q - 1, 0]
    ka, kb = (rng.integers(0, q, size=(2 * d, n), dtype=np.uint64) for _ in "ab")
    ka[0, :2] = q - 1
    ext = jax.jit(jrgsw.external_product, static_argnums=0)(
        params, jrgsw.RgswEval(jnp.asarray(ka), jnp.asarray(kb)), jrlwe.RlweCiphertext(jnp.asarray(a), jnp.asarray(b))
    )
    ta, tb, tka, tkb = (torch.from_numpy(x.view(np.int64)) for x in (a, b, ka, kb))
    for group in groups:
        got = model_external_product(Gadget(q, log_b, d), ntt_plan(q, n), ta, tb, tka, tkb, group)
        np.testing.assert_array_equal(torch.stack(got).numpy().view(np.uint64), np.stack([ext.a, ext.b]), err_msg=f"group {group}")


# -- K-NTT64 and intt64: the forward-only and inverse-only plans

NTT_THREADS, NTT_VALUES = 256, 2048  # a block's threads, and the values it owns (max(1, 2048 / N) rows)


def model_forward(x, plan, mont: bool) -> torch.Tensor:
    """K-NTT64 as `rows::forward` runs it: the head passes (the first reads
    device memory) and the last pass, whose item's values go to device
    memory: canonical (the lazy values below 4q by two minimums), or with
    mont, one Shoup product by r1 = 2^64 mod q taken on those values
    unreduced (exact for any input below 2^64 when q < 2^63)."""
    q, lazy = plan.q, plan.q < 1 << 62
    v = x
    for l0, w in plan_of(plan.log_n):
        v = model_pass(v, plan, l0, w, False, lazy)
    if mont:
        return _csub(_shoup_lazy(v, plan.zq.r1, as_i64(plan.r1_shoup), q), q)
    return _csub(_csub(v, 2 * q), q) if lazy else v


def model_inverse(x, plan) -> torch.Tensor:
    """intt64 as `rows::inverse` runs it: the last pass's layers first, on
    items of consecutive values read from device memory, then the head
    passes backwards, the last scaled by 1/N into device memory."""
    return model_intt(x, plan, plan.q < 1 << 62)


@pytest.mark.parametrize("log_n", [1, 2, 3, 4, 8, 11])
def test_ntt64_blocks_take_every_value_once_in_aligned_items(log_n):
    """A K-NTT64 / intt64 block (256 threads, max(1, 2048 / N) rows, the
    last of them ragged): every pass takes each (row, item) once, the
    device-memory pass (the forward's last, the inverse's first; the only
    one at N <= 4) reads or writes only the real rows, each value once, in
    items of 2 or 4 consecutive values that start on a 16-byte boundary of
    a 16-byte aligned operand."""
    n, per = 1 << log_n, max(1, NTT_VALUES >> log_n)
    have = per - 1 if per > 1 else 1
    plan = plan_of(log_n)
    for l0, w in plan:
        taken = [x for v in visits(NTT_THREADS, per, log_n - w) for x in v]
        assert sorted(taken) == [(i, r) for i in range(n >> w) for r in range(per)]
    l0, w = plan[-1]
    assert l0 + w == log_n and w in (1, 2)
    words = []
    for i, row in (x for v in visits(NTT_THREADS, per, log_n - w) for x in v):
        cols = item_cols(i, log_n, l0, w)
        assert cols == list(range(cols[0], cols[0] + (1 << w))) and at(row, cols[0], log_n) % 2 == 0
        if row < have:
            words += [at(row, c, log_n) for c in cols]
    assert sorted(words) == list(range(have * n))


def test_montgomery_output_is_exact_for_any_u64():
    """The Shoup product by r1 = 2^64 mod q gives x 2^64 mod q for any u64
    x, at a 55-bit and a 63-bit prime: the lazy values (below 4q) need no
    reduction before it."""
    rng = np.random.default_rng(64)
    for bits in (55, 63):
        q = next(two_adic_primes(bits, 12))
        plan = ntt_plan(q, 8)
        xs = [0, 1, q - 1, q, 2 * q + 1, 4 * q - 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
        xs = [v for v in xs if v < 1 << 64] + [int(v) for v in rng.integers(0, 1 << 63, size=64, dtype=np.uint64)]
        t = torch.tensor([as_i64(v) for v in xs])
        got = _csub(_shoup_lazy(t, plan.zq.r1, as_i64(plan.r1_shoup), q), q)
        assert [v % (1 << 64) for v in got.tolist()] == [(v << 64) % q for v in xs]


@pytest.mark.parametrize("bits,log_n", [(55, 1), (55, 2), (55, 4), (55, 6), (62, 8), (63, 8), (55, 11)])
def test_forward_and_inverse_plans_match_reference_and_jax(bits, log_n):
    """K-NTT64's forward plan (canonical and Montgomery outputs) and intt64's
    inverse plan on random rows with 0 and q - 1 in them, lazy below 2^62
    and eager above: bit for bit against ntt64_ref, to_montgomery(ntt64_ref),
    ntt64_mont_ref, intt64_ref and the JAX package's jitted
    `rlwe._to_eval_mont` and `ntt.intt`."""
    n = 1 << log_n
    q = next(two_adic_primes(bits, 12))
    plan, jplan = ntt_plan(q, n), jntt.ntt_plan(q, n)
    rng = np.random.default_rng(bits * 16 + log_n)
    x = rng.integers(0, q, size=(3, n), dtype=np.uint64)
    x[0, :2], x[-1, -1] = [0, q - 1], q - 1
    tx = torch.from_numpy(x.view(np.int64))
    fwd, mont = model_forward(tx, plan, False), model_forward(tx, plan, True)
    assert torch.equal(fwd, ntt64_ref(tx, plan))
    assert torch.equal(mont, to_montgomery(ntt64_ref(tx, plan), plan.zq))
    assert torch.equal(mont, ntt64_mont_ref(tx, plan))
    jmont = jrlwe._to_eval_mont(jrlwe_params(q, log_n), jnp.asarray(x))
    np.testing.assert_array_equal(mont.numpy().view(np.uint64), np.asarray(jmont))
    inv = model_inverse(tx, plan)
    assert torch.equal(inv, intt64_ref(tx, plan))
    np.testing.assert_array_equal(inv.numpy().view(np.uint64), np.asarray(jax.jit(jntt.intt, static_argnums=1)(jnp.asarray(x), jplan)))


def jrlwe_params(q: int, log_n: int, log_b: int = 11, d: int = 5):
    return jfhew.RlweParams(q=q, p=4, log_n=log_n, log_b=log_b, d=d)


def test_cpu_to_eval_matches_jax():
    """The port's `rgsw.to_eval` and `rlwe._to_eval_mont` on CPU tensors (the
    plain version of K-NTT64's Montgomery instance) against the JAX
    package's jitted ones at a small ring of the 55-bit prime, and K-NTT64's
    modelled Montgomery plan against both."""
    q, log_n, log_b, d = Q55, 5, 11, 5
    n = 1 << log_n
    rng = np.random.default_rng(5)
    a, b = (rng.integers(0, q, size=(2, 2 * d, n), dtype=np.uint64) for _ in "ab")
    a[0, 0, :2] = [0, q - 1]
    jparams = jfhew.RgswParams(jrlwe_params(q, log_n, log_b, d), log_b=log_b, d=d)
    tparams = tfhew.RgswParams(tfhew.RlweParams(q=q, p=4, log_n=log_n, log_b=log_b, d=d), log_b=log_b, d=d)
    want = jrgsw.to_eval(jparams, jrgsw.RgswCiphertext(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = (torch.from_numpy(v.view(np.int64)) for v in (a, b))
    got = tfhew.rgsw.to_eval(tparams, tfhew.rgsw.RgswCiphertext(ta, tb))
    for g, w in ((got.a, want.a), (got.b, want.b)):
        np.testing.assert_array_equal(g.numpy().view(np.uint64), np.asarray(w))
    assert torch.equal(got.a, model_forward(ta, tparams.plan, True))
    row = jrlwe._to_eval_mont(jparams.rlwe, jnp.asarray(a[1]))
    np.testing.assert_array_equal(tfhew.rlwe._to_eval_mont(tparams.rlwe, ta[1]).numpy().view(np.uint64), np.asarray(row))
