"""A model of the redesigned K-RNS-NTT and K-BASECONV
(`learn_fhe_tpu_torch/csrc/rns64.cu`), held against the port's plain
versions and the JAX package on the CPU.

The kernels run only on a CUDA device, so this models in Python what they
do. K-RNS-MAC inside the inverse (`rns_intt_mac`): output row r of S R rows
(S sums, R x rows) is sum r / R of x row r mod R against y or z row
(r mod R) mod y_rows, the blocks taking the two sums of an x row back to
back; the inverse's first pass builds each 4-value item from the terms'
16-byte words (128-bit sums, one REDC per chunk of terms), and the final
scale by N^-1 2^64 in place of 1/N takes out the REDCs' 2^-64. K-RNS-NTT:
from N = 2048 up a row runs on a cluster of C blocks of 256 threads, C = 2
up to N = 2^13 and 2^(log N - 13) past it (2, 4, 8 at 2^14, 2^15, 2^16:
each block then holds 2^13 values); at 2^14 a launch whose rows the card
holds at once takes the wide instance, 512 threads a block on the same
sub-rows, its buffer columns swizzled; the first pass's 3 layers leave 8
sub-rows of N/8 values, block c takes items [c N/(8C), (c+1) N/(8C)) of
that pass and writes output m of item i into the buffer of the block that
holds sub-row m (8/C a block, at column i of it), then each block runs the
head passes from layer 3 and the last pass of 2 layers on its sub-rows
alone; the inverse the other way round, scaled by 1/N in the first pass.
Below N = 2048 a block of 128 threads takes one row through the row passes
of `u64_rows.cuh`. Each row r is under limb r mod L. The tests check which
block and thread take which item of which pass (every value once, the
reference's butterflies and twiddles) at N = 2..2^16, the arithmetic of both plans with per-row limb tables and
Harvey's lazy ranges at N <= 256, and K-BASECONV's sum (128-bit products,
one REDC per chunk of terms, Montgomery tables made from the Shoup duals,
-p^-1 by Newton's iteration) in Python integers.
"""

from collections import defaultdict

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.ops import rns as JR  # noqa: E402
from learn_fhe_tpu_torch.ops import rns as TR  # noqa: E402
from learn_fhe_tpu_torch.ops.modular import mulhi64  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u64, u64_to_torch  # noqa: E402
from learn_fhe_tpu_torch.utils.primes import two_adic_primes  # noqa: E402
from tests.test_torch_u64_rows_model import head_passes, head_width, item_cols, plan_of, visits  # noqa: E402

CPU = torch.device("cpu")
SIGN = -(1 << 63)

# the launch shapes, as rns64.cu has them
THREADS = 256  # a cluster's block
ROW_THREADS = 128  # a row's block below SPLIT_LOG_N
SPLIT_LOG_N = 11  # from N = 2048 up a row runs on a cluster
SPLIT = 3  # the first pass's layers
SUBS = 1 << SPLIT
CLUSTER = 2  # blocks per row up to FIXED_LOG_N
PER_BLOCK = SUBS // CLUSTER
FIXED_LOG_N = 13  # past it the cluster grows with the ring
MAX_LOG_N = 16


WIDE_LOG_N, WIDE_THREADS = 14, 512  # rns64.cu's wide instances: their ring and block


def shape(log_n: int, wide: bool = False) -> tuple[int, int]:
    """(blocks a row, threads a block) of the cluster instance (`rns64.cu::RowShape`)."""
    return (1 << (log_n - FIXED_LOG_N) if log_n > FIXED_LOG_N else CLUSTER), (WIDE_THREADS if wide else THREADS)


def cluster(log_n: int) -> int:
    """Blocks per row."""
    return shape(log_n)[0]


def swz(col: int, wide: bool) -> int:
    """A buffer column's place in shared memory (`rns64.cu::swz`): in a wide
    instance bits 2-3 XORed with bits 5-6."""
    return col ^ (((col >> 5) & 3) << 2) if wide else col


def _primes(bits: int, log_n: int, count: int) -> tuple[int, ...]:
    it = two_adic_primes(bits, log_n + 1)
    return tuple(next(it) for _ in range(count))


# -- the split plan: which block and thread take which item of each pass


def split_items(log_n: int, wide: bool = False) -> dict[tuple[int, int], list[int]]:
    """The first pass: block c's thread t takes items c share + k, k = t, t
    + T, ... below share = 2^log_s / C; item i holds the values i + m
    2^log_s, m < 8."""
    c_n, threads = shape(log_n, wide)
    share = (1 << (log_n - SPLIT)) // c_n
    return {(c, t): [c * share + k for k in range(t, share, threads)] for c in range(c_n) for t in range(threads)}


def sub_items(log_n: int, l0: int, w: int, wide: bool = False) -> dict[tuple[int, int], list[tuple[int, int, int]]]:
    """A pass of w layers from l0 >= 3 on the blocks' sub-rows, as
    `sub_pass` deals it: block c's thread t takes k = t, t + T, ... of its
    8/C sub-rows' items; (buffer column, global column, twiddle group) of
    each item."""
    log_s, log_h = log_n - SPLIT, log_n - l0 - w
    log_items = log_s - w
    c_n, threads = shape(log_n, wide)
    per = SUBS // c_n
    out = {}
    for c in range(c_n):
        sub0 = c * per
        for t in range(threads):
            got = []
            for k in range(t, per << log_items, threads):
                s, i = k >> log_items, k & ((1 << log_items) - 1)
                g = i >> log_h
                col = (s << log_s) + (g << (log_n - l0)) + (i & ((1 << log_h) - 1))
                got.append((col, (sub0 << log_s) + col, ((sub0 + s) << (l0 - SPLIT)) + g))
            out[c, t] = got
    return out


def split_plan(log_n: int) -> list[tuple[int, int]]:
    """(l0, w) of the passes after the first: the head passes from layer 3,
    then the last pass of 2 layers."""
    return [(3 * p, head_width(log_n, p)) for p in range(1, head_passes(log_n))] + [(log_n - 2, 2)]


def split_passes(log_n: int, wide: bool = False) -> list[tuple[int, int, list[list[int]], list[int]]]:
    """Every pass of the split plan in forward order: (l0, w, the global
    columns of each item, each item's twiddle group), over all blocks and
    threads."""
    log_s = log_n - SPLIT
    items = [i for v in split_items(log_n, wide).values() for i in v]
    out = [(0, SPLIT, [[i + (m << log_s) for m in range(SUBS)] for i in items], [0] * len(items))]
    for l0, w in split_plan(log_n):
        log_h = log_n - l0 - w
        taken = [x for v in sub_items(log_n, l0, w, wide).values() for x in v]
        out.append((l0, w, [[gcol + (m << log_h) for m in range(1 << w)] for _, gcol, _ in taken], [g for *_, g in taken]))
    return out


def rows_passes(log_n: int) -> list[tuple[int, int, list[list[int]], list[int]]]:
    """Below N = 2048 a block of ROW_THREADS threads takes one row through
    the passes of `rows::forward` (one row: every item a thread covers)."""
    out = []
    for l0, w in plan_of(log_n):
        taken = [i for v in visits(ROW_THREADS, 1, log_n - w) for i, _ in v]
        out.append((l0, w, [item_cols(i, log_n, l0, w) for i in taken], [i >> (log_n - l0 - w) for i in taken]))
    return out


def plan_passes(log_n: int, split: bool, wide: bool = False) -> list:
    return split_passes(log_n, wide) if split else rows_passes(log_n)


def _check_butterflies(passes, log_n: int) -> None:
    """Each pass takes every value once, and its layers pair exactly the
    reference's values with its twiddle index 2^L + g."""
    n, seen, layers = 1 << log_n, defaultdict(list), 0
    for l0, w, cols, groups in passes:
        assert sorted(c for item in cols for c in item) == list(range(n)), f"pass at l0 = {l0}"
        for item, g in zip(cols, groups):
            for t in range(w):
                half = 1 << (w - 1 - t)
                for u in range(1 << t):
                    for j in range(half):
                        a = 2 * half * u + j
                        seen[l0 + t].append(((item[a], item[a + half]), (1 << (l0 + t)) + (g << t) + u))
        layers += w
    assert layers == log_n
    for layer, pairs in seen.items():
        h = n >> (layer + 1)
        want = sorted(((g * 2 * h + j, g * 2 * h + h + j), (1 << layer) + g) for g in range(1 << layer) for j in range(h))
        assert sorted(pairs) == want, f"layer {layer}"


@pytest.mark.parametrize("log_n", range(SPLIT_LOG_N, MAX_LOG_N + 1))
def test_cluster_plan_takes_every_value_once_with_the_reference_twiddles(log_n):
    """At N = 2^11 .. 2^16 (clusters of 2 blocks of 256 threads up to 2^13,
    then 2, 4 and 8 of 2^13 values each; at 2^14 also the wide instance's
    blocks of 512 threads): every pass of the cluster's plan takes each value once,
    with the reference's butterflies and twiddles; in the first pass each
    (block, thread) takes its own items and every block's buffer gets each
    of its sub-rows' columns once, from the block that ran its item; in the
    others a block's items fall in its own sub-rows, each (block, item)
    taken by one thread; the last pass's items are 4 consecutive values on
    a 16-byte boundary; each block's buffer fits its shared memory (the
    static 32 KB up to 2^13, the dynamic 64 KB past it), and the items a
    thread takes in the first pass and in the last are the instance's
    unrolled counts (RowShape's kAheadSplit and kAheadItems)."""
    for wide in (False, True) if log_n == WIDE_LOG_N else (False,):
        _check_butterflies(split_passes(log_n, wide), log_n)
        log_s, (c_n, threads) = log_n - SPLIT, shape(log_n, wide)
        per = SUBS // c_n
        assert (per << log_s) * 8 <= (64 if log_n > FIXED_LOG_N else 32) * 1024
        buffers = defaultdict(list)
        for (c, _), items in split_items(log_n, wide).items():
            for i in items:
                for m in range(SUBS):
                    buffers[m // per].append(((m % per) << log_s) + i)
        assert sorted(buffers) == list(range(c_n))
        assert all(sorted(v) == list(range(per << log_s)) for v in buffers.values())
        for l0, w in split_plan(log_n):
            for (c, _), got in sub_items(log_n, l0, w, wide).items():
                for col, gcol, _ in got:
                    assert col < per << log_s and gcol >> log_s in range(c * per, (c + 1) * per)
        last = sub_items(log_n, log_n - 2, 2, wide)
        for got in last.values():
            assert all(col % 4 == 0 and gcol % 4 == 0 for col, gcol, _ in got)
        if log_n >= FIXED_LOG_N:  # every thread the same count
            ahead_split = (1 << log_s) // c_n // threads if log_n > FIXED_LOG_N else 2
            ahead_items = (per << (log_s - 2)) // threads if log_n > FIXED_LOG_N else 4
            assert ahead_split >= 1 and ahead_items >= 1
            assert {len(v) for v in split_items(log_n, wide).values()} == {ahead_split}
            assert {len(v) for v in last.values()} == {ahead_items}


def _wavefronts(cols: list[int], words: int) -> int:
    """Shared-memory wavefronts of a warp's access of `words` u64 at each of
    its threads' columns (32 banks of 4 bytes): each 128-byte line a
    wavefront takes serves one address a bank."""
    banks = defaultdict(set)
    for c in cols:
        for w in range(words):
            for b in (2 * (c + w), 2 * (c + w) + 1):
                banks[b % 32].add(b // 32)
    return max(len(v) for v in banks.values())


@pytest.mark.parametrize("wide", [False, True])
def test_wide_swizzle_spreads_every_pass_over_the_banks(wide):
    """At 2^14 the swizzle maps each block's buffer onto itself, and every
    warp access of every pass (the head passes' values m of an item, the last
    pass's 16-byte words, the first pass's columns through the cluster)
    takes the fewest wavefronts: 2 for 8-byte accesses, 8 for the last
    pass's 32 bytes a thread. Unswizzled, the head pass from layer 9 (groups
    of 4 columns 32 apart) takes 8 a value (4 addresses to a bank in each
    half-warp); swizzled, 2."""
    log_n = WIDE_LOG_N
    log_s, (c_n, threads) = log_n - SPLIT, shape(log_n, wide)
    per = SUBS // c_n
    assert sorted(swz(c, wide) for c in range(per << log_s)) == list(range(per << log_s))
    worst = {}
    for l0, w in split_plan(log_n):
        taken = sub_items(log_n, l0, w, wide)
        log_h = log_n - l0 - w
        for (c, t0), _ in taken.items():
            if t0 % 32:
                continue
            warp = [taken[c, t] for t in range(t0, t0 + 32)]
            for a in range(len(warp[0])):
                cols = [items[a][0] for items in warp if a < len(items)]
                if log_h == 0:  # 4 consecutive values, two 16-byte words
                    worst[l0] = max(worst.get(l0, 0), _wavefronts([swz(col, wide) for col in cols], 4))
                else:
                    for m in range(1 << w):
                        got = _wavefronts([swz(col + (m << log_h), wide) for col in cols], 1)
                        worst[l0] = max(worst.get(l0, 0), got)
    for (c, t0), items in split_items(log_n, wide).items():
        if t0 % 32 == 0:
            for a in range(len(items)):
                cols = [split_items(log_n, wide)[c, t][a] for t in range(t0, t0 + 32)]
                worst[0] = max(worst.get(0, 0), _wavefronts([swz(i, wide) for i in cols], 1))
    want = {0: 2, 3: 2, 6: 2, 9: 2 if wide else 8, 12: 8}
    assert worst == want


@pytest.mark.parametrize("log_n", range(1, SPLIT_LOG_N))
def test_row_plan_takes_every_value_once_with_the_reference_twiddles(log_n):
    """Below N = 2048 (one row a block of 128 threads): every pass takes each
    value once with the reference's butterflies and twiddles."""
    _check_butterflies(rows_passes(log_n), log_n)


# -- the arithmetic: the plans' passes on values, each row under its limb's tables


def _ult(a, b) -> torch.Tensor:
    return (a ^ SIGN) < (b ^ SIGN)


def _csub(s, m) -> torch.Tensor:
    t = s - m
    return torch.where(_ult(t, s), t, s)


def _shoup_lazy(a, w, ws, q) -> torch.Tensor:
    return a * w - mulhi64(a, ws) * q


def _radix(x: list, w: list, ws: list, q, width: int, inverse: bool, lazy: bool) -> None:
    """fwd_radix / inv_radix of u64.cuh on the item values x (in place), the
    lazy ranges checked after each layer."""
    for t in reversed(range(width)) if inverse else range(width):
        half = 1 << (width - 1 - t)
        for u in range(1 << t):
            wt, wst = w[(1 << t) - 1 + u], ws[(1 << t) - 1 + u]
            for j in range(half):
                a = 2 * half * u + j
                x0, x1 = x[a], x[a + half]
                if inverse and lazy:
                    x[a], x[a + half] = _csub(x0 + x1, 2 * q), _shoup_lazy(x0 - x1 + 2 * q, wt, wst, q)
                elif inverse:
                    d = x0 - x1
                    x[a], x[a + half] = _csub(x0 + x1, q), _csub(_shoup_lazy(torch.where(_ult(x0, x1), d + q, d), wt, wst, q), q)
                elif lazy:
                    y0, y1 = _csub(x0, 2 * q), _shoup_lazy(x1, wt, wst, q)
                    x[a], x[a + half] = y0 + y1, y0 - y1 + 2 * q
                else:
                    y1 = _csub(_shoup_lazy(x1, wt, wst, q), q)
                    d = x0 - y1
                    x[a], x[a + half] = _csub(x0 + y1, q), torch.where(_ult(x0, y1), d + q, d)
        bound = ((2 if inverse else 4) if lazy else 1) * q
        assert all(bool(_ult(v, bound.expand_as(v)).all()) for v in x), "a value left its lazy range"


def model_transform(x: torch.Tensor, plan: TR.RnsPlan, inverse: bool, split: bool, scale=None) -> torch.Tensor:
    """K-RNS-NTT on rows x (R, N), row r under limb r mod L: the plan's
    passes (the inverse's in reverse order, each inverse), on the columns
    and twiddle groups the kernel computes for each item; the inverse scaled
    by 1/N, or by scale (per-limb (L, 1) value and Shoup dual)."""
    rows = x.shape[0]
    t = TR.rns_tables(plan, CPU)
    limb = torch.arange(rows) % len(plan.qs)
    q = t.q[limb]  # (R, 1)
    tab, tab_s = (t.psi_inv[limb], t.psi_inv_s[limb]) if inverse else (t.psi[limb], t.psi_s[limb])
    lazy = max(plan.qs) < 1 << 62
    v = x.clone()
    passes = plan_passes(plan.log_n, split)
    for l0, w, cols, groups in reversed(passes) if inverse else passes:
        cols, groups = torch.tensor(cols), torch.tensor(groups)
        vals = [v[:, cols[:, m]] for m in range(1 << w)]
        idx = [(((1 << (l0 + tt)) + (groups << tt)) + u) for tt in range(w) for u in range(1 << tt)]
        _radix(vals, [tab[:, i] for i in idx], [tab_s[:, i] for i in idx], q, w, inverse, lazy)
        for m in range(1 << w):
            v[:, cols[:, m]] = vals[m]
    if inverse:
        w, ws = (t.n_inv, t.n_inv_s) if scale is None else scale
        return _csub(_shoup_lazy(v, w[limb], ws[limb], q), q)
    return _csub(_csub(v, 2 * q), q) if lazy else v


@pytest.mark.parametrize(
    "bits,log_n,limbs,lead",
    [(55, 1, 3, 2), (55, 2, 8, 1), (55, 3, 1, 3), (55, 5, 3, 2), (55, 6, 8, 1), (55, 8, 3, 3), (63, 5, 3, 1), (63, 8, 2, 2), (62, 7, 3, 1)],
)
def test_model_transforms_match_reference_and_jax(bits, log_n, limbs, lead):
    """Both plans (the cluster's, modelled here at small rings too, and the
    row plan) on (lead, L, N) rows holding 0 and q - 1, lazy below 2^62 and
    eager above: forward and inverse bit for bit against rns_ntt_ref /
    rns_intt_ref and the JAX package's rns_ntt / rns_intt, every row under
    its own limb's tables."""
    n = 1 << log_n
    qs = _primes(bits, log_n, limbs)
    rng = np.random.default_rng(bits * 100 + log_n * 10 + limbs)
    x = np.stack([rng.integers(0, q, size=(lead, n), dtype=np.uint64) for q in qs], axis=-2)
    x[0, 0, 0], x[-1, -1, -1] = 0, qs[-1] - 1
    tx = u64_to_torch(x)
    plan, jplan = TR.rns_plan(qs, n), JR.rns_plan(qs, n)
    want_f, want_i = TR.rns_ntt_ref(tx, plan), TR.rns_intt_ref(tx, plan)
    np.testing.assert_array_equal(torch_to_u64(want_f), np.asarray(JR.rns_ntt(jnp.asarray(x), jplan)))
    np.testing.assert_array_equal(torch_to_u64(want_i), np.asarray(JR.rns_intt(jnp.asarray(x), jplan)))
    rows = tx.reshape(-1, n)
    for split in (False, True) if log_n >= 6 else (False,):  # the cluster plan needs 8 first-pass items
        assert torch.equal(model_transform(rows, plan, False, split).reshape(tx.shape), want_f), f"forward, split {split}"
        assert torch.equal(model_transform(rows, plan, True, split).reshape(tx.shape), want_i), f"inverse, split {split}"


@pytest.mark.parametrize("log_n", [14, 16])
def test_model_transforms_past_2_13_match_reference(log_n):
    """The cluster's plan past 2^13 (2 and 8 blocks of 2^13 values) on 2 rows
    of 52- and 59-bit primes (the production ladder's; lazy): forward and
    inverse bit for bit against rns_ntt_ref / rns_intt_ref (which
    `tests/test_torch_rns.py` holds against the JAX package at these rings),
    the fused inverse's rescale by N^-1 2^64 too."""
    n = 1 << log_n
    qs = (_primes(52, log_n, 1)[0], _primes(59, log_n, 1)[0])
    rng = np.random.default_rng(log_n + 59)
    x = u64_to_torch(np.stack([rng.integers(0, q, size=(1, n), dtype=np.uint64) for q in qs], axis=-2)).reshape(-1, n)
    x[0, 0], x[-1, -1] = 0, qs[-1] - 1
    plan = TR.rns_plan(qs, n)
    assert torch.equal(model_transform(x, plan, False, True), TR.rns_ntt_ref(x, plan))
    assert torch.equal(model_transform(x, plan, True, True), TR.rns_intt_ref(x, plan))


# -- K-BASECONV: the chunked 128-bit sum with one REDC per chunk, in Python integers


def neg_inv64(p: int) -> int:
    """The kernel's -p^-1 mod 2^64: p is its own inverse to 3 bits, five
    Newton steps."""
    inv = p
    for _ in range(5):
        inv = inv * (2 - p * inv) % (1 << 64)
    return -inv % (1 << 64)


def redc(t: int, p: int, nqi: int) -> int:
    """lft64::redc on t = hi 2^64 + lo < p 2^64."""
    assert t < p << 64, "a chunk's sum left the REDC bound"
    hi, lo = t >> 64, t & ((1 << 64) - 1)
    k = lo * nqi % (1 << 64)
    s = hi + ((k * p) >> 64) + (lo != 0)
    return s - p if s >= p else s


def model_base_convert(x: np.ndarray, qs, ps, add=None) -> np.ndarray:
    """K-BASECONV on x (B, Lq, N): v_k (the Shoup product's exact value), u
    from the f64 sum the kernel makes (`overflow_sums`, rint), then per
    output limb the sum of v_k w'_jk over chunks of terms below p 2^64, one
    REDC each, w'_jk = -(ws_jk p_j) mod 2^64, the chunks added mod p_j, less
    u Q mod p_j."""
    bp = TR.base_extend_plan(qs, ps)
    chunk = min(((1 << 64) - 1) // max(qs), len(qs))
    b_, lq, n = x.shape
    xs = [[[int(x[b, k, j]) for j in range(n)] for k in range(lq)] for b in range(b_)]
    if add is not None:
        xs = [[[(v + add[k]) % qs[k] for v in row] for k, row in enumerate(blk)] for blk in xs]
    v = [[[val * int(bp.q_hats_inv[k]) % qs[k] for val in row] for k, row in enumerate(blk)] for blk in xs]
    u = torch.round(TR.overflow_sums(u64_to_torch(np.array(v, dtype=np.uint64)), qs)).long()
    out = np.zeros((b_, len(ps), n), dtype=np.uint64)
    for j, p in enumerate(ps):
        wm = [(-int(bp.q_hats_ps_shoup[j, k]) * p) % (1 << 64) for k in range(lq)]
        assert wm == [(int(bp.q_hats_ps[j, k]) << 64) % p for k in range(lq)]
        nqi = neg_inv64(p)
        assert nqi * p % (1 << 64) == (1 << 64) - 1
        for b in range(b_):
            for c in range(n):
                s = 0
                for k0 in range(0, lq, chunk):
                    s = (s + redc(sum(v[b][k][c] * wm[k] for k in range(k0, min(lq, k0 + chunk))), p, nqi)) % p
                out[b, j, c] = (s - int(bp.uq_ps_t[int(u[b, c]), j])) % p
    return out


@pytest.mark.parametrize(
    "lq,lp,bits,with_add",
    [(1, 3, 55, False), (8, 8, 55, False), (8, 8, 55, True), (23, 4, 55, False), (64, 3, 55, True), (6, 3, 62, False), (6, 3, 62, True)],
)
def test_base_convert_chunked_sum_matches_reference_and_jax(lq, lp, bits, with_add):
    """The kernel's sum against base_convert_ref and the JAX package's
    extend_bases: lq = 1, 8, 23 and 64 input limbs of 55 bits (one chunk),
    and 62-bit input primes, whose chunks hold 4 terms; with and without a
    constant added mod q_i first (the rescale's P/2), on inputs holding 0
    and q - 1."""
    primes = _primes(bits, 4, lq) + _primes(55, 5, lp) if bits != 55 else _primes(55, 4, lq + lp)
    qs, ps = primes[:lq], primes[lq:]
    assert bits != 62 or ((1 << 64) - 1) // max(qs) == 4
    rng = np.random.default_rng(lq * 10 + lp + bits + with_add)
    n = 16
    x = np.stack([rng.integers(0, q, size=(2, n), dtype=np.uint64) for q in qs], axis=-2)
    x[0, :, 0], x[1, :, 1] = 0, np.array(qs, dtype=np.uint64) - 1
    add = tuple(int(q) // 2 + k for k, q in enumerate(qs)) if with_add else None
    got = model_base_convert(x, qs, ps, add)
    np.testing.assert_array_equal(got, torch_to_u64(TR.base_convert_ref(u64_to_torch(x), qs, ps, add)))
    xa = x if add is None else (x.astype(object) + np.array(add, dtype=object)[:, None]) % np.array(qs, dtype=object)[:, None]
    np.testing.assert_array_equal(got, np.asarray(JR.extend_bases(jnp.asarray(xa.astype(np.uint64)), qs, ps)))


# -- K-RNS-MAC inside the inverse: the row mapping, the MAC source's loads, the rescaled 1/N


def mac_out_row(sums: int, rows: int, g: int) -> int:
    """The output row of a launch's g-th cluster (or block): with two sums,
    the two of x row g / 2 one after the other."""
    return (g & 1) * rows + (g >> 1) if sums == 2 else g


def mac_row(rows: int, limbs: int, y_rows: int, r: int) -> tuple[int, int, int, int]:
    """(sum, x row, limb, y or z row) of output row r, as `mac_row` makes
    them once a block: the key row is the x row, or its limb where the key
    is broadcast."""
    s = int(r >= rows)
    xrow = r - s * rows
    limb = xrow % limbs
    return s, xrow, limb, xrow if y_rows == rows else limb


@pytest.mark.parametrize(
    "limbs,lead,sums,broadcast", [(8, 16, 1, False), (8, 16, 2, True), (16, 16, 2, True), (3, 5, 2, False), (1, 1, 1, True), (19, 27, 2, True)]
)
def test_mac_rows_take_each_output_row_once(limbs, lead, sums, broadcast):
    """The launch's clusters take every output row once; row r is sum r / R
    of x row r mod R under limb r mod L (its transform's tables) against
    key row (r mod R) mod y_rows; with two sums, cluster g takes x row g / 2."""
    rows = limbs * lead
    y_rows = limbs if broadcast else rows
    order = [mac_out_row(sums, rows, g) for g in range(sums * rows)]
    assert sorted(order) == list(range(sums * rows))
    for g, r in enumerate(order):
        s, xrow, limb, yrow = mac_row(rows, limbs, y_rows, r)
        assert (s, xrow, yrow) == (r // rows, r % rows, (r % rows) % y_rows)
        assert limb == r % limbs
        assert sums == 1 or xrow == g // 2


def mac_loads(log_n: int) -> list[tuple[int, int]]:
    """Every load of the fused inverse's first pass for one output row and
    one term: (column of the row, values), each a 16-byte aligned word run
    of an item. From N = 2048 the cluster's blocks take the last pass's
    items of their sub-rows (`sub_items`) at the block's offset; below, a
    block of ROW_THREADS takes the row's items through `rows::pass`."""
    if log_n >= SPLIT_LOG_N:
        return [(gcol, 4) for got in sub_items(log_n, log_n - 2, 2).values() for _, gcol, _ in got]
    l0, w = plan_of(log_n)[-1]
    return [(item_cols(i, log_n, l0, w)[0], 1 << w) for v in visits(ROW_THREADS, 1, log_n - w) for i, _ in v]


@pytest.mark.parametrize("log_n", range(1, MAX_LOG_N + 1))
def test_mac_source_gives_each_first_pass_value_once(log_n):
    """Each value of an output row's first inverse pass is built once, from
    one load of each term's x and y at the same column, in 16-byte words
    (2 or 4 consecutive values at a multiple of their count)."""
    loads = mac_loads(log_n)
    cols = sorted(c + j for c, v in loads for j in range(v))
    assert cols == list(range(1 << log_n))
    assert all(v in (2, 4) and c % v == 0 for c, v in loads)


def model_mac_sums(xs, ws, qs, rows: int, y_rows: int, sums: int, chunk: int) -> torch.Tensor:
    """The first pass's values of every output row, as `mac_item` makes them
    in Python integers: per term the product of canonical residues, summed
    over chunks of `chunk` terms below q 2^64, one REDC a chunk (each leaves
    2^-64), the chunks' residues added mod q. xs: per term (R, N) rows; ws:
    per sum, per term (y_rows, N) rows."""
    limbs = len(qs)
    n = len(xs[0][0])
    out = np.zeros((sums * rows, n), dtype=np.uint64)
    for r in range(sums * rows):
        s, xrow, limb, yrow = mac_row(rows, limbs, y_rows, r)
        q = qs[limb]
        nqi = neg_inv64(q)
        for c in range(n):
            v = 0
            for k0 in range(0, len(xs), chunk):
                t = sum(int(xs[k][xrow][c]) * int(ws[s][k][yrow][c]) for k in range(k0, min(len(xs), k0 + chunk)))
                v = (v + redc(t, q, nqi)) % q
            out[r, c] = v
    return u64_to_torch(out)


@pytest.mark.parametrize(
    "bits,log_n,limbs,lead,terms,sums,broadcast",
    [(55, 6, 3, 2, 1, 2, True), (55, 8, 2, 2, 2, 1, False), (62, 6, 2, 2, 9, 2, True), (63, 7, 2, 1, 3, 1, False), (55, 3, 3, 1, 3, 2, False)],
)
def test_mac_sums_with_rescaled_inverse_match_reference_and_jax(bits, log_n, limbs, lead, terms, sums, broadcast):
    """The fused plan's values: the sums times 2^-64 (a 62-bit prime's
    chunk holds 4 products, so 9 terms take 3 REDCs; a 63-bit one's 2), run
    through the inverse passes with N^-1 2^64 in place of 1/N, equal
    rns_intt_mac_ref, rns_intt_ref(rns_mac_ref(..)), and the JAX package's
    rns_intt of rns_mul_eval sums (of _ks_dot where the key is broadcast)."""
    n = 1 << log_n
    qs = _primes(bits, log_n, limbs)
    plan, jplan = TR.rns_plan(qs, n), JR.rns_plan(qs, n)
    chunk = TR._mac_chunk(qs)
    assert bits != 62 or chunk == 4
    rng = np.random.default_rng(bits + log_n + terms)
    res = lambda lead_: np.stack([rng.integers(0, q, size=(*lead_, n), dtype=np.uint64) for q in qs], axis=-2)  # noqa: E731
    w_lead = () if broadcast else (lead,)
    xs = [res((lead,)) for _ in range(terms)]
    ws = [[res(w_lead) for _ in range(terms)] for _ in range(sums)]
    xs[0][0, 0, 0], ws[0][-1].reshape(-1)[-1] = 0, qs[-1] - 1
    rows, y_rows = lead * limbs, limbs if broadcast else lead * limbs
    v = model_mac_sums([x.reshape(rows, n) for x in xs], [[w.reshape(y_rows, n) for w in wk] for wk in ws], qs, rows, y_rows, sums, chunk)
    t = TR.rns_tables(plan, CPU)
    tx = [u64_to_torch(x) for x in xs]
    ty = [u64_to_torch(w) for w in ws[0]]
    tz = [u64_to_torch(w) for w in ws[1]] if sums == 2 else None
    mac = TR.rns_mac_ref(tx, ty, plan, tz).reshape(sums * rows, n)
    limb = torch.arange(sums * rows) % limbs
    r1 = u64_to_torch(np.array([[(1 << 64) % q] for q in qs], dtype=np.uint64))
    assert torch.equal(TR.mul_mod_v(v, r1[limb], t.q[limb], t.neg_q_inv[limb], t.r2[limb]), mac)  # v 2^64 = the sums
    want = TR.rns_intt_mac_ref(tx, ty, plan, tz)
    assert torch.equal(want, TR.rns_intt_ref(TR.rns_mac_ref(tx, ty, plan, tz), plan))
    for split in (False, True) if log_n >= 6 else (False,):
        got = model_transform(v, plan, True, split, scale=(t.n_inv_mac, t.n_inv_mac_s))
        assert torch.equal(got.reshape(want.shape), want), f"split {split}"

    def jsum(wk):
        if broadcast:
            from learn_fhe_tpu.models.ckks import ckks as JC

            return JC._ks_dot(jnp.asarray(np.stack(wk)), jnp.asarray(np.stack(xs, axis=-3)), jplan)
        acc = JR.rns_mul_eval(jnp.asarray(xs[0]), jnp.asarray(wk[0]), jplan)
        for x, w in zip(xs[1:], wk[1:]):
            acc = JR.rns_add(acc, JR.rns_mul_eval(jnp.asarray(x), jnp.asarray(w), jplan), jplan)
        return acc

    jwant = np.stack([np.asarray(JR.rns_intt(jsum(wk), jplan)) for wk in ws])
    np.testing.assert_array_equal(torch_to_u64(want).reshape(jwant.shape), jwant)


# -- K-RNS-MAC's gathered instance with one x: the x row in each block's shared memory

ROW_LOG_N = 13  # the shared-x instances' ring (lazy, 1..ROW_TERMS terms)
ROW_TERMS = 4
ITEMS_AHEAD = (PER_BLOCK << (ROW_LOG_N - SPLIT - 2)) // THREADS  # kItemsAhead: a thread's items of the last pass


def staged(terms: int) -> int:
    """kStaged: the items a thread stages at a time (tables and y in
    registers): all of them with 1 or 2 terms, half as many with 3 or 4."""
    return ITEMS_AHEAD if terms <= 2 else ITEMS_AHEAD // 2


def row_copy(rows: int, limbs: int, y_rows: int, sums: int, g: int, c: int) -> tuple[int, int]:
    """(first value, values) of x that block c of cluster g copies into its
    shared memory: the whole x row of the cluster's output row, whichever
    block it is."""
    _, xrow, _, _ = mac_row(rows, limbs, y_rows, mac_out_row(sums, rows, g))
    return xrow << ROW_LOG_N, 1 << ROW_LOG_N


def staged_items(log_n: int, terms: int) -> dict[tuple[int, int], list[list[tuple[int, int, int]]]]:
    """`staged_last_pass`'s dealing: block c's thread t takes items k = t +
    a THREADS of its PER_BLOCK sub-rows' last-pass items (4 consecutive
    values each), in groups of staged(terms), each item as (block column
    col, table column c_off + col, twiddle group), c_off = c N / 2 the
    block's first column. The kernel's shape is N = 2^13's (every thread
    ITEMS_AHEAD items); at a smaller N the same columns fall to fewer
    threads, which is how the arithmetic below runs them."""
    log_s, l0 = log_n - SPLIT, log_n - 2
    log_items = log_s - 2
    out = {}
    for c in range(CLUSTER):
        c_off, sub0 = (c * PER_BLOCK) << log_s, c * PER_BLOCK
        for t in range(THREADS):
            groups = []
            for a0 in range(0, ITEMS_AHEAD, staged(terms)):
                group = []
                for a in range(a0, a0 + staged(terms)):
                    k = t + a * THREADS
                    if k < PER_BLOCK << log_items:
                        s, i = k >> log_items, k & ((1 << log_items) - 1)
                        col = (s << log_s) + (i << 2)
                        group.append((col, c_off + col, ((sub0 + s) << (l0 - SPLIT)) + i))
                groups.append(group)
            out[c, t] = groups
    return out


def staged_values(smem: np.ndarray, perm, tcol: int) -> list[int]:
    """The 4 values of a term that an item at table column tcol reads from
    the block's shared-memory row: at the table's entries, or at tcol.. for
    a term without a table (the identity)."""
    idx = [tcol + j for j in range(4)] if perm is None else [int(perm[tcol + j]) for j in range(4)]
    return [int(smem[i]) for i in idx]


@pytest.mark.parametrize("terms", range(1, ROW_TERMS + 1))
def test_staged_pass_takes_the_last_pass_items_once(terms):
    """At N = 2^13 every thread takes ITEMS_AHEAD items in groups of
    staged(terms), and the cluster's items are the last pass's (`sub_items`:
    every column once, the same twiddle groups), so the transform's other
    passes run on them as on K-RNS-NTT's."""
    dealt = staged_items(ROW_LOG_N, terms)
    assert all(len(g) == staged(terms) for groups in dealt.values() for g in groups)
    assert all(sum(map(len, groups)) == ITEMS_AHEAD for groups in dealt.values())
    want = sub_items(ROW_LOG_N, ROW_LOG_N - 2, 2)
    for (c, t), groups in dealt.items():
        assert [it for g in groups for it in g] == want[c, t]
    cols = sorted(tc + j for groups in dealt.values() for g in groups for _, tc, _ in g for j in range(4))
    assert cols == list(range(1 << ROW_LOG_N))


@pytest.mark.parametrize("limbs,lead,sums", [(23, 2, 1), (5, 2, 1), (46, 2, 2)])
def test_shared_row_gives_every_term_x_at_its_permutation(limbs, lead, sums):
    """Both blocks of a cluster copy the whole x row of its output row; an
    item at table column c_off + col reads, for every term, the staged
    values x[perm[c]] (x[c] without a table) of its 4 columns: every first
    pass value of every term is x at its permutation, on each of the path's
    22 rotations' tables and the identity."""
    from learn_fhe_tpu_torch.models.ckks import bootstrapping as Bt
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.ops.ntt import eval_automorphism_perm

    n = 1 << ROW_LOG_N
    params = C.CkksParams(log_n=ROW_LOG_N, log_qi=55, big_l=23)
    js = Bt.rotation_indices(Bt.BootstrapParams(params, r=3))
    tabs = [eval_automorphism_perm(n, params.pow5(j)) for j in js] + [np.arange(n)]
    rows = limbs * lead
    rng = np.random.default_rng(limbs + sums)
    x = rng.integers(0, 1 << 55, size=(rows, n), dtype=np.uint64)
    for g in (0, 1, sums * rows - 1):  # clusters of the first, second and last output rows
        copies = [row_copy(rows, limbs, limbs, sums, g, c) for c in range(CLUSTER)]
        assert copies[0] == copies[1]
        start, count = copies[0]
        smem = x.reshape(-1)[start : start + count]
        xrow = start >> ROW_LOG_N
        for k0 in range(0, len(tabs), ROW_TERMS):
            perms = [None, *tabs[k0 : k0 + ROW_TERMS - 1]]
            tcols = np.array([tc for groups in staged_items(ROW_LOG_N, len(perms)).values() for g in groups for _, tc, _ in g])
            cols = (tcols[:, None] + np.arange(4)).reshape(-1)  # each item's 4 table columns
            assert np.array_equal(np.sort(cols), np.arange(n))
            for p in perms:
                got = np.zeros(n, dtype=np.uint64)
                got[cols] = smem[cols if p is None else p[cols]]  # staged_values of every item
                np.testing.assert_array_equal(got, x[xrow] if p is None else x[xrow][p])


def model_row_sums(x: np.ndarray, perms, ws, qs, rows: int, y_rows: int, sums: int) -> torch.Tensor:
    """The first pass's values of every output row as the shared-x instance
    makes them in Python integers: each cluster's blocks stage x's row,
    each item sums, over the terms, the staged values at its table columns
    times y (or z) at its columns, in 128 bits with one REDC (1..ROW_TERMS
    terms of lazy primes are one chunk). x: (R, N) rows; ws: per sum, per
    term (y_rows, N) rows."""
    limbs, n = len(qs), x.shape[1]
    log_n = n.bit_length() - 1
    out = np.zeros((sums * rows, n), dtype=np.uint64)
    dealt = staged_items(log_n, len(perms))
    for g in range(sums * rows):
        r = mac_out_row(sums, rows, g)
        s, xrow, limb, yrow = mac_row(rows, limbs, y_rows, r)
        q = qs[limb]
        smem = x[xrow]
        for (_, _), groups in dealt.items():
            for _, tcol, _ in (it for grp in groups for it in grp):
                acc = [0] * 4
                for k, p in enumerate(perms):
                    xv = staged_values(smem, p, tcol)
                    for j in range(4):
                        acc[j] += xv[j] * int(ws[s][k][yrow][tcol + j])
                assert max(acc) < q << 64  # one chunk
                out[r, tcol : tcol + 4] = [redc(a, q, neg_inv64(q)) for a in acc]
    return u64_to_torch(out)


@pytest.mark.parametrize(
    "terms,identity,sums", [(1, False, 1), (2, True, 1), (3, False, 2), (3, True, 1), (4, True, 1), (4, False, 2)]
)
def test_shared_row_sums_match_reference_and_jax(terms, identity, sums):
    """The shared-x instance's values (the staged gather, one REDC an item)
    through the inverse passes with N^-1 2^64 equal rns_intt_mac_ref on one
    x and the JAX package's rns_intt of sum_k rns_mul_eval(x[..., perm_k],
    y_k), bit for bit: 1-4 terms, with and without a term read in place,
    each y a key broadcast over the batch (the bootstrap's diagonals)."""
    from learn_fhe_tpu_torch.ops.ntt import eval_automorphism_perm

    log_n, limbs, lead = 7, 3, 2  # one shape: the JAX side compiles once
    n = 1 << log_n
    qs = _primes(55, log_n, limbs)
    plan, jplan = TR.rns_plan(qs, n), JR.rns_plan(qs, n)
    rng = np.random.default_rng(terms * 10 + sums + identity)
    tabs = [eval_automorphism_perm(n, pow(5, j, 2 * n)) for j in (1, 2, 3)] + [rng.permutation(n)]
    perms = [None if identity and k == 0 else tabs[k % len(tabs)] for k in range(terms)]
    res = lambda lead_: np.stack([rng.integers(0, q, size=(*lead_, n), dtype=np.uint64) for q in qs], axis=-2)  # noqa: E731
    x = res((lead,))
    x[0, 0, 0], x[-1, -1, -1] = 0, qs[-1] - 1
    ws = [[res(()) for _ in range(terms)] for _ in range(sums)]
    rows = lead * limbs
    v = model_row_sums(x.reshape(rows, n), perms, ws, qs, rows, limbs, sums)
    t = TR.rns_tables(plan, CPU)
    got = model_transform(v, plan, True, True, scale=(t.n_inv_mac, t.n_inv_mac_s))
    tx = u64_to_torch(x)
    tp = [None if p is None else torch.from_numpy(p.astype(np.int32)) for p in perms]
    tz = [u64_to_torch(w) for w in ws[1]] if sums == 2 else None
    want = TR.rns_intt_mac_ref([tx] * terms, [u64_to_torch(w) for w in ws[0]], plan, tz, tp)
    assert torch.equal(got.reshape(want.shape), want)
    for s in range(sums):
        acc = None
        for p, w in zip(perms, ws[s]):
            xp = jnp.asarray(x if p is None else x[..., p])
            term = JR.rns_mul_eval(xp, jnp.asarray(np.broadcast_to(w, x.shape)), jplan)
            acc = term if acc is None else JR.rns_add(acc, term, jplan)
        jwant = np.asarray(JR.rns_intt(acc, jplan))
        np.testing.assert_array_equal(torch_to_u64(want if sums == 1 else want[s]), jwant)
