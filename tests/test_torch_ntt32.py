"""Port vs JAX: the u32 negacyclic NTT, its inverse and the polymul.

Exact equality everywhere (integer arithmetic). The port's functions run
their plain versions here because the tensors lie on the CPU; the CUDA
kernels are held against those plain versions on the card
(`chip_smoke.py`, `tests/test_torch_cuda.py`).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.ops import ntt32 as jntt  # noqa: E402
from learn_fhe_tpu.ops.torus_crt import required_bound_bits, torus_crt_plan  # noqa: E402
from learn_fhe_tpu_torch.ops import ntt32 as tntt  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u32, u32_to_torch  # noqa: E402


def _step_primes(n: int) -> tuple[int, ...]:
    """The primes of the blind-rotation step's CRT plan (B=2^23, R=2)."""
    return torus_crt_plan(n, required_bound_bits(n, 23, 2)).primes


def test_ntt32_plan_tables_match_jax():
    for n in (64, 2048):
        for q in _step_primes(n):
            jp, tp = jntt.ntt32_plan(q, n), tntt.ntt32_plan(q, n)
            for f in ("psi_br", "psi_br_shoup", "psi_inv_br", "psi_inv_br_shoup"):
                np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f))
            assert (tp.n_inv, tp.n_inv_shoup) == (jp.n_inv, jp.n_inv_shoup)
            for f in ("q", "neg_q_inv", "r1", "r2", "barrett_m"):
                assert getattr(tp.zq, f) == getattr(jp.zq, f)


@pytest.mark.parametrize("n", [64, 256, 2048])
def test_ntt32_intt32_polymul_match_jax(n):
    rng = np.random.default_rng(n)
    for q in _step_primes(n):
        jp, tp = jntt.ntt32_plan(q, n), tntt.ntt32_plan(q, n)
        a = rng.integers(0, q, size=(3, n), dtype=np.uint32)
        b = rng.integers(0, q, size=(3, n), dtype=np.uint32)
        ta, tb = u32_to_torch(a), u32_to_torch(b)
        fwd = tntt.ntt32(ta, tp)
        np.testing.assert_array_equal(torch_to_u32(fwd), np.asarray(jntt.ntt32(jnp.asarray(a), jp)))
        np.testing.assert_array_equal(
            torch_to_u32(tntt.intt32(ta, tp)), np.asarray(jntt.intt32(jnp.asarray(a), jp))
        )
        np.testing.assert_array_equal(torch_to_u32(tntt.intt32(fwd, tp)), a)
        want = np.asarray(jntt.negacyclic_mul32(jnp.asarray(a), jnp.asarray(b), jp))
        np.testing.assert_array_equal(torch_to_u32(tntt.negacyclic_mul32(ta, tb, tp)), want)


# ---------------------------------------------------------------------------
# A model of the kernels' schedule (csrc/ntt32.cu): blocks of 2048 values
# up to n = 2048 and of one row past it,
# passes of up to 3 layers on items of 2^W values, the swizzled buffer
# between passes, the ragged last block's masked loads and stores, and
# K-POLYMUL's product and first inverse pass in registers. Past 2048 a
# block's ROW_THREADS threads take the items in turns (item t + j
# ROW_THREADS at turn j), an item's buffer slots come from the swizzle of
# its first value alone, every pass's twiddles come in wide loads, and from
# n = 2^SCRATCH_LOG_N K-POLYMUL runs a's forward passes alone, parks NTT(a)
# in the output row and takes it back in b's last forward pass. Plain int64
# arithmetic mod q stands in for the Shoup butterflies (both are exact); the
# product is the kernels' division-free one.
# ---------------------------------------------------------------------------

ROWS_LOG_N = 11  # up to here a block holds 2048 values; past it, one row
ROW_THREADS = 512  # a row's block past ROWS_LOG_N
SCRATCH_LOG_N = 14  # from here K-POLYMUL's buffer holds one operand


def _block_values(log_n: int) -> int:
    """Values of a block's rows: 2048 (8 a thread of 256) up to n = 2048,
    one row past it."""
    return max(2048, 1 << log_n)


def _pass_widths(log_n: int) -> list[int]:
    passes = (log_n + 2) // 3
    return [3] * (passes - 1) + [log_n - 3 * (passes - 1)]


def _swizzle(i: torch.Tensor) -> torch.Tensor:
    return i ^ (((i >> 5) & 7) << 2)


def _pass_items(log_n: int, l0: int, w: int):
    """Item t of a block's pass: hi, and the (items, 2^w) indices of its
    values in the block's rows, base + (m << log_h)."""
    log_h = log_n - l0 - w
    t = torch.arange(_block_values(log_n) >> w)
    hi = (t & ((1 << (log_n - w)) - 1)) >> log_h
    base = ((t >> (log_n - w)) << log_n) + (hi << (log_n - l0)) + (t & ((1 << log_h) - 1))
    return hi, base[:, None] + (torch.arange(1 << w) << log_h)


def _row_turns(log_n: int, l0: int, w: int):
    """Past 2048 (`RowItem`): hi and at of the item that thread t takes at
    turn j, each (turns, ROW_THREADS), item i = t + j ROW_THREADS of the
    row's 2^(log_n - w)."""
    log_h = log_n - l0 - w
    turns = (1 << (log_n - w)) // ROW_THREADS
    i = torch.arange(ROW_THREADS)[None, :] + torch.arange(turns)[:, None] * ROW_THREADS
    hi = i >> log_h
    return hi, (hi << (log_n - l0)) + (i & ((1 << log_h) - 1))


def _row_slots(log_h: int, w: int, s: torch.Tensor) -> torch.Tensor:
    """`lft::slot`: the (items, 2^w) buffer slots of an item's values from s
    = swizzle(base) alone, slot m = s ^ K_m with K_m = swizzle(m << log_h),
    its bits outside those s may hold added, the rest XORed."""
    bits = ((1 << log_h) - 1) | (7 << 2) | ~((1 << (log_h + w)) - 1)
    m = torch.arange(1 << w) << log_h
    k = m ^ (((m >> 5) & 7) << 2)
    return (s[:, None] ^ (k & bits)) + (k & ~bits)


def _pass_twiddles(tab: torch.Tensor, l0: int, w: int, hi: torch.Tensor) -> torch.Tensor:
    """(items, 2^w - 1): twiddle (1 << (l0+t)) + (hi << t) + u, in the order t, u."""
    return tab[torch.stack([(1 << (l0 + t)) + (hi << t) + u for t in range(w) for u in range(1 << t)], -1)]


def _pass_twiddles_wide(tab: torch.Tensor, l0: int, w: int, hi: torch.Tensor) -> torch.Tensor:
    """`lft::pass_twiddles_wide`: layer l0+t's 2^t twiddles of each item as
    one load of 2^t words at (1 << (l0+t)) + (hi << t), which must be a
    multiple of 2^t (the load's alignment, the table 16-byte aligned); the
    loads laid side by side in the order t = 0, 1, 2."""
    loads = []
    for t in range(w):
        at = (1 << (l0 + t)) + (hi << t)
        assert bool((at % (1 << t) == 0).all()), f"a {4 << t}-byte load off its alignment"
        loads.append(tab[at[:, None] + torch.arange(1 << t)])
    return torch.cat(loads, -1)


def _fwd_radix(x: torch.Tensor, tw: torch.Tensor, q: int) -> None:
    w = x.shape[-1].bit_length() - 1
    for t in range(w):
        half = 1 << (w - 1 - t)
        for u in range(1 << t):
            for j in range(half):
                a = 2 * half * u + j
                v = x[..., a + half] * tw[:, (1 << t) - 1 + u] % q
                x[..., a], x[..., a + half] = (x[..., a] + v) % q, (x[..., a] - v) % q


def _inv_radix(x: torch.Tensor, tw: torch.Tensor, q: int) -> None:
    w = x.shape[-1].bit_length() - 1
    for t in reversed(range(w)):
        half = 1 << (w - 1 - t)
        for u in range(1 << t):
            for j in range(half):
                a = 2 * half * u + j
                x0, x1 = x[..., a].clone(), x[..., a + half].clone()
                x[..., a] = (x0 + x1) % q
                x[..., a + half] = (x0 - x1) % q * tw[:, (1 << t) - 1 + u] % q


def _mul_fold(a: torch.Tensor, b: torch.Tensor, q: int, r32: int, r32_shoup: int) -> torch.Tensor:
    """lft::mul_fold on u32 values held in int64: hi * (2^32 mod q) by Shoup,
    plus lo reduced by two conditional subtracts; no division."""
    m32 = (1 << 32) - 1
    hi, lo = (a * b) >> 32, (a * b) & m32  # a, b < 2^31: the product fits int64
    lo = torch.where(lo >= 2 * q, lo - 2 * q, lo)
    lo = torch.where(lo >= q, lo - q, lo)
    r = (hi * r32 - ((hi * r32_shoup) >> 32) * q) & m32
    r = torch.where(r >= q, r - q, r)
    s = r + lo
    return torch.where(s >= q, s - q, s)


def _kernel_model(kind: str, plan, x: np.ndarray, b: np.ndarray | None = None) -> np.ndarray:
    """The kernels' schedule over all blocks at once: kind 'fwd' (K-NTT),
    'inv' (its inverse) or 'mul' (K-POLYMUL)."""
    n, log_n, q = plan.n, plan.log_n, plan.q
    rows, bv = x.shape[0], _block_values(log_n)
    blocks = -(-rows * n // bv)
    limit = torch.clamp(rows * n - torch.arange(blocks) * bv, max=bv)
    row = log_n > ROWS_LOG_N
    scratch = kind == "mul" and log_n >= SCRATCH_LOG_N

    def rows_of(v):  # device memory: the blocks' values, zeros past the last row
        flat = torch.zeros(blocks * bv, dtype=torch.int64)
        flat[: rows * n] = torch.from_numpy(v.astype(np.int64)).reshape(-1)
        return flat.reshape(blocks, bv)

    ins = [rows_of(x)] + ([rows_of(b)] if kind == "mul" else [])
    # the buffer's slices: K-POLYMUL's a and b, or one from SCRATCH_LOG_N
    bufs = [torch.full((blocks, bv), -1, dtype=torch.int64) for _ in ins[: 1 if scratch else None]]
    out = torch.full((blocks, bv), -1, dtype=torch.int64)
    tab = {f: torch.from_numpy(getattr(plan, f).astype(np.int64)) for f in ("psi_br", "psi_inv_br")}
    widths = _pass_widths(log_n)
    l0s = [3 * p for p in range(len(widths))]
    twiddles = _pass_twiddles_wide if row else _pass_twiddles

    def items(l0, w):
        """hi, the (items, 2^w) value indices and their buffer slots; past
        2048 by (turn, thread), the slots from swizzle(at) (`lft::slot`)."""
        if not row:
            hi, idx = _pass_items(log_n, l0, w)
            return hi, idx, _swizzle(idx)
        log_h = log_n - l0 - w
        hi, at = (v.reshape(-1) for v in _row_turns(log_n, l0, w))
        return hi, at[:, None] + (torch.arange(1 << w) << log_h), _row_slots(log_h, w, _swizzle(at))

    def load(src, idx, slots, from_global):
        if from_global:  # masked: zeros past the rows that exist
            return src[:, idx] * (idx[None, :, :1] < limit[:, None, None])
        return src[:, slots]

    def store(v, dst, idx, slots, to_global):
        if to_global:  # masked: no store past the rows that exist
            keep = (idx[None, :, :1] < limit[:, None, None]).expand_as(v)
            dst[:, idx] = torch.where(keep, v, dst[:, idx])
        else:
            dst[:, slots] = v

    def inverse_layers(v, l0, w, hi):
        _inv_radix(v, twiddles(tab["psi_inv_br"], l0, w, hi), q)
        return v * plan.n_inv % q if l0 == 0 else v

    def forward(srcs, end):
        """The forward passes of srcs (operand o in bufs[o]); the last pass
        stores to out ('store'), or multiplies (by the second operand, or by
        NTT(a) read back from out) and runs its inverse layers ('mul')."""
        for p, (l0, w) in enumerate(zip(l0s, widths)):
            hi, idx, sl = items(l0, w)
            vs = [load(src if p == 0 else bufs[o], idx, sl, p == 0) for o, src in enumerate(srcs)]
            for v in vs:
                _fwd_radix(v, twiddles(tab["psi_br"], l0, w, hi), q)
            if p < len(widths) - 1:
                for v, buf in zip(vs, bufs):
                    store(v, buf, idx, sl, False)
            elif end == "store":
                store(vs[0], out, idx, sl, True)
            else:  # the product and the inverse of the same layers, in registers
                other = vs[1] if len(vs) == 2 else load(out, idx, sl, True)
                prod = _mul_fold(vs[0], other, q, plan.r32, plan.r32_shoup)
                store(inverse_layers(prod, l0, w, hi), out if l0 == 0 else bufs[0], idx, sl, l0 == 0)

    if kind == "fwd":
        forward(ins, "store")
    elif scratch:  # NTT(a) parked in the output row, taken back by b's last pass
        forward(ins[:1], "store")
        forward(ins[1:], "mul")
    elif kind == "mul":
        forward(ins, "mul")
    first_inverse = {"fwd": -1, "mul": len(widths) - 2, "inv": len(widths) - 1}[kind]
    for p in range(first_inverse, -1, -1):
        hi, idx, sl = items(l0s[p], widths[p])
        v = load(ins[0] if kind == "inv" and p == len(widths) - 1 else bufs[0], idx, sl, kind == "inv" and p == len(widths) - 1)
        store(inverse_layers(v, l0s[p], widths[p], hi), out if p == 0 else bufs[0], idx, sl, p == 0)
    got = out.reshape(-1)[: rows * n].reshape(rows, n)
    assert (got >= 0).all(), "a value of the rows was never written"
    return got.numpy().astype(np.uint32)


@pytest.mark.parametrize("log_n", range(1, 12))
def test_kernel_schedule_model_matches_jax(log_n):
    """The kernels' pass schedule, bit for bit against the JAX package, at
    every n = 2..2048, with a ragged last block (rows per block + 1 rows)
    and inputs holding 0 and q - 1."""
    n = 1 << log_n
    rows = (_block_values(log_n) >> log_n) + 1
    rng = np.random.default_rng(log_n)
    for q in _step_primes(n):
        jp, tp = jntt.ntt32_plan(q, n), tntt.ntt32_plan(q, n)
        a = rng.integers(0, q, size=(rows, n), dtype=np.uint32)
        b = rng.integers(0, q, size=(rows, n), dtype=np.uint32)
        a[0, 0], a[-1, -1], b[0, -1], b[-1, 0] = 0, q - 1, q - 1, 0
        np.testing.assert_array_equal(_kernel_model("fwd", tp, a), np.asarray(jntt.ntt32(jnp.asarray(a), jp)))
        np.testing.assert_array_equal(_kernel_model("inv", tp, a), np.asarray(jntt.intt32(jnp.asarray(a), jp)))
        want = np.asarray(jntt.negacyclic_mul32(jnp.asarray(a), jnp.asarray(b), jp))
        np.testing.assert_array_equal(_kernel_model("mul", tp, a, b), want)


@pytest.mark.parametrize("plan_of", ["step", "keygen"])
def test_division_free_product_is_exact(plan_of):
    """K-POLYMUL's product, hi * (2^32 mod q) + lo reduced as the kernel
    reduces it, equals a * b mod q under every prime of the step (B=2^23,
    R=2) and key generation (B=2, R=1) plans at N=2048."""
    bits = required_bound_bits(2048, 23, 2) if plan_of == "step" else required_bound_bits(2048, 2, 1)
    rng = np.random.default_rng(len(plan_of))
    for q in torus_crt_plan(2048, bits).primes:
        tp = tntt.ntt32_plan(q, 2048)
        assert tp.r32 == (1 << 32) % q and 1 << 30 < q < 1 << 31
        edge = np.array([0, 1, q - 1], dtype=np.int64)
        a = np.concatenate([np.repeat(edge, 3), rng.integers(0, q, size=4096)])
        b = np.concatenate([np.tile(edge, 3), rng.integers(0, q, size=4096)])
        got = _mul_fold(torch.from_numpy(a), torch.from_numpy(b), q, tp.r32, tp.r32_shoup)
        want = [int(x) * int(y) % q for x, y in zip(a, b)]
        assert got.tolist() == want


def _pallas_ntt_experiment():
    path = Path(__file__).resolve().parents[1] / "bench" / "pallas_ntt14_experiment.py"
    spec = importlib.util.spec_from_file_location("pallas_ntt14_experiment", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ntt32_matches_pallas_kernels_interpret():
    """The Pallas forward and polymul kernels the port's CUDA kernels
    replace, run in interpret mode at N=256, batch tile 8."""
    mod = _pallas_ntt_experiment()
    n, tb = 256, 8
    q = _step_primes(n)[0]
    jp, tp = jntt.ntt32_plan(q, n), tntt.ntt32_plan(q, n)
    W, WS, WI, WIS, MASK = mod.dense_tables(jp)
    call_fwd, call_polymul = mod.make_kernels(
        q, n, jp.log_n, tb, int(jp.n_inv), int(jp.n_inv_shoup), True
    )
    rng = np.random.default_rng(5)
    a = rng.integers(0, q, size=(2 * tb, n), dtype=np.uint32)
    b = rng.integers(0, q, size=(2 * tb, n), dtype=np.uint32)
    got_fwd = np.asarray(call_fwd(jnp.asarray(a), W, WS, MASK))
    np.testing.assert_array_equal(torch_to_u32(tntt.ntt32(u32_to_torch(a), tp)), got_fwd)
    got_pm = np.asarray(call_polymul(jnp.asarray(a), jnp.asarray(b), W, WS, WI, WIS, MASK))
    port_pm = tntt.negacyclic_mul32(u32_to_torch(a), u32_to_torch(b), tp)
    np.testing.assert_array_equal(torch_to_u32(port_pm), got_pm)


def test_wrappers_take_plain_version_only_on_cpu():
    """On the CPU each wrapper returns its plain version's result and counts
    no kernel launch."""
    n = 64
    q = _step_primes(n)[0]
    tp = tntt.ntt32_plan(q, n)
    x = u32_to_torch(np.random.default_rng(1).integers(0, q, size=(2, n), dtype=np.uint32))
    before = (tntt.ntt32.launches, tntt.intt32.launches, tntt.negacyclic_mul32.launches)
    assert torch.equal(tntt.ntt32(x, tp), tntt.ntt32_ref(x, tp))
    assert torch.equal(tntt.intt32(x, tp), tntt.intt32_ref(x, tp))
    assert torch.equal(tntt.negacyclic_mul32(x, x, tp), tntt.negacyclic_mul32_ref(x, x, tp))
    after = (tntt.ntt32.launches, tntt.intt32.launches, tntt.negacyclic_mul32.launches)
    assert after == before
