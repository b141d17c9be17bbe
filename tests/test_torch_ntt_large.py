"""Port vs JAX past N = 2048: the u32 transforms of K-NTT, intt32 and
K-POLYMUL at the Pallas kernels' own N = 2^14 (and 2^12, 2^13), and the u64
engine's `ntt64` / `intt64` / `negacyclic_mul64`, which run on K-RNS-NTT
with one limb there.

The port's functions run their plain versions here (CPU tensors); the
kernels' pass schedule at these rings is modelled on the CPU
(`test_torch_ntt32._kernel_model`, one row a 512-thread block), and the kernels
themselves are held against the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` N1, N2).
"""

import functools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.ops import ntt as jntt64  # noqa: E402
from learn_fhe_tpu.ops import ntt32 as jntt  # noqa: E402
from learn_fhe_tpu_torch.ops import ntt as tntt64  # noqa: E402
from learn_fhe_tpu_torch.ops import ntt32 as tntt  # noqa: E402
from learn_fhe_tpu_torch.ops import rns as trns  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u32, torch_to_u64, u32_to_torch, u64_to_torch  # noqa: E402
from learn_fhe_tpu_torch.utils.primes import two_adic_primes  # noqa: E402

from .test_torch_ntt32 import (  # noqa: E402
    ROW_THREADS,
    SCRATCH_LOG_N,
    _kernel_model,
    _pass_twiddles,
    _pass_twiddles_wide,
    _pass_widths,
    _row_slots,
    _row_turns,
    _swizzle,
)

LOG_NS = (12, 13, 14)
Q31 = next(two_adic_primes(31, 15))  # 2^30 < q < 2^31: K-POLYMUL's product
Q28 = next(two_adic_primes(28, 15))  # FHEW's and bench_scaling's size: the three-launch route
Q55 = next(two_adic_primes(55, 15))  # bench.py's u64 NTT metric


@pytest.mark.parametrize("log_n", LOG_NS)
@pytest.mark.parametrize("q", [Q31, Q28], ids=["q31", "q28"])
def test_ntt32_past_2048_matches_jax(log_n, q):
    n = 1 << log_n
    jp, tp = jntt.ntt32_plan(q, n), tntt.ntt32_plan(q, n)
    rng = np.random.default_rng(log_n)
    a = rng.integers(0, q, size=(2, n), dtype=np.uint32)
    b = rng.integers(0, q, size=(2, n), dtype=np.uint32)
    a[0, 0], b[-1, -1] = q - 1, q - 1
    ta, tb = u32_to_torch(a), u32_to_torch(b)
    fwd = tntt.ntt32(ta, tp)
    np.testing.assert_array_equal(torch_to_u32(fwd), np.asarray(jntt.ntt32(jnp.asarray(a), jp)))
    np.testing.assert_array_equal(torch_to_u32(tntt.intt32(ta, tp)), np.asarray(jntt.intt32(jnp.asarray(a), jp)))
    np.testing.assert_array_equal(torch_to_u32(tntt.intt32(fwd, tp)), a)
    want = np.asarray(jntt.negacyclic_mul32(jnp.asarray(a), jnp.asarray(b), jp))
    np.testing.assert_array_equal(torch_to_u32(tntt.negacyclic_mul32(ta, tb, tp)), want)
    prod = np.asarray(jntt.pointwise_mul32(jnp.asarray(a), jnp.asarray(b), jp))
    np.testing.assert_array_equal(torch_to_u32(tntt.pointwise_mul32(ta, tb, tp)), prod)


@functools.cache
def _schedule_rows(log_n: int):
    """8 rows under Q31 with edge values in rows 0, 2 and 6 (the last of 1,
    3 and 7 rows), and the JAX package's K-NTT, intt32 and K-POLYMUL results
    on them, two rows a call (the shape this file's other tests compile)."""
    n = 1 << log_n
    jp = jntt.ntt32_plan(Q31, n)
    rng = np.random.default_rng(400 + log_n)
    a = rng.integers(0, Q31, size=(8, n), dtype=np.uint32)
    b = rng.integers(0, Q31, size=(8, n), dtype=np.uint32)
    for r in (0, 2, 6):
        a[r, 0], a[r, -1], b[r, 0], b[r, -1] = 0, Q31 - 1, Q31 - 1, 0

    def jax_rows(f, *xs):
        return np.concatenate([np.asarray(f(*(jnp.asarray(x[i : i + 2]) for x in xs), jp)) for i in range(0, 8, 2)])

    return a, b, {"fwd": jax_rows(jntt.ntt32, a), "inv": jax_rows(jntt.intt32, a), "mul": jax_rows(jntt.negacyclic_mul32, a, b)}


@pytest.mark.parametrize(
    "log_n, rows",
    [pytest.param(log_n, 2, id=str(log_n)) for log_n in LOG_NS]
    + [pytest.param(log_n, rows, id=f"{log_n}-{rows}rows") for log_n in LOG_NS for rows in (1, 3, 7)],
)
def test_kernel_schedule_model_past_2048(log_n, rows):
    """The kernels' schedule at one row a block (512 threads taking the
    items in turns, wide twiddle loads, the row in dynamic shared memory,
    K-POLYMUL's NTT(a) parked in the output row from 2^SCRATCH_LOG_N):
    edge values, the K-POLYMUL product, against the JAX package, on 2 rows
    of their own and on 1, 3 and 7 rows of `_schedule_rows`."""
    n = 1 << log_n
    tp = tntt.ntt32_plan(Q31, n)
    if rows == 2:
        jp = jntt.ntt32_plan(Q31, n)
        rng = np.random.default_rng(100 + log_n)
        a = rng.integers(0, Q31, size=(2, n), dtype=np.uint32)
        b = rng.integers(0, Q31, size=(2, n), dtype=np.uint32)
        a[0, 0], a[-1, -1], b[0, -1], b[-1, 0] = 0, Q31 - 1, Q31 - 1, 0
        want = {
            "fwd": np.asarray(jntt.ntt32(jnp.asarray(a), jp)),
            "inv": np.asarray(jntt.intt32(jnp.asarray(a), jp)),
            "mul": np.asarray(jntt.negacyclic_mul32(jnp.asarray(a), jnp.asarray(b), jp)),
        }
    else:
        a, b, want = _schedule_rows(log_n)
    for kind, ref in want.items():
        got = _kernel_model(kind, tp, a[:rows], b[:rows] if kind == "mul" else None)
        np.testing.assert_array_equal(got, ref[:rows], err_msg=f"{kind} on {rows} rows")


@pytest.mark.parametrize("log_n", LOG_NS)
def test_row_index_maps_take_every_value_once(log_n):
    """Past 2048, at every pass, the items that ROW_THREADS threads take in
    turns reach every value of the row exactly once, and so do their swizzled
    buffer slots, which `lft::slot` makes from the swizzle of an item's
    first value alone; the model's constants are the kernel's."""
    src = (Path(__file__).resolve().parents[1] / "learn_fhe_tpu_torch" / "csrc" / "ntt32.cu").read_text()
    assert f"constexpr int kRowThreads = {ROW_THREADS};" in src
    assert f"constexpr int kScratchLogN = {SCRATCH_LOG_N};" in src
    n = 1 << log_n
    for p, w in enumerate(_pass_widths(log_n)):
        hi, at = _row_turns(log_n, 3 * p, w)
        assert at.shape == ((n >> w) // ROW_THREADS, ROW_THREADS)
        values = (at[..., None] + (torch.arange(1 << w) << (log_n - 3 * p - w))).reshape(-1)
        assert torch.equal(values.sort().values, torch.arange(n)), f"pass {p}"
        assert torch.equal(_swizzle(values).sort().values, torch.arange(n)), f"pass {p} (swizzled)"
        slots = _row_slots(log_n - 3 * p - w, w, _swizzle(at.reshape(-1)))
        assert torch.equal(slots.reshape(-1), _swizzle(values)), f"pass {p} (slots from swizzle(at))"
        assert int(hi.max()) == (1 << (3 * p)) - 1


@pytest.mark.parametrize("log_n", LOG_NS)
def test_wide_twiddle_loads_match_pass_twiddles(log_n):
    """`pass_twiddles_wide`'s loads (one of 1, 2 and 4 words a layer, each
    on its own alignment) give `pass_twiddles`' values in its order, for
    every item of every pass, from both tables of each direction."""
    tp = tntt.ntt32_plan(Q31, 1 << log_n)
    for f in ("psi_br", "psi_br_shoup", "psi_inv_br", "psi_inv_br_shoup"):
        tab = torch.from_numpy(getattr(tp, f).astype(np.int64))
        for p, w in enumerate(_pass_widths(log_n)):
            hi = _row_turns(log_n, 3 * p, w)[0].reshape(-1)
            assert torch.equal(_pass_twiddles_wide(tab, 3 * p, w, hi), _pass_twiddles(tab, 3 * p, w, hi)), f"{f} pass {p}"


@pytest.mark.parametrize("log_n", LOG_NS)
def test_ntt64_past_2048_matches_jax(log_n):
    n = 1 << log_n
    jp, tp = jntt64.ntt_plan(Q55, n), tntt64.ntt_plan(Q55, n)
    rng = np.random.default_rng(200 + log_n)
    a = rng.integers(0, Q55, size=(2, n), dtype=np.uint64)
    b = rng.integers(0, Q55, size=(2, n), dtype=np.uint64)
    ta, tb = u64_to_torch(a), u64_to_torch(b)
    fwd = tntt64.ntt64(ta, tp)
    np.testing.assert_array_equal(torch_to_u64(fwd), np.asarray(jntt64.ntt(jnp.asarray(a), jp)))
    np.testing.assert_array_equal(torch_to_u64(tntt64.intt64(ta, tp)), np.asarray(jntt64.intt(jnp.asarray(a), jp)))
    np.testing.assert_array_equal(torch_to_u64(tntt64.intt64(fwd, tp)), a)
    want = np.asarray(jntt64.negacyclic_mul(jnp.asarray(a), jnp.asarray(b), jp))
    np.testing.assert_array_equal(torch_to_u64(tntt64.negacyclic_mul64(ta, tb, tp)), want)


@pytest.mark.parametrize("log_n", (12, 14, 16))
def test_one_limb_route_matches_ntt64(log_n):
    """Past 2048 the u64 wrappers run K-RNS-NTT on the one-prime plan: its
    tables are the NttPlan's, and its plain transforms, and the product as
    the wrapper makes it (two forward transforms, one `rns_intt_mac` of one
    term), give `ntt64_ref`'s, `intt64_ref`'s and `negacyclic_mul64_ref`'s
    values."""
    n = 1 << log_n
    q = next(two_adic_primes(55, log_n + 1))
    tp, rp = tntt64.ntt_plan(q, n), trns.rns_plan((q,), n)
    for f in ("psi_br", "psi_br_shoup", "psi_inv_br", "psi_inv_br_shoup"):
        np.testing.assert_array_equal(getattr(rp, f)[0], getattr(tp, f))
    assert (int(rp.n_inv[0, 0]), int(rp.n_inv_shoup[0, 0])) == (tp.n_inv, tp.n_inv_shoup)
    rng = np.random.default_rng(300 + log_n)
    a = u64_to_torch(rng.integers(0, q, size=(2, n), dtype=np.uint64))
    b = u64_to_torch(rng.integers(0, q, size=(2, n), dtype=np.uint64))
    ea, eb = (trns.rns_ntt_ref(t.unsqueeze(-2), rp) for t in (a, b))
    assert torch.equal(ea.squeeze(-2), tntt64.ntt64_ref(a, tp))
    assert torch.equal(trns.rns_intt_ref(a.unsqueeze(-2), rp).squeeze(-2), tntt64.intt64_ref(a, tp))
    assert torch.equal(trns.rns_intt_mac_ref([ea], [eb], rp).squeeze(-2), tntt64.negacyclic_mul64_ref(a, b, tp))


def test_wrappers_take_2_to_the_14_and_no_more():
    """A non-CPU tensor past 2^14 is refused by the ring check before any
    launch; at 2^14 the ring is taken and the device check refuses a tensor
    that is not on the card (here a meta tensor)."""
    big = torch.empty((1, 1 << 15), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="n <= 16384"):
        tntt.ntt32(big, tntt.ntt32_plan(next(two_adic_primes(31, 16)), 1 << 15))
    at = torch.empty((1, 1 << 14), dtype=torch.int32, device="meta")
    for fn in (tntt.ntt32, tntt.intt32):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(at, tntt.ntt32_plan(Q31, 1 << 14))
    with pytest.raises(ValueError, match="CUDA device"):
        tntt.negacyclic_mul32(at, at, tntt.ntt32_plan(Q31, 1 << 14))
