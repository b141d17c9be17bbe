"""Port vs JAX: the coefficient-sharded transforms with the forward's last
cross-shard layer folded into the local tail (`parallel/coef.py`,
`parallel/coef32.py`), on D ranks simulated as threads of this process.

A stub of `distributed.exchange` hands each rank's thread its partner's
block, or blocks where a list is sent, and counts the calls; no process
group is made. Every rank's shard of the forward transform, the inverse and
the product, gathered, equals the JAX package's unsharded transform element
for element (tolerance zero: every step is exact mod q). The forward issues
log2(D) exchanges, the inverse log2(D), and the product 2 log2(D): a and b
go in one exchange a forward layer.
"""

import threading
from functools import lru_cache
from itertools import islice

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.ops import ntt32 as jntt  # noqa: E402
from learn_fhe_tpu.ops import rns as jrns  # noqa: E402
from learn_fhe_tpu_torch.ops import ntt32 as tntt  # noqa: E402
from learn_fhe_tpu_torch.ops import rns as trns  # noqa: E402
from learn_fhe_tpu_torch.parallel import coef as tcoef  # noqa: E402
from learn_fhe_tpu_torch.parallel import coef32 as tcoef32  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u32, torch_to_u64, u32_to_torch, u64_to_torch  # noqa: E402
from learn_fhe_tpu_torch.utils.primes import two_adic_primes  # noqa: E402

N = 256
RANKS = (2, 4, 8)
QS64 = tuple(islice(two_adic_primes(55, 9), 2))  # two 55-bit primes
Q32 = {"q28": next(two_adic_primes(28, 9)), "q31": next(two_adic_primes(31, 9))}


class _Exchanges:
    """`exchange` among D threads: a rank posts what it sends under its
    call's number, waits for every rank to post, and takes its peer's."""

    def __init__(self, d: int):
        self.barrier = threading.Barrier(d)
        self.posted: dict[tuple[int, int], tuple[int, list]] = {}
        self.calls = [0] * d
        self.local = threading.local()

    def __call__(self, x, peer: int, group=None):
        rank = self.local.rank
        many = isinstance(x, (list, tuple))
        k = self.calls[rank]
        self.calls[rank] += 1
        self.posted[rank, k] = (peer, [t.clone() for t in (x if many else [x])])
        self.barrier.wait()
        to, got = self.posted[peer, k]
        assert to == rank, f"rank {rank} sends to {peer}, which sends to {to}"
        return got if many else got[0]


def _on_ranks(d: int, fn, monkeypatch) -> tuple[list, list[int]]:
    """fn(rank) on d threads, each rank's exchanges through one stub;
    (the results by rank, the exchange calls by rank)."""
    ex = _Exchanges(d)
    monkeypatch.setattr(tcoef, "exchange", ex)
    out, errors = [None] * d, []

    def body(rank: int) -> None:
        ex.local.rank = rank
        try:
            out[rank] = fn(rank)
        except BaseException as e:  # noqa: BLE001 - re-raised below, after the threads end
            errors.append(e)
            ex.barrier.abort()

    threads = [threading.Thread(target=body, args=(r,)) for r in range(d)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out, ex.calls


def _blocks(x: torch.Tensor, d: int) -> list[torch.Tensor]:
    return [b.contiguous() for b in x.chunk(d, dim=-1)]


@lru_cache(maxsize=None)
def _u64_case():
    """(x, y) numpy (2, L, N) residues, and the JAX package's ntt, intt, mul of them."""
    rng = np.random.default_rng(22)
    x, y = (np.stack([rng.integers(0, q, size=(2, N), dtype=np.uint64) for q in QS64], axis=-2) for _ in range(2))
    plan = jrns.rns_plan(QS64, N)
    want = {
        "ntt": np.asarray(jrns.rns_ntt(jnp.asarray(x), plan)),
        "intt": np.asarray(jrns.rns_intt(jnp.asarray(x), plan)),
        "mul": np.asarray(jrns.rns_mul(jnp.asarray(x), jnp.asarray(y), plan)),
    }
    return x, y, want


@lru_cache(maxsize=None)
def _u32_case(q: int):
    rng = np.random.default_rng(q % 1000)
    x, y = (rng.integers(0, q, size=(3, N), dtype=np.uint32) for _ in range(2))
    plan = jntt.ntt32_plan(q, N)
    want = {
        "ntt": np.asarray(jntt.ntt32(jnp.asarray(x), plan)),
        "intt": np.asarray(jntt.intt32(jnp.asarray(x), plan)),
        "mul": np.asarray(jntt.negacyclic_mul32(jnp.asarray(x), jnp.asarray(y), plan)),
    }
    return x, y, want


def _exchanges(op: str, log_d: int) -> int:
    return 2 * log_d if op == "mul" else log_d


@pytest.mark.parametrize("op", ["ntt", "intt", "mul"])
@pytest.mark.parametrize("d", RANKS)
def test_coef_sharded_u64_matches_jax(monkeypatch, d, op):
    """coef_ntt_local / coef_intt_local / coef_mul_local on D thread ranks ==
    the JAX package's rns_ntt / rns_intt / rns_mul at N = 256, two 55-bit
    primes; each rank issues log2(D) exchanges (2 log2(D) for the product)."""
    x, y, want = _u64_case()
    plan = tcoef.coef_ntt_plan(QS64, N, d)
    xs, ys = _blocks(u64_to_torch(x), d), _blocks(u64_to_torch(y), d)
    fn = {
        "ntt": lambda r: tcoef.coef_ntt_local(xs[r], plan, r),
        "intt": lambda r: tcoef.coef_intt_local(xs[r], plan, r),
        "mul": lambda r: tcoef.coef_mul_local(xs[r], ys[r], plan, r),
    }[op]
    got, calls = _on_ranks(d, fn, monkeypatch)
    np.testing.assert_array_equal(torch_to_u64(torch.cat(got, dim=-1)), want[op])
    assert calls == [_exchanges(op, plan.log_d)] * d


@pytest.mark.parametrize("op", ["ntt", "intt", "mul"])
@pytest.mark.parametrize("prime", sorted(Q32))
@pytest.mark.parametrize("d", RANKS)
def test_coef32_sharded_matches_jax(monkeypatch, d, prime, op):
    """coef32_ntt_local / coef32_intt_local / coef32_mul_local on D thread
    ranks == the JAX package's ntt32 / intt32 / negacyclic_mul32 at N = 256
    under a 28-bit prime (the product through the fused forward tails) and a
    31-bit one (through K-POLYMUL on the raw blocks)."""
    q = Q32[prime]
    x, y, want = _u32_case(q)
    plan = tcoef32.coef32_plan(q, N, d)
    xs, ys = _blocks(u32_to_torch(x), d), _blocks(u32_to_torch(y), d)
    fn = {
        "ntt": lambda r: tcoef32.coef32_ntt_local(xs[r], plan, r),
        "intt": lambda r: tcoef32.coef32_intt_local(xs[r], plan, r),
        "mul": lambda r: tcoef32.coef32_mul_local(xs[r], ys[r], plan, r),
    }[op]
    got, calls = _on_ranks(d, fn, monkeypatch)
    np.testing.assert_array_equal(torch_to_u32(torch.cat(got, dim=-1)), want[op])
    assert calls == [_exchanges(op, plan.log_d)] * d


@pytest.mark.parametrize("d", RANKS)
def test_coef_ntt_tail_ref_is_the_layer_then_the_tail(d):
    """The fused launches' plain versions == the last forward cross layer's
    plain version, then the plain local transform, for a lower rank (0) and
    an upper one (D - 1) of that layer, on both engines."""
    x, y, _ = _u64_case()
    plan = tcoef.coef_ntt_plan(QS64, N, d)
    a, v = _blocks(u64_to_torch(x), d)[0], _blocks(u64_to_torch(y), d)[0]
    q = Q32["q28"]
    x32, y32, _ = _u32_case(q)
    plan32 = tcoef32.coef32_plan(q, N, d)
    a32, v32 = _blocks(u32_to_torch(x32), d)[0], _blocks(u32_to_torch(y32), d)[0]
    for rank in (0, d - 1):
        assert tcoef._upper(plan, plan.log_d - 1, rank) == bool(rank & 1)
        want = trns.rns_ntt_ref(tcoef.coef_cross_ref(a, v, plan, plan.log_d - 1, rank, False), tcoef.local_plan(plan, rank))
        assert torch.equal(tcoef.coef_ntt_tail_ref(a, v, plan, rank), want)
        assert torch.equal(tcoef.coef_ntt_tail(a, v, plan, rank), want)
        want32 = tntt.ntt32_ref(tcoef32.coef32_cross_ref(a32, v32, plan32, plan.log_d - 1, rank, False), tcoef32.local_plan32(plan32, rank))
        assert torch.equal(tcoef32.coef32_ntt_tail_ref(a32, v32, plan32, rank), want32)
        assert torch.equal(tcoef32.coef32_ntt_tail(a32, v32, plan32, rank), want32)


@pytest.mark.parametrize("engine", ["u64", "q28", "q31"])
@pytest.mark.parametrize("d", RANKS)
def test_past_the_fused_rings_every_layer_launches_apart(monkeypatch, d, engine):
    """With the fused tails' largest ring below the local one (as for a u64
    local ring past 2^13), the forward runs every cross layer before the
    local transform: the same values and the same exchanges."""
    monkeypatch.setattr(tcoef, "TAIL_LOG_N", 4)
    if engine == "u64":
        x, y, want = _u64_case()
        plan = tcoef.coef_ntt_plan(QS64, N, d)
        xs, ys, back = _blocks(u64_to_torch(x), d), _blocks(u64_to_torch(y), d), torch_to_u64
        ntt, mul = tcoef.coef_ntt_local, tcoef.coef_mul_local
    else:
        x, y, want = _u32_case(Q32[engine])
        plan = tcoef32.coef32_plan(Q32[engine], N, d)
        xs, ys, back = _blocks(u32_to_torch(x), d), _blocks(u32_to_torch(y), d), torch_to_u32
        ntt, mul = tcoef32.coef32_ntt_local, tcoef32.coef32_mul_local
    for op, fn in (("ntt", lambda r: ntt(xs[r], plan, r)), ("mul", lambda r: mul(xs[r], ys[r], plan, r))):
        got, calls = _on_ranks(d, fn, monkeypatch)
        np.testing.assert_array_equal(back(torch.cat(got, dim=-1)), want[op])
        assert calls == [_exchanges(op, plan.log_d)] * d
