"""Time the CKKS and BGV ring's user-facing operations whole and list what
the card runs for each, for this checkout and for others, in turns on one
card: the batch-16 CKKS `mul` (`chip_smoke.py` C3), the batch-16 BGV `mul`
at the top level (G2) and a warm CKKS bootstrap of a batch of 2 (B3).

Each turn is a process of its own whose `learn_fhe_tpu_torch` is the
checkout's (its root first on `sys.path`, its kernels built from its own
`csrc/` into its own `build/`); the configurations, seeds and the listing
(`chip_smoke.device_listing`) are this checkout's `chip_smoke.py`'s, which
run on either checkout's package. A turn, for each operation:

- the median, least and most of `--calls` calls, each between CUDA events
  and synchronised (eager: host time included);
- the host enqueue, the median of `--calls` calls timed on the host clock
  from the call to its return, each after a sync;
- one call's launches replayed from a CUDA graph (device only);
- one warm call's device activities by kind (hand-written kernels, PyTorch's
  kernels, copies and sets) and name, with counts (torch.profiler), or "not
  measured" where the records sum to less than 0.9 of the graph's time.

The `mul`s take uniform random residues as operands (their time does not
depend on the values); the bootstrap takes B3's keys and messages (seed 17),
after one cold call.

Run from the repository root on a machine with one CUDA device:

    python3 learn_fhe_tpu_torch/tools/ring_ab.py [--parent DIR ...] [--parent-only] [--json PATH]

With `--parent DIR` (another checkout, e.g. a `git archive` of the parent
commit unpacked under `build/`) the turns run parent, this, this, parent;
`--parent-only` runs the parents alone. Each turn prints its lines and one
JSON line; the summary goes to `--json` (default `build/ring_ab.json`).
"""

from __future__ import annotations

import importlib.util
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the shared turn runner, by its path (see `turns.py`)
_spec = importlib.util.spec_from_file_location("turns", Path(__file__).with_name("turns.py"))
turns = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(turns)


def enqueue_ms(fn, calls: int) -> float:
    """Median host milliseconds from a call of fn to its return, each call
    after a sync (the time the host takes to queue the call's launches)."""
    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def measure(cs, label: str, fn, calls: int, graph_reps: int) -> dict:
    """One operation's times and listing (see the module's docstring)."""
    med, lo, hi = cs.spread_ms(fn, calls)
    row = {"eager_ms": [med, lo, hi], "enqueue_ms": enqueue_ms(fn, calls), "graph_ms": cs.graph_ms(fn, graph_reps)}
    counts, us, total = cs.device_listing(fn)
    row["listing"] = {kind: dict(c) for kind, c in counts.items()}
    row["listing_us"], row["listing_ms"] = us, total
    row["lines"] = cs.listing_lines("", label, (counts, us, total), row["graph_ms"])
    return row


def residues(basis, lead, n, rng, dev) -> torch.Tensor:
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch

    return u64_to_torch(np.stack([rng.integers(0, q, size=(*lead, n), dtype=np.uint64) for q in basis], axis=-2), dev)


def turn(root: Path, calls: int) -> dict:
    """One checkout's times (see the module's docstring)."""
    sys.path.insert(0, str(root))
    cs = turns.chip_smoke()
    from learn_fhe_tpu_torch.models import bgv as G
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.models.ckks import evalmod as E

    out = {"root": str(root), "card": cs.card_line(), "package": str(Path(C.__file__).resolve().parents[3])}
    dev = torch.device("cuda", torch.cuda.current_device())

    params = C.CkksParams(**cs.CKKS)
    rng = np.random.default_rng(11)
    rlk = C.rlk_gen(params, C.sk_gen(params, rng), rng, dev)
    B, qs, n = cs.CKKS_BATCH, params.qs, params.n
    ct0, ct1 = (C.CkksCiphertext(residues(qs, (B,), n, rng, dev), residues(qs, (B,), n, rng, dev), qs) for _ in range(2))
    out["ckks_mul"] = measure(cs, f"CKKS mul at batch {B}", lambda: C.mul(params, rlk, ct0, ct1), calls, 3)

    bp = G.BgvParams(**cs.BGV)
    rng = np.random.default_rng(cs.BGV_SEED)
    brlk = G.rlk_gen(bp, G.sk_gen(bp, rng), rng, dev)
    B = cs.BGV_BATCH
    g0, g1 = (G.BgvCiphertext(residues(bp.qs, (B,), bp.n, rng, dev), residues(bp.qs, (B,), bp.n, rng, dev), bp.qs) for _ in range(2))
    out["bgv_mul"] = measure(cs, f"BGV mul at batch {B}", lambda: G.mul(bp, brlk, g0, g1), calls, 3)

    boot = C.CkksParams(**cs.BOOT)
    em = E.EvalModParams(**cs.BOOT_EM)
    _, rlk, cjk, bk, _, low = cs.bootstrap_setup(boot, np.random.default_rng(cs.BOOT_SEED), dev, cs.BOOT_BATCH)
    run = lambda: E.bootstrap(boot, bk, rlk, cjk, low, em)  # noqa: E731
    run()  # cold: the diagonals' and constants' encodes
    out["bootstrap"] = measure(cs, f"warm bootstrap of a batch of {cs.BOOT_BATCH}", run, max(3, calls // 2), 1)
    return out


def report(r: dict) -> None:
    """One turn's lines."""
    print(f"{r['card']} | {r['root']}", flush=True)
    for op in ("ckks_mul", "bgv_mul", "bootstrap"):
        m = r[op]
        e = m["eager_ms"]
        print(f"  {op}: eager {e[0]:.3f} ms ({e[1]:.3f}-{e[2]:.3f}), enqueue {m['enqueue_ms']:.3f} ms, graph {m['graph_ms']:.3f} ms")
        for line in m["lines"]:
            print("   " + line, flush=True)


def main() -> None:
    turns.main(__file__, __doc__, turn, report, "whole calls a spread and an enqueue median take")


if __name__ == "__main__":
    main()
