"""Time the multi-key path's conversions into the evaluation basis, in the
Montgomery domain, at each shape the path gives them (the full set, N=2048;
`chip_smoke.to_eval_calls`): `rlwe._to_eval_mont` at 5 rows (`make_ksk`),
`rgsw.to_eval` at a merge chunk (60 keys of 10 rows: 600 rows of a and of
b) and at the final `to_eval` (6000 rows of each).

For each shape, per operand (a call converts one operand, or two):
- the call itself: CUDA events around `--reps` eager calls (host time
  included), and per launch replayed from a CUDA graph;
- its parts as a K-NTT64 launch followed by the eager conversion
  (`to_montgomery`, plain torch): `ntt64` alone (eager and from a graph),
  the conversion alone and the two in turn (eager: the conversion makes
  tensors from host constants, which a graph cannot capture).

Run from the repository root on a machine with one CUDA device:

    python3 learn_fhe_tpu_torch/tools/to_eval_times.py [--reps N] [--json PATH] [--no-call-graph]

`--no-call-graph` leaves out the graph of the call itself, for a tree whose
call runs that eager conversion.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50, help="calls per timing (eager), launches per CUDA graph")
    ap.add_argument("--json", type=Path, help="write the times here as JSON")
    ap.add_argument("--no-call-graph", action="store_true", help="do not capture the call itself in a CUDA graph")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("to_eval_times: no CUDA device")
    from learn_fhe_tpu_torch.examples.multi_key_uint8 import example_params
    from learn_fhe_tpu_torch.ops import ntt as tntt
    from learn_fhe_tpu_torch.ops.modular import to_montgomery
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch

    card = cs.card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    params = example_params(full=True)
    q, n, plan, zq = params.big_q, params.n, params.rlwe.plan, params.rlwe.plan.zq
    rng = np.random.default_rng(5)

    def residues(shape):
        return u64_to_torch(rng.integers(0, q, size=shape, dtype=np.uint64))

    rows_out = []
    for (call, rows), (whole, operands) in cs.to_eval_calls(params, residues, dev).items():
        a = residues((rows, n)).to(dev)
        y = tntt.ntt64(a, plan)
        parts = {  # (call, whether a graph can capture it)
            "ntt64": (lambda a=a: tntt.ntt64(a, plan), True),
            "conversion": (lambda y=y: to_montgomery(y, zq), False),
            "ntt64 + conversion": (lambda a=a: to_montgomery(tntt.ntt64(a, plan), zq), False),
        }
        row = {"call": call, "rows": rows, "operands": operands}
        row["call_eager_us"] = cs.cuda_ms(whole, args.reps) * 1e3 / operands
        if not args.no_call_graph:
            row["call_graph_us"] = cs.graph_ms(whole, args.reps) * 1e3 / operands
        for name, (fn, graph) in parts.items():
            row[f"{name} eager_us"] = cs.cuda_ms(fn, args.reps) * 1e3
            if graph:
                row[f"{name} graph_us"] = cs.graph_ms(fn, args.reps) * 1e3
        rows_out.append(row)
        times = "; ".join(f"{k} {v:.3f}" for k, v in row.items() if k.endswith("_us"))
        print(f"[{card}] {call} at ({rows}, {n}) x {operands} operand(s), us per operand: {times}", flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "rows": rows_out}, indent=1))


if __name__ == "__main__":
    main()
