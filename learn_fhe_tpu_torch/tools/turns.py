"""The turn-taking that the tools timing this checkout against others on
one card share (`ends_ab.py`, `ring_ab.py`). Each turn is a process of its
own whose `learn_fhe_tpu_torch` is the turn's checkout (its root first on
`sys.path`, its kernels built from its own `csrc/` into its own `build/`);
it prints one JSON line last. With parents the turns run parent, this,
this, parent for each; `--parent-only` runs the parents alone.

A tool imports this file by its path (`load`), not through the package, so
that a turn can still import another checkout's `learn_fhe_tpu_torch`.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load(path: Path):
    """The module in the file `path`, imported under its stem."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def chip_smoke():
    """This checkout's chip_smoke.py, whichever package is on sys.path."""
    return load(ROOT / "chip_smoke.py")


def order(parents: list[Path], parent_only: bool) -> list[Path]:
    """The roots in the order their turns run."""
    if parent_only:
        return parents
    return [x for p in parents for x in (p, ROOT, ROOT, p)] or [ROOT]


def main(tool: str, doc: str, turn, report, calls_help: str) -> None:
    """A tool's command line: `--parent DIR` (repeatable), `--parent-only`,
    `--calls`, `--json` (default `build/<tool>.json`). With the internal
    `--turn ROOT` it prints `turn(ROOT, calls)` as one JSON line; else it
    runs the turns (`order`), hands each turn's row to `report`, and writes
    the rows to `--json`."""
    import torch

    name = Path(tool).stem
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--parent", action="append", default=[], help="another checkout's root (repeatable)")
    ap.add_argument("--parent-only", action="store_true", help="time the parents alone")
    ap.add_argument("--calls", type=int, default=7, help=calls_help)
    ap.add_argument("--json", default=str(ROOT / "build" / f"{name}.json"))
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit(f"{name}: no CUDA device")
    if args.turn:
        print(json.dumps(turn(Path(args.turn).resolve(), args.calls)), flush=True)
        return
    rows = []
    for root in order([Path(p).resolve() for p in args.parent], args.parent_only):
        run = subprocess.run(
            [sys.executable, tool, "--turn", str(root), "--calls", str(args.calls)],
            capture_output=True, text=True, cwd=ROOT,
        )  # fmt: skip
        if run.returncode:
            raise SystemExit(f"{name}: the turn of {root} failed ({run.returncode}):\n{run.stderr[-4000:]}")
        rows.append(json.loads(run.stdout.strip().splitlines()[-1]))
        report(rows[-1])
    Path(args.json).parent.mkdir(parents=True, exist_ok=True)
    Path(args.json).write_text(json.dumps(rows, indent=1))
