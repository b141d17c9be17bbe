"""Time K-STEP at batch 128 on the TFHE reference fixture in this checkout
and in others, in turns, each through its own package, wrappers and kernel
library: a change that must leave the step kernel as it was (its source,
or what it shares, such as `csrc/torus_crt.cuh`) is checked here, since the
two checkouts' wrappers may lay out their constants differently.

Each turn is a process of its own that times the step as `chip_smoke.py`
phase 6 does: key generation from seed 0, 128 encryptions, then CUDA events
over 3 x 1024 steps of the C loop (`tggsw.blind_rotate_steps`), five
times. The libraries are built first, all at once; then the turns run
parent, this, this, parent (each parent's turns around this checkout's).

Run from the repository root on a machine with one CUDA device:

    python3 learn_fhe_tpu_torch/tools/step_ab.py --parent DIR [--parent DIR ...]

DIR is another checkout's root, e.g. a `git archive` of the parent commit
unpacked under `build/`.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
TIMES = 5


def time_steps(root: str) -> None:
    """One turn: import `root`'s package and chip_smoke.py, time the step."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from learn_fhe_tpu_torch.models import tfhe
    from learn_fhe_tpu_torch.models.tfhe import tggsw, tglwe, tlwe
    from learn_fhe_tpu_torch.utils import kernels
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch

    if not Path(cs.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise SystemExit(f"step_ab: imported {cs.__file__}, not {root}'s")
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = cs.REFERENCE
    params = tfhe.BootstrapParams(
        tfhe.TlweParams(log_p=cfg["log_p"], padding=1, n=cfg["n"], std_dev=cfg["tlwe_std"], log_b=4, d=5),
        tfhe.TggswParams(tfhe.TglweParams(log_p=cfg["log_p"], padding=1, big_n=cfg["big_n"], k=1, std_dev=cfg["tglwe_std"]), log_b=23, d=1),
    )
    rng = np.random.default_rng(0)
    z = tlwe.sk_gen(params.tlwe, rng)
    key = tfhe.key_gen(params, z, rng, dev)
    n_big, batch = params.big_n, cs.BATCH
    tab = u64_to_torch(tfhe.lut_table(params.tlwe.log_p, n_big, lambda v: v), dev)
    ms = torch.from_numpy(rng.integers(0, params.tlwe.p, size=batch)).to(dev)
    cts = tlwe.sk_encrypt(params.tlwe, z, tlwe.encode(params.tlwe, ms), rng)
    a2n, b2n = tfhe.mod_switch_2n(cts, n_big)
    zero = torch.zeros((batch, 1, n_big), dtype=torch.int64, device=dev)
    acc = tglwe.rotate(tglwe.TglweCiphertext(zero, tglwe.encode(params.tglwe, tab).expand(batch, n_big)), (-b2n) % (2 * n_big))
    exps = a2n.t().contiguous()

    def steps():
        tggsw.blind_rotate_steps(params.tggsw, key.brk, acc, exps, key.mon_v, key.mon_d)

    us = [cs.cuda_ms(steps, 3) / params.tlwe.n * 1e3 for _ in range(TIMES)]
    regs = kernels.ptxas_report(kernels.build_log()).get("tfhe_step_kernel<11>")
    print(f"step_ab {root}: {' '.join(f'{u:.2f}' for u in us)} us per step at batch {batch}; ptxas {regs}; {cs.card_line()}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="append", default=[], help="another checkout's root (repeatable)")
    ap.add_argument("--root", help=argparse.SUPPRESS)  # one turn, in a process of its own
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.root:
        if args.build_only:
            sys.path.insert(0, args.root)
            from learn_fhe_tpu_torch.utils import kernels

            kernels.library()
        else:
            time_steps(args.root)
        return
    if not args.parent:
        ap.error("give at least one --parent DIR")
    this = str(ROOT)
    me = [sys.executable, str(Path(__file__).resolve())]
    builds = [subprocess.Popen([*me, "--root", r, "--build-only"]) for r in [this, *args.parent]]
    if any(p.wait() for p in builds):
        raise SystemExit("step_ab: a build failed")
    for parent in args.parent:
        for r in (parent, this, this, parent):
            subprocess.run([*me, "--root", r], check=True)


if __name__ == "__main__":
    main()
