"""Time the PBS batch and the NAND gate batch whole, and the two ends of
their device work that run as one launch each since K-TFHE-PRE and
K-EXTRACT (the front of a PBS chunk; the gate's extract with its + Q/8),
beside the eager routes those kernels replaced, for this checkout and for
others, in turns on one card.

Each turn is a process of its own whose `learn_fhe_tpu_torch` is the
checkout's (its root first on `sys.path`, its kernels built from its own
`csrc/` into its own `build/`); the yardsticks are this checkout's
`chip_smoke.parent_front` and `chip_smoke.parent_extract`, which run on
either checkout's package. A turn:

- the TFHE reference fixture (TLWE n=1024, TGGSW N=2048, `chip_smoke.py`
  phase 4) at batch 128: keys from seed 0, `tfhe_pbs_batch` with the
  identity LUT, the median, least and most of `--calls` calls, each between
  CUDA events and synchronised; the eager front (`parent_front`) and, where
  the checkout has it, K-TFHE-PRE, each per call over 20 calls (CUDA events);
- the FHEW reference fixture (q = 268409857, N = 512, n = 100, `chip_smoke.py`
  F2) at batch 128: `fhew_gate_batch` NAND, the same spread; the eager
  extract and + Q/8 (`parent_extract`) on the walk's output and, where the
  checkout has it, K-EXTRACT, each per call over 20 calls.

Run from the repository root on a machine with one CUDA device:

    python3 learn_fhe_tpu_torch/tools/ends_ab.py [--parent DIR ...] [--parent-only] [--json PATH]

With `--parent DIR` (another checkout, e.g. a `git archive` of the parent
commit unpacked under `build/`) the turns run parent, this, this, parent;
`--parent-only` times the parents alone. Each turn prints one JSON line;
the summary goes to `--json` (default `build/ends_ab.json`).
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

# the shared turn runner, by its path (see `turns.py`)
_spec = importlib.util.spec_from_file_location("turns", Path(__file__).with_name("turns.py"))
turns = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(turns)
BATCH = 128


def turn(root: Path, calls: int) -> dict:
    """One checkout's times (see the module's docstring)."""
    sys.path.insert(0, str(root))
    cs = turns.chip_smoke()
    from learn_fhe_tpu_torch.models import fhew, tfhe
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.models.fhew import gates, lwe, rlwe
    from learn_fhe_tpu_torch.models.tfhe import tlwe
    from learn_fhe_tpu_torch.parallel import batch as pbatch
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch

    out = {"root": str(root), "card": cs.card_line(), "package": str(Path(tfhe.__file__).resolve().parents[2])}
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = cs.REFERENCE
    params = tfhe.BootstrapParams(
        tfhe.TlweParams(log_p=cfg["log_p"], padding=1, n=cfg["n"], std_dev=cfg["tlwe_std"], log_b=4, d=5),
        tfhe.TggswParams(
            tfhe.TglweParams(log_p=cfg["log_p"], padding=1, big_n=cfg["big_n"], k=1, std_dev=cfg["tglwe_std"]), log_b=23, d=1
        ),
    )
    rng = np.random.default_rng(0)
    z = tlwe.sk_gen(params.tlwe, rng)
    key = tfhe.key_gen(params, z, rng, dev)
    tab = u64_to_torch(tfhe.lut_table(params.tlwe.log_p, params.big_n, lambda v: v), dev)
    ms = torch.from_numpy(rng.integers(0, params.tlwe.p, size=BATCH)).to(dev)
    cts = tlwe.sk_encrypt(params.tlwe, z, tlwe.encode(params.tlwe, ms), rng)
    got = tlwe.decode(params.tlwe, tlwe.decrypt(params.tlwe, z, pbatch.tfhe_pbs_batch(params, key, tab, cts)))
    if not torch.equal(got, ms):
        raise AssertionError("the PBS batch decrypts wrong")
    out["pbs_ms"] = cs.spread_ms(lambda: pbatch.tfhe_pbs_batch(params, key, tab, cts), calls)
    out["front_eager_ms"] = cs.cuda_ms(lambda: cs.parent_front(params, tab, cts), 20)
    if hasattr(tfhe, "blind_rotate_front"):
        out["front_kernel_ms"] = cs.cuda_ms(lambda: tfhe.blind_rotate_front(params, tab, cts.a, cts.b, False, encode=True), 20)

    fp = cs.fhew_reference_params()
    rng = np.random.default_rng(0)
    zf = fhew.rlwe.sk_gen(fp.rlwe, rng)
    fkey = fhew.key_gen(fp, zf, rng, dev)
    m0, m1 = (torch.from_numpy(rng.integers(0, 2, size=BATCH)).to(dev) for _ in range(2))
    c0, c1 = (lwe.sk_encrypt(fp.lwe_z, zf, gates.encode_bool(fp, m), rng) for m in (m0, m1))
    nand = pbatch.fhew_gate_batch(fp, fkey, "nand", c0, c1)
    if not torch.equal(gates.decode_bool(fp, lwe.decrypt(fp.lwe_z, zf, nand)), ~(m0.bool() & m1.bool())):
        raise AssertionError("the NAND batch decrypts wrong")
    out["nand_ms"] = cs.spread_ms(lambda: pbatch.fhew_gate_batch(fp, fkey, "nand", c0, c1), calls)
    lin = gates._lin2(fp, "nand", c0, c1)
    mask, f_prime = pbatch._fhew_preamble(fp, fkey, gates.lut_poly(fp, gates.GATE_TABLES["nand"], dev), lin)
    e_idx, a_idx = boot.schedule(fp, mask)
    walk = boot.blind_rotate_core_fused(fp, fkey, e_idx, a_idx, rlwe.RlweCiphertext(torch.zeros_like(f_prime), f_prime))
    out["extract_eager_ms"] = cs.cuda_ms(lambda: cs.parent_extract(fp, walk, fp.big_q_by_8), 20)
    if hasattr(rlwe.sample_extract, "launches"):
        out["extract_kernel_ms"] = cs.cuda_ms(lambda: rlwe.sample_extract(fp.rlwe, walk, 0, b_add=fp.big_q_by_8), 20)
    return out


def report(r: dict) -> None:
    """One turn's line."""
    print(
        f"{r['card']} | {r['root']}: PBS batch {BATCH} {r['pbs_ms'][0]:.3f} ms ({r['pbs_ms'][1]:.3f}-{r['pbs_ms'][2]:.3f}); "
        f"NAND batch {BATCH} {r['nand_ms'][0]:.3f} ms ({r['nand_ms'][1]:.3f}-{r['nand_ms'][2]:.3f}); "
        f"front eager {r['front_eager_ms'] * 1e3:.1f} us, K-TFHE-PRE {r.get('front_kernel_ms', float('nan')) * 1e3:.1f} us; "
        f"extract + Q/8 eager {r['extract_eager_ms'] * 1e3:.1f} us, K-EXTRACT {r.get('extract_kernel_ms', float('nan')) * 1e3:.1f} us",
        flush=True,
    )


def main() -> None:
    turns.main(__file__, __doc__, turn, report, "whole calls a spread takes")


if __name__ == "__main__":
    main()
