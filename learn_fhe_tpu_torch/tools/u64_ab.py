"""Time K-POLYMUL64, K-NTT64 (`ntt64`, `ntt64_mont`), `intt64` and
K-EXTPROD64 at every shape the multi-key path launches them at, each
against its bound, and the kernels that share their code or their card
beside them; the RNS kernels at the batch-16 CKKS `mul`'s shapes (the
transforms and K-BASECONV also with a cold L2; the sums inside the inverse,
`rns_intt_mac`, against `rns_mac` then `rns_intt`, from a graph and eager)
and at the CKKS bootstrap's (`chip_smoke.bootstrap_cases`: the gathered
MAC alone and inside the inverse, K-AUTOMORPH, K-BASECONV, the transforms,
K-RESCALE) with their registers and spills, and that whole `mul` from a
CUDA graph;
with `--parent DIR`, the
same for the kernel library built from another checkout's sources
(`DIR/learn_fhe_tpu_torch/csrc`), in turns (parent, this, this, parent;
with more than one, each parent's turns around this checkout's).

Both libraries run through this checkout's wrappers on the same inputs
(`kernels.library` is pointed at one, then the other), so the C entry
points of the two must take the same arguments; a case whose entry point
an older library lacks (`NEW_ENTRIES`) is timed on this checkout's alone,
on a library without `lft_rns_intt_mac` the `mul` makes its sums with
`rns_mac` and transforms them with `rns_intt`, as it did before, and on
one without `lft_rns_intt_mac_gather_shared` the gathered sums of one x
run its `lft_rns_intt_mac_gather` (its own gathered path).
K-NTT64's, K-POLYMUL64's, K-EXTPROD64's and the RNS kernels' times are per
launch from a CUDA graph of `--reps` launches (no host time between
launches; a cold-L2 case takes its input from more copies than the L2
holds, `chip_smoke.cold_graph_ms`; the transforms and K-BASECONV also per
eager wrapper call, CUDA events around `--reps` calls), the `mul`'s per
call from a graph of 3 calls; the walks' (K-FHEW-BR64 at a
round of 2 gates and at batch 128) and K-STEP's are CUDA events around
eager wrapper calls, K-FHEW-BR's (batch 128) from a CUDA graph too.
Bounds are `chip_smoke.py`'s cost model at the card's maximum SM clock.

Run from the repository root on a machine with one CUDA device:

    python3 learn_fhe_tpu_torch/tools/u64_ab.py [--parent DIR ...] [--u64-only | --rns-only] [--json PATH]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from learn_fhe_tpu_torch.utils import kernels  # noqa: E402

# The cases, by kernel name, that need an entry point newer libraries add.
# The shared-x gathered sums' entry point; an older library runs them on its
# gathered one, which takes the same arguments.
SHARED_ENTRY, GATHER_ENTRY = "lft_rns_intt_mac_gather_shared", "lft_rns_intt_mac_gather"
NEW_ENTRIES = {
    "ntt64_mont": "lft_ntt64_fwd_mont", "rns_intt_mac": "lft_rns_intt_mac", "rns_mac_gather": "lft_rns_mac_gather",
    "rns_intt_mac_gather": "lft_rns_intt_mac_gather", "automorphism_rns": "lft_rns_automorphism",
    "bgv_drop": "lft_bgv_drop",
}  # fmt: skip


def runs_on(lib, name: str) -> bool:
    entry = NEW_ENTRIES.get(name.split(" ")[0])
    return entry is None or hasattr(lib, entry)


def cases(dev, pipe_per_s: float, walks: bool = True) -> list[tuple[str, object, tuple[float, str] | None, str]]:
    """(name, call, bound, how it is timed) for every measured launch:
    chip_smoke.py's M1 and M2 shapes (`chip_smoke.u64_cases`), and with
    walks, K-FHEW-BR64 at a round of 2 gates and at 128, K-FHEW-BR and
    K-STEP."""
    from learn_fhe_tpu_torch.examples.multi_key_uint8 import example_params
    from learn_fhe_tpu_torch.models import fhew, tfhe
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.models.fhew import gates, lwe
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext
    from learn_fhe_tpu_torch.models.tfhe import tggsw, tglwe, tlwe
    from learn_fhe_tpu_torch.parallel import batch as pbatch
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch

    params = example_params(full=True)
    q, n = params.big_q, params.n
    rng = np.random.default_rng(11)

    def residues(shape, modulus=q):
        return u64_to_torch(rng.integers(0, modulus, size=shape, dtype=np.uint64))

    timed, _, _ = cs.u64_cases(params, residues, dev)
    out = [
        (f"{name} ({rows})", kernel, cs.bound_ms(n_bytes, ops, pipe_per_s), "graph")
        for (name, rows), (kernel, _, n_bytes, ops) in timed.items()
    ]
    if not walks:
        return out

    # K-FHEW-BR64 on random key rows at the full set: a round of 2 gates, and 128
    key = cs.random_walk_key(boot, params, residues, dev)
    a2n = torch.from_numpy(2 * rng.integers(0, n, size=(cs.FHEW_BATCH, params.lwe_s.n)) + 1).to(dev)
    e_all, a_all = boot.schedule(params, a2n)
    for b in (cs.ROUND_BATCH, cs.FHEW_BATCH):
        acc = RlweCiphertext(residues((b, n)).to(dev), residues((b, n)).to(dev))
        e_idx, a_idx = e_all[:b].contiguous(), a_all[:b].contiguous()
        label = f"fhew_blind_rotate64 batch {b} (C = {boot.walk64_cluster(b, params, dev)})"
        out.append((label, lambda e=e_idx, a=a_idx, acc=acc: boot.blind_rotate_core_fused(params, key, e, a, acc), None, "events"))

    # K-FHEW-BR at the 28-bit reference fixture, batch 128
    fp = cs.fhew_reference_params()
    z = fhew.rlwe.sk_gen(fp.rlwe, rng)
    fkey = fhew.key_gen(fp, z, rng, dev)
    m = torch.from_numpy(rng.integers(0, 2, size=(2, cs.FHEW_BATCH))).to(dev)
    c0, c1 = (lwe.sk_encrypt(fp.lwe_z, z, gates.encode_bool(fp, m[i]), rng) for i in range(2))
    lin = gates._lin2(fp, "nand", c0, c1)
    ct_a, f_prime = pbatch._fhew_preamble(fp, fkey, gates.lut_poly(fp, gates.GATE_TABLES["nand"], dev), lin)
    fe, fa = boot.schedule(fp, ct_a)
    facc = RlweCiphertext(torch.zeros_like(f_prime), f_prime)
    out.append((f"fhew_blind_rotate batch {cs.FHEW_BATCH}", lambda: boot.blind_rotate_core_fused(fp, fkey, fe, fa, facc), None, "graph"))

    # K-STEP at the TFHE reference fixture, batch 128, per step of the C loop
    cfg = cs.REFERENCE
    tp = tfhe.BootstrapParams(
        tfhe.TlweParams(log_p=cfg["log_p"], padding=1, n=cfg["n"], std_dev=cfg["tlwe_std"], log_b=4, d=5),
        tfhe.TggswParams(tfhe.TglweParams(log_p=cfg["log_p"], padding=1, big_n=cfg["big_n"], k=1, std_dev=cfg["tglwe_std"]), log_b=23, d=1),
    )  # fmt: skip
    tz = tlwe.sk_gen(tp.tlwe, rng)
    tkey = tfhe.key_gen(tp, tz, rng, dev)
    tab = u64_to_torch(tfhe.lut_table(tp.tlwe.log_p, tp.big_n, lambda v: v), dev)
    cts = tlwe.sk_encrypt(tp.tlwe, tz, tlwe.encode(tp.tlwe, torch.from_numpy(rng.integers(0, tp.tlwe.p, size=cs.BATCH)).to(dev)), rng)
    a2n_t, b2n_t = tfhe.mod_switch_2n(cts, tp.big_n)
    zeros = torch.zeros((cs.BATCH, 1, tp.big_n), dtype=torch.int64, device=dev)
    tacc = tglwe.rotate(tglwe.TglweCiphertext(zeros, tglwe.encode(tp.tglwe, tab).expand(cs.BATCH, tp.big_n)), (-b2n_t) % (2 * tp.big_n))
    exps = a2n_t.t().contiguous()
    steps = tp.tlwe.n

    def step():
        tggsw.blind_rotate_steps(tp.tggsw, tkey.brk, tacc, exps, tkey.mon_v, tkey.mon_d)

    out.append((f"tfhe_step batch {cs.BATCH} (per step of {steps})", step, None, f"events/{steps}"))
    return out


def rns_cases(dev, pipe_per_s: float) -> list[tuple[str, object, tuple[float, str] | None, str]]:
    """chip_smoke.py's C1 cases (`chip_smoke.rns_cases`), the transforms and
    K-BASECONV also cold; each of `rns_intt_mac`'s shapes also as the
    parent's two launches (`rns_mac`, then `rns_intt` of its sums), both
    from a graph and eager, and its registers, spills and stack; B1's
    bootstrap cases (`chip_smoke.bootstrap_cases`) and the gathered sums at
    every shape of the bootstrap's path (`boot_gather_cases`) from a graph;
    and C3's
    batch-16 `mul` (keys and ciphertexts made on the card as C3 makes them;
    on a library without `lft_rns_intt_mac` the `mul` makes its sums with
    `rns_mac` and transforms them with `rns_intt`, as before the fusion)."""
    from learn_fhe_tpu_torch.models.ckks import ckks as C

    params = C.CkksParams(**cs.CKKS)
    B = cs.CKKS_BATCH
    rng = np.random.default_rng(11)
    out, apart = [], []
    for (name, shape), (kernel, _, n_bytes, ops, cold) in cs.rns_cases(params, B, rng, dev).items():
        bound = cs.bound_ms(n_bytes, ops, pipe_per_s)
        out.append((f"{name} {shape}", kernel, bound, "graph"))
        if cold is not None:
            out.append((f"{name} {shape} cold-L2", cold, bound, "cold"))
        if cold is not None or name == "rns_intt_mac":
            out.append((f"{name} {shape} eager", kernel, bound, "eager"))
        if name == "rns_intt_mac":
            two = _two_launches(kernel)
            apart += [(f"rns_mac+rns_intt {shape}", two, None, "graph"), (f"rns_mac+rns_intt {shape} eager", two, None, "eager")]
    out += apart
    boot, _ = cs.bootstrap_cases(C.CkksParams(**cs.BOOT), cs.BOOT_BATCH, np.random.default_rng(41), dev)
    for (name, shape), (kernel, _, n_bytes, ops) in boot.items():
        out.append((f"{name} {shape} (bootstrap)", kernel, cs.bound_ms(n_bytes, ops, pipe_per_s), "graph"))
    out += boot_gather_cases(dev, pipe_per_s)
    sk = C.sk_gen(params, rng)
    rlk = C.rlk_gen(params, sk, rng, dev)
    ms = [rng.standard_normal(params.l) + 1j * rng.standard_normal(params.l) for _ in range(2 * B)]
    cts = [C.sk_encrypt(params, sk, C.encode(params, m, device=dev), params.qs, rng) for m in ms]
    ct0, ct1 = (C.CkksCiphertext(torch.stack([c.b for c in h]), torch.stack([c.a for c in h]), params.qs) for h in (cts[:B], cts[B:]))
    out.append((f"ckks mul batch {B} (per call)", lambda: C.mul(params, rlk, ct0, ct1), None, "graph:3"))
    return out


# The gathered rns_intt_mac's launches in a warm CKKS bootstrap of the batch
# of 2 (chip_smoke.py B3, N = 2^13): (limbs, terms, terms read in place),
# every one reading one x; its rows are twice the limbs.
BOOT_GATHERED = (
    (3, 2, 1), (23, 2, 1), *((limbs, 3, 0) for limbs in (4, 5, 6, 20, 21, 22)), *((limbs, 4, 1) for limbs in (4, 5, 6, 20, 21, 22)),
)  # fmt: skip


def boot_gather_cases(dev, pipe_per_s: float) -> list[tuple[str, object, tuple[float, str] | None, str]]:
    """The gathered rns_intt_mac at each shape a bootstrap launches it at
    (`BOOT_GATHERED`: b's sums, one x through the path's permutations, a
    diagonal a term), each beside `rns_intt` at the same rows, from a graph."""
    from learn_fhe_tpu_torch.models.ckks import bootstrapping as Bt
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.ops import rns
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch

    params = C.CkksParams(**cs.BOOT)
    n, qs, B = params.n, params.qs, cs.BOOT_BATCH
    rng = np.random.default_rng(43)
    sig = [C._eval_perm(n, params.pow5(j), dev) for j in Bt.rotation_indices(Bt.BootstrapParams(params, r=3))]

    def residues(basis, lead):
        return u64_to_torch(np.stack([rng.integers(0, q, size=(*lead, n), dtype=np.uint64) for q in basis], axis=-2)).to(dev)

    out = []
    for limbs, terms, in_place in BOOT_GATHERED:
        plan = rns.rns_plan(qs[:limbs], n)
        be, pts = residues(qs[:limbs], (B,)), [residues(qs[:limbs], ()) for _ in range(terms)]
        perms = [None] * in_place + sig[: terms - in_place]
        tab = limbs * n * 16
        n_bytes = 2 * B * limbs * n * 8 + terms * limbs * n * 8 + (terms - in_place) * n * 4 + tab
        ops = cs.intt64_ops(B * limbs, n) + cs.gather_mac_ops(B * limbs * n, terms, 1, True, True)
        rows = f"({B}, {limbs}, {n})"
        out.append((f"rns_intt_mac_gather {rows} {terms} terms, {in_place} in place (bootstrap path)",
                    lambda be=be, pts=pts, plan=plan, perms=perms, t=terms: rns.rns_intt_mac([be] * t, pts, plan, perms=perms),
                    cs.bound_ms(n_bytes, ops, pipe_per_s), "graph"))  # fmt: skip
        if terms == 4 or limbs in (3, 23):
            out.append((f"rns_intt {rows} (bootstrap path)", lambda be=be, plan=plan: rns.rns_intt(be, plan),
                        cs.bound_ms(2 * B * limbs * n * 8 + tab, cs.intt64_ops(B * limbs, n), pipe_per_s), "graph"))  # fmt: skip
    return out


def _mac_then_intt(xs, ys, plan, zs=None):
    """`rns_intt_mac` as two launches: the sums by `rns_mac`, then their
    inverse transform by `rns_intt`."""
    from learn_fhe_tpu_torch.ops import rns

    return rns.rns_intt(rns.rns_mac(xs, ys, plan, zs), plan)


@contextmanager
def _sums_apart():
    """Within it `ops.rns` and the CKKS ops make their sums by `_mac_then_intt`."""
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.ops import rns

    saved = C.rns_intt_mac, rns.rns_intt_mac
    C.rns_intt_mac = rns.rns_intt_mac = _mac_then_intt
    try:
        yield
    finally:
        C.rns_intt_mac, rns.rns_intt_mac = saved


def _two_launches(fused):
    """The call `fused` (an `rns_intt_mac` of chip_smoke.rns_cases) made by `_mac_then_intt`."""

    def two():
        with _sums_apart():
            return fused()

    return two


def measure(cases_, reps: int, lib) -> dict[str, float | None]:
    """The cases' times on lib; on a library without `lft_rns_intt_mac` (a
    parent's) the sums are made apart, as before the fusion."""
    with nullcontext() if hasattr(lib, "lft_rns_intt_mac") else _sums_apart():
        return _measure(cases_, reps, lib)


def _measure(cases_, reps: int, lib) -> dict[str, float | None]:
    got = {}
    for name, fn, _, how in cases_:
        if not runs_on(lib, name):
            got[name] = None
        elif how.startswith("graph"):
            got[name] = cs.graph_ms(fn, int(how.split(":")[1]) if ":" in how else reps) * 1e3
        elif how == "cold":
            got[name] = cs.cold_graph_ms(*fn, reps)[0] * 1e3
        elif how == "eager":
            got[name] = cs.cuda_ms(fn, reps) * 1e3
        else:
            per = int(how.split("/")[1]) if "/" in how else 1
            got[name] = cs.cuda_ms(fn, 3) * 1e3 / per
    return got


def print_rns_ptxas(label: str, log: str) -> None:
    """The registers, spills and stack frame of each RNS kernel instance in a build log."""
    for name, (regs, st, ld, stack) in sorted(kernels.ptxas_report(log).items()):
        if "rns" in name:
            print(f"ptxas {label}: {name}: {regs} registers, {st} / {ld} bytes spill stores / loads, {stack} bytes stack frame", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[], help="a checkout whose kernel library is timed in turns with this one (repeatable)")
    ap.add_argument("--reps", type=int, default=20, help="launches per CUDA graph")
    ap.add_argument("--json", type=Path, help="write the times here as JSON")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--u64-only", action="store_true", help="time K-NTT64, ntt64_mont, intt64, K-POLYMUL64 and K-EXTPROD64 alone")
    only.add_argument("--rns-only", action="store_true", help="time the RNS kernels and the CKKS mul alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("u64_ab: no CUDA device")
    card = cs.card_line()
    sm_mhz = float(cs.smi("clocks.max.sm"))
    pipe_per_s = cs.SMS * cs.PIPE_LANES * sm_mhz * 1e6
    print(f"card: {card}; max SM clock {sm_mhz:.0f} MHz", flush=True)
    libs = {"this": kernels.library()}
    if not args.u64_only:
        print_rns_ptxas("this", kernels.build_log())
    for parent in args.parent:
        name = parent.resolve().name
        so = kernels.BUILD_DIR / "parent" / f"liblft_kernels-{name}.so"
        t0 = time.perf_counter()
        csrc = parent.resolve() / "learn_fhe_tpu_torch" / "csrc"
        # an older checkout lacks the newer sources: build those it has
        kernels.build(csrc, so, tuple(s for s in kernels.SOURCES if (csrc / s).exists()))
        print(f"{name} library built in {time.perf_counter() - t0:.1f} s", flush=True)
        if not args.u64_only:
            print_rns_ptxas(name, (so.parent / "build.log").read_text())
        lib = kernels.load(so, optional=frozenset((*NEW_ENTRIES.values(), SHARED_ENTRY)))
        if not hasattr(lib, SHARED_ENTRY) and hasattr(lib, GATHER_ENTRY):
            setattr(lib, SHARED_ENTRY, getattr(lib, GATHER_ENTRY))
        libs[name] = lib
    dev = torch.device("cuda", torch.cuda.current_device())
    built = [] if args.rns_only else cases(dev, pipe_per_s, walks=not args.u64_only)
    if not args.u64_only:
        built += rns_cases(dev, pipe_per_s)
    others = [k for k in libs if k != "this"]
    order = others + ["this", "this"] + others[::-1]
    runs: dict[str, list[dict[str, float]]] = {k: [] for k in libs}
    for which in order:
        kernels.library = lambda lib=libs[which]: lib
        runs[which].append(measure(built, args.reps, libs[which]))
        print(f"turn done: {which}", flush=True)
    rows = []
    for name, _, bound, how in built:
        row = {"name": name, "timed": how, **{k: [r[name] for r in v] for k, v in runs.items()}}
        if bound is not None:
            row["bound_us"], row["bound_by"] = bound[0] * 1e3, bound[1]
        rows.append(row)
        times = "; ".join(f"{k} " + " / ".join("-" if t is None else f"{t:.3f}" for t in v) for k, v in ((k, row[k]) for k in runs))
        share = ""
        if bound is not None:
            ran = [k for k in runs if None not in row[k]]
            share = "; share " + "; ".join(f"{k} {row['bound_us'] / min(row[k]):.4f}" for k in ran)
            share = f"; bound {row['bound_us']:.3f} us by {bound[1]}{share}"
        print(f"[{card}] {name}: {times} us{share}", flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "sm_mhz": sm_mhz, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
