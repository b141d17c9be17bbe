"""Time K-POLYMUL64, K-NTT64 (`ntt64`, `ntt64_mont`), `intt64` and
K-EXTPROD64 at every shape the multi-key path launches them at, each
against its bound, and the kernels that share their code or their card
beside them; the RNS kernels at the batch-16 CKKS `mul`'s shapes (the
transforms and K-BASECONV also with a cold L2; the sums inside the inverse,
`rns_intt_mac`, against `rns_mac` then `rns_intt`, from a graph and eager)
and at the CKKS bootstrap's (`chip_smoke.bootstrap_cases`: the gathered
MAC alone and inside the inverse, K-AUTOMORPH, K-BASECONV, the transforms,
K-RESCALE) with their registers and spills, and that whole `mul` from a
CUDA graph; with `--rings-only`, K-RNS-NTT and `rns_intt_mac` at the
batch-16 BGV `mul`'s shapes (N=2^14, `chip_smoke.py` G0) and the production
bootstrap's (N=2^16, P1), the 2^13 ones beside them (C1), K-BGV-DROP at
G1's shapes, and the BGV and CKKS `mul`s from a CUDA graph;
with `--ntt32-only`, K-NTT, `intt32` and K-POLYMUL at (256, 2^12 .. 2^14)
(`chip_smoke.py` N1) and (2048, 2048), the 28-bit route at (4, 16384) and
K-STEP at batch 128, each row with its instance's blocks an SM,
registers and spills and the compare-and-select count's bound;
with `--coef-only`, the coefficient-sharded forward's last cross-shard
layer and local tail at `chip_smoke.py` S1's shapes, as two launches
(K-COEF-CROSS, then K-RNS-NTT / K-NTT), the tail alone and the fused
launch, for the lower and the upper rank, beside the launch floor (an
empty kernel from a graph);
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

    python3 learn_fhe_tpu_torch/tools/u64_ab.py [--parent DIR ...] [--u64-only | --rns-only | --rings-only | --ntt32-only | --coef-only] [--json PATH]
"""

from __future__ import annotations

import argparse
import ctypes
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
    "bgv_drop": "lft_bgv_drop", "coef_ntt_tail": "lft_rns_ntt_cross", "coef32_ntt_tail": "lft_ntt32_fwd_cross",
    "launch_floor": "lft_empty", "tfhe_key_switch": "lft_tfhe_key_switch", "fhew_preamble": "lft_fhew_preamble",
}  # fmt: skip
HOST_ENTRIES = ("lft_rns_cluster_occupancy", "lft_ntt32_occupancy")  # host functions an older library lacks
RING_ENTRIES = ("lft_rns_add", "lft_base_convert_rows", "lft_rescale_add")  # entries an older library lacks (`adapt_ring_entries`)


_P, _I, _LL, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_ulonglong
# the entries an older library has in their place, with their argument types
OLD_RING_SIGNATURES = {
    "lft_base_convert": (_P,) * 11 + (_I,) * 3 + (_LL, _LL, _P),
    "lft_rescale": (_P,) * 8 + (_I,) * 3 + (_LL, _U64, _U64, _P),
}


def adapt_ring_entries(lib) -> None:
    """Let an older library take this checkout's K-BASECONV and K-RESCALE
    wrappers, which call `lft_base_convert_rows` and `lft_rescale_add`: on
    the calls without a row table or an add (every case here) its
    `lft_base_convert` and `lft_rescale` take the same launch; any other
    call returns cudaErrorInvalidValue (1). The arguments are unpacked by
    name, so a change to either signature fails here, not in a launch. No
    case here calls K-RNS-ADD."""
    for name, argtypes in OLD_RING_SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes, getattr(lib, name).restype = argtypes, ctypes.c_int
    if not hasattr(lib, "lft_base_convert_rows"):

        def base_convert_rows(x, y, q, qhi, qhi_s, frac, p, w, ws, uq, add, rows, copy, lq, lp, log_n, batch, x_stride, y_stride, stream):
            if rows or copy or y_stride != lp << log_n:
                return 1
            return lib.lft_base_convert(x, y, q, qhi, qhi_s, frac, p, w, ws, uq, add, lq, lp, log_n, batch, x_stride, stream)

        lib.lft_base_convert_rows = base_convert_rows
    if not hasattr(lib, "lft_rescale_add"):

        def rescale_add(x, conv, y, q, p_half, p_inv, p_inv_s, bm, add0, add1, limbs, keep, log_n, batch, half, q_d, ph_d, stream):
            if add0 or add1:
                return 1
            return lib.lft_rescale(x, conv, y, q, p_half, p_inv, p_inv_s, bm, limbs, keep, log_n, batch, q_d, ph_d, stream)

        lib.lft_rescale_add = rescale_add


def runs_on(lib, name: str) -> bool:
    entry = NEW_ENTRIES.get(name.split(" ")[0])
    return entry is None or hasattr(lib, entry)


def cases(dev, pipe_per_s: float, walks: bool = True) -> list[tuple[str, object, tuple[float, str] | None, str]]:
    """(name, call, bound, how it is timed) for every measured launch:
    chip_smoke.py's M1 and M2 shapes (`chip_smoke.u64_cases`), and with
    walks, K-FHEW-BR64 at a round of 2 gates and at 128, K-FHEW-BR and
    K-STEP."""
    from learn_fhe_tpu_torch.examples.multi_key_uint8 import example_params
    from learn_fhe_tpu_torch.models import fhew
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.models.fhew import gates, lwe
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext
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

    out.append(step_case(dev, rng))
    return out


def step_case(dev, rng) -> tuple[str, object, None, str]:
    """K-STEP at the TFHE reference fixture, batch 128, per step of the C loop."""
    from learn_fhe_tpu_torch.models import tfhe
    from learn_fhe_tpu_torch.models.tfhe import tggsw, tglwe, tlwe
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch

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

    return (f"tfhe_step batch {cs.BATCH} (per step of {steps})", step, None, f"events/{steps}")


# K-NTT, intt32 and K-POLYMUL: (rows, log N) of chip_smoke.py N1 (256 rows
# at 2^12 .. 2^14) and of key generation's 2048 instances; the 28-bit route
# at bench.py's scaling shape.
NTT32_SHAPES = ((cs.NTT_BATCH, 12), (cs.NTT_BATCH, 13), (cs.NTT_BATCH, 14), (2048, 11))
NTT32_KINDS = {"ntt32": "ntt32_fwd", "intt32": "ntt32_inv", "negacyclic_mul32": "negacyclic_mul32"}


def ntt32_row(name: str) -> tuple[str, int, int] | None:
    """(wrapper, rows, log N) of an `ntt32_cases` label 'wrapper (rows, N)',
    for what is printed beside its times; None for another case."""
    kind, _, shape = name.partition(" (")
    if kind not in NTT32_KINDS or not shape.endswith(")"):
        return None
    rows, n = (int(v) for v in shape[:-1].split(", "))
    return kind, rows, n.bit_length() - 1


def ntt32_bound(kind: str, rows: int, n: int, pipe_per_s: float, least: bool = True) -> tuple[float, str]:
    """chip_smoke.py N1's bound of a K-NTT, intt32 or K-POLYMUL launch;
    least False: by the compare-and-select count (`chip_smoke.ntt32_ops`)."""
    n_bytes = (3 if kind == "negacyclic_mul32" else 2) * rows * n * 4
    return cs.bound_ms(n_bytes, cs.ntt32_ops(kind, rows, n, least), pipe_per_s)


def ntt32_cases(dev, pipe_per_s: float) -> list[tuple[str, object, tuple[float, str] | None, str]]:
    """K-NTT, intt32 and K-POLYMUL at NTT32_SHAPES under the Pallas
    experiment's 31-bit prime, the 28-bit route (two K-NTT, the product in
    torch, one intt32) at (4, 16384), each from a graph against its bound
    (chip_smoke.py N1's), and K-STEP at batch 128."""
    from learn_fhe_tpu_torch.ops import ntt32 as t32
    from learn_fhe_tpu_torch.utils.interop import u32_to_torch
    from learn_fhe_tpu_torch.utils.primes import two_adic_primes

    q31, q28 = next(two_adic_primes(31, 15)), next(two_adic_primes(28, 15))
    rng = np.random.default_rng(20)
    out = []
    for rows, log_n in NTT32_SHAPES:
        n = 1 << log_n
        plan = t32.ntt32_plan(q31, n)
        a, b = (u32_to_torch(rng.integers(0, q31, size=(rows, n), dtype=np.uint32), dev) for _ in range(2))
        for name, call in (
            ("ntt32", lambda a=a, p=plan: t32.ntt32(a, p)),
            ("intt32", lambda a=a, p=plan: t32.intt32(a, p)),
            ("negacyclic_mul32", lambda a=a, b=b, p=plan: t32.negacyclic_mul32(a, b, p)),
        ):
            out.append((f"{name} ({rows}, {n})", call, ntt32_bound(name, rows, n, pipe_per_s), "graph"))
    n, rows = 1 << 14, cs.SCALING_ROWS
    plan = t32.ntt32_plan(q28, n)
    a, b = (u32_to_torch(rng.integers(0, q28, size=(rows, n), dtype=np.uint32), dev) for _ in range(2))
    ops = cs.ntt32_ops("negacyclic_mul32", rows, n)  # two forward, one inverse; the product counted as a Shoup one
    out.append((f"negacyclic_mul32 28-bit route ({rows}, {n})", lambda: t32.negacyclic_mul32(a, b, plan), cs.bound_ms(9 * rows * n * 4, ops, pipe_per_s), "graph"))
    out.append(step_case(dev, np.random.default_rng(11)))
    return out


def ntt32_residency(lib, log: str) -> dict[tuple[str, int], str]:
    """Per (wrapper, log N) of NTT32_SHAPES: its instance's threads, shared
    memory and blocks an SM (from a library that has `lft_ntt32_occupancy`;
    no instance launches a cluster), registers and spills (from the
    library's build log)."""
    from learn_fhe_tpu_torch.ops.ntt32 import OCCUPANCY_KINDS

    report, out = kernels.ptxas_report(log), {}
    for _, log_n in NTT32_SHAPES:
        for kind, instance in NTT32_KINDS.items():
            regs, st, ld, _ = report.get(f"{instance}_kernel<{log_n}>", (0, 0, 0, 0))
            occ = "blocks an SM -"
            if hasattr(lib, "lft_ntt32_occupancy"):
                got = np.zeros(3, dtype=np.int32)
                if lib.lft_ntt32_occupancy(OCCUPANCY_KINDS.index(kind), log_n, got.ctypes.data) == 0:
                    occ = f"{got[0]} threads, {got[1]} B shared, {got[2]} blocks an SM"
            out[kind, log_n] = f"{occ}, {regs} registers, {st} / {ld} B spilled"
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


def ring_cases(dev, pipe_per_s: float) -> list[tuple[str, object, tuple[float, str] | None, str]]:
    """The cluster instances past 2^13 at the shapes their paths launch them
    at: G0's (BGV's mul at N=2^14: the transforms at 64 and 128 rows, the
    sums of 1 and 2 terms, the key switch's) and P1's (N=2^16: the transforms
    at (15, 32) and (2, 30), the sums of 1, 2 and 15 terms, the gathered b
    sum); C1's 2^13 transforms and sums beside them; K-BGV-DROP at G1's
    shapes; and the BGV and CKKS batch-16 `mul`s from a CUDA graph of 3."""
    from learn_fhe_tpu_torch.models import bgv as G
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.models.ckks.production import production_config

    out, keep = [], ("rns_ntt", "rns_intt", "rns_intt_mac", "rns_intt_mac_gather")
    bgv = G.BgvParams(**cs.BGV)
    for ring, params, seed in (("2^13", C.CkksParams(**cs.CKKS), 11), ("2^14", bgv, 13)):
        for (name, shape), (kernel, _, n_bytes, ops, _) in cs.rns_cases(params, 16, np.random.default_rng(seed), dev).items():
            if name in keep:
                out.append((f"{ring} {name} {shape}", kernel, cs.bound_ms(n_bytes, ops, pipe_per_s), "graph"))
    for (name, shape), (kernel, _, n_bytes, ops) in cs.production_cases(production_config(cs.PROD_LOG_N).params, np.random.default_rng(61), dev).items():
        if name in keep:
            out.append((f"2^16 {name} {shape}", kernel, cs.bound_ms(n_bytes, ops, pipe_per_s), "graph"))
    for shape, (kernel, _, n_bytes, ops, _) in cs.bgv_drop_cases(bgv, np.random.default_rng(3), dev).items():
        out.append((f"bgv_drop {shape}", kernel, cs.bound_ms(n_bytes, ops, pipe_per_s), "graph"))
    rng, B = np.random.default_rng(cs.BGV_SEED), cs.BGV_BATCH
    sk = G.sk_gen(bgv, rng)
    rlk = G.rlk_gen(bgv, sk, rng, dev)
    pts = [G.encode(bgv, rng.integers(0, bgv.t, size=(B, bgv.n), dtype=np.int64), dev) for _ in range(2)]
    made = [[G.sk_encrypt(bgv, sk, pt[i], bgv.qs, rng) for i in range(B)] for pt in pts]
    ct0, ct1 = (G.BgvCiphertext(torch.stack([c.b for c in h]), torch.stack([c.a for c in h]), bgv.qs) for h in made)
    out.append((f"bgv mul batch {B} (per call)", lambda: G.mul(bgv, rlk, ct0, ct1), None, "graph:3"))
    params = C.CkksParams(**cs.CKKS)
    sk = C.sk_gen(params, rng)
    crlk = C.rlk_gen(params, sk, rng, dev)
    ms = [rng.standard_normal(params.l) + 1j * rng.standard_normal(params.l) for _ in range(2 * B)]
    cts = [C.sk_encrypt(params, sk, C.encode(params, m, device=dev), params.qs, rng) for m in ms]
    c0, c1 = (C.CkksCiphertext(torch.stack([c.b for c in h]), torch.stack([c.a for c in h]), params.qs) for h in (cts[:B], cts[B:]))
    out.append((f"ckks mul batch {B} (per call)", lambda: C.mul(params, crlk, c0, c1), None, "graph:3"))
    return out


def coef_cases(dev, pipe_per_s: float) -> list[tuple[str, object, tuple[float, str] | None, str]]:
    """The sharded forward transform's last cross-shard layer and local
    tail at chip_smoke.py S1's shapes (u64 at COEF_SHAPE (16, 8, 8192) and
    u32 at (4, 16384) under the 28-bit prime, the local blocks n / D for D =
    2, 4, 8), for the lower rank (0) and the upper one (D - 1): K-COEF-CROSS
    of layer log2 D - 1 then the local K-RNS-NTT / K-NTT (two launches, the
    parent's route), the local transform alone, and where the wrappers have
    it the fused launch (`coef_ntt_tail` / `coef32_ntt_tail`); and the empty
    kernel (the launch floor). Each from a graph; the pair and the fused
    launch against one bound (x, the partner's block and y moved once, or
    the layer's and the tail's operations)."""
    from learn_fhe_tpu_torch.ops import ntt32 as t32
    from learn_fhe_tpu_torch.ops import rns
    from learn_fhe_tpu_torch.parallel import coef as pc
    from learn_fhe_tpu_torch.parallel import coef32 as pc32
    from learn_fhe_tpu_torch.parallel import dryrun
    from learn_fhe_tpu_torch.utils.interop import u32_to_torch, u64_to_torch

    rng = np.random.default_rng(22)
    qs = dryrun.coef_inputs(((), 13, 8, 55))[0]
    q28 = dryrun.coef32_inputs(((), 14, 28))[0]
    rows, n = cs.COEF_SHAPE[0] * cs.COEF_SHAPE[1], cs.COEF_SHAPE[-1]
    out = [("launch_floor (1 block)", lambda: kernels.launch("lft_empty", 1), None, "graph")]
    for d in cs.COEF_RANKS:
        m, m32 = n // d, (1 << 14) // d
        plan, plan32 = pc.coef_ntt_plan(qs, n, d), pc32.coef32_plan(q28, 1 << 14, d)
        x, v = (u64_to_torch(np.stack([rng.integers(0, q, size=(cs.COEF_SHAPE[0], m), dtype=np.uint64) for q in qs], axis=-2), dev) for _ in range(2))
        x32, v32 = (u32_to_torch(rng.integers(0, q28, size=(cs.SCALING_ROWS, m32), dtype=np.uint32), dev) for _ in range(2))
        pair64 = cs.bound_ms(3 * x.numel() * 8, x.numel() * (cs.SHOUP64 + cs.ADD_Q64) + cs.ntt64_ops(rows, m), pipe_per_s)
        tail64 = cs.bound_ms(2 * x.numel() * 8, cs.ntt64_ops(rows, m), pipe_per_s)
        ntt32_ops = cs.ntt32_ops("ntt32", cs.SCALING_ROWS, m32)
        pair32 = cs.bound_ms(3 * x32.numel() * 4, x32.numel() * (cs.SHOUP_MIN + cs.ADD_MIN) + ntt32_ops, pipe_per_s)
        tail32 = cs.bound_ms(2 * x32.numel() * 4, ntt32_ops, pipe_per_s)
        for rank in (0, d - 1):
            lp, lp32 = pc.local_plan(plan, rank), pc32.local_plan32(plan32, rank)
            side = "upper" if rank & 1 else "lower"
            shape, shape32 = f"D={d} rank {rank} ({side}) {tuple(x.shape)}", f"D={d} rank {rank} ({side}) {tuple(x32.shape)}"
            out += [
                (f"coef_cross+rns_ntt {shape}", lambda x=x, v=v, p=plan, r=rank, lp=lp: rns.rns_ntt(pc.coef_cross(x, v, p, p.log_d - 1, r), lp), pair64, "graph"),
                (f"rns_ntt local {shape}", lambda x=x, lp=lp: rns.rns_ntt(x, lp), tail64, "graph"),
                (f"coef32_cross+ntt32 {shape32}", lambda x=x32, v=v32, p=plan32, r=rank, lp=lp32: t32.ntt32(pc32.coef32_cross(x, v, p, p.log_d - 1, r), lp), pair32, "graph"),
                (f"ntt32 local {shape32}", lambda x=x32, lp=lp32: t32.ntt32(x, lp), tail32, "graph"),
            ]  # fmt: skip
            if hasattr(pc, "coef_ntt_tail"):
                out.append((f"coef_ntt_tail {shape}", lambda x=x, v=v, p=plan, r=rank: pc.coef_ntt_tail(x, v, p, r), pair64, "graph"))
            if hasattr(pc32, "coef32_ntt_tail"):
                out.append((f"coef32_ntt_tail {shape32}", lambda x=x32, v=v32, p=plan32, r=rank: pc32.coef32_ntt_tail(x, v, p, r), pair32, "graph"))
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
    only.add_argument("--rings-only", action="store_true", help="time the instances past 2^13 (BGV's and the production ring's), the 2^13 ones, K-BGV-DROP and both muls alone")
    only.add_argument("--ntt32-only", action="store_true", help="time K-NTT, intt32 and K-POLYMUL at (256, 2^12 .. 2^14) and (2048, 2048), the 28-bit route and K-STEP alone")
    only.add_argument("--coef-only", action="store_true", help="time the sharded forward's last cross-shard layer and local tail (K-COEF-CROSS then K-RNS-NTT / K-NTT, the tail alone, the fused launch) at S1's shapes, and the launch floor, alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("u64_ab: no CUDA device")
    card = cs.card_line()
    sm_mhz = float(cs.smi("clocks.max.sm"))
    pipe_per_s = cs.SMS * cs.PIPE_LANES * sm_mhz * 1e6
    print(f"card: {card}; max SM clock {sm_mhz:.0f} MHz", flush=True)
    libs = {"this": kernels.library()}
    residency = {"this": ntt32_residency(libs["this"], kernels.build_log())}
    narrow = args.u64_only or args.ntt32_only or args.coef_only
    if not narrow:
        print_rns_ptxas("this", kernels.build_log())
    for parent in args.parent:
        name = parent.resolve().name
        so = kernels.BUILD_DIR / "parent" / f"liblft_kernels-{name}.so"
        t0 = time.perf_counter()
        csrc = parent.resolve() / "learn_fhe_tpu_torch" / "csrc"
        # an older checkout lacks the newer sources: build those it has
        kernels.build(csrc, so, tuple(s for s in kernels.SOURCES if (csrc / s).exists()))
        print(f"{name} library built in {time.perf_counter() - t0:.1f} s", flush=True)
        log = (so.parent / "build.log").read_text()
        if not narrow:
            print_rns_ptxas(name, log)
        lib = kernels.load(so, optional=frozenset((*NEW_ENTRIES.values(), SHARED_ENTRY, *HOST_ENTRIES, *RING_ENTRIES)))
        residency[name] = ntt32_residency(lib, log)
        if not hasattr(lib, SHARED_ENTRY) and hasattr(lib, GATHER_ENTRY):
            setattr(lib, SHARED_ENTRY, getattr(lib, GATHER_ENTRY))
        adapt_ring_entries(lib)
        libs[name] = lib
    dev = torch.device("cuda", torch.cuda.current_device())
    if args.rings_only:
        built = ring_cases(dev, pipe_per_s)
    elif args.ntt32_only:
        built = ntt32_cases(dev, pipe_per_s)
    elif args.coef_only:
        built = coef_cases(dev, pipe_per_s)
    else:
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
        if (key := ntt32_row(name)) is not None:
            kind, n_rows, log_n = key
            cs_ms, _ = ntt32_bound(kind, n_rows, 1 << log_n, pipe_per_s, least=False)
            row["bound_compare_select_us"] = cs_ms * 1e3
            print(f"    the compare-and-select count's bound {cs_ms * 1e3:.3f} us; share " + "; ".join(f"{k} {cs_ms * 1e3 / min(row[k]):.4f}" for k in runs if None not in row[k]), flush=True)
            row["residency"] = {k: residency[k][kind, log_n] for k in runs}
            for k, v in row["residency"].items():
                print(f"    {k}: {v}", flush=True)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "sm_mhz": sm_mhz, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
