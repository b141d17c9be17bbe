"""The SASS instructions of the u64 kernels by issue pipe, on a machine with
the CUDA toolkit.

1. Each u64 operation of `csrc/u64.cuh` (FMA, ALU, either), from chains of
   the operation (`walk64_probes.cu`, built with the library's flags, read
   with `cuobjdump -sass`): the counts `chip_smoke.py`'s cost model takes.
2. The static SASS of the u64 kernels in the library the wrappers build.
3. K-BGV-DROP's own SASS (`csrc/bgv.cu`) by pipe: each instance's loops
   (backward branches) and, at G1's counts of `chip_smoke.py`, its
   instructions a column: the body of the loop over a thread's columns,
   each inner loop (the drops of a loop instance) taken as often as its
   count, over the columns a thread takes at once.

Run from the repository root; writes `build/walk64/sass.json`.

    python3 learn_fhe_tpu_torch/tools/walk64_sass.py
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE.parent / "csrc"
OUT = HERE.parents[1] / "build" / "walk64"
CUDA_BIN = Path("/usr/local/cuda/bin")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]


def pipe(op: str) -> str:
    """The issue pipe of a SASS opcode: an IMAD that is a move, an add or a
    shift, an IADD3 and a MOV count as either pipe (the compiler may put
    them on both); other IMADs on the FMA pipe; compares, selects, logic,
    shifts and minimums on the ALU pipe; the rest (memory, control,
    uniform datapath) is not counted."""
    if op.startswith(("U", "CS2R", "S2")):
        return "other"
    if op.startswith(("IMAD.MOV", "IMAD.IADD", "IMAD.SHL", "IADD3")) or op == "MOV":
        return "either"
    if op.startswith("IMAD"):
        return "fma"
    alu = ("ISETP", "SEL", "LOP3", "SHF", "LEA", "IMNMX", "VIADDMNMX", "VIMNMX", "PLOP3", "PRMT", "IABS", "FLO", "POPC", "BREV")
    return "alu" if op.startswith(alu) else "other"


def listing(path: Path) -> dict[str, list[tuple[int, str, str]]]:
    """(address, opcode, operands) of each instruction, per function of a
    cubin or shared library."""
    txt = subprocess.run([str(CUDA_BIN / "cuobjdump"), "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in txt.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            cur = funcs.setdefault(m[1], [])
        elif cur is not None and (m := re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", line)):
            cur.append((int(m[1], 16), m[3], m[4]))
    return funcs


def sass(path: Path) -> dict[str, collections.Counter]:
    """Opcode counts per function of a cubin or shared library."""
    return {name: collections.Counter(op for _, op, _ in ins) for name, ins in listing(path).items()}


def loops(ins: list[tuple[int, str, str]]) -> list[tuple[int, int]]:
    """(first, last) instruction index of each loop: a branch back to an
    earlier address, in address order of the branch target."""
    at = {a: i for i, (a, _, _) in enumerate(ins)}
    out = []
    for i, (a, op, rest) in enumerate(ins):
        if op.startswith("BRA") and (t := re.search(r"0x([0-9a-f]+)", rest)) and int(t[1], 16) <= a and int(t[1], 16) in at:
            out.append((at[int(t[1], 16)], i))
    return sorted(out)


def per_column(ins, inner_counts: tuple[int, ...], columns: int) -> dict[str, float]:
    """Instructions by pipe a column: the outermost loop's body (a thread's
    columns), its inner loops in address order taken inner_counts[i] times
    each (their body is in the outer one once), over `columns` a turn."""
    spans = loops(ins)
    if not spans:
        return {}
    outer = max(spans, key=lambda s: s[1] - s[0])
    inner = [s for s in spans if s != outer and outer[0] <= s[0] and s[1] <= outer[1]]
    total = collections.Counter(op for _, op, _ in ins[outer[0] : outer[1] + 1])
    for (a, b), times in zip(inner, inner_counts):
        for _, op, _ in ins[a : b + 1]:
            total[op] += times - 1
    return {k: v / columns for k, v in by_pipe(total).items()}


def by_pipe(counts: collections.Counter) -> dict[str, float]:
    out = collections.Counter()
    for op, k in counts.items():
        out[pipe(op)] += k
    return dict(out)


def probe_counts(work: Path) -> dict[str, dict[str, float]]:
    cubin = work / "probes.cubin"
    subprocess.run([str(CUDA_BIN / "nvcc"), *FLAGS, "-cubin", "-I", str(CSRC), "-o", str(cubin), str(HERE / "walk64_probes.cu")], check=True)
    chains = collections.defaultdict(dict)
    for name, counts in sass(cubin).items():
        if m := re.search(r"(probe_\w+?)ILi(\d+)E", name):
            chains[m[1]][int(m[2])] = counts
    return {name: by_pipe(collections.Counter({op: (k[16][op] - k[8][op]) / 8 for op in k[16] | k[8]})) for name, k in sorted(chains.items())}


def main() -> None:
    sys.path.insert(0, str(HERE.parents[1]))
    from learn_fhe_tpu_torch.utils import kernels

    OUT.mkdir(parents=True, exist_ok=True)
    work = kernels.BUILD_DIR.parent / "walk64_sass"
    work.mkdir(parents=True, exist_ok=True)
    res = {"probes": probe_counts(work), "static": {}}
    for name, c in res["probes"].items():
        print(f"SASS {name}: FMA {c.get('fma', 0):g}, ALU {c.get('alu', 0):g}, either {c.get('either', 0):g} instructions per operation")
    kernels.library()
    for name, counts in sass(kernels._library_path()).items():
        if any(k in name for k in ("blind_rotate64", "external_product64", "ntt64_kernel", "negacyclic_mul64")):
            res["static"][name] = by_pipe(counts)
            print(f"SASS static {name[:90]}: {sum(counts.values())} instructions, {res['static'][name]}")
    # K-BGV-DROP at G1's counts: (instance, inner loops' counts, columns a thread takes at once: csrc/bgv.cu's kCols)
    g1 = {"<8,4,0>": ((), 2), "<8,4,1>": ((), 2), "<4,1,0>": ((), 2), "<5,0,0>": ((1, 0), 2), "<8,0,0>": ((4, 0), 2)}
    res["bgv_drop"] = {}
    for name, ins in listing(kernels._library_path()).items():
        if "bgv_drop_kernel" not in name:
            continue
        m = kernels._KERNEL_NAME.search(name)
        inst = "bgv_drop_kernel" + kernels._template_args(m[2] if m else None)
        counts = by_pipe(collections.Counter(op for _, op, _ in ins))
        row = {"static": counts, "loops": [(a, b, b + 1 - a) for a, b in loops(ins)]}
        key = inst[len("bgv_drop_kernel") :]
        if key in g1:
            row["per_column"] = per_column(ins, *g1[key])
        res["bgv_drop"][inst] = row
        print(f"SASS {inst}: static {counts}; loops (first, last, instructions) {row['loops']}; a column at G1's counts {row.get('per_column')}")
    out = OUT / "sass.json"
    out.write_text(json.dumps(res, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
