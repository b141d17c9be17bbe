"""The SASS instructions of the u64 kernels by issue pipe, on a machine with
the CUDA toolkit.

1. Each u64 operation of `csrc/u64.cuh` (FMA, ALU, either), from chains of
   the operation (`walk64_probes.cu`, built with the library's flags, read
   with `cuobjdump -sass`): the counts `chip_smoke.py`'s cost model takes.
2. The static SASS of the u64 kernels in the library the wrappers build.

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


def sass(path: Path) -> dict[str, collections.Counter]:
    """Opcode counts per function of a cubin or shared library."""
    txt = subprocess.run([str(CUDA_BIN / "cuobjdump"), "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in txt.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            cur = funcs.setdefault(m[1], collections.Counter())
        elif cur is not None and (m := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)):
            cur[m[2]] += 1
    return funcs


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
    out = OUT / "sass.json"
    out.write_text(json.dumps(res, indent=1))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
