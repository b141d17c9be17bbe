"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

The sources are compiled at first use with `nvcc` for `sm_90a`, one `nvcc`
per source, all started together, and linked into one shared library with a
plain C interface, loaded with ctypes. The library is
cached in `build/learn_fhe_tpu_torch/` beside the package, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
loaded again. Nothing here is imported or built until a wrapper is handed a
CUDA tensor.

Every C entry point of a kernel takes tensors as raw device pointers and
PyTorch's current stream, launches on that stream, allocates nothing, does
not synchronise and returns `cudaGetLastError()`; `launch` raises on a
non-zero status. The library also holds host functions (the FHEW schedule),
called through `call`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "learn_fhe_tpu_torch"
SOURCES = ("ntt32.cu", "torus_crt.cu", "tfhe_step.cu", "fhew_blind_rotate.cu", "ntt64.cu", "fhew_u64.cu", "rns64.cu", "bgv.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)  # fmt: skip

# Largest ring the kernels take: one N=2048 row of u32 is 8 KB of shared memory.
MAX_LOG_N = 11
MAX_PRIMES = 4

_P, _I, _LL, _U, _U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint, ctypes.c_ulonglong
_SIGNATURES = {
    # x, y, psi, psi_shoup, rows, log_n, q, stream
    "lft_ntt32_fwd": (_P, _P, _P, _P, _I, _I, _U, _P),
    # x, y, psi_inv, psi_inv_shoup, rows, log_n, q, n_inv, n_inv_shoup, stream
    "lft_ntt32_inv": (_P, _P, _P, _P, _I, _I, _U, _U, _U, _P),
    # a, b, y, psi, psi_shoup, psi_inv, psi_inv_shoup, rows, log_n, q, n_inv,
    # n_inv_shoup, 2^32 mod q, its shoup, stream
    "lft_negacyclic_mul32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _U, _U, _U, _U, _U, _P),
    # residues (K, count), out (count,), count, host consts, stream
    "lft_garner_to_u64": (_P, _P, _LL, _P, _P),
    # acc_a, acc_b, exps, batch, av, ad, bv, bd, mon_v, mon_d, psi, psi_shoup,
    # psi_inv, psi_inv_shoup, log_n, log_b, rounding_bits, host consts, stream
    "lft_tfhe_step": (_P,) * 3 + (_I,) + (_P,) * 10 + (_I, _I, _I, _P, _P),
    # acc_a, acc_b, exps (steps, batch), steps, batch, av, ad, bv, bd (steps, K,
    # 2, N), mon_v, mon_d, psi, psi_shoup, psi_inv, psi_inv_shoup, log_n,
    # log_b, rounding_bits, host consts, stream
    "lft_tfhe_blind_rotate": (_P,) * 3 + (_LL, _I) + (_P,) * 10 + (_I, _I, _I, _P, _P),
    # acc_a, acc_b, out_a, out_b, ext_idx, auto_idx, batch, steps, brk_a,
    # brk_b, n_keys, ak_a, ak_b, auto_src, auto_sign, windows, psi,
    # psi_shoup, psi_inv, psi_inv_shoup, log_n, q, n_inv, n_inv_shoup, RGSW
    # gadget (log_b, d, rounding_bits, half), RLWE gadget (same), chunk,
    # error, stream
    "lft_fhew_blind_rotate": (
        (_P,) * 6 + (_I, _I) + (_P, _P, _I) + (_P,) * 4 + (_I,) + (_P,) * 4 + (_I, _U, _U, _U)
        + (_I, _I, _I, _U) * 2 + (_I, _P, _P)
    ),
    # x, y, psi, psi_shoup, psi_inv, psi_inv_shoup, rows, log_n, q,
    # -q^-1 mod 2^64, n_inv, n_inv_shoup, stream
    "lft_ntt64_fwd": (_P,) * 6 + (_I, _I) + (_U64,) * 4 + (_P,),
    "lft_ntt64_inv": (_P,) * 6 + (_I, _I) + (_U64,) * 4 + (_P,),
    # the same, then 2^64 mod q and its Shoup dual, stream
    "lft_ntt64_fwd_mont": (_P,) * 6 + (_I, _I) + (_U64,) * 6 + (_P,),
    # a, b, y, the four tables, rows, log_n, q, -q^-1, n_inv, n_inv_shoup,
    # 2^128 mod q, stream
    "lft_negacyclic_mul64": (_P,) * 7 + (_I, _I) + (_U64,) * 5 + (_P,),
    # ct_a, ct_b, out_a, out_b, key_idx, batch, key_a, key_b, n_keys, rows,
    # key_switch, the four tables, log_n, q, -q^-1, n_inv, n_inv_shoup,
    # gadget (log_b, d, rounding_bits, half), error, stream
    "lft_external_product64": (
        (_P,) * 5 + (_I, _P, _P, _I, _I, _I) + (_P,) * 4 + (_I,) + (_U64,) * 4 + (_I, _I, _I, _U64) + (_P, _P)
    ),
    # acc_a, acc_b, out_a, out_b, ext_idx, auto_idx, batch, steps, brk_a,
    # brk_b, n_keys, ak_a, ak_b, auto_src, auto_sign, windows, the four
    # tables, log_n, q, -q^-1, n_inv, n_inv_shoup, RGSW gadget (log_b, d,
    # rounding_bits, half), RLWE gadget (same), cluster, error, stream
    "lft_fhew_blind_rotate64": (
        (_P,) * 6 + (_I, _I) + (_P, _P, _I) + (_P,) * 4 + (_I,) + (_P,) * 4 + (_I,) + (_U64,) * 4
        + (_I, _I, _I, _U64) * 2 + (_I, _P, _P)
    ),
    # x, y, the stacked tables psi, psi_shoup, psi_inv, psi_inv_shoup (L, N),
    # per-limb q, -q^-1 mod 2^64, n_inv, n_inv_shoup (L,), rows, limbs,
    # log_n, lazy, stream
    "lft_rns_ntt_fwd": (_P,) * 10 + (_I,) * 4 + (_P,),
    "lft_rns_ntt_inv": (_P,) * 10 + (_I,) * 4 + (_P,),
    # host arrays of x, y, z pointers (z null: one sum), out, terms, rows,
    # limbs, log_n, y_rows, per-limb q, -q^-1, 2^128 mod q, chunk, stream
    "lft_rns_mac": (_P,) * 4 + (_I,) * 5 + (_P,) * 3 + (_I, _P),
    # the same pointer arrays and out, terms, rows, limbs, log_n, y_rows, the
    # stacked tables as lft_rns_ntt_inv's with N^-1 2^64 mod q and its dual
    # for 1/N, chunk, lazy, stream
    "lft_rns_intt_mac": (_P,) * 4 + (_I,) * 5 + (_P,) * 8 + (_I, _I, _P),
    # lft_rns_mac's and lft_rns_intt_mac's with, after zs, the host array of
    # each term's permutation table (0: none)
    "lft_rns_mac_gather": (_P,) * 5 + (_I,) * 5 + (_P,) * 3 + (_I, _P),
    "lft_rns_intt_mac_gather": (_P,) * 5 + (_I,) * 5 + (_P,) * 8 + (_I, _I, _P),
    # lft_rns_intt_mac_gather's, every x the same pointer
    "lft_rns_intt_mac_gather_shared": (_P,) * 5 + (_I,) * 5 + (_P,) * 8 + (_I, _I, _P),
    # x0, x1 (or null), y0, y1 (or null), code (src | sign << 31), per-limb
    # q, rows, limbs, log_n, stream
    "lft_rns_automorphism": (_P,) * 6 + (_I,) * 3 + (_P,),
    # x, y, q, q_hat^-1, its dual, 1/q, p, q_hat mod p, its dual, u Q mod p,
    # add (or null), lq, lp, log_n, batch, x batch stride, stream
    "lft_base_convert": (_P,) * 11 + (_I,) * 3 + (_LL, _LL, _P),
    # x, conv (or null), y, kept q, P/2 mod q, P^-1 mod q, its dual, Barrett
    # m, limbs, keep, log_n, batch, dropped q_d, (q_d >> 1), stream
    "lft_rescale": (_P,) * 8 + (_I,) * 3 + (_LL, _U64, _U64, _P),
    # x0, x1 (or null), add0, add1 (or null), y0, y1 (or null), the drop
    # table, limbs, k, then, log_n, rows, t, floor(2^64 / t), stream
    "lft_bgv_drop": (_P,) * 7 + (_I,) * 4 + (_LL, _U64, _U64, _P),
    # host function (no stream): cluster, log_n, rows_g, rows_k
    "lft_fhew_walk64_clusters": (_I,) * 4,
    # host functions (no stream): a, batch, n_lwe, minus_map, plus_map,
    # half, window, ops, idxs, sched_len
    "lft_fhew_build_schedule": (_P, _LL, _LL, _P, _P, _LL, _I, _P, _P, _LL),
    # ops, idxs, batch, sched_len, e_out, a_out
    "lft_fhew_fuse_schedule": (_P, _P, _LL, _LL, _P, _P),
}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = shutil.which("nvcc") or (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "nvcc"))
    if not nvcc or not os.path.exists(nvcc):
        raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode() + f.read_bytes())
    return BUILD_DIR / f"liblft_kernels-{h.hexdigest()[:16]}.so"


def build(csrc: Path, so: Path, sources: tuple[str, ...] = SOURCES) -> None:
    """Compile `sources` of `csrc` into the shared library `so`, with the
    compiler's output in `build.log` beside it."""
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tmp = _nvcc(), so.with_name(f"{so.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{s}.o") for s in sources]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(csrc / s)] for s, o in zip(sources, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    codes = [p.returncode for p in procs]
    if not any(codes):
        cmds.append([nvcc, "-shared", "-o", str(tmp), *map(str, objs)])
        link = subprocess.run(cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        outs.append(link.stdout)
        codes.append(link.returncode)
    log = "".join(f"$ {' '.join(c)}\n{out}" for c, out in zip(cmds, outs))
    (so.parent / "build.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    if any(codes):
        raise KernelBuildError(f"nvcc failed ({max(codes)}):\n{log[-8000:]}")
    os.replace(tmp, so)


def load(so: Path, optional: frozenset[str] = frozenset()) -> ctypes.CDLL:
    """Load a library that `build` made, with its entry points' argument
    types; an entry point named in `optional` may be missing (a library
    built from an older checkout's sources)."""
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        if name in optional and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lft_error_string.argtypes = (ctypes.c_int,)
    lib.lft_error_string.restype = ctypes.c_char_p
    return lib


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    so = _library_path()
    if not so.exists():
        build(CSRC, so)
    return load(so)


def build_log() -> str:
    """The compiler's output (`-Xptxas -v`: registers, shared memory, spills)
    of the last build in this checkout, or '' if it has not been built here."""
    path = BUILD_DIR / "build.log"
    return path.read_text() if path.exists() else ""


# The kernels of the library by the name in their source; a mangled name
# holds it after an anonymous-namespace prefix whose hash depends on the
# source's path, and a template instance adds its arguments after it
# (ILi<LOG_N>E, ILb<lazy>ELb<clustered>EE, ILb<lazy>ELi<LOG_N>ELb<mont>EE).
_KERNEL_NAME = re.compile(
    r"(ntt32_fwd|ntt32_inv|negacyclic_mul32|garner|tfhe_step|fhew_blind_rotate|ntt64_fwd|ntt64_inv"
    r"|negacyclic_mul64_bulk|negacyclic_mul64|external_product64|fhew_blind_rotate64|rns_ntt_rows|rns_ntt|rns_intt_mac_rows|rns_intt_mac|rns_mac"
    r"|rns_intt_mac_gather_rows|rns_intt_mac_gather|rns_intt_mac_shared|rns_mac_gather|automorphism|base_convert|rescale|bgv_drop)_kernel"
    r"(I(?:L[ib]\d+E)+E)?"
)


def _template_args(mangled: str | None) -> str:
    """`<11>` for I Li11E E, `<true,false>` for I Lb1E Lb0E E, '' for none."""
    if not mangled:
        return ""
    args = re.findall(r"L([ib])(\d+)E", mangled)
    return "<" + ",".join(v if t == "i" else ("true" if v == "1" else "false") for t, v in args) + ">"


def ptxas_report(log: str) -> dict[str, tuple[int, int, int, int]]:
    """Per kernel instance in a build log (`build_log()`): registers, bytes
    of spill stores, bytes of spill loads and bytes of stack frame (local
    memory: spills, and arrays the compiler could not keep in registers),
    keyed as in the source with the ring's LOG_N for a template instance
    (`ntt32_fwd_kernel<11>`, `garner_kernel`)."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            m = _KERNEL_NAME.search(line)
            name = None if m is None else f"{m[1]}_kernel" + _template_args(m[2])
            continue
        if name is None:
            continue
        regs, st, ld, stack = out.get(name, (0, 0, 0, 0))
        if m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line):
            stack, st, ld = int(m[1]), int(m[2]), int(m[3])
        if m := re.search(r"Used (\d+) registers", line):
            regs = int(m[1])
        out[name] = (regs, st, ld, stack)
    return out


def require(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple | None = None) -> None:
    """Raise unless t is a contiguous CUDA tensor on the current device of
    the given dtype (and shape)."""
    if not t.is_cuda or t.get_device() != torch.cuda.current_device():
        raise ValueError(f"{name}: expected a tensor on the current CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


_ERROR_WORDS: dict[int, torch.Tensor] = {}


def error_word(device: torch.device | str) -> torch.Tensor:
    """The kernels' error word on a CUDA device: one int32 that a kernel ORs
    with a bit where an index it was given lies outside its key (K-FHEW-BR,
    K-FHEW-BR64: 1 an ext index, 2 an auto index; K-EXTPROD64: 1 a key
    index). It stays on the card: read it after a sync, zero it with
    `.zero_()`."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _ERROR_WORDS:
        _ERROR_WORDS[index] = torch.zeros(1, dtype=torch.int32, device=torch.device("cuda", index))
    return _ERROR_WORDS[index]


def launch(entry: str, *args: int) -> None:
    """Call C entry point `entry` on the current stream. The caller passes
    device tensors as `Tensor.data_ptr()` and host constants as
    `ndarray.ctypes.data`, and the stream goes as its raw handle
    (`torch.cuda.current_stream()` would build a Python object): an eager
    caller such as key generation pays this host time on every launch, and
    for the NTT kernels it is of the order of the kernel's own time."""
    status = getattr(library(), entry)(*args, torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice()))
    if status != 0:
        msg = library().lft_error_string(status).decode()
        raise RuntimeError(f"{entry}: CUDA error {status} ({msg})")


def call(entry: str, *args: int) -> int:
    """Call host function `entry` of the library (no stream, no launch) and
    return its int result; pointers go as `ndarray.ctypes.data`."""
    return getattr(library(), entry)(*args)
