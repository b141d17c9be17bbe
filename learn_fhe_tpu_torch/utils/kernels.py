"""Build and load the port's hand-written CUDA kernels (`csrc/*.cu`).

The sources are compiled at first use with `nvcc` for `sm_90a` into one
shared library with a plain C interface, loaded with ctypes. The library is
cached in `build/learn_fhe_tpu_torch/` beside the package, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
loaded again. Nothing here is imported or built until a wrapper is handed a
CUDA tensor.

Every C entry point takes tensors as raw device pointers and PyTorch's current
stream, launches on that stream, allocates nothing, does not synchronise and
returns `cudaGetLastError()`; `launch` raises on a non-zero status.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "learn_fhe_tpu_torch"
SOURCES = ("ntt32.cu", "torus_crt.cu", "tfhe_step.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)  # fmt: skip

# Largest ring the kernels take: one N=2048 row of u32 is 8 KB of shared memory.
MAX_LOG_N = 11
MAX_PRIMES = 4

_P, _I, _LL, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint
_SIGNATURES = {
    # x, y, psi, psi_shoup, rows, log_n, q, stream
    "lft_ntt32_fwd": (_P, _P, _P, _P, _I, _I, _U, _P),
    # x, y, psi_inv, psi_inv_shoup, rows, log_n, q, n_inv, n_inv_shoup, stream
    "lft_ntt32_inv": (_P, _P, _P, _P, _I, _I, _U, _U, _U, _P),
    # a, b, y, psi, psi_shoup, psi_inv, psi_inv_shoup, rows, log_n, q, n_inv,
    # n_inv_shoup, stream
    "lft_negacyclic_mul32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _U, _U, _U, _P),
    # residues (K, count), out (count,), count, host consts, stream
    "lft_garner_to_u64": (_P, _P, _LL, _P, _P),
    # acc_a, acc_b, exps, batch, av, ad, bv, bd, mon_v, mon_d, psi, psi_shoup,
    # psi_inv, psi_inv_shoup, log_n, log_b, rounding_bits, host consts, stream
    "lft_tfhe_step": (_P,) * 3 + (_I,) + (_P,) * 10 + (_I, _I, _I, _P, _P),
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


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    so = _library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        (BUILD_DIR / "build.log").write_text(log)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed ({proc.returncode}):\n{log[-8000:]}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.lft_error_string.argtypes = (ctypes.c_int,)
    lib.lft_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """The compiler's output (`-Xptxas -v`: registers, shared memory, spills)
    of the last build in this checkout, or '' if it has not been built here."""
    path = BUILD_DIR / "build.log"
    return path.read_text() if path.exists() else ""


def require(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple | None = None) -> None:
    """Raise unless t is a contiguous CUDA tensor on the current device of
    the given dtype (and shape)."""
    if t.device.type != "cuda" or t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: expected a tensor on the current CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def launch(entry: str, *args) -> None:
    """Call C entry point `entry` on the current stream; tensors go by device
    pointer, numpy arrays (host constants) by host pointer."""
    lib = library()
    conv = []
    for a in args:
        if isinstance(a, torch.Tensor):
            conv.append(a.data_ptr())
        elif isinstance(a, np.ndarray):
            conv.append(a.ctypes.data)
        else:
            conv.append(a)
    status = getattr(lib, entry)(*conv, torch.cuda.current_stream().cuda_stream)
    if status != 0:
        msg = lib.lft_error_string(status).decode()
        raise RuntimeError(f"{entry}: CUDA error {status} ({msg})")
