"""Batched negacyclic NTT over Z_q[X]/(X^N+1) for primes q < 2^31.

Counterpart of `learn_fhe_tpu/ops/ntt32.py`: the same merged-twist DIT/DIF
transform (normal order in, bit-reversed order out; the inverse takes it
back), the same twiddle tables, so evaluation-basis values agree element for
element with the JAX package.

Kernels (`csrc/ntt32.cu`), each beside its plain radix-2 version:
- `ntt32` / `intt32` replace the Pallas forward kernel
  `bench/pallas_ntt14_experiment.py:166` (`call_fwd`) and the inverse half
  of its polymul kernel (:183): up to n = 2048 a block owns max(1, 2048 /
  n) rows, past it one row (n = 2^12 .. 2^14, the Pallas kernels' own
  (256, 16384) among them, in dynamic shared memory) on 512 threads, two
  blocks an SM, and runs the layers in passes of up to 3 on values held in
  registers (radix 8, [3, 3, 3, 2] at n=2048, [3, 3, 3, 3, 2] at 2^14),
  one barrier between passes; past 2048 an item's shared slots come from
  one swizzle and each layer's twiddles in one wide load.
- `negacyclic_mul32` replaces the Pallas polymul kernel (:183, `call_polymul`):
  the forward passes of a and b, the pointwise product without a division
  (2^32 mod q folded into the high word, `Ntt32Plan.r32`) and the inverse
  passes in one launch; at n = 2^14 its block keeps one operand in shared
  memory (64 KB, two blocks an SM), a's transform waiting in the output
  row until b's last forward pass takes it back. `occupancy(kind, log_n)`
  names each instance's threads, shared memory and blocks an SM. It takes
  primes 2^30 < q < 2^31, as every prime of
  the torus CRT plans is; for a smaller prime (FHEW's 28-bit q) the wrapper
  runs two K-NTT launches, the pointwise product in torch and one `intt32`
  launch instead.
These wrappers take 2 <= n <= 2^14 (`MAX_LOG_N`); the step kernel and
K-FHEW-BR keep `kernels.MAX_LOG_N`. `pointwise_mul32` is the evaluation-basis
product, plain torch on either device (an XLA element-wise op in the JAX
package).

Each wrapper runs the plain version only for CPU tensors. A CUDA tensor goes
to the kernel, or the wrapper raises; there is no fallback.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..utils import kernels
from ..utils.interop import u32_to_torch
from ..utils.primes import mod_inverse, two_adic_generator
from .modular32 import Zq32Params, add_mod32, mul_mod32, shoup32, sub_mod32
from .ntt import bit_reverse_indices

# Largest ring of K-NTT, intt32 and K-POLYMUL: one 2^14 row of u32 is 64 KB
# of shared memory (K-POLYMUL's too: NTT(a) waits in the output row).
MAX_LOG_N = 14


@dataclass(frozen=True, eq=False)
class Ntt32Plan:
    """Host twiddle tables for one (q, n), q < 2^31."""

    q: int
    n: int
    log_n: int
    zq: Zq32Params
    psi_br: np.ndarray  # (n,) u32: psi_{2n}^{bitrev(k)}
    psi_br_shoup: np.ndarray
    psi_inv_br: np.ndarray
    psi_inv_br_shoup: np.ndarray
    n_inv: int
    n_inv_shoup: int
    r32: int  # 2^32 mod q, for the polymul kernel's product
    r32_shoup: int


@lru_cache(maxsize=None)
def ntt32_plan(q: int, n: int) -> Ntt32Plan:
    assert n & (n - 1) == 0
    assert q < (1 << 31), "u32 NTT needs q < 2^31"
    log_n = n.bit_length() - 1
    assert (q - 1) % (2 * n) == 0, f"q={q} is not NTT-friendly for n={n}"
    psi = two_adic_generator(q, log_n + 1)
    rev = bit_reverse_indices(n)
    pow_list = []
    acc = 1
    for _ in range(n):
        pow_list.append(acc)
        acc = acc * psi % q
    inv_list = [mod_inverse(p, q) for p in pow_list]
    psi_br = np.array(pow_list, dtype=np.uint32)[rev]
    psi_inv_br = np.array(inv_list, dtype=np.uint32)[rev]
    n_inv = mod_inverse(n % q, q)
    return Ntt32Plan(
        q=q,
        n=n,
        log_n=log_n,
        zq=Zq32Params(q),
        psi_br=psi_br,
        psi_br_shoup=shoup32(psi_br, q),
        psi_inv_br=psi_inv_br,
        psi_inv_br_shoup=shoup32(psi_inv_br, q),
        n_inv=n_inv,
        n_inv_shoup=int(shoup32(n_inv, q)[()]),
        r32=(1 << 32) % q,
        r32_shoup=int(shoup32((1 << 32) % q, q)[()]),
    )


class PlanTables(NamedTuple):
    """A plan's twiddle tables as int32 tensors on one device; each (n,) for
    one plan, or (K, n) stacked over the primes of a CRT plan."""

    psi: torch.Tensor
    psi_s: torch.Tensor
    psi_inv: torch.Tensor
    psi_inv_s: torch.Tensor


def stack_tables(plans, device) -> PlanTables:
    return PlanTables(
        *(
            u32_to_torch(np.stack([getattr(p, f) for p in plans]), device)
            for f in ("psi_br", "psi_br_shoup", "psi_inv_br", "psi_inv_br_shoup")
        )
    )


@lru_cache(maxsize=None)
def plan_tables(plan: Ntt32Plan, device: torch.device) -> PlanTables:
    return PlanTables(*(t[0] for t in stack_tables([plan], device)))


# ---------------------------------------------------------------------------
# Plain versions: radix-2 layers in int64, written from the JAX semantics.
# Inputs are int32 residues in [0, q); outputs likewise.
# ---------------------------------------------------------------------------


def ntt32_ref(x: torch.Tensor, plan: Ntt32Plan) -> torch.Tensor:
    """Forward negacyclic NTT over the last axis (normal -> bit-reversed)."""
    n, q = plan.n, plan.q
    psi = plan_tables(plan, x.device).psi.long()
    batch = x.shape[:-1]
    out = x.long()
    for layer in range(plan.log_n):
        m = 1 << layer
        x4 = out.reshape(*batch, m, 2, n >> (layer + 1))
        u, v = x4[..., 0, :], x4[..., 1, :]
        tv = mul_mod32(v, psi[m : 2 * m, None], q)
        out = torch.stack([add_mod32(u, tv, q), sub_mod32(u, tv, q)], dim=-2).reshape(*batch, n)
    return out.to(torch.int32)


def intt32_ref(x: torch.Tensor, plan: Ntt32Plan) -> torch.Tensor:
    """Inverse negacyclic NTT over the last axis (bit-reversed -> normal)."""
    n, q = plan.n, plan.q
    psi_inv = plan_tables(plan, x.device).psi_inv.long()
    batch = x.shape[:-1]
    out = x.long()
    for layer in reversed(range(plan.log_n)):
        m = 1 << layer
        x4 = out.reshape(*batch, m, 2, n >> (layer + 1))
        u, v = x4[..., 0, :], x4[..., 1, :]
        d = mul_mod32(sub_mod32(u, v, q), psi_inv[m : 2 * m, None], q)
        out = torch.stack([add_mod32(u, v, q), d], dim=-2).reshape(*batch, n)
    return mul_mod32(out, plan.n_inv, q).to(torch.int32)


def pointwise_mul32(a: torch.Tensor, b: torch.Tensor, plan: Ntt32Plan) -> torch.Tensor:
    """Evaluation-basis pointwise product mod q of int32 residues
    (`learn_fhe_tpu/ops/ntt32.py:704`)."""
    return mul_mod32(a.long(), b.long(), plan.q).to(torch.int32)


def negacyclic_mul32_ref(a: torch.Tensor, b: torch.Tensor, plan: Ntt32Plan) -> torch.Tensor:
    """Negacyclic product mod q: INTT(NTT(a) * NTT(b))."""
    return intt32_ref(pointwise_mul32(ntt32_ref(a, plan), ntt32_ref(b, plan), plan), plan)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name: str, x: torch.Tensor, plan: Ntt32Plan) -> int:
    if not 1 <= plan.log_n <= MAX_LOG_N:
        raise ValueError(f"{name}: the kernel takes 2 <= n <= {1 << MAX_LOG_N}, got {plan.n}")
    kernels.require(name, x, torch.int32)
    if x.dim() == 0 or x.shape[-1] != plan.n:
        raise ValueError(f"{name}: last axis must be n={plan.n}, got {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads and writes rows with 16-byte accesses; x is not 16-byte aligned")
    return x.numel() // plan.n


@lru_cache(maxsize=None)
def _table_pointers(plan: Ntt32Plan, device: int) -> tuple[int, int, int, int]:
    """Device pointers of the plan's tables on CUDA device `device`, which
    `plan_tables`' cache keeps alive: a wrapper call reads them here rather
    than from four tensors."""
    return tuple(t.data_ptr() for t in plan_tables(plan, torch.device("cuda", device)))


OCCUPANCY_KINDS = ("ntt32", "intt32", "negacyclic_mul32")


def occupancy(kind: str, log_n: int) -> dict[str, int]:
    """The kernel instance that `kind` (OCCUPANCY_KINDS) launches at N =
    2^log_n on the current CUDA device: threads a block, dynamic shared
    memory bytes and blocks an SM (the CUDA occupancy calculator); no
    instance launches a cluster. Host only: no launch."""
    out = np.zeros(3, dtype=np.int32)
    status = kernels.call("lft_ntt32_occupancy", OCCUPANCY_KINDS.index(kind), log_n, out.ctypes.data)
    if status != 0:
        raise RuntimeError(f"occupancy({kind}, {log_n}): CUDA error {status}")
    return dict(zip(("threads", "smem", "blocks_per_sm"), (int(v) for v in out)))


def ntt32(x: torch.Tensor, plan: Ntt32Plan) -> torch.Tensor:
    """Forward NTT of every row of x (int32 residues in [0, q))."""
    if x.is_cpu:
        return ntt32_ref(x, plan)
    rows = _check("ntt32", x, plan)
    y = torch.empty_like(x)
    if rows:
        psi, psi_s, _, _ = _table_pointers(plan, x.get_device())
        kernels.launch("lft_ntt32_fwd", x.data_ptr(), y.data_ptr(), psi, psi_s, rows, plan.log_n, plan.q)
        ntt32.launches += 1
    return y


def intt32(x: torch.Tensor, plan: Ntt32Plan) -> torch.Tensor:
    """Inverse NTT of every row of x (int32 residues in [0, q))."""
    if x.is_cpu:
        return intt32_ref(x, plan)
    rows = _check("intt32", x, plan)
    y = torch.empty_like(x)
    if rows:
        _, _, psi_inv, psi_inv_s = _table_pointers(plan, x.get_device())
        kernels.launch(
            "lft_ntt32_inv", x.data_ptr(), y.data_ptr(), psi_inv, psi_inv_s, rows, plan.log_n, plan.q,
            plan.n_inv, plan.n_inv_shoup,
        )  # fmt: skip
        intt32.launches += 1
    return y


def negacyclic_mul32(a: torch.Tensor, b: torch.Tensor, plan: Ntt32Plan) -> torch.Tensor:
    """Row-wise negacyclic product mod q of two equal-shape residue tensors."""
    if a.is_cpu:
        return negacyclic_mul32_ref(a, b, plan)
    rows = _check("negacyclic_mul32", a, plan)
    _check("negacyclic_mul32", b, plan)
    kernels.require("negacyclic_mul32", b, torch.int32, a.shape)
    if plan.q < 1 << 30:  # K-POLYMUL's product takes only 2^30 < q < 2^31
        return intt32(pointwise_mul32(ntt32(a, plan), ntt32(b, plan), plan), plan)
    y = torch.empty_like(a)
    if rows:
        kernels.launch(
            "lft_negacyclic_mul32", a.data_ptr(), b.data_ptr(), y.data_ptr(),
            *_table_pointers(plan, a.get_device()), rows, plan.log_n, plan.q, plan.n_inv, plan.n_inv_shoup,
            plan.r32, plan.r32_shoup,
        )  # fmt: skip
        negacyclic_mul32.launches += 1
    return y


ntt32.launches = 0
intt32.launches = 0
negacyclic_mul32.launches = 0
