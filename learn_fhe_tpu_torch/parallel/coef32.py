"""Coefficient-axis (N) sharded negacyclic NTT for the u32 engine, q < 2^31
(`learn_fhe_tpu/parallel/coef32.py`).

The same split as `parallel/coef.py`: log2(D) cross-shard layers, each one
exchange of the local block with the partner rank and one K-COEF-CROSS
launch (its u32 instance), then the local tail on a per-rank plan; the
forward's last layer runs inside the tail's first pass (`coef32_ntt_tail`,
K-NTT's fused instances `lft_ntt32_fwd_cross`) up to a local ring of
2^13, and keeps its own launch past it. Here the tail is K-NTT / `intt32`
(`ops/ntt32.py`, radix-8 register passes) on the rank's tables, which go
to the kernels by pointer like any plan's; the JAX package runs a radix-2
tail there. Every modular operation returns the
canonical value, so any correct grouping of the layers gives the unsharded
`ntt32` / `intt32` / `negacyclic_mul32` values element for element. The
product exchanges a and b together in each forward layer. Its local part
for 2^30 < q < 2^31 is K-POLYMUL on the rank's plan (`negacyclic_mul32`),
which takes the raw operands, so there every forward layer keeps its
K-COEF-CROSS launch; for a smaller prime (the 28-bit q of FHEW and of
`bench.py`'s scaling metric) the two fused forward tails, `pointwise_mul32`
and one `intt32` launch. The local inverse carries the full n^-1, as in
coef.py.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.modular32 import add_mod32, mul_mod32, sub_mod32
from ..ops.ntt32 import Ntt32Plan, _table_pointers, intt32, negacyclic_mul32, ntt32, ntt32_plan, ntt32_ref, pointwise_mul32
from ..utils import kernels
from .coef import AXIS, TAIL_LOG_N, _cross_layers, _forward, _inverse_layers, _upper, coord, cross_table, local_table


@dataclass(frozen=True, eq=False)
class Coef32Plan:
    """Host tables for a D-way coefficient-sharded (q, n) u32 NTT: the JAX
    package's, value for value."""

    q: int
    n: int
    d: int
    log_d: int
    cross_tw: np.ndarray  # (log_d, D) u32: one twiddle a layer and rank
    cross_tw_shoup: np.ndarray
    cross_tw_inv: np.ndarray
    cross_tw_inv_shoup: np.ndarray
    local_psi: np.ndarray  # (D, n/D) plan-table layout
    local_psi_shoup: np.ndarray
    local_psi_inv: np.ndarray
    local_psi_inv_shoup: np.ndarray
    n_inv: int
    n_inv_shoup: int


@lru_cache(maxsize=None)
def coef32_plan(q: int, n: int, d: int) -> Coef32Plan:
    assert d & (d - 1) == 0 and d >= 1
    assert n % d == 0 and n // d >= 2, (n, d)
    base = ntt32_plan(q, n)
    cross = lambda t: cross_table(t, d)  # noqa: E731
    local = lambda t: local_table(t, d)  # noqa: E731
    return Coef32Plan(
        q=q,
        n=n,
        d=d,
        log_d=d.bit_length() - 1,
        cross_tw=cross(base.psi_br),
        cross_tw_shoup=cross(base.psi_br_shoup),
        cross_tw_inv=cross(base.psi_inv_br),
        cross_tw_inv_shoup=cross(base.psi_inv_br_shoup),
        local_psi=local(base.psi_br),
        local_psi_shoup=local(base.psi_br_shoup),
        local_psi_inv=local(base.psi_inv_br),
        local_psi_inv_shoup=local(base.psi_inv_br_shoup),
        n_inv=base.n_inv,
        n_inv_shoup=base.n_inv_shoup,
    )


@lru_cache(maxsize=None)
def local_plan32(plan: Coef32Plan, rank: int) -> Ntt32Plan:
    """K-NTT's plan for rank `rank`'s local tail: the ring n/D, the rank's
    tables and the full n's n^-1."""
    return replace(
        ntt32_plan(plan.q, plan.n // plan.d),
        psi_br=plan.local_psi[rank],
        psi_br_shoup=plan.local_psi_shoup[rank],
        psi_inv_br=plan.local_psi_inv[rank],
        psi_inv_br_shoup=plan.local_psi_inv_shoup[rank],
        n_inv=plan.n_inv,
        n_inv_shoup=plan.n_inv_shoup,
    )


def _twiddle(plan: Coef32Plan, layer: int, rank: int, inverse: bool) -> tuple[int, int]:
    t, ts = (plan.cross_tw_inv, plan.cross_tw_inv_shoup) if inverse else (plan.cross_tw, plan.cross_tw_shoup)
    return int(t[layer, rank]), int(ts[layer, rank])


def coef32_cross_ref(x: torch.Tensor, recv: torch.Tensor, plan: Coef32Plan, layer: int, rank: int, inverse: bool) -> torch.Tensor:
    """The JAX package's layer body (`coef32.py:148-158` forward, `:171-181`
    inverse) on (..., n/D) int32 blocks."""
    upper = _upper(plan, layer, rank)
    t, _ = _twiddle(plan, layer, rank, inverse)
    q = plan.q
    u, v = (recv.long(), x.long()) if upper else (x.long(), recv.long())
    if inverse:
        out = mul_mod32(sub_mod32(u, v, q), t, q) if upper else add_mod32(u, v, q)
    else:
        tv = mul_mod32(v, t, q)
        out = sub_mod32(u, tv, q) if upper else add_mod32(u, tv, q)
    return out.to(torch.int32)


def _check_blocks(name: str, x: torch.Tensor, recv: torch.Tensor, plan: Coef32Plan) -> int:
    """Rows of the equal, contiguous, 16-byte aligned (..., n/D) int32 CUDA
    blocks x and recv (a row of a multiple of 4)."""
    m = plan.n // plan.d
    for t in (x, recv):
        kernels.require(name, t, torch.int32, x.shape)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel moves 16-byte words; an operand is not 16-byte aligned")
    if x.dim() < 1 or x.shape[-1] != m or m % 4:
        raise ValueError(f"{name}: expected (..., {m}) with a row of a multiple of 4, got {tuple(x.shape)}")
    return x.numel() // m


def coef32_cross(x: torch.Tensor, recv: torch.Tensor, plan: Coef32Plan, layer: int, rank: int, inverse: bool = False) -> torch.Tensor:
    """Cross-shard layer `layer` of rank `rank` on (..., n/D) int32 blocks:
    one launch of K-COEF-CROSS's u32 instance."""
    if x.is_cpu:
        return coef32_cross_ref(x, recv, plan, layer, rank, inverse)
    rows, m = _check_blocks("coef32_cross", x, recv, plan), plan.n // plan.d
    y = torch.empty_like(x)
    if rows:
        t, ts = _twiddle(plan, layer, rank, inverse)
        kernels.launch(
            "lft_coef_cross32", x.data_ptr(), recv.data_ptr(), y.data_ptr(), t, ts, plan.q, rows, m // 4,
            int(_upper(plan, layer, rank)), int(inverse),
        )  # fmt: skip
        coef32_cross.launches += 1
    return y


coef32_cross.launches = 0


def coef32_ntt_tail_ref(x: torch.Tensor, recv: torch.Tensor, plan: Coef32Plan, rank: int) -> torch.Tensor:
    """The forward's last cross-shard layer (`coef32_cross_ref` of layer
    log2(D) - 1), then the plain local K-NTT on rank `rank`'s plan."""
    return ntt32_ref(coef32_cross_ref(x, recv, plan, plan.log_d - 1, rank, False), local_plan32(plan, rank))


def coef32_ntt_tail(x: torch.Tensor, recv: torch.Tensor, plan: Coef32Plan, rank: int) -> torch.Tensor:
    """The forward's last cross-shard layer and the local K-NTT of rank
    `rank`'s (..., n/D) int32 block x with its partner's block recv at that
    layer, n/D <= 2^TAIL_LOG_N: one launch of K-NTT's fused instance, which
    makes each value's pair as its first pass loads x and recv."""
    if x.is_cpu:
        return coef32_ntt_tail_ref(x, recv, plan, rank)
    lp, layer = local_plan32(plan, rank), plan.log_d - 1
    if plan.log_d < 1 or lp.log_n > TAIL_LOG_N:
        raise ValueError(f"coef32_ntt_tail: the fused instances take D >= 2 and n/D <= {1 << TAIL_LOG_N}, got D = {plan.d}, n/D = {lp.n}")
    rows = _check_blocks("coef32_ntt_tail", x, recv, plan)
    y = torch.empty_like(x)
    if rows:
        psi, psi_s, _, _ = _table_pointers(lp, x.get_device())
        t, ts = _twiddle(plan, layer, rank, False)
        kernels.launch(
            "lft_ntt32_fwd_cross", x.data_ptr(), recv.data_ptr(), y.data_ptr(), psi, psi_s, rows, lp.log_n, plan.q, t, ts,
            int(_upper(plan, layer, rank)),
        )  # fmt: skip
        coef32_ntt_tail.launches += 1
    return y


coef32_ntt_tail.launches = 0


def coef32_ntt_local(x: torch.Tensor, plan: Coef32Plan, rank: int, group=None) -> torch.Tensor:
    """Forward u32 NTT of rank `rank`'s (..., n/D) block."""
    return _forward([x], plan, rank, group, coef32_cross, coef32_ntt_tail, ntt32, local_plan32(plan, rank))[0]


def coef32_intt_local(x: torch.Tensor, plan: Coef32Plan, rank: int, group=None) -> torch.Tensor:
    """Inverse u32 NTT of rank `rank`'s block: the local tail scaled by the
    full n^-1, then the cross layers in reverse."""
    return _inverse_layers(intt32(x, local_plan32(plan, rank)), plan, rank, group, coef32_cross)


def coef32_mul_local(a: torch.Tensor, b: torch.Tensor, plan: Coef32Plan, rank: int, group=None) -> torch.Tensor:
    """Negacyclic product of rank `rank`'s blocks (a and b in one exchange a
    forward layer), then the inverse cross layers. For q < 2^30 the two
    forward transforms with their fused tails, the product and the local
    inverse tail; for 2^30 < q < 2^31 the forward cross layers, then
    K-POLYMUL (`negacyclic_mul32`) on the raw blocks, which runs the local
    forward tails, the product and the inverse tail in one launch."""
    lp = local_plan32(plan, rank)
    if plan.q < 1 << 30:  # K-POLYMUL's product takes only 2^30 < q < 2^31
        ea, eb = _forward([a, b], plan, rank, group, coef32_cross, coef32_ntt_tail, ntt32, lp)
        x = intt32(pointwise_mul32(ea, eb, lp), lp)
    else:
        a, b = _cross_layers([a, b], plan, rank, group, range(plan.log_d), False, coef32_cross)
        x = negacyclic_mul32(a, b, lp)
    return _inverse_layers(x, plan, rank, group, coef32_cross)


def _plan_of(mesh: DeviceMesh, x: torch.Tensor, q: int) -> tuple[Coef32Plan, int, object]:
    rank, d = coord(mesh, AXIS)
    return coef32_plan(q, x.shape[-1] * d, d), rank, mesh.get_group(AXIS)


def coef32_sharded_ntt(mesh: DeviceMesh, x: torch.Tensor, q: int) -> torch.Tensor:
    """This rank's shard of the u32 NTT of the (..., N) tensor whose shard x is."""
    plan, rank, group = _plan_of(mesh, x, q)
    return coef32_ntt_local(x, plan, rank, group)


def coef32_sharded_intt(mesh: DeviceMesh, x: torch.Tensor, q: int) -> torch.Tensor:
    plan, rank, group = _plan_of(mesh, x, q)
    return coef32_intt_local(x, plan, rank, group)


def coef32_sharded_mul(mesh: DeviceMesh, a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """This rank's shard of the negacyclic u32 product; equal to
    `ops.ntt32.negacyclic_mul32`'s."""
    plan, rank, group = _plan_of(mesh, a, q)
    return coef32_mul_local(a, b, plan, rank, group)
