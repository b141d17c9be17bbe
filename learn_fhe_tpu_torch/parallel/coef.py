"""Coefficient-axis (N) sharded negacyclic NTT over ranks
(`learn_fhe_tpu/parallel/coef.py`), for the u64 / RNS engine.

The coefficient axis is split contiguously over D ranks, and the full-size
merged-twist transform is split in place:
- layers 0 .. log2(D)-1 pair value j with j + N / 2^(l+1), always on the
  partner rank r XOR D >> (l+1) at the same local offset, under the twiddle
  psi_br[2^l + (r >> (log2(D) - l))], one scalar per rank and limb. Each
  such layer is one exchange of the local block with the partner
  (`distributed.exchange`: one `batch_isend_irecv`) and, but for the
  forward's last, one launch of K-COEF-CROSS (`coef_cross`,
  `csrc/coef.cu`);
- layers log2(D) .. are local: each rank runs the tail of the transform on
  its block with K-RNS-NTT on a per-rank plan (`local_plan`) whose table is
  T[r][k] = psi_br[(D + r) msb(k) + k - msb(k)], the JAX package's
  `local_psi[r]`.
The forward's last cross layer runs inside the local tail's first pass,
which reads every value of the block anyway: it reads the partner's block
too and makes each value's pair in registers (`coef_ntt_tail`, K-RNS-NTT's
fused instances `lft_rns_ntt_cross`), one launch and one write and read
of the block fewer than the layer's own launch. That covers local rings up
to 2^13 (`TAIL_LOG_N`); past it the layer keeps its own launch before
K-RNS-NTT. The inverse runs the local tail first, then the cross layers
in reverse: each layer combines the partner's tail output, which the
exchange brings only after the tail, so every inverse layer keeps its
K-COEF-CROSS launch.
Its local plan carries the full n^-1 as its scale: every step is exact mod
q and the cross layers are linear, so scaling before them gives the JAX
package's canonical values, which scales after them. The product
(`coef_sharded_mul`) is the two forward transforms, then the pointwise
product inside the local inverse tail (`rns_intt_mac` of one term, scaled
by n^-1 2^64), then the cross layers; a and b go in one exchange a
forward layer. Every value equals the unsharded
transform's (`ops/rns.py` `rns_ntt`, `rns_intt`, `rns_mul`).

Every rank calls the entry points with its own shard (`shard_coef`) and
gets its shard of the result; `mesh.gather(mesh, y, AXIS, -1)` puts it
together. The plain version of K-COEF-CROSS is `coef_cross_ref`, the JAX
package's layer body in torch, and that of the fused launch
`coef_ntt_tail_ref` (`coef_cross_ref`, then the plain K-RNS-NTT); the
wrappers run them only for CPU tensors.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.rns import (
    RnsPlan, _ntt_ptrs, add_mod_v, mul_shoup_v, rns_intt, rns_intt_mac, rns_ntt, rns_ntt_ref, rns_plan, rns_tables, sub_mod_v,
)  # fmt: skip
from ..ops.modular import shoup_precompute
from ..utils import kernels
from ..utils.interop import u64_to_torch
from .distributed import exchange
from .mesh import axis_mesh, coord, shard

AXIS = "coef"
TAIL_LOG_N = 13  # the fused forward tails' largest local ring (K-RNS-NTT's and K-NTT's instances up to 2^13)


def coef_mesh(n_coef: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D 'coef' mesh over every rank."""
    return axis_mesh(AXIS, n_coef, device_type)


def shard_coef(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous slice of x's trailing coefficient axis."""
    return shard(mesh, x, AXIS, -1)


@dataclass(frozen=True, eq=False)
class CoefNttPlan:
    """Host tables for a D-way coefficient-sharded (qs, n) NTT: the JAX
    package's, value for value."""

    qs: tuple[int, ...]
    n: int
    d: int  # ranks along the coef axis
    log_d: int
    # cross-shard layer twiddles, per (layer, rank, limb): (log_d, D, L, 1)
    cross_tw: np.ndarray
    cross_tw_shoup: np.ndarray
    cross_tw_inv: np.ndarray
    cross_tw_inv_shoup: np.ndarray
    # per-rank local tables, plan-table layout: (D, L, n/D)
    local_psi: np.ndarray
    local_psi_shoup: np.ndarray
    local_psi_inv: np.ndarray
    local_psi_inv_shoup: np.ndarray
    # the full ring's n^-1 per limb (L, 1), the local tails' scale
    n_inv: np.ndarray
    n_inv_shoup: np.ndarray


def cross_table(table: np.ndarray, d: int) -> np.ndarray:
    """out[l, r] = table[..., 2^l + (r >> (log2 d - l))]: (log_d, d, *lead)."""
    log_d = d.bit_length() - 1
    out = np.empty((log_d, d, *table.shape[:-1]), dtype=table.dtype)
    for l in range(log_d):
        for r in range(d):
            out[l, r] = table[..., (1 << l) + (r >> (log_d - l))]
    return out


def local_table(table: np.ndarray, d: int) -> np.ndarray:
    """T[r][..., k] = table[..., (d + r) msb(k) + (k - msb(k))], T[r][..., 0]
    = table[..., 0] (unused): (d, *lead, n/d)."""
    m = table.shape[-1] // d
    out = np.empty((d, *table.shape[:-1], m), dtype=table.dtype)
    out[..., 0] = table[..., 0]
    for k in range(1, m):
        msb = 1 << (k.bit_length() - 1)
        out[..., k] = np.moveaxis(table[..., (d + np.arange(d)) * msb + (k - msb)], -1, 0)
    return out


@lru_cache(maxsize=None)
def coef_ntt_plan(qs: tuple[int, ...], n: int, d: int) -> CoefNttPlan:
    assert d & (d - 1) == 0 and d >= 1
    assert n % d == 0 and n // d >= 2, (n, d)
    base = rns_plan(qs, n)
    cross = lambda t: cross_table(t, d)[..., None]  # noqa: E731
    local = lambda t: local_table(t, d)  # noqa: E731
    return CoefNttPlan(
        qs=qs,
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
def local_plan(plan: CoefNttPlan, rank: int) -> RnsPlan:
    """K-RNS-NTT's plan for rank `rank`'s local tail: the ring n/D, the
    rank's tables, and the full n's n^-1 (and n^-1 2^64 for `rns_intt_mac`)."""
    n_inv_mac = np.array([(int(v) << 64) % q for v, q in zip(plan.n_inv[:, 0], plan.qs)], dtype=np.uint64)[:, None]
    return replace(
        rns_plan(plan.qs, plan.n // plan.d),
        psi_br=plan.local_psi[rank],
        psi_br_shoup=plan.local_psi_shoup[rank],
        psi_inv_br=plan.local_psi_inv[rank],
        psi_inv_br_shoup=plan.local_psi_inv_shoup[rank],
        n_inv=plan.n_inv,
        n_inv_shoup=plan.n_inv_shoup,
        n_inv_mac=n_inv_mac,
        n_inv_mac_shoup=np.array([int(shoup_precompute(int(v), q)) for v, q in zip(n_inv_mac[:, 0], plan.qs)], dtype=np.uint64)[:, None],
    )


# ---------------------------------------------------------------------------
# K-COEF-CROSS: one cross-shard layer
# ---------------------------------------------------------------------------


def _upper(plan, layer: int, rank: int) -> bool:
    """Whether rank `rank` keeps the upper value of layer `layer`'s pairs."""
    return bool((rank >> (plan.log_d - layer - 1)) & 1)


@lru_cache(maxsize=None)
def _cross_tables(plan: CoefNttPlan, layer: int, rank: int, inverse: bool, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The (L,) twiddles and Shoup duals of rank `rank` at `layer`, on `device`."""
    t, ts = (plan.cross_tw_inv, plan.cross_tw_inv_shoup) if inverse else (plan.cross_tw, plan.cross_tw_shoup)
    return u64_to_torch(np.ascontiguousarray(t[layer, rank, :, 0]), device), u64_to_torch(np.ascontiguousarray(ts[layer, rank, :, 0]), device)


def coef_cross_ref(x: torch.Tensor, recv: torch.Tensor, plan: CoefNttPlan, layer: int, rank: int, inverse: bool) -> torch.Tensor:
    """The JAX package's layer body (`coef.py:157-167` forward, `:180-190`
    inverse) on (..., L, n/D) int64 blocks."""
    upper = _upper(plan, layer, rank)
    t, ts = (v[:, None] for v in _cross_tables(plan, layer, rank, inverse, x.device))
    q = rns_tables(rns_plan(plan.qs, plan.n), x.device).q
    u, v = (recv, x) if upper else (x, recv)
    if inverse:
        return mul_shoup_v(sub_mod_v(u, v, q), t, ts, q) if upper else add_mod_v(u, v, q)
    tv = mul_shoup_v(v, t, ts, q)
    return sub_mod_v(u, tv, q) if upper else add_mod_v(u, tv, q)


def _check_blocks(name: str, x: torch.Tensor, recv: torch.Tensor, plan: CoefNttPlan) -> int:
    """Rows of the equal, contiguous, 16-byte aligned (..., L, n/D) int64
    CUDA blocks x and recv (a row of an even length)."""
    m, limbs = plan.n // plan.d, len(plan.qs)
    for t in (x, recv):
        kernels.require(name, t, torch.int64, x.shape)
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel moves 16-byte words; an operand is not 16-byte aligned")
    if x.dim() < 2 or x.shape[-2:] != (limbs, m) or m % 2:
        raise ValueError(f"{name}: expected (..., {limbs}, {m}) with an even row, got {tuple(x.shape)}")
    return x.numel() // m


def coef_cross(x: torch.Tensor, recv: torch.Tensor, plan: CoefNttPlan, layer: int, rank: int, inverse: bool = False) -> torch.Tensor:
    """Cross-shard layer `layer` of rank `rank`: its block x and its
    partner's block recv, (..., L, n/D) int64, in one K-COEF-CROSS launch."""
    if x.is_cpu:
        return coef_cross_ref(x, recv, plan, layer, rank, inverse)
    rows, limbs = _check_blocks("coef_cross", x, recv, plan), len(plan.qs)
    m = plan.n // plan.d
    y = torch.empty_like(x)
    if rows:
        t, ts = _cross_tables(plan, layer, rank, inverse, x.device)
        q = rns_tables(rns_plan(plan.qs, plan.n), x.device).q
        kernels.launch(
            "lft_coef_cross64", x.data_ptr(), recv.data_ptr(), y.data_ptr(), t.data_ptr(), ts.data_ptr(), q.data_ptr(),
            rows, m // 2, limbs, int(_upper(plan, layer, rank)), int(inverse),
        )  # fmt: skip
        coef_cross.launches += 1
    return y


coef_cross.launches = 0


# ---------------------------------------------------------------------------
# The forward's last cross-shard layer inside the local tail's first pass
# ---------------------------------------------------------------------------


def coef_ntt_tail_ref(x: torch.Tensor, recv: torch.Tensor, plan: CoefNttPlan, rank: int) -> torch.Tensor:
    """The forward's last cross-shard layer (`coef_cross_ref` of layer
    log2(D) - 1), then the plain local tail on rank `rank`'s plan."""
    return rns_ntt_ref(coef_cross_ref(x, recv, plan, plan.log_d - 1, rank, False), local_plan(plan, rank))


def coef_ntt_tail(x: torch.Tensor, recv: torch.Tensor, plan: CoefNttPlan, rank: int) -> torch.Tensor:
    """The forward's last cross-shard layer and the local tail of rank
    `rank`'s block x with its partner's block recv at that layer, (..., L,
    n/D) int64, local ring n/D <= 2^TAIL_LOG_N: one launch of K-RNS-NTT's
    fused instance, which makes each value's pair as its first pass loads
    x and recv."""
    if x.is_cpu:
        return coef_ntt_tail_ref(x, recv, plan, rank)
    lp, layer = local_plan(plan, rank), plan.log_d - 1
    if plan.log_d < 1 or lp.log_n > TAIL_LOG_N:
        raise ValueError(f"coef_ntt_tail: the fused instances take D >= 2 and n/D <= {1 << TAIL_LOG_N}, got D = {plan.d}, n/D = {lp.n}")
    rows = _check_blocks("coef_ntt_tail", x, recv, plan)
    y = torch.empty_like(x)
    if rows:
        t, ts = _cross_tables(plan, layer, rank, False, x.device)
        kernels.launch(
            "lft_rns_ntt_cross", x.data_ptr(), recv.data_ptr(), y.data_ptr(), *_ntt_ptrs(rns_tables(lp, x.device)),
            t.data_ptr(), ts.data_ptr(), rows, len(plan.qs), lp.log_n, int(max(plan.qs) < 1 << 62),
            int(_upper(plan, layer, rank)),
        )  # fmt: skip
        coef_ntt_tail.launches += 1
    return y


coef_ntt_tail.launches = 0


# ---------------------------------------------------------------------------
# The sharded transforms, per rank
# ---------------------------------------------------------------------------


def _partner(plan, layer: int, rank: int) -> int:
    return rank ^ (plan.d >> (layer + 1))


def _cross_layers(xs: list, plan, rank: int, group, layers, inverse: bool, cross) -> list:
    """Cross-shard layers `layers` (in that order) of the blocks xs: per
    layer one exchange of all of them with the partner rank and one
    `cross` launch each."""
    for layer in layers:
        recv = exchange(xs, _partner(plan, layer, rank), group)
        xs = [cross(x, v, plan, layer, rank, inverse) for x, v in zip(xs, recv)]
    return xs


def _forward(xs: list, plan, rank: int, group, cross, fused, transform, lp) -> list:
    """The forward transforms of the blocks xs on rank `rank`'s local plan
    lp, all blocks in each layer's one exchange: the cross layers
    (`cross`), then the local transform. Up to n/D = 2^TAIL_LOG_N the last
    layer runs inside it (`fused`, one launch); past it, and where D = 1,
    every layer and the transform (`transform`) launch apart."""
    folded = plan.log_d >= 1 and lp.log_n <= TAIL_LOG_N
    xs = _cross_layers(xs, plan, rank, group, range(plan.log_d - folded), False, cross)
    if not folded:
        return [transform(x, lp) for x in xs]
    recv = exchange(xs, _partner(plan, plan.log_d - 1, rank), group)
    return [fused(x, v, plan, rank) for x, v in zip(xs, recv)]


def _inverse_layers(x: torch.Tensor, plan, rank: int, group, cross) -> torch.Tensor:
    """The inverse's cross layers, last to first, on one block."""
    return _cross_layers([x], plan, rank, group, range(plan.log_d - 1, -1, -1), True, cross)[0]


def coef_ntt_local(x: torch.Tensor, plan: CoefNttPlan, rank: int, group=None) -> torch.Tensor:
    """Forward NTT of rank `rank`'s (..., L, n/D) block: the same positions
    of the full bit-reversed-order NTT. `group` holds the D ranks in coef
    order (None: the world)."""
    return _forward([x], plan, rank, group, coef_cross, coef_ntt_tail, rns_ntt, local_plan(plan, rank))[0]


def coef_intt_local(x: torch.Tensor, plan: CoefNttPlan, rank: int, group=None) -> torch.Tensor:
    """Inverse NTT of rank `rank`'s block: the local tail scaled by the full
    n^-1, then the cross layers in reverse."""
    return _inverse_layers(rns_intt(x, local_plan(plan, rank)), plan, rank, group, coef_cross)


def coef_intt_mac_local(xs, ys, plan: CoefNttPlan, rank: int, group=None, zs=None) -> torch.Tensor:
    """The inverse NTT of `rns_mac(xs, ys, ..., zs)` for rank `rank`'s blocks
    of evaluation-basis operands: the sums inside the local inverse tail
    (`rns_intt_mac`), then the cross layers in reverse (both sums in one
    exchange a layer where zs is given: (2, ..., L, n/D))."""
    return _inverse_layers(rns_intt_mac(xs, ys, local_plan(plan, rank), zs), plan, rank, group, coef_cross)


def coef_mul_local(a: torch.Tensor, b: torch.Tensor, plan: CoefNttPlan, rank: int, group=None) -> torch.Tensor:
    """Negacyclic product of rank `rank`'s blocks of a and b: both forward
    transforms (a and b in one exchange a layer), the product inside the
    local inverse tail, the cross layers."""
    ea, eb = _forward([a, b], plan, rank, group, coef_cross, coef_ntt_tail, rns_ntt, local_plan(plan, rank))
    return coef_intt_mac_local([ea], [eb], plan, rank, group)


def _plan_of(mesh: DeviceMesh, x: torch.Tensor, qs: tuple[int, ...]) -> tuple[CoefNttPlan, int, object]:
    rank, d = coord(mesh, AXIS)
    return coef_ntt_plan(tuple(qs), x.shape[-1] * d, d), rank, mesh.get_group(AXIS)


def coef_sharded_ntt(mesh: DeviceMesh, x: torch.Tensor, qs: tuple[int, ...]) -> torch.Tensor:
    """This rank's shard of the NTT of the (..., L, N) tensor whose shard x is."""
    plan, rank, group = _plan_of(mesh, x, qs)
    return coef_ntt_local(x, plan, rank, group)


def coef_sharded_intt(mesh: DeviceMesh, x: torch.Tensor, qs: tuple[int, ...]) -> torch.Tensor:
    plan, rank, group = _plan_of(mesh, x, qs)
    return coef_intt_local(x, plan, rank, group)


def coef_sharded_mul(mesh: DeviceMesh, a: torch.Tensor, b: torch.Tensor, qs: tuple[int, ...]) -> torch.Tensor:
    """This rank's shard of the negacyclic product; equal to `ops.rns.rns_mul`'s."""
    plan, rank, group = _plan_of(mesh, a, qs)
    return coef_mul_local(a, b, plan, rank, group)
