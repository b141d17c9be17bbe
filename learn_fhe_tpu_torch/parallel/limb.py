"""Limb-sharded CKKS and BGV multiplies and key switches over torch.distributed:
what XLA's partitioner makes of `C.mul`, `G.mul` and `C.rotate` in the JAX
package when their RNS limbs are sharded (`__graft_entry__.py:134-165,
272-298, 315-335, 337-358`), written out with explicit collectives.

Every function takes this rank's shards and returns this rank's shard. A
sharded ciphertext keeps its whole level in `qs`; its b and a hold this
rank's limbs of it, cut as `mesh.limb_bounds` cuts them (contiguous, the
first ranks one limb more), on the mesh's 'limb' axis. A rank's rows of the
QP basis are its limbs of qs, then its limbs of ps (`qp_rows`): the
key-switching key's rows it holds (`limb_ksk`).

Per-limb work stays on the rank: the forward transforms, the tensor's sums
inside `rns_intt_mac`, the key's dot, the adds. Only the contractions over
the limb axis need every limb: the base extension in the hoist, the
division by P (a base conversion of the p limbs), and the rescale (CKKS) or
the t-corrected drop (BGV) by the last q limb. For those a rank swaps its
(L_r, N) limbs for an (L, N / n_limb) block of columns holding every limb,
with one `all_to_all`, runs the unsharded code on whole columns, and swaps
back. On whole columns the base extension's f64 overflow count is summed
one fused multiply-add per limb in limb order from 0, as unsharded: partial
sums per shard, added afterwards, would round otherwise. So every output
equals the unsharded one, bit for bit, and a `mul` issues 4 collectives
(JAX's GSPMD: 26-36):
1. d2: limbs -> columns; K-BASECONV extends each key-switch digit to QP;
2. the extension: columns -> this rank's QP rows; K-RNS-NTT and the key's
   dot (`rns_intt_mac`) local;
3. the dot's sums with d0 and d1: limbs -> columns in one exchange; the
   division by P and the rescale by q_L (K-BASECONV and K-RESCALE; BGV: one
   K-BGV-DROP launch);
4. the result: columns -> the limbs of the new level.

`sharded_rotate_2d` shards the coefficients too, over the mesh's 'batch'
axis: the automorphism gathers the coefficient axis (one all_gather), the
column swaps run inside the 'limb' group over the rank's coefficient block,
and the transforms are the coefficient-sharded ones (`parallel/coef.py`,
log2(n_batch) exchanges each way, K-COEF-CROSS): 5 + 2 log2(n_batch)
collectives. `digit_sharded_mul` shards the key-switch digits instead (the
dnum ladder, whose limb count need not split): each rank hoists and dots its
own digits, the ranks' partial sums are all-gathered and added mod q in
rank order (one collective; exact, as a raw int64 sum of 59-bit residues
may not be), and every rank finishes the whole result.

A column block must be a power of two (K-BASECONV and K-RESCALE take the
ring's log), so N / n_limb is. Each rank needs at least one q limb at the
input; the output level may leave a rank none. JAX's GSPMD pads instead;
`ValueError` here.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..models.bgv import bgv as G
from ..models.ckks import ckks as C
from ..ops.rns import automorphism_rns, rescale_k, rns_add, rns_ntt
from .coef import coef_intt_mac_local, coef_ntt_local, coef_ntt_plan
from .distributed import all_gather, all_to_all
from .mesh import coord, limb_bounds, limb_sizes

AXIS = "limb"


def qp_rows(params, qs: tuple, rank: int, n_limb: int) -> tuple[tuple, tuple]:
    """Rank `rank`'s primes of level qs and of params.ps: its QP rows are the
    first, then the second. Raises where the rank would hold no q limb."""
    if len(qs) < n_limb:
        raise ValueError(f"{len(qs)} q limbs over {n_limb} 'limb' ranks would leave a rank none")
    (s, e), (ps, pe) = limb_bounds(len(qs), n_limb)[rank], limb_bounds(len(params.ps), n_limb)[rank]
    return qs[s:e], params.ps[ps:pe]


def _layout(name: str, mesh: DeviceMesh, n: int) -> tuple[int, int]:
    """This rank's position on 'limb' and the axis' size, after checking that
    ring n splits over it into power-of-two column blocks."""
    r, size = coord(mesh, AXIS)
    c = n // size
    if n % size or c < 2 or c & (c - 1):
        raise ValueError(f"{name}: N = {n} over {size} ranks is not a power-of-two block of columns")
    return r, size


def _check(name: str, x: torch.Tensor, limbs: int) -> None:
    if x.shape[-2] != limbs:
        raise ValueError(f"{name}: this rank's shard has {x.shape[-2]} limbs, its share of the level is {limbs}")


def _to_columns(xs, sizes, group):
    """Each x (..., L_r, N), this rank's limbs of an L-limb tensor split as
    `sizes` (a list per x) -> (..., L, N / n): every limb of this rank's
    column block. One all_to_all for all of xs."""
    return all_to_all(list(xs), group, split_axis=-1, cat_axis=-2, cat_sizes=sizes)


def _to_limbs(xs, sizes, group):
    """`_to_columns` reversed: each x (..., L, c) -> (..., L_r, n c)."""
    return all_to_all(list(xs), group, split_axis=-2, cat_axis=-1, split_sizes=sizes)


def _hoist_rows(params, ext: torch.Tensor, d2: torch.Tensor, sq, sp, group) -> torch.Tensor:
    """The extension ext (..., D, L + P, c) over qs + ps, on columns -> this
    rank's QP rows (..., D, L_r + P_r, N). With one digit its q rows are
    d2's own limbs, so only the p rows travel."""
    L = sum(sq)
    if ext.shape[-3] == 1:
        (ep,) = _to_limbs([ext[..., L:, :]], [sp], group)
        return torch.cat([d2.unsqueeze(-3), ep], dim=-2)
    eq, ep = _to_limbs([ext[..., :L, :], ext[..., L:, :]], [sq, sp], group)
    return torch.cat([eq, ep], dim=-2)


def _sums_to_columns(ba: torch.Tensor, lq: int, more, sq, sp, group) -> tuple[torch.Tensor, list]:
    """The key's sums ba (2, ..., L_r + P_r, N) on this rank's QP rows, and
    the tensors `more` (..., L_r, N), to columns in one exchange: (2, ...,
    L + P, c) and each of more (..., L, c)."""
    bq, bp, *rest = _to_columns([ba[..., :lq, :], ba[..., lq:, :], *more], [sq, sp, *[sq] * len(more)], group)
    return torch.cat([bq, bp], dim=-2), rest


# ---------------------------------------------------------------------------
# The key-switching keys' shards
# ---------------------------------------------------------------------------


def limb_ksk(mesh: DeviceMesh, params, ksk, qs: tuple, coef: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's rows (`qp_rows`) of a CKKS or BGV key-switching key, for a
    ciphertext at level qs: b and a, (D_active, L_r + P_r, N) for CKKS,
    (L_r + P_r, N) for BGV. With coef, CKKS's block of the evaluation
    basis's columns at this rank's 'batch' position too (`sharded_rotate_2d`)."""
    r, n = coord(mesh, AXIS)
    rows = sum(qp_rows(params, qs, r, n), ())
    if isinstance(ksk, G.BgvKeySwitchingKey):
        return tuple(t.contiguous() for t in ksk.rows(rows))
    kb, ka = C.ksk_rows(params, ksk, qs, rows)
    if coef:
        rb, nb = coord(mesh, "batch")
        m = kb.shape[-1] // nb
        kb, ka = kb[..., rb * m : (rb + 1) * m], ka[..., rb * m : (rb + 1) * m]
    return kb.contiguous(), ka.contiguous()


def digit_ksk(mesh: DeviceMesh, params: C.CkksParams, ksk: C.CkksKeySwitchingKey, qs: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's digits (`limb_bounds` over 'limb') of a CKKS key's active
    digits at level qs, every QP row: b and a, (D_r, L + P, N)."""
    r, n = coord(mesh, AXIS)
    lo, hi = limb_bounds(len(params.digit_slices(len(qs))), n)[r]
    kb, ka = C.ksk_rows(params, ksk, qs, qs + params.ps)
    return kb[lo:hi].contiguous(), ka[lo:hi].contiguous()


# ---------------------------------------------------------------------------
# The sharded operations
# ---------------------------------------------------------------------------


def limb_sharded_mul(mesh: DeviceMesh, params: C.CkksParams, rlk, ct0: C.CkksCiphertext, ct1: C.CkksCiphertext) -> C.CkksCiphertext:
    """This rank's shard of `ckks.mul(params, rlk, ct0, ct1)`, from this
    rank's shards of ct0 and ct1 (limbs over 'limb') and its rows of rlk
    (`limb_ksk`): 4 all_to_alls."""
    name = "limb_sharded_mul"
    ct0, ct1, qs = C._align(ct0, ct1)
    L, n_cols = len(qs), ct0.b.shape[-1]
    r, n = _layout(name, mesh, n_cols)
    group = mesh.get_group(AXIS)
    sq, sp = limb_sizes(L, n), limb_sizes(len(params.ps), n)
    qs_r, ps_r = qp_rows(params, qs, r, n)
    for x in (ct0.b, ct0.a, ct1.b, ct1.a):
        _check(name, x, len(qs_r))
    ct0, ct1 = C._broadcast(ct0, ct1, qs)
    d0, d1, d2 = C._tensor(ct0, ct1, params.plan(qs_r))
    (d2c,) = _to_columns([d2], [sq], group)
    ext = _hoist_rows(params, C._ks_extend(params, d2c, qs), d2, sq, sp, group)
    plan = params.plan(qs_r + ps_r)
    ba = C._ks_macs(rns_ntt(ext, plan), *rlk, plan)
    ba, (d0c, d1c) = _sums_to_columns(ba, len(qs_r), (d0, d1), sq, sp, group)
    out = C._mul_finish(params, ba, d0c, d1c, qs)
    b, a = _to_limbs([out.b, out.a], [limb_sizes(L - 1, n)] * 2, group)
    return C.CkksCiphertext(b, a, out.qs)


def limb_sharded_bgv_mul(mesh: DeviceMesh, params: G.BgvParams, rlk, ct0: G.BgvCiphertext, ct1: G.BgvCiphertext) -> G.BgvCiphertext:
    """This rank's shard of `bgv.mul(params, rlk, ct0, ct1)`, as
    `limb_sharded_mul`; the division by P, the adds and the mod-switch drop
    are one K-BGV-DROP launch on the columns."""
    name = "limb_sharded_bgv_mul"
    if ct0.qs != ct1.qs:
        raise ValueError(f"{name}: mod_switch the operands to a common level first")
    qs = ct0.qs
    L = len(qs)
    r, n = _layout(name, mesh, ct0.b.shape[-1])
    group = mesh.get_group(AXIS)
    sq, sp = limb_sizes(L, n), limb_sizes(len(params.ps), n)
    qs_r, ps_r = qp_rows(params, qs, r, n)
    ops = G._operands(ct0, ct1)
    for x in ops:
        _check(name, x, len(qs_r))
    d0, d1, d2 = G._tensor(*ops, params.plan(qs_r))
    (d2c,) = _to_columns([d2], [sq], group)
    ext = _hoist_rows(params, G._ks_extend(params, d2c, qs).unsqueeze(-3), d2, sq, sp, group).squeeze(-3)
    ba = G._ks_macs(ext, *rlk, params.plan(qs_r + ps_r))
    ba, (d0c, d1c) = _sums_to_columns(ba, len(qs_r), (d0, d1), sq, sp, group)
    b, a = _to_limbs(G._mul_finish(params, ba, d0c, d1c, qs), [limb_sizes(L - 1, n)] * 2, group)
    return G.BgvCiphertext(b, a, qs[:-1], G._mul_factor(params, ct0, ct1))


def sharded_rotate_2d(mesh: DeviceMesh, params: C.CkksParams, rtk, j: int, ct: C.CkksCiphertext) -> C.CkksCiphertext:
    """This rank's shard of `ckks.rotate(params, CkksRotKey(ksk, j), ct)`,
    with ct's limbs over 'limb' and its coefficients over 'batch' (JAX's
    `P("limb", "batch")`), from this rank's block of ct and its rows and
    block of the key (`limb_ksk(..., coef=True)`)."""
    name = "sharded_rotate_2d"
    qs = ct.qs
    L = len(qs)
    rb, nb = coord(mesh, "batch")
    n_full = ct.b.shape[-1] * nb
    r, n = _layout(name, mesh, ct.b.shape[-1])
    gl, gb = mesh.get_group(AXIS), mesh.get_group("batch")
    sq, sp = limb_sizes(L, n), limb_sizes(len(params.ps), n)
    qs_r, ps_r = qp_rows(params, qs, r, n)
    for x in (ct.b, ct.a):
        _check(name, x, len(qs_r))
    # the automorphism crosses coefficient blocks: gather them, permute, cut
    whole = all_gather(torch.stack([ct.b, ct.a]), gb, -1)
    m = ct.b.shape[-1]
    mb, ma = (x[..., rb * m : (rb + 1) * m].contiguous() for x in automorphism_rns((whole[0], whole[1]), params.pow5(j), qs_r))
    (ac,) = _to_columns([ma], [sq], gl)
    ext = _hoist_rows(params, C._ks_extend(params, ac, qs), ma, sq, sp, gl)
    plan = coef_ntt_plan(qs_r + ps_r, n_full, nb)
    ae = coef_ntt_local(ext, plan, rb, gb)
    kb, ka = rtk
    D = ae.shape[-3]
    ba = coef_intt_mac_local(C._digits(ae), [kb[d] for d in range(D)], plan, rb, gb, [ka[d] for d in range(D)])
    ba, _ = _sums_to_columns(ba, len(qs_r), (), sq, sp, gl)
    sw = rescale_k(ba, qs + params.ps, len(params.ps))
    sb, sa = _to_limbs([sw[0], sw[1]], [sq, sq], gl)
    return C.CkksCiphertext(rns_add(sb, mb, params.plan(qs_r)), sa, qs)


def digit_sharded_mul(mesh: DeviceMesh, params: C.CkksParams, rlk, ct0: C.CkksCiphertext, ct1: C.CkksCiphertext) -> C.CkksCiphertext:
    """`ckks.mul(params, rlk, ct0, ct1)` with the key-switch digits over
    'limb': ct0 and ct1 whole on every rank, rlk this rank's digits
    (`digit_ksk`). Each rank hoists its digits and contracts them inside
    its own `rns_intt_mac`; one all_gather brings every rank's partial sums,
    added mod q in rank order; every rank returns the whole result."""
    ct0, ct1, qs = C._align(ct0, ct1)
    r, n = coord(mesh, AXIS)
    lo, hi = limb_bounds(len(params.digit_slices(len(qs))), n)[r]
    kb, ka = rlk
    if kb.shape[0] != hi - lo:
        raise ValueError(f"digit_sharded_mul: this rank holds {kb.shape[0]} digits of the key, its share is {hi - lo}")
    ct0, ct1 = C._broadcast(ct0, ct1, qs)
    d0, d1, d2 = C._tensor(ct0, ct1, params.plan(qs))
    qps = qs + params.ps
    plan = params.plan(qps)
    if hi > lo:
        part = C._ks_macs(C._ks_hoist(params, d2, qs, (lo, hi)), kb, ka, plan)
    else:
        part = torch.zeros((2, *d2.shape[:-2], len(qps), d2.shape[-1]), dtype=d2.dtype, device=d2.device)
    parts = all_gather(part.unsqueeze(0), mesh.get_group(AXIS), 0)
    ba = parts[0]
    for p in parts[1:]:
        ba = rns_add(ba, p, plan)
    return C._mul_finish(params, ba, d0, d1, qs)
