"""RNS (CRT-limb) polynomial arithmetic with a stacked limb axis
(`learn_fhe_tpu/ops/rns.py`).

An RNS polynomial is one int64 tensor of shape (..., L, N) holding u64
residues, the limb axis second to last; limb l is reduced mod qs[l]. The
per-limb constants (twiddles, Montgomery factors, CRT hats) are stacked
into (L, ...) tables, so one launch serves every limb. Every function
returns canonical residues, bit-identical to the JAX package's.

Kernels (`csrc/rns64.cu`), each beside its plain PyTorch version (`*_ref`):
- K-RNS-NTT, `rns_ntt` / `rns_intt`: the forward and inverse transforms of
  every row, row r under limb r mod L (`rns.py:123,193` `fwd_stages` /
  `inv_stages`, XLA fusions);
- K-RNS-MAC, `rns_mac`: sum_k x_k y_k mod q_limb in the evaluation basis,
  for one or two sets of y (`rns_mul_eval` :280, CKKS `mul`'s tensor and
  `_ks_dot`);
- K-BASECONV, `base_convert`: the approximate base extension qs -> ps
  (`extend_bases` :356, `switch_bases` :422);
- K-RESCALE, `rescale_finish`: the rounding division by the dropped primes
  that ends `rescale_k` (:426).
Each wrapper runs the plain version only for CPU tensors; a CUDA tensor goes
to the kernel, or the wrapper raises. Add, subtract, negate and
`rns_from_i64` stay plain torch on either device, as they are XLA
element-wise ops in the JAX package.

The overflow count of the base extension, u = round(sum_i v_i / q_i), is
summed in f64 as XLA's CPU backend sums the JAX package's expression
(`rns.py:373-375`): a fused multiply-add per limb, limbs in order, from 0;
`fma_f64` emulates the fused operation in plain torch (Boldo and
Melquiond's round-to-odd emulation), the kernel uses `__fma_rn`.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..utils import kernels
from ..utils.interop import u64_to_torch
from ..utils.primes import mod_inverse
from .modular import barrett_reduce_u64, mulhi64, shoup_precompute
from .ntt import ntt_plan

# ---------------------------------------------------------------------------
# Stacked-limb modular primitives: q and the constants are (L, 1) int64
# tensors (or broadcast against the limb axis); values below q < 2^63.
# ---------------------------------------------------------------------------


def _csub_v(r: torch.Tensor, q) -> torch.Tensor:
    """r mod q for a u64 r < 2q (int64 r < 0 when r >= 2^63)."""
    return torch.where((r >= q) | (r < 0), r - q, r)


def add_mod_v(a: torch.Tensor, b, q) -> torch.Tensor:
    return _csub_v(a + b, q)


def sub_mod_v(a: torch.Tensor, b, q) -> torch.Tensor:
    d = a - b
    return torch.where(d < 0, d + q, d)


def neg_mod_v(a: torch.Tensor, q) -> torch.Tensor:
    return torch.where(a == 0, a, q - a)


def mul_shoup_v(a: torch.Tensor, w, w_shoup, q) -> torch.Tensor:
    return _csub_v(a * w - mulhi64(a, w_shoup) * q, q)


def _redc_v(t_hi: torch.Tensor, t_lo: torch.Tensor, q, neg_q_inv) -> torch.Tensor:
    m = t_lo * neg_q_inv
    return _csub_v(t_hi + mulhi64(m, q) + (t_lo != 0).long(), q)


def mul_mod_v(a: torch.Tensor, b, q, neg_q_inv, r2) -> torch.Tensor:
    """a b mod q by two REDCs, with per-limb Montgomery constants."""
    b = torch.as_tensor(b, dtype=torch.int64, device=a.device)
    t = _redc_v(mulhi64(a, b), a * b, q, neg_q_inv)
    return _redc_v(mulhi64(t, r2), t * r2, q, neg_q_inv)


def _col(vals, device) -> torch.Tensor:
    """u64 values as an (L, 1) int64 tensor."""
    return u64_to_torch(np.array([int(v) for v in vals], dtype=np.uint64)[:, None], device)


# ---------------------------------------------------------------------------
# Plan: stacked NTT tables for a prime basis
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class RnsPlan:
    qs: tuple[int, ...]
    n: int
    log_n: int
    # stacked NTT tables, shape (L, n) u64
    psi_br: np.ndarray
    psi_br_shoup: np.ndarray
    psi_inv_br: np.ndarray
    psi_inv_br_shoup: np.ndarray
    n_inv: np.ndarray  # (L, 1)
    n_inv_shoup: np.ndarray
    # Montgomery constants, shape (L, 1)
    q_arr: np.ndarray
    neg_q_inv: np.ndarray
    r2: np.ndarray

    @property
    def big_q(self) -> int:
        out = 1
        for q in self.qs:
            out *= q
        return out


@lru_cache(maxsize=None)
def rns_plan(qs: tuple[int, ...], n: int) -> RnsPlan:
    plans = [ntt_plan(q, n) for q in qs]
    stack = lambda attr: np.stack([getattr(p, attr) for p in plans])  # noqa: E731
    col = lambda vals: np.array(vals, dtype=np.uint64)[:, None]  # noqa: E731
    return RnsPlan(
        qs=qs,
        n=n,
        log_n=n.bit_length() - 1,
        psi_br=stack("psi_br"),
        psi_br_shoup=stack("psi_br_shoup"),
        psi_inv_br=stack("psi_inv_br"),
        psi_inv_br_shoup=stack("psi_inv_br_shoup"),
        n_inv=col([p.n_inv for p in plans]),
        n_inv_shoup=col([p.n_inv_shoup for p in plans]),
        q_arr=col(qs),
        neg_q_inv=col([p.zq.neg_q_inv for p in plans]),
        r2=col([p.zq.r2 for p in plans]),
    )


class RnsTables(NamedTuple):
    """A plan's tables as int64 tensors on one device: the stacked (L, n)
    twiddles and the (L, 1) per-limb constants."""

    psi: torch.Tensor
    psi_s: torch.Tensor
    psi_inv: torch.Tensor
    psi_inv_s: torch.Tensor
    q: torch.Tensor
    neg_q_inv: torch.Tensor
    n_inv: torch.Tensor
    n_inv_s: torch.Tensor
    r2: torch.Tensor


@lru_cache(maxsize=None)
def rns_tables(plan: RnsPlan, device: torch.device) -> RnsTables:
    fields = ("psi_br", "psi_br_shoup", "psi_inv_br", "psi_inv_br_shoup", "q_arr", "neg_q_inv", "n_inv", "n_inv_shoup", "r2")
    return RnsTables(*(u64_to_torch(getattr(plan, f), device) for f in fields))


# ---------------------------------------------------------------------------
# Plain versions of the transforms: radix-2 layers, each limb under its own
# tables (every operation is exact mod q, so any grouping of the layers
# gives the JAX package's radix-4 values)
# ---------------------------------------------------------------------------


def rns_ntt_ref(x: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """Forward NTT over the trailing axis of (..., L, N), limb l under qs[l]."""
    n, t = plan.n, rns_tables(plan, x.device)
    batch = x.shape[:-1]
    q = t.q[:, :, None]
    out = x
    for layer in range(plan.log_n):
        m = 1 << layer
        x4 = out.reshape(*batch, m, 2, n >> (layer + 1))
        u, v = x4[..., 0, :], x4[..., 1, :]
        tv = mul_shoup_v(v, t.psi[:, m : 2 * m, None], t.psi_s[:, m : 2 * m, None], q)
        out = torch.stack([add_mod_v(u, tv, q), sub_mod_v(u, tv, q)], dim=-2).reshape(*batch, n)
    return out


def rns_intt_ref(x: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """Inverse NTT over the trailing axis, with the 1/N scale."""
    n, t = plan.n, rns_tables(plan, x.device)
    batch = x.shape[:-1]
    q = t.q[:, :, None]
    out = x
    for layer in reversed(range(plan.log_n)):
        m = 1 << layer
        x4 = out.reshape(*batch, m, 2, n >> (layer + 1))
        u, v = x4[..., 0, :], x4[..., 1, :]
        d = mul_shoup_v(sub_mod_v(u, v, q), t.psi_inv[:, m : 2 * m, None], t.psi_inv_s[:, m : 2 * m, None], q)
        out = torch.stack([add_mod_v(u, v, q), d], dim=-2).reshape(*batch, n)
    return mul_shoup_v(out, t.n_inv, t.n_inv_s, t.q)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

MAX_LOG_N = 13  # K-RNS-NTT: one block a row, the row in dynamic shared memory
MAX_TERMS = 16  # K-RNS-MAC: products a launch sums
MAX_LIMBS = 64  # K-BASECONV: input limbs a thread holds


def _count(fn, rows: int) -> None:
    fn.launches += 1
    fn.by_rows[rows] += 1


def _check_rows(name: str, x: torch.Tensor, limbs: int, n: int) -> int:
    """Rows of a contiguous, 16-byte aligned (..., limbs, n) int64 CUDA tensor."""
    kernels.require(name, x, torch.int64)
    if x.dim() < 2 or x.shape[-1] != n or x.shape[-2] != limbs:
        raise ValueError(f"{name}: expected (..., {limbs}, {n}), got {tuple(x.shape)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads rows in 16-byte loads; x is not 16-byte aligned")
    return x.numel() // n


def _ntt_ptrs(t: RnsTables) -> tuple[int, ...]:
    """K-RNS-NTT's tables: the four stacked twiddle tables, q, -q^-1, 1/N and its dual."""
    return tuple(v.data_ptr() for v in (t.psi, t.psi_s, t.psi_inv, t.psi_inv_s, t.q, t.neg_q_inv, t.n_inv, t.n_inv_s))


def _transform(fn, entry: str, x: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    if not 1 <= plan.log_n <= MAX_LOG_N:
        raise ValueError(f"{fn.__name__}: the kernel takes 2 <= n <= {1 << MAX_LOG_N}, got {plan.n}")
    rows = _check_rows(fn.__name__, x, len(plan.qs), plan.n)
    y = torch.empty_like(x)
    if rows:
        lazy = max(plan.qs) < 1 << 62
        kernels.launch(entry, x.data_ptr(), y.data_ptr(), *_ntt_ptrs(rns_tables(plan, x.device)), rows, len(plan.qs), plan.log_n, int(lazy))
        _count(fn, rows)
    return y


def rns_ntt(x: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """Forward NTT over the trailing axis, batched over (..., L)."""
    if plan.n == 1:
        return x
    if x.is_cpu:
        return rns_ntt_ref(x, plan)
    return _transform(rns_ntt, "lft_rns_ntt_fwd", x, plan)


def rns_intt(x: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    if plan.n == 1:
        return x
    if x.is_cpu:
        return rns_intt_ref(x, plan)
    return _transform(rns_intt, "lft_rns_ntt_inv", x, plan)


def rns_mac_ref(xs, ys, plan: RnsPlan, zs=None):
    """sum_k xs[k] ys[k] mod q_limb (and, given zs, sum_k xs[k] zs[k]):
    each product by two REDCs, then the modular sum in order (`_ks_dot`)."""
    t = rns_tables(plan, xs[0].device)

    def dot(ws):
        acc = mul_mod_v(xs[0], ws[0], t.q, t.neg_q_inv, t.r2)
        for x, w in zip(xs[1:], ws[1:]):
            acc = add_mod_v(acc, mul_mod_v(x, w, t.q, t.neg_q_inv, t.r2), t.q)
        return acc

    return dot(ys) if zs is None else torch.stack([dot(ys), dot(zs)])


@lru_cache(maxsize=None)
def _mac_chunk(qs: tuple[int, ...]) -> int:
    """Products K-RNS-MAC sums in 128 bits before one REDC: k (q - 1)^2 < q 2^64."""
    return min(min(((q << 64) - 1) // (q - 1) ** 2, 1 << 30) for q in qs)


def rns_mac(xs, ys, plan: RnsPlan, zs=None) -> torch.Tensor:
    """sum_k xs[k] * ys[k] mod q_limb in the evaluation basis: xs[k] of shape
    (..., L, N); each ys[k] of the same shape, or (L, N) and broadcast over
    the leading axes (a key). With zs (shaped as ys), both sums, stacked on
    a new leading axis (one launch, xs read once)."""
    if xs[0].is_cpu:
        return rns_mac_ref(xs, ys, plan, zs)
    name, limbs, n = "rns_mac", len(plan.qs), plan.n
    shape = xs[0].shape
    if not 1 <= len(xs) <= MAX_TERMS or len(ys) != len(xs) or (zs is not None and len(zs) != len(xs)):
        raise ValueError(f"{name}: takes 1..{MAX_TERMS} terms with as many y (and z), got {len(xs)}, {len(ys)}")
    rows = _check_rows(name, xs[0], limbs, n)
    w_shape = tuple(ys[0].shape)
    if w_shape not in (tuple(shape), (limbs, n)):
        raise ValueError(f"{name}: y must be {tuple(shape)} or ({limbs}, {n}), got {w_shape}")
    for x in xs:
        kernels.require(name, x, torch.int64, shape)
    for w in (*ys, *(zs or ())):
        kernels.require(name, w, torch.int64, w_shape)
    out = torch.empty((1 if zs is None else 2, *shape), dtype=torch.int64, device=xs[0].device)
    if rows:
        ptrs = lambda ts: np.array([t.data_ptr() for t in ts], dtype=np.uint64)  # noqa: E731
        px, py = ptrs(xs), ptrs(ys)
        pz = ptrs(zs) if zs is not None else None
        t = rns_tables(plan, xs[0].device)
        kernels.launch(
            "lft_rns_mac", px.ctypes.data, py.ctypes.data, 0 if pz is None else pz.ctypes.data,
            out.data_ptr(), len(xs), rows, limbs, plan.log_n, ys[0].numel() // n,
            t.q.data_ptr(), t.neg_q_inv.data_ptr(), t.r2.data_ptr(), _mac_chunk(plan.qs),
        )  # fmt: skip
        _count(rns_mac, rows)
    return out[0] if zs is None else out


def rns_add(a, b, plan: RnsPlan):
    return add_mod_v(a, b, rns_tables(plan, a.device).q)


def rns_sub(a, b, plan: RnsPlan):
    return sub_mod_v(a, b, rns_tables(plan, a.device).q)


def rns_neg(a, plan: RnsPlan):
    return neg_mod_v(a, rns_tables(plan, a.device).q)


def rns_mul_eval(a, b, plan: RnsPlan):
    """Pointwise product in the evaluation basis (either operand may be the
    (L, N) one broadcast over the other's leading axes)."""
    if a.dim() < b.dim():
        a, b = b, a
    return rns_mac([a], [b], plan)


def rns_mul(a, b, plan: RnsPlan):
    """Coefficient-basis negacyclic product, all limbs fused."""
    return rns_intt(rns_mul_eval(rns_ntt(a, plan), rns_ntt(b, plan), plan), plan)


def rns_from_i64(v: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    """Broadcast signed coefficients (..., N) into all limbs (..., L, N)
    (torch's % is floor-mod, as jnp's)."""
    return v[..., None, :] % rns_tables(plan, v.device).q


# ---------------------------------------------------------------------------
# Base extension (`rns.rs:331-345`)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class BaseExtendPlan:
    """Tables for extending base qs -> ps (`Rns::with_ps`, `rns.rs:305-322`)."""

    qs: tuple[int, ...]
    ps: tuple[int, ...]
    q_hats_inv: np.ndarray  # (Lq,) q_hat_i^-1 mod q_i
    q_hats_inv_shoup: np.ndarray
    q_fracs: np.ndarray  # (Lq,) f64 1/q_i
    q_hats_ps: np.ndarray  # (Lp, Lq) q_hat_i mod p_j
    q_hats_ps_shoup: np.ndarray  # their Shoup duals mod p_j (the kernel's products)
    uq_ps_t: np.ndarray  # (Lq+1, Lp) (u*Q) mod p_j, u-major for one gather
    neg_p_inv: np.ndarray  # (Lp,) -p^-1 mod 2^64 (REDC)
    p_r2: np.ndarray  # (Lp,) 2^128 mod p
    p_barrett_m: np.ndarray  # (Lp,) floor(2^64 / p)


@lru_cache(maxsize=None)
def base_extend_plan(qs: tuple[int, ...], ps: tuple[int, ...]) -> BaseExtendPlan:
    big_q = 1
    for q in qs:
        big_q *= q
    q_hats = [big_q // q for q in qs]
    q_hats_inv = [mod_inverse(h % q, q) for h, q in zip(q_hats, qs)]
    u64 = lambda vals: np.array([int(v) for v in vals], dtype=np.uint64)  # noqa: E731
    hats_ps = [[h % p for h in q_hats] for p in ps]
    return BaseExtendPlan(
        qs=qs,
        ps=ps,
        q_hats_inv=u64(q_hats_inv),
        q_hats_inv_shoup=u64([(h << 64) // q for h, q in zip(q_hats_inv, qs)]),
        q_fracs=np.array([1.0 / q for q in qs], dtype=np.float64),
        q_hats_ps=np.array(hats_ps, dtype=np.uint64),
        q_hats_ps_shoup=np.array([[(w << 64) // p for w in row] for row, p in zip(hats_ps, ps)], dtype=np.uint64),
        uq_ps_t=np.array([[(u * big_q) % p for p in ps] for u in range(len(qs) + 1)], dtype=np.uint64),
        neg_p_inv=u64([(-pow(p, -1, 1 << 64)) % (1 << 64) for p in ps]),
        p_r2=u64([(1 << 128) % p for p in ps]),
        p_barrett_m=u64([(1 << 64) // p for p in ps]),
    )


class BaseExtendTables(NamedTuple):
    """K-BASECONV's constants on one device: q, q_hat^-1 and its dual, 1/q
    (f64) per input limb; p per output limb; q_hat mod p and its dual per
    (output, input); the correction table (Lq+1, Lp)."""

    q: torch.Tensor
    qhi: torch.Tensor
    qhi_s: torch.Tensor
    frac: torch.Tensor
    p: torch.Tensor
    w: torch.Tensor
    ws: torch.Tensor
    uq: torch.Tensor


@lru_cache(maxsize=None)
def base_extend_tables(bp: BaseExtendPlan, device: torch.device) -> BaseExtendTables:
    u = lambda a: u64_to_torch(a, device)  # noqa: E731
    return BaseExtendTables(
        u(np.array(bp.qs, dtype=np.uint64)), u(bp.q_hats_inv), u(bp.q_hats_inv_shoup),
        torch.from_numpy(bp.q_fracs.copy()).to(device), u(np.array(bp.ps, dtype=np.uint64)),
        u(bp.q_hats_ps), u(bp.q_hats_ps_shoup), u(bp.uq_ps_t),
    )  # fmt: skip


def fma_f64(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a b + c rounded once (a fused multiply-add), in float64 torch ops, for
    finite non-negative operands far from underflow: the exact product as
    p + e (Dekker), c + p as s + t (Knuth), t + e rounded to odd, then one
    rounding of s + (t + e) (Boldo and Melquiond, "Emulation of FMA and
    correctly rounded sums: proved algorithms using rounding to odd")."""
    split = 134217729.0  # 2^27 + 1

    def halves(x):
        t = split * x
        hi = t - (t - x)
        return hi, x - hi

    p = a * b
    (ah, al), (bh, bl) = halves(a), halves(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = c + p
    z = s - c
    t = (c - (s - z)) + (p - z)
    v = t + e
    w = v - t
    err = (t - (v - w)) + (e - w)  # v + err == t + e exactly
    even = (v.view(torch.int64) & 1) == 0
    odd = torch.where(err > 0, torch.nextafter(v, torch.full_like(v, float("inf"))), torch.nextafter(v, torch.full_like(v, float("-inf"))))
    v = torch.where((err != 0) & even, odd, v)
    return s + v


def overflow_sums(v: torch.Tensor, qs: tuple[int, ...]) -> torch.Tensor:
    """sum_i f64(v_i) (1/q_i) over the limb axis of (..., Lq, N), as XLA's
    CPU backend computes `jnp.sum(v.astype(f64) * (1/q), axis=-2)`: one
    fused multiply-add per limb, in limb order, from 0."""
    frac = torch.tensor([1.0 / q for q in qs], dtype=torch.float64, device=v.device)
    acc = torch.zeros(v.shape[:-2] + v.shape[-1:], dtype=torch.float64, device=v.device)
    for i in range(len(qs)):
        acc = fma_f64(v[..., i, :].double(), frac[i].expand_as(acc), acc)
    return acc


def base_convert_ref(x: torch.Tensor, qs: tuple[int, ...], ps: tuple[int, ...], add=None) -> torch.Tensor:
    """The JAX package's `extend_bases` of x (+ add, a per-limb constant
    added mod q_i first, where given)."""
    bp = base_extend_plan(qs, ps)
    dev = x.device
    q_col = _col(qs, dev)
    if add is not None:
        x = add_mod_v(x, _col(add, dev), q_col)
    v = mul_shoup_v(x, _col(bp.q_hats_inv, dev), _col(bp.q_hats_inv_shoup, dev), q_col)  # (..., Lq, N)
    u_cnt = torch.round(overflow_sums(v, qs)).long()  # (..., N), half to even as jnp.round
    p3 = _col(ps, dev)[:, :, None]  # (Lp, 1, 1)
    terms = mul_mod_v(
        v[..., None, :, :],
        u64_to_torch(bp.q_hats_ps[:, :, None], dev),
        p3,
        _col(bp.neg_p_inv, dev)[:, :, None],
        _col(bp.p_r2, dev)[:, :, None],
    )  # (..., Lp, Lq, N), each term < p_j
    p_col = p3[:, :, 0]
    if len(qs) * (max(ps) - 1) < 1 << 64:
        s = terms.sum(-2)  # raw u64, wrapping in int64: no overflow of the u64
        r = s - mulhi64(s, _col(bp.p_barrett_m, dev)) * p_col
        s = _csub_v(_csub_v(r, p_col), p_col)
    else:  # log-depth modular fold
        t = terms.movedim(-2, 0)
        while t.shape[0] > 1:
            if t.shape[0] % 2:
                t = torch.cat([t, torch.zeros_like(t[:1])])
            h = t.shape[0] // 2
            t = add_mod_v(t[:h], t[h:], p_col)
        s = t[0]
    corr = u64_to_torch(bp.uq_ps_t, dev)[u_cnt].movedim(-1, -2)  # (..., Lp, N)
    return sub_mod_v(s, corr, p_col)


def _batch_layout(name: str, x: torch.Tensor, limbs: int, n: int) -> tuple[int, int]:
    """(batch, batch stride in elements) of a (..., limbs, n) view whose rows
    are contiguous and whose leading axes merge into one."""
    if not x.is_cuda or x.get_device() != torch.cuda.current_device() or x.dtype != torch.int64:
        raise ValueError(f"{name}: expected an int64 tensor on the current CUDA device, got {x.dtype} on {x.device}")
    if x.dim() < 2 or x.shape[-1] != n or x.shape[-2] != limbs or x.stride(-1) != 1 or x.stride(-2) != n:
        raise ValueError(f"{name}: expected (..., {limbs}, {n}) with contiguous rows, got {tuple(x.shape)}, strides {x.stride()}")
    for i in range(x.dim() - 3):
        if x.stride(i) != x.stride(i + 1) * x.shape[i + 1]:
            raise ValueError(f"{name}: the leading axes of x do not merge (strides {x.stride()})")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x is not 16-byte aligned")
    batch = x.numel() // (limbs * n)
    return batch, (x.stride(-3) if x.dim() > 2 else limbs * n)


def base_convert(x: torch.Tensor, qs: tuple[int, ...], ps: tuple[int, ...], add=None) -> torch.Tensor:
    """Approximate base extension (`rns.rs:331-345`) of x (..., Lq, N) over qs
    into (..., Lp, N) over ps: v_i = x_i q_hat_i^-1 mod q_i; u = round(sum
    v_i / q_i) in f64; out_j = sum_i (q_hat_i mod p_j) v_i - (u Q mod p_j).
    `add` (a per-input-limb constant, or None) is added to x mod q_i first.
    x may be a view whose rows are contiguous (a slice of the limb axis)."""
    if x.is_cpu:
        return base_convert_ref(x, qs, ps, add)
    n = x.shape[-1]
    if len(qs) > MAX_LIMBS:
        raise ValueError(f"base_convert: the kernel takes at most {MAX_LIMBS} input limbs, got {len(qs)}")
    batch, stride = _batch_layout("base_convert", x, len(qs), n)
    y = torch.empty((*x.shape[:-2], len(ps), n), dtype=torch.int64, device=x.device)
    if batch:
        t = base_extend_tables(base_extend_plan(qs, ps), x.device)
        add_t = None if add is None else _add_tensor(tuple(int(a) for a in add), x.device)
        kernels.launch(
            "lft_base_convert", x.data_ptr(), y.data_ptr(), *(v.data_ptr() for v in t), 0 if add_t is None else add_t.data_ptr(),
            len(qs), len(ps), n.bit_length() - 1, batch, stride,
        )  # fmt: skip
        _count(base_convert, batch * len(qs))
    return y


@lru_cache(maxsize=None)
def _add_tensor(add: tuple[int, ...], device: torch.device) -> torch.Tensor:
    return u64_to_torch(np.array(add, dtype=np.uint64), device)


def extend_bases(x: torch.Tensor, qs: tuple[int, ...], ps: tuple[int, ...]) -> torch.Tensor:
    """x (..., Lq, N) over qs -> (..., Lp, N) over ps."""
    return base_convert(x, qs, ps)


switch_bases = extend_bases


def barrett_all(v: torch.Tensor, p: int) -> torch.Tensor:
    """Any u64 into [0, p) (`ops/modular.py:barrett_reduce_u64`)."""
    return barrett_reduce_u64(v, p)


# ---------------------------------------------------------------------------
# Rescale (`rns.rs:103-132`)
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class RescalePlan:
    """The per-limb constants of `rescale_k(·, qs, k)`, made once per (qs, k)."""

    qs: tuple[int, ...]
    k: int
    keep: tuple[int, ...]
    drop: tuple[int, ...]
    p_half: tuple[int, ...]  # (P >> 1) mod q for every q in qs, P = prod(drop)
    p_inv: np.ndarray  # (L-k,) P^-1 mod q_keep
    p_inv_shoup: np.ndarray
    barrett_m: np.ndarray  # (L-k,) floor(2^64 / q) where k == 1 and drop[0] >= q, else 0


@lru_cache(maxsize=None)
def rescale_plan(qs: tuple[int, ...], k: int) -> RescalePlan:
    assert k > 0
    assert len(qs) > k, (
        f"rescale_k: cannot drop {k} of {len(qs)} limbs — level budget exhausted (raise big_l / use fewer multiplies)"
    )
    keep, drop = qs[:-k], qs[-k:]
    p = 1
    for d in drop:
        p *= d
    p_inv = [mod_inverse(p % q, q) for q in keep]
    return RescalePlan(
        qs=qs,
        k=k,
        keep=keep,
        drop=drop,
        p_half=tuple((p >> 1) % q for q in qs),
        p_inv=np.array(p_inv, dtype=np.uint64),
        p_inv_shoup=np.array([int(shoup_precompute(w, q)) for w, q in zip(p_inv, keep)], dtype=np.uint64),
        barrett_m=np.array([(1 << 64) // q if k == 1 and drop[0] >= q else 0 for q in keep], dtype=np.uint64),
    )


class RescaleTables(NamedTuple):
    """K-RESCALE's per-kept-limb constants on one device."""

    q: torch.Tensor
    p_half: torch.Tensor
    p_inv: torch.Tensor
    p_inv_s: torch.Tensor
    barrett_m: torch.Tensor


@lru_cache(maxsize=None)
def rescale_tables(rp: RescalePlan, device: torch.device) -> RescaleTables:
    lk = len(rp.keep)
    u = lambda a: u64_to_torch(np.asarray(a, dtype=np.uint64), device)  # noqa: E731
    return RescaleTables(u(rp.keep), u(rp.p_half[:lk]), u(rp.p_inv), u(rp.p_inv_shoup), u(rp.barrett_m))


def rescale_finish_ref(x: torch.Tensor, conv: torch.Tensor | None, rp: RescalePlan) -> torch.Tensor:
    """From x (..., L, N) and, for k > 1, the base conversion of its last k
    limbs (+ P/2) into the kept primes: (x + P/2 - r) P^-1 mod q per kept
    limb, r the dropped limb (k = 1, reduced where drop[0] >= q) or conv."""
    dev, lk = x.device, len(rp.keep)
    keep_q = _col(rp.keep, dev)
    head = add_mod_v(x[..., :lk, :], _col(rp.p_half[:lk], dev), keep_q)
    if conv is None:
        d = rp.drop[0]
        rp_v = add_mod_v(x[..., lk, :], rp.p_half[lk], d)  # (..., N) values < drop[0]
        conv = torch.stack([barrett_all(rp_v, q) if d >= q else rp_v for q in rp.keep], dim=-2)
    head = sub_mod_v(head, conv, keep_q)
    return mul_shoup_v(head, u64_to_torch(rp.p_inv[:, None], dev), u64_to_torch(rp.p_inv_shoup[:, None], dev), keep_q)


def rescale_finish(x: torch.Tensor, conv: torch.Tensor | None, rp: RescalePlan) -> torch.Tensor:
    """K-RESCALE: the last step of `rescale_k`, on x (..., L, N)."""
    if x.is_cpu:
        return rescale_finish_ref(x, conv, rp)
    n, lk = x.shape[-1], len(rp.keep)
    rows = _check_rows("rescale_finish", x, len(rp.qs), n)
    out_shape = (*x.shape[:-2], lk, n)
    if conv is not None:
        kernels.require("rescale_finish", conv, torch.int64, out_shape)
    y = torch.empty(out_shape, dtype=torch.int64, device=x.device)
    if rows:
        t = rescale_tables(rp, x.device)
        d = rp.drop[0]
        kernels.launch(
            "lft_rescale", x.data_ptr(), 0 if conv is None else conv.data_ptr(), y.data_ptr(), *(v.data_ptr() for v in t),
            len(rp.qs), lk, n.bit_length() - 1, rows // len(rp.qs), d, rp.p_half[lk],
        )  # fmt: skip
        _count(rescale_finish, rows)
    return y


def rescale_k(x: torch.Tensor, qs: tuple[int, ...], k: int) -> torch.Tensor:
    """Divide-and-round by the product of the last k primes (`rns.rs:103-118`):
    x (..., L, N) over qs -> (..., L-k, N) over qs[:-k]."""
    rp = rescale_plan(qs, k)
    lk = len(rp.keep)
    conv = None if k == 1 else base_convert(x[..., lk:, :], rp.drop, rp.keep, add=rp.p_half[lk:])
    return rescale_finish(x, conv, rp)


# launches, and launches by row count (K-BASECONV: input rows)
for _fn in (rns_ntt, rns_intt, rns_mac, base_convert, rescale_finish):
    _fn.launches, _fn.by_rows = 0, Counter()
