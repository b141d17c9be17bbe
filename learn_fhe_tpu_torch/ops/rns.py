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
  `_ks_dot`); `rns_intt_mac` builds those sums inside K-RNS-NTT's inverse
  and returns their inverse transforms (`rns_intt(rns_mul_eval(..))` :287,
  the JAX package's CKKS `mul` and `key_switch` under one jit), which is
  every use the port makes of them;
- K-BASECONV, `base_convert`: the approximate base extension qs -> ps
  (`extend_bases` :356, `switch_bases` :422), into a caller's rows with x's
  own limbs beside them where asked (the key switch's hoist in QP order,
  `models/ckks/ckks.py:692`);
- K-RESCALE, `rescale_finish`: the rounding division by the dropped primes
  that ends `rescale_k` (:426), with the add after it where one follows;
- K-RNS-ADD, `rns_add` / `rns_sub` / `rns_neg` (:268-278): limb-wise, a
  ciphertext's b and a in one launch;
- the gathered instances of K-RNS-MAC (`rns_mac` / `rns_intt_mac` with
  `perms`): a term's x read at the columns of an evaluation-slot
  permutation (CKKS's hoisted rotations, `models/ckks/bootstrapping.py:143,
  147`, `ckks.py:666`, where XLA fuses the gather into the products);
  `rns_intt_mac`'s where every term reads one x copies each x row into
  shared memory and gathers from there (`_row_instance`);
- K-AUTOMORPH, `automorphism_rns`: the coefficient automorphism X -> X^t
  of (..., L, N) rows, b and a in one launch (`models/ckks/ckks.py:605`);
- K-BGV-DROP (`csrc/bgv.cu`), `drop_limbs_t`: BGV's exact t-corrected drop
  of trailing limbs, b and a in one launch, with an add between or after
  the drops (`models/bgv/bgv.py:176` `_drop_limb`).
K-RNS-NTT and every `rns_intt_mac` instance take 2 <= N <= 2^16, past
2^13 on primes below 2^62 only (`_check_ring`: the production bootstrap's
ring). Each wrapper runs the plain version only for CPU tensors; a CUDA
tensor goes to the kernel, or the wrapper raises. `rns_from_i64` stays
plain torch on either device.

The overflow count of the base extension, u = round(sum_i v_i / q_i), is
summed in f64 as XLA's CPU backend sums the JAX package's expression
(`rns.py:373-375`): a fused multiply-add per limb, limbs in order, from 0;
`fma_f64` emulates the fused operation in plain torch (Boldo and
Melquiond's round-to-odd emulation), the kernel uses `__fma_rn`.
"""

from __future__ import annotations

import math
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
from .poly import automorphism_map

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
    n_inv_mac: np.ndarray  # (L, 1) N^-1 2^64 mod q: rns_intt_mac's final scale
    n_inv_mac_shoup: np.ndarray
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
        n_inv_mac=col([(p.n_inv << 64) % q for p, q in zip(plans, qs)]),
        n_inv_mac_shoup=col([int(shoup_precompute((p.n_inv << 64) % q, q)) for p, q in zip(plans, qs)]),
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
    n_inv_mac: torch.Tensor
    n_inv_mac_s: torch.Tensor


@lru_cache(maxsize=None)
def rns_tables(plan: RnsPlan, device: torch.device) -> RnsTables:
    fields = (
        "psi_br", "psi_br_shoup", "psi_inv_br", "psi_inv_br_shoup", "q_arr", "neg_q_inv", "n_inv", "n_inv_shoup", "r2",
        "n_inv_mac", "n_inv_mac_shoup",
    )  # fmt: skip
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

MAX_LOG_N = 16  # K-RNS-NTT: a row's 8 sub-rows of N/8 in the shared memory of its cluster of up to 8 blocks
FIXED_LOG_N = 13  # past it the cluster instances are lazy only (every prime below 2^62)
MAX_TERMS = 16  # K-RNS-MAC: products a launch sums
ROW_LOG_N = 13  # the gathered rns_intt_mac's shared-x instances: N = 2^13 (a 64 KB x row a block)
ROW_TERMS = 4  # ... and 1..4 terms (lazy)
MAX_LIMBS = 64  # K-BASECONV: input limbs a thread holds


def _count(fn, rows: int, gather: bool = False, shared: bool = False) -> None:
    fn.launches += 1
    fn.by_rows[rows] += 1
    if gather:
        fn.gather_launches += 1
        fn.gather_by_rows[rows] += 1
    if shared:
        fn.shared_launches += 1


CLUSTER_KINDS = ("rns_ntt", "rns_intt", "rns_intt_mac", "rns_intt_mac_gather")


def cluster_occupancy(kind: str, log_n: int, terms: int = 0, rows: int = 1) -> dict[str, int]:
    """The lazy cluster instance that a launch of `kind` (CLUSTER_KINDS;
    rns_intt_mac's with `terms` terms, 0: any other count) on `rows` rows at
    N = 2^log_n, 13 <= log_n <= 16, takes on the current CUDA device: blocks
    a row, threads a block, dynamic shared memory bytes, blocks an SM and
    clusters the device holds at once (the CUDA occupancy calculator). Host
    only: no launch."""
    out = np.zeros(5, dtype=np.int32)
    status = kernels.call("lft_rns_cluster_occupancy", CLUSTER_KINDS.index(kind), log_n, terms, rows, out.ctypes.data)
    if status != 0:
        raise RuntimeError(f"cluster_occupancy({kind}, {log_n}): CUDA error {status}")
    return dict(zip(("cluster", "threads", "smem", "blocks_per_sm", "clusters"), (int(v) for v in out)))


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


def _check_ring(name: str, plan: RnsPlan) -> bool:
    """Whether K-RNS-NTT's instances at the plan's ring are lazy (every prime
    below 2^62); raises where no instance takes the plan: 2 <= N <= 2^16, and
    past N = 2^13 lazy ones alone."""
    lazy = max(plan.qs) < 1 << 62
    if not 1 <= plan.log_n <= MAX_LOG_N:
        raise ValueError(f"{name}: the kernel takes 2 <= n <= {1 << MAX_LOG_N}, got {plan.n}")
    if plan.log_n > FIXED_LOG_N and not lazy:
        raise ValueError(f"{name}: past n = {1 << FIXED_LOG_N} the kernel takes primes below 2^62, got {max(plan.qs)}")
    return lazy


def _transform(fn, entry: str, x: torch.Tensor, plan: RnsPlan) -> torch.Tensor:
    lazy = _check_ring(fn.__name__, plan)
    rows = _check_rows(fn.__name__, x, len(plan.qs), plan.n)
    y = torch.empty_like(x)
    if rows:
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


def _permuted(xs, perms):
    """xs[k][..., perms[k]] where perms[k] is given (the plain versions' gather)."""
    if perms is None:
        return xs
    return [x if p is None else x[..., p.long()] for x, p in zip(xs, perms)]


def rns_mac_ref(xs, ys, plan: RnsPlan, zs=None, perms=None):
    """sum_k xs[k] ys[k] mod q_limb (and, given zs, sum_k xs[k] zs[k]):
    each product by two REDCs, then the modular sum in order (`_ks_dot`).
    With perms, xs[k] is read as xs[k][..., perms[k]] where perms[k] is not
    None."""
    xs = _permuted(xs, perms)
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


def _mac_operands(name: str, xs, ys, zs, plan: RnsPlan) -> tuple[int, int, tuple]:
    """(x rows, y rows, the host arrays of x, y and z pointers) of a MAC's
    operands on the card: 1..MAX_TERMS terms, each x a contiguous (..., L, N)
    of one shape, each y and z of that shape or (L, N) (a key broadcast over
    the leading axes), every one 16-byte aligned (the kernels move 16-byte
    words)."""
    limbs, n = len(plan.qs), plan.n
    if not 1 <= len(xs) <= MAX_TERMS or len(ys) != len(xs) or (zs is not None and len(zs) != len(xs)):
        raise ValueError(f"{name}: takes 1..{MAX_TERMS} terms with as many y (and z), got {len(xs)}, {len(ys)}")
    shape = tuple(xs[0].shape)
    rows = _check_rows(name, xs[0], limbs, n)
    w_shape = tuple(ys[0].shape)
    if w_shape not in (shape, (limbs, n)):
        raise ValueError(f"{name}: y must be {shape} or ({limbs}, {n}), got {w_shape}")
    for x in xs:
        kernels.require(name, x, torch.int64, shape)
    for w in (*ys, *(zs or ())):
        kernels.require(name, w, torch.int64, w_shape)
    ops = (*xs, *ys, *(zs or ()))
    if any(t.data_ptr() % 16 for t in ops):
        raise ValueError(f"{name}: the kernel reads its operands in 16-byte loads; an x, y or z is not 16-byte aligned")
    ptrs = lambda ts: np.array([t.data_ptr() for t in ts], dtype=np.uint64)  # noqa: E731
    return rows, ys[0].numel() // n, (ptrs(xs), ptrs(ys), None if zs is None else ptrs(zs))


def _perm_operands(name: str, perms, terms: int, n: int) -> np.ndarray | None:
    """The host array of the terms' permutation-table pointers (0 for None),
    or None where no term has a table (the ungathered instances). A table
    is a contiguous, 16-byte aligned int32 (n,) on the current CUDA device,
    a permutation of 0..n-1 (the caller's: the kernels do not check it)."""
    if perms is None or all(p is None for p in perms):
        return None
    if len(perms) != terms:
        raise ValueError(f"{name}: takes one permutation table (or None) per term, got {len(perms)} for {terms}")
    for p in perms:
        if p is not None:
            kernels.require(name, p, torch.int32, (n,))
            if p.data_ptr() % 16:
                raise ValueError(f"{name}: the kernel reads a permutation table in 16-byte words; it is not 16-byte aligned")
    return np.array([0 if p is None else p.data_ptr() for p in perms], dtype=np.uint64)


def _shared_x(xs) -> bool:
    """Whether every term reads one x: the same tensor memory, at the same
    storage offset, of the same shape and strides (views of one storage at
    other offsets or strides are other x)."""
    x0 = xs[0]
    key = (x0.data_ptr(), tuple(x0.shape), x0.stride())
    return all((x.data_ptr(), tuple(x.shape), x.stride()) == key for x in xs[1:])


def _row_instance(xs, plan: RnsPlan) -> bool:
    """Whether a gathered rns_intt_mac takes the instance that copies each x
    row into shared memory: one x (`_shared_x`), lazy, N = 2^ROW_LOG_N and
    1..ROW_TERMS terms (`lft_rns_intt_mac_gather_shared` refuses others;
    past 2^13 the distinct-x instance takes every gathered sum)."""
    return plan.log_n == ROW_LOG_N and max(plan.qs) < 1 << 62 and len(xs) <= ROW_TERMS and _shared_x(xs)


def rns_mac(xs, ys, plan: RnsPlan, zs=None, perms=None) -> torch.Tensor:
    """sum_k xs[k] * ys[k] mod q_limb in the evaluation basis: xs[k] of shape
    (..., L, N); each ys[k] of the same shape, or (L, N) and broadcast over
    the leading axes (a key). With zs (shaped as ys), both sums, stacked on
    a new leading axis (one launch). With perms (one int32 (N,) table or
    None per term), term k reads xs[k][..., perms[k]]: the gathered
    instance, which reads x at the table's columns rather than a permuted
    copy."""
    if xs[0].is_cpu:
        return rns_mac_ref(xs, ys, plan, zs, perms)
    rows, y_rows, (px, py, pz) = _mac_operands("rns_mac", xs, ys, zs, plan)
    pp = _perm_operands("rns_mac", perms, len(xs), plan.n)
    out = torch.empty((1 if zs is None else 2, *xs[0].shape), dtype=torch.int64, device=xs[0].device)
    if rows:
        t = rns_tables(plan, xs[0].device)
        entry, gather = ("lft_rns_mac",), ()
        if pp is not None:
            entry, gather = ("lft_rns_mac_gather",), (pp.ctypes.data,)
        kernels.launch(
            *entry, px.ctypes.data, py.ctypes.data, 0 if pz is None else pz.ctypes.data, *gather,
            out.data_ptr(), len(xs), rows, len(plan.qs), plan.log_n, y_rows,
            t.q.data_ptr(), t.neg_q_inv.data_ptr(), t.r2.data_ptr(), _mac_chunk(plan.qs),
        )  # fmt: skip
        _count(rns_mac, rows, pp is not None)
    return out[0] if zs is None else out


def rns_intt_mac_ref(xs, ys, plan: RnsPlan, zs=None, perms=None):
    return rns_intt_ref(rns_mac_ref(xs, ys, plan, zs, perms), plan)


def rns_intt_mac(xs, ys, plan: RnsPlan, zs=None, perms=None) -> torch.Tensor:
    """rns_intt(rns_mac(xs, ys, plan, zs, perms), plan) in one launch: the
    sums are made inside the inverse transform's first pass and never
    stored. Takes rns_mac's operands; returns (..., L, N), or (2, ..., L, N)
    with zs. With perms, where every term reads one x (the bootstrap's b
    sums), lazy at N = 2^13 with up to ROW_TERMS terms, the launch copies
    each x row into shared memory and gathers from there
    (`_row_instance`). Rings and primes as K-RNS-NTT's (`_check_ring`)."""
    if xs[0].is_cpu:
        return rns_intt_mac_ref(xs, ys, plan, zs, perms)
    if plan.n == 1:  # the inverse transform of one value is the value
        return rns_mac(xs, ys, plan, zs, perms)
    name = "rns_intt_mac"
    lazy = _check_ring(name, plan)
    rows, y_rows, (px, py, pz) = _mac_operands(name, xs, ys, zs, plan)
    pp = _perm_operands(name, perms, len(xs), plan.n)
    sums = 1 if zs is None else 2
    out = torch.empty((sums, *xs[0].shape), dtype=torch.int64, device=xs[0].device)
    if rows:
        t = rns_tables(plan, xs[0].device)
        tabs = (t.psi, t.psi_s, t.psi_inv, t.psi_inv_s, t.q, t.neg_q_inv, t.n_inv_mac, t.n_inv_mac_s)
        entry, gather, shared = ("lft_rns_intt_mac",), (), False
        if pp is not None:
            shared = _row_instance(xs, plan)
            entry, gather = ("lft_rns_intt_mac_gather_shared" if shared else "lft_rns_intt_mac_gather",), (pp.ctypes.data,)
        kernels.launch(
            *entry, px.ctypes.data, py.ctypes.data, 0 if pz is None else pz.ctypes.data, *gather,
            out.data_ptr(), len(xs), rows, len(plan.qs), plan.log_n, y_rows, *(v.data_ptr() for v in tabs),
            _mac_chunk(plan.qs), int(lazy),
        )  # fmt: skip
        _count(rns_intt_mac, (sums * rows, len(xs)), pp is not None, shared)
    return out[0] if zs is None else out


# ---------------------------------------------------------------------------
# K-AUTOMORPH: the coefficient automorphism of RNS rows
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def automorphism_index(n: int, t: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """automorphism_map's src (int64) and sign (bool) on a device."""
    src, sign = automorphism_map(n, t)
    return torch.from_numpy(src).to(device), torch.from_numpy(sign).to(device)


@lru_cache(maxsize=None)
def automorphism_code(n: int, t: int, device: torch.device) -> torch.Tensor:
    """K-AUTOMORPH's table: int32 src | sign << 31 per output column."""
    src, sign = automorphism_map(n, t)
    code = src.astype(np.uint32) | (sign.astype(np.uint32) << np.uint32(31))
    return torch.from_numpy(code.view(np.int32)).to(device)


def automorphism_rns_ref(x: torch.Tensor, t: int, qs: tuple) -> torch.Tensor:
    """X -> X^t of every row of x (..., L, N): the signed gather, negated
    mod the row's prime (`learn_fhe_tpu/models/ckks/ckks.py:605`)."""
    src, sign = automorphism_index(x.shape[-1], t, x.device)
    g = x[..., src]
    return torch.where(sign, neg_mod_v(g, rns_tables(rns_plan(qs, x.shape[-1]), x.device).q), g)


def automorphism_rns(x, t: int, qs: tuple):
    """K-AUTOMORPH: X -> X^t of the rows of x, a (..., L, N) tensor over
    qs, or of a pair of them of one shape (CKKS's b and a) in one launch;
    returns what it was given, permuted. Inputs need not be contiguous (a
    strided one is copied first)."""
    pair = isinstance(x, (tuple, list))
    xs = tuple(x) if pair else (x,)
    if xs[0].is_cpu:
        out = tuple(automorphism_rns_ref(v, t, qs) for v in xs)
        return out if pair else out[0]
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"automorphism_rns: takes one tensor or a pair, got {len(xs)}")
    n = xs[0].shape[-1]
    xs = tuple(v.contiguous() for v in xs)
    rows = _check_rows("automorphism_rns", xs[0], len(qs), n)
    for v in xs[1:]:
        kernels.require("automorphism_rns", v, torch.int64, xs[0].shape)
        if v.data_ptr() % 16:
            raise ValueError("automorphism_rns: the kernel writes rows in 16-byte stores; x is not 16-byte aligned")
    ys = tuple(torch.empty_like(v) for v in xs)
    if rows:
        code = automorphism_code(n, t, xs[0].device)
        q = rns_tables(rns_plan(qs, n), xs[0].device).q
        second = (xs[1].data_ptr(), ys[1].data_ptr()) if len(xs) == 2 else (0, 0)
        kernels.launch(
            "lft_rns_automorphism", xs[0].data_ptr(), second[0], ys[0].data_ptr(), second[1], code.data_ptr(),
            q.data_ptr(), rows, len(qs), n.bit_length() - 1,
        )  # fmt: skip
        _count(automorphism_rns, len(xs) * rows)
    return ys if pair else ys[0]


# ---------------------------------------------------------------------------
# K-RNS-ADD: limb-wise add, subtract and negate
# ---------------------------------------------------------------------------

ADD, SUB, NEG = 0, 1, 2  # K-RNS-ADD's ops (`lft_rns_add`)


def _add_layout(name: str, a: torch.Tensor, b: torch.Tensor | None, limbs: int) -> tuple[tuple, int, int, int]:
    """(output shape, its rows, a's rows, b's rows) of K-RNS-ADD's operands:
    each (..., limbs, n) for one power of two n (the ring, or a block of its
    columns), its leading axes the output's (leading ones aside: the same
    rows in memory) or none but ones (an (L, n) operand, e.g. a plaintext,
    repeated over the other's leading axes: its rows are then the limbs).
    Raises ValueError on any other shape, on either device."""
    ops = (a,) if b is None else (a, b)
    n = a.shape[-1] if a.dim() else 0
    for t in ops:
        if t.dim() < 2 or tuple(t.shape[-2:]) != (limbs, n) or n < 1 or n & (n - 1):
            raise ValueError(f"{name}: expected (..., {limbs}, n) with n a power of two, the same for both, got {[tuple(t.shape) for t in ops]}")
    try:
        shape = tuple(torch.broadcast_shapes(*(t.shape for t in ops)))
    except RuntimeError as err:
        raise ValueError(f"{name}: the operands do not broadcast: {[tuple(t.shape) for t in ops]}") from err
    rows = math.prod(shape[:-1])
    counts = []
    for t in ops:
        if math.prod(t.shape[:-1]) == rows:
            counts.append(rows)
        elif math.prod(t.shape[:-2]) == 1:
            counts.append(limbs)
        else:
            raise ValueError(f"{name}: an operand's leading axes must be the other's, or absent (an (L, N) operand), got {[tuple(t.shape) for t in ops]}")
    return shape, rows, counts[0], counts[-1]


def _elementwise(fn, op: int, a, b, plan: RnsPlan):
    """K-RNS-ADD: `op` (ADD, SUB, NEG) of a and b (None for NEG) mod each
    row's prime, a and b tensors or pairs of them (a ciphertext's b and a:
    one launch, each part with its own layout, so a batched b beside an
    unbatched a is one launch too); `_add_layout` gives the shapes taken,
    and a strided operand is copied first. On the CPU the plain versions
    (`add_mod_v`, `sub_mod_v`, `neg_mod_v`) after the same checks; on the
    card the kernel, or the wrapper raises."""
    name = fn.__name__
    pair = isinstance(a, (tuple, list))
    xs = tuple(a) if pair else (a,)
    ys = (None,) * len(xs) if op == NEG else tuple(b) if pair else (b,)
    if not 1 <= len(xs) <= 2 or len(ys) != len(xs):
        raise ValueError(f"{name}: takes one tensor or a pair (and as many second operands), got {len(xs)} and {len(ys)}")
    for t in (*xs, *ys):
        if t is not None and t.dtype != torch.int64:
            raise ValueError(f"{name}: the operands must be int64 tensors, got {t.dtype}")
    xs, ys = (tuple(None if t is None else t.contiguous() for t in ts) for ts in (xs, ys))
    limbs = len(plan.qs)
    layouts = [_add_layout(name, x, y, limbs) for x, y in zip(xs, ys)]
    n = layouts[0][0][-1]
    if any(lay[0][-1] != n for lay in layouts):
        raise ValueError(f"{name}: the parts of a pair must share one ring, got {[lay[0] for lay in layouts]}")
    fn.calls += 1
    dev = xs[0].device
    if xs[0].is_cpu:
        q = rns_tables(plan, dev).q
        out = tuple(neg_mod_v(x, q) if op == NEG else (add_mod_v if op == ADD else sub_mod_v)(x, y, q) for x, y in zip(xs, ys))
        return out if pair else out[0]
    if n < 2:
        raise ValueError(f"{name}: the kernel moves 16-byte words of two values, got n = {n}")
    for t in (*xs, *ys):
        if t is not None:
            kernels.require(name, t, torch.int64)
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the kernel reads and writes 16-byte words; an operand is not 16-byte aligned")
    out = tuple(torch.empty(lay[0], dtype=torch.int64, device=dev) for lay in layouts)
    live = [i for i, lay in enumerate(layouts) if lay[1]]  # the parts with rows
    if live:
        ptr = lambda ts, k: ts[live[k]].data_ptr() if k < len(live) and ts[live[k]] is not None else 0  # noqa: E731
        rows = [layouts[i][1:] for i in live] + [(0, 0, 0)] * (2 - len(live))
        kernels.launch(
            "lft_rns_add", ptr(xs, 0), ptr(ys, 0), ptr(out, 0), ptr(xs, 1), ptr(ys, 1), ptr(out, 1),
            rns_tables(plan, dev).q.data_ptr(), op, limbs, n.bit_length() - 1, *rows[0], *rows[1],
        )  # fmt: skip
        fn.launches += 1
        fn.by_rows[sum(layouts[i][1] for i in live)] += 1
    return out if pair else out[0]


def rns_add(a, b, plan: RnsPlan):
    """(a + b) mod q_limb (`rns.py:268`), a and b tensors or pairs (see
    `_elementwise`)."""
    return _elementwise(rns_add, ADD, a, b, plan)


def rns_sub(a, b, plan: RnsPlan):
    """(a - b) mod q_limb (`rns.py:272`)."""
    return _elementwise(rns_sub, SUB, a, b, plan)


def rns_neg(a, plan: RnsPlan):
    """-a mod q_limb (`rns.py:276`)."""
    return _elementwise(rns_neg, NEG, a, None, plan)


def rns_mul_eval(a, b, plan: RnsPlan):
    """Pointwise product in the evaluation basis (either operand may be the
    (L, N) one broadcast over the other's leading axes)."""
    if a.dim() < b.dim():
        a, b = b, a
    return rns_mac([a], [b], plan)


def rns_mul(a, b, plan: RnsPlan):
    """Coefficient-basis negacyclic product, all limbs fused: the product of
    the transforms inside the inverse (either operand may be the (L, N) one
    broadcast over the other's leading axes)."""
    ea, eb = rns_ntt(a, plan), rns_ntt(b, plan)
    if ea.dim() < eb.dim():
        ea, eb = eb, ea
    return rns_intt_mac([ea], [eb], plan)


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


def _check_out_rows(x: torch.Tensor, lq: int, lp: int, out: torch.Tensor, rows, own) -> None:
    """Raise ValueError unless out (x's leading axes, R rows of x's N) takes
    lp output rows `rows` and, where given, x's lq limbs at rows `own`, all
    distinct and below R."""
    if rows is None or len(rows) != lp or (own is not None and len(own) != lq):
        raise ValueError(f"base_convert: out takes one row for each of the {lp} output limbs (and, with own, each of the {lq} input limbs)")
    if out.dim() != x.dim() or tuple(out.shape[:-2]) != tuple(x.shape[:-2]) or out.shape[-1] != x.shape[-1] or out.dtype != torch.int64:
        raise ValueError(f"base_convert: out must be int64 of x's leading axes and N, got {tuple(out.shape)} for x {tuple(x.shape)}")
    every = (*rows, *(own or ()))
    if len(set(every)) != len(every) or not all(0 <= r < out.shape[-2] for r in every):
        raise ValueError(f"base_convert: the rows must be distinct and below {out.shape[-2]}, got {every}")


@lru_cache(maxsize=None)
def _rows_table(rows: tuple[int, ...], device: torch.device) -> torch.Tensor:
    """K-BASECONV's row table (int32) on a device, made once."""
    return torch.tensor(rows, dtype=torch.int32, device=device)


def base_convert(x: torch.Tensor, qs: tuple[int, ...], ps: tuple[int, ...], add=None, out=None, rows=None, own=None) -> torch.Tensor:
    """Approximate base extension (`rns.rs:331-345`) of x (..., Lq, N) over qs
    into (..., Lp, N) over ps: v_i = x_i q_hat_i^-1 mod q_i; u = round(sum
    v_i / q_i) in f64; out_j = sum_i (q_hat_i mod p_j) v_i - (u Q mod p_j).
    `add` (a per-input-limb constant, or None) is added to x mod q_i first.
    x may be a view whose rows are contiguous (a slice of the limb axis).
    With out (a (..., R, N) tensor of x's leading axes whose rows are
    contiguous and whose leading axes merge: a digit's slice of the key
    switch's (..., D, Lqp, N)), output limb j goes into out's row rows[j]
    and, with own, x's limb k (before add) into row own[k], in the same
    launch; returns out."""
    if out is not None:
        _check_out_rows(x, len(qs), len(ps), out, rows, own)
    if x.is_cpu:
        y = base_convert_ref(x, qs, ps, add)
        if out is None:
            return y
        out[..., list(rows), :] = y
        if own is not None:
            out[..., list(own), :] = x
        return out
    n = x.shape[-1]
    if len(qs) > MAX_LIMBS:
        raise ValueError(f"base_convert: the kernel takes at most {MAX_LIMBS} input limbs, got {len(qs)}")
    batch, stride = _batch_layout("base_convert", x, len(qs), n)
    if out is None:
        out = torch.empty((*x.shape[:-2], len(ps), n), dtype=torch.int64, device=x.device)
    if not batch:
        return out
    _, y_stride = _batch_layout("base_convert", out, out.shape[-2], n)
    add_t = None if add is None else _add_tensor(tuple(int(a) for a in add), x.device)
    for j, m, table, copy in _conv_launches(len(qs), len(ps), rows, own):
        t = base_extend_tables(base_extend_plan(qs, ps[j : j + m]), x.device)
        kernels.launch(
            "lft_base_convert_rows", x.data_ptr(), out.data_ptr(), *(v.data_ptr() for v in t),
            0 if add_t is None else add_t.data_ptr(), 0 if table is None else _rows_table(table, x.device).data_ptr(),
            int(copy), len(qs), m, n.bit_length() - 1, batch, stride, y_stride,
        )  # fmt: skip
        _count(base_convert, (batch * len(qs), len(qs), m))
        base_convert.rows_launches += table is not None
    return out


def _conv_launches(lq: int, lp: int, rows, own) -> list[tuple[int, int, tuple | None, bool]]:
    """K-BASECONV's launches of lq -> lp limbs, one per slice of
    `_conv_out_limbs(lq)` output limbs (the tables of all of them outgrow a
    block's shared memory): (first output limb, output limbs, row table or
    None, copy) each. The table (`lft_base_convert_rows`) holds x's limbs'
    rows (0s where the launch copies none: only the first copies them),
    then the slice's outputs' rows; None (rows j of a fresh (..., lp, N))
    for a lone launch without `rows`."""
    most = _conv_out_limbs(lq)
    if rows is None and lp > most:  # the slices' outputs into one fresh tensor
        rows = tuple(range(lp))
    launches = []
    for j in range(0, lp, most):
        m, copy = min(most, lp - j), own is not None and j == 0
        table = None if rows is None else (*(own if copy else (0,) * lq), *rows[j : j + m])
        launches.append((j, m, None if table is None else tuple(int(r) for r in table), copy))
    return launches


def _conv_out_limbs(lq: int) -> int:
    """Output limbs one K-BASECONV launch takes: its block's tables within
    227 KB of shared memory, as `rns64.cu::conv_words` counts them (per
    input limb 5 words; per output limb 2, lq of w' and lq + 1 of the
    correction; one more; the instance for an lq other than 1, 2 or 8 also
    its 256 threads' v)."""
    fixed = 5 * lq + 1 + (0 if lq in (1, 2, 8) else 256 * lq)
    return (227 * 1024 // 8 - fixed) // (2 * lq + 3)


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


def _rescale_adds(add, out_shape: tuple) -> tuple[tuple, tuple]:
    """rescale's `add` (see `rescale_finish`) as (fused, later), each () for
    None, one entry for one tensor, or two for the pair an output of leading
    axis 2 takes: fused holds the adds the launch takes (None, or a
    contiguous int64 tensor of the output part's shape), later those of
    another shape (None where fused holds it), which K-RNS-ADD adds after
    the launch, broadcast as the JAX package's `rns_add` does (a batched b
    on the switch of an unbatched a). Raises ValueError on a pair for
    another output or a non-int64 add, on either device."""
    if add is None:
        return (), ()
    if isinstance(add, (tuple, list)):
        if len(add) != 2 or len(out_shape) < 3 or out_shape[0] != 2:
            raise ValueError(f"rescale: a pair of adds takes an output of leading axis 2, got {tuple(out_shape)}")
        parts, shape = tuple(add), tuple(out_shape[1:])
    else:
        parts, shape = (add,), tuple(out_shape)
    for a in parts:
        if a is not None and a.dtype != torch.int64:
            raise ValueError(f"rescale: an add must be an int64 tensor, got {a.dtype}")
    fits = [a is not None and tuple(a.shape) == shape for a in parts]
    return tuple(a.contiguous() if f else None for a, f in zip(parts, fits)), tuple(None if f else a for a, f in zip(parts, fits))


def _rescale_result(y: torch.Tensor, add, later: tuple, keep: tuple):
    """rescale's output y with the adds `later` (see `_rescale_adds`) added by
    K-RNS-ADD: for a pair of adds the pair of parts, else one tensor."""
    plan = rns_plan(keep, y.shape[-1])
    if isinstance(add, (tuple, list)):
        return tuple(v if a is None else rns_add(v, a, plan) for v, a in zip(y, later))
    return y if not later or later[0] is None else rns_add(y, later[0], plan)


def rescale_finish_ref(x: torch.Tensor, conv: torch.Tensor | None, rp: RescalePlan, add=None):
    """From x (..., L, N) and, for k > 1, the base conversion of its last k
    limbs (+ P/2) into the kept primes: (x + P/2 - r) P^-1 mod q per kept
    limb, r the dropped limb (k = 1, reduced where drop[0] >= q) or conv;
    then + add mod q (`rescale_finish`'s add and result)."""
    dev, lk = x.device, len(rp.keep)
    keep_q = _col(rp.keep, dev)
    head = add_mod_v(x[..., :lk, :], _col(rp.p_half[:lk], dev), keep_q)
    if conv is None:
        d = rp.drop[0]
        rp_v = add_mod_v(x[..., lk, :], rp.p_half[lk], d)  # (..., N) values < drop[0]
        conv = torch.stack([barrett_all(rp_v, q) if d >= q else rp_v for q in rp.keep], dim=-2)
    head = sub_mod_v(head, conv, keep_q)
    y = mul_shoup_v(head, u64_to_torch(rp.p_inv[:, None], dev), u64_to_torch(rp.p_inv_shoup[:, None], dev), keep_q)
    fused, later = _rescale_adds(add, tuple(y.shape))
    if len(fused) == 2:
        y = torch.stack([v if a is None else add_mod_v(v, a, keep_q) for v, a in zip(y, fused)])
    elif fused and fused[0] is not None:
        y = add_mod_v(y, fused[0], keep_q)
    return _rescale_result(y, add, later, rp.keep)


def rescale_finish(x: torch.Tensor, conv: torch.Tensor | None, rp: RescalePlan, add=None):
    """K-RESCALE: the last step of `rescale_k`, on x (..., L, N), then + add
    mod q in the same launch: add is None, a tensor, or for an x whose
    leading axis is 2 (CKKS's b and a) a pair, either entry None
    (`drop_limbs_t` takes its adds the same way); a pair gives the pair of
    parts. An add of the output's (part's) shape goes into the launch; one
    that broadcasts beyond it is added after it by K-RNS-ADD, as the JAX
    package's `rns_add` broadcasts."""
    if x.is_cpu:
        return rescale_finish_ref(x, conv, rp, add)
    n, lk = x.shape[-1], len(rp.keep)
    rows = _check_rows("rescale_finish", x, len(rp.qs), n)
    out_shape = (*x.shape[:-2], lk, n)
    if conv is not None:
        kernels.require("rescale_finish", conv, torch.int64, out_shape)
    fused, later = _rescale_adds(add, out_shape)
    for a in fused:
        if a is not None:
            kernels.require("rescale_finish", a, torch.int64)
    y = torch.empty(out_shape, dtype=torch.int64, device=x.device)
    if rows:
        t = rescale_tables(rp, x.device)
        d, batch = rp.drop[0], rows // len(rp.qs)
        ptr = lambda i: fused[i].data_ptr() if i < len(fused) and fused[i] is not None else 0  # noqa: E731
        kernels.launch(
            "lft_rescale_add", x.data_ptr(), 0 if conv is None else conv.data_ptr(), y.data_ptr(), *(v.data_ptr() for v in t),
            ptr(0), ptr(1), len(rp.qs), lk, n.bit_length() - 1, batch, batch // 2 if len(fused) == 2 else batch, d,
            rp.p_half[lk],
        )  # fmt: skip
        _count(rescale_finish, rows)
        rescale_finish.add_launches += any(a is not None for a in fused)
    return _rescale_result(y, add, later, rp.keep)


def rescale_k(x: torch.Tensor, qs: tuple[int, ...], k: int, add=None):
    """Divide-and-round by the product of the last k primes (`rns.rs:103-118`):
    x (..., L, N) over qs -> (..., L-k, N) over qs[:-k]; then + add mod q
    (`rescale_finish`: in the same launch where add has the output's shape;
    a pair of adds gives the pair of parts), the JAX package's `rns_add`
    after its `rescale_k`."""
    rp = rescale_plan(qs, k)
    lk = len(rp.keep)
    conv = None if k == 1 else base_convert(x[..., lk:, :], rp.drop, rp.keep, add=rp.p_half[lk:])
    return rescale_finish(x, conv, rp, add)


# ---------------------------------------------------------------------------
# The t-corrected limb drop (BGV's modulus switch, `models/bgv/bgv.py:154-194`)
# ---------------------------------------------------------------------------

MAX_DROP_LIMBS = 16  # K-BGV-DROP: a column's limbs in registers (an instance per count 2..16)


@lru_cache(maxsize=None)
def _drop_table(qs: tuple[int, ...], t: int, steps: int) -> np.ndarray:
    """K-BGV-DROP's table for `steps` drops from qs with plaintext modulus t
    (the JAX package's `_DropPlan` of each step), as `csrc/bgv.cu` reads it:
    the MAX_DROP_LIMBS primes (0 past L), then per step s (dropping q_l =
    qs[L-1-s]) q_l, q_l^-1 mod t and per kept limb i (MAX_DROP_LIMBS slots)
    q_l^-1 mod q_i and its Shoup dual."""
    m = MAX_DROP_LIMBS
    tab = np.zeros(m + steps * (2 + 2 * m), dtype=np.uint64)
    tab[: len(qs)] = qs
    for s in range(steps):
        ql, base = qs[len(qs) - 1 - s], m + s * (2 + 2 * m)
        tab[base : base + 2] = ql, mod_inverse(ql % t, t)
        for i, q in enumerate(qs[: len(qs) - 1 - s]):
            inv = mod_inverse(ql % q, q)
            tab[base + 2 + 2 * i : base + 4 + 2 * i] = inv, (inv << 64) // q
    return tab


@lru_cache(maxsize=None)
def drop_table(qs: tuple[int, ...], t: int, steps: int, device: torch.device) -> torch.Tensor:
    return u64_to_torch(_drop_table(qs, t, steps), device)


def _drop_limb_ref(x: torch.Tensor, qs: tuple[int, ...], t: int) -> torch.Tensor:
    """x (..., L, N) over qs -> (..., L-1, N) over qs[:-1]: exactly (x - d) /
    q_l with d = x (mod q_l), d = 0 (mod t), in int64 as the JAX package
    computes it (torch's % is floor-mod, as jnp.mod)."""
    dev, ql, keep = x.device, qs[-1], qs[:-1]
    inv_ql_t = mod_inverse(ql % t, t)
    r = x[..., -1, :]  # in [0, ql)
    rc = torch.where(r > ql // 2, r - ql, r)  # centered, |rc| <= ql/2
    k = ((t - rc % t) * inv_ql_t) % t
    kc = torch.where(k > t // 2, k - t, k)  # |kc| <= t/2
    keep_q = _col(keep, dev)
    d_mod = (rc[..., None, :] % keep_q + _col([ql % q for q in keep], dev) * kc[..., None, :]) % keep_q
    inv = [mod_inverse(ql % q, q) for q in keep]
    num = sub_mod_v(x[..., :-1, :], d_mod, keep_q)
    return mul_shoup_v(num, _col(inv, dev), _col([(w << 64) // q for w, q in zip(inv, keep)], dev), keep_q)


def drop_limbs_t_ref(x: torch.Tensor, qs: tuple[int, ...], t: int, k: int, add=None, then: int = 0) -> torch.Tensor:
    """The plain version of `drop_limbs_t` on one tensor: k drops, add (a
    tensor over qs[:-k], or None) mod q, `then` more drops."""
    basis = qs
    for _ in range(k):
        x, basis = _drop_limb_ref(x, basis, t), basis[:-1]
    if add is not None:
        x = add_mod_v(x, add, _col(basis, x.device))
    for _ in range(then):
        x, basis = _drop_limb_ref(x, basis, t), basis[:-1]
    return x


def _drop_check(name: str, x: torch.Tensor, shape: tuple) -> None:
    kernels.require(name, x, torch.int64, shape)
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel moves two columns in 16-byte words; a tensor is not 16-byte aligned")


def drop_limbs_t(x, qs: tuple[int, ...], t: int, k: int, add=None, then: int = 0):
    """K-BGV-DROP: drop the k trailing limbs of x (..., L, N) over qs one at a
    time, each exactly (x - d) / q_l with d = x (mod q_l), d = 0 (mod t)
    (BGV's modulus switch, the JAX package's `_drop_limb` k times); then add
    `add` (over the kept limbs) mod q; then drop `then` more limbs. x is a
    tensor or a pair (b, a) of one shape, in one launch; add is None, a
    tensor, or for a pair a pair whose entries may be None. Returns what it
    was given, over qs[:L-k-then]. On the card every prime must exceed half
    of the largest (so a centered residue needs one conditional add) and
    t max(q) < 2^63, t < 2^32; the wrapper raises otherwise."""
    pair = isinstance(x, (tuple, list))
    xs = tuple(x) if pair else (x,)
    adds = (tuple(add) if pair else (add,)) if add is not None else (None,) * len(xs)
    if len(adds) != len(xs):
        raise ValueError(f"drop_limbs_t: takes one add (or None) per part, got {len(adds)} for {len(xs)}")
    steps = k + then
    if k < 1 or then < 0 or steps >= len(qs):
        raise ValueError(f"drop_limbs_t: cannot drop {k} + {then} of {len(qs)} limbs")
    if xs[0].is_cpu:
        out = tuple(drop_limbs_t_ref(v, qs, t, k, a, then) for v, a in zip(xs, adds))
        return out if pair else out[0]
    name, L, n = "drop_limbs_t", len(qs), xs[0].shape[-1]
    if not 2 <= L <= MAX_DROP_LIMBS or not 2 <= n or n & (n - 1) or len(xs) > 2:
        raise ValueError(f"drop_limbs_t: the kernel takes 2..{MAX_DROP_LIMBS} limbs, N >= 2 a power of 2 and one or two parts, got L={L}, N={n}, {len(xs)} parts")
    if 2 * min(qs) <= max(qs) or t >= 1 << 32 or t * max(qs) >= 1 << 63:
        raise ValueError("drop_limbs_t: the kernel needs max(q) / 2 < min(q), t < 2^32 and t max(q) < 2^63")
    shape = tuple(xs[0].shape)
    if len(shape) < 2 or shape[-2] != L:
        raise ValueError(f"drop_limbs_t: expected (..., {L}, {n}), got {shape}")
    mid = (*shape[:-2], L - k, n)
    for v in xs:
        _drop_check(name, v, shape)
    for a in adds:
        if a is not None:
            _drop_check(name, a, mid)
    ys = tuple(torch.empty((*shape[:-2], L - steps, n), dtype=torch.int64, device=v.device) for v in xs)
    rows = xs[0].numel() // (L * n)
    if rows:
        ptr = lambda ts, i: ts[i].data_ptr() if i < len(ts) and ts[i] is not None else 0  # noqa: E731
        kernels.launch(
            "lft_bgv_drop", ptr(xs, 0), ptr(xs, 1), ptr(adds, 0), ptr(adds, 1), ptr(ys, 0), ptr(ys, 1),
            drop_table(qs, t, steps, xs[0].device).data_ptr(), L, k, then, n.bit_length() - 1, rows, t, (1 << 64) // t,
        )  # fmt: skip
        drop_limbs_t.launches += 1
        drop_limbs_t.by_rows[len(xs) * rows, L, steps] += 1
    return ys if pair else ys[0]


ELEMENTWISE = (rns_add, rns_sub, rns_neg)  # K-RNS-ADD's wrappers

# launches, and launches by row count (K-BASECONV: (input rows, input
# limbs, output limbs); rns_intt_mac: (output rows, terms); K-AUTOMORPH and
# K-RNS-ADD: rows of all its parts; K-BGV-DROP: (rows of all its parts,
# limbs, drops));
# of the MAC's, those of its gathered instances and theirs by row count; of
# rns_intt_mac's, those of its shared-x ones
for _fn in (rns_ntt, rns_intt, rns_mac, rns_intt_mac, base_convert, rescale_finish, automorphism_rns, drop_limbs_t, *ELEMENTWISE):
    _fn.launches, _fn.by_rows = 0, Counter()
for _fn in ELEMENTWISE:  # K-RNS-ADD's wrappers also count their calls, on either device
    _fn.calls = 0
base_convert.rows_launches = 0  # K-BASECONV's launches into a caller's rows
rescale_finish.add_launches = 0  # K-RESCALE's launches with an add
for _fn in (rns_mac, rns_intt_mac):
    _fn.gather_launches, _fn.gather_by_rows = 0, Counter()
rns_intt_mac.shared_launches = 0
