"""LMKCDEY blind-rotation bootstrapping (eprint 2022/198;
`learn_fhe_tpu/models/fhew/bootstrapping.py`, reference
`scheme/fhew/src/bootstrapping.rs`):

    mod_switch(Q -> Q_ks) -> LWE key_switch (N -> n) -> mod_switch_odd(-> 2N)
    -> blind rotation (external products bucketed by dlog_g(a_i), an
       automorphism every <= w steps) -> sample_extract(0)

The LWE mask is public, so the walk's (external product | automorphism)
sequence is built on the host per ciphertext (`build_schedule`) and fused
into (ext_idx, auto_idx) pairs (`fuse_schedule`). On the card the schedule
comes from the C copy of that transcription in the kernel library
(`csrc/fhew_blind_rotate.cu`), and the whole walk of a batch is one launch
of K-FHEW-BR (`blind_rotate_core_fused`), which replaces the JAX package's
`lax.scan` (`blind_rotate_core_fused`, :423), vmapped over the batch.

On the u64 engine (q >= 2^31, or a digit span over 31 bits: the multi-key
parameter sets) the walk is one launch of K-FHEW-BR64
(`blind_rotate_core_fused64`, `csrc/fhew_u64.cu`), the u64 branch of the
same scan (`u32` false at :436).

Each ciphertext walks its own schedule to its end, and a batch runs at its
own size: the JAX package's `_trim_len` and the gates' padding exist only
to keep its jit cache small, and are not carried over.

Multi-key (`bootstrapping.rs:233-321`): `crs_gen` draws the common
reference string, each party's `key_share_gen` its LWE key switching key
share, its brk encrypted under the merged public key and its automorphism
key shares, and `key_share_merge` sums the shares and folds the brk shares
through RGSW internal products (K-EXTPROD64), chunk by chunk as the JAX
package does.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple

import numpy as np
import torch

from ...ops.modular import neg_mod
from ...ops.ntt import table_pointers
from ...ops.ntt32 import _table_pointers
from ...ops.poly import automorphism_map, automorphism_zq, monomial_mul_zq
from ...utils import kernels
from ...utils.distributions import uniform_zq
from ...utils.interop import resolve_device, u64_to_torch
from . import lwe, rgsw, rlwe
from .lwe import LweCiphertext, LweKeySwitchingKey
from .params import AUTO_G, LweParams, RgswParams, RlweParams
from .rgsw import RgswEval
from .rlwe import RlweCiphertext

OP_EXT, OP_AUTO, OP_NOOP = 0, 1, 2
FHEW_MAX_ROWS = 16  # digit rows K-FHEW-BR's shared buffer takes: max(2d, d_ks)


@dataclass(frozen=True)
class BootstrapParams:
    """RGSW(big Q, N) + small LWE(q_ks, n) + window w (`bootstrapping.rs:21-90`).

    `gate_pad` is kept for signature parity with the JAX package, where it
    buckets gate batches for the jit cache; the port ignores it."""

    rgsw: RgswParams
    lwe_s: LweParams
    w: int
    gate_pad: tuple[int, ...] | None = None

    def __post_init__(self):
        assert self.rgsw.p == self.lwe_s.p

    @property
    def rlwe(self) -> RlweParams:
        return self.rgsw.rlwe

    @cached_property
    def lwe_z(self) -> LweParams:
        """Big-Q LWE view of the RLWE dimension (`bootstrapping.rs:42-44`)."""
        return LweParams(q=self.big_q, p=self.p, n=self.n)

    @property
    def p(self) -> int:
        return self.rgsw.p

    @property
    def n(self) -> int:
        return self.rgsw.n

    @property
    def big_q(self) -> int:
        return self.rgsw.q

    @property
    def big_q_ks(self) -> int:
        return self.lwe_s.q

    @property
    def q(self) -> int:
        return 2 * self.n

    @property
    def q_by_8(self) -> int:
        return self.q // 8

    @property
    def big_q_by_8(self) -> int:
        return round(self.big_q / 8.0)

    @property
    def big_q_by_4(self) -> int:
        return round(self.big_q / 4.0)

    @cached_property
    def ak_t(self) -> list[int]:
        """Automorphism exponents [-g, g, g^2, .., g^w], centered
        (`bootstrapping.rs:86-90`)."""
        two_n, g = self.q, AUTO_G % self.q
        ts, acc = [(-g) % two_n], 1
        for _ in range(self.w):
            acc = acc * g % two_n
            ts.append(acc)
        return [v if v < two_n // 2 else v - two_n for v in ts]

    @cached_property
    def schedule_len(self) -> int:
        """Longest unfused schedule: n external products + <= N/2 + 2 autos."""
        return self.lwe_s.n + self.n // 2 + 2

    @cached_property
    def dlog_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """value -> l maps for -g^l and g^l mod 2N, -1 where undefined
        (`bootstrapping.rs:228-231`)."""
        two_n = self.q
        minus = np.full(two_n, -1, dtype=np.int64)
        plus = np.full(two_n, -1, dtype=np.int64)
        acc = 1
        for l in range(self.n // 2):
            plus[acc % two_n] = l
            minus[(-acc) % two_n] = l
            acc = acc * (AUTO_G % two_n) % two_n
        return minus, plus


class BootstrapKey(NamedTuple):
    """Key material in the evaluation basis: on the u32 engine int32 values
    with Shoup duals, on the u64 engine int64 values in the Montgomery domain
    with the dual fields None; the LWE key switch's rows as int64 values."""

    ksk_a: torch.Tensor  # (d_ks, N, n)
    ksk_b: torch.Tensor  # (d_ks, N)
    brk_a: torch.Tensor  # (n, 2d, N) blind-rotation RGSW keys
    brk_b: torch.Tensor
    ak_a: torch.Tensor  # (w+1, d, N) automorphism keys
    ak_b: torch.Tensor
    auto_src: torch.Tensor  # (w+1, N) int32 gather maps of X -> X^t
    auto_sign: torch.Tensor  # (w+1, N) bool
    brk_ad: torch.Tensor | None = None  # Shoup duals (u32 engine)
    brk_bd: torch.Tensor | None = None
    ak_ad: torch.Tensor | None = None
    ak_bd: torch.Tensor | None = None


def _monomial_poly(n: int, q: int, exps: np.ndarray) -> np.ndarray:
    """The polynomials X^{e_j} mod q: (len(exps), N) u64."""
    out = np.zeros((len(exps), n), dtype=np.uint64)
    i = np.asarray(exps, dtype=np.int64) % (2 * n)
    rows = np.arange(len(exps))
    out[rows, np.where(i < n, i, i - n)] = np.where(i < n, 1, q - 1).astype(np.uint64)
    return out


def key_gen(
    params: BootstrapParams,
    z: np.ndarray,
    rng: np.random.Generator,
    device: torch.device | str | None = None,
) -> BootstrapKey:
    """ksk: Q_ks LWE N -> n; brk_j = RGSW(X^{s_j}); ak for each t in ak_t
    (`bootstrapping.rs:121-146`). Draws from rng exactly as the JAX key_gen.
    The key goes to `device`, by default the current CUDA device; without
    one this raises unless device="cpu" (see `resolve_device`)."""
    device = resolve_device(device)
    s = lwe.sk_gen(params.lwe_s, rng)
    ksk = lwe.ksk_gen(params.lwe_s, s, z, rng, device)
    brk_pt = u64_to_torch(_monomial_poly(params.n, params.big_q, s), device)
    brk_eval = rgsw.to_eval(params.rgsw, rgsw.sk_encrypt_rgsw(params.rgsw, z, brk_pt, rng))
    aks = [rlwe.ak_gen(params.rlwe, t, z, rng, device) for t in params.ak_t]
    return _pack_key(params, ksk, brk_eval, [ak.ksk for ak in aks])


def _pack_key(
    params: BootstrapParams,
    ksk: LweKeySwitchingKey,
    brk_eval: RgswEval,
    ak_ksks: list[rlwe.RlweKeySwitchingKey],
) -> BootstrapKey:
    device = brk_eval.a.device
    maps = [automorphism_map(params.n, t) for t in params.ak_t]
    u32 = params.rgsw.use_u32 and brk_eval.a_dual is not None
    return BootstrapKey(
        ksk_a=ksk.a,
        ksk_b=ksk.b,
        brk_a=brk_eval.a,
        brk_b=brk_eval.b,
        ak_a=torch.stack([k.a_eval for k in ak_ksks]),
        ak_b=torch.stack([k.b_eval for k in ak_ksks]),
        auto_src=torch.from_numpy(np.stack([m[0] for m in maps]).astype(np.int32)).to(device),
        auto_sign=torch.from_numpy(np.stack([m[1] for m in maps])).to(device),
        brk_ad=brk_eval.a_dual,
        brk_bd=brk_eval.b_dual,
        ak_ad=torch.stack([k.a_dual for k in ak_ksks]) if u32 else None,
        ak_bd=torch.stack([k.b_dual for k in ak_ksks]) if u32 else None,
    )


# -- the schedule, on the host (public data) ------------------------------------


def build_schedule(params: BootstrapParams, a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Alg 3's control flow over the public mask a (values in Z_2N) as an
    (op, idx) array pair of length `schedule_len`, NOOP-padded
    (`bootstrapping.rs:171-231`). a: (..., n). The plain version: the card
    path runs its C copy (`schedule`)."""
    a = np.asarray(a, dtype=np.int64)
    if a.ndim > 1:
        pairs = [build_schedule(params, row) for row in a.reshape(-1, a.shape[-1])]
        return tuple(np.stack([p[i] for p in pairs]).reshape(*a.shape[:-1], -1) for i in (0, 1))
    minus_map, plus_map = params.dlog_tables
    half = params.n // 2
    i_minus = [[] for _ in range(half)]
    i_plus = [[] for _ in range(half)]
    for j, aj in enumerate(a):
        lm, lp = minus_map[aj], plus_map[aj]
        if lm >= 0 and lp < 0:
            i_minus[lm].append(j)
        elif lp >= 0 and lm < 0:
            i_plus[lp].append(j)
        elif aj != 0:
            raise AssertionError("value in both dlog tables")

    steps: list[tuple[int, int]] = []

    def walk(buckets):
        v = 0
        for l in range(len(buckets) - 1, 0, -1):
            steps.extend((OP_EXT, j) for j in buckets[l])
            v += 1
            if buckets[l - 1] or v == params.w or l == 1:
                steps.append((OP_AUTO, v))
                v = 0

    walk(i_minus)
    steps.extend((OP_EXT, j) for j in i_minus[0])
    steps.append((OP_AUTO, 0))  # ak[0]: t = -g
    walk(i_plus)
    steps.extend((OP_EXT, j) for j in i_plus[0])

    L = params.schedule_len
    assert len(steps) <= L, (len(steps), L)
    ops = np.full(L, OP_NOOP, dtype=np.int32)
    idxs = np.zeros(L, dtype=np.int32)
    if steps:
        ops[: len(steps)], idxs[: len(steps)] = np.array(steps, dtype=np.int32).T
    return ops, idxs


def fuse_schedule(ops: np.ndarray, idxs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Merge each automorphism into the external product before it: an
    (op, idx) stream becomes (ext_idx, auto_idx) pairs, -1 where absent,
    with the same order of operations (ext phase, then auto phase, per
    step). The output's length is the longest fused schedule of the batch;
    a ciphertext's schedule ends at its first (-1, -1)."""
    ops2 = ops.reshape(-1, ops.shape[-1])
    idxs2 = idxs.reshape(-1, idxs.shape[-1])
    B, L = ops2.shape
    e_out = np.full((B, L), -1, dtype=np.int32)
    a_out = np.full((B, L), -1, dtype=np.int32)
    max_len = 1
    for b in range(B):
        k, open_ext = 0, False  # next step to write; step k-1 is an ext with no auto yet
        for t in range(L):
            op = ops2[b, t]
            if op == OP_EXT:
                e_out[b, k] = idxs2[b, t]
                open_ext = True
                k += 1
            elif op == OP_AUTO:
                if open_ext:
                    a_out[b, k - 1] = idxs2[b, t]
                    open_ext = False
                else:
                    a_out[b, k] = idxs2[b, t]
                    k += 1
            else:  # NOOP padding, only at the tail
                break
        max_len = max(max_len, k)
    shape = (*ops.shape[:-1], max_len)
    return e_out[:, :max_len].reshape(shape), a_out[:, :max_len].reshape(shape)


def check_schedule(params: BootstrapParams, ext_idx: np.ndarray, auto_idx: np.ndarray) -> None:
    """Raise unless every index of a fused schedule is -1 or names a key:
    ext_idx < n (brk), auto_idx <= w (ak). The schedule is checked here, on
    the host where it is built, so that the walk's wrapper reads nothing
    back from the card; K-FHEW-BR itself ends a ciphertext's walk at an
    index outside the key and flags it (`walk_error`)."""
    for name, idx, bound in (("ext_idx", ext_idx, params.lwe_s.n), ("auto_idx", auto_idx, params.w + 1)):
        if idx.size and (idx.min() < -1 or idx.max() >= bound):
            raise ValueError(f"schedule: {name} out of range ({idx.min()}..{idx.max()}; keys 0..{bound - 1}, or -1)")


def schedule_native(params: BootstrapParams, a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """`build_schedule` then `fuse_schedule` on a (B, n) host mask, by their C
    copy in the kernel library (`lft_fhew_build_schedule`,
    `lft_fhew_fuse_schedule`), checked by `check_schedule`; raises if the
    library cannot be built."""
    a = np.ascontiguousarray(a, dtype=np.int64)
    B, n_lwe = a.shape
    if a.size and (a.min() < 0 or a.max() >= params.q):
        raise ValueError(f"schedule_native: mask values must lie in Z_{params.q}")  # the C code indexes tables by them
    L = params.schedule_len
    minus_map, plus_map = params.dlog_tables
    ops = np.empty((B, L), dtype=np.int32)
    idxs = np.empty((B, L), dtype=np.int32)
    rc = kernels.call(
        "lft_fhew_build_schedule", a.ctypes.data, B, n_lwe, minus_map.ctypes.data, plus_map.ctypes.data,
        params.n // 2, params.w, ops.ctypes.data, idxs.ctypes.data, L,
    )  # fmt: skip
    if rc != 0:
        raise AssertionError("schedule overflow, or a value in both dlog tables")
    e_out = np.empty((B, L), dtype=np.int32)
    a_out = np.empty((B, L), dtype=np.int32)
    max_len = max(1, kernels.call("lft_fhew_fuse_schedule", ops.ctypes.data, idxs.ctypes.data, B, L, e_out.ctypes.data, a_out.ctypes.data))
    e_out, a_out = e_out[:, :max_len], a_out[:, :max_len]
    check_schedule(params, e_out, a_out)
    return e_out, a_out


def schedule(params: BootstrapParams, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused schedule of each row of a (B, n) Z_2N mask, as (B, L) int32
    tensors on a's device: the Python transcription for a CPU tensor, the C
    copy for a CUDA tensor, whose two index arrays go to the card in one
    copy."""
    host = a.cpu().numpy()
    if a.is_cpu:
        e_idx, a_idx = fuse_schedule(*build_schedule(params, host))
        check_schedule(params, e_idx, a_idx)
        return torch.from_numpy(e_idx), torch.from_numpy(a_idx)
    both = torch.from_numpy(np.stack(schedule_native(params, host))).to(a.device)
    return both[0], both[1]


# -- the blind rotation ----------------------------------------------------------


def _u32(params: BootstrapParams, key: BootstrapKey) -> bool:
    """Whether the walk runs on the u32 engine (the JAX package's `u32`)."""
    return params.rgsw.use_u32 and key.brk_ad is not None


def blind_rotate_core_fused_ref(
    params: BootstrapParams,
    key: BootstrapKey,
    ext_idx: torch.Tensor,
    auto_idx: torch.Tensor,
    acc: RlweCiphertext,
) -> RlweCiphertext:
    """Plain version of `blind_rotate_core_fused` (both engines): the JAX
    package's scan step, batched, in a loop over the steps. Step s runs, for
    each ciphertext, the external product with brk[ext_idx[:, s]] where that
    is >= 0, then the automorphism by ak_t[auto_idx[:, s]] with its key
    switch where that is >= 0; the loop ends when every schedule has ended.
    The u64 branch runs `rgsw.external_product64_ref` for both phases."""
    q, u32 = params.big_q, _u32(params, key)
    gg, gk, plan = params.rgsw.gadget, params.rlwe.gadget, params.rlwe.plan

    def ext(a, b, i):
        if u32:
            brk = RgswEval(key.brk_a[i], key.brk_b[i], key.brk_ad[i], key.brk_bd[i])
            return rgsw.external_product(params.rgsw, brk, RlweCiphertext(a, b))
        return rgsw.external_product64_ref(gg, plan, key.brk_a, key.brk_b, i.int(), RlweCiphertext(a, b), False)

    def switch(a, b, i):
        if u32:
            ksk = rlwe.RlweKeySwitchingKey(key.ak_a[i], key.ak_b[i], key.ak_ad[i], key.ak_bd[i])
            return rlwe.key_switch(params.rlwe, ksk, RlweCiphertext(a, b))
        return rgsw.external_product64_ref(gk, plan, key.ak_a, key.ak_b, i.int(), RlweCiphertext(a, b), True)

    a, b = (acc.a.to(torch.int32), acc.b.to(torch.int32)) if u32 else (acc.a.long(), acc.b.long())
    for s in range(ext_idx.shape[-1]):
        e, au = ext_idx[:, s].long(), auto_idx[:, s].long()
        keep_e, keep_a = (e >= 0)[:, None], (au >= 0)[:, None]
        if not bool((keep_e | keep_a).any()):
            break
        if bool(keep_e.any()):
            out = ext(a, b, e.clamp(min=0))
            a, b = torch.where(keep_e, out.a, a), torch.where(keep_e, out.b, b)
        if bool(keep_a.any()):
            i = au.clamp(min=0)
            src, sign = key.auto_src[i].long(), key.auto_sign[i]
            a_g, b_g = torch.gather(a, -1, src), torch.gather(b, -1, src)
            out = switch(torch.where(sign, neg_mod(a_g, q), a_g), torch.where(sign, neg_mod(b_g, q), b_g), i)
            a, b = torch.where(keep_a, out.a, a), torch.where(keep_a, out.b, b)
    return RlweCiphertext(a, b)


def blind_rotate_core_fused(
    params: BootstrapParams,
    key: BootstrapKey,
    ext_idx: torch.Tensor,  # (B, L) int32, -1 = no external product this step
    auto_idx: torch.Tensor,  # (B, L) int32, -1 = no automorphism this step
    acc: RlweCiphertext,  # a, b: (B, N) int32 residues (u32 engine) or int64 (u64)
) -> RlweCiphertext:
    """The fused walk of a batch: K-FHEW-BR (`lft_fhew_blind_rotate`), one
    launch for the whole batch and all its steps, one block per ciphertext,
    with no read back to the host; on the u64 engine K-FHEW-BR64
    (`blind_rotate_core_fused64`). The schedule's indices are checked where
    they are built (`schedule` runs `check_schedule`); the kernel ends a
    ciphertext's walk at an index outside the key, leaves that output as
    the walk stood, and flags it in `walk_error`, which nothing reads here.
    A caller that builds the indices on the card some other way must check
    them itself, or read `walk_error` after its own sync. On CPU tensors,
    the plain version. Returns a new (B, N) pair of acc's dtype."""
    if not _u32(params, key):
        return blind_rotate_core_fused64(params, key, ext_idx, auto_idx, acc)
    if acc.a.is_cpu:
        return blind_rotate_core_fused_ref(params, key, ext_idx, auto_idx, acc)
    name = "blind_rotate_core_fused"
    n, q = params.n, params.big_q
    gg, gk = params.rgsw.gadget, params.rlwe.gadget
    rows = max(2 * gg.d, gk.d)
    if n > 1 << kernels.MAX_LOG_N or rows > FHEW_MAX_ROWS:
        raise ValueError(f"{name}: the kernel takes N <= {1 << kernels.MAX_LOG_N} and at most {FHEW_MAX_ROWS} digit rows")
    B, L = ext_idx.shape
    kernels.require(f"{name} acc.a", acc.a, torch.int32, (B, n))
    kernels.require(f"{name} acc.b", acc.b, torch.int32, (B, n))
    kernels.require(f"{name} ext_idx", ext_idx, torch.int32, (B, L))
    kernels.require(f"{name} auto_idx", auto_idx, torch.int32, (B, L))
    n_keys, windows = key.brk_a.shape[0], key.ak_a.shape[0]
    for f in ("brk_a", "brk_b"):
        kernels.require(f"{name} key.{f}", getattr(key, f), torch.int32, (n_keys, 2 * gg.d, n))
    for f in ("ak_a", "ak_b"):
        kernels.require(f"{name} key.{f}", getattr(key, f), torch.int32, (windows, gk.d, n))
    kernels.require(f"{name} key.auto_src", key.auto_src, torch.int32, (windows, n))
    kernels.require(f"{name} key.auto_sign", key.auto_sign, torch.bool, (windows, n))
    rows_of_key = [getattr(key, f) for f in ("brk_a", "brk_b", "ak_a", "ak_b", "auto_src", "auto_sign")]
    if any(t.data_ptr() % 16 for t in rows_of_key):
        raise ValueError(f"{name}: the kernel copies key rows with 16-byte accesses; a key tensor is not 16-byte aligned")
    out = RlweCiphertext(torch.empty_like(acc.a), torch.empty_like(acc.b))
    if B:
        plan = params.rlwe.plan32
        psi, psi_s, psi_inv, psi_inv_s = _table_pointers(plan, acc.a.get_device())
        kernels.launch(
            "lft_fhew_blind_rotate", acc.a.data_ptr(), acc.b.data_ptr(), out.a.data_ptr(), out.b.data_ptr(),
            ext_idx.data_ptr(), auto_idx.data_ptr(), B, L, key.brk_a.data_ptr(), key.brk_b.data_ptr(), n_keys,
            key.ak_a.data_ptr(), key.ak_b.data_ptr(), key.auto_src.data_ptr(), key.auto_sign.data_ptr(), windows,
            psi, psi_s, psi_inv, psi_inv_s, plan.log_n, q, plan.n_inv, plan.n_inv_shoup,
            *rgsw.gadget_args(gg), *rgsw.gadget_args(gk), contraction_chunk(q, rows), walk_error(acc.a.device).data_ptr(),
        )  # fmt: skip
        blind_rotate_core_fused.launches += 1
    return out


blind_rotate_core_fused.launches = 0


def contraction_chunk(q: int, rows: int) -> int:
    """How many of a coefficient's `rows` products of two residues below q
    K-FHEW-BR sums in a u64 before it reduces: the most whose sum fits 64
    bits (chunk * (q-1)^2 < 2^64), at most `rows`. Every chunk gives the
    same residues; at a 28-bit q it is every row, reduced once."""
    return min(rows, ((1 << 64) - 1) // max(1, (q - 1) ** 2))


def walk_error(device: torch.device | str) -> torch.Tensor:
    """K-FHEW-BR's and K-FHEW-BR64's error word on a CUDA device
    (`kernels.error_word`): one int32, OR-ed by every launch with 1 where a
    schedule's ext index lay outside the key and 2 where an auto index did
    (that ciphertext's walk ended there). It stays on the card: read it
    after a sync, and zero it with `.zero_()`."""
    return kernels.error_word(device)


def blind_rotate_core_fused64(
    params: BootstrapParams,
    key: BootstrapKey,
    ext_idx: torch.Tensor,  # (B, L) int32, -1 = no external product this step
    auto_idx: torch.Tensor,  # (B, L) int32, -1 = no automorphism this step
    acc: RlweCiphertext,  # a, b: (B, N) int64 residues
) -> RlweCiphertext:
    """The fused walk of a batch on the u64 engine: K-FHEW-BR64
    (`lft_fhew_blind_rotate64`), one launch, one 512-thread block per
    ciphertext, no read back to the host; an index outside the key is
    flagged in `walk_error` as K-FHEW-BR flags it. The key's brk and ak rows
    are int64 in the evaluation basis and the Montgomery domain. On CPU
    tensors, the plain version. Returns a new (B, N) int64 pair."""
    if acc.a.is_cpu:
        return blind_rotate_core_fused_ref(params, key, ext_idx, auto_idx, acc)
    name = "blind_rotate_core_fused64"
    n, q, plan = params.n, params.big_q, params.rlwe.plan
    gg, gk = params.rgsw.gadget, params.rlwe.gadget
    if not 1 <= plan.log_n <= kernels.MAX_LOG_N:
        raise ValueError(f"{name}: the kernel takes N <= {1 << kernels.MAX_LOG_N}")
    for g, rows in ((gg, 2 * gg.d), (gk, gk.d)):
        if rows * (q - 1) ** 2 >= q << 64 or g.log_b * g.d > 64:
            raise ValueError(f"{name}: {rows} row products below q={q} overflow one REDC, or the digits span 64 bits")
    B, L = ext_idx.shape
    kernels.require(f"{name} acc.a", acc.a, torch.int64, (B, n))
    kernels.require(f"{name} acc.b", acc.b, torch.int64, (B, n))
    kernels.require(f"{name} ext_idx", ext_idx, torch.int32, (B, L))
    kernels.require(f"{name} auto_idx", auto_idx, torch.int32, (B, L))
    n_keys, windows = key.brk_a.shape[0], key.ak_a.shape[0]
    for f in ("brk_a", "brk_b"):
        kernels.require(f"{name} key.{f}", getattr(key, f), torch.int64, (n_keys, 2 * gg.d, n))
    for f in ("ak_a", "ak_b"):
        kernels.require(f"{name} key.{f}", getattr(key, f), torch.int64, (windows, gk.d, n))
    kernels.require(f"{name} key.auto_src", key.auto_src, torch.int32, (windows, n))
    kernels.require(f"{name} key.auto_sign", key.auto_sign, torch.bool, (windows, n))
    out = RlweCiphertext(torch.empty_like(acc.a), torch.empty_like(acc.b))
    if B:
        kernels.launch(
            "lft_fhew_blind_rotate64", acc.a.data_ptr(), acc.b.data_ptr(), out.a.data_ptr(), out.b.data_ptr(),
            ext_idx.data_ptr(), auto_idx.data_ptr(), B, L, key.brk_a.data_ptr(), key.brk_b.data_ptr(), n_keys,
            key.ak_a.data_ptr(), key.ak_b.data_ptr(), key.auto_src.data_ptr(), key.auto_sign.data_ptr(), windows,
            *table_pointers(plan, acc.a.get_device()), plan.log_n, q, plan.zq.neg_q_inv, plan.n_inv, plan.n_inv_shoup,
            *rgsw.gadget_args(gg), *rgsw.gadget_args(gk), walk_error(acc.a.device).data_ptr(),
        )  # fmt: skip
        blind_rotate_core_fused64.launches += 1
    return out


blind_rotate_core_fused64.launches = 0


def prepare_acc(params: BootstrapParams, f: torch.Tensor, b2n: torch.Tensor) -> RlweCiphertext:
    """acc = (0, f o sigma_{-g} * X^{g*b}) for each b of a (B,) Z_2N vector,
    f a LUT polynomial (N,) or one per ciphertext (B, N): int32 residues on
    the u32 engine, int64 on the u64 (`bootstrapping.rs:157-168`)."""
    f_auto = automorphism_zq(f, -AUTO_G, params.big_q)
    f_prime = monomial_mul_zq(f_auto.expand(b2n.shape[0], params.n), (b2n * AUTO_G) % params.q, params.big_q)
    f_prime = f_prime.to(torch.int32 if params.rgsw.use_u32 else torch.int64).contiguous()
    return RlweCiphertext(torch.zeros_like(f_prime), f_prime)


def blind_rotate(params: BootstrapParams, key: BootstrapKey, f: torch.Tensor, ct: LweCiphertext) -> RlweCiphertext:
    """The blind rotation of Z_2N ciphertexts ct (a (..., n), b (...,)):
    the prepared accumulator, the schedule, the walk. Returns int64 values."""
    batch = ct.b.shape
    a2n, b2n = ct.a.reshape(-1, ct.a.shape[-1]), ct.b.reshape(-1)
    e_idx, a_idx = schedule(params, a2n)
    out = blind_rotate_core_fused(params, key, e_idx, a_idx, prepare_acc(params, f, b2n))
    return RlweCiphertext(out.a.long().reshape(*batch, params.n), out.b.long().reshape(*batch, params.n))


def bootstrap(params: BootstrapParams, key: BootstrapKey, f: torch.Tensor, ct: LweCiphertext) -> LweCiphertext:
    """Figure 2 of 2022/198 (`bootstrapping.rs:148-155`), for any batch shape."""
    ct = lwe.ct_mod_switch(ct, params.big_q, params.big_q_ks)
    ct = lwe.key_switch(params.lwe_s, LweKeySwitchingKey(key.ksk_a, key.ksk_b), ct)
    ct = lwe.ct_mod_switch_odd(ct, params.big_q_ks, params.q)
    return rlwe.sample_extract(params.rlwe, blind_rotate(params, key, f, ct), 0)


# -- multi-key / threshold (`bootstrapping.rs:233-321`) ---------------------------


class BootstrapCrs(NamedTuple):
    pk_a: torch.Tensor  # (N,)
    ksk_a: torch.Tensor  # (d_ks, N, n)
    ak_a: torch.Tensor  # (w+1, d, N)


class BootstrapKeyShare(NamedTuple):
    ksk_b: torch.Tensor  # (d_ks, N)
    brk: rgsw.RgswCiphertext  # (n, 2d, N), encrypted under the merged pk
    ak_b: torch.Tensor  # (w+1, d, N)


def crs_gen(params: BootstrapParams, rng: np.random.Generator, device: torch.device | str | None = None) -> BootstrapCrs:
    """The common reference string: pk_a, the LWE key switch's a rows and
    the automorphism keys' a rows, uniform, drawn in that order, on `device`
    (by default the current CUDA device)."""
    device = resolve_device(device)
    pk_a = u64_to_torch(uniform_zq(params.big_q, rng, params.n), device)
    ksk_a = u64_to_torch(uniform_zq(params.big_q_ks, rng, (params.lwe_s.gadget.d, params.n, params.lwe_s.n)), device)
    ak_a = u64_to_torch(uniform_zq(params.big_q, rng, (len(params.ak_t), params.rlwe.gadget.d, params.n)), device)
    return BootstrapCrs(pk_a, ksk_a, ak_a)


def key_share_gen(
    params: BootstrapParams, crs: BootstrapCrs, z: np.ndarray, pk: RlweCiphertext, rng: np.random.Generator
) -> BootstrapKeyShare:
    """Each party: its LWE key switching key share under the CRS, its brk
    under the MERGED pk, its automorphism key shares (`bootstrapping.rs:271-293`)."""
    s = lwe.sk_gen(params.lwe_s, rng)
    ksk_b = lwe.ksk_share_gen(params.lwe_s, crs.ksk_a, s, z, rng)
    brk_pt = u64_to_torch(_monomial_poly(params.n, params.big_q, s), crs.pk_a.device)
    brk = rgsw.pk_encrypt_rgsw(params.rgsw, pk, brk_pt, rng)
    ak_b = torch.stack([rlwe.ak_share_gen(params.rlwe, t, crs.ak_a[i], z, rng) for i, t in enumerate(params.ak_t)])
    return BootstrapKeyShare(ksk_b, brk, ak_b)


def merge_chunk_size(n_keys: int, target: int = 64) -> int:
    """Keys per internal-product chunk of the merge, as the JAX package
    chunks it: the largest divisor of n_keys up to target (600 -> 60),
    else equal widths of at most target."""
    if n_keys <= target:
        return max(1, n_keys)
    for c in range(target, max(1, target // 2) - 1, -1):
        if n_keys % c == 0:
            return c
    n_chunks = -(-n_keys // target)
    return -(-n_keys // n_chunks)


def _merge_chunk(params: RgswParams, merged: rgsw.RgswCiphertext, share: rgsw.RgswCiphertext) -> rgsw.RgswCiphertext:
    """One chunk of the fold: the merged keys into the evaluation basis, then
    every row of the share through an external product with its key."""
    return rgsw.internal_product(params, rgsw.to_eval(params, merged), share)


def key_share_merge(params: BootstrapParams, crs: BootstrapCrs, shares: list[BootstrapKeyShare]) -> BootstrapKey:
    """The ksk and ak shares sum; the brk shares fold through RGSW internal
    products (`bootstrapping.rs:295-321`), `merge_chunk_size` keys at a time."""
    ksk = lwe.ksk_share_merge(params.lwe_s, crs.ksk_a, (s.ksk_b for s in shares))
    merged = shares[0].brk
    for share in shares[1:]:
        n_keys = merged.a.shape[0]
        chunk = merge_chunk_size(n_keys)
        outs = [
            _merge_chunk(
                params.rgsw,
                rgsw.RgswCiphertext(merged.a[lo : lo + chunk], merged.b[lo : lo + chunk]),
                rgsw.RgswCiphertext(share.brk.a[lo : lo + chunk], share.brk.b[lo : lo + chunk]),
            )
            for lo in range(0, n_keys, chunk)
        ]
        merged = rgsw.RgswCiphertext(torch.cat([o.a for o in outs]), torch.cat([o.b for o in outs]))
    brk_eval = rgsw.to_eval(params.rgsw, merged)
    ak_ksks = [
        rlwe.ak_share_merge(params.rlwe, t, crs.ak_a[i], (s.ak_b[i] for s in shares)).ksk for i, t in enumerate(params.ak_t)
    ]
    return _pack_key(params, ksk, brk_eval, ak_ksks)
