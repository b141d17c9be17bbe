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

Each ciphertext walks its own schedule to its end, and a batch runs at its
own size: the JAX package's `_trim_len` and the gates' padding exist only
to keep its jit cache small, and are not carried over.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import NamedTuple

import numpy as np
import torch

from ...ops.modular32 import neg_mod32
from ...ops.ntt32 import _table_pointers
from ...ops.poly import automorphism_map, automorphism_zq, monomial_mul_zq
from ...utils import kernels
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
    """Key material in the evaluation basis: int32 values with Shoup duals;
    the LWE key switch's rows as int64 values."""

    ksk_a: torch.Tensor  # (d_ks, N, n)
    ksk_b: torch.Tensor  # (d_ks, N)
    brk_a: torch.Tensor  # (n, 2d, N) blind-rotation RGSW keys
    brk_b: torch.Tensor
    ak_a: torch.Tensor  # (w+1, d, N) automorphism keys
    ak_b: torch.Tensor
    auto_src: torch.Tensor  # (w+1, N) int32 gather maps of X -> X^t
    auto_sign: torch.Tensor  # (w+1, N) bool
    brk_ad: torch.Tensor
    brk_bd: torch.Tensor
    ak_ad: torch.Tensor
    ak_bd: torch.Tensor


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
        ak_ad=torch.stack([k.a_dual for k in ak_ksks]),
        ak_bd=torch.stack([k.b_dual for k in ak_ksks]),
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


def schedule_native(params: BootstrapParams, a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """`build_schedule` then `fuse_schedule` on a (B, n) host mask, by their C
    copy in the kernel library (`lft_fhew_build_schedule`,
    `lft_fhew_fuse_schedule`); raises if the library cannot be built."""
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
    return e_out[:, :max_len], a_out[:, :max_len]


def schedule(params: BootstrapParams, a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused schedule of each row of a (B, n) Z_2N mask, as (B, L) int32
    tensors on a's device: the Python transcription for a CPU tensor, the C
    copy for a CUDA tensor."""
    host = a.cpu().numpy()
    if a.is_cpu:
        e_idx, a_idx = fuse_schedule(*build_schedule(params, host))
    else:
        e_idx, a_idx = schedule_native(params, host)
    return torch.from_numpy(e_idx).to(a.device), torch.from_numpy(a_idx).to(a.device)


# -- the blind rotation ----------------------------------------------------------


def _ksk_at(key: BootstrapKey, i: torch.Tensor) -> rlwe.RlweKeySwitchingKey:
    return rlwe.RlweKeySwitchingKey(key.ak_a[i], key.ak_b[i], key.ak_ad[i], key.ak_bd[i])


def blind_rotate_core_fused_ref(
    params: BootstrapParams,
    key: BootstrapKey,
    ext_idx: torch.Tensor,
    auto_idx: torch.Tensor,
    acc: RlweCiphertext,
) -> RlweCiphertext:
    """Plain version of `blind_rotate_core_fused`: the JAX package's scan
    step, batched, in a loop over the steps. Step s runs, for each
    ciphertext, the external product with brk[ext_idx[:, s]] where that is
    >= 0, then the automorphism by ak_t[auto_idx[:, s]] with its key switch
    where that is >= 0; the loop ends when every schedule has ended."""
    q = params.big_q
    a, b = acc.a.to(torch.int32), acc.b.to(torch.int32)
    for s in range(ext_idx.shape[-1]):
        e, au = ext_idx[:, s].long(), auto_idx[:, s].long()
        keep_e, keep_a = (e >= 0)[:, None], (au >= 0)[:, None]
        if not bool((keep_e | keep_a).any()):
            break
        if bool(keep_e.any()):
            i = e.clamp(min=0)
            brk = RgswEval(key.brk_a[i], key.brk_b[i], key.brk_ad[i], key.brk_bd[i])
            ext = rgsw.external_product(params.rgsw, brk, RlweCiphertext(a, b))
            a, b = torch.where(keep_e, ext.a, a), torch.where(keep_e, ext.b, b)
        if bool(keep_a.any()):
            i = au.clamp(min=0)
            src, sign = key.auto_src[i].long(), key.auto_sign[i]
            a_g, b_g = torch.gather(a, -1, src), torch.gather(b, -1, src)
            auto_in = RlweCiphertext(
                torch.where(sign, neg_mod32(a_g, q), a_g), torch.where(sign, neg_mod32(b_g, q), b_g)
            )
            out = rlwe.key_switch(params.rlwe, _ksk_at(key, i), auto_in)
            a, b = torch.where(keep_a, out.a, a), torch.where(keep_a, out.b, b)
    return RlweCiphertext(a, b)


def _gadget_args(g) -> tuple[int, int, int, int]:
    return g.log_b, g.d, g.rounding_bits, ((1 << g.rounding_bits) >> 1) % g.q


def blind_rotate_core_fused(
    params: BootstrapParams,
    key: BootstrapKey,
    ext_idx: torch.Tensor,  # (B, L) int32, -1 = no external product this step
    auto_idx: torch.Tensor,  # (B, L) int32, -1 = no automorphism this step
    acc: RlweCiphertext,  # a, b: (B, N) int32 residues
) -> RlweCiphertext:
    """The fused walk of a batch: K-FHEW-BR (`lft_fhew_blind_rotate`), one
    launch for the whole batch and all its steps, one block per ciphertext.
    On CPU tensors, its plain version. Returns a new (B, N) int32 pair."""
    if acc.a.is_cpu:
        return blind_rotate_core_fused_ref(params, key, ext_idx, auto_idx, acc)
    name = "blind_rotate_core_fused"
    n, q = params.n, params.big_q
    gg, gk = params.rgsw.gadget, params.rlwe.gadget
    if n > 1 << kernels.MAX_LOG_N or max(2 * gg.d, gk.d) > FHEW_MAX_ROWS:
        raise ValueError(f"{name}: the kernel takes N <= {1 << kernels.MAX_LOG_N} and at most {FHEW_MAX_ROWS} digit rows")
    B, L = ext_idx.shape
    kernels.require(f"{name} acc.a", acc.a, torch.int32, (B, n))
    kernels.require(f"{name} acc.b", acc.b, torch.int32, (B, n))
    kernels.require(f"{name} ext_idx", ext_idx, torch.int32, (B, L))
    kernels.require(f"{name} auto_idx", auto_idx, torch.int32, (B, L))
    n_keys, windows = key.brk_a.shape[0], key.ak_a.shape[0]
    for f in ("brk_a", "brk_b", "brk_ad", "brk_bd"):
        kernels.require(f"{name} key.{f}", getattr(key, f), torch.int32, (n_keys, 2 * gg.d, n))
    for f in ("ak_a", "ak_b", "ak_ad", "ak_bd"):
        kernels.require(f"{name} key.{f}", getattr(key, f), torch.int32, (windows, gk.d, n))
    kernels.require(f"{name} key.auto_src", key.auto_src, torch.int32, (windows, n))
    kernels.require(f"{name} key.auto_sign", key.auto_sign, torch.bool, (windows, n))
    out = RlweCiphertext(torch.empty_like(acc.a), torch.empty_like(acc.b))
    if B and L:  # the kernel reads key rows by these indices: hold them in range (one sync)
        e_lo, e_hi, a_lo, a_hi = torch.stack([*torch.aminmax(ext_idx), *torch.aminmax(auto_idx)]).tolist()
        if min(e_lo, a_lo) < -1 or e_hi >= n_keys or a_hi >= windows:
            raise ValueError(f"{name}: schedule indices out of range ({e_lo}..{e_hi} of {n_keys} keys, {a_lo}..{a_hi} of {windows})")
    if B:
        plan = params.rlwe.plan32
        psi, psi_s, psi_inv, psi_inv_s = _table_pointers(plan, acc.a.get_device())
        kernels.launch(
            "lft_fhew_blind_rotate", acc.a.data_ptr(), acc.b.data_ptr(), out.a.data_ptr(), out.b.data_ptr(),
            ext_idx.data_ptr(), auto_idx.data_ptr(), B, L,
            *(getattr(key, f).data_ptr() for f in ("brk_a", "brk_ad", "brk_b", "brk_bd", "ak_a", "ak_ad", "ak_b", "ak_bd")),
            key.auto_src.data_ptr(), key.auto_sign.data_ptr(), psi, psi_s, psi_inv, psi_inv_s, plan.log_n, q,
            plan.n_inv, plan.n_inv_shoup, *_gadget_args(gg), *_gadget_args(gk),
        )  # fmt: skip
        blind_rotate_core_fused.launches += 1
    return out


blind_rotate_core_fused.launches = 0


def prepare_acc(params: BootstrapParams, f: torch.Tensor, b2n: torch.Tensor) -> RlweCiphertext:
    """acc = (0, f o sigma_{-g} * X^{g*b}) for each b of a (B,) Z_2N vector,
    f a LUT polynomial (N,) or one per ciphertext (B, N): int32 residues
    (`bootstrapping.rs:157-168`)."""
    f_auto = automorphism_zq(f, -AUTO_G, params.big_q)
    f_prime = monomial_mul_zq(f_auto.expand(b2n.shape[0], params.n), (b2n * AUTO_G) % params.q, params.big_q)
    f_prime = f_prime.to(torch.int32).contiguous()
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
