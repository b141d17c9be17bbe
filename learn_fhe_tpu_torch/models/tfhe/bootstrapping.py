"""TFHE programmable bootstrapping: CMux-chain blind rotation
(`learn_fhe_tpu/models/tfhe/bootstrapping.py`).

    acc = TGLWE(v) * X^{-b~};  for each LWE key bit i:
        acc += (X^{a~_i} - 1) (*) ExtProd(brk_i, acc)
    then sample_extract(0) and key-switch back to the LWE key.

The monomial is applied pointwise in the NTT domain from a public table of
evaluation rows, so a step is one launch of the step kernel, and the whole
chain is one C call (`tggsw.blind_rotate_steps`). With parity=True the
chain runs the reference's exact CMux order instead, acc = cmux(brk_i, acc,
acc X^{a_i}) with the rotation in the coefficient domain
(`tggsw.external_product`), unbatched: its outputs are bit-identical to the
reference's, for the transcript parity check, at no attempt at speed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ...ops.gadget import shr_u64
from ...ops.torus_crt import monomial_eval_table, required_bound_bits
from ...utils.interop import resolve_device, u32_to_torch, u64_to_torch
from . import tggsw, tglwe, tlwe
from .params import TggswParams, TglweParams, TlweParams
from .tggsw import TggswEval
from .tglwe import TglweCiphertext
from .tlwe import TlweCiphertext, TlweKeySwitchingKey


@dataclass(frozen=True)
class BootstrapParams:
    """Pairs a TLWE (for key switch) with a TGGSW (for blind rotation) of
    equal plaintext modulus (`bootstrapping.rs:21-38`)."""

    tlwe: TlweParams
    tggsw: TggswParams

    def __post_init__(self):
        assert self.tlwe.p == self.tggsw.p

    @property
    def tglwe(self) -> TglweParams:
        return self.tggsw.tglwe

    @property
    def big_n(self) -> int:
        return self.tggsw.big_n


class BootstrapKey(NamedTuple):
    brk: TggswEval  # rows stacked over the n LWE key bits: (n, K, R, ...)
    ksk: TlweKeySwitchingKey
    mon_v: torch.Tensor  # (K, 2N, N) int32: NTT rows of X^s for every s
    mon_d: torch.Tensor  # matching Shoup duals


def key_gen(
    params: BootstrapParams,
    z: np.ndarray,
    rng: np.random.Generator,
    device: torch.device | str | None = None,
) -> BootstrapKey:
    """brk_i = TGGSW(z_i as constant poly) under a fresh TGLWE key s; ksk from
    the flattened s back to z (`bootstrapping.rs:59-76`); plus the public
    monomial evaluation table. Draws from rng exactly as the JAX key_gen.

    The key goes to `device`, by default the current CUDA device; without
    one this raises unless device="cpu" (see `resolve_device`)."""
    device = resolve_device(device)
    s = tglwe.sk_gen(params.tglwe, rng)
    const = np.zeros((params.tlwe.n, params.big_n), dtype=np.uint64)
    const[:, 0] = np.asarray(z).astype(np.uint64)
    brk_coeff = tggsw.sk_encrypt(params.tggsw, s, u64_to_torch(const, device), rng)
    brk = tggsw.to_eval(params.tggsw, brk_coeff)
    ksk = tlwe.ksk_gen(params.tlwe, z, s.reshape(-1), rng, device)
    rows = (params.tglwe.k + 1) * params.tggsw.d
    mv, md = monomial_eval_table(params.big_n, required_bound_bits(params.big_n, params.tggsw.log_b, rows))
    return BootstrapKey(brk, ksk, u32_to_torch(mv, device), u32_to_torch(md, device))


def mod_switch_2n(ct: TlweCiphertext, big_n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Round (a, b) into Z_2N exponents (`bootstrapping.rs:99-104`); the
    rounding can give 2N itself."""
    bits = 64 - (2 * big_n).bit_length() + 1
    half = (1 << bits) >> 1
    return shr_u64(ct.a + half, bits), shr_u64(ct.b + half, bits)


def _blind_rotate_parity(
    params: BootstrapParams, key: BootstrapKey, v_encoded: torch.Tensor, a2n: torch.Tensor, b2n: torch.Tensor
) -> TglweCiphertext:
    """The reference's CMux order for one ciphertext (`tggsw.rs:113-120`,
    `bootstrapping.rs:88-95`): acc = cmux(brk_i, acc, acc X^{a_i})."""
    k, n_big = params.tglwe.k, params.big_n
    n2 = 2 * n_big
    acc0 = TglweCiphertext(torch.zeros((k, n_big), dtype=torch.int64, device=b2n.device), v_encoded)
    acc = tglwe.rotate(acc0, (-b2n) % n2)
    brk = key.brk
    for i in range(a2n.shape[-1]):
        key_i = TggswEval(brk.av[i], brk.ad[i], brk.bv[i], brk.bd[i])
        acc = tggsw.cmux(params.tggsw, key_i, acc, tglwe.rotate(acc, a2n[i] % n2))
    return acc


def blind_rotate(
    params: BootstrapParams,
    key: BootstrapKey,
    v_encoded: torch.Tensor,  # (N,) torus LUT
    a2n: torch.Tensor,  # (..., n) exponents in [0, 2N]
    b2n: torch.Tensor,  # (...,)
    parity: bool = False,
) -> TglweCiphertext:
    """CMux chain (`bootstrapping.rs:84-96`) over a batch of ciphertexts.

    The JAX package runs the n steps as a `lax.scan` whose carry is a new
    accumulator each step. Here `tggsw.blind_rotate_steps` launches the n
    step kernels from one C call and each step adds its delta into the
    accumulator's storage in place, which JAX could not do.

    parity=True runs the reference's exact CMux order (see the module's
    docstring) on one ciphertext (a2n (n,), b2n a scalar); a batch raises,
    as the JAX package asserts."""
    if parity:
        if b2n.dim():
            raise ValueError("the parity blind rotation is unbatched by design: pass one ciphertext")
        return _blind_rotate_parity(params, key, v_encoded, a2n, b2n)
    k, n_big = params.tglwe.k, params.big_n
    batch = b2n.shape
    a2n = a2n.reshape(-1, a2n.shape[-1])
    b2n = b2n.reshape(-1)
    B = b2n.shape[0]
    acc0 = TglweCiphertext(
        torch.zeros((B, k, n_big), dtype=torch.int64, device=b2n.device),
        v_encoded.expand(B, n_big),
    )
    acc = tglwe.rotate(acc0, (-b2n) % (2 * n_big))  # fresh contiguous storage
    exps = a2n.t().contiguous()  # (n, B): row i holds step i's exponents
    tggsw.blind_rotate_steps(params.tggsw, key.brk, acc, exps, key.mon_v, key.mon_d)
    return TglweCiphertext(acc.a.reshape(*batch, k, n_big), acc.b.reshape(*batch, n_big))


def bootstrap(
    params: BootstrapParams, key: BootstrapKey, v: torch.Tensor, ct: TlweCiphertext, parity: bool = False
) -> TlweCiphertext:
    """Programmable bootstrap: LUT v (N values mod p) -> fresh ciphertext of
    v[round(phase)] (`bootstrapping.rs:78-82`). parity=True: the reference's
    exact CMux order, one ciphertext (see `blind_rotate`)."""
    v_enc = tglwe.encode(params.tglwe, v)
    a2n, b2n = mod_switch_2n(ct, params.big_n)
    acc = blind_rotate(params, key, v_enc, a2n, b2n, parity)
    ext = tglwe.sample_extract(params.tglwe, acc, 0)
    return tlwe.key_switch(params.tlwe, key.ksk, ext)


class TfheBootstrap(nn.Module):
    """A bootstrap key held as module buffers, so `.to(device)` moves it;
    calling the module runs the batched PBS."""

    def __init__(self, params: BootstrapParams, key: BootstrapKey):
        super().__init__()
        self.params = params
        brk, ksk = key.brk, key.ksk
        for name, t in (
            ("brk_av", brk.av),
            ("brk_ad", brk.ad),
            ("brk_bv", brk.bv),
            ("brk_bd", brk.bd),
            ("ksk_a", ksk.a),
            ("ksk_b", ksk.b),
            ("mon_v", key.mon_v),
            ("mon_d", key.mon_d),
        ):
            self.register_buffer(name, t)

    @property
    def key(self) -> BootstrapKey:
        return BootstrapKey(
            TggswEval(self.brk_av, self.brk_ad, self.brk_bv, self.brk_bd),
            TlweKeySwitchingKey(self.ksk_a, self.ksk_b),
            self.mon_v,
            self.mon_d,
        )

    @torch.no_grad()
    def forward(self, v: torch.Tensor, ct: TlweCiphertext) -> TlweCiphertext:
        return bootstrap(self.params, self.key, v, ct)


def lut_table(log_p: int, big_n: int, f) -> np.ndarray:
    """Negacyclic LUT with half-slot offset (`bootstrapping.rs:118-128`):
    table[v] = f(v) laid out so slot 0 is centered, with the wrap-around
    encoded as -f(0) at the tail."""
    p = 1 << log_p
    m = big_n >> log_p
    vals = [int(f(v)) % p for v in range(p)]
    out = []
    out += [vals[0]] * (m // 2)
    for t in vals[1:]:
        out += [t] * m
    out += [(-vals[0]) % p] * (m // 2)
    return np.array(out, dtype=np.uint64)
