"""TFHE programmable bootstrapping: CMux-chain blind rotation
(`learn_fhe_tpu/models/tfhe/bootstrapping.py`).

    acc = TGLWE(v) * X^{-b~};  for each LWE key bit i:
        acc += (X^{a~_i} - 1) (*) ExtProd(brk_i, acc)
    then sample_extract(0) and key-switch back to the LWE key.

The monomial is applied pointwise in the NTT domain from a public table of
evaluation rows, so a step is one launch of the step kernel
(`tggsw.cmux_rotate`). Only the default step order is ported; the JAX
package's `parity=True` reference order is not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ...ops.gadget import shr_u64
from ...ops.torus_crt import monomial_eval_table, required_bound_bits
from ...utils.interop import u32_to_torch, u64_to_torch
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
    monomial evaluation table. Draws from rng exactly as the JAX key_gen."""
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


def blind_rotate(
    params: BootstrapParams,
    key: BootstrapKey,
    v_encoded: torch.Tensor,  # (N,) torus LUT
    a2n: torch.Tensor,  # (..., n) exponents in [0, 2N]
    b2n: torch.Tensor,  # (...,)
) -> TglweCiphertext:
    """CMux chain (`bootstrapping.rs:84-96`) over a batch of ciphertexts.

    The JAX package runs the n steps as a `lax.scan` whose carry is a new
    accumulator each step. Here the loop launches one step kernel per key
    bit and each step adds its delta into the accumulator's storage in
    place, which JAX could not do."""
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
    brk = key.brk
    for i in range(exps.shape[0]):
        key_i = TggswEval(brk.av[i], brk.ad[i], brk.bv[i], brk.bd[i])
        tggsw.cmux_rotate(params.tggsw, key_i, acc, exps[i], key.mon_v, key.mon_d)
    return TglweCiphertext(acc.a.reshape(*batch, k, n_big), acc.b.reshape(*batch, n_big))


def bootstrap(
    params: BootstrapParams, key: BootstrapKey, v: torch.Tensor, ct: TlweCiphertext
) -> TlweCiphertext:
    """Programmable bootstrap: LUT v (N values mod p) -> fresh ciphertext of
    v[round(phase)] (`bootstrapping.rs:78-82`)."""
    v_enc = tglwe.encode(params.tglwe, v)
    a2n, b2n = mod_switch_2n(ct, params.big_n)
    acc = blind_rotate(params, key, v_enc, a2n, b2n)
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
