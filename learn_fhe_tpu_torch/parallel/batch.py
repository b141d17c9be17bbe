"""Batched bootstrap pipelines (`learn_fhe_tpu/parallel/batch.py`): the TFHE
programmable bootstrap and the FHEW gate bootstrap, the throughput surface
of the port."""

from __future__ import annotations

import torch

from ..models import tfhe
from ..models.fhew import bootstrapping as fhew_boot
from ..models.fhew import gates as fhew_gates
from ..models.fhew import lwe as fhew_lwe
from ..models.fhew import rlwe as fhew_rlwe
from ..models.fhew.bootstrapping import BootstrapKey as FhewKey, BootstrapParams as FhewParams
from ..models.fhew.lwe import LweCiphertext as FhewLwe, LweKeySwitchingKey
from ..models.tfhe import tglwe, tlwe
from ..models.tfhe.bootstrapping import BootstrapKey as TfheKey, BootstrapParams as TfheParams
from ..models.tfhe.tlwe import TlweCiphertext
from ..ops.modular import add_mod


@torch.no_grad()
def tfhe_pbs_batch_device(
    params: TfheParams,
    key: TfheKey,
    v_encoded: torch.Tensor,  # (N,) torus LUT
    a2n: torch.Tensor,  # (B, n) exponents
    b2n: torch.Tensor,  # (B,)
) -> TlweCiphertext:
    """Batched CMux-chain blind rotation, sample extract and key switch."""
    acc = tfhe.blind_rotate(params, key, v_encoded, a2n, b2n)
    ext = tglwe.sample_extract(params.tglwe, acc, 0)
    return tlwe.key_switch(params.tlwe, key.ksk, ext)


# Batches stream through chunks of this size. The JAX package tuned it on a
# TPU. The step kernel runs a cluster of 4 blocks per ciphertext and an H100
# holds 124 such clusters at once, so a chunk of 128 ends in a short second
# wave; the card's best chunk size is not measured yet.
PBS_CHUNK = 128


def tfhe_pbs_batch(
    params: TfheParams, key: TfheKey, v: torch.Tensor, cts: TlweCiphertext
) -> TlweCiphertext:
    """Full batched PBS: cts carries a leading batch axis of any size;
    batches beyond PBS_CHUNK stream through equal chunks (padding the tail)."""
    v_enc = tglwe.encode(params.tglwe, v)
    a2n, b2n = tfhe.mod_switch_2n(cts, params.big_n)
    B = a2n.shape[0]
    if B <= PBS_CHUNK:
        return tfhe_pbs_batch_device(params, key, v_enc, a2n, b2n)
    pad = (-B) % PBS_CHUNK
    if pad:
        a2n = torch.cat([a2n, a2n[:pad]], dim=0)
        b2n = torch.cat([b2n, b2n[:pad]], dim=0)
    outs = [
        tfhe_pbs_batch_device(params, key, v_enc, a2n[s : s + PBS_CHUNK], b2n[s : s + PBS_CHUNK])
        for s in range(0, a2n.shape[0], PBS_CHUNK)
    ]
    a = torch.cat([o.a for o in outs], dim=0)[:B]
    b = torch.cat([o.b for o in outs], dim=0)[:B]
    return TlweCiphertext(a, b)


# -- FHEW batched gate bootstrap -------------------------------------------------


@torch.no_grad()
def fhew_blind_rotate_batch_device(
    params: FhewParams,
    key: FhewKey,
    f_prime: torch.Tensor,  # (B, N) int32 (u32 engine) or int64 (u64): the prepared LUTs, rotated by X^{gb}
    ext_idx: torch.Tensor,  # (B, L) int32 fused schedule: ext key index or -1
    auto_idx: torch.Tensor,  # (B, L) int32 fused schedule: auto key index or -1
) -> FhewLwe:
    """The fused LMKCDEY walk of the whole batch (one launch of K-FHEW-BR, or
    of K-FHEW-BR64 on the u64 engine, on the card), then sample_extract(0):
    (B, N) int64 LWE ciphertexts. The
    schedule is trusted: `fhew_boot.schedule` checks its indices on the
    host; one built otherwise is the caller's to check, or to verify by
    `fhew_boot.walk_error` after a sync (the walk reads back nothing)."""
    acc = fhew_boot.blind_rotate_core_fused(
        params, key, ext_idx, auto_idx, fhew_rlwe.RlweCiphertext(torch.zeros_like(f_prime), f_prime)
    )
    ext = fhew_rlwe.sample_extract(params.rlwe, acc, 0)
    return FhewLwe(ext.a.long(), ext.b.long())


@torch.no_grad()
def _fhew_preamble(params: FhewParams, key: FhewKey, f: torch.Tensor, cts: FhewLwe):
    """Mod switch -> LWE key switch -> odd mod switch -> per-ciphertext
    rotated LUT. Returns the Z_2N mask (B, n), from which the host builds the
    schedule, and the prepared accumulators' b (B, N), int32 on the u32
    engine and int64 on the u64. f is one LUT (N,) for the batch or one per
    ciphertext (B, N). The LWE key switch is a float64 product, whose
    exactness `lwe.key_switch` checks (at the full multi-key set it holds by
    a margin of 2^34 - 2^13 below 2^53)."""
    ct = fhew_lwe.ct_mod_switch(cts, params.big_q, params.big_q_ks)
    ct = fhew_lwe.key_switch(params.lwe_s, LweKeySwitchingKey(key.ksk_a, key.ksk_b), ct)
    ct = fhew_lwe.ct_mod_switch_odd(ct, params.big_q_ks, params.q)
    return ct.a, fhew_boot.prepare_acc(params, f, ct.b).b


def fhew_bootstrap_batch(params: FhewParams, key: FhewKey, f: torch.Tensor, cts: FhewLwe) -> FhewLwe:
    """Batched Figure-2 pipeline (`fhew/bootstrapping.rs:148-155`): the
    preamble on the device, the schedule from the public mask on the host
    (C on the card), the walk and the extraction on the device."""
    ct_a, f_prime = _fhew_preamble(params, key, f, cts)
    ext_idx, auto_idx = fhew_boot.schedule(params, ct_a)
    return fhew_blind_rotate_batch_device(params, key, f_prime, ext_idx, auto_idx)


def fhew_gate_batch(params: FhewParams, key: FhewKey, name: str, ct0s: FhewLwe, ct1s: FhewLwe) -> FhewLwe:
    """Batched 2-input gate: linear combination + one batched LUT bootstrap."""
    lin = fhew_gates._lin2(params, name, ct0s, ct1s)
    f = fhew_gates.lut_poly(params, fhew_gates.GATE_TABLES[name], lin.a.device)
    out = fhew_bootstrap_batch(params, key, f, lin)
    return FhewLwe(out.a, add_mod(out.b, params.big_q_by_8, params.big_q))
