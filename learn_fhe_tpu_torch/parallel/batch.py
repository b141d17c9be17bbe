"""Batched bootstrap pipelines (`learn_fhe_tpu/parallel/batch.py`): the TFHE
programmable bootstrap and the FHEW gate bootstrap, the throughput surface
of the port."""

from __future__ import annotations

import torch

from ..models import tfhe
from ..models.fhew import bootstrapping as fhew_boot
from ..models.fhew import gates as fhew_gates
from ..models.fhew import rlwe as fhew_rlwe
from ..models.fhew.bootstrapping import BootstrapKey as FhewKey, BootstrapParams as FhewParams
from ..models.fhew.lwe import LweCiphertext as FhewLwe
from ..models.tfhe import tggsw, tlwe
from ..models.tfhe.bootstrapping import BootstrapKey as TfheKey, BootstrapParams as TfheParams
from ..models.tfhe.tlwe import TlweCiphertext


@torch.no_grad()
def tfhe_pbs_batch_device(
    params: TfheParams,
    key: TfheKey,
    v_encoded: torch.Tensor,  # (N,) torus LUT
    a2n: torch.Tensor,  # (B, n) exponents
    b2n: torch.Tensor,  # (B,)
) -> TlweCiphertext:
    """Batched CMux-chain blind rotation of ciphertexts given as exponents
    (the JAX package's signature; K-TFHE-PRE reads them unswitched), then
    the sample extract and the key switch as one launch of K6
    (`tlwe.extract_key_switch`)."""
    acc = tfhe.blind_rotate(params, key, v_encoded, a2n, b2n)
    return tlwe.extract_key_switch(params.tlwe, key.ksk, acc)


@torch.no_grad()
def _tfhe_pbs_chunk(params: TfheParams, key: TfheKey, v: torch.Tensor, cts: TlweCiphertext) -> TlweCiphertext:
    """One PBS chunk of torus ciphertexts (a (B, n), b (B,)) under the LUT
    v (N,) int64, not yet encoded: on the card K-TFHE-PRE (the LUT's
    encode, the mod switch, the transposed exponents and the rotated
    accumulator, one launch), the n steps of K-STEP from one C call, and K6."""
    a, b = cts.a.contiguous(), cts.b.contiguous()
    exps, acc = tfhe.blind_rotate_front(params, v, a, b, switched=False, encode=True)
    tggsw.blind_rotate_steps(params.tggsw, key.brk, acc, exps, key.mon_v, key.mon_d)
    return tlwe.extract_key_switch(params.tlwe, key.ksk, acc)


# Batches stream through chunks of this size. The JAX package tuned it on a
# TPU. The step kernel runs a cluster of 4 blocks per ciphertext and an H100
# holds 124 such clusters at once, so a chunk of 128 ends in a short second
# wave; the card's best chunk size is not measured yet.
PBS_CHUNK = 128


def tfhe_pbs_batch(
    params: TfheParams, key: TfheKey, v: torch.Tensor, cts: TlweCiphertext
) -> TlweCiphertext:
    """Full batched PBS: cts carries a leading batch axis of any size;
    batches beyond PBS_CHUNK stream through equal chunks (padding the tail),
    each one `_tfhe_pbs_chunk`."""
    v = v.long()
    B = cts.b.shape[0]
    if B <= PBS_CHUNK:
        return _tfhe_pbs_chunk(params, key, v, cts)
    a, b = cts.a, cts.b
    pad = (-B) % PBS_CHUNK
    if pad:
        a = torch.cat([a, a[:pad]], dim=0)
        b = torch.cat([b, b[:pad]], dim=0)
    outs = [
        _tfhe_pbs_chunk(params, key, v, TlweCiphertext(a[s : s + PBS_CHUNK], b[s : s + PBS_CHUNK]))
        for s in range(0, a.shape[0], PBS_CHUNK)
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
    of K-FHEW-BR64 on the u64 engine, on the card), then sample_extract(0)
    (one launch of K-EXTRACT): (B, N) int64 LWE ciphertexts. The
    schedule is trusted: `fhew_boot.schedule` checks its indices on the
    host; one built otherwise is the caller's to check, or to verify by
    `fhew_boot.walk_error` after a sync (the walk reads back nothing)."""
    return _walk_extract(params, key, f_prime, ext_idx, auto_idx)


def _walk_extract(params: FhewParams, key: FhewKey, f_prime, ext_idx, auto_idx, b_add: int = 0) -> FhewLwe:
    """The walk, then the extract of coefficient 0 with b_add added to b mod
    Q in the same launch."""
    acc = fhew_boot.blind_rotate_core_fused(
        params, key, ext_idx, auto_idx, fhew_rlwe.RlweCiphertext(torch.zeros_like(f_prime), f_prime)
    )
    return fhew_rlwe.sample_extract(params.rlwe, acc, 0, b_add=b_add)


@torch.no_grad()
def _fhew_preamble(params: FhewParams, key: FhewKey, f: torch.Tensor, cts: FhewLwe):
    """Mod switch -> LWE key switch -> odd mod switch -> per-ciphertext
    rotated LUT, one launch of K-FHEW-PRE on the card
    (`fhew_boot.preamble`). Returns the Z_2N mask (B, n), from which the
    host builds the schedule, and the prepared accumulators' b (B, N), int32
    on the u32 engine and int64 on the u64. f is one LUT (N,) for the batch
    or one per ciphertext (B, N)."""
    return fhew_boot.preamble(params, key, f, cts)


def fhew_bootstrap_batch(params: FhewParams, key: FhewKey, f: torch.Tensor, cts: FhewLwe, b_add: int = 0) -> FhewLwe:
    """Batched Figure-2 pipeline (`fhew/bootstrapping.rs:148-155`): the
    preamble on the device, the schedule from the public mask on the host
    (C on the card), the walk and the extraction on the device. b_add (a
    gate's Q/8; 0 in the JAX package's signature) is added to the output's
    b mod Q by the extract's launch."""
    ct_a, f_prime = _fhew_preamble(params, key, f, cts)
    ext_idx, auto_idx = fhew_boot.schedule(params, ct_a)
    return _walk_extract(params, key, f_prime, ext_idx, auto_idx, b_add)


def fhew_gate_batch(params: FhewParams, key: FhewKey, name: str, ct0s: FhewLwe, ct1s: FhewLwe) -> FhewLwe:
    """Batched 2-input gate: linear combination + one batched LUT bootstrap,
    its + Q/8 added by the extract."""
    lin = fhew_gates._lin2(params, name, ct0s, ct1s)
    f = fhew_gates.lut_poly(params, fhew_gates.GATE_TABLES[name], lin.a.device)
    return fhew_bootstrap_batch(params, key, f, lin, b_add=params.big_q_by_8)
