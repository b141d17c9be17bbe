"""Batched bootstrap pipelines (`learn_fhe_tpu/parallel/batch.py`, the TFHE
part): the throughput surface of the port."""

from __future__ import annotations

import torch

from ..models import tfhe
from ..models.tfhe import tglwe, tlwe
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
    """Batched CMux-chain blind rotation, sample extract and key switch."""
    acc = tfhe.blind_rotate(params, key, v_encoded, a2n, b2n)
    ext = tglwe.sample_extract(params.tglwe, acc, 0)
    return tlwe.key_switch(params.tlwe, key.ksk, ext)


# Batches stream through chunks of this size. The JAX package tuned it on a
# TPU. The step kernel runs one block per ciphertext, so a chunk of 128 puts
# one block on each of 128 of an H100's 132 SMs; the card's best chunk size
# is not measured yet.
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
