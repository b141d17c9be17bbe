"""Batched bootstrap pipelines."""

from .batch import (
    PBS_CHUNK,
    fhew_bootstrap_batch,
    fhew_gate_batch,
    tfhe_pbs_batch,
    tfhe_pbs_batch_device,
)

__all__ = ["PBS_CHUNK", "fhew_bootstrap_batch", "fhew_gate_batch", "tfhe_pbs_batch", "tfhe_pbs_batch_device"]
