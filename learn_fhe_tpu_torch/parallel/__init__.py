"""Batched bootstrap pipelines."""

from .batch import PBS_CHUNK, tfhe_pbs_batch, tfhe_pbs_batch_device

__all__ = ["PBS_CHUNK", "tfhe_pbs_batch", "tfhe_pbs_batch_device"]
