"""Scale-out layer: batched bootstrap pipelines, meshes over torch.distributed
ranks, the coefficient-sharded NTT and multi-party share merging."""

from .batch import (
    PBS_CHUNK,
    fhew_bootstrap_batch,
    fhew_gate_batch,
    tfhe_pbs_batch,
    tfhe_pbs_batch_device,
)
from .coef import coef_mesh, coef_sharded_intt, coef_sharded_mul, coef_sharded_ntt, shard_coef
from .coef32 import coef32_sharded_intt, coef32_sharded_mul, coef32_sharded_ntt
from .distributed import collective_watchdog, global_mesh, init_distributed
from .mesh import gather, make_mesh, replicate, shard_batch, shard_limbs
from .multiparty import merge_shares, party_mesh, shard_parties

__all__ = [
    "PBS_CHUNK",
    "coef32_sharded_intt",
    "coef32_sharded_mul",
    "coef32_sharded_ntt",
    "coef_mesh",
    "coef_sharded_intt",
    "coef_sharded_mul",
    "coef_sharded_ntt",
    "collective_watchdog",
    "fhew_bootstrap_batch",
    "fhew_gate_batch",
    "gather",
    "global_mesh",
    "init_distributed",
    "make_mesh",
    "merge_shares",
    "party_mesh",
    "replicate",
    "shard_batch",
    "shard_coef",
    "shard_limbs",
    "shard_parties",
    "tfhe_pbs_batch",
    "tfhe_pbs_batch_device",
]
