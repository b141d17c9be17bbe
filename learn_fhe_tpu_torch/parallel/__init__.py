"""Scale-out layer: batched bootstrap pipelines, meshes over torch.distributed
ranks, the coefficient-sharded NTT, the limb-sharded CKKS and BGV key switch
and multi-party share merging."""

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
from .limb import digit_ksk, digit_sharded_mul, limb_ksk, limb_sharded_bgv_mul, limb_sharded_mul, sharded_rotate_2d
from .mesh import gather, gather_limbs, limb_bounds, make_mesh, replicate, shard_batch, shard_limbs
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
    "digit_ksk",
    "digit_sharded_mul",
    "fhew_bootstrap_batch",
    "fhew_gate_batch",
    "gather",
    "gather_limbs",
    "global_mesh",
    "init_distributed",
    "limb_bounds",
    "limb_ksk",
    "limb_sharded_bgv_mul",
    "limb_sharded_mul",
    "make_mesh",
    "merge_shares",
    "party_mesh",
    "replicate",
    "shard_batch",
    "shard_coef",
    "shard_limbs",
    "shard_parties",
    "sharded_rotate_2d",
    "tfhe_pbs_batch",
    "tfhe_pbs_batch_device",
]
