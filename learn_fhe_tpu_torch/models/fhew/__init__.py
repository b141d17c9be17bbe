"""FHEW: Z_q LWE / RLWE / RGSW with LMKCDEY blind-rotation bootstrapping,
the MP21 boolean gates, multi-key / threshold key generation, and the
encrypted bool / u8 types (`learn_fhe_tpu/models/fhew`), on the u32 engine
(q < 2^31) and the u64 engine (q < 2^63)."""

from . import bootstrapping, gates, lwe, rgsw, rlwe
from .boolean import FhewBool
from .bootstrapping import (
    BootstrapCrs,
    BootstrapKey,
    BootstrapKeyShare,
    BootstrapParams,
    blind_rotate,
    bootstrap,
    crs_gen,
    key_gen,
    key_share_gen,
    key_share_merge,
)
from .params import AUTO_G, LweParams, RgswParams, RlweParams
from .uint8 import FhewU8

__all__ = [
    "AUTO_G",
    "BootstrapCrs",
    "BootstrapKey",
    "BootstrapKeyShare",
    "BootstrapParams",
    "FhewBool",
    "FhewU8",
    "LweParams",
    "RgswParams",
    "RlweParams",
    "blind_rotate",
    "bootstrap",
    "bootstrapping",
    "crs_gen",
    "gates",
    "key_gen",
    "key_share_gen",
    "key_share_merge",
    "lwe",
    "rgsw",
    "rlwe",
]
