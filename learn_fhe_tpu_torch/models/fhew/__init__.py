"""FHEW: Z_q LWE / RLWE / RGSW with LMKCDEY blind-rotation bootstrapping and
the MP21 boolean gates (the port's second slice). Not ported yet: the
multi-key / threshold API, `boolean.FhewBool`, `uint8.FhewU8`, and moduli
q >= 2^31 (the u64 engine)."""

from . import bootstrapping, gates, lwe, rgsw, rlwe
from .bootstrapping import BootstrapKey, BootstrapParams, blind_rotate, bootstrap, key_gen
from .params import AUTO_G, LweParams, RgswParams, RlweParams

__all__ = [
    "AUTO_G",
    "BootstrapKey",
    "BootstrapParams",
    "LweParams",
    "RgswParams",
    "RlweParams",
    "blind_rotate",
    "bootstrap",
    "bootstrapping",
    "gates",
    "key_gen",
    "lwe",
    "rgsw",
    "rlwe",
]
