"""TFHE: torus LWE tower TLWE -> TGLWE -> TGGSW with CMux-chain blind
rotation and programmable bootstrapping (the port's first slice; `tgsw`,
`external_product`/`cmux` and the reference-order blind rotation are not
ported yet)."""

from . import tggsw, tglwe, tlwe
from .bootstrapping import (
    BootstrapKey,
    BootstrapParams,
    TfheBootstrap,
    blind_rotate,
    bootstrap,
    key_gen,
    lut_table,
    mod_switch_2n,
)
from .params import TggswParams, TglweParams, TlweParams

__all__ = [
    "BootstrapKey",
    "BootstrapParams",
    "TfheBootstrap",
    "TggswParams",
    "TglweParams",
    "TlweParams",
    "blind_rotate",
    "bootstrap",
    "key_gen",
    "lut_table",
    "mod_switch_2n",
    "tggsw",
    "tglwe",
    "tlwe",
]
