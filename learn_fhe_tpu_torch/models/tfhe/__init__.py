"""TFHE: torus LWE tower TLWE -> TGLWE -> TGSW -> TGGSW with CMux-chain
blind rotation and programmable bootstrapping, by default through the step
kernel, and in the reference's exact CMux order with parity=True."""

from . import tggsw, tglwe, tgsw, tlwe
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
from .params import TggswParams, TglweParams, TgswParams, TlweParams

__all__ = [
    "BootstrapKey",
    "BootstrapParams",
    "TfheBootstrap",
    "TggswParams",
    "TglweParams",
    "TgswParams",
    "TlweParams",
    "blind_rotate",
    "bootstrap",
    "key_gen",
    "lut_table",
    "mod_switch_2n",
    "tggsw",
    "tglwe",
    "tgsw",
    "tlwe",
]
