"""FHEW parameter sets (`learn_fhe_tpu/models/fhew/params.py`).

Two engines, chosen as the JAX package chooses them: the u32 engine (int32
residues with Shoup duals, K-NTT and K-FHEW-BR) where the ciphertext
modulus and the whole gadget digit span fit 31 bits (`use_u32`), the u64
engine (int64 residues, keys in the evaluation basis and the Montgomery
domain, K-NTT64, K-EXTPROD64 and K-FHEW-BR64) for the rest, up to q < 2^63.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

from ...ops.gadget import Gadget, decompose_zq_supports_u32
from ...ops.ntt import NttPlan, ntt_plan

AUTO_G = 5  # generator of the automorphism group used by LMKCDEY (`rlwe.rs:92`)


@dataclass(frozen=True)
class LweParams:
    """LWE over Z_q with plaintext space Z_p (`lwe.rs:10-53`)."""

    q: int
    p: int
    n: int
    log_b: int | None = None
    d: int | None = None

    def __post_init__(self):
        assert self.q > self.p

    @property
    def delta(self) -> float:
        return self.q / self.p

    @cached_property
    def gadget(self) -> Gadget:
        assert self.log_b is not None and self.d is not None
        return Gadget(self.q, self.log_b, self.d)


@dataclass(frozen=True)
class RlweParams:
    """RLWE over Z_q[X]/(X^N+1) (`rlwe.rs:13-25`)."""

    q: int
    p: int
    log_n: int
    log_b: int | None = None
    d: int | None = None

    @property
    def n(self) -> int:
        return 1 << self.log_n

    @property
    def delta(self) -> float:
        return self.q / self.p

    @cached_property
    def gadget(self) -> Gadget:
        assert self.log_b is not None and self.d is not None
        return Gadget(self.q, self.log_b, self.d)

    @cached_property
    def plan(self) -> NttPlan:
        return ntt_plan(self.q, self.n)

    @property
    def use_u32(self) -> bool:
        """The u32 engine takes the modulus and the whole digit span."""
        return self.q < (1 << 31) and (self.log_b is None or decompose_zq_supports_u32(Gadget(self.q, self.log_b, self.d)))

    @cached_property
    def plan32(self):
        from ...ops.ntt32 import ntt32_plan

        return ntt32_plan(self.q, self.n)


@dataclass(frozen=True)
class RgswParams:
    """RGSW = gadget RLWE, with its own gadget for external products
    (`rgsw.rs:11-27`)."""

    rlwe: RlweParams
    log_b: int
    d: int

    @property
    def q(self) -> int:
        return self.rlwe.q

    @property
    def p(self) -> int:
        return self.rlwe.p

    @property
    def n(self) -> int:
        return self.rlwe.n

    @cached_property
    def gadget(self) -> Gadget:
        return Gadget(self.q, self.log_b, self.d)

    @property
    def plan(self) -> NttPlan:
        return self.rlwe.plan

    @property
    def use_u32(self) -> bool:
        return decompose_zq_supports_u32(Gadget(self.q, self.log_b, self.d))

    @property
    def plan32(self):
        return self.rlwe.plan32
