"""TFHE parameter sets (`learn_fhe_tpu/models/tfhe/params.py`).

The torus is Z/2^64 (int64 bit patterns here); plaintexts live in the top
log_p + padding bits: log_delta = 64 - log_p - padding (`tlwe.rs:46-48`).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

from ...ops.gadget import Gadget


@dataclass(frozen=True)
class TlweParams:
    log_p: int
    padding: int
    n: int
    std_dev: float
    log_b: int | None = None
    d: int | None = None

    @property
    def p(self) -> int:
        return 1 << self.log_p

    @property
    def log_delta(self) -> int:
        return 64 - self.log_p - self.padding

    @cached_property
    def gadget(self) -> Gadget:
        assert self.log_b is not None and self.d is not None
        return Gadget(0, self.log_b, self.d)  # q=0 => torus 2^64


@dataclass(frozen=True)
class TglweParams:
    """Ring variant: k polynomials of degree big_n; the flattened LWE view has
    dimension big_n * k (`tglwe.rs:12-35`)."""

    log_p: int
    padding: int
    big_n: int
    k: int
    std_dev: float

    @property
    def p(self) -> int:
        return 1 << self.log_p

    @property
    def log_delta(self) -> int:
        return 64 - self.log_p - self.padding

    @property
    def n_flat(self) -> int:
        return self.big_n * self.k

    def tlwe_view(self, log_b: int | None = None, d: int | None = None) -> TlweParams:
        return TlweParams(self.log_p, self.padding, self.n_flat, self.std_dev, log_b, d)


@dataclass(frozen=True)
class TgswParams:
    tlwe: TlweParams
    log_b: int
    d: int

    @cached_property
    def gadget(self) -> Gadget:
        return Gadget(0, self.log_b, self.d)


@dataclass(frozen=True)
class TggswParams:
    tglwe: TglweParams
    log_b: int
    d: int

    @property
    def p(self) -> int:
        return self.tglwe.p

    @property
    def big_n(self) -> int:
        return self.tglwe.big_n

    @property
    def k(self) -> int:
        return self.tglwe.k

    @cached_property
    def gadget(self) -> Gadget:
        return Gadget(0, self.log_b, self.d)
