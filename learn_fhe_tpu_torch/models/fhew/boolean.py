"""FhewBool: an encrypted boolean with operator overloading
(`learn_fhe_tpu/models/fhew/boolean.py`, reference
`scheme/fhew/src/fhew/boolean.rs`).

A FhewBool wraps one LWE ciphertext and the bootstrap key. The derived
circuits (select, adders, subtractors) are the JAX package's gate
compositions, and the independent gates of a circuit run as one batched
bootstrap (`gate_many`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

import numpy as np
import torch

from . import gates, lwe, rlwe
from .bootstrapping import BootstrapKey, BootstrapParams
from .lwe import LweCiphertext
from .rlwe import RlweCiphertext


@dataclass
class FhewBool:
    ct: LweCiphertext
    params: BootstrapParams
    key: BootstrapKey

    # -- encryption / decryption ---------------------------------------------

    @classmethod
    def sk_encrypt(
        cls, params: BootstrapParams, key: BootstrapKey, sk: np.ndarray, m, rng: np.random.Generator
    ) -> "FhewBool":
        """m: a bool, or a bool array: a batched m gives a VECTORIZED
        encrypted bool whose gates run lane-parallel in one bootstrap."""
        bits = torch.as_tensor(np.asarray(m, dtype=np.int64), device=key.brk_a.device)
        return cls(lwe.sk_encrypt(params.lwe_z, sk, gates.encode_bool(params, bits), rng), params, key)

    @classmethod
    def pk_encrypt(
        cls, params: BootstrapParams, key: BootstrapKey, pk: RlweCiphertext, m: bool, rng: np.random.Generator
    ) -> "FhewBool":
        """RLWE-encrypt the constant m, then sample-extract (`boolean.rs:27-35`)."""
        const = torch.zeros(params.n, dtype=torch.int64, device=pk.a.device)
        const[0] = int(m)
        ct = rlwe.pk_encrypt(params.rlwe, pk, rlwe.encode(params.rlwe, const), rng)
        return cls(rlwe.sample_extract(params.rlwe, ct, 0), params, key)

    def decrypt(self, sk: np.ndarray):
        """bool for a scalar ciphertext, a np.bool_ array for a vectorized one."""
        pt = lwe.decrypt(self.params.lwe_z, sk, self.ct)
        out = gates.decode_bool(self.params, pt).cpu().numpy()
        return bool(out) if out.ndim == 0 else out

    def share_decrypt(self, sk: np.ndarray, rng: np.random.Generator) -> torch.Tensor:
        return lwe.share_decrypt(self.params.lwe_z, sk, self.ct.a, rng)

    def decryption_share_merge(self, shares: Iterable[torch.Tensor]) -> bool:
        pt = lwe.decryption_share_merge(self.params.lwe_z, self.ct.b, shares)
        return bool(gates.decode_bool(self.params, pt))

    # -- gates ----------------------------------------------------------------

    def _wrap(self, ct: LweCiphertext) -> "FhewBool":
        return FhewBool(ct, self.params, self.key)

    def _gate(self, name: str, *others: "FhewBool") -> "FhewBool":
        return self._wrap(gates.gate(self.params, self.key, name, self.ct, *(o.ct for o in others)))

    def __invert__(self) -> "FhewBool":
        return self._wrap(gates.not_(self.params, self.ct))

    def __and__(self, o: "FhewBool") -> "FhewBool":
        return self._gate("and", o)

    def __or__(self, o: "FhewBool") -> "FhewBool":
        return self._gate("or", o)

    def __xor__(self, o: "FhewBool") -> "FhewBool":
        return self._gate("xor", o)

    def nand(self, o: "FhewBool") -> "FhewBool":
        return self._gate("nand", o)

    def nor(self, o: "FhewBool") -> "FhewBool":
        return self._gate("nor", o)

    def xnor(self, o: "FhewBool") -> "FhewBool":
        return self._gate("xnor", o)

    def majority(self, o1: "FhewBool", o2: "FhewBool") -> "FhewBool":
        return self._gate("majority", o1, o2)

    # -- derived circuits (`boolean.rs:135-176`) ------------------------------

    def select(self, f: "FhewBool", t: "FhewBool") -> "FhewBool":
        nf, st = gate_many([("and", ~self, f), ("and", self, t)])
        return nf | st

    def overflowing_add(self, rhs: "FhewBool") -> tuple["FhewBool", "FhewBool"]:
        s, c = gate_many([("xor", self, rhs), ("and", self, rhs)])
        return s, c

    def carrying_add(self, rhs: "FhewBool", carry: "FhewBool") -> tuple["FhewBool", "FhewBool"]:
        """Full adder in two bootstrap rounds: the carry-out is the 3-input
        majority."""
        t, c_out = gate_many([("xor", self, rhs), ("majority", self, rhs, carry)])
        return t ^ carry, c_out

    def overflowing_sub(self, rhs: "FhewBool") -> tuple["FhewBool", "FhewBool"]:
        d, b = gate_many([("xor", self, rhs), ("and", ~self, rhs)])
        return d, b

    def borrowing_sub(self, rhs: "FhewBool", borrow: "FhewBool") -> tuple["FhewBool", "FhewBool"]:
        """Full subtractor in two rounds: borrow-out = majority(~a, b, borrow)."""
        t, b_out = gate_many([("xor", self, rhs), ("majority", ~self, rhs, borrow)])
        return t ^ borrow, b_out


def gate_many(ops: list[tuple]) -> list[FhewBool]:
    """Independent gates [(name, FhewBool...), ...] in one batched bootstrap;
    all inputs share params and key."""
    first = ops[0][1]
    specs = [(name, *(b.ct for b in bs)) for name, *bs in ops]
    outs = gates.gate_batch(first.params, first.key, specs)
    return [FhewBool(ct, first.params, first.key) for ct in outs]
