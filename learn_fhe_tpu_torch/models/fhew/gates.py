"""FHEW boolean gates (MP21 Table 1; `learn_fhe_tpu/models/fhew/gates.py`).

A gate is a linear combination of its input ciphertexts and one LUT
bootstrap: the LUT maps the 4 plaintext quadrants to +-Q/8, and the final
+Q/8 lands the output on {0, Q/4} (`fhew.rs:31-39`).
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops.modular import add_mod, neg_mod
from . import lwe
from .bootstrapping import BootstrapKey, BootstrapParams, bootstrap
from .lwe import LweCiphertext

# Table 1 in 2020/086 (`fhew.rs:59-67`)
GATE_TABLES = {
    "and": [0, 0, 0, 1],
    "nand": [1, 1, 1, 0],
    "or": [0, 1, 1, 1],
    "nor": [1, 0, 0, 0],
    "xor": [0, 1, 1, 1],
    "xnor": [1, 0, 0, 0],
    "majority": [0, 0, 0, 1],
}


def encode_bool(params: BootstrapParams, m: torch.Tensor) -> torch.Tensor:
    """m: bool or 0/1 tensor of any shape."""
    assert params.p == 4
    return lwe.encode(params.lwe_z, m.long())


def decode_bool(params: BootstrapParams, pt: torch.Tensor) -> torch.Tensor:
    """Values must land on {0, 1} of Z_4 (`fhew.rs:20-25`)."""
    return lwe.decode(params.lwe_z, pt) == 1


def lut_poly(params: BootstrapParams, table, device=None) -> torch.Tensor:
    """Negacyclic LUT: each table entry repeated 2N/8 times, mapped to -+Q/8
    (`fhew.rs:31-36`): (N,) int64."""
    mapped = np.where(np.asarray(table) == 0, params.big_q - params.big_q_by_8, params.big_q_by_8)
    return torch.from_numpy(np.repeat(mapped.astype(np.int64), params.q_by_8)).to(device)


def not_(params: BootstrapParams, ct: LweCiphertext) -> LweCiphertext:
    """NOT is linear: (-a, -b + Q/4), no bootstrap (`fhew.rs:27-29`)."""
    q = params.big_q
    return LweCiphertext(neg_mod(ct.a, q), add_mod(neg_mod(ct.b, q), params.big_q_by_4, q))


def op(params: BootstrapParams, key: BootstrapKey, table, ct: LweCiphertext) -> LweCiphertext:
    """One LUT bootstrap of ct by a 4-entry table, landing on {0, Q/4}."""
    out = bootstrap(params, key, lut_poly(params, table, ct.a.device), ct)
    return LweCiphertext(out.a, add_mod(out.b, params.big_q_by_8, params.big_q))


def _lin2(params: BootstrapParams, name: str, ct0: LweCiphertext, ct1: LweCiphertext) -> LweCiphertext:
    if name in ("and", "nand", "or", "nor"):
        return lwe.add(params.lwe_z, ct0, ct1)
    if name in ("xor", "xnor"):
        return lwe.double(params.lwe_z, lwe.sub(params.lwe_z, ct0, ct1))
    raise KeyError(name)


def gate(params, key, name, ct0, ct1, ct2=None) -> LweCiphertext:
    """A named 2- or 3-input gate: one bootstrap, through `gate_batch`."""
    spec = (name, ct0, ct1) if ct2 is None else (name, ct0, ct1, ct2)
    return gate_batch(params, key, [spec])[0]


def and_(p, k, a, b):
    return gate(p, k, "and", a, b)


def nand(p, k, a, b):
    return gate(p, k, "nand", a, b)


def or_(p, k, a, b):
    return gate(p, k, "or", a, b)


def nor(p, k, a, b):
    return gate(p, k, "nor", a, b)


def xor(p, k, a, b):
    return gate(p, k, "xor", a, b)


def xnor(p, k, a, b):
    return gate(p, k, "xnor", a, b)


def majority(p, k, a, b, c):
    return gate(p, k, "majority", a, b, c)


def gate_batch(params: BootstrapParams, key: BootstrapKey, specs: list[tuple]) -> list[LweCiphertext]:
    """A list of gates [(name, ct0, ct1[, ct2]), ...] with one batched
    bootstrap and one LUT per gate; the same result as `gate` per spec. The
    input ciphertexts may carry a leading "value lane" batch shape: all G
    gates x V lanes run as one bootstrap of G*V ciphertexts. The batch runs
    at its own size (the JAX package pads it for its jit cache)."""
    from ...parallel.batch import fhew_bootstrap_batch

    lanes = tuple(specs[0][1].b.shape)
    device = specs[0][1].a.device
    lins, luts = [], []
    for spec in specs:
        name, cts = spec[0], spec[1:]
        if name == "majority":
            assert len(cts) == 3
            lin = lwe.add(params.lwe_z, lwe.add(params.lwe_z, cts[0], cts[1]), cts[2])
        else:
            lin = _lin2(params, name, cts[0], cts[1])
        lins.append(lin)
        luts.append(lut_poly(params, GATE_TABLES[name], device))
    n_lwe = lins[0].a.shape[-1]
    flat = LweCiphertext(
        torch.stack([c.a for c in lins]).reshape(-1, n_lwe), torch.stack([c.b for c in lins]).reshape(-1)
    )
    lut = torch.stack(luts).repeat_interleave(int(np.prod(lanes, dtype=np.int64)), dim=0)  # (G*V, N)
    out = fhew_bootstrap_batch(params, key, lut, flat)
    b = add_mod(out.b, params.big_q_by_8, params.big_q).reshape(len(specs), *lanes)
    a = out.a.reshape(len(specs), *lanes, n_lwe)
    return [LweCiphertext(a[i], b[i]) for i in range(len(specs))]
