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
from .bootstrapping import BootstrapKey, BootstrapParams
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


_LUTS: dict[tuple, torch.Tensor] = {}


def lut_poly(params: BootstrapParams, table, device=None) -> torch.Tensor:
    """Negacyclic LUT: each table entry repeated 2N/8 times, mapped to -+Q/8
    (`fhew.rs:31-36`): (N,) int64. One tensor per (Q, N, table, device),
    made on first use and returned again after, so no gate call copies a LUT
    from the host; callers read it and never write it in place."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (params.big_q, params.n, tuple(int(t) for t in table), device)
    lut = _LUTS.get(key)
    if lut is None:
        mapped = np.where(np.asarray(table) == 0, params.big_q - params.big_q_by_8, params.big_q_by_8)
        lut = _LUTS[key] = torch.from_numpy(np.repeat(mapped.astype(np.int64), params.q_by_8)).to(device)
    return lut


def not_(params: BootstrapParams, ct: LweCiphertext) -> LweCiphertext:
    """NOT is linear: (-a, -b + Q/4), no bootstrap (`fhew.rs:27-29`)."""
    q = params.big_q
    return LweCiphertext(neg_mod(ct.a, q), add_mod(neg_mod(ct.b, q), params.big_q_by_4, q))


def op(params: BootstrapParams, key: BootstrapKey, table, ct: LweCiphertext) -> LweCiphertext:
    """One LUT bootstrap of ct (any batch shape) by a 4-entry table, landing
    on {0, Q/4}: the + Q/8 is added by the extract's launch."""
    from ...parallel.batch import fhew_bootstrap_batch

    batch = ct.b.shape
    flat = LweCiphertext(ct.a.reshape(-1, params.n), ct.b.reshape(-1))
    out = fhew_bootstrap_batch(params, key, lut_poly(params, table, ct.a.device), flat, b_add=params.big_q_by_8)
    return LweCiphertext(out.a.reshape(*batch, params.n), out.b.reshape(batch))


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
    lins = []
    for spec in specs:
        name, cts = spec[0], spec[1:]
        if name == "majority":
            assert len(cts) == 3
            lin = lwe.add(params.lwe_z, lwe.add(params.lwe_z, cts[0], cts[1]), cts[2])
        else:
            lin = _lin2(params, name, cts[0], cts[1])
        lins.append(lin)
    n_lwe = lins[0].a.shape[-1]
    flat = LweCiphertext(
        torch.stack([c.a for c in lins]).reshape(-1, n_lwe), torch.stack([c.b for c in lins]).reshape(-1)
    )
    names = [spec[0] for spec in specs]
    if len(set(names)) == 1:  # one gate: K-FHEW-PRE reads the one (N,) LUT for every ciphertext
        lut = lut_poly(params, GATE_TABLES[names[0]], device)
    else:
        luts = torch.stack([lut_poly(params, GATE_TABLES[name], device) for name in names])
        lut = luts.repeat_interleave(int(np.prod(lanes, dtype=np.int64)), dim=0)  # (G*V, N)
    out = fhew_bootstrap_batch(params, key, lut, flat, b_add=params.big_q_by_8)
    b = out.b.reshape(len(specs), *lanes)
    a = out.a.reshape(len(specs), *lanes, n_lwe)
    return [LweCiphertext(a[i], b[i]) for i in range(len(specs))]
