"""Noise-budget observability subsystem.

Counterpart of `learn_fhe_tpu/utils/noise.py`. Given the secret key, the
meters report how many bits of headroom remain between accumulated noise
and the decryption threshold for each scheme's ciphertext type, vectorized
over batch lanes, and the profilers walk gate chains / bootstrap boundaries
recording the per-op budget that a regression test can pin.

The meters' arithmetic is host numpy, as in the JAX package: the port's
tensors (on any device, u64 values in int64) are copied to the host first.
The profilers run the port's batched paths on the key's device and draw
from the caller's `np.random.Generator` in the JAX package's order, so the
same seed gives the same ciphertexts and the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .interop import torch_to_u64


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _u64(x) -> np.ndarray:
    return torch_to_u64(x) if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.uint64)


def _budget_bits(err: np.ndarray, threshold: float) -> np.ndarray:
    """log2(threshold) - log2(|err|) per lane (threshold cap when err == 0)."""
    err = np.abs(np.asarray(err, dtype=np.float64))
    cap = float(np.log2(threshold))
    with np.errstate(divide="ignore"):
        bits = cap - np.log2(err)
    return np.where(err == 0, cap, bits)


def _center(err: np.ndarray, q: int) -> np.ndarray:
    err = np.asarray(err, dtype=object) % q
    return np.where(err >= q // 2, err - q, err).astype(np.float64)


def fhew_noise_bits(params, sk, ct, m_expected):
    """Remaining budget (bits) of FHEW LWE ciphertext(s): threshold is
    Delta/2 = q/(2p). Scalar in, float out; batched in, (B,) array out."""
    from ..models.fhew import lwe

    pt = _host(lwe.decrypt(params.lwe_z, _host(sk), ct)).astype(np.int64)
    q, p = params.big_q, params.p
    m = _host(m_expected).astype(np.int64)
    ideal = np.round(m * (q / p)).astype(np.int64) % q
    err = _center(pt - ideal, q)
    bits = _budget_bits(err, q / (2 * p))
    return float(bits) if np.ndim(pt) == 0 else bits


def tfhe_noise_bits(params, sk, ct, m_expected):
    """Remaining budget of TLWE ciphertext(s) against the 2^log_delta slot."""
    a = _u64(ct.a)
    b = _u64(ct.b)
    mask = np.sum(a * _host(sk).astype(np.uint64), axis=-1)  # wraps mod 2^64
    mu_star = b - mask  # u64 wrap
    m = _u64(m_expected)
    ideal = m << np.uint64(params.log_delta)
    err64 = (mu_star - ideal).astype(np.uint64)
    err = err64.astype(np.int64)  # two's-complement centered lift
    bits = _budget_bits(err.astype(np.float64), 2.0 ** (params.log_delta - 1))
    return float(bits) if np.ndim(mu_star) == 0 else bits


def ckks_precision_bits(m_expected, m_got) -> float:
    """Observed slot precision in bits (the reference's assert_eq_complex
    budget, `f256.rs:291-327`)."""
    d = float(np.max(np.abs(_host(m_expected) - _host(m_got))))
    return 200.0 if d == 0 else float(-np.log2(d))


# ---------------------------------------------------------------------------
# Profilers: per-op noise-growth records
# ---------------------------------------------------------------------------


@dataclass
class NoiseLog:
    """Ordered (label, budget-bits) records from a profiled pipeline."""

    records: list[tuple[str, float]] = field(default_factory=list)

    def add(self, label: str, bits) -> None:
        self.records.append((label, float(np.min(bits))))

    def bits(self) -> list[float]:
        return [b for _, b in self.records]

    def summary(self) -> str:
        return "\n".join(f"{label:32s} {b:6.2f} bits" for label, b in self.records)


def fhew_gate_chain_profile(params, key, sk, depth: int, rng, gate: str = "nand", lanes: int = 8) -> NoiseLog:
    """Walk a depth-`depth` chain of 2-input gates feeding each output back
    as the next left input, recording the worst-lane budget after every gate
    (`parallel/batch.fhew_gate_batch` on the key's device).

    Each gate bootstraps, so the budget must be depth-INDEPENDENT (the meter
    proves noise reset, the property the whole scheme rests on).
    """
    from ..models.fhew import gates, lwe
    from ..parallel.batch import fhew_gate_batch

    dev = key.ksk_a.device
    sk = _host(sk)
    m0 = rng.integers(0, 2, size=lanes).astype(bool)
    m1 = rng.integers(0, 2, size=lanes).astype(bool)
    c0 = lwe.sk_encrypt(params.lwe_z, sk, gates.encode_bool(params, torch.from_numpy(m0).to(dev)), rng)
    c1 = lwe.sk_encrypt(params.lwe_z, sk, gates.encode_bool(params, torch.from_numpy(m1).to(dev)), rng)
    log = NoiseLog()
    log.add("fresh encrypt", fhew_noise_bits(params, sk, c0, m0.astype(int)))
    truth = {
        "and": lambda a, b: a & b,
        "nand": lambda a, b: ~(a & b),
        "or": lambda a, b: a | b,
        "nor": lambda a, b: ~(a | b),
        "xor": lambda a, b: a ^ b,
        "xnor": lambda a, b: ~(a ^ b),
    }[gate]
    cur, cur_m = c0, m0
    for d in range(depth):
        cur = fhew_gate_batch(params, key, gate, cur, c1)
        cur_m = truth(cur_m, m1)
        # gate outputs land on {0, 1} of Z_4 (`fhew.rs:20-25`)
        log.add(f"after {gate} #{d + 1}", fhew_noise_bits(params, sk, cur, cur_m.astype(int)))
    return log


def tfhe_pbs_io_profile(params, key, sk, rng, lanes: int = 8) -> NoiseLog:
    """Budget immediately before and after a programmable bootstrap
    (`parallel/batch.tfhe_pbs_batch` on the key's device)."""
    from ..models.tfhe import lut_table, tlwe
    from ..parallel.batch import tfhe_pbs_batch
    from .interop import u64_to_torch

    dev = key.mon_v.device
    p = params.tlwe.p
    ms = rng.integers(0, p, size=lanes).astype(np.uint64)
    ct = tlwe.sk_encrypt(params.tlwe, sk, tlwe.encode(params.tlwe, u64_to_torch(ms, dev)), rng)
    log = NoiseLog()
    log.add("fresh encrypt", tfhe_noise_bits(params.tlwe, sk, ct, ms))
    tab = u64_to_torch(lut_table(params.tlwe.log_p, params.big_n, lambda v: v), dev)
    out = tfhe_pbs_batch(params, key, tab, ct)
    log.add("after PBS", tfhe_noise_bits(params.tlwe, sk, out, ms))
    return log
