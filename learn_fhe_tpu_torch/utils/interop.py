"""numpy <-> torch views for the port's integer carriers, and the key carry-over.

torch has no arithmetic on uint32/uint64, so the port carries torus values
(u64) as int64 and residues/Shoup duals (u32) as int32 holding the same bit
pattern. Crossing the boundary is always a `.view`, never a value cast.
"""

from __future__ import annotations

import numpy as np
import torch


def _to(arr: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return t if device is None else t.to(device)


def u64_to_torch(x, device=None) -> torch.Tensor:
    """u64 array -> int64 tensor with the same bits."""
    return _to(np.ascontiguousarray(np.asarray(x, dtype=np.uint64)).view(np.int64), device)


def u32_to_torch(x, device=None) -> torch.Tensor:
    """u32 array -> int32 tensor with the same bits."""
    return _to(np.ascontiguousarray(np.asarray(x, dtype=np.uint32)).view(np.int32), device)


def resolve_device(device) -> torch.device:
    """Where an entry point puts what it makes: the device the caller names,
    else the current CUDA device. The port runs on a GPU; it never falls back
    to the CPU unless the caller passes device="cpu"."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "learn_fhe_tpu_torch runs on a GPU and no CUDA device is present; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())


def torch_to_u64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def torch_to_u32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def bootstrap_key_from_numpy(key, device=None):
    """The port's BootstrapKey from the JAX package's, given as numpy leaves
    (`jax.tree.map(np.asarray, key)`).

    The JAX key keeps one array per CRT prime; the port stacks the primes on
    one axis just before the gadget-row axis: brk av/ad (n, K, R, k, N),
    bv/bd (n, K, R, N), and mon_v/mon_d (K, 2N, N). The key goes to `device`,
    by default the current CUDA device (see `resolve_device`).
    """
    from ..models.tfhe.bootstrapping import BootstrapKey
    from ..models.tfhe.tggsw import TggswEval
    from ..models.tfhe.tlwe import TlweKeySwitchingKey

    device = resolve_device(device)

    def primes(leaves, axis):
        return u32_to_torch(np.stack([np.asarray(x) for x in leaves], axis=axis), device)

    brk = TggswEval(
        primes(key.brk.av, 1),
        primes(key.brk.ad, 1),
        primes(key.brk.bv, 1),
        primes(key.brk.bd, 1),
    )
    ksk = TlweKeySwitchingKey(u64_to_torch(key.ksk.a, device), u64_to_torch(key.ksk.b, device))
    return BootstrapKey(brk, ksk, primes(key.mon_v, 0), primes(key.mon_d, 0))
