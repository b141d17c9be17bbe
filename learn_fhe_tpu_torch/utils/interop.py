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
    return _to(np.asarray(x, dtype=np.uint64, order="C").view(np.int64), device)


def u32_to_torch(x, device=None) -> torch.Tensor:
    """u32 array -> int32 tensor with the same bits."""
    return _to(np.asarray(x, dtype=np.uint32, order="C").view(np.int32), device)


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


def fhew_bootstrap_key_from_numpy(key, device=None):
    """The port's FHEW BootstrapKey from the JAX package's, given as numpy
    leaves (`jax.tree.map(np.asarray, key)`), on either engine: u32 brk/ak
    values with their Shoup duals, or u64 brk/ak values in the Montgomery
    domain with the dual fields None, copied as they are; the LWE key
    switch's rows u64, auto_src as int32 and auto_sign as bool. The key goes
    to `device`, by default the current CUDA device (see `resolve_device`)."""
    from ..models.fhew.bootstrapping import BootstrapKey

    device = resolve_device(device)
    u32 = key.brk_ad is not None
    fields = {}
    for f in BootstrapKey._fields:
        x = getattr(key, f)
        if x is None:
            if u32 or f not in ("brk_ad", "brk_bd", "ak_ad", "ak_bd"):
                raise ValueError(f"fhew_bootstrap_key_from_numpy: {f} is None")
            fields[f] = None
            continue
        x = np.asarray(x)
        if f == "auto_src":
            fields[f] = _to(x.astype(np.int32), device)
        elif f == "auto_sign":
            fields[f] = _to(x.astype(bool), device)
        elif u32 and f.startswith(("brk", "ak")):
            fields[f] = u32_to_torch(x, device)
        else:
            fields[f] = u64_to_torch(x, device)
    return BootstrapKey(**fields)


def fhew_crs_from_numpy(crs, device=None):
    """The port's BootstrapCrs from the JAX package's, as numpy leaves: u64
    values as int64, on `device` (see `resolve_device`)."""
    from ..models.fhew.bootstrapping import BootstrapCrs

    device = resolve_device(device)
    return BootstrapCrs(*(u64_to_torch(np.asarray(getattr(crs, f)), device) for f in BootstrapCrs._fields))


def fhew_key_share_from_numpy(share, device=None):
    """The port's BootstrapKeyShare from the JAX package's, as numpy leaves
    (the brk share in the coefficient basis), on `device`."""
    from ..models.fhew.bootstrapping import BootstrapKeyShare
    from ..models.fhew.rgsw import RgswCiphertext

    device = resolve_device(device)
    return BootstrapKeyShare(
        u64_to_torch(np.asarray(share.ksk_b), device),
        RgswCiphertext(u64_to_torch(np.asarray(share.brk.a), device), u64_to_torch(np.asarray(share.brk.b), device)),
        u64_to_torch(np.asarray(share.ak_b), device),
    )


def ckks_ciphertext_from_numpy(ct, device=None):
    """The port's CkksCiphertext from the JAX package's, given with numpy
    leaves (b and a u64 of shape (..., L, N)) and its level `qs`, on
    `device` (see `resolve_device`)."""
    from ..models.ckks.ckks import CkksCiphertext

    device = resolve_device(device)
    return CkksCiphertext(u64_to_torch(np.asarray(ct.b), device), u64_to_torch(np.asarray(ct.a), device), tuple(ct.qs))


def ckks_ksk_from_numpy(ksk, device=None):
    """The port's CkksKeySwitchingKey from the JAX package's, given with
    numpy leaves: the evaluation-basis b and a over qps, (2L, N) or with a
    leading digit axis (D, 2L, N), copied as they are, on `device`."""
    from ..models.ckks.ckks import CkksKeySwitchingKey

    device = resolve_device(device)
    b, a = np.asarray(ksk.b), np.asarray(ksk.a)
    if b.shape != a.shape or b.ndim not in (2, 3) or b.shape[-2] != len(ksk.qs):
        raise ValueError(f"ckks_ksk_from_numpy: expected b and a of shape ([D,] {len(ksk.qs)}, N), got {b.shape}, {a.shape}")
    return CkksKeySwitchingKey(u64_to_torch(b, device), u64_to_torch(a, device), tuple(ksk.qs))


def ckks_bootstrap_key_from_numpy(bk, device=None):
    """The port's BootstrapKey from the JAX package's, given with numpy
    leaves: its parameters (a CkksParams' fields and r) and its `rtk` dict
    of rotation keys, each key by `ckks_ksk_from_numpy`, on `device` (see
    `resolve_device`). The diagonal cache starts empty: the port encodes
    its own."""
    from ..models.ckks.bootstrapping import BootstrapKey, BootstrapParams
    from ..models.ckks.ckks import CkksParams, CkksRotKey

    device = resolve_device(device)
    p = bk.bp.params
    params = CkksParams(p.log_n, p.log_qi, p.big_l, p.log_qis, p.log_ps, p.dnum)
    rtk = {int(j): CkksRotKey(ckks_ksk_from_numpy(k.ksk, device), int(k.j)) for j, k in bk.rtk.items()}
    return BootstrapKey(BootstrapParams(params, bk.bp.r), rtk)


def bgv_ciphertext_from_numpy(ct, device=None):
    """The port's BgvCiphertext from the JAX package's, given with numpy
    leaves (b and a u64 of shape (..., L, N)), its level `qs` and its
    plaintext `factor`, on `device` (see `resolve_device`)."""
    from ..models.bgv.bgv import BgvCiphertext

    device = resolve_device(device)
    return BgvCiphertext(
        u64_to_torch(np.asarray(ct.b), device), u64_to_torch(np.asarray(ct.a), device), tuple(ct.qs), int(ct.factor)
    )


def bgv_ksk_from_numpy(ksk, device=None):
    """The port's BgvKeySwitchingKey from the JAX package's, given with numpy
    leaves (the evaluation-basis b and a (2L, N) over qps, copied as they
    are), or its BgvRotKey from a JAX BgvRotKey (keeping `j`), on `device`."""
    from ..models.bgv.bgv import BgvKeySwitchingKey, BgvRotKey

    if hasattr(ksk, "ksk"):
        return BgvRotKey(bgv_ksk_from_numpy(ksk.ksk, device), int(ksk.j))
    device = resolve_device(device)
    b, a = np.asarray(ksk.b), np.asarray(ksk.a)
    if b.shape != a.shape or b.ndim != 2 or b.shape[0] != len(ksk.qs):
        raise ValueError(f"bgv_ksk_from_numpy: expected b and a of shape ({len(ksk.qs)}, N), got {b.shape}, {a.shape}")
    return BgvKeySwitchingKey(u64_to_torch(b, device), u64_to_torch(a, device), tuple(ksk.qs))


def tgsw_ciphertext_from_numpy(ct, device=None):
    """The port's TgswCiphertext from the JAX package's, as numpy leaves (a
    (..., R, n) and b (..., R) torus values), on `device`."""
    from ..models.tfhe.tgsw import TgswCiphertext

    device = resolve_device(device)
    return TgswCiphertext(u64_to_torch(np.asarray(ct.a), device), u64_to_torch(np.asarray(ct.b), device))


def tggsw_ciphertext_from_numpy(ct, device=None):
    """The port's TggswCiphertext from the JAX package's, as numpy leaves (a
    (..., R, k, N) and b (..., R, N) torus values), on `device`."""
    from ..models.tfhe.tggsw import TggswCiphertext

    device = resolve_device(device)
    return TggswCiphertext(u64_to_torch(np.asarray(ct.a), device), u64_to_torch(np.asarray(ct.b), device))
