"""Key/ciphertext (de)serialization for multi-host deployment.

Counterpart of `learn_fhe_tpu/utils/serialization.py`, with the same file:
any of the port's NamedTuple/dataclass/dict/list containers is flattened to
one `.npz` with a structure manifest (`__manifest__`, JSON bytes; the same
kinds and the same key syntax: `.field`, `[key]`, `#index`), so a file that
either package writes loads in the other's `load`. It covers the
multi-party protocol's messages (CRS, key shares, ciphertexts, decryption
shares) and checkpoint/resume of key material.

Tensors are written as `.cpu().numpy()`, bits as they are: the port's int64
and int32 carriers keep their u64 and u32 patterns, in signed arrays. `load`
gives tensors on a device; an unsigned array (the JAX package writes u64
and u32) becomes the signed carrier of its width with the same bits, and
`utils/interop`'s `*_from_numpy` converters take what `load(...,
device="cpu")` returns from a JAX-written key.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from .interop import resolve_device

_SIGNED = {np.dtype(np.uint32): np.int32, np.dtype(np.uint64): np.int64}


def _flatten(obj: Any, prefix: str, arrays: dict, manifest: dict) -> None:
    if hasattr(obj, "_fields"):  # NamedTuple
        manifest[prefix] = {"kind": "namedtuple", "type": type(obj).__name__, "fields": list(obj._fields)}
        for f in obj._fields:
            _flatten(getattr(obj, f), f"{prefix}.{f}", arrays, manifest)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        names = [f.name for f in dataclasses.fields(obj)]
        manifest[prefix] = {"kind": "dataclass", "type": type(obj).__name__, "fields": names}
        for f in names:
            _flatten(getattr(obj, f), f"{prefix}.{f}", arrays, manifest)
    elif isinstance(obj, dict):
        manifest[prefix] = {"kind": "dict", "keys": [str(k) for k in obj.keys()]}
        for k, v in obj.items():
            _flatten(v, f"{prefix}[{k}]", arrays, manifest)
    elif isinstance(obj, (list, tuple)) and obj and not isinstance(obj[0], (int, float)):
        manifest[prefix] = {"kind": "list", "len": len(obj)}
        for i, v in enumerate(obj):
            _flatten(v, f"{prefix}#{i}", arrays, manifest)
    elif isinstance(obj, tuple):  # tuple of scalars (e.g. qs level metadata)
        manifest[prefix] = {"kind": "scalars", "values": list(obj)}
    elif isinstance(obj, (int, float, str, bool)):
        manifest[prefix] = {"kind": "scalar", "value": obj}
    elif obj is None:
        manifest[prefix] = {"kind": "none"}
    else:
        manifest[prefix] = {"kind": "array"}
        arrays[prefix] = obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)


def save(path: str, **objects) -> None:
    """Serialize named containers (keys, ciphertexts, CRS...) to one .npz."""
    arrays: dict = {}
    manifest: dict = {}
    for name, obj in objects.items():
        _flatten(obj, name, arrays, manifest)
    arrays["__manifest__"] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _tensor(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    signed = _SIGNED.get(arr.dtype)
    return torch.from_numpy(arr if signed is None else arr.view(signed)).to(device)


def load(path: str, reconstruct: dict[str, Any] | None = None, device=None) -> dict[str, Any]:
    """Load back; returns {name: structure} with every array a tensor on
    `device` (by default the current CUDA device, see `resolve_device`). If
    `reconstruct` maps a name (a root or a path like "key.brk") or a type
    name to a class, that container is rebuilt typed as cls(**fields);
    otherwise nested dicts/lists of tensors are returned."""
    device = resolve_device(device)
    classes = reconstruct or {}
    with np.load(path) as data:
        manifest = json.loads(bytes(data["__manifest__"]).decode())
        roots = sorted({k.split(".")[0].split("[")[0].split("#")[0] for k in manifest})

        def build(prefix: str):
            meta = manifest[prefix]
            kind = meta["kind"]
            if kind == "array":
                return _tensor(data[prefix], device)
            if kind == "scalar":
                return meta["value"]
            if kind == "scalars":
                return tuple(meta["values"])
            if kind == "none":
                return None
            if kind in ("namedtuple", "dataclass"):
                fields = {f: build(f"{prefix}.{f}") for f in meta["fields"]}
                cls = classes.get(prefix) or classes.get(meta["type"])
                return cls(**fields) if cls else fields
            if kind == "dict":
                return {k: build(f"{prefix}[{k}]") for k in meta["keys"]}
            if kind == "list":
                return [build(f"{prefix}#{i}") for i in range(meta["len"])]
            raise ValueError(kind)

        return {r: build(r) for r in roots}
