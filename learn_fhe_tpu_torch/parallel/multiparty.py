"""Multi-party share merging as one collective (`learn_fhe_tpu/parallel/
multiparty.py`): merges of additive shares are sums, so merging a batch of
shares held one party a rank is one all_reduce(SUM) over the party group.

A rank folds its own shares into a raw u64 sum (int64 bits, which wrap
mod 2^64 as u64 does), the all_reduce adds the ranks' sums (int64 on gloo
and nccl is two's complement, so it wraps the same way), and an unsigned
reduction mod q ends it. The sum is exact while n_parties (q - 1) < 2^64.
The JAX package splits its u64 psum into four 16-bit pieces because a TPU
lowers no u64 all-reduce; here the u64 sum goes as it is, with the same
values.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.modular import barrett_reduce_u64
from .distributed import all_reduce_sum
from .mesh import axis_mesh, coord, shard

AXIS = "party"


def party_mesh(n_parties: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D 'party' mesh over every rank."""
    return axis_mesh(AXIS, n_parties, device_type)


def shard_parties(mesh: DeviceMesh, shares: torch.Tensor) -> torch.Tensor:
    """This rank's parties of a stacked (P, ...) share tensor."""
    return shard(mesh, shares, AXIS, 0)


def merge_shares(mesh: DeviceMesh, shares: torch.Tensor, q: int) -> torch.Tensor:
    """sum_p shares[p] mod q, where each rank passes its own parties'
    shares (P / ranks, ...) as `shard_parties` gives them, values reduced
    mod q; returns (...) on every rank."""
    _, ranks = coord(mesh, AXIS)
    n_parties = shares.shape[0] * ranks
    assert n_parties * (q - 1) < (1 << 64), "raw u64 sum would overflow"
    total = all_reduce_sum(shares.long().sum(0), mesh.get_group(AXIS))
    return barrett_reduce_u64(total, q)
