"""Device meshes and sharding helpers on torch.distributed
(`learn_fhe_tpu/parallel/mesh.py`).

The parallel axes are the data layout's:
- 'batch': independent ciphertexts (gate bootstraps, FhewU8 bit lanes),
  embarrassingly parallel, the throughput axis;
- 'limb': RNS primes of a CKKS ciphertext; per-limb ops are local, the
  cross-limb reductions (base extension, rescale) contract over it.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over every rank of
the process group, one rank a mesh position; `mesh.get_group("limb")` is a
rank's limb group (the n_limb consecutive ranks of its batch row) and
`mesh.get_group("batch")` its batch group (the ranks at its limb position).
The JAX package places a global array and lets XLA insert the collectives;
here every rank holds its own shard: `shard_batch` / `shard_limbs` cut this
rank's contiguous slice out of a value every rank has, `replicate` keeps a
value whole, and `gather` / `gather_limbs` all-gather a sharded result
where JAX's `np.asarray` does it implicitly.

Limbs split as `np.array_split` splits (`limb_bounds`): contiguous, the
first L mod n ranks one limb more, so 15 digits over 2 ranks are 8 and 7.
JAX's GSPMD pads an uneven axis instead; the values are the same.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(n_batch: int | None = None, n_limb: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """('batch', 'limb') mesh of n_batch x n_limb ranks over the process
    group (the CPU tests pass device_type="cpu")."""
    n = dist.get_world_size()
    if n_batch is None:
        n_batch = n // n_limb
    assert n_batch * n_limb == n, (n_batch, n_limb, n)
    return init_device_mesh(device_type, (n_batch, n_limb), mesh_dim_names=("batch", "limb"))


def axis_mesh(name: str, n: int | None = None, device_type: str = "cuda") -> DeviceMesh:
    """A 1-D mesh named `name` over every rank (n, if given, must be the
    world size: every rank takes part)."""
    world = dist.get_world_size()
    assert n is None or n == world, f"a {name} mesh of {n} ranks in a world of {world}"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(name,))


def coord(mesh: DeviceMesh, dim: str) -> tuple[int, int]:
    """This rank's position on mesh axis `dim`, and the axis' size."""
    return mesh.get_local_rank(dim), mesh.size(mesh.mesh_dim_names.index(dim))


def shard(mesh: DeviceMesh, x: torch.Tensor, dim: str, axis: int) -> torch.Tensor:
    """This rank's contiguous slice of x's `axis` over mesh axis `dim`
    (a contiguous copy; the axis must divide evenly, as a JAX sharding's)."""
    r, size = coord(mesh, dim)
    axis %= x.dim()
    assert x.shape[axis] % size == 0, f"axis {axis} of {tuple(x.shape)} does not split over {size} ranks"
    k = x.shape[axis] // size
    return x.narrow(axis, r * k, k).contiguous()


def shard_batch(mesh: DeviceMesh, x: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
    """This rank's slice of x's leading batch axis."""
    return shard(mesh, x, "batch", batch_axis)


def limb_bounds(n_limbs: int, n_ranks: int) -> tuple[tuple[int, int], ...]:
    """The (start, stop) of each rank's limbs, as `np.array_split` cuts
    n_limbs over n_ranks: contiguous, the first n_limbs mod n_ranks ranks
    one more (a rank may get none)."""
    k, extra = divmod(n_limbs, n_ranks)
    starts = [r * k + min(r, extra) for r in range(n_ranks + 1)]
    return tuple(zip(starts[:-1], starts[1:]))


def limb_sizes(n_limbs: int, n_ranks: int) -> list[int]:
    return [e - s for s, e in limb_bounds(n_limbs, n_ranks)]


def shard_limbs(mesh: DeviceMesh, x: torch.Tensor, limb_axis: int = -2) -> torch.Tensor:
    """This rank's slice of an RNS tensor's limb axis (`limb_bounds`: an
    uneven split gives the first ranks one limb more), a contiguous copy."""
    r, size = coord(mesh, "limb")
    s, e = limb_bounds(x.shape[limb_axis], size)[r]
    return x.narrow(limb_axis % x.dim(), s, e - s).contiguous()


def gather_limbs(mesh: DeviceMesh, x: torch.Tensor, n_limbs: int, limb_axis: int = -2) -> torch.Tensor:
    """The whole of an (n_limbs-limb) tensor whose limb axis is split over
    'limb' as `shard_limbs` splits it, on every rank of the limb group:
    each rank's slice padded to the largest, all-gathered, then cut back."""
    from .distributed import all_gather

    _, size = coord(mesh, "limb")
    axis = limb_axis % x.dim()
    sizes = limb_sizes(n_limbs, size)
    pad = list(x.shape)
    pad[axis] = max(sizes)
    buf = torch.zeros(pad, dtype=x.dtype, device=x.device)
    buf.narrow(axis, 0, x.shape[axis]).copy_(x)
    parts = all_gather(buf.unsqueeze(0), mesh.get_group("limb"), 0)
    return torch.cat([parts[i].narrow(axis, 0, s) for i, s in enumerate(sizes)], dim=axis)


def replicate(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """x whole on every rank (each rank already holds it)."""
    del mesh
    return x


def gather(mesh: DeviceMesh, x: torch.Tensor, dim: str = "batch", axis: int = 0) -> torch.Tensor:
    """The whole of a result sharded over mesh axis `dim` along `axis`: the
    ranks' slices all-gathered in mesh order, on every rank."""
    from .distributed import all_gather

    return all_gather(x, mesh.get_group(dim), axis % x.dim())
