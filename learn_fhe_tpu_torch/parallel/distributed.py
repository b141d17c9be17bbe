"""Multi-process bring-up on torch.distributed (`learn_fhe_tpu/parallel/
distributed.py`), and the few collectives the sharded paths use.

    from learn_fhe_tpu_torch.parallel.distributed import init_distributed, global_mesh
    init_distributed()                  # False for a single process
    mesh = global_mesh(n_limb=1)        # ('batch', 'limb') over every rank

The backend is explicit and never changes on its own after a failure:
- `nccl` where each rank has a card of its own;
- `gloo` on the CPU, or where ranks share a card. gloo's send and receive
  take no CUDA tensor, so every exchange here of a CUDA tensor over gloo
  stages through pinned host memory (`exchange`, `all_reduce_sum`,
  `all_gather`).
The caller names it, or `init_distributed` picks it by that rule and prints
its choice.

A collective that loses its peer either fails (gloo: "Connection closed by
peer") or blocks. `collective_watchdog` turns both into one diagnosable end:
a `FAULT DETECTED` line on stderr and exit code 86.
"""

from __future__ import annotations

import os
import sys
import threading
from contextlib import contextmanager

import torch
import torch.distributed as dist

from .mesh import make_mesh

FAULT_EXIT = 86


class PeerLostError(RuntimeError):
    """A collective of this module failed: its peer is gone or unreachable."""


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> bool:
    """Initialise torch.distributed when running multi-process; True if a
    process group is up, False for a single process. Explicit arguments win,
    then torchrun's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK. The
    address is host:port (tcp://), or a tcp:// or file:// URL. Safe to call
    twice. Under nccl each rank takes card rank mod the cards it sees, and
    the communicator is made at once (`device_id`), so a first
    point-to-point exchange does not wait for ranks outside it."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    num_processes = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    process_id = process_id if process_id is not None else _env_int("RANK")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed: needs the address, the number of processes and this process's id")
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    if backend is None:
        own_card = torch.cuda.is_available() and torch.cuda.device_count() >= num_processes
        backend = "nccl" if own_card else "gloo"
    kwargs = {}
    if backend == "nccl":
        card = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
        kwargs["device_id"] = card
    print(f"init_distributed: rank {process_id} of {num_processes}, backend {backend}", flush=True)
    dist.init_process_group(backend, init_method=coordinator_address, world_size=num_processes, rank=process_id, **kwargs)
    return True


def global_mesh(n_batch: int | None = None, n_limb: int = 1, device_type: str = "cuda"):
    """('batch', 'limb') mesh over every rank, batch-major: a rank's limb
    group is n_limb consecutive ranks (torchrun numbers a host's ranks
    consecutively, so the chatty limb axis stays within a host)."""
    return make_mesh(n_batch, n_limb, device_type)


# ---------------------------------------------------------------------------
# Collectives, with gloo's CUDA tensors staged through pinned host memory
# ---------------------------------------------------------------------------


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return h


def _run(what: str, fn):
    try:
        return fn()
    except RuntimeError as e:
        raise PeerLostError(f"{what}: {e}") from e


def exchange(x: torch.Tensor, peer: int, group=None) -> torch.Tensor:
    """Send x to rank `peer` of `group` and receive its block of x's shape
    and dtype: one `batch_isend_irecv`."""
    staged = _staged(x, group)
    send = _to_host(x) if staged else x.contiguous()
    recv = torch.empty_like(send)
    peer_global = dist.get_global_rank(group, peer) if group is not None else peer
    ops = [dist.P2POp(dist.isend, send, peer_global, group), dist.P2POp(dist.irecv, recv, peer_global, group)]

    def run():
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _run(f"exchange with rank {peer}", run)
    return recv.to(x.device, non_blocking=True) if staged else recv


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of x over the ranks of `group` (int64 wraps mod 2^64 on
    gloo and nccl alike), on every rank; x is left as it was."""
    staged = _staged(x, group)
    buf = _to_host(x) if staged else x.clone()
    _run("all_reduce", lambda: dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group))
    return buf.to(x.device, non_blocking=True) if staged else buf


def all_gather(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """Every rank's x of `group`, in rank order, concatenated along `axis`."""
    staged = _staged(x, group)
    src = _to_host(x) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    _run("all_gather", lambda: dist.all_gather(parts, src, group=group))
    out = torch.cat(parts, dim=axis)
    return out.to(x.device, non_blocking=True) if staged else out


# ---------------------------------------------------------------------------
# Failure detection
# ---------------------------------------------------------------------------


def _fault(what: str, why: str) -> None:
    rank = f"{dist.get_rank()}/{dist.get_world_size()}" if dist.is_initialized() else "?"
    print(f"FAULT DETECTED: {what} {why} (rank {rank})", file=sys.stderr, flush=True)
    os._exit(FAULT_EXIT)


@contextmanager
def collective_watchdog(seconds: float, what: str = "collective"):
    """Bound cross-process collectives with a hard deadline. If the block
    has not completed after `seconds`, or a collective of this module in it
    reports a lost peer (`PeerLostError`), the process prints a FAULT
    DETECTED line naming `what` on stderr and exits with code 86 (distinct
    from a crash's, so an orchestrator can tell "peer lost" from "I
    crashed")."""
    done = threading.Event()

    def watch():
        if not done.wait(seconds):
            _fault(what, f"did not complete within {seconds:.0f}s: a peer process is unreachable or dead")

    threading.Thread(target=watch, daemon=True).start()
    try:
        yield
    except PeerLostError as e:
        _fault(what, f"failed: {e}")
    finally:
        done.set()
