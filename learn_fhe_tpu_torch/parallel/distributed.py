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
  `all_gather`, `all_to_all`).
The caller names it, or `init_distributed` picks it by that rule and prints
its choice.

Each collective here counts its calls and the bytes this rank sends to
other ranks, by name (`CALLS`, `BYTES`; `counts()` reads both), as the
kernel wrappers count their launches: the sharded paths' tests and dry run
read how many collectives an operation issued.

A collective that loses its peer either fails (gloo: "Connection closed by
peer") or blocks. `collective_watchdog` turns both into one diagnosable end:
a `FAULT DETECTED` line on stderr and exit code 86.
"""

from __future__ import annotations

import os
import sys
import threading
from collections import Counter
from contextlib import contextmanager

import numpy as np
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


CALLS: Counter = Counter()  # collective name -> calls on this rank
BYTES: Counter = Counter()  # collective name -> bytes this rank sent to other ranks


def _counted(name: str, n_bytes: int) -> None:
    CALLS[name] += 1
    BYTES[name] += n_bytes


def counts() -> tuple[dict[str, int], dict[str, int]]:
    """(calls, bytes sent) of each collective on this rank so far."""
    return dict(CALLS), dict(BYTES)


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


def exchange(x, peer: int, group=None):
    """Send x to rank `peer` of `group` and receive its block of x's shape
    and dtype: one `batch_isend_irecv`. x may be a list of tensors, all
    sent, and the peer's of the same shapes received, in that one call
    (counted as one, with all their bytes); a list is returned for a list
    (`all_to_all`'s list form)."""
    many = isinstance(x, (list, tuple))
    xs = list(x) if many else [x]
    staged = _staged(xs[0], group)
    sends = [_to_host(t) if staged else t.contiguous() for t in xs]
    recvs = [torch.empty_like(t) for t in sends]
    peer_global = dist.get_global_rank(group, peer) if group is not None else peer
    ops = [
        op
        for k, (send, recv) in enumerate(zip(sends, recvs))
        for op in (dist.P2POp(dist.isend, send, peer_global, group, tag=k), dist.P2POp(dist.irecv, recv, peer_global, group, tag=k))
    ]

    def run():
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    _run(f"exchange with rank {peer}", run)
    _counted("exchange", sum(t.numel() * t.element_size() for t in sends))
    out = [r.to(t.device, non_blocking=True) if staged else r for r, t in zip(recvs, xs)]
    return out if many else out[0]


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of x over the ranks of `group` (int64 wraps mod 2^64 on
    gloo and nccl alike), on every rank; x is left as it was."""
    staged = _staged(x, group)
    buf = _to_host(x) if staged else x.clone()
    _run("all_reduce", lambda: dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group))
    _counted("all_reduce", buf.numel() * buf.element_size())
    return buf.to(x.device, non_blocking=True) if staged else buf


def all_gather(x: torch.Tensor, group=None, axis: int = 0) -> torch.Tensor:
    """Every rank's x of `group`, in rank order, concatenated along `axis`."""
    staged = _staged(x, group)
    src = _to_host(x) if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    _run("all_gather", lambda: dist.all_gather(parts, src, group=group))
    _counted("all_gather", src.numel() * src.element_size() * (len(parts) - 1))
    out = torch.cat(parts, dim=axis)
    return out.to(x.device, non_blocking=True) if staged else out


def _sizes(length: int, sizes, world: int, what: str) -> list[int]:
    if sizes is None:
        if length % world:
            raise ValueError(f"all_to_all: {what} of {length} does not split evenly over {world} ranks")
        return [length // world] * world
    sizes = [int(v) for v in sizes]
    if len(sizes) != world or (what == "split axis" and sum(sizes) != length):
        raise ValueError(f"all_to_all: {what} sizes {sizes} for {world} ranks and a length of {length}")
    return sizes


def all_to_all(x, group=None, split_axis: int = -1, cat_axis: int = -2, split_sizes=None, cat_sizes=None):
    """One all-to-all over `group`. x is cut along `split_axis` into one
    piece a rank (`split_sizes`, default equal), piece j goes to rank j,
    and the pieces received are concatenated in rank order along
    `cat_axis` (`cat_sizes`: each sender's length there; default x's own).
    x may be a list of tensors of one dtype and device, all sent in the one
    exchange (`split_sizes` / `cat_sizes` then a list with an entry, or
    None, per tensor); a list is returned for a list. Every rank's pieces
    of all the tensors go as one flat buffer (`all_to_all_single` with
    explicit sizes, so uneven limb splits need no padding)."""
    many = isinstance(x, (list, tuple))
    xs = list(x) if many else [x]
    n = len(xs)
    splits = list(split_sizes) if many and split_sizes is not None else [split_sizes] * n
    cats = list(cat_sizes) if many and cat_sizes is not None else [cat_sizes] * n
    world, me = dist.get_world_size(group), dist.get_rank(group)
    sa = [split_axis % t.dim() for t in xs]
    ca = [cat_axis % t.dim() for t in xs]
    splits = [_sizes(t.shape[a], s, world, "split axis") for t, a, s in zip(xs, sa, splits)]
    cats = [[t.shape[a]] * world if c is None else _sizes(t.shape[a], c, world, "cat axis") for t, a, c in zip(xs, ca, cats)]
    offs = [np.concatenate([[0], np.cumsum(s)]).tolist() for s in splits]
    pieces = [[t.narrow(a, offs[k][j], splits[k][j]).reshape(-1) for k, (t, a) in enumerate(zip(xs, sa))] for j in range(world)]
    send_sizes = [sum(p.numel() for p in ps) for ps in pieces]
    send = torch.cat([p for ps in pieces for p in ps])

    def shape(k: int, i: int) -> list[int]:  # the piece of tensor k from rank i
        s = list(xs[k].shape)
        s[sa[k]], s[ca[k]] = splits[k][me], cats[k][i]
        return s

    recv_shapes = [[shape(k, i) for k in range(n)] for i in range(world)]
    recv_sizes = [sum(int(np.prod(s)) for s in ss) for ss in recv_shapes]
    staged = _staged(send, group)
    src = _to_host(send) if staged else send
    buf = torch.empty(sum(recv_sizes), dtype=src.dtype, device=src.device, pin_memory=staged)
    _run("all_to_all", lambda: dist.all_to_all_single(buf, src, recv_sizes, send_sizes, group=group))
    _counted("all_to_all", (send.numel() - send_sizes[me]) * send.element_size())
    if staged:
        buf = buf.to(send.device, non_blocking=True)
    flat = iter(buf.split([int(np.prod(s)) for ss in recv_shapes for s in ss]))
    parts = [[next(flat).view(s) for s in ss] for ss in recv_shapes]
    out = [torch.cat([parts[i][k] for i in range(world)], dim=ca[k]) for k in range(n)]
    return out if many else out[0]


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
