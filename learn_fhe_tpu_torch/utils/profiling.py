"""Profiling / tracing observability.

Counterpart of `learn_fhe_tpu/utils/profiling.py` on `torch.profiler`:
`trace(log_dir)` records a region (CPU and, where there is a card, CUDA
activity) and writes its Chrome trace under `log_dir`; `summarize(log_dir)`
reads the newest trace file there, so a trace written by another process
can be summarized too, and sums its device events by name.

Example:
    from learn_fhe_tpu_torch.utils import profiling
    with profiling.trace("/tmp/fhe_trace"):
        out = pipeline(...)
    for line in profiling.summarize("/tmp/fhe_trace")[:15]:
        print(line)
"""

from __future__ import annotations

import collections
import glob
import json
import os
import socket
import time
from contextlib import contextmanager
from dataclasses import dataclass

import torch

# Device events: what the card ran. The host's CUDA API calls
# (cudaLaunchKernel, cudaStreamSynchronize, ...) and the device-side copies
# of annotations are left out, as the JAX package leaves out its _HOST_KINDS.
_DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


@contextmanager
def trace(log_dir: str):
    """Profile the region (`torch.profiler`, CPU activity and CUDA activity
    where a card is present; the card is synchronised before the profiler
    stops) and write its Chrome trace as `log_dir/<host>_<pid>.<ns>.pt.trace.json`."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"))


@dataclass(frozen=True)
class OpStat:
    kind: str  # a kernel's (or copy's) name; on a trace without device events, an operator's
    total_ms: float
    count: int

    def __str__(self):
        return f"{self.total_ms:9.2f} ms  x{self.count:6d}  {self.kind}"


def _top_level(events: list[dict]) -> list[dict]:
    """The events that no other event of the same thread encloses."""
    out, end = [], {}
    for e in sorted(events, key=lambda e: (e["pid"], e["tid"], e["ts"], -e["dur"])):
        key = (e["pid"], e["tid"])
        if e["ts"] >= end.get(key, float("-inf")):
            out.append(e)
            end[key] = e["ts"] + e["dur"]
    return out


def summarize(log_dir: str, min_count: int = 1) -> list[OpStat]:
    """Device time of the newest trace under `log_dir` by event name
    (kernels, memcpy, memset), most expensive first; host runtime events
    are left out. On a trace with no device events (a run on the CPU) it
    sums the top-level CPU operators instead (those no other operator of
    their thread encloses).

    Counts and totals are what the profiler recorded. CUPTI can drop
    records of a short window, so a count below the launches a caller made
    is short, and its total is not scaled up: compare the count with the
    launches and say so (as `chip_smoke.py` does)."""
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if not files:
        raise FileNotFoundError(f"no trace files under {log_dir}")
    with open(max(files, key=lambda p: (os.path.getmtime(p), p))) as f:
        data = json.load(f)
    spans = [e for e in data.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    picked = [e for e in spans if e.get("cat") in _DEVICE_CATEGORIES]
    if not picked:
        picked = _top_level([e for e in spans if e.get("cat") == "cpu_op"])
    tot: collections.Counter = collections.Counter()
    cnt: collections.Counter = collections.Counter()
    for e in picked:
        tot[e["name"]] += e["dur"]
        cnt[e["name"]] += 1
    return [OpStat(k, us / 1e3, cnt[k]) for k, us in tot.most_common() if cnt[k] >= min_count]
