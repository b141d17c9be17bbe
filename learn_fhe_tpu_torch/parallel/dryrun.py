"""One sharded step of the port's parallel paths on D ranks, each result
gathered and held against the unsharded one (`__graft_entry__.py:65-370`
`dryrun_multichip` and `tests/distributed_worker.py` of the JAX package).

    python -m learn_fhe_tpu_torch.parallel.dryrun --ranks D [--device cpu]

spawns D ranks (torch.distributed; gloo, or nccl with --backend nccl where
each rank has a card of its own). Each rank runs, at the size of `--size`
(`card`: the sizes below; `small`: the CPU tests' rings):
- `coef`: the coefficient-sharded u64 NTT, inverse and polymul
  (`parallel/coef.py`) at the CKKS `mul`'s ring, (16, 8, 8192) under eight
  55-bit primes;
- `coef32`: the u32 ones (`parallel/coef32.py`) at `bench_scaling`'s
  (4, 16384) under a 28-bit prime;
- `pbs`: the TFHE PBS at the reference fixture, batch 128 split over the
  'batch' axis of a ('batch', 'limb') mesh (`tfhe_pbs_batch_device` on each
  rank's slice), then 4096 ciphertexts in chunks of `PBS_CHUNK`, each
  chunk split the same way;
- `gate`: a FHEW NAND batch of 128 at the reference fixture, split over
  'batch' (`fhew_gate_batch`);
- `merge`: `merge_shares` of D parties' shares, one a rank.
Every rank makes the keys, messages and operands from the same seeds. Every
sharded result is gathered; rank 0 holds it against the unsharded result
of the same device, bit for bit, and checks the decryptions. Any failure
on any rank makes the command exit non-zero. With `--out FILE` rank 0
writes the inputs' seeds' results (gathered) to FILE (numpy .npz), which
the CPU tests hold against the JAX package. The limb-sharded CKKS and BGV
`mul`, the 2-D key switch and the dnum digit sharding of the JAX dry run
are not here: they need collectives inside the key switch.

Ranks that share one card run over gloo (nccl refuses two ranks on one
device), so their wall times are not a scaling number.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from itertools import islice

import numpy as np
import torch
import torch.distributed as dist

PHASES = ("coef", "coef32", "pbs", "gate", "merge")


def _counted():
    """The launch counters of the kernels the phases run, by name."""
    from ..models.fhew import bootstrapping as fhew_boot
    from ..models.tfhe import tggsw
    from ..ops import ntt32, rns
    from . import coef, coef32

    fns = (
        coef.coef_cross, coef32.coef32_cross, ntt32.ntt32, ntt32.intt32, ntt32.negacyclic_mul32, rns.rns_ntt, rns.rns_intt,
        rns.rns_intt_mac, tggsw.blind_rotate_steps, fhew_boot.blind_rotate_core_fused,
    )  # fmt: skip
    return {f.__name__: f for f in fns}


@dataclass(frozen=True)
class Size:
    coef: tuple  # (leading shape, log_n, limbs, prime bits) per case
    coef32: tuple  # (leading shape, log_n, prime bits) per case
    tfhe: str  # "reference" or "small"
    pbs_batch: int
    pbs_stream: int  # ciphertexts of the chunked run (0: none)
    fhew: str
    gate_batch: int
    merge_cols: int
    merge_q: int


SIZES = {
    "card": Size(
        coef=(((16,), 13, 8, 55),),
        coef32=(((4,), 14, 28),),
        tfhe="reference",
        pbs_batch=128,
        pbs_stream=4096,
        fhew="reference",
        gate_batch=128,
        merge_cols=4096,
        merge_q=(1 << 55) - 55,
    ),
    # the shapes of tests/test_parallel.py's coefficient-sharded tests
    "small": Size(
        coef=(((), 9, 2, 45), ((), 8, 3, 45)),
        coef32=(((3,), 9, 28), ((2,), 8, 28)),
        tfhe="small",
        pbs_batch=16,
        pbs_stream=0,
        fhew="small",
        gate_batch=16,
        merge_cols=64,
        merge_q=12289,
    ),
}


def coef_inputs(case, seed: int = 0):
    """(qs, a, b) of a u64 case: numpy u64 residues of shape (*lead, L, N)."""
    from ..utils.primes import two_adic_primes

    lead, log_n, limbs, bits = case
    qs = tuple(islice(two_adic_primes(bits, log_n + 1), limbs))
    rng = np.random.default_rng(seed)
    a, b = (np.stack([rng.integers(0, q, size=(*lead, 1 << log_n), dtype=np.uint64) for q in qs], axis=-2) for _ in range(2))
    return qs, a, b


def coef32_inputs(case, seed: int = 0):
    """(q, a, b) of a u32 case: numpy u32 residues of shape (*lead, N)."""
    from ..utils.primes import two_adic_primes

    lead, log_n, bits = case
    q = next(two_adic_primes(bits, log_n + 1))
    rng = np.random.default_rng(seed)
    a, b = (rng.integers(0, q, size=(*lead, 1 << log_n), dtype=np.uint32) for _ in range(2))
    return q, a, b


def tfhe_params(name: str):
    from ..models import tfhe

    if name == "reference":  # `bootstrapping.rs:141-152`
        tl = tfhe.TlweParams(log_p=4, padding=1, n=1024, std_dev=1.339775301998614e-7, log_b=4, d=5)
        tg = tfhe.TglweParams(log_p=4, padding=1, big_n=2048, k=1, std_dev=2.845267479601915e-15)
        return tfhe.BootstrapParams(tl, tfhe.TggswParams(tg, log_b=23, d=1))
    tl = tfhe.TlweParams(log_p=2, padding=1, n=64, std_dev=1.34e-7, log_b=4, d=5)  # tests/test_parallel.py
    tg = tfhe.TglweParams(log_p=2, padding=1, big_n=256, k=1, std_dev=2.85e-15)
    return tfhe.BootstrapParams(tl, tfhe.TggswParams(tg, log_b=23, d=1))


def fhew_params(name: str):
    from ..models import fhew
    from ..utils.primes import two_adic_primes

    if name == "reference":  # `bench.py:289-295`
        q = next(two_adic_primes(28, 10))
        rl, lw, w = fhew.RlweParams(q=q, p=4, log_n=9, log_b=7, d=4), fhew.LweParams(q=1 << 16, p=4, n=100, log_b=4, d=4), 10
    else:  # tests/test_parallel.py
        q = next(two_adic_primes(28, 8))
        rl, lw, w = fhew.RlweParams(q=q, p=4, log_n=7, log_b=7, d=4), fhew.LweParams(q=1 << 16, p=4, n=16, log_b=4, d=4), 5
    return fhew.BootstrapParams(fhew.RgswParams(rl, log_b=7, d=4), lw, w=w)


def pbs_messages(params, batch: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, params.tlwe.p, size=batch)


def gate_messages(batch: int, seed: int = 2) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2, size=batch), rng.integers(0, 2, size=batch)


def merge_inputs(size: Size, parties: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, size.merge_q, size=(parties, size.merge_cols), dtype=np.uint64)


class _Rank:
    """One rank's run: its meshes, results and the checks rank 0 makes."""

    def __init__(self, rank: int, world: int, device: str, size: Size):
        self.rank, self.world, self.size = rank, world, size
        self.dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
        self.device_type = device
        self.results: dict[str, np.ndarray] = {}
        self.seconds: dict[str, float] = {}

    def check(self, what: str, got: torch.Tensor, want: torch.Tensor) -> None:
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"dryrun: {what} (D={self.world}) differs from the unsharded result")

    def coef(self) -> None:
        from ..ops.rns import rns_intt, rns_mul, rns_ntt, rns_plan
        from ..utils.interop import torch_to_u64, u64_to_torch
        from .coef import coef_mesh, coef_sharded_intt, coef_sharded_mul, coef_sharded_ntt, shard_coef
        from .mesh import gather

        mesh = coef_mesh(device_type=self.device_type)
        for i, case in enumerate(self.size.coef):
            qs, a_np, b_np = coef_inputs(case, seed=10 + i)
            a, b = u64_to_torch(a_np, self.dev), u64_to_torch(b_np, self.dev)
            sa, sb = shard_coef(mesh, a), shard_coef(mesh, b)
            got = {
                "ntt": coef_sharded_ntt(mesh, sa, qs),
                "intt": coef_sharded_intt(mesh, sa, qs),
                "mul": coef_sharded_mul(mesh, sa, sb, qs),
            }
            got = {k: gather(mesh, v, "coef", -1) for k, v in got.items()}
            if self.rank == 0:
                plan = rns_plan(qs, a.shape[-1])
                want = {"ntt": rns_ntt(a, plan), "intt": rns_intt(a, plan), "mul": rns_mul(a, b, plan)}
                for k in got:
                    self.check(f"coef_sharded_{k} at {tuple(a.shape)}", got[k], want[k])
                    self.results[f"coef{i}_{k}"] = torch_to_u64(got[k].cpu())

    def coef32(self) -> None:
        from ..ops.ntt32 import intt32, negacyclic_mul32, ntt32, ntt32_plan
        from ..utils.interop import torch_to_u32, u32_to_torch
        from .coef import coef_mesh, shard_coef
        from .coef32 import coef32_sharded_intt, coef32_sharded_mul, coef32_sharded_ntt
        from .mesh import gather

        mesh = coef_mesh(device_type=self.device_type)
        for i, case in enumerate(self.size.coef32):
            q, a_np, b_np = coef32_inputs(case, seed=20 + i)
            a, b = u32_to_torch(a_np, self.dev), u32_to_torch(b_np, self.dev)
            sa, sb = shard_coef(mesh, a), shard_coef(mesh, b)
            got = {
                "ntt": coef32_sharded_ntt(mesh, sa, q),
                "intt": coef32_sharded_intt(mesh, sa, q),
                "mul": coef32_sharded_mul(mesh, sa, sb, q),
            }
            got = {k: gather(mesh, v, "coef", -1) for k, v in got.items()}
            if self.rank == 0:
                plan = ntt32_plan(q, a.shape[-1])
                want = {"ntt": ntt32(a, plan), "intt": intt32(a, plan), "mul": negacyclic_mul32(a, b, plan)}
                for k in got:
                    self.check(f"coef32_sharded_{k} at {tuple(a.shape)}", got[k], want[k])
                    self.results[f"coef32_{i}_{k}"] = torch_to_u32(got[k].cpu())

    def pbs(self) -> None:
        from ..models import tfhe
        from ..models.tfhe import tglwe, tlwe
        from ..utils.interop import u64_to_torch
        from .batch import PBS_CHUNK, tfhe_pbs_batch_device
        from .mesh import gather, make_mesh, replicate, shard_batch

        params = tfhe_params(self.size.tfhe)
        rng = np.random.default_rng(0)
        z = tlwe.sk_gen(params.tlwe, rng)
        key = tfhe.key_gen(params, z, rng, self.dev)
        mesh = make_mesh(n_batch=self.world, n_limb=1, device_type=self.device_type)
        v_enc = replicate(mesh, tglwe.encode(params.tglwe, u64_to_torch(tfhe.lut_table(params.tlwe.log_p, params.big_n, lambda v: v), self.dev)))

        def run(ms: np.ndarray, seed: int):
            cts = tlwe.sk_encrypt(params.tlwe, z, tlwe.encode(params.tlwe, torch.from_numpy(ms).to(self.dev)), np.random.default_rng(seed))
            a2n, b2n = tfhe.mod_switch_2n(cts, params.big_n)
            parts = [
                tfhe_pbs_batch_device(params, key, v_enc, shard_batch(mesh, a2n[s : s + PBS_CHUNK]), shard_batch(mesh, b2n[s : s + PBS_CHUNK]))
                for s in range(0, len(ms), PBS_CHUNK)
            ]
            out = tlwe.TlweCiphertext(*(gather(mesh, torch.cat([getattr(p, f) for p in parts]), "batch", 0) for f in ("a", "b")))
            if self.rank == 0:
                # the gathered chunks interleave the ranks' slices of each chunk
                order = np.concatenate([np.arange(s, min(s + PBS_CHUNK, len(ms))).reshape(self.world, -1) for s in range(0, len(ms), PBS_CHUNK)], axis=1).reshape(-1)
                a_full, b_full = torch.empty_like(out.a), torch.empty_like(out.b)
                a_full[torch.from_numpy(order)], b_full[torch.from_numpy(order)] = out.a, out.b
                out = tlwe.TlweCiphertext(a_full, b_full)
                want = [tfhe_pbs_batch_device(params, key, v_enc, a2n[s : s + PBS_CHUNK], b2n[s : s + PBS_CHUNK]) for s in range(0, len(ms), PBS_CHUNK)]
                self.check(f"PBS of {len(ms)} (a)", out.a, torch.cat([w.a for w in want]))
                self.check(f"PBS of {len(ms)} (b)", out.b, torch.cat([w.b for w in want]))
                got = tlwe.decode(params.tlwe, tlwe.decrypt(params.tlwe, z, out)).cpu().numpy()
                if not np.array_equal(got, ms):
                    raise AssertionError(f"dryrun: the sharded PBS of {len(ms)} decrypts wrong")
                return got
            return None

        got = run(pbs_messages(params, self.size.pbs_batch), seed=4)
        if self.rank == 0:
            self.results["pbs_bits"] = got
        if self.size.pbs_stream:
            t0 = time.perf_counter()
            run(pbs_messages(params, self.size.pbs_stream, seed=5), seed=6)
            self.seconds["pbs_stream"] = time.perf_counter() - t0

    def gate(self) -> None:
        from ..models import fhew
        from ..models.fhew import gates, lwe
        from .batch import fhew_gate_batch
        from .mesh import gather, make_mesh, shard_batch

        params = fhew_params(self.size.fhew)
        rng = np.random.default_rng(0)
        z = fhew.rlwe.sk_gen(params.rlwe, rng)
        key = fhew.key_gen(params, z, rng, self.dev)
        m0, m1 = gate_messages(self.size.gate_batch)
        enc_rng = np.random.default_rng(7)
        c0, c1 = (lwe.sk_encrypt(params.lwe_z, z, gates.encode_bool(params, torch.from_numpy(m).to(self.dev)), enc_rng) for m in (m0, m1))
        mesh = make_mesh(n_batch=self.world, n_limb=1, device_type=self.device_type)
        shard = lambda c: lwe.LweCiphertext(shard_batch(mesh, c.a), shard_batch(mesh, c.b))  # noqa: E731
        out = fhew_gate_batch(params, key, "nand", shard(c0), shard(c1))
        out = lwe.LweCiphertext(gather(mesh, out.a, "batch", 0), gather(mesh, out.b, "batch", 0))
        if self.rank == 0:
            want = fhew_gate_batch(params, key, "nand", c0, c1)
            self.check("FHEW NAND batch (a)", out.a, want.a)
            self.check("FHEW NAND batch (b)", out.b, want.b)
            got = gates.decode_bool(params, lwe.decrypt(params.lwe_z, z, out)).cpu().numpy().astype(np.int64)
            if not np.array_equal(got, 1 - (m0 & m1)):
                raise AssertionError("dryrun: the sharded FHEW NAND batch decrypts wrong")
            self.results["gate_bits"] = got

    def merge(self) -> None:
        from ..utils.interop import torch_to_u64, u64_to_torch
        from .multiparty import merge_shares, party_mesh, shard_parties

        shares = u64_to_torch(merge_inputs(self.size, self.world), self.dev)
        mesh = party_mesh(device_type=self.device_type)
        merged = merge_shares(mesh, shard_parties(mesh, shares), self.size.merge_q)
        want = merge_inputs(self.size, self.world).astype(object).sum(axis=0) % self.size.merge_q
        if not np.array_equal(torch_to_u64(merged.cpu()).astype(object), want):
            raise AssertionError(f"dryrun: merge_shares on rank {self.rank} differs from the sum mod q")
        if self.rank == 0:
            self.results["merge"] = torch_to_u64(merged.cpu())


def rank_main(
    rank: int, world: int, init_method: str, device: str, size: str, phases: tuple, out: str | None, backend: str | None,
    stream: int | None = None,
) -> None:  # fmt: skip
    """One rank: join the group, run the phases under the watchdog, and (rank
    0) write the results, with every rank's kernel launches summed
    (`launches_<kernel>`; the counters start at 0 in a new process).
    `stream` replaces the size's chunked PBS count."""
    from dataclasses import replace

    from .distributed import all_reduce_sum, collective_watchdog, init_distributed

    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init_distributed(init_method, world, rank, backend)
    sz = SIZES[size] if stream is None else replace(SIZES[size], pbs_stream=stream)
    r = _Rank(rank, world, device, sz)
    counted = _counted()
    with collective_watchdog(900, f"dryrun rank {rank}"):
        for phase in phases:
            t0 = time.perf_counter()
            getattr(r, phase)()
            if device == "cuda":
                torch.cuda.synchronize()
            r.seconds[phase] = time.perf_counter() - t0
        total = all_reduce_sum(torch.tensor([f.launches for f in counted.values()], dtype=torch.int64, device=r.dev))
    for name, v in zip(counted, total.tolist()):
        r.results[f"launches_{name}"] = np.array(v)
    if rank == 0:
        if out:
            np.savez(out, **r.results)
        print(f"dryrun: rank 0 of {world}: " + ", ".join(f"{k} {v:.2f} s" for k, v in r.seconds.items()), flush=True)
        print("dryrun: launches on all ranks: " + ", ".join(f"{k} {int(v)}" for k, v in zip(counted, total.tolist())), flush=True)
    dist.destroy_process_group()


def fault_main(rank: int, world: int, init_method: str) -> None:
    """Fault injection: after one all_reduce every rank but 0 dies at once
    (exit 42, no shutdown); rank 0's next all_reduce, under
    `collective_watchdog`, must end the process with the FAULT DETECTED
    line and exit code 86, not hang."""
    from .distributed import all_reduce_sum, collective_watchdog, init_distributed

    torch.set_num_threads(1)
    init_distributed(init_method, world, rank, "gloo")
    x = torch.ones(4, dtype=torch.int64)
    all_reduce_sum(x)
    if rank:
        os._exit(42)
    time.sleep(2)  # the peers are gone
    with collective_watchdog(60, "all_reduce after peer loss"):
        all_reduce_sum(x)
    os._exit(99)  # not reached


_MODULE = "learn_fhe_tpu_torch.parallel.dryrun"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(
    ranks: int, device: str = "cuda", size: str = "card", phases=PHASES, out: str | None = None, backend: str | None = None,
    stream: int | None = None, store: str | None = None, timeout: float = 1200, fault: bool = False,
) -> float:  # fmt: skip
    """Start `ranks` rank processes (`python -m` this module, one a rank)
    and wait for them; raise if one fails or they outlast `timeout`. The
    ranks meet at a FileStore under `store` (default: a new temporary
    directory). Returns the wall seconds. `fault`: run `fault_main`."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device (pass --device cpu to run on the CPU)")
    if backend is None:
        backend = "nccl" if device == "cuda" and torch.cuda.device_count() >= ranks else "gloo"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=store) as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        common = [
            "--ranks", str(ranks), "--device", device, "--size", size, "--phases", ",".join(phases), "--backend", backend,
            "--init", init, *(["--out", out] if out else []), *(["--stream", str(stream)] if stream is not None else []),
            *(["--fault"] if fault else []),
        ]  # fmt: skip
        procs = [subprocess.Popen([sys.executable, "-m", _MODULE, "--rank", str(r), *common], cwd=_ROOT) for r in range(ranks)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise RuntimeError(f"dryrun: ranks exited with {codes}")
    return time.perf_counter() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--size", choices=tuple(SIZES), default=None, help="card (default on cuda) or small (default on cpu)")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None)
    ap.add_argument("--stream", type=int, default=None, help="ciphertexts of the chunked PBS run (default: the size's)")
    ap.add_argument("--store", default=None, help="directory for the ranks' FileStore (default: a temporary one)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", action="store_true", help="fault injection: the peers of rank 0 die after one all_reduce (gloo)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)  # set by `run` for a rank process
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    size = args.size or ("card" if args.device == "cuda" else "small")
    phases = tuple(p for p in args.phases.split(",") if p)
    if not set(phases) <= set(PHASES):
        raise SystemExit(f"dryrun: phases are {PHASES}")
    if args.rank is not None:
        try:
            if args.fault:
                fault_main(args.rank, args.ranks, args.init)
            else:
                rank_main(args.rank, args.ranks, args.init, args.device, size, phases, args.out, args.backend, args.stream)
        except BaseException:
            import traceback

            traceback.print_exc()
            sys.stdout.flush()
            os._exit(1)
        return
    secs = run(args.ranks, args.device, size, phases, args.out, args.backend, args.stream, args.store, fault=args.fault)
    print(f"dryrun OK: {args.ranks} ranks ({args.device}, {size}): {', '.join(phases)} equal the unsharded results; {secs:.1f} s wall", flush=True)


if __name__ == "__main__":
    main()
