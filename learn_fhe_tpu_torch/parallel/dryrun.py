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
- `merge`: `merge_shares` of D parties' shares, one a rank;
- `ckks_limb`: the CKKS `mul` with its limbs over 'limb' and its batch over
  'batch' of a (D / n_limb, n_limb) mesh (`parallel/limb.py`,
  `limb_sharded_mul`) at `chip_smoke.py` C3's size, N = 2^13, 8 + 8 primes
  of 55 bits, batch 16;
- `bgv_limb`: the BGV `mul` likewise (`limb_sharded_bgv_mul`) at G2's
  `BgvParams(log_n=14, t=65537, log_qi=45, big_l=4)`, batch 16;
- `ks2d`: a rotation by 1 with the limbs over 'limb' and the coefficients
  over 'batch' (`sharded_rotate_2d`) at C3's ring, batch 16;
- `dnum`: the `mul` of one ciphertext by itself at `production_config(16)`
  (N = 2^16, 15 key-switch digits) with the digits over 'limb'
  (`digit_sharded_mul`).
`--limb-ranks` is n_limb (default 2 where D is even, else 1, as the JAX dry
run's mesh). Every rank makes the keys, messages and operands from the same
seeds. Every sharded result is gathered; rank 0 holds it against the
unsharded result of the same device, bit for bit, and checks the
decryptions (the product of the messages, the rotated message, the product
mod t). Any failure on any rank makes the command exit non-zero. With `--out
FILE` rank 0 writes the inputs' seeds' results (gathered) to FILE (numpy
.npz), which the CPU tests hold against the JAX package, with each rank's
collectives (calls and bytes sent, by kind), kernel launches and seconds of
the four sharded operations (`op_<phase>_*`), and rank 0's exchange calls
in each coefficient-sharded ntt, intt and mul (`coef<i>_exchanges`,
`coef32_<i>_exchanges`). `small` runs the JAX tests' shapes: N = 32, `CkksParams(log_n=5, log_qi=45, big_l=8)`,
`BgvParams(log_n=5, big_l=4)`, `ProductionConfig(log_n=5, user_levels=2,
chunk_r=5)`.

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

PHASES = ("coef", "coef32", "pbs", "gate", "merge", "ckks_limb", "bgv_limb", "ks2d", "dnum")
LIMB_PHASES = PHASES[5:]
COLLECTIVES = ("all_to_all", "all_gather", "exchange", "all_reduce")


def counted_kernels():
    """The launch counters of the kernels the phases run, by name."""
    from ..models.fhew import bootstrapping as fhew_boot
    from ..models.tfhe import tggsw
    from ..ops import ntt32, rns
    from . import coef, coef32

    fns = (
        coef.coef_cross, coef32.coef32_cross, coef.coef_ntt_tail, coef32.coef32_ntt_tail, ntt32.ntt32, ntt32.intt32, ntt32.negacyclic_mul32, rns.rns_ntt, rns.rns_intt,
        rns.rns_intt_mac, tggsw.blind_rotate_steps, fhew_boot.blind_rotate_core_fused, rns.base_convert, rns.rescale_finish,
        rns.automorphism_rns, rns.drop_limbs_t,
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
    ckks: dict  # CkksParams of ckks_limb and ks2d
    ckks_batch: int  # ciphertexts a batch (0: one, unbatched)
    bgv: dict  # BgvParams of bgv_limb
    bgv_batch: int
    dnum: dict  # ProductionConfig of dnum


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
        ckks=dict(log_n=13, log_qi=55, big_l=8),  # `bench.py:657-700`, chip_smoke.py C3
        ckks_batch=16,
        bgv=dict(log_n=14, t=65537, log_qi=45, big_l=4),  # chip_smoke.py G2
        bgv_batch=16,
        dnum=dict(log_n=16),  # production_config(16)
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
        # `__graft_entry__.py:134-165,272-298,315-335,337-358`: the JAX dry run's
        ckks=dict(log_n=5, log_qi=45, big_l=8),
        ckks_batch=0,
        bgv=dict(log_n=5, t=65537, log_qi=45, big_l=4),
        bgv_batch=0,
        dnum=dict(log_n=5, user_levels=2, chunk_r=5),
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


SEEDS = dict(ckks_limb=30, bgv_limb=31, ks2d=32, dnum=33)


def _ckks_messages(params, rng, batch: int, amp: float):
    """One ciphertext's messages: (l,) complex, or (batch, l)."""
    draw = lambda: (rng.standard_normal(params.l) + 1j * rng.standard_normal(params.l)) * amp  # noqa: E731
    return draw() if not batch else np.stack([draw() for _ in range(batch)])


def ckks_inputs(params, batch: int, seed: int, dev, n_cts: int, key: str, amp: float = 0.5):
    """(sk, key, messages, ciphertexts) from one seed, drawn as the JAX
    dry run draws them: sk, the key (`key`: "rlk", or "rtk" by 1), then
    for each ciphertext its messages and its encryptions (a batch: row by
    row, each row's messages then its encryption)."""
    from ..models.ckks import ckks as C

    rng = np.random.default_rng(seed)
    sk = C.sk_gen(params, rng)
    k = C.rlk_gen(params, sk, rng, dev) if key == "rlk" else C.rtk_gen(params, sk, 1, rng, dev)
    ms, cts = [], []
    for _ in range(n_cts):
        rows = []
        for i in range(max(batch, 1)):
            m = _ckks_messages(params, rng, 0, amp)
            rows.append((m, C.sk_encrypt(params, sk, C.encode(params, m, device=dev), params.qs, rng)))
        ms.append(rows[0][0] if not batch else np.stack([m for m, _ in rows]))
        pick = lambda f: getattr(rows[0][1], f) if not batch else torch.stack([getattr(c, f) for _, c in rows])  # noqa: E731
        cts.append(C.CkksCiphertext(pick("b"), pick("a"), params.qs))
    return sk, k, ms, cts


def bgv_inputs(params, batch: int, seed: int, dev):
    """(sk, rlk, messages, ciphertexts) of two ciphertexts from one seed:
    sk, rlk, then each ciphertext's slots (a batch: row by row) and
    encryption."""
    from ..models.bgv import bgv as G

    rng = np.random.default_rng(seed)
    sk = G.sk_gen(params, rng)
    rlk = G.rlk_gen(params, sk, rng, dev)
    ms, cts = [], []
    for _ in range(2):
        rows = []
        for _ in range(max(batch, 1)):
            m = rng.integers(0, params.t, size=params.n, dtype=np.int64)
            rows.append((m, G.sk_encrypt(params, sk, G.encode(params, m, dev), params.qs, rng)))
        ms.append(rows[0][0] if not batch else np.stack([m for m, _ in rows]))
        pick = lambda f: getattr(rows[0][1], f) if not batch else torch.stack([getattr(c, f) for _, c in rows])  # noqa: E731
        cts.append(G.BgvCiphertext(pick("b"), pick("a"), params.qs))
    return sk, rlk, ms, cts


def dnum_config(size: Size):
    from ..models.ckks.production import ProductionConfig, production_config

    return production_config(**size.dnum) if size.dnum.get("log_n", 16) >= 16 else ProductionConfig(**size.dnum)


class _Rank:
    """One rank's run: its meshes, results and the checks rank 0 makes."""

    def __init__(self, rank: int, world: int, device: str, size: Size, limb_ranks: int):
        self.rank, self.world, self.size = rank, world, size
        self.dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else torch.device("cpu")
        self.device_type = device
        self.limb_ranks = limb_ranks
        self.results: dict[str, np.ndarray] = {}
        self.seconds: dict[str, float] = {}
        self.ops: dict[str, tuple] = {}  # phase -> (calls, bytes by COLLECTIVES; launches by kernel; seconds)
        self._mesh = None

    def limb_mesh(self):
        """The (D / n_limb, n_limb) ('batch', 'limb') mesh, made once."""
        from .mesh import make_mesh

        if self._mesh is None:
            self._mesh = make_mesh(self.world // self.limb_ranks, self.limb_ranks, self.device_type)
        return self._mesh

    def measured(self, phase: str, op):
        """op() twice, the second with this rank's collectives, kernel
        launches and seconds in it (the first makes the plans and tables)."""
        from . import distributed

        op()
        counted = counted_kernels()
        c0, b0 = distributed.counts()
        l0 = {k: f.launches for k, f in counted.items()}
        if self.device_type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = op()
        if self.device_type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c1, b1 = distributed.counts()
        calls = [c1.get(k, 0) - c0.get(k, 0) for k in COLLECTIVES]
        sent = [b1.get(k, 0) - b0.get(k, 0) for k in COLLECTIVES]
        self.ops[phase] = (calls, sent, [f.launches - l0[k] for k, f in counted.items()], secs)
        return out

    def check(self, what: str, got: torch.Tensor, want: torch.Tensor) -> None:
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"dryrun: {what} (D={self.world}) differs from the unsharded result")

    def _exchanged(self, key: str, ops: dict) -> dict:
        """Each op() of `ops` with this rank's exchange calls in it, which
        rank 0 keeps as `key` (in the order of `ops`)."""
        from . import distributed

        out, calls = {}, []
        for name, op in ops.items():
            before = distributed.CALLS["exchange"]
            out[name] = op()
            calls.append(distributed.CALLS["exchange"] - before)
        if self.rank == 0:
            self.results[key] = np.array(calls)
        return out

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
            got = self._exchanged(f"coef{i}_exchanges", {
                "ntt": lambda: coef_sharded_ntt(mesh, sa, qs),
                "intt": lambda: coef_sharded_intt(mesh, sa, qs),
                "mul": lambda: coef_sharded_mul(mesh, sa, sb, qs),
            })  # fmt: skip
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
            got = self._exchanged(f"coef32_{i}_exchanges", {
                "ntt": lambda: coef32_sharded_ntt(mesh, sa, q),
                "intt": lambda: coef32_sharded_intt(mesh, sa, q),
                "mul": lambda: coef32_sharded_mul(mesh, sa, sb, q),
            })  # fmt: skip
            got = {k: gather(mesh, v, "coef", -1) for k, v in got.items()}
            if self.rank == 0:
                plan = ntt32_plan(q, a.shape[-1])
                want = {"ntt": ntt32(a, plan), "intt": intt32(a, plan), "mul": negacyclic_mul32(a, b, plan)}
                for k in got:
                    self.check(f"coef32_sharded_{k} at {tuple(a.shape)}", got[k], want[k])
                    self.results[f"coef32_{i}_{k}"] = torch_to_u32(got[k].cpu())

    def pbs(self) -> None:
        from ..models import tfhe
        from ..models.tfhe import tlwe
        from ..utils.interop import u64_to_torch
        from .batch import PBS_CHUNK, _tfhe_pbs_chunk
        from .mesh import gather, make_mesh, replicate, shard_batch

        params = tfhe_params(self.size.tfhe)
        rng = np.random.default_rng(0)
        z = tlwe.sk_gen(params.tlwe, rng)
        key = tfhe.key_gen(params, z, rng, self.dev)
        mesh = make_mesh(n_batch=self.world, n_limb=1, device_type=self.device_type)
        lut = replicate(mesh, u64_to_torch(tfhe.lut_table(params.tlwe.log_p, params.big_n, lambda v: v), self.dev))

        def run(ms: np.ndarray, seed: int):
            cts = tlwe.sk_encrypt(params.tlwe, z, tlwe.encode(params.tlwe, torch.from_numpy(ms).to(self.dev)), np.random.default_rng(seed))
            chunks = [tlwe.TlweCiphertext(cts.a[s : s + PBS_CHUNK], cts.b[s : s + PBS_CHUNK]) for s in range(0, len(ms), PBS_CHUNK)]
            parts = [
                _tfhe_pbs_chunk(params, key, lut, tlwe.TlweCiphertext(shard_batch(mesh, c.a), shard_batch(mesh, c.b)))
                for c in chunks
            ]
            out = tlwe.TlweCiphertext(*(gather(mesh, torch.cat([getattr(p, f) for p in parts]), "batch", 0) for f in ("a", "b")))
            if self.rank == 0:
                # the gathered chunks interleave the ranks' slices of each chunk
                order = np.concatenate([np.arange(s, min(s + PBS_CHUNK, len(ms))).reshape(self.world, -1) for s in range(0, len(ms), PBS_CHUNK)], axis=1).reshape(-1)
                a_full, b_full = torch.empty_like(out.a), torch.empty_like(out.b)
                a_full[torch.from_numpy(order)], b_full[torch.from_numpy(order)] = out.a, out.b
                out = tlwe.TlweCiphertext(a_full, b_full)
                want = [_tfhe_pbs_chunk(params, key, lut, c) for c in chunks]
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


    def _limb_shard(self, mesh, x: torch.Tensor, batched: bool) -> torch.Tensor:
        from .mesh import shard_batch, shard_limbs

        return shard_limbs(mesh, shard_batch(mesh, x) if batched else x)

    def _limb_gather(self, mesh, x: torch.Tensor, n_limbs: int, batched: bool) -> torch.Tensor:
        from .mesh import gather, gather_limbs

        x = gather_limbs(mesh, x, n_limbs)
        return gather(mesh, x, "batch", 0) if batched else x

    def _ckks_check(self, what: str, params, sk, out, want, ms) -> None:
        """out == want bit for bit (rank 0), and out decrypts to ms within 1e-5."""
        from ..models.ckks import ckks as C
        from ..utils.interop import torch_to_u64

        self.check(f"{what} (b)", out.b, want.b)
        self.check(f"{what} (a)", out.a, want.a)
        pt = C.decrypt(params, sk, out)
        rows = pt.reshape(-1, *pt.shape[-2:])
        got = np.stack([C.decode(params, r, out.qs) for r in rows]).reshape(np.shape(ms))
        err = float(np.max(np.abs(got - ms)))
        if not err < 1e-5:
            raise AssertionError(f"dryrun: {what} (D={self.world}) decrypts {err:.3g} away from the messages")
        self.results[f"{what}_b"], self.results[f"{what}_a"] = torch_to_u64(out.b.cpu()), torch_to_u64(out.a.cpu())
        self.results[f"{what}_err"] = np.array(err)

    def ckks_limb(self) -> None:
        from ..models.ckks import ckks as C
        from .limb import limb_ksk, limb_sharded_mul

        params = C.CkksParams(**self.size.ckks)
        B = self.size.ckks_batch
        sk, rlk, (m0, m1), (ct0, ct1) = ckks_inputs(params, B, SEEDS["ckks_limb"], self.dev, 2, "rlk")
        mesh = self.limb_mesh()
        s0, s1 = (C.CkksCiphertext(self._limb_shard(mesh, c.b, B > 0), self._limb_shard(mesh, c.a, B > 0), c.qs) for c in (ct0, ct1))
        key = limb_ksk(mesh, params, rlk, params.qs)
        out = self.measured("ckks_limb", lambda: limb_sharded_mul(mesh, params, key, s0, s1))
        got = C.CkksCiphertext(*(self._limb_gather(mesh, x, len(out.qs), B > 0) for x in (out.b, out.a)), out.qs)
        if self.rank == 0:
            self._ckks_check("ckks_limb", params, sk, got, C.mul(params, rlk, ct0, ct1), m0 * m1)

    def ks2d(self) -> None:
        from ..models.ckks import ckks as C
        from .limb import limb_ksk, sharded_rotate_2d
        from .mesh import coord, gather, gather_limbs, shard_limbs

        params = C.CkksParams(**self.size.ckks)
        sk, rtk, (m,), (ct,) = ckks_inputs(params, self.size.ckks_batch, SEEDS["ks2d"], self.dev, 1, "rtk")
        mesh = self.limb_mesh()
        rb, nb = coord(mesh, "batch")
        blk = ct.b.shape[-1] // nb
        cut = lambda x: shard_limbs(mesh, x)[..., rb * blk : (rb + 1) * blk].contiguous()  # noqa: E731
        sct = C.CkksCiphertext(cut(ct.b), cut(ct.a), ct.qs)
        key = limb_ksk(mesh, params, rtk.ksk, params.qs, coef=True)
        out = self.measured("ks2d", lambda: sharded_rotate_2d(mesh, params, key, rtk.j, sct))
        got = C.CkksCiphertext(*(gather(mesh, gather_limbs(mesh, x, len(out.qs)), "batch", -1) for x in (out.b, out.a)), out.qs)
        if self.rank == 0:
            self._ckks_check("ks2d", params, sk, got, C.rotate(params, rtk, ct), np.roll(m, -1, axis=-1))

    def dnum(self) -> None:
        from ..models.ckks import ckks as C
        from .limb import digit_ksk, digit_sharded_mul

        params = dnum_config(self.size).params
        sk, rlk, (m,), (ct,) = ckks_inputs(params, 0, SEEDS["dnum"], self.dev, 1, "rlk", amp=0.3)
        mesh = self.limb_mesh()
        key = digit_ksk(mesh, params, rlk, params.qs)
        out = self.measured("dnum", lambda: digit_sharded_mul(mesh, params, key, ct, ct))
        if self.rank == 0:
            self._ckks_check("dnum", params, sk, out, C.mul(params, rlk, ct, ct), m * m)

    def bgv_limb(self) -> None:
        from ..models.bgv import bgv as G
        from ..utils.interop import torch_to_u64
        from .limb import limb_ksk, limb_sharded_bgv_mul

        params = G.BgvParams(**self.size.bgv)
        B = self.size.bgv_batch
        sk, rlk, (m0, m1), (ct0, ct1) = bgv_inputs(params, B, SEEDS["bgv_limb"], self.dev)
        mesh = self.limb_mesh()
        s0, s1 = (G.BgvCiphertext(self._limb_shard(mesh, c.b, B > 0), self._limb_shard(mesh, c.a, B > 0), c.qs) for c in (ct0, ct1))
        key = limb_ksk(mesh, params, rlk, params.qs)
        out = self.measured("bgv_limb", lambda: limb_sharded_bgv_mul(mesh, params, key, s0, s1))
        got = G.BgvCiphertext(*(self._limb_gather(mesh, x, len(out.qs), B > 0) for x in (out.b, out.a)), out.qs, out.factor)
        if self.rank == 0:
            want = G.mul(params, rlk, ct0, ct1)
            self.check("bgv_limb (b)", got.b, want.b)
            self.check("bgv_limb (a)", got.a, want.a)
            if got.factor != want.factor:
                raise AssertionError(f"dryrun: bgv_limb's factor {got.factor} is not the unsharded {want.factor}")
            if not np.array_equal(G.decrypt(params, sk, got), (m0 * m1) % params.t):
                raise AssertionError(f"dryrun: the limb-sharded BGV mul (D={self.world}) decrypts wrong")
            self.results["bgv_limb_b"], self.results["bgv_limb_a"] = torch_to_u64(got.b.cpu()), torch_to_u64(got.a.cpu())


def rank_main(
    rank: int, world: int, init_method: str, device: str, size: str, phases: tuple, out: str | None, backend: str | None,
    stream: int | None = None, limb_ranks: int | None = None,
) -> None:  # fmt: skip
    """One rank: join the group, run the phases under the watchdog, and (rank
    0) write the results, with every rank's kernel launches summed
    (`launches_<kernel>`; the counters start at 0 in a new process) and,
    for each of the sharded key-switch operations that ran, every rank's
    collectives, launches and seconds in it (`op_<phase>_calls` /
    `_bytes`: (ranks, COLLECTIVES); `op_<phase>_launches`: (ranks,
    kernels), `op_<phase>_seconds`: (ranks,)). `stream` replaces the size's
    chunked PBS count."""
    from dataclasses import replace

    from .distributed import all_gather, all_reduce_sum, collective_watchdog, init_distributed

    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    init_distributed(init_method, world, rank, backend)
    sz = SIZES[size] if stream is None else replace(SIZES[size], pbs_stream=stream)
    r = _Rank(rank, world, device, sz, default_limb_ranks(world) if limb_ranks is None else limb_ranks)
    counted = counted_kernels()
    with collective_watchdog(900, f"dryrun rank {rank}"):
        for phase in phases:
            t0 = time.perf_counter()
            getattr(r, phase)()
            if device == "cuda":
                torch.cuda.synchronize()
            r.seconds[phase] = time.perf_counter() - t0
        total = all_reduce_sum(torch.tensor([f.launches for f in counted.values()], dtype=torch.int64, device=r.dev))
        ops = {}
        for phase in (p for p in phases if p in r.ops):
            calls, sent, launched, secs = r.ops[phase]
            row = torch.tensor([*calls, *sent, *launched, round(secs * 1e6)], dtype=torch.int64, device=r.dev)
            ops[phase] = all_gather(row[None], None, 0).cpu().numpy()
    for name, v in zip(counted, total.tolist()):
        r.results[f"launches_{name}"] = np.array(v)
    k = len(COLLECTIVES)
    for phase, m in ops.items():
        r.results[f"op_{phase}_calls"], r.results[f"op_{phase}_bytes"] = m[:, :k], m[:, k : 2 * k]
        r.results[f"op_{phase}_launches"], r.results[f"op_{phase}_seconds"] = m[:, 2 * k : -1], m[:, -1] / 1e6
    if rank == 0:
        if out:
            np.savez(out, **r.results)
        print(f"dryrun: rank 0 of {world} (n_limb {r.limb_ranks}): " + ", ".join(f"{k} {v:.2f} s" for k, v in r.seconds.items()), flush=True)
        print("dryrun: launches on all ranks: " + ", ".join(f"{k} {int(v)}" for k, v in zip(counted, total.tolist())), flush=True)
        for phase, m in ops.items():
            calls = ", ".join(f"{c} {int(m[0, i])} ({int(m[0, k + i])} bytes)" for i, c in enumerate(COLLECTIVES) if m[:, i].any())
            print(f"dryrun: {phase} on rank 0: {calls}; {m[0, -1] / 1e6:.4f} s", flush=True)
    dist.destroy_process_group()


def default_limb_ranks(world: int) -> int:
    """n_limb of the limb phases' mesh: 2 where the world is even, else 1
    (`__graft_entry__.py:111`)."""
    return 2 if world % 2 == 0 else 1


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
    limb_ranks: int | None = None,
) -> float:  # fmt: skip
    """Start `ranks` rank processes (`python -m` this module, one a rank)
    and wait for them; raise if one fails or they outlast `timeout`. The
    ranks meet at a FileStore under `store` (default: a new temporary
    directory). Returns the wall seconds. `fault`: run `fault_main`;
    `limb_ranks`: n_limb of the limb phases' mesh (default
    `default_limb_ranks`)."""
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
            *(["--fault"] if fault else []), *(["--limb-ranks", str(limb_ranks)] if limb_ranks is not None else []),
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
    ap.add_argument("--limb-ranks", type=int, default=None, help="n_limb of the limb phases' (D / n_limb, n_limb) mesh (default 2 where D is even, else 1)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)  # set by `run` for a rank process
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    size = args.size or ("card" if args.device == "cuda" else "small")
    phases = tuple(p for p in args.phases.split(",") if p)
    if not set(phases) <= set(PHASES):
        raise SystemExit(f"dryrun: phases are {PHASES}")
    if args.limb_ranks is not None and (args.limb_ranks < 1 or args.ranks % args.limb_ranks):
        raise SystemExit(f"dryrun: --limb-ranks {args.limb_ranks} does not divide {args.ranks} ranks")
    if args.rank is not None:
        try:
            if args.fault:
                fault_main(args.rank, args.ranks, args.init)
            else:
                rank_main(args.rank, args.ranks, args.init, args.device, size, phases, args.out, args.backend, args.stream, args.limb_ranks)
        except BaseException:
            import traceback

            traceback.print_exc()
            sys.stdout.flush()
            os._exit(1)
        return
    secs = run(args.ranks, args.device, size, phases, args.out, args.backend, args.stream, args.store, fault=args.fault, limb_ranks=args.limb_ranks)
    print(f"dryrun OK: {args.ranks} ranks ({args.device}, {size}): {', '.join(phases)} equal the unsharded results; {secs:.1f} s wall", flush=True)


if __name__ == "__main__":
    main()
