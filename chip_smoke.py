#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU, and check it.

The path is the TFHE programmable bootstrap at the reference fixture (TLWE
n=1024, B=2^4, d=5; TGGSW N=2048, k=1, B=2^23, d=1) at batch 128, through
`learn_fhe_tpu_torch`:

  1. require a CUDA device; print its name and power limit;
  2. build the hand-written kernels from `learn_fhe_tpu_torch/csrc/` (nvcc, sm_90a)
     and print the registers and spills of their N=2048 instances (ptxas);
  3. hold the NTT, inverse NTT, polymul and Garner kernels against their
     plain PyTorch versions (on a CPU copy of the same inputs) at the shapes
     key generation gives them, and the first three on a ragged last block
     too, with `torch.equal`;
  4. the main path: key generation from seed 0, 128 encryptions,
     `tfhe_pbs_batch` with the identity LUT (its 1024 steps launched from
     one C call, `tggsw.blind_rotate_steps`), decryption of all 128; the
     kernels' launch counters are set to 0 just before this run and read
     just after it;
  5. hold the step kernel against its plain version at batch 128 with the
     real key (one step, and 4 steps through the C loop), and the first 4
     bootstraps against the whole plain path on the CPU (bit-identical
     ciphertexts);
  6. time the PBS, the host enqueue of a batch, the blind rotation, the key
     switch, the device's idle share (profiler), and each kernel against its
     plain version and its bound with CUDA events: K-STEP over the C loop,
     the key generation kernels over 50 eager wrapper calls, as key
     generation calls them (`ms`), and over the same 50 launches replayed
     from a CUDA graph, which leaves the wrapper's host time out
     (`graph_ms`).

Then the FHEW gate bootstrap at the reference fixture (q = 268409857, N=512,
B=2^7, d=4; LWE n=100, q_ks=2^16, B=2^4, d=4; window 10), batch 128:

  F1. hold K-NTT and intt32 against their plain versions at the FHEW
      primes: q=268409857 at N=512 on key generation's (800, 512) rows and a
      ragged (19, 512), and the test prime 268432897 at N=128;
  F2. the FHEW main path: key generation from seed 0 on the card, 128 NAND
      gates through `fhew_gate_batch` on random bits (the launch counters
      set to 0 just before and read just after: K-FHEW-BR must launch once),
      all 128 decrypted against the truth table; then one `gate_batch` of
      all 7 gates (majority with 3 inputs), decrypted;
  F3. K-FHEW-BR's whole walk at batch 128 with the real key against
      `blind_rotate_core_fused_ref` on the card, on the real schedule and on
      two made from it (each row's external products alone, its
      automorphisms alone), the first 4 gate outputs against the whole plain
      path on the CPU, and the C schedule against the Python one on the same
      mask, all bit for bit; the kernel's error word must read 0;
  F4. NAND gates/s at batch 128 and 1024 over whole `fhew_gate_batch`
      calls (median and spread of 5), the preamble, host schedule and walk
      times, the device's idle share; K-FHEW-BR's device time (profiler)
      beside its wrapper call's, on the ext-only and auto-only schedules and
      at batch 1, 132, 264 and 1024; the bytes of key rows a launch copies;
      K-FHEW-BR against its plain version and its bound, with its registers
      and spills.

Then multi-key FHEW with encrypted u8 on the u64 engine, the port of
`examples/multi_key_uint8.py --full` (q = next(two_adic_primes(55, 12)),
N=2048, B=2^11, d=5; LWE n=600, q_ks=2^20, B=2^5, d=4; window 10; 2
parties):

  M1. hold K-NTT64, intt64 and K-POLYMUL64 against their plain versions at
      the 55-bit prime on (10, 2048) (one RGSW's rows), a ragged (19, 256)
      and key generation's (6000, 2048); time them at (10, 2048) and
      (6000, 2048) against their bounds;
  M2. hold K-EXTPROD64 against its plain version at one merge chunk (60
      keys, 600 products) and as a key switch; time it at the chunk;
  M3. hold K-FHEW-BR64 against its plain version at the 54-bit multi-key
      test fixture (N=128, 2d=18; batch 5 and 128) and at batch 2 of the
      full set (random key rows); the error word must read 0;
  M4. the main path, with the launch counters set to 0 just before and
      read just after: crs and pk shares, each party's key share, the merge
      (each timed), two u8 pk-encrypted (a=177, b=7), ((a+b)*(a-b)/a)%b in
      wrapping u8, gate round by gate round, and its threshold decryption,
      which must give the expected value (wall time and rounds printed);
      then a NAND batch of 128 at the full set: gates/s (median and spread
      of 5 calls), K-FHEW-BR64's device time against its bound, and the
      device's idle share.

Every number is printed beside the card's name and power limit. Each
kernel's bound is the larger of its bytes over the card's memory rate and
its integer instructions over the SMs' issue rates (the cost model below).
The line before the last is {"kernels": [...]}; the last line is the
contract line {"ok": true, "device": {...}}. Any failure exits non-zero
without it, and so does a machine without a CUDA device.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

REFERENCE = dict(
    log_p=4, n=1024, big_n=2048, tlwe_std=1.339775301998614e-7, tglwe_std=2.845267479601915e-15
)
BATCH = 128
CPU_CHECK = 4  # bootstraps also run on the CPU's plain path and compared
LOOP_CHECK = 4  # steps of the C loop held against the plain loop at batch 128

# The bounds. H100 SXM: 3.35 TB/s of device memory (data sheet); 132 SMs at
# the card's maximum SM clock, each issuing at most 128 lanes of
# instructions per clock (4 warp schedulers). Integer instructions go to two
# pipes of 64 lanes per SM per clock: the FMA pipe (IMAD, IMAD.HI) and the
# ALU pipe (ISETP, SEL, LOP3, shifts); an add or subtract may go to either
# (IADD3, or IMAD.IADD). The kernels' work is counted in integer
# instructions of each class, as the compiled code has them (cuobjdump
# -sass): (FMA pipe only, ALU pipe only, either pipe).
HBM_BYTES_PER_S = 3.35e12
SMS, PIPE_LANES = 132, 64
SHOUP = np.array([3, 2, 1])  # a*w mod q, Shoup dual: mul hi, mul, mul-sub; compare, select; subtract q
ADD_MOD = np.array([0, 2, 2])  # a + b mod q: add; compare, select; subtract q
SUB_MOD = np.array([0, 2, 1])  # a - b mod q: compare, select; a - b + (q or 0)
BUTTERFLY = SHOUP + ADD_MOD + SUB_MOD
DIGIT = np.array([0, 6, 3])  # one gadget digit from a torus value's high word
FOLD = np.array([0, 2, 1])  # a signed digit into [0, q)
U64_ADD = np.array([0, 0, 2])


def say(*parts) -> None:
    print(*parts, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout  # fmt: skip
    return out.strip().splitlines()[0].strip()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout  # fmt: skip
    return out.strip().splitlines()[0].strip()


def garner_ops(k: int) -> np.ndarray:
    """Per coefficient: the mixed-radix walk, the u64 recombination (4 FMA
    instructions per multiply-add) and the centered lift's comparisons."""
    return k * (k - 1) // 2 * (SUB_MOD + SHOUP + [0, 0, 2]) + k * np.array([4, 2, 0])


def ntt_ops(rows: int, n: int) -> np.ndarray:
    return rows * (n // 2) * (n.bit_length() - 1) * BUTTERFLY


def step_ops(batch: int, n: int, k: int) -> np.ndarray:
    """One blind-rotation step per ciphertext: digits, and per prime the
    sign fold, 2 forward and 2 inverse NTTs with the 1/N scale, the key
    contraction and the monomial; then Garner and the u64 add into acc."""
    contraction = 4 * SHOUP + 2 * ADD_MOD
    per_prime = 2 * n * FOLD + 4 * ntt_ops(1, n) + 2 * n * SHOUP + n * contraction + 2 * n * (SHOUP + SUB_MOD)
    return batch * (2 * n * DIGIT + k * per_prime + 2 * n * (garner_ops(k) + U64_ADD))


ZQ_DIGIT = np.array([1, 4, 2])  # one Zq gadget digit: and, carry compare/select, shift, mask, limb + carry * (q - B)
NEG_MOD = np.array([0, 2, 1])  # q - a where a != 0


def fhew_walk_ops_shoup(ext_steps: int, auto_steps: int, n: int, d_g: int, d_k: int) -> np.ndarray:
    """A walk over a batch's schedules as a kernel with Shoup contractions
    (the key's duals) and compare-and-select subtracts would run it, counted
    from the steps that this run's schedules hold (summed over the
    ciphertexts): printed beside K-FHEW-BR's own count for comparison. An
    external product: 2d digit rows, their forward NTTs, the Shoup
    contraction of a and b over 2d rows, 2 inverse NTTs with the 1/N scale.
    An automorphism: the signed gather of a and b, d digit rows, their
    forward NTTs, the contraction over d rows, 2 inverse NTTs with the
    scale, and b + the gathered b."""
    inverse = ntt_ops(2, n) + 2 * n * SHOUP
    ext = 2 * n * d_g * ZQ_DIGIT + ntt_ops(2 * d_g, n) + 2 * d_g * n * 2 * (SHOUP + ADD_MOD) + inverse
    auto = 2 * n * NEG_MOD + n * d_k * ZQ_DIGIT + ntt_ops(d_k, n) + d_k * n * 2 * (SHOUP + ADD_MOD) + inverse + n * ADD_MOD
    return ext_steps * ext + auto_steps * auto


# K-FHEW-BR's own arithmetic, as its SASS has it: each conditional subtract
# is the unsigned minimum min(s, s - q), which Hopper fuses into one
# VIADDMNMX (counted on the ALU pipe, as a minimum is).
SHOUP_MIN = np.array([3, 1, 0])  # mul hi, mul, mul-sub; subtract-and-minimum
ADD_MIN = np.array([0, 1, 1])  # add; subtract-and-minimum
SUB_MIN = np.array([0, 1, 1])  # subtract; add-and-minimum
BUTTERFLY_MIN = SHOUP_MIN + ADD_MIN + SUB_MIN
MAD_WIDE = np.array([1, 0, 0])  # a row product added to a u64 sum (IMAD.WIDE.U32)
REDUCE64 = 2 * SHOUP_MIN - [1, 0, 0] + ADD_MIN  # a u64 mod q: hi * (2^32 mod q) + lo (lo's product by 1 needs no multiply)
ZQ_LIFT = np.array([0, 2, 2])  # per coefficient: the centered lift (compare, select, subtract), + the digits' offsets
ZQ_FIELD = np.array([0, 3, 1])  # per digit: shift, mask, less the offset mod q


def ntt_ops_min(rows: int, n: int) -> np.ndarray:
    return rows * (n // 2) * (n.bit_length() - 1) * BUTTERFLY_MIN


def fhew_walk_ops(ext_steps: int, auto_steps: int, n: int, d_g: int, d_k: int, chunk: int) -> np.ndarray:
    """K-FHEW-BR over a batch's schedules, counted from the steps that this
    run's schedules hold (summed over the ciphertexts), at the least each
    operation of the kernel needs. An external product: the centered lift
    of a and b and 2d digit rows from it, their forward NTTs, per output
    coefficient 2d row products summed in u64 and reduced once per `chunk`
    rows, 2 inverse NTTs with the 1/N scale. An automorphism: the signed
    gather of a and b, the lift and d digit rows of the gathered a, their
    forward NTTs, the contraction over d rows, 2 inverse NTTs with the
    scale, and b + the gathered b."""

    def contraction(rows: int) -> np.ndarray:
        sums = -(-rows // min(rows, chunk))
        return 2 * n * (rows * MAD_WIDE + sums * REDUCE64 + (sums - 1) * ADD_MIN)

    inverse = ntt_ops_min(2, n) + 2 * n * SHOUP_MIN
    ext = 2 * n * ZQ_LIFT + 2 * n * d_g * ZQ_FIELD + ntt_ops_min(2 * d_g, n) + contraction(2 * d_g) + inverse
    auto = 2 * n * NEG_MOD + n * ZQ_LIFT + n * d_k * ZQ_FIELD + ntt_ops_min(d_k, n) + contraction(d_k) + inverse + n * ADD_MIN
    return ext_steps * ext + auto_steps * auto


def issue_ms(ops: np.ndarray, pipe_per_s: float) -> float:
    """The least time for the instructions (FMA only, ALU only, either):
    each pipe takes pipe_per_s lanes, the SMs issue twice that."""
    fma, alu, either = (float(v) for v in ops)
    return max(fma, alu, (fma + alu + either) / 2) / pipe_per_s * 1e3


def bound_ms(n_bytes: float, ops: np.ndarray, pipe_per_s: float) -> tuple[float, str]:
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, issue_ms(ops, pipe_per_s)
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds per call of fn, by CUDA events after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device milliseconds per call of fn: reps calls captured in one CUDA
    graph, which is replayed once to warm up and once between CUDA events,
    so that no host time (the wrapper's checks, its allocation, the ctypes
    call) falls between two launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_kernel_ms(fn) -> tuple[float, float, list[tuple[str, float, int]]]:
    """For one call of fn (torch.profiler): the device's idle share over the
    span from its first kernel's start to its last kernel's end (1 minus
    the union of the kernels' intervals over that span; a kernel launched
    early by programmatic dependent launch counts as busy from its start),
    the kernels' summed time, and the five largest by name with their
    launch counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    spans = sorted(
        (e.time_range.start, e.time_range.end)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start
    )
    busy, reach = 0.0, None
    for start, end in spans:
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    idle = 1 - busy / (reach - spans[0][0]) if spans else float("nan")
    return idle, sum(t for _, t, _ in rows), rows[:5]


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Require got (on the card) == want (on the CPU); return max |difference|."""
    torch.cuda.synchronize()
    got = got.cpu()
    err = float((got.long() - want.long()).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, want):
        raise AssertionError(f"kernel differs from its plain version (max |err| {err})")
    return err


def spread_ms(fn, calls: int) -> tuple[float, float, float]:
    """Median, least and most milliseconds of `calls` single calls of fn,
    each between CUDA events and synchronised, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), min(times), max(times)


# The u64 engine's operations as 32-bit instructions (FMA pipe only, ALU
# pipe only, either), the least each needs, counted from its 32-bit
# expansion (a model: not read from the SASS): a 64 x 64 product's low word
# is one IMAD.WIDE.U32 and two IMADs; its high word four wide products and
# three carrying adds; a u64 add two adds; a u64 minimum two compares and
# two selects.
MUL64_LO = np.array([3, 0, 0])
MULHI64 = np.array([4, 0, 3])
ADD64 = np.array([0, 0, 2])
MIN64 = np.array([0, 4, 0])
CSUB64 = ADD64 + MIN64
SHOUP64 = MULHI64 + 2 * MUL64_LO + ADD64 + CSUB64
ADD_Q64 = ADD64 + CSUB64
BUTTERFLY64 = SHOUP64 + 2 * ADD_Q64
REDC64 = MUL64_LO + MULHI64 + 2 * ADD64 + CSUB64
MAC128 = MUL64_LO + MULHI64 + 2 * ADD64  # a row product added to a 128-bit sum
MULMOD64 = 2 * (MUL64_LO + MULHI64 + REDC64)
DIGIT64 = np.array([0, 8, 4])  # the centered lift and one field of it, less the offset mod q


def ntt64_ops(rows: int, n: int) -> np.ndarray:
    return rows * (n // 2) * (n.bit_length() - 1) * BUTTERFLY64


def extprod64_ops(count: int, n: int, rows: int, key_switch: bool) -> np.ndarray:
    """`count` external products (2d = rows digit rows of a and b) or key
    switches (d = rows digit rows of a; b + the source's b): the digits,
    their forward NTTs, per output coefficient `rows` 128-bit
    multiply-adds and one REDC, two inverse NTTs with the 1/N scale."""
    inverse = ntt64_ops(2, n) + 2 * n * SHOUP64
    per = rows * n * DIGIT64 + ntt64_ops(rows, n) + 2 * n * (rows * MAC128 + REDC64) + inverse
    return count * (per + (n * ADD_Q64 if key_switch else 0))


def walk_device_ms(fn, reps: int) -> float:
    """K-FHEW-BR's device milliseconds per launch over `reps` calls of fn
    (torch.profiler, the kernel's own time only), after one warm-up. The
    mean is over the launches the profiler recorded: CUPTI can drop a
    record, so a short count is printed, and where it recorded none the
    time is taken by CUDA events around each whole call instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [
        (e.self_device_time_total, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and "fhew_blind_rotate" in e.key
    ]
    total, count = sum(r[0] for r in rows), sum(r[1] for r in rows)
    if count > reps:
        raise AssertionError(f"the profiler saw {count} K-FHEW-BR launches in {reps} calls")
    if count == 0:
        say(f"  (the profiler recorded none of {reps} K-FHEW-BR launches: CUDA events around each whole call instead)")
        return cuda_ms(fn, reps)
    if count < reps:
        say(f"  (the profiler recorded {count} of {reps} K-FHEW-BR launches: the mean is over those)")
    return total / 1e3 / count


def compact(idx: torch.Tensor) -> torch.Tensor:
    """Each row's entries >= 0 moved to its front, in order, -1 after them."""
    rows = []
    for row in idx.cpu():
        kept = row[row >= 0]
        rows.append(torch.cat([kept, torch.full((row.numel() - kept.numel(),), -1, dtype=row.dtype)]))
    return torch.stack(rows).to(idx.device)


FHEW_BATCH = 128  # `bench.py:302`
FHEW_INFO_BATCH = 1024  # gates/s for information beside batch 128
FHEW_CPU_CHECK = 4
GATE_CALLS = 5  # whole gate batches timed one by one: the host's time varies between calls
WALK_REPS = 5
WALK_SWEEP = (1, 132, 264, 1024)  # one ciphertext alone; one and two per SM; eight
FHEW_INSTANCE = "fhew_blind_rotate_kernel<9>"  # N=512


def fhew_reference_params():
    """`bench.py:289-295` (= `tests/test_fhew.py::reference_boot_params`)."""
    from learn_fhe_tpu_torch.models import fhew
    from learn_fhe_tpu_torch.utils.primes import two_adic_primes

    q = next(two_adic_primes(28, 10))
    return fhew.BootstrapParams(
        fhew.RgswParams(fhew.RlweParams(q=q, p=4, log_n=9, log_b=7, d=4), log_b=7, d=4),
        fhew.LweParams(q=1 << 16, p=4, n=100, log_b=4, d=4),
        w=10,
    )


def fhew_phases(dev, tag, pipe_per_s, errs, timings, bounds, launches) -> None:
    """F1-F4 (see the module's docstring); adds K-FHEW-BR's entries to the
    kernels line's dicts, and K-NTT's and intt32's errors at FHEW's primes."""
    from learn_fhe_tpu_torch.models import fhew
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.models.fhew import gates, lwe
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext
    from learn_fhe_tpu_torch.ops import ntt32 as tntt
    from learn_fhe_tpu_torch.parallel import batch as pbatch
    from learn_fhe_tpu_torch.utils import kernels
    from learn_fhe_tpu_torch.utils.interop import u32_to_torch

    # -- F1. K-NTT and intt32 at the FHEW primes --------------------------------
    rng = np.random.default_rng(2)
    for q, n, shapes in ((268409857, 512, (800, 19)), (268432897, 128, (800, 19))):
        plan = tntt.ntt32_plan(q, n)
        for rows in shapes:
            x = u32_to_torch(rng.integers(0, q, size=(rows, n), dtype=np.uint32))
            errs["ntt32"] = max(errs["ntt32"], max_abs_err(tntt.ntt32(x.to(dev), plan), tntt.ntt32_ref(x, plan)))
            errs["intt32"] = max(errs["intt32"], max_abs_err(tntt.intt32(x.to(dev), plan), tntt.intt32_ref(x, plan)))
        say(f"F1 ntt32 / intt32 == plain at q={q}, N={n} on {shapes[0]} and {shapes[1]} rows: ok")

    # -- F2. the FHEW main path ------------------------------------------------
    params = fhew_reference_params()
    lz, B = params.lwe_z, FHEW_BATCH
    rng = np.random.default_rng(0)
    z = fhew.rlwe.sk_gen(params.rlwe, rng)
    for fn in (tntt.ntt32, tntt.intt32, tntt.negacyclic_mul32):
        fn.launches = 0
    t0 = time.perf_counter()
    key = fhew.key_gen(params, z, rng, dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    keygen_launches = {fn.__name__: fn.launches for fn in (tntt.ntt32, tntt.intt32, tntt.negacyclic_mul32)}
    m0 = torch.from_numpy(rng.integers(0, 2, size=B)).to(dev)
    m1 = torch.from_numpy(rng.integers(0, 2, size=B)).to(dev)
    c0 = lwe.sk_encrypt(lz, z, gates.encode_bool(params, m0), rng)
    c1 = lwe.sk_encrypt(lz, z, gates.encode_bool(params, m1), rng)
    counted = (tntt.ntt32, tntt.intt32, tntt.negacyclic_mul32, boot.blind_rotate_core_fused)
    boot.walk_error(dev).zero_()
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    out = pbatch.fhew_gate_batch(params, key, "nand", c0, c1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    fhew_launches = {fn.__name__: fn.launches for fn in counted}
    say(f"{tag} F2 FHEW keygen {keygen_s * 1e3:.1f} ms (host clock, to a sync; launches {keygen_launches}); first NAND batch of {B} {first_s * 1e3:.1f} ms; launches {fhew_launches}")
    if out.a.shape != (B, params.n) or out.b.shape != (B,):
        raise AssertionError(f"gate output shapes {tuple(out.a.shape)}, {tuple(out.b.shape)}")
    if fhew_launches["blind_rotate_core_fused"] != 1:
        raise AssertionError(f"K-FHEW-BR launched {fhew_launches['blind_rotate_core_fused']} times in one fhew_gate_batch, expected 1")
    if keygen_launches["ntt32"] == 0 or keygen_launches["intt32"] == 0:
        raise AssertionError("FHEW key generation did not launch K-NTT and intt32")
    launches["fhew_blind_rotate"] = fhew_launches["blind_rotate_core_fused"]
    got = gates.decode_bool(params, lwe.decrypt(lz, z, out))
    n_ok = int((got == ~(m0.bool() & m1.bool())).sum())
    say(f"F2 NAND: {n_ok}/{B} gates decrypt to the truth table")
    if n_ok != B:
        raise AssertionError("NAND outputs failed decryption")
    names = ["and", "nand", "or", "nor", "xor", "xnor", "majority"]
    bits = rng.integers(0, 2, size=(len(names), 3))
    specs, want_bits = [], []
    for name, (x, y, c) in zip(names, bits):
        cts = [lwe.sk_encrypt(lz, z, gates.encode_bool(params, torch.tensor(int(v), device=dev)), rng) for v in (x, y, c)]
        truth = {"and": x & y, "nand": 1 - (x & y), "or": x | y, "nor": 1 - (x | y), "xor": x ^ y, "xnor": 1 - (x ^ y)}
        specs.append((name, *cts) if name == "majority" else (name, *cts[:2]))
        want_bits.append(int(x + y + c >= 2) if name == "majority" else int(truth[name]))
    mixed = gates.gate_batch(params, key, specs)
    got_bits = [int(gates.decode_bool(params, lwe.decrypt(lz, z, ct))) for ct in mixed]
    say(f"F2 gate_batch of {names}: decrypts {got_bits}, truth {want_bits}")
    if got_bits != want_bits:
        raise AssertionError("mixed gate batch failed decryption")

    # -- F3. the walk against its plain version; the CPU path; the C schedule --
    lin = gates._lin2(params, "nand", c0, c1)
    f = gates.lut_poly(params, gates.GATE_TABLES["nand"], dev)
    ct_a, f_prime = pbatch._fhew_preamble(params, key, f, lin)
    e_idx, a_idx = boot.schedule(params, ct_a)
    mask = ct_a.cpu().numpy()
    py_e, py_a = boot.fuse_schedule(*boot.build_schedule(params, mask))
    c_e, c_a = boot.schedule_native(params, mask)
    if not (np.array_equal(py_e, c_e) and np.array_equal(py_a, c_a)):
        raise AssertionError("the C schedule differs from the Python one")
    if not (np.array_equal(e_idx.cpu().numpy(), c_e) and np.array_equal(a_idx.cpu().numpy(), c_a)):
        raise AssertionError("schedule() on a CUDA mask differs from the C schedule")
    steps = e_idx.shape[1]
    ext_steps, auto_steps = int((e_idx >= 0).sum()), int((a_idx >= 0).sum())
    say(f"F3 C schedule == Python schedule on the batch's mask: ok (fused length {steps}, schedule_len {params.schedule_len}; {ext_steps} external products and {auto_steps} automorphisms over {B} ciphertexts)")
    acc = RlweCiphertext(torch.zeros_like(f_prime), f_prime)
    # the same phases split apart: each row's external products alone, then
    # its automorphisms alone (a schedule ends at its first (-1, -1))
    none = torch.full_like(e_idx, -1)
    schedules = {"real": (e_idx, a_idx), "ext-only": (compact(e_idx), none), "auto-only": (none, compact(a_idx))}
    errs["fhew_blind_rotate"] = 0.0
    for name, (se, sa) in schedules.items():
        walk = boot.blind_rotate_core_fused(params, key, se, sa, acc)
        plain = boot.blind_rotate_core_fused_ref(params, key, se, sa, acc)
        errs["fhew_blind_rotate"] = max(errs["fhew_blind_rotate"], max_abs_err(walk.a, plain.a.cpu()), max_abs_err(walk.b, plain.b.cpu()))
        say(f"F3 K-FHEW-BR == blind_rotate_core_fused_ref at batch {B}, N={params.n}, real key, {name} schedule: ok")
    t0 = time.perf_counter()
    key_cpu = boot.BootstrapKey(*(t.cpu() for t in key))
    k = FHEW_CPU_CHECK
    sub = [lwe.LweCiphertext(c.a[:k].cpu(), c.b[:k].cpu()) for c in (c0, c1)]
    ref_out = pbatch.fhew_gate_batch(params, key_cpu, "nand", *sub)
    if not (torch.equal(ref_out.a, out.a[:k].cpu()) and torch.equal(ref_out.b, out.b[:k].cpu())):
        raise AssertionError("FHEW gates on the card differ from the plain path on the CPU")
    say(f"F3 first {k} NAND outputs == the plain path on the CPU, bit for bit ({time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    word = int(boot.walk_error(dev).item())
    say(f"F3 K-FHEW-BR error word after F2 and F3: {word}")
    if word:
        raise AssertionError(f"K-FHEW-BR flagged a schedule index outside the key (error word {word})")

    # -- F4. timing --------------------------------------------------------------
    reps = 3

    def gate_call():
        pbatch.fhew_gate_batch(params, key, "nand", c0, c1)

    gate_ms = spread_ms(gate_call, GATE_CALLS)
    say(f"{tag} F4 NAND batch {B}: {gate_ms[0]:.3f} ms per fhew_gate_batch call (median of {GATE_CALLS}; {gate_ms[1]:.3f}-{gate_ms[2]:.3f}) = {B / gate_ms[0] * 1e3:.2f} gates/s ({B / gate_ms[2] * 1e3:.2f}-{B / gate_ms[1] * 1e3:.2f}; CUDA events around each whole call, host time included)")
    pre, sch = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ct_a_r, _ = pbatch._fhew_preamble(params, key, f, lin)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        boot.schedule(params, ct_a_r)
        torch.cuda.synchronize()
        pre.append(t1 - t0)
        sch.append(time.perf_counter() - t1)
    walk_ms = cuda_ms(lambda: boot.blind_rotate_core_fused(params, key, e_idx, a_idx, acc), reps)
    say(f"{tag} F4 NAND batch {B}: preamble {np.median(pre) * 1e3:.3f} ms, host schedule (C, with the mask's copy to the host and the indices' copy back) {np.median(sch) * 1e3:.3f} ms (host clock to a sync, median of {reps}); walk {walk_ms:.3f} ms (CUDA events)")
    # where the walk's time goes: the phases apart, and the batch size
    walk_dev = walk_device_ms(lambda: boot.blind_rotate_core_fused(params, key, e_idx, a_idx, acc), WALK_REPS)
    say(f"{tag} F4 K-FHEW-BR at batch {B}: device {walk_dev:.4f} ms per launch (profiler, {WALK_REPS} launches), wrapper call {walk_ms:.4f} ms (CUDA events, {reps} calls)")
    for name in ("ext-only", "auto-only"):
        se, sa = schedules[name]
        n_ext, n_auto = int((se >= 0).sum()), int((sa >= 0).sum())
        t = walk_device_ms(lambda: boot.blind_rotate_core_fused(params, key, se, sa, acc), WALK_REPS)
        per = t * 1e3 / (n_ext or n_auto) * B
        say(f"{tag} F4 split, batch {B}, {name} schedule ({n_ext} external products, {n_auto} automorphisms): {t:.4f} ms per launch (device, profiler) = {per:.3f} us per phase and ciphertext")
    for b in WALK_SWEEP:
        rows = torch.arange(b, device=dev) % B
        se, sa = e_idx[rows].contiguous(), a_idx[rows].contiguous()
        acc_b = RlweCiphertext(acc.a[rows].contiguous(), acc.b[rows].contiguous())
        t = walk_device_ms(lambda: boot.blind_rotate_core_fused(params, key, se, sa, acc_b), WALK_REPS)
        say(f"{tag} F4 sweep, real schedule at batch {b} (rows of the batch-{B} schedule, repeated): {t:.4f} ms per launch (device, profiler) = {t * 1e3 / b:.3f} us per ciphertext")
    idle, kernel_ms, top = device_kernel_ms(gate_call)
    if kernel_ms:
        say(f"{tag} F4 NAND batch {B}: device idle share {idle:.4f} (profiler, union of kernel intervals); summed kernel time {kernel_ms:.3f} ms")
        for name, t, count in top:
            say(f"  {t:10.3f} ms  {count:6d} x  {name[:100]}")
    else:
        say(f"{tag} F4 device kernel time and idle share: not measured (the profiler recorded no device activity)")
    plain_ms = cuda_ms(lambda: boot.blind_rotate_core_fused_ref(params, key, e_idx, a_idx, acc), 1)
    gg, gk = params.rgsw.gadget, params.rlwe.gadget
    chunk = boot.contraction_chunk(params.big_q, max(2 * gg.d, gk.d))
    ops = fhew_walk_ops(ext_steps, auto_steps, params.n, gg.d, gk.d, chunk)
    n, row = params.n, params.n * 4
    e_used = torch.unique(e_idx[e_idx >= 0]).numel()
    a_used = torch.unique(a_idx[a_idx >= 0]).numel()
    key_values = e_used * 2 * 2 * gg.d * row + a_used * 2 * gk.d * row  # the brk and ak rows used, a and b
    walk_bytes = (
        4 * B * row  # acc a, b in; a, b out
        + 2 * B * steps * 4  # the schedules
        + key_values
        + a_used * n * 5  # the gather maps and signs used
        + 4 * row  # twiddle tables
    )
    key_rows = ext_steps * 2 * 2 * gg.d * n * 4 + auto_steps * (2 * gk.d * n * 4 + n * 5)
    say(f"{tag} F4 K-FHEW-BR at batch {B}: the walk's key rows, one copy per phase (values of a and b; the automorphisms' gather maps and signs): {key_rows / 1e6:.2f} MB per launch ({key_rows / (ext_steps + auto_steps) / 1e3:.2f} KB per phase); with the Shoup duals {2 * key_rows / 1e6:.2f} MB")
    b_ms, by = bound_ms(walk_bytes, ops, pipe_per_s)
    timings["fhew_blind_rotate"] = (walk_ms, plain_ms)
    bounds["fhew_blind_rotate"] = (b_ms, by)
    regs, st, ld = kernels.ptxas_report(kernels.build_log()).get(FHEW_INSTANCE, (0, 0, 0))
    say(f"{tag} F4 K-FHEW-BR at batch {B}: {walk_ms:.3f} ms per launch (CUDA events, {reps} reps), bound {b_ms:.4f} ms by {by} (instructions {ops[0] / 1e6:.1f} M FMA, {ops[1] / 1e6:.1f} M ALU, {ops[2] / 1e6:.1f} M either, the contraction reduced every {chunk} rows; bytes {walk_bytes / 1e6:.2f} MB) = {b_ms / walk_ms:.4f} of bound, {b_ms / walk_dev:.4f} on the device; plain version on CUDA tensors {plain_ms:.1f} ms; {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
    ops_s = fhew_walk_ops_shoup(ext_steps, auto_steps, params.n, gg.d, gk.d)
    s_ms, s_by = bound_ms(walk_bytes + key_values, ops_s, pipe_per_s)
    say(f"{tag} F4 K-FHEW-BR at batch {B}, for comparison: a walk with Shoup contractions (the key's duals read too) and compare-and-select subtracts counts {ops_s[0] / 1e6:.1f} M FMA, {ops_s[1] / 1e6:.1f} M ALU, {ops_s[2] / 1e6:.1f} M either: bound {s_ms:.4f} ms by {s_by} = {s_ms / walk_ms:.4f} of this kernel's wrapper call, {s_ms / walk_dev:.4f} on the device")

    rng = np.random.default_rng(3)
    big = [
        lwe.sk_encrypt(lz, z, gates.encode_bool(params, torch.from_numpy(rng.integers(0, 2, size=FHEW_INFO_BATCH)).to(dev)), rng)
        for _ in range(2)
    ]
    big_ms = spread_ms(lambda: pbatch.fhew_gate_batch(params, key, "nand", *big), GATE_CALLS)
    say(f"{tag} F4 NAND batch {FHEW_INFO_BATCH}: {big_ms[0]:.3f} ms per call (median of {GATE_CALLS}; {big_ms[1]:.3f}-{big_ms[2]:.3f}) = {FHEW_INFO_BATCH / big_ms[0] * 1e3:.2f} gates/s ({FHEW_INFO_BATCH / big_ms[2] * 1e3:.2f}-{FHEW_INFO_BATCH / big_ms[1] * 1e3:.2f}; CUDA events around each whole call)")
    torch.cuda.synchronize()
    word = int(boot.walk_error(dev).item())
    say(f"F4 K-FHEW-BR error word after the timing, the split and the sweep: {word}")
    if word:
        raise AssertionError(f"K-FHEW-BR flagged a schedule index outside the key (error word {word})")


MK_PARTIES = 2
MK_A, MK_B = 177, 7  # `examples/multi_key_uint8.py`'s defaults
MK_KEYGEN_ROWS = 6000  # one party's brk: 600 RGSW encryptions of 2d = 10 rows
MK_INSTANCES = ("ntt64_kernel", "negacyclic_mul64_kernel", "external_product64_kernel", "fhew_blind_rotate64_kernel")


def multikey_phases(dev, tag, pipe_per_s, errs, timings, bounds, launches, graphs) -> None:
    """M1-M4 (see the module's docstring); adds the u64 kernels' entries to
    the kernels line's dicts."""
    from learn_fhe_tpu_torch.examples.multi_key_uint8 import example_params, wrapping_expression
    from learn_fhe_tpu_torch.models import fhew
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.models.fhew import gates, lwe, rgsw
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext
    from learn_fhe_tpu_torch.ops import ntt as tntt
    from learn_fhe_tpu_torch.ops.poly import automorphism_map
    from learn_fhe_tpu_torch.parallel import batch as pbatch
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch
    from learn_fhe_tpu_torch.utils.primes import two_adic_primes

    params = example_params(full=True)
    q, n, plan = params.big_q, params.n, params.rlwe.plan
    gg, gk = params.rgsw.gadget, params.rlwe.gadget
    rng = np.random.default_rng(7)

    def residues(shape, modulus=q):
        x = rng.integers(0, modulus, size=shape, dtype=np.uint64)
        x.reshape(-1)[:2] = [0, modulus - 1]
        return u64_to_torch(x)

    def plain(fn, *args):
        """A plain version on CUDA tensors, its result brought to the CPU."""
        out = fn(*args)
        return RlweCiphertext(out.a.cpu(), out.b.cpu()) if isinstance(out, tuple) else out.cpu()

    # -- M1. K-NTT64, intt64, K-POLYMUL64 ----------------------------------------
    for name in ("ntt64", "intt64", "negacyclic_mul64"):
        errs[name] = 0.0
    small = tntt.ntt_plan(q, min(256, n // 2))
    for rows, p in ((10, plan), (19, small), (MK_KEYGEN_ROWS, plan)):
        x, y = residues((rows, p.n)).to(dev), residues((rows, p.n)).to(dev)
        check = (
            ("ntt64", tntt.ntt64(x, p), lambda: plain(tntt.ntt64_ref, x, p)),
            ("intt64", tntt.intt64(x, p), lambda: plain(tntt.intt64_ref, x, p)),
            ("negacyclic_mul64", tntt.negacyclic_mul64(x, y, p), lambda: plain(tntt.negacyclic_mul64_ref, x, y, p)),
        )
        for name, got, want in check:
            errs[name] = max(errs[name], max_abs_err(got, want()))
        say(f"M1 ntt64 / intt64 / negacyclic_mul64 == plain at q={q} on ({rows}, {p.n}): ok")
    for rows in (10, MK_KEYGEN_ROWS):
        x, y = residues((rows, n)).to(dev), residues((rows, n)).to(dev)
        row_bytes = rows * n * 8
        for name, kernel, plain_fn, n_bytes, ops in (
            ("ntt64", lambda: tntt.ntt64(x, plan), lambda: tntt.ntt64_ref(x, plan), 2 * row_bytes, ntt64_ops(rows, n)),
            ("intt64", lambda: tntt.intt64(x, plan), lambda: tntt.intt64_ref(x, plan), 2 * row_bytes, ntt64_ops(rows, n) + rows * n * SHOUP64),
            (
                "negacyclic_mul64", lambda: tntt.negacyclic_mul64(x, y, plan), lambda: tntt.negacyclic_mul64_ref(x, y, plan),
                3 * row_bytes, 3 * ntt64_ops(rows, n) + rows * n * (MULMOD64 + SHOUP64),
            ),
        ):  # fmt: skip
            k_ms, g_ms, p_ms = cuda_ms(kernel, 50), graph_ms(kernel, 50), cuda_ms(plain_fn, 3)
            b_ms, by = bound_ms(n_bytes, ops, pipe_per_s)
            say(f"{tag} M1 {name} at ({rows}, {n}): kernel {k_ms * 1e3:.2f} us per wrapper call (CUDA events over 50 eager calls), {g_ms * 1e3:.2f} us per launch (CUDA graph of 50), plain {p_ms * 1e3:.2f} us; bound {b_ms * 1e3:.2f} us by {by} = {b_ms / k_ms:.4f} / {b_ms / g_ms:.4f} of bound")
            if rows == MK_KEYGEN_ROWS:
                timings[name], graphs[name], bounds[name] = (k_ms, p_ms), g_ms, (b_ms, by)

    # -- M2. K-EXTPROD64 at one merge chunk --------------------------------------
    chunk = boot.merge_chunk_size(params.lwe_s.n)
    rows_g = 2 * gg.d
    ka, kb = residues((chunk, rows_g, n)).to(dev), residues((chunk, rows_g, n)).to(dev)
    count = chunk * rows_g
    ct = RlweCiphertext(residues((count, n)).to(dev), residues((count, n)).to(dev))
    idx = torch.arange(chunk, dtype=torch.int32, device=dev).repeat_interleave(rows_g)
    args = (gg, plan, ka, kb, idx, ct, False)
    want = plain(rgsw.external_product64_ref, *args)
    got = rgsw.external_product64(*args)
    errs["external_product64"] = max(max_abs_err(got.a, want.a), max_abs_err(got.b, want.b))
    ks_args = (gk, plan, ka[:, : gk.d].contiguous(), kb[:, : gk.d].contiguous(), idx, ct, True)
    want = plain(rgsw.external_product64_ref, *ks_args)
    got = rgsw.external_product64(*ks_args)
    errs["external_product64"] = max(errs["external_product64"], max_abs_err(got.a, want.a), max_abs_err(got.b, want.b))
    say(f"M2 external_product64 == plain at one merge chunk ({chunk} keys, {count} products of {rows_g} rows) and as a key switch ({gk.d} rows): ok")
    k_ms, p_ms = cuda_ms(lambda: rgsw.external_product64(*args), 5), cuda_ms(lambda: rgsw.external_product64_ref(*args), 1)
    n_bytes = 4 * count * n * 8 + 2 * chunk * rows_g * n * 8 + count * 4
    b_ms, by = bound_ms(n_bytes, extprod64_ops(count, n, rows_g, False), pipe_per_s)
    timings["external_product64"], bounds["external_product64"] = (k_ms, p_ms), (b_ms, by)
    regs, st, ld = kernels_report().get("external_product64_kernel", (0, 0, 0))
    say(f"{tag} M2 external_product64 at one merge chunk: {k_ms:.4f} ms per call (CUDA events, 5 calls) = {k_ms * 1e3 / count:.3f} us per product; plain {p_ms:.1f} ms; bound {b_ms:.4f} ms by {by} = {b_ms / k_ms:.4f} of bound; {regs} registers, {st} / {ld} bytes spilled")

    # -- M3. K-FHEW-BR64 against the plain walk ------------------------------------
    errs["fhew_blind_rotate64"] = 0.0
    q54 = next(two_adic_primes(54, 8))
    fixture = fhew.BootstrapParams(
        fhew.RgswParams(fhew.RlweParams(q=q54, p=4, log_n=7, log_b=6, d=9), log_b=6, d=9),
        fhew.LweParams(q=1 << 16, p=4, n=16, log_b=4, d=4),
        w=5,
    )
    key54 = fhew.key_gen(fixture, fhew.rlwe.sk_gen(fixture.rlwe, rng), rng, dev)
    maps = [automorphism_map(n, t) for t in params.ak_t]
    key_rand = boot.BootstrapKey(
        torch.zeros((4, n, params.lwe_s.n), dtype=torch.int64, device=dev), torch.zeros((4, n), dtype=torch.int64, device=dev),
        residues((params.lwe_s.n, rows_g, n)).to(dev), residues((params.lwe_s.n, rows_g, n)).to(dev),
        residues((params.w + 1, gk.d, n)).to(dev), residues((params.w + 1, gk.d, n)).to(dev),
        torch.from_numpy(np.stack([m[0] for m in maps]).astype(np.int32)).to(dev), torch.from_numpy(np.stack([m[1] for m in maps])).to(dev),
    )  # fmt: skip
    boot.walk_error(dev).zero_()
    for label, p, key, batch in (("54-bit fixture", fixture, key54, 5), ("54-bit fixture", fixture, key54, 128), ("full set, random key rows", params, key_rand, 2)):
        a2n = torch.from_numpy(2 * rng.integers(0, p.n, size=(batch, p.lwe_s.n)) + 1).to(dev)
        e_idx, a_idx = boot.schedule(p, a2n)
        acc = RlweCiphertext(residues((batch, p.n), p.big_q).to(dev), residues((batch, p.n), p.big_q).to(dev))
        t0 = time.perf_counter()
        want = plain(boot.blind_rotate_core_fused_ref, p, key, e_idx, a_idx, acc)
        plain_s = time.perf_counter() - t0
        got = boot.blind_rotate_core_fused(p, key, e_idx, a_idx, acc)
        errs["fhew_blind_rotate64"] = max(errs["fhew_blind_rotate64"], max_abs_err(got.a, want.a), max_abs_err(got.b, want.b))
        say(f"M3 K-FHEW-BR64 == blind_rotate_core_fused_ref at the {label}, batch {batch} ({int((e_idx >= 0).sum())} external products, {int((a_idx >= 0).sum())} automorphisms; plain on CUDA tensors {plain_s:.1f} s): ok")
    torch.cuda.synchronize()
    word = int(boot.walk_error(dev).item())
    say(f"M3 K-FHEW-BR64 error word: {word}")
    if word:
        raise AssertionError(f"K-FHEW-BR64 flagged a schedule index outside the key (error word {word})")

    # -- M4. the main path -----------------------------------------------------------
    counted = (tntt.ntt64, tntt.intt64, tntt.negacyclic_mul64, rgsw.external_product64, boot.blind_rotate_core_fused64)
    for fn in counted:
        fn.launches = 0
    rng = np.random.default_rng(0)
    steps = []

    def stamp(name, t0):
        torch.cuda.synchronize()
        steps.append((name, time.perf_counter() - t0))
        return time.perf_counter()

    t = time.perf_counter()
    crs = fhew.crs_gen(params, rng, dev)
    sks = [fhew.rlwe.sk_gen(params.rlwe, rng) for _ in range(MK_PARTIES)]
    pk = fhew.rlwe.pk_share_merge(params.rlwe, crs.pk_a, [fhew.rlwe.pk_share_gen(params.rlwe, crs.pk_a, sk, rng) for sk in sks])
    t = stamp("crs + pk shares merged", t)
    shares = []
    for i, sk in enumerate(sks):
        shares.append(fhew.key_share_gen(params, crs, sk, pk, rng))
        t = stamp(f"party {i} key share", t)
    key = fhew.key_share_merge(params, crs, shares)
    t = stamp("key merge", t)
    ct_a = fhew.FhewU8.pk_encrypt(params, key, pk, MK_A, rng)
    ct_b = fhew.FhewU8.pk_encrypt(params, key, pk, MK_B, rng)
    t = stamp("two u8 pk-encrypted", t)
    rounds0, t_expr = boot.blind_rotate_core_fused64.launches, t
    r = ct_a.wrapping_add(ct_b).wrapping_mul(ct_a.wrapping_sub(ct_b)).wrapping_div(ct_a).wrapping_rem(ct_b)
    t = stamp("((a+b)*(a-b)/a)%b", t)
    rounds = boot.blind_rotate_core_fused64.launches - rounds0
    got = r.decryption_share_merge([r.share_decrypt(sk, rng) for sk in sks])
    t = stamp("threshold decryption", t)
    mk_launches = {fn.__name__: fn.launches for fn in counted}
    expr_s = steps[-2][1]
    for name, secs in steps:
        say(f"{tag} M4 {name}: {secs:.3f} s (host clock, to a sync)")
    want = wrapping_expression(MK_A, MK_B)
    say(f"{tag} M4 ((a+b)*(a-b)/a)%b for a={MK_A}, b={MK_B}: threshold-decrypted {got}, expected {want}; {rounds} gate rounds in {expr_s:.3f} s ({expr_s / max(rounds, 1) * 1e3:.2f} ms per round); launches {mk_launches}")
    if got != want:
        raise AssertionError("the u8 expression threshold-decrypted to the wrong value")
    for name in ("ntt64", "negacyclic_mul64", "external_product64", "fhew_blind_rotate64"):
        counter = "blind_rotate_core_fused64" if name == "fhew_blind_rotate64" else name
        if mk_launches[counter] == 0:
            raise AssertionError(f"{name} was not launched on the multi-key main path")
    launches.update({k: v for k, v in mk_launches.items() if k != "blind_rotate_core_fused64"})
    launches["fhew_blind_rotate64"] = mk_launches["blind_rotate_core_fused64"]

    # NAND gates/s at batch 128 under the merged key (encrypted under the sum
    # of the parties' secrets, which the merged key switches from)
    B = FHEW_BATCH
    z_sum = sum(np.asarray(sk, dtype=np.int64) for sk in sks)
    m0 = torch.from_numpy(rng.integers(0, 2, size=B)).to(dev)
    m1 = torch.from_numpy(rng.integers(0, 2, size=B)).to(dev)
    c0 = lwe.sk_encrypt(params.lwe_z, z_sum, gates.encode_bool(params, m0), rng)
    c1 = lwe.sk_encrypt(params.lwe_z, z_sum, gates.encode_bool(params, m1), rng)
    out = pbatch.fhew_gate_batch(params, key, "nand", c0, c1)
    n_ok = int((gates.decode_bool(params, lwe.decrypt(params.lwe_z, z_sum, out)) == ~(m0.bool() & m1.bool())).sum())
    say(f"M4 NAND batch {B} at the full set: {n_ok}/{B} gates decrypt to the truth table")
    if n_ok != B:
        raise AssertionError("full-set NAND outputs failed decryption")

    def gate_call():
        pbatch.fhew_gate_batch(params, key, "nand", c0, c1)

    gate_ms = spread_ms(gate_call, GATE_CALLS)
    say(f"{tag} M4 NAND batch {B} at the full set: {gate_ms[0]:.3f} ms per fhew_gate_batch call (median of {GATE_CALLS}; {gate_ms[1]:.3f}-{gate_ms[2]:.3f}) = {B / gate_ms[0] * 1e3:.2f} gates/s ({B / gate_ms[2] * 1e3:.2f}-{B / gate_ms[1] * 1e3:.2f}; CUDA events around each whole call)")
    lin = gates._lin2(params, "nand", c0, c1)
    f = gates.lut_poly(params, gates.GATE_TABLES["nand"], dev)
    ct_a2n, f_prime = pbatch._fhew_preamble(params, key, f, lin)
    e_idx, a_idx = boot.schedule(params, ct_a2n)
    acc = RlweCiphertext(torch.zeros_like(f_prime), f_prime)
    walk_ms = cuda_ms(lambda: boot.blind_rotate_core_fused(params, key, e_idx, a_idx, acc), 3)
    idle, kernel_ms, top = device_kernel_ms(gate_call)
    walk_rows = [(t_k, cnt) for name, t_k, cnt in top if "fhew_blind_rotate64" in name]
    if walk_rows:
        walk_dev = walk_rows[0][0] / walk_rows[0][1]
        say(f"{tag} M4 NAND batch {B} at the full set: device idle share {idle:.4f} (profiler, union of kernel intervals); summed kernel time {kernel_ms:.3f} ms, K-FHEW-BR64 {walk_dev:.3f} ms of it")
        for name, t_k, cnt in top:
            say(f"  {t_k:10.3f} ms  {cnt:6d} x  {name[:100]}")
    else:
        walk_dev = float("nan")
        say(f"{tag} M4 device kernel time, K-FHEW-BR64's device time and the idle share: not measured (the profiler recorded no launch of K-FHEW-BR64: {[(k[:60], c) for k, _, c in top]})")
    ext_steps, auto_steps = int((e_idx >= 0).sum()), int((a_idx >= 0).sum())
    ops = extprod64_ops(ext_steps, n, rows_g, False) + extprod64_ops(auto_steps, n, gk.d, True) + auto_steps * 2 * n * CSUB64
    e_used = torch.unique(e_idx[e_idx >= 0]).numel()
    a_used = torch.unique(a_idx[a_idx >= 0]).numel()
    walk_bytes = 4 * B * n * 8 + 2 * e_idx.numel() * 4 + e_used * 2 * rows_g * n * 8 + a_used * (2 * gk.d * n * 8 + 5 * n)
    b_ms, by = bound_ms(walk_bytes, ops, pipe_per_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain(boot.blind_rotate_core_fused_ref, params, key, e_idx, a_idx, acc)
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = boot.blind_rotate_core_fused(params, key, e_idx, a_idx, acc)
    errs["fhew_blind_rotate64"] = max(errs["fhew_blind_rotate64"], max_abs_err(got.a, want.a), max_abs_err(got.b, want.b))
    say(f"M4 K-FHEW-BR64 == blind_rotate_core_fused_ref at batch {B} of the full set with the merged key: ok")
    timings["fhew_blind_rotate64"], bounds["fhew_blind_rotate64"] = (walk_ms, plain_ms), (b_ms, by)
    regs, st, ld = kernels_report().get("fhew_blind_rotate64_kernel", (0, 0, 0))
    say(f"{tag} M4 K-FHEW-BR64 at batch {B} ({ext_steps} external products, {auto_steps} automorphisms, fused length {e_idx.shape[1]}): {walk_ms:.3f} ms per wrapper call (CUDA events, 3 calls), device {walk_dev:.3f} ms (profiler, in the gate batch above); bound {b_ms:.4f} ms by {by} (instructions {ops[0] / 1e9:.2f} G FMA, {ops[1] / 1e9:.2f} G ALU, {ops[2] / 1e9:.2f} G either; bytes {walk_bytes / 1e6:.1f} MB) = {b_ms / walk_ms:.4f} of bound, {b_ms / walk_dev:.4f} on the device; plain version on CUDA tensors {plain_ms / 1e3:.1f} s (host clock, to a sync); {regs} registers, {st} / {ld} bytes spilled")
    torch.cuda.synchronize()
    word = int(boot.walk_error(dev).item())
    say(f"M4 K-FHEW-BR64 error word after M4: {word}")
    if word:
        raise AssertionError(f"K-FHEW-BR64 flagged a schedule index outside the key (error word {word})")


def kernels_report() -> dict:
    from learn_fhe_tpu_torch.utils import kernels

    return kernels.ptxas_report(kernels.build_log())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels run only on a GPU")
    from learn_fhe_tpu_torch.models import tfhe
    from learn_fhe_tpu_torch.models.tfhe import tggsw, tglwe, tlwe
    from learn_fhe_tpu_torch.ops import ntt32 as tntt
    from learn_fhe_tpu_torch.ops import torus_crt as tcrt
    from learn_fhe_tpu_torch.parallel.batch import PBS_CHUNK, tfhe_pbs_batch
    from learn_fhe_tpu_torch.utils import kernels
    from learn_fhe_tpu_torch.utils.interop import u32_to_torch, u64_to_torch

    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    tag = f"[{card}]"
    sm_mhz = float(smi("clocks.max.sm"))
    pipe_per_s = SMS * PIPE_LANES * sm_mhz * 1e6
    say(f"{tag} max SM clock {sm_mhz:.0f} MHz: {pipe_per_s / 1e12:.3f} T int32 instructions/s per pipe (FMA, ALU), issue {2 * pipe_per_s / 1e12:.3f} T/s; memory {HBM_BYTES_PER_S / 1e12:.2f} TB/s")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    say(f"{tag} kernel build + load: {time.perf_counter() - t0:.1f} s")
    report = kernels.ptxas_report(kernels.build_log())
    for name, (regs, st, ld) in sorted(report.items()):
        if name.endswith("<11>") or "<" not in name or name == FHEW_INSTANCE:  # N=2048, Garner, FHEW's N=512, the u64 kernels
            say(f"  ptxas: {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
    if not {"ntt32_fwd_kernel<11>", "negacyclic_mul32_kernel<11>", FHEW_INSTANCE, *MK_INSTANCES} <= report.keys():
        raise AssertionError("build.log shows no N=2048 instance of K-NTT or K-POLYMUL, no N=512 instance of K-FHEW-BR, or no u64 kernel")

    # -- 3. NTT, inverse NTT, polymul, Garner vs plain, at keygen's shapes -----
    cfg = REFERENCE
    params = tfhe.BootstrapParams(
        tfhe.TlweParams(log_p=cfg["log_p"], padding=1, n=cfg["n"], std_dev=cfg["tlwe_std"], log_b=4, d=5),
        tfhe.TggswParams(
            tfhe.TglweParams(log_p=cfg["log_p"], padding=1, big_n=cfg["big_n"], k=1, std_dev=cfg["tglwe_std"]),
            log_b=23,
            d=1,
        ),
    )
    n_big, rows = params.big_n, 2 * params.tlwe.n  # keygen transforms n * R rows
    step_plan = tggsw._crt_plan(params.tggsw)
    key_plan = tcrt.torus_crt_plan(n_big, tcrt.required_bound_bits(n_big, 2, 1))
    rng = np.random.default_rng(1)
    errs: dict[str, float] = {}

    def residues(plan):
        return u32_to_torch(np.stack([rng.integers(0, q, size=(rows, n_big), dtype=np.uint32) for q in plan.primes]))

    def check_ntt(x, y, plans):
        for i, p in enumerate(plans):
            for name, got, want in (
                ("ntt32", tntt.ntt32(x[i].to(dev), p), lambda: tntt.ntt32_ref(x[i], p)),
                ("intt32", tntt.intt32(x[i].to(dev), p), lambda: tntt.intt32_ref(x[i], p)),
                ("negacyclic_mul32", tntt.negacyclic_mul32(x[i].to(dev), y[i].to(dev), p), lambda: tntt.negacyclic_mul32_ref(x[i], y[i], p)),
            ):
                errs[name] = max(errs.get(name, 0.0), max_abs_err(got, want()))

    x = residues(step_plan)
    a, b = residues(key_plan), residues(key_plan)
    check_ntt(x, x.flip(1), step_plan.plans)
    check_ntt(a, b, key_plan.plans)
    say(f"ntt32 / intt32 / negacyclic_mul32 == plain on ({rows}, {n_big}) under each of the {step_plan.k} step and {key_plan.k} keygen primes: ok")
    # a ragged last block: at N=256 a block holds 8 rows, and 19 rows leave 3 in the last
    small_plan = tcrt.torus_crt_plan(256, tcrt.required_bound_bits(256, 23, 2))
    xs = u32_to_torch(np.stack([rng.integers(0, q, size=(2, 19, 256), dtype=np.uint32) for q in small_plan.primes]))
    check_ntt(xs[:, 0], xs[:, 1], [tntt.ntt32_plan(q, 256) for q in small_plan.primes])
    say(f"ntt32 / intt32 / negacyclic_mul32 == plain on (19, 256), a ragged last block, under each of {small_plan.k} primes: ok")
    errs["garner_to_u64"] = max_abs_err(tcrt.garner_to_u64(a.to(dev), key_plan), tcrt.garner_to_u64_ref(a, key_plan))
    say(f"garner_to_u64 == plain on ({key_plan.k}, {rows}, {n_big}): ok")

    # -- 4. the main path ------------------------------------------------------
    counted = (
        tntt.ntt32, tntt.intt32, tntt.negacyclic_mul32, tcrt.garner_to_u64, tggsw.cmux_rotate, tggsw.blind_rotate_steps,
    )  # fmt: skip
    rng = np.random.default_rng(0)
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    z = tlwe.sk_gen(params.tlwe, rng)
    key = tfhe.key_gen(params, z, rng, dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    tab = u64_to_torch(tfhe.lut_table(params.tlwe.log_p, n_big, lambda v: v), dev)
    ms = torch.from_numpy(rng.integers(0, params.tlwe.p, size=BATCH)).to(dev)
    cts = tlwe.sk_encrypt(params.tlwe, z, tlwe.encode(params.tlwe, ms), rng)
    t0 = time.perf_counter()
    out = tfhe_pbs_batch(params, key, tab, cts)
    torch.cuda.synchronize()
    first_pbs_s = time.perf_counter() - t0
    got = tlwe.decode(params.tlwe, tlwe.decrypt(params.tlwe, z, out))
    launches = {fn.__name__: fn.launches for fn in counted}
    say(f"{tag} keygen {keygen_s * 1e3:.1f} ms (host clock, to a sync); first PBS batch of {BATCH} {first_pbs_s:.2f} s; launches {launches}")
    if out.a.shape != (BATCH, params.tlwe.n) or out.b.shape != (BATCH,):
        raise AssertionError(f"PBS output shapes {tuple(out.a.shape)}, {tuple(out.b.shape)}")
    n_ok = int((got == ms).sum())
    say(f"PBS identity LUT: {n_ok}/{BATCH} messages decrypt back")
    if n_ok != BATCH:
        raise AssertionError("PBS output failed decryption")
    chunks = -(-BATCH // PBS_CHUNK)
    if launches["blind_rotate_steps"] != params.tlwe.n * chunks:
        raise AssertionError(f"step kernel launched {launches['blind_rotate_steps']} times, expected {params.tlwe.n * chunks}")
    launches["tfhe_step"] = launches["blind_rotate_steps"]
    for name in ("ntt32", "negacyclic_mul32", "garner_to_u64"):
        if launches[name] == 0:
            raise AssertionError(f"{name} kernel was not launched on the main path")

    # -- 5. step kernel vs plain at batch 128, and the first 4 PBS vs the CPU --
    a2n, b2n = tfhe.mod_switch_2n(cts, n_big)
    acc = tglwe.rotate(
        tglwe.TglweCiphertext(torch.zeros((BATCH, 1, n_big), dtype=torch.int64, device=dev), tglwe.encode(params.tglwe, tab).expand(BATCH, n_big)),
        (-b2n) % (2 * n_big),
    )
    exps0 = a2n[:, 0].contiguous()
    key0 = tggsw.TggswEval(*(t[0] for t in key.brk))
    cpu = lambda ct: tglwe.TglweCiphertext(ct.a.cpu().clone(), ct.b.cpu().clone())  # noqa: E731
    want = tggsw.cmux_rotate_ref(
        params.tggsw, tggsw.TggswEval(*(t.cpu() for t in key0)), cpu(acc), exps0.cpu(), key.mon_v.cpu(), key.mon_d.cpu()
    )
    got_step = tggsw.cmux_rotate(params.tggsw, key0, tglwe.TglweCiphertext(acc.a.clone(), acc.b.clone()), exps0, key.mon_v, key.mon_d)
    errs["tfhe_step"] = max(max_abs_err(got_step.a, want.a), max_abs_err(got_step.b, want.b))
    say(f"cmux_rotate == plain at batch {BATCH}, N={n_big}, real key: ok")
    exps_all = a2n.t().contiguous()  # (n, B)
    brk_l = tggsw.TggswEval(*(t[:LOOP_CHECK] for t in key.brk))
    want = tggsw.blind_rotate_steps(
        params.tggsw, tggsw.TggswEval(*(t.cpu() for t in brk_l)), cpu(acc), exps_all[:LOOP_CHECK].cpu(), key.mon_v.cpu(), key.mon_d.cpu()
    )
    got_l = tggsw.blind_rotate_steps(
        params.tggsw, brk_l, tglwe.TglweCiphertext(acc.a.clone(), acc.b.clone()), exps_all[:LOOP_CHECK], key.mon_v, key.mon_d
    )
    errs["tfhe_step"] = max(errs["tfhe_step"], max_abs_err(got_l.a, want.a), max_abs_err(got_l.b, want.b))
    say(f"blind_rotate_steps == the plain loop over {LOOP_CHECK} steps at batch {BATCH}, real key: ok")

    t0 = time.perf_counter()
    key_cpu = tfhe.BootstrapKey(
        tggsw.TggswEval(*(t.cpu() for t in key.brk)),
        tlwe.TlweKeySwitchingKey(key.ksk.a.cpu(), key.ksk.b.cpu()),
        key.mon_v.cpu(),
        key.mon_d.cpu(),
    )
    sub = tlwe.TlweCiphertext(cts.a[:CPU_CHECK].cpu(), cts.b[:CPU_CHECK].cpu())
    ref_out = tfhe_pbs_batch(params, key_cpu, tab.cpu(), sub)
    if not (torch.equal(ref_out.a, out.a[:CPU_CHECK].cpu()) and torch.equal(ref_out.b, out.b[:CPU_CHECK].cpu())):
        raise AssertionError("PBS on the card differs from the plain path on the CPU")
    say(f"first {CPU_CHECK} PBS outputs == the plain path on the CPU, bit for bit ({time.perf_counter() - t0:.1f} s)")

    # -- 6. timing -------------------------------------------------------------
    reps = 3
    pbs_ms = cuda_ms(lambda: tfhe_pbs_batch(params, key, tab, cts), reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tfhe_pbs_batch(params, key, tab, cts)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    say(f"{tag} PBS batch {BATCH}: {pbs_ms:.3f} ms per batch = {BATCH / pbs_ms * 1e3:.2f} PBS/s (CUDA events, {reps} reps)")
    say(f"{tag} PBS batch {BATCH}: host enqueue {host_s * 1e3:.3f} ms per batch (C loop of {params.tlwe.n} steps), wall with sync {wall_s * 1e3:.3f} ms")
    v_enc = tglwe.encode(params.tglwe, tab)
    br_ms = cuda_ms(lambda: tfhe.blind_rotate(params, key, v_enc, a2n, b2n), reps)
    ext = tglwe.sample_extract(params.tglwe, tfhe.blind_rotate(params, key, v_enc, a2n, b2n), 0)
    ks_ms = cuda_ms(lambda: tlwe.key_switch(params.tlwe, key.ksk, ext), 10)
    say(f"{tag} PBS batch {BATCH}: blind rotation {br_ms:.3f} ms, key switch {ks_ms:.3f} ms (CUDA events)")
    idle, kernel_ms, top = device_kernel_ms(lambda: tfhe_pbs_batch(params, key, tab, cts))
    if kernel_ms:
        say(f"{tag} PBS batch {BATCH}: device idle share {idle:.4f} (profiler, union of kernel intervals); summed kernel time {kernel_ms:.3f} ms, which counts a step kernel's wait for its predecessor")
        for name, t, count in top:
            say(f"  {t:10.3f} ms  {count:6d} x  {name[:100]}")
    else:
        say(f"{tag} device kernel time and idle share: not measured (the profiler recorded no device activity)")

    scratch = tglwe.TglweCiphertext(acc.a.clone(), acc.b.clone())
    timings = {}
    n_steps = params.tlwe.n

    def steps_kernel():
        tggsw.blind_rotate_steps(params.tggsw, key.brk, scratch, exps_all, key.mon_v, key.mon_d)

    def step_plain():
        tggsw.cmux_rotate_ref(params.tggsw, key0, scratch, exps0, key.mon_v, key.mon_d)

    timings["tfhe_step"] = (cuda_ms(steps_kernel, reps) / n_steps, cuda_ms(step_plain, 5))
    rows_read = float(np.mean([torch.unique(exps_all[i] % (2 * n_big)).numel() for i in range(n_steps)]))
    k_s = step_plan.k
    step_bytes = 2 * BATCH * 2 * n_big * 8 + BATCH * 8 + 4 * k_s * 2 * n_big * 4 + 2 * k_s * n_big * 4 * rows_read
    st_ops = step_ops(BATCH, n_big, k_s)
    bounds = {"tfhe_step": bound_ms(step_bytes, st_ops, pipe_per_s)}
    t0 = time.perf_counter()
    steps_kernel()
    enqueue_us = (time.perf_counter() - t0) / n_steps * 1e6
    torch.cuda.synchronize()
    st_ms, (st_b, st_by) = timings["tfhe_step"][0], bounds["tfhe_step"]
    say(f"{tag} step kernel at batch {BATCH}: {st_ms * 1e3:.2f} us per step (CUDA events over {reps} x {n_steps} steps of the C loop), bound {st_b * 1e3:.2f} us by {st_by} (instructions {st_ops[0] / 1e6:.1f} M FMA, {st_ops[1] / 1e6:.1f} M ALU, {st_ops[2] / 1e6:.1f} M either; bytes {step_bytes / 1e6:.1f} MB) = {st_b / st_ms:.4f} of bound; host enqueue {enqueue_us:.2f} us per step; plain on CUDA tensors {timings['tfhe_step'][1] * 1e3:.2f} us")

    xd, ad, bd = x[0].to(dev), a[0].to(dev), b[0].to(dev)
    p0, k0 = step_plan.plans[0], key_plan.plans[0]
    ag = a.to(dev)
    keygen_kernels = {  # the kernel's wrapper and its plain version on the same inputs
        "ntt32": (lambda: tntt.ntt32(xd, p0), lambda: tntt.ntt32_ref(xd, p0)),
        "intt32": (lambda: tntt.intt32(xd, p0), lambda: tntt.intt32_ref(xd, p0)),
        "negacyclic_mul32": (lambda: tntt.negacyclic_mul32(ad, bd, k0), lambda: tntt.negacyclic_mul32_ref(ad, bd, k0)),
        "garner_to_u64": (lambda: tcrt.garner_to_u64(ag, key_plan), lambda: tcrt.garner_to_u64_ref(ag, key_plan)),
    }
    graphs = {}
    for name, (kernel, plain) in keygen_kernels.items():
        timings[name] = (cuda_ms(kernel, 50), cuda_ms(plain, 3))
        graphs[name] = graph_ms(kernel, 50)
    row_bytes = rows * n_big * 4
    bounds["ntt32"] = bound_ms(2 * row_bytes, ntt_ops(rows, n_big), pipe_per_s)
    bounds["intt32"] = bound_ms(2 * row_bytes, ntt_ops(rows, n_big) + rows * n_big * SHOUP, pipe_per_s)
    bounds["negacyclic_mul32"] = bound_ms(3 * row_bytes, 3 * ntt_ops(rows, n_big) + 2 * rows * n_big * SHOUP, pipe_per_s)
    bounds["garner_to_u64"] = bound_ms(key_plan.k * row_bytes + rows * n_big * 8, rows * n_big * garner_ops(key_plan.k), pipe_per_s)
    for name, (k_ms, p_ms) in timings.items():
        b_ms, by = bounds[name]
        say(f"{tag} {name}: kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound {b_ms * 1e3:.2f} us by {by} = {b_ms / k_ms:.4f} of bound")
        if name in graphs:
            g_ms = graphs[name]
            say(f"  {name}: the kernel's {k_ms * 1e3:.2f} us is per wrapper call (CUDA events over 50 eager calls, host time included); the same 50 launches replayed from a CUDA graph take {g_ms * 1e3:.2f} us each = {b_ms / g_ms:.4f} of bound")

    fhew_phases(dev, tag, pipe_per_s, errs, timings, bounds, launches)
    multikey_phases(dev, tag, pipe_per_s, errs, timings, bounds, launches, graphs)

    src = "learn_fhe_tpu_torch/csrc/"
    table = [
        ("ntt32", "ntt32.cu", "bench/pallas_ntt14_experiment.py:166"),
        ("intt32", "ntt32.cu", "bench/pallas_ntt14_experiment.py:183"),  # the polymul's inverse half
        ("negacyclic_mul32", "ntt32.cu", "bench/pallas_ntt14_experiment.py:183"),
        ("garner_to_u64", "torus_crt.cu", "bench/pallas_step_experiment.py:202"),
        ("tfhe_step", "tfhe_step.cu", "bench/pallas_step_experiment.py:202"),
        ("fhew_blind_rotate", "fhew_blind_rotate.cu", "learn_fhe_tpu/models/fhew/bootstrapping.py:423 (XLA scan; no Pallas call)"),
        ("ntt64", "ntt64.cu", "learn_fhe_tpu/ops/ntt.py:135 (XLA fusion; no Pallas call)"),
        ("intt64", "ntt64.cu", "learn_fhe_tpu/ops/ntt.py:189 (XLA fusion; no Pallas call)"),
        ("negacyclic_mul64", "ntt64.cu", "learn_fhe_tpu/ops/ntt.py:261 (XLA fusion; no Pallas call)"),
        ("external_product64", "fhew_u64.cu", "learn_fhe_tpu/models/fhew/rgsw.py:154 (u64 external product, XLA fusion; no Pallas call)"),
        ("fhew_blind_rotate64", "fhew_u64.cu", "learn_fhe_tpu/models/fhew/bootstrapping.py:436 (u64 branch of the XLA scan; no Pallas call)"),
    ]
    say(
        json.dumps(
            {
                "kernels": [
                    {
                        "name": name,
                        "route": "cuda",
                        "source": src + file,
                        "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": errs[name],
                        "ms": timings[name][0],
                        "graph_ms": graphs.get(name),  # the 50 launches replayed from a CUDA graph
                        "plain_ms": timings[name][1],
                        "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1],
                        "library_ms": None,  # no PyTorch call computes any of these
                    }
                    for name, file, replaces in table
                ]
            }
        )
    )
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
