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
        if name.endswith("<11>") or "<" not in name:  # the N=2048 instances, and Garner
            say(f"  ptxas: {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads")
    if not {"ntt32_fwd_kernel<11>", "negacyclic_mul32_kernel<11>"} <= report.keys():
        raise AssertionError("build.log shows no N=2048 instance of K-NTT or K-POLYMUL")

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

    src = "learn_fhe_tpu_torch/csrc/"
    table = [
        ("ntt32", "ntt32.cu", "bench/pallas_ntt14_experiment.py:166"),
        ("intt32", "ntt32.cu", "bench/pallas_ntt14_experiment.py:183"),  # the polymul's inverse half
        ("negacyclic_mul32", "ntt32.cu", "bench/pallas_ntt14_experiment.py:183"),
        ("garner_to_u64", "torus_crt.cu", "bench/pallas_step_experiment.py:202"),
        ("tfhe_step", "tfhe_step.cu", "bench/pallas_step_experiment.py:202"),
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
