#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU, and check it.

The path is the TFHE programmable bootstrap at the reference fixture (TLWE
n=1024, B=2^4, d=5; TGGSW N=2048, k=1, B=2^23, d=1) at batch 128, through
`learn_fhe_tpu_torch`:

  1. require a CUDA device; print its name and power limit;
  2. build the hand-written kernels from `learn_fhe_tpu_torch/csrc/` (nvcc, sm_90a);
  3. hold the NTT, inverse NTT, polymul and Garner kernels against their
     plain PyTorch versions (on a CPU copy of the same inputs) at the shapes
     key generation gives them, with `torch.equal`;
  4. the main path: key generation from seed 0, 128 encryptions,
     `tfhe_pbs_batch` with the identity LUT, decryption of all 128; the
     kernels' launch counters are read around this run;
  5. hold the step kernel against its plain version at batch 128 with the
     real key, and the first 4 bootstraps against the whole plain path on
     the CPU (bit-identical ciphertexts);
  6. time the PBS and each kernel against its plain version with CUDA events.

Every number is printed beside the card's name and power limit. The line
before the last is {"kernels": [...]}; the last line is the contract line
{"ok": true, "device": {...}}. Any failure exits non-zero without it, and so
does a machine without a CUDA device.

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


def say(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout  # fmt: skip
    return out.strip().splitlines()[0].strip()


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


def device_kernel_ms(fn) -> tuple[float, list[tuple[str, float]]]:
    """Total device time of the kernels one call of fn runs (torch.profiler),
    and the five largest by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [
        (e.key, e.self_device_time_total / 1e3)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r[1])
    return sum(t for _, t in rows), rows[:5]


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

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    say(f"{tag} kernel build + load: {time.perf_counter() - t0:.1f} s")
    for line in kernels.build_log().splitlines():
        if "Function properties" in line or "Used" in line or "spill" in line:
            say("  ptxas:", line.strip())

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

    x = residues(step_plan)
    for i, p in enumerate(step_plan.plans):
        e_f = max_abs_err(tntt.ntt32(x[i].to(dev), p), tntt.ntt32_ref(x[i], p))
        e_i = max_abs_err(tntt.intt32(x[i].to(dev), p), tntt.intt32_ref(x[i], p))
        errs["ntt32"] = max(errs.get("ntt32", 0.0), e_f)
        errs["intt32"] = max(errs.get("intt32", 0.0), e_i)
    say(f"ntt32 / intt32 == plain on ({rows}, {n_big}) under each of {step_plan.k} primes: ok")
    a, b = residues(key_plan), residues(key_plan)
    for i, p in enumerate(key_plan.plans):
        e = max_abs_err(tntt.negacyclic_mul32(a[i].to(dev), b[i].to(dev), p), tntt.negacyclic_mul32_ref(a[i], b[i], p))
        errs["negacyclic_mul32"] = max(errs.get("negacyclic_mul32", 0.0), e)
    say(f"negacyclic_mul32 == plain on ({rows}, {n_big}) under each of {key_plan.k} keygen primes: ok")
    errs["garner_to_u64"] = max_abs_err(tcrt.garner_to_u64(a.to(dev), key_plan), tcrt.garner_to_u64_ref(a, key_plan))
    say(f"garner_to_u64 == plain on ({key_plan.k}, {rows}, {n_big}): ok")

    # -- 4. the main path ------------------------------------------------------
    counted = (tntt.ntt32, tntt.intt32, tntt.negacyclic_mul32, tcrt.garner_to_u64, tggsw.cmux_rotate)
    for fn in counted:
        fn.launches = 0
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
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
    say(f"{tag} keygen {keygen_s:.2f} s; first PBS batch of {BATCH} {first_pbs_s:.2f} s; launches {launches}")
    if out.a.shape != (BATCH, params.tlwe.n) or out.b.shape != (BATCH,):
        raise AssertionError(f"PBS output shapes {tuple(out.a.shape)}, {tuple(out.b.shape)}")
    n_ok = int((got == ms).sum())
    say(f"PBS identity LUT: {n_ok}/{BATCH} messages decrypt back")
    if n_ok != BATCH:
        raise AssertionError("PBS output failed decryption")
    chunks = -(-BATCH // PBS_CHUNK)
    if launches["cmux_rotate"] != params.tlwe.n * chunks:
        raise AssertionError(f"step kernel launched {launches['cmux_rotate']} times, expected {params.tlwe.n * chunks}")
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
    errs["cmux_rotate"] = max(max_abs_err(got_step.a, want.a), max_abs_err(got_step.b, want.b))
    say(f"cmux_rotate == plain at batch {BATCH}, N={n_big}, real key: ok")

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
    say(f"{tag} PBS batch {BATCH}: host enqueue {host_s * 1e3:.3f} ms, wall with sync {wall_s * 1e3:.3f} ms")
    v_enc = tglwe.encode(params.tglwe, tab)
    br_ms = cuda_ms(lambda: tfhe.blind_rotate(params, key, v_enc, a2n, b2n), reps)
    ext = tglwe.sample_extract(params.tglwe, tfhe.blind_rotate(params, key, v_enc, a2n, b2n), 0)
    ks_ms = cuda_ms(lambda: tlwe.key_switch(params.tlwe, key.ksk, ext), 10)
    say(f"{tag} PBS batch {BATCH}: blind rotation {br_ms:.3f} ms, key switch {ks_ms:.3f} ms (CUDA events)")
    kernel_ms, top = device_kernel_ms(lambda: tfhe_pbs_batch(params, key, tab, cts))
    if kernel_ms:
        say(f"{tag} PBS batch {BATCH}: device kernel time {kernel_ms:.3f} ms (profiler) = {kernel_ms / pbs_ms:.4f} of the batch's {pbs_ms:.3f} ms")
        for name, t in top:
            say(f"  {t:10.3f} ms  {name[:100]}")
    else:
        say(f"{tag} device kernel time: not measured (the profiler recorded no device activity)")

    scratch = tglwe.TglweCiphertext(acc.a.clone(), acc.b.clone())
    timings = {}

    def step_kernel():
        tggsw.cmux_rotate(params.tggsw, key0, scratch, exps0, key.mon_v, key.mon_d)

    def step_plain():
        tggsw.cmux_rotate_ref(params.tggsw, key0, scratch, exps0, key.mon_v, key.mon_d)

    timings["cmux_rotate"] = (cuda_ms(step_kernel, 200), cuda_ms(step_plain, 5))
    t0 = time.perf_counter()
    for _ in range(params.tlwe.n):
        step_kernel()
    enqueue_us = (time.perf_counter() - t0) / params.tlwe.n * 1e6
    torch.cuda.synchronize()
    say(f"{tag} step: kernel {timings['cmux_rotate'][0] * 1e3:.2f} us, plain on CUDA tensors {timings['cmux_rotate'][1] * 1e3:.2f} us, host enqueue {enqueue_us:.2f} us per step")

    xd, ad, bd = x[0].to(dev), a[0].to(dev), b[0].to(dev)
    p0, k0 = step_plan.plans[0], key_plan.plans[0]
    timings["ntt32"] = (cuda_ms(lambda: tntt.ntt32(xd, p0), 50), cuda_ms(lambda: tntt.ntt32_ref(xd, p0), 3))
    timings["intt32"] = (cuda_ms(lambda: tntt.intt32(xd, p0), 50), cuda_ms(lambda: tntt.intt32_ref(xd, p0), 3))
    timings["negacyclic_mul32"] = (
        cuda_ms(lambda: tntt.negacyclic_mul32(ad, bd, k0), 50),
        cuda_ms(lambda: tntt.negacyclic_mul32_ref(ad, bd, k0), 3),
    )
    ag = a.to(dev)
    timings["garner_to_u64"] = (
        cuda_ms(lambda: tcrt.garner_to_u64(ag, key_plan), 50),
        cuda_ms(lambda: tcrt.garner_to_u64_ref(ag, key_plan), 3),
    )
    for name, (k_ms, p_ms) in timings.items():
        say(f"{tag} {name}: kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us per call")

    src = "learn_fhe_tpu_torch/csrc/"
    table = [
        ("ntt32", "ntt32.cu", "bench/pallas_ntt14_experiment.py:166"),
        ("negacyclic_mul32", "ntt32.cu", "bench/pallas_ntt14_experiment.py:183"),
        ("garner_to_u64", "torus_crt.cu", "bench/pallas_step_experiment.py:202"),
        ("cmux_rotate", "tfhe_step.cu", "bench/pallas_step_experiment.py:202"),
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
                        "plain_ms": timings[name][1],
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
