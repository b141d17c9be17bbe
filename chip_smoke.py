#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU, and check it.

The path is the TFHE programmable bootstrap at the reference fixture (TLWE
n=1024, B=2^4, d=5; TGGSW N=2048, k=1, B=2^23, d=1) at batch 128, through
`learn_fhe_tpu_torch`:

  1. require a CUDA device; print its name and power limit;
  2. build the hand-written kernels from `learn_fhe_tpu_torch/csrc/` (nvcc, sm_90a)
     and print the registers, spills and stack frames of their N=2048
     instances (ptxas);
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

  M1. hold K-NTT64 (`ntt64`, and `ntt64_mont`, its Montgomery output),
      intt64 and K-POLYMUL64 against their plain versions at the 55-bit
      prime on (10, 2048) (one RGSW's rows), a ragged (19, 256) and key
      generation's (6000, 2048), the three transforms also at 5 and 600
      rows, and K-POLYMUL64 at every row count the multi-key path launches
      it at (1, 5, 8, 6000: its N=2048 instance; the ragged (19, 256) runs
      the one for any N); time each kernel at the shapes the path launches
      it at (K-POLYMUL64 at 1, 5, 8 and 6000 rows, `ntt64` and `ntt64_mont`
      at 5, 600 and 6000, intt64 at 6000) against its bound;
  M2. hold K-EXTPROD64 against its plain version at one merge chunk (60
      keys, 600 products), at 601 products and as a key switch; time it
      at the chunk;
  M3. hold K-FHEW-BR64 against its plain version at the 54-bit multi-key
      test fixture (N=128, 2d=18) at a batch that makes the wrapper pick
      each cluster size it can (1-8 blocks per ciphertext) and at batch
      128, at the full set (random key rows) at batches that pick 2-5 and
      at batch 2, and at a 63-bit prime (the eager instance); the error
      word must read 0;
  M4. the main path, with the launch counters set to 0 just before and
      read just after (K-NTT64's, intt64's and K-POLYMUL64's also by row
      count, K-EXTPROD64's by product count, each printed with its
      launches x (time - bound) where M1 or M2 timed that shape; the path
      converts keys into the evaluation basis by `ntt64_mont` alone, so
      plain `ntt64` must not launch): crs and pk shares, each party's key
      share, the merge (each timed), two u8 pk-encrypted (a=177, b=7), ((a+b)*(a-b)/a)%b in
      wrapping u8, gate round by gate round, and its threshold decryption,
      which must give the expected value (wall time and rounds printed,
      and the rounds by gates per round and by the cluster size they
      took), and a NAND batch of 128 at the full set, which must decrypt
      to the truth table; K-FHEW-BR64 counts its launches in clusters
      (C > 1) and alone (C = 1) apart, and each must be launched. Then:
      gates/s (median and spread of 5 calls), K-FHEW-BR64's time at batch
      1, 2, 8, 36 and 128 of its schedule with the cluster size each took;
      the clustered instance at batch 2 (a round of two gates) and the
      single-block one at 128, each against its bound and its plain
      version; the walk's device time at 128 and the device's idle share;
      the path's conversions into the evaluation basis whole
      (`rlwe._to_eval_mont` at 5 rows, `rgsw.to_eval` at a merge chunk and
      at the final 6000 rows), eager and from a CUDA graph.

Then CKKS up to its key switch on the RNS u64 engine, at the JAX package's
CKKS metric (`bench.py:657-700`: N=2^13, L=8 q-primes and 8 p-primes of 55
bits, one key-switch digit) at batch 16 (`bench/ckks_profile.py`):

  C1. hold K-RNS-NTT (forward and inverse; on (16, 8, 8192) over the
      q-primes and on (16, 16, 8192) over q + p, the inverse also on the
      key switch's (2, 16, 16, 8192)), K-RNS-MAC (1 and 2 terms, and the key
      switch's two sums against a key broadcast over the batch), the same
      three sums inside the inverse transform (`rns_intt_mac`, the path's),
      K-BASECONV (8 -> 8) and K-RESCALE (k = 1, and k = 8 after K-BASECONV
      of the dropped limbs) against their plain versions, `torch.equal`,
      each wrapper's launch counter rising by one a call; time each
      over 20 eager wrapper calls and over 20 launches replayed from a CUDA
      graph against its bound, the transforms and K-BASECONV also from a
      graph whose launches take their inputs from more copies than the
      50 MB L2 holds (cold L2), and print each instance's registers,
      spills and stack frame;
  C2. the Rust reference transcript (`tests/vectors/rust_dump/ckks_*`, N=512,
      L=8) on the card: mul + relinearize + rescale, rotate and conjugate
      must equal the reference's ciphertexts bit for bit;
  C3. the main path: key generation on the card (rlk, one rotation key,
      cjk), 2 x 16 messages encoded and sk_encrypted, one batch-16 `mul`
      with the launch counters set to 0 just before and read just after
      (K-RNS-NTT, `rns_intt_mac`, K-BASECONV and K-RESCALE must launch, the
      MAC and the inverse transform alone must not; the counts printed by
      row count); the 16 products must decode within the budget
      `tests/test_ckks_large.py` holds at log_n=13, and the first ciphertext
      of the batch must equal the port's CPU path's after mul, rotate and
      conjugate; then muls/s at batch 16 and 1 (median and spread of 5
      calls), the host enqueue time against the wall time, and the device's
      idle share (profiler);
  C4. `learn_fhe_tpu_torch/examples/ckks_logistic.py` at its default ring
      on the card: the classifications must agree.

Then the CKKS bootstrap (mod_raise, CoeffToSlot, EvalMod, SlotToCoeff) at
the JAX package's bootstrap metric (`bench.py:714-778` at --log-n 13: N=2^13,
L=23 q-primes and 23 p-primes of 55 bits, one key-switch digit, a sparse
ternary secret of weight 64, r=3, EvalModParams(k=24, r=4, degree=34),
batch 2 from seed 17, messages x 1e-4):

  B1. hold K-RNS-MAC's gathered instances against their plain versions at
      the bootstrap's shapes: W[j] (`rns_mac`, a digit of the hoisted mask
      (2, 46, 8192) through sigma_j, the key's b and a sums) and
      `rns_intt_mac` with 1-4 terms and z, through each of the path's 22
      rotations' permutations and the identity, and b's sums (2, 23, 8192)
      of 2-4 terms with one read in place, each with one x in every term
      (the shared-x instances, which the wrapper must take) and with
      distinct x (which it must not); K-AUTOMORPH on b and a (2, 23, 8192) for
      each rotation and t = -1; K-BASECONV from one limb into 22 (mod_raise)
      and from every level 1..23 into the 23 p-primes (the hoists);
      K-RNS-NTT at 46 and 23 limbs; K-RESCALE at k=1 and k=23; all with
      `torch.equal`, each wrapper's counter rising by one a call; time
      each over 20 eager calls and from a CUDA graph of 20 against its
      bound (the gathered sums at 23 and 5 limbs beside `rns_intt` at the
      same rows, and at 23 with distinct x), and print the bootstrap's
      instances' registers, spills and stack;
  B2. the bootstrap at N=16, L=16 (r=3, default EvalModParams, batch 2,
      seed 17) on the card == the port's CPU path, bit for bit;
  B3. the path: key generation on the card, timed (it must launch the
      kernels); one cold bootstrap of the batch of 2; one warm one with the
      launch counters set to 0 just before and read just after, printed by
      shape, the gathered `rns_intt_mac` apart by (rows, terms) (it, its
      shared-x instance, K-AUTOMORPH, K-BASECONV at lq = 1, K-RNS-NTT,
      K-RESCALE and the key switches' `rns_intt_mac` must launch); at
      least 2 levels left and more than 16 relative bits for
      each decrypted ciphertext (`tests/test_ckks_bootstrap.py::
      test_full_bootstrap_n8192`); then 3 warm bootstraps (median and
      spread of seconds per ciphertext, bootstraps/s), the host enqueue
      against the wall, a warm bootstrap from a CUDA graph (device only),
      the device's idle share and top kernels (profiler).

Then the certified production bootstrap, `production_config(16)` (N=2^16,
L=30 q-primes on the ladder 55 | 52 x 4 | 52 x 3 | 56 x 19 | 52 x 3, two
59-bit p-primes, dnum 15 digits of 2 primes, a dense ternary secret, K=314,
r=8, a degree-30 Chebyshev with the arcsine, 38 rotation keys; 128.6 bits
by the HES tables), as `bench/production_bootstrap_probe.py` runs it:

  P1. hold K-RNS-NTT past N=2^13 (its clusters of 8 blocks), the inverse,
      `rns_intt_mac` with 1, 2 and 15 terms (the key switch's digits, with
      z), the gathered `rns_intt_mac` (one x, which takes the distinct-x
      instance past 2^13) and `rns_mac` (W[j]), K-BASECONV 1 -> 29 and
      2 -> 30, K-RESCALE at k=1 and k=2 and K-AUTOMORPH against their plain
      versions at the production shapes, `torch.equal`, each wrapper's
      counter rising by one a call; time each eager and from a CUDA graph
      against its bound, with the registers and spills of the 2^16
      instances;
  P2. the path: keys from seed 2026 (the dense secret, rlk, cjk, then the
      rotation keys with `rtk_gen_many` in groups of 4 in sorted index
      order), their seconds split into host draws, host -> device copies
      and device work; a message of amplitude 0.3 encoded at (q0,) with
      scale 2^52 and sk-encrypted; mod_raise, coeff_to_slot, eval_mod and
      slot_to_coeff each timed to a sync, cold and warm (the warm run with
      the launch counters set to 0 just before and read just after, by
      shape; K-RNS-NTT, the key switches' and the gathered `rns_intt_mac`,
      the gathered `rns_mac`, K-BASECONV at lq = 1, K-RESCALE and
      K-AUTOMORPH must launch, the shared-x instance must not); 5 levels
      left, consumed = predicted = 25, at least 14 relative bits; 4 user
      squarings, at least 10 bits; the JAX package's record for the same
      seed and knobs (15.7 / 14.1 bits) printed beside them; the peak
      device memory and the device's idle share (profiler).

Then BGV at a deployment's size, `BgvParams(log_n=14, t=65537, log_qi=45,
big_l=4)` (N=2^14, 4 q-primes + 4 p-primes of 45 bits, 165.5 bits by
`utils/security.estimate`), batch 16 from seed 17:

  G1. hold K-BGV-DROP (`ops/rns.py::drop_limbs_t`) against its plain
      version at N=2^14 on b and a of a batch of 16 in one launch: the key
      switch's division by P (8 limbs, k=4), a mul's whole drop (k=4, the
      add of d0 and d1, one more drop), a rotation's (k=4, the permuted b
      added after the drops), mod_switch (4 limbs, k=1), and 5 limbs at k=1
      and k=4, `torch.equal`, the wrapper's counter rising by
      one a call; time each over 20 eager calls and from a CUDA graph of 20
      against its bound, with the instances' registers and spills;
  G2. the path: keys on the card (pk, rlk, rotation keys for j = 1 and 7,
      cjk; seconds by part), 6 x 16 messages encoded and pk_encrypted; with
      the launch counters set to 0 just before and read just after, a mul
      chain to depth 3 with fresh operands brought down by mod_switch,
      rotate by 1 and 7, conjugate, and mul_plain, mod_switch, add_plain
      (K-RNS-NTT, `rns_intt_mac`, K-BASECONV, K-AUTOMORPH and K-BGV-DROP must
      launch; `rns_intt`, `rns_mac` and K-RESCALE must not); every slot of
      every ciphertext must decrypt exactly to the numpy oracle mod t; one
      batch-16 mul's launches by shape; its first ciphertext == the port's
      CPU path; muls/s at batch 16 and 1 (median and spread of 5 calls),
      the host enqueue against the wall, a CUDA graph's device time and the
      device's idle share (profiler over 20 muls; "not measured" where its
      records sum to less than 0.9 of the graph's kernel time).

Then the TFHE reference-order PBS (T1): `bootstrap(..., parity=True)` at the
reference fixture, unbatched, on 4 messages through the identity LUT (each
must decrypt right; seconds per PBS; K-NTT, `intt32` and K-GARNER must
launch, K-STEP must not), and its first 8 CMux steps on the card == the
port's CPU path.

The kernels line's rows carry each kernel's launches on P2's warm
bootstrap (`p2_launches`), and four rows time the production ring's
instances (`*_n65536`: P1's shapes, P2's launches); the `bgv_drop` row
times G1's first shape and carries G2's path's launches. The phases'
seconds are printed before it.

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
from collections import Counter
from fractions import Fraction

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
# pipe only, either), counted from the SASS (cuobjdump -sass) of chains of
# each operation from csrc/u64.cuh built with the library's flags for
# sm_90a (learn_fhe_tpu_torch/tools/walk64_sass.py; an IMAD.MOV, IMAD.IADD,
# IADD3 or MOV counts as either pipe). The eager butterfly ends each output
# in an unsigned minimum (12 ALU instructions); the lazy one (Harvey's, for
# q < 2^62) keeps one.
CSUB64 = np.array([0, 4, 2])
ADD_Q64 = np.array([1, 4, 3])
SHOUP64 = np.array([10.625, 4, 8.375])
BUTTERFLY64 = np.array([14, 12, 13])
BUTTERFLY64_LAZY = np.array([11, 4, 12])
REDC64 = np.array([8, 7, 7])
MAC128 = np.array([6.125, 3, 4.875])  # a row product added to a 128-bit sum
MULMOD64 = np.array([24.75, 14, 19.25])
DIGIT64 = np.array([1, 10, 5])  # the centered lift and one field of it, less the offset mod q


def ntt64_ops(rows: int, n: int, lazy: bool = True, canonical: bool = True) -> np.ndarray:
    """Forward transforms of `rows` rows: the butterflies, and where lazy and
    canonical the canonicalisation of each value (two minimums) at the end.
    A kernel that takes the lazy values into its products unreduced
    (canonical False) does not do that work, and its bound does not count it."""
    if not lazy:
        return rows * (n // 2) * (n.bit_length() - 1) * BUTTERFLY64
    return rows * (n // 2) * (n.bit_length() - 1) * BUTTERFLY64_LAZY + (rows * n * 2 * CSUB64 if canonical else 0)


def ntt64_mont_ops(rows: int, n: int, lazy: bool = True) -> np.ndarray:
    """`ntt64_mont`: the forward transforms, their values taken unreduced
    into one Shoup product by 2^64 mod q each (canonical)."""
    return ntt64_ops(rows, n, lazy, canonical=False) + rows * n * SHOUP64


def intt64_ops(rows: int, n: int, lazy: bool = True) -> np.ndarray:
    """Inverse transforms with the 1/N scale (a Shoup product, canonical)."""
    return rows * (n // 2) * (n.bit_length() - 1) * (BUTTERFLY64_LAZY if lazy else BUTTERFLY64) + rows * n * SHOUP64


def polymul64_ops(rows: int, n: int, q: int) -> np.ndarray:
    """K-POLYMUL64 on `rows` row pairs: both forward transforms, the
    pointwise product (two REDCs), the inverse with the 1/N scale. Its lazy
    values reach the product unreduced (a b < 16 q^2 < q 2^64) for q < 2^60,
    and are made canonical first above it."""
    lazy = q < 1 << 62
    return 2 * ntt64_ops(rows, n, lazy, canonical=q >= 1 << 60) + rows * n * MULMOD64 + intt64_ops(rows, n, lazy)


def extprod64_ops(count: int, n: int, rows: int, key_switch: bool, lazy: bool = True, canonical: bool = True) -> np.ndarray:
    """`count` external products (2d = rows digit rows of a and b) or key
    switches (d = rows digit rows of a; b + the source's b): the digits,
    their forward NTTs, per output coefficient `rows` 128-bit
    multiply-adds and one REDC, two inverse NTTs with the 1/N scale.
    canonical: whether the forward transforms' lazy values are made
    canonical before the products (the walk's `lft64::phase` does it;
    K-EXTPROD64 takes them unreduced)."""
    per = rows * n * DIGIT64 + ntt64_ops(rows, n, lazy, canonical) + 2 * n * (rows * MAC128 + REDC64) + intt64_ops(2, n, lazy)
    return count * (per + (n * ADD_Q64 if key_switch else 0))


def u64_cases(params, residues, dev):
    """The u64 kernels' launches that M1 and M2 time, at the multi-key full
    set: K-POLYMUL64, K-NTT64 (`ntt64`, `ntt64_mont`) and `intt64` at each
    row count the path launches them at (`ntt64` at `ntt64_mont`'s), and
    K-EXTPROD64 at one merge chunk (`chunk` keys of
    2d rows, 10 consecutive products a key), as an external product and as
    a key switch. residues(shape) draws residues mod q on the CPU. Returns
    {(label, rows or products): (kernel call, plain call, bytes moved,
    instructions)}, and the merge chunk's arguments of `external_product64`
    for an external product and for a key switch."""
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.models.fhew import rgsw
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext
    from learn_fhe_tpu_torch.ops import ntt as tntt

    q, n, plan = params.big_q, params.n, params.rlwe.plan
    gg, gk = params.rgsw.gadget, params.rlwe.gadget
    lazy = tntt.lazy_butterflies(q)
    cases = {}
    for rows in POLYMUL_ROWS:
        x, y = residues((rows, n)).to(dev), residues((rows, n)).to(dev)
        cases["negacyclic_mul64", rows] = (
            lambda x=x, y=y: tntt.negacyclic_mul64(x, y, plan), lambda x=x, y=y: tntt.negacyclic_mul64_ref(x, y, plan),
            3 * rows * n * 8, polymul64_ops(rows, n, q),
        )  # fmt: skip
    for name, fn, ref, counts, ops in (
        ("ntt64", tntt.ntt64, tntt.ntt64_ref, NTT_ROWS, ntt64_ops),
        ("ntt64_mont", tntt.ntt64_mont, tntt.ntt64_mont_ref, NTT_ROWS, ntt64_mont_ops),
        ("intt64", tntt.intt64, tntt.intt64_ref, INTT_ROWS, intt64_ops),
    ):
        for rows in counts:
            x = residues((rows, n)).to(dev)
            cases[name, rows] = (lambda x=x, fn=fn: fn(x, plan), lambda x=x, ref=ref: ref(x, plan), 2 * rows * n * 8, ops(rows, n, lazy))
    chunk = boot.merge_chunk_size(params.lwe_s.n)
    rows_g = 2 * gg.d
    count = chunk * rows_g
    ka, kb = residues((chunk, rows_g, n)).to(dev), residues((chunk, rows_g, n)).to(dev)
    ct = RlweCiphertext(residues((count, n)).to(dev), residues((count, n)).to(dev))
    idx = torch.arange(chunk, dtype=torch.int32, device=dev).repeat_interleave(rows_g)
    args = (gg, plan, ka, kb, idx, ct, False)
    ks_args = (gk, plan, ka[:, : gk.d].contiguous(), kb[:, : gk.d].contiguous(), idx, ct, True)
    for label, a, rows in (("external_product64", args, rows_g), ("external_product64 key switch", ks_args, gk.d)):
        cases[label, count] = (
            lambda a=a: rgsw.external_product64(*a), lambda a=a: rgsw.external_product64_ref(*a),
            4 * count * n * 8 + 2 * chunk * rows * n * 8 + count * 4, extprod64_ops(count, n, rows, a[-1], lazy, canonical=False),
        )  # fmt: skip
    return cases, args, ks_args


def to_eval_calls(params, residues, dev):
    """The multi-key path's conversions into the evaluation basis at each
    shape it gives them: {(call, rows of an operand): (call, operands)}:
    `rlwe._to_eval_mont` at 5 rows (`make_ksk`), `rgsw.to_eval` at a merge
    chunk (60 keys of 2d = 10 rows) and at the final 6000 rows, each on
    residues drawn by residues(shape)."""
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.models.fhew import rgsw, rlwe

    n, rows_g = params.n, 2 * params.rgsw.gadget.d
    x = residues((NTT_ROWS[0], n)).to(dev)
    calls = {("_to_eval_mont", NTT_ROWS[0]): (lambda: rlwe._to_eval_mont(params.rlwe, x), 1)}
    for keys in (boot.merge_chunk_size(params.lwe_s.n), params.lwe_s.n):
        ct = rgsw.RgswCiphertext(residues((keys, rows_g, n)).to(dev), residues((keys, rows_g, n)).to(dev))
        calls["to_eval", keys * rows_g] = (lambda ct=ct: rgsw.to_eval(params.rgsw, ct), 2)
    return calls


def random_walk_key(boot, p, residues, dev):
    """A bootstrap key of evaluation-basis rows drawn at random for the walk
    (arithmetic on any rows) at parameters p; residues(shape, modulus)
    draws them on the CPU."""
    from learn_fhe_tpu_torch.ops.poly import automorphism_map

    maps = [automorphism_map(p.n, t) for t in p.ak_t]
    rows = (p.lwe_s.n, 2 * p.rgsw.gadget.d, p.n), (p.w + 1, p.rlwe.gadget.d, p.n)
    return boot.BootstrapKey(
        None, None, *(residues(rows[i // 2], p.big_q).to(dev) for i in range(4)),
        torch.from_numpy(np.stack([m[0] for m in maps]).astype(np.int32)).to(dev), torch.from_numpy(np.stack([m[1] for m in maps])).to(dev),
    )  # fmt: skip


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
    regs, st, ld, _ = kernels.ptxas_report(kernels.build_log()).get(FHEW_INSTANCE, (0, 0, 0, 0))
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
MK_INSTANCES = (  # the lazy instances the 55-bit set runs; the walk alone (C = 1) and in clusters
    "ntt64_fwd_kernel<true,11,true>", "ntt64_fwd_kernel<true,11,false>", "ntt64_inv_kernel<true,11>",
    "negacyclic_mul64_bulk_kernel<true>", "external_product64_kernel<true,11>",
    "fhew_blind_rotate64_kernel<true,false>", "fhew_blind_rotate64_kernel<true,true>",
)  # fmt: skip
WALK64_SWEEP = (1, 2, 8, 36, 128)
# the row counts the multi-key path launches the u64 transforms at: K-POLYMUL64
# for the pk shares, ak_share_gen, the u8 pk_encrypts and pk_encrypt_rgsw;
# K-NTT64's Montgomery instance for make_ksk, a merge chunk's to_eval and the
# final to_eval
POLYMUL_ROWS, NTT_ROWS, INTT_ROWS = (1, 5, 8, 6000), (5, 600, 6000), (6000,)
ROUND_BATCH = 2  # the u8 expression's commonest round: a majority and a xor (`uint8.py`)


def multikey_phases(dev, tag, pipe_per_s, errs, timings, bounds, launches, graphs) -> None:
    """M1-M4 (see the module's docstring); adds the u64 kernels' entries to
    the kernels line's dicts."""
    shape_ms = {}  # (kernel, rows or products): (CUDA-graph ms, bound ms)
    from learn_fhe_tpu_torch.examples.multi_key_uint8 import example_params, wrapping_expression
    from learn_fhe_tpu_torch.models import fhew
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.models.fhew import gates, lwe, rgsw
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext
    from learn_fhe_tpu_torch.ops import ntt as tntt
    from learn_fhe_tpu_torch.parallel import batch as pbatch
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch
    from learn_fhe_tpu_torch.utils.primes import two_adic_primes

    params = example_params(full=True)
    q, n, plan = params.big_q, params.n, params.rlwe.plan
    gg, gk = params.rgsw.gadget, params.rlwe.gadget
    lazy = tntt.lazy_butterflies(q)
    rng = np.random.default_rng(7)

    def residues(shape, modulus=q):
        x = rng.integers(0, modulus, size=shape, dtype=np.uint64)
        x.reshape(-1)[:2] = [0, modulus - 1]
        return u64_to_torch(x)

    def plain(fn, *args):
        """A plain version on CUDA tensors, its result brought to the CPU."""
        out = fn(*args)
        return RlweCiphertext(out.a.cpu(), out.b.cpu()) if isinstance(out, tuple) else out.cpu()

    # -- M1. K-NTT64 (ntt64, ntt64_mont), intt64, K-POLYMUL64 ---------------------
    for name in ("ntt64", "ntt64_mont", "intt64", "negacyclic_mul64"):
        errs[name] = 0.0
    small = tntt.ntt_plan(q, min(256, n // 2))
    for rows, p in ((10, plan), (19, small), (MK_KEYGEN_ROWS, plan), *((r, plan) for r in NTT_ROWS[:-1])):
        x, y = residues((rows, p.n)).to(dev), residues((rows, p.n)).to(dev)
        check = (
            ("ntt64", tntt.ntt64(x, p), lambda: plain(tntt.ntt64_ref, x, p)),
            ("ntt64_mont", tntt.ntt64_mont(x, p), lambda: plain(tntt.ntt64_mont_ref, x, p)),
            ("intt64", tntt.intt64(x, p), lambda: plain(tntt.intt64_ref, x, p)),
            ("negacyclic_mul64", tntt.negacyclic_mul64(x, y, p), lambda: plain(tntt.negacyclic_mul64_ref, x, y, p)),
        )
        for name, got, want in check:
            errs[name] = max(errs[name], max_abs_err(got, want()))
        say(f"M1 ntt64 / ntt64_mont / intt64 / negacyclic_mul64 == plain at q={q} on ({rows}, {p.n}): ok")
    for rows in POLYMUL_ROWS[:-1]:  # the path's other row counts
        x, y = residues((rows, n)).to(dev), residues((rows, n)).to(dev)
        errs["negacyclic_mul64"] = max(errs["negacyclic_mul64"], max_abs_err(tntt.negacyclic_mul64(x, y, plan), plain(tntt.negacyclic_mul64_ref, x, y, plan)))
    say(f"M1 negacyclic_mul64 == plain on ({', '.join(str(r) for r in POLYMUL_ROWS[:-1])}, {n}): ok")
    timed, args, ks_args = u64_cases(params, residues, dev)
    for (name, rows), (kernel, plain_fn, n_bytes, ops) in timed.items():
        if name.startswith("external_product64"):
            continue  # M2
        k_ms, g_ms, p_ms = cuda_ms(kernel, 50), graph_ms(kernel, 50), cuda_ms(plain_fn, 3)
        b_ms, by = bound_ms(n_bytes, ops, pipe_per_s)
        shape_ms[name, rows] = (g_ms, b_ms)
        say(f"{tag} M1 {name} at ({rows}, {n}): kernel {k_ms * 1e3:.2f} us per wrapper call (CUDA events over 50 eager calls), {g_ms * 1e3:.2f} us per launch (CUDA graph of 50), plain {p_ms * 1e3:.2f} us; bound {b_ms * 1e3:.3f} us by {by} = {b_ms / k_ms:.4f} / {b_ms / g_ms:.4f} of bound")
        if rows == MK_KEYGEN_ROWS:
            timings[name], graphs[name], bounds[name] = (k_ms, p_ms), g_ms, (b_ms, by)

    # -- M2. K-EXTPROD64 at one merge chunk --------------------------------------
    chunk = boot.merge_chunk_size(params.lwe_s.n)
    rows_g = 2 * gg.d
    count = chunk * rows_g
    _, _, ka, kb, idx, ct, _ = args
    want = plain(rgsw.external_product64_ref, *args)
    got = rgsw.external_product64(*args)
    errs["external_product64"] = max(max_abs_err(got.a, want.a), max_abs_err(got.b, want.b))
    want = plain(rgsw.external_product64_ref, *ks_args)
    got = rgsw.external_product64(*ks_args)
    errs["external_product64"] = max(errs["external_product64"], max_abs_err(got.a, want.a), max_abs_err(got.b, want.b))
    # a ragged chunk: 601 products, the last against a 61st key
    ka1, kb1 = torch.cat([ka, ka[:1]]), torch.cat([kb, kb[:1]])
    ct1 = RlweCiphertext(torch.cat([ct.a, ct.a[:1]]), torch.cat([ct.b, ct.b[:1]]))
    args1 = (gg, plan, ka1, kb1, torch.cat([idx, idx.new_full((1,), chunk)]), ct1, False)
    want = plain(rgsw.external_product64_ref, *args1)
    got = rgsw.external_product64(*args1)
    errs["external_product64"] = max(errs["external_product64"], max_abs_err(got.a, want.a), max_abs_err(got.b, want.b))
    say(f"M2 external_product64 == plain at one merge chunk ({chunk} keys, {count} products of {rows_g} rows), at {count + 1} products and as a key switch ({gk.d} rows): ok")
    kernel, plain_fn, n_bytes, ops = timed["external_product64", count]
    k_ms, p_ms, g_ms = cuda_ms(kernel, 5), cuda_ms(plain_fn, 1), graph_ms(kernel, 10)
    b_ms, by = bound_ms(n_bytes, ops, pipe_per_s)
    timings["external_product64"], bounds["external_product64"], graphs["external_product64"] = (k_ms, p_ms), (b_ms, by), g_ms
    shape_ms["external_product64", count] = (g_ms, b_ms)
    regs, st, ld, _ = kernels_report().get("external_product64_kernel<true,11>", (0, 0, 0, 0))
    say(f"{tag} M2 external_product64 at one merge chunk: {k_ms:.4f} ms per call (CUDA events, 5 calls), {g_ms:.4f} ms per launch (CUDA graph of 10) = {g_ms * 1e3 / count:.3f} us per product; plain {p_ms:.1f} ms; bound {b_ms:.4f} ms by {by} = {b_ms / k_ms:.4f} / {b_ms / g_ms:.4f} of bound; {regs} registers, {st} / {ld} bytes spilled")
    kernel, _, n_bytes, ops = timed["external_product64 key switch", count]
    ks_ms, ks_bound = graph_ms(kernel, 10), bound_ms(n_bytes, ops, pipe_per_s)
    say(f"{tag} M2 external_product64 as a key switch of {count}: {ks_ms:.4f} ms per launch (CUDA graph of 10); bound {ks_bound[0]:.4f} ms by {ks_bound[1]} = {ks_bound[0] / ks_ms:.4f} of bound")

    # -- M3. K-FHEW-BR64 against the plain walk ------------------------------------
    errs["fhew_blind_rotate64"] = errs["fhew_blind_rotate64_cluster"] = 0.0
    q54 = next(two_adic_primes(54, 8))
    fixture = fhew.BootstrapParams(
        fhew.RgswParams(fhew.RlweParams(q=q54, p=4, log_n=7, log_b=6, d=9), log_b=6, d=9),
        fhew.LweParams(q=1 << 16, p=4, n=16, log_b=4, d=4),
        w=5,
    )
    key54 = fhew.key_gen(fixture, fhew.rlwe.sk_gen(fixture.rlwe, rng), rng, dev)

    def random_key(p):
        return random_walk_key(boot, p, residues, dev)

    # a 63-bit prime, which takes the eager instance (d = 1: two rows below q 2^64)
    q63 = next(two_adic_primes(63, 8))
    eager = fhew.BootstrapParams(fhew.RgswParams(fhew.RlweParams(q=q63, p=4, log_n=7, log_b=20, d=1), log_b=20, d=1), fixture.lwe_s, w=fixture.w)
    # per fixture, the batches that pick each cluster size; ciphertexts are
    # independent, so one plain walk of the largest batch holds them all
    cases = [
        ("54-bit fixture", fixture, key54, [batch_for_cluster(boot, fixture, c, dev) for c in range(1, 9)] + [128]),
        ("full set, random key rows", params, random_key(params), [batch_for_cluster(boot, params, c, dev) for c in range(2, 6)] + [2]),
        ("63-bit prime (eager instance)", eager, random_key(eager), [2]),
    ]
    boot.walk_error(dev).zero_()
    for label, p, key, batches in cases:
        batches = [b for b in batches if b is not None]  # None: no batch picks that cluster size on this card
        top = max(batches)
        a2n = torch.from_numpy(2 * rng.integers(0, p.n, size=(top, p.lwe_s.n)) + 1).to(dev)
        e_all, a_all = boot.schedule(p, a2n)
        acc_all = RlweCiphertext(residues((top, p.n), p.big_q).to(dev), residues((top, p.n), p.big_q).to(dev))
        t0 = time.perf_counter()
        want = plain(boot.blind_rotate_core_fused_ref, p, key, e_all, a_all, acc_all)
        plain_s = time.perf_counter() - t0
        for batch in batches:
            e_idx, a_idx = e_all[:batch].contiguous(), a_all[:batch].contiguous()
            acc = RlweCiphertext(acc_all.a[:batch].contiguous(), acc_all.b[:batch].contiguous())
            got = boot.blind_rotate_core_fused(p, key, e_idx, a_idx, acc)
            cluster = boot.walk64_cluster(batch, p, dev)
            inst = "fhew_blind_rotate64_cluster" if cluster > 1 else "fhew_blind_rotate64"
            errs[inst] = max(errs[inst], max_abs_err(got.a, want.a[:batch]), max_abs_err(got.b, want.b[:batch]))
            say(f"M3 K-FHEW-BR64 == blind_rotate_core_fused_ref at the {label}, batch {batch}, cluster {cluster}, {'lazy' if tntt.lazy_butterflies(p.big_q) else 'eager'} instance ({int((e_idx >= 0).sum())} external products, {int((a_idx >= 0).sum())} automorphisms): ok")
        say(f"M3 (the plain walk of batch {top} at the {label} on CUDA tensors: {plain_s:.1f} s)")
    torch.cuda.synchronize()
    word = int(boot.walk_error(dev).item())
    say(f"M3 K-FHEW-BR64 error word: {word}")
    if word:
        raise AssertionError(f"K-FHEW-BR64 flagged a schedule index outside the key (error word {word})")

    # -- M4. the main path -----------------------------------------------------------
    counted = (tntt.ntt64, tntt.ntt64_mont, tntt.intt64, tntt.negacyclic_mul64, rgsw.external_product64, boot.blind_rotate_core_fused64)
    by_shape = {
        "ntt64": tntt.ntt64.by_rows, "ntt64_mont": tntt.ntt64_mont.by_rows, "intt64": tntt.intt64.by_rows,
        "negacyclic_mul64": tntt.negacyclic_mul64.by_rows, "external_product64": rgsw.external_product64.by_count,
    }  # fmt: skip
    for fn in counted:
        fn.launches = 0
    for c in by_shape.values():
        c.clear()
    boot.blind_rotate_core_fused64.cluster_launches = 0
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
    picked, pick = [], boot.walk64_cluster  # each gate round's batch and the cluster size it took
    boot.walk64_cluster = lambda batch, p, device: picked.append((batch, pick(batch, p, device))) or picked[-1][1]
    try:
        r = ct_a.wrapping_add(ct_b).wrapping_mul(ct_a.wrapping_sub(ct_b)).wrapping_div(ct_a).wrapping_rem(ct_b)
    finally:
        boot.walk64_cluster = pick
    t = stamp("((a+b)*(a-b)/a)%b", t)
    rounds = boot.blind_rotate_core_fused64.launches - rounds0
    got = r.decryption_share_merge([r.share_decrypt(sk, rng) for sk in sks])
    t = stamp("threshold decryption", t)
    expr_s = steps[-2][1]
    for name, secs in steps:
        say(f"{tag} M4 {name}: {secs:.3f} s (host clock, to a sync)")
    want = wrapping_expression(MK_A, MK_B)
    say(f"{tag} M4 ((a+b)*(a-b)/a)%b for a={MK_A}, b={MK_B}: threshold-decrypted {got}, expected {want}; {rounds} gate rounds in {expr_s:.3f} s ({expr_s / max(rounds, 1) * 1e3:.2f} ms per round)")
    if got != want:
        raise AssertionError("the u8 expression threshold-decrypted to the wrong value")
    sizes, clusters = Counter(b for b, _ in picked), Counter(c for _, c in picked)
    say(f"{tag} M4 the u8 expression's gate rounds by gates per round (gates: rounds): {dict(sorted(sizes.items()))}; by the cluster size K-FHEW-BR64 took (C: rounds): {dict(sorted(clusters.items()))}")

    # a NAND batch of 128 under the merged key (encrypted under the sum of
    # the parties' secrets, which the merged key switches from), the last
    # call of the main path; then its gates/s
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
    mk_launches = {fn.__name__: fn.launches for fn in counted}
    walk_all, walk_clustered = mk_launches.pop("blind_rotate_core_fused64"), boot.blind_rotate_core_fused64.cluster_launches
    mk_launches["fhew_blind_rotate64"], mk_launches["fhew_blind_rotate64_cluster"] = walk_all - walk_clustered, walk_clustered
    say(f"{tag} M4 launches on the main path (the u8 expression, its decryption, one NAND batch of {B}): {mk_launches}")
    lost = {}
    for name, counts in by_shape.items():
        parts = []
        for rows, cnt in sorted(counts.items()):
            if (name, rows) in shape_ms:
                g_ms, b_ms = shape_ms[name, rows]
                lost[name] = lost.get(name, 0.0) + cnt * (g_ms - b_ms)
                parts.append(f"{cnt} x {rows} rows: {cnt} x ({g_ms * 1e3:.3f} - {b_ms * 1e3:.3f}) us = {cnt * (g_ms - b_ms) * 1e3:.1f} us")
            else:
                parts.append(f"{cnt} x {rows} rows: not timed")
        say(f"{tag} M4 {name} launches by shape, with launches x (time - bound) from M1/M2's CUDA-graph times: {'; '.join(parts) or 'none'}; in all {lost.get(name, 0.0) * 1e3:.1f} us")
    for name in ("ntt64_mont", "negacyclic_mul64", "external_product64", "fhew_blind_rotate64", "fhew_blind_rotate64_cluster"):
        if mk_launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the multi-key main path")
    if mk_launches["ntt64"]:
        raise AssertionError("plain ntt64 ran on the multi-key main path: every conversion into the evaluation basis should be one ntt64_mont launch")
    launches.update(mk_launches)
    for (call, rows), (fn, operands) in to_eval_calls(params, residues, dev).items():
        e_ms, g_ms = cuda_ms(fn, 20), graph_ms(fn, 20)
        say(f"{tag} M4 {call} at ({rows}, {n}) x {operands} operand(s), whole: {e_ms * 1e3:.2f} us per eager call (CUDA events over 20 calls), {g_ms * 1e3:.2f} us per call replayed from a CUDA graph of 20 = {g_ms * 1e3 / operands:.2f} us per operand")

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

    def walk_work(e, a, lazy_bfly=lazy):
        """A walk's external products and automorphisms, its instructions,
        and its bytes: acc in and out, the schedule, and each key row it
        uses once."""
        ext, auto = int((e >= 0).sum()), int((a >= 0).sum())
        ops = extprod64_ops(ext, n, rows_g, False, lazy_bfly) + extprod64_ops(auto, n, gk.d, True, lazy_bfly) + auto * 2 * n * CSUB64
        e_used, a_used = torch.unique(e[e >= 0]).numel(), torch.unique(a[a >= 0]).numel()
        n_bytes = 4 * e.shape[0] * n * 8 + 2 * e.numel() * 4 + e_used * 2 * rows_g * n * 8 + a_used * (2 * gk.d * n * 8 + 5 * n)
        return ext, auto, ops, n_bytes

    round_walk = None
    for b in WALK64_SWEEP:  # rows of the batch-128 schedule: a gate round's size
        rows = torch.arange(b, device=dev) % B
        se, sa = e_idx[rows].contiguous(), a_idx[rows].contiguous()
        acc_b = RlweCiphertext(acc.a[rows].contiguous(), acc.b[rows].contiguous())
        t_b = cuda_ms(lambda: boot.blind_rotate_core_fused(params, key, se, sa, acc_b), 3)
        cluster = boot.walk64_cluster(b, params, dev)
        say(f"{tag} M4 K-FHEW-BR64 at batch {b} of the NAND schedule, cluster {cluster}: {t_b:.3f} ms per launch (CUDA events, 3 launches) = {t_b * 1e3 / b:.1f} us per ciphertext")
        if b == ROUND_BATCH:
            round_walk = (t_b, cluster, se, sa, acc_b)

    # the clustered instance at a round of two gates, against its bound and its plain version
    r_ms, r_cluster, se, sa, acc_r = round_walk
    if r_cluster == 1:
        raise AssertionError(f"K-FHEW-BR64 took one block per ciphertext at batch {ROUND_BATCH}")
    r_ext, r_auto, r_ops, r_bytes = walk_work(se, sa)
    r_bound, r_by = bound_ms(r_bytes, r_ops, pipe_per_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain(boot.blind_rotate_core_fused_ref, params, key, se, sa, acc_r)
    r_plain = (time.perf_counter() - t0) * 1e3
    got = boot.blind_rotate_core_fused(params, key, se, sa, acc_r)
    errs["fhew_blind_rotate64_cluster"] = max(errs["fhew_blind_rotate64_cluster"], max_abs_err(got.a, want.a), max_abs_err(got.b, want.b))
    timings["fhew_blind_rotate64_cluster"], bounds["fhew_blind_rotate64_cluster"] = (r_ms, r_plain), (r_bound, r_by)
    regs_c, st_c, ld_c, _ = kernels_report().get("fhew_blind_rotate64_kernel<true,true>", (0, 0, 0, 0))
    say(f"M4 K-FHEW-BR64 == blind_rotate_core_fused_ref at batch {ROUND_BATCH} of the full set with the merged key (cluster {r_cluster}): ok")
    say(f"{tag} M4 K-FHEW-BR64 clustered at batch {ROUND_BATCH}, C = {r_cluster} ({r_ext} external products, {r_auto} automorphisms): {r_ms:.3f} ms per wrapper call (CUDA events, 3 calls); bound {r_bound:.4f} ms by {r_by} (instructions {r_ops[0] / 1e9:.3f} G FMA, {r_ops[1] / 1e9:.3f} G ALU, {r_ops[2] / 1e9:.3f} G either; bytes {r_bytes / 1e6:.1f} MB) = {r_bound / r_ms:.4f} of bound; plain version on CUDA tensors {r_plain / 1e3:.1f} s (host clock, to a sync); {regs_c} registers, {st_c} / {ld_c} bytes spilled")
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
    ext_steps, auto_steps, ops, walk_bytes = walk_work(e_idx, a_idx)
    eager_ops = walk_work(e_idx, a_idx, False)[2]
    b_ms, by = bound_ms(walk_bytes, ops, pipe_per_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain(boot.blind_rotate_core_fused_ref, params, key, e_idx, a_idx, acc)
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = boot.blind_rotate_core_fused(params, key, e_idx, a_idx, acc)
    errs["fhew_blind_rotate64"] = max(errs["fhew_blind_rotate64"], max_abs_err(got.a, want.a), max_abs_err(got.b, want.b))
    say(f"M4 K-FHEW-BR64 == blind_rotate_core_fused_ref at batch {B} of the full set with the merged key: ok")
    timings["fhew_blind_rotate64"], bounds["fhew_blind_rotate64"] = (walk_ms, plain_ms), (b_ms, by)
    regs, st, ld, _ = kernels_report().get("fhew_blind_rotate64_kernel<true,false>", (0, 0, 0, 0))
    e_ms, e_by = bound_ms(walk_bytes, eager_ops, pipe_per_s)
    say(f"{tag} M4 K-FHEW-BR64 at batch {B} ({ext_steps} external products, {auto_steps} automorphisms, fused length {e_idx.shape[1]}): {walk_ms:.3f} ms per wrapper call (CUDA events, 3 calls), device {walk_dev:.3f} ms (profiler, in the gate batch above); bound {b_ms:.4f} ms by {by} (lazy butterflies; instructions {ops[0] / 1e9:.2f} G FMA, {ops[1] / 1e9:.2f} G ALU, {ops[2] / 1e9:.2f} G either; bytes {walk_bytes / 1e6:.1f} MB) = {b_ms / walk_ms:.4f} of bound, {b_ms / walk_dev:.4f} on the device; with eager butterflies the count gives {e_ms:.4f} ms by {e_by}; plain version on CUDA tensors {plain_ms / 1e3:.1f} s (host clock, to a sync); {regs} registers, {st} / {ld} bytes spilled")
    torch.cuda.synchronize()
    word = int(boot.walk_error(dev).item())
    say(f"M4 K-FHEW-BR64 error word after M4: {word}")
    if word:
        raise AssertionError(f"K-FHEW-BR64 flagged a schedule index outside the key (error word {word})")


CKKS = dict(log_n=13, log_qi=55, big_l=8)  # `bench.py:657-700`: N=2^13, 8 q-primes + 8 p-primes of 55 bits
CKKS_BATCH = 16  # `bench/ckks_profile.py:61,188`
CKKS_MUL_CALLS = 5
CKKS_REPS = 20  # eager calls and CUDA-graph launches a C1 timing averages
CKKS_ROT = 5
# the budget `tests/test_ckks_large.py::test_mul_chain_32bits` holds at log_n=13
CKKS_MUL_BITS = 32 - 1.5 * (13 - 10)
CKKS_INSTANCES = (
    "rns_ntt_kernel<false,true,13>", "rns_ntt_kernel<true,true,13>", "rns_intt_mac_kernel<true,13,1>",
    "rns_intt_mac_kernel<true,13,2>", "rns_mac_kernel<4>", "base_convert_kernel<8>", "rescale_kernel",
)  # fmt: skip
L2_BYTES = 50e6  # the H100's L2 cache


def rns_mac_ops(values: int, terms: int, sums: int, fused: bool = False) -> np.ndarray:
    """K-RNS-MAC on `values` outputs of each of `sums` sums of `terms`
    products: per sum and value the 128-bit multiply-adds, one REDC per
    chunk (a chunk holds every term at 55 bits); alone, also the add of the
    chunk's residue mod q and the REDC by 2^128 mod q that takes the sum out
    of the Montgomery domain. Inside the inverse transform (fused: the
    instances for 1 and 2 terms, one chunk) neither: the transform's final
    scale takes the 2^-64 out."""
    return values * sums * (terms * MAC128 + REDC64 + (0 if fused else ADD_Q64 + REDC64))


def base_convert_ops(cols: int, qs: tuple[int, ...], lp: int, add: bool) -> np.ndarray:
    """K-BASECONV on `cols` coefficient columns from the input primes qs into
    lp output limbs: per input limb one Shoup product (and an add where a
    constant comes first); per output limb lq 128-bit multiply-adds, one
    REDC per chunk of terms (chunk max(q) < 2^64: all 8 at 55 bits) and,
    with more than one chunk, the chunks' adds mod p; the correction
    subtracted. The overflow count's lq f64 fused multiply-adds go to the
    FP64 pipe and are not counted."""
    lq, chunk = len(qs), ((1 << 64) - 1) // max(qs)
    chunks = -(-lq // chunk)
    per_out = lq * MAC128 + chunks * REDC64 + (chunks * ADD_Q64 if chunks > 1 else 0) + ADD_Q64
    return cols * (lq * (SHOUP64 + (ADD_Q64 if add else 0)) + lp * per_out)


def base_convert_ops_shoup(cols: int, lq: int, lp: int, add: bool) -> np.ndarray:
    """K-BASECONV's first version, counted as it ran (the bound before its redesign): per
    output limb lq Shoup products added mod p one at a time."""
    return cols * (lq * (SHOUP64 + (ADD_Q64 if add else 0)) + lp * lq * (SHOUP64 + ADD_Q64) + lp * ADD_Q64)


def rescale_ops(values: int, k1: bool) -> np.ndarray:
    """K-RESCALE on `values` outputs: add P/2, subtract, one Shoup product;
    with k = 1 also the dropped limb's add and a Barrett (a Shoup's cost)."""
    return values * (2 * ADD_Q64 + SHOUP64 + ((ADD_Q64 + SHOUP64) if k1 else 0))


def rns_cases(params, batch: int, rng, dev):
    """The RNS kernels' launches that C1 times, at a batch-`batch` `mul`'s
    shapes: K-RNS-NTT (forward and inverse) on (B, L, N) and (B, L+P, N),
    the inverse also on the key switch's (2, B, L+P, N); K-RNS-MAC at K=1,
    K=2 and the key switch's two sums, alone and inside the inverse
    (`rns_intt_mac`, whose bytes count each x, y and z read once, the
    twiddles and the output written once); K-BASECONV L -> P; K-RESCALE at
    k=1 and k=P. Returns {(row, shape): (kernel call, plain call, bytes,
    instructions, cold)}: cold is (call of an input, the input) where C1
    also reads a cold-L2 time (the transforms and K-BASECONV), else None."""
    from learn_fhe_tpu_torch.ops import rns
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch

    qs, ps, qps, n, B = params.qs, params.ps, params.qps, params.n, batch
    L, P = len(qs), len(ps)

    def residues(basis, lead):
        x = np.stack([rng.integers(0, q, size=(*lead, n), dtype=np.uint64) for q in basis], axis=-2)
        x.reshape(-1)[:2] = [0, basis[0] - 1]
        return u64_to_torch(x).to(dev)

    plan_q, plan_qp = params.plan(qs), params.plan(qps)
    xq, yq = residues(qs, (B,)), residues(qs, (B,))
    xqp = residues(qps, (B,))
    xqp2 = torch.stack([xqp, xqp])  # the key switch's b and a sums, inverse-transformed in one launch
    key_b, key_a = residues(qps, ()), residues(qps, ())
    rp1, rp8 = rns.rescale_plan(qs, 1), rns.rescale_plan(qps, P)
    conv8 = rns.base_convert(xqp[:, L:], rp8.drop, rp8.keep, add=rp8.p_half[L:])
    lazy = max(qps) < 1 << 62
    tab = lambda basis: len(basis) * n * 16  # noqa: E731  (a launch's twiddles and duals)
    ntt_q, ntt_qp = (lambda x: rns.rns_ntt(x, plan_q)), (lambda x: rns.rns_ntt(x, plan_qp))  # noqa: E731
    intt_q, intt_qp = (lambda x: rns.rns_intt(x, plan_q)), (lambda x: rns.rns_intt(x, plan_qp))  # noqa: E731
    conv = lambda x: rns.base_convert(x, qs, ps)  # noqa: E731
    return {
        ("rns_ntt", (B, L, n)): (lambda: ntt_q(xq), lambda: rns.rns_ntt_ref(xq, plan_q),
                                 2 * B * L * n * 8 + tab(qs), ntt64_ops(B * L, n, lazy), (ntt_q, xq)),
        ("rns_ntt", (B, L + P, n)): (lambda: ntt_qp(xqp), lambda: rns.rns_ntt_ref(xqp, plan_qp),
                                     2 * B * (L + P) * n * 8 + tab(qps), ntt64_ops(B * (L + P), n, lazy), (ntt_qp, xqp)),
        ("rns_intt", (B, L, n)): (lambda: intt_q(xq), lambda: rns.rns_intt_ref(xq, plan_q),
                                  2 * B * L * n * 8 + tab(qs), intt64_ops(B * L, n, lazy), (intt_q, xq)),
        ("rns_intt", (2, B, L + P, n)): (lambda: intt_qp(xqp2), lambda: rns.rns_intt_ref(xqp2, plan_qp),
                                         4 * B * (L + P) * n * 8 + tab(qps), intt64_ops(2 * B * (L + P), n, lazy), (intt_qp, xqp2)),
        ("rns_mac", "K=1"): (lambda: rns.rns_mac([xq], [yq], plan_q), lambda: rns.rns_mac_ref([xq], [yq], plan_q),
                             3 * B * L * n * 8, rns_mac_ops(B * L * n, 1, 1), None),
        ("rns_mac", "K=2"): (lambda: rns.rns_mac([xq, yq], [yq, xq], plan_q), lambda: rns.rns_mac_ref([xq, yq], [yq, xq], plan_q),
                             5 * B * L * n * 8, rns_mac_ops(B * L * n, 2, 1), None),
        ("rns_mac", "key switch"): (lambda: rns.rns_mac([xqp], [key_b], plan_qp, [key_a]),
                                    lambda: rns.rns_mac_ref([xqp], [key_b], plan_qp, [key_a]),
                                    3 * B * (L + P) * n * 8 + 2 * (L + P) * n * 8, rns_mac_ops(B * (L + P) * n, 1, 2), None),
        ("rns_intt_mac", "K=1"): (lambda: rns.rns_intt_mac([xq], [yq], plan_q), lambda: rns.rns_intt_mac_ref([xq], [yq], plan_q),
                                  3 * B * L * n * 8 + tab(qs), intt64_ops(B * L, n, lazy) + rns_mac_ops(B * L * n, 1, 1, True), None),
        ("rns_intt_mac", "K=2"): (lambda: rns.rns_intt_mac([xq, yq], [yq, xq], plan_q),
                                  lambda: rns.rns_intt_mac_ref([xq, yq], [yq, xq], plan_q),
                                  5 * B * L * n * 8 + tab(qs), intt64_ops(B * L, n, lazy) + rns_mac_ops(B * L * n, 2, 1, True), None),
        ("rns_intt_mac", "key switch"): (lambda: rns.rns_intt_mac([xqp], [key_b], plan_qp, [key_a]),
                                         lambda: rns.rns_intt_mac_ref([xqp], [key_b], plan_qp, [key_a]),
                                         3 * B * (L + P) * n * 8 + 2 * (L + P) * n * 8 + tab(qps),
                                         intt64_ops(2 * B * (L + P), n, lazy) + rns_mac_ops(B * (L + P) * n, 1, 2, True), None),
        ("base_convert", f"{L}->{P}"): (lambda: conv(xq), lambda: rns.base_convert_ref(xq, qs, ps),
                                        B * (L + P) * n * 8, base_convert_ops(B * n, qs, P, False), (conv, xq)),
        ("rescale", "k=1"): (lambda: rns.rescale_finish(xq, None, rp1), lambda: rns.rescale_finish_ref(xq, None, rp1),
                             B * (2 * L - 1) * n * 8, rescale_ops(B * (L - 1) * n, True), None),
        ("rescale", f"k={P}"): (lambda: rns.rescale_finish(xqp, conv8, rp8), lambda: rns.rescale_finish_ref(xqp, conv8, rp8),
                                3 * B * L * n * 8, rescale_ops(B * L * n, False), None),
    }  # fmt: skip


def cold_graph_ms(call, x: torch.Tensor, reps: int) -> tuple[float, int]:
    """graph_ms of call on copies of x taken in turn, more of them than the
    L2 holds, so that each launch reads its input from device memory; and
    the number of copies."""
    import itertools

    k = int(L2_BYTES // (x.numel() * x.element_size())) + 2
    copies = itertools.cycle([x.clone() for _ in range(k)])
    return graph_ms(lambda: call(next(copies)), reps), k


def ckks_phases(dev, tag, pipe_per_s, errs, timings, bounds, launches, graphs) -> None:
    """C1-C4 (see the module's docstring); adds the RNS kernels' entries to
    the kernels line's dicts."""
    from learn_fhe_tpu_torch.examples.ckks_logistic import run as logistic
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.ops import rns
    from tests.test_torch_rust_ckks import check_evaluations, transcript

    params = C.CkksParams(**CKKS)
    qs, ps, qps, n, B = params.qs, params.ps, params.qps, params.n, CKKS_BATCH
    L, P = len(qs), len(ps)
    rng = np.random.default_rng(11)

    # -- C1: each kernel vs its plain version at the path's shapes -------------
    t0 = time.perf_counter()
    report = kernels_report()
    for name in CKKS_INSTANCES:
        regs, st, ld, stack = report[name]
        say(f"  ptxas: {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads, {stack} bytes stack frame")
    cases = rns_cases(params, B, rng, dev)
    wrappers = {"rns_ntt": rns.rns_ntt, "rns_intt": rns.rns_intt, "rns_mac": rns.rns_mac, "rns_intt_mac": rns.rns_intt_mac, "base_convert": rns.base_convert, "rescale": rns.rescale_finish}
    for (name, shape), (kernel, plain, *_) in cases.items():
        before = wrappers[name].launches
        got = kernel()
        if wrappers[name].launches != before + 1:
            raise AssertionError(f"C1 {name} {shape}: the wrapper did not launch its kernel once")
        errs[name] = max(errs.get(name, 0.0), max_abs_err(got, plain().cpu()))
    # the whole rescale by P: K-BASECONV of the dropped limbs + K-RESCALE
    xqp = cases["rns_ntt", (B, L + P, n)][4][1]  # the (B, L+P, N) residues the transform cases take
    rp8 = rns.rescale_plan(qps, P)
    errs["rescale"] = max(errs["rescale"], max_abs_err(rns.rescale_k(xqp, qps, P), rns.rescale_finish_ref(
        xqp, rns.base_convert_ref(xqp[:, L:], rp8.drop, rp8.keep, add=rp8.p_half[L:]), rp8).cpu()))  # fmt: skip
    say(f"C1 K-RNS-NTT (forward, inverse) on ({B}, {L}, {n}) and ({B}, {L + P}, {n}), K-RNS-MAC at K=1, 2 and the key switch's two sums alone and inside the inverse (rns_intt_mac), K-BASECONV {L}->{P}, K-RESCALE at k=1 and k={P} == plain, each wrapper launching its kernel once a call: ok")
    for (name, shape), (kernel, plain, n_bytes, ops, cold) in cases.items():
        k_ms, g_ms, p_ms = cuda_ms(kernel, CKKS_REPS), graph_ms(kernel, CKKS_REPS), cuda_ms(plain, 3)
        b_ms, by = bound_ms(n_bytes, ops, pipe_per_s)
        if name not in timings:  # the kernels line takes the first shape of each row
            timings[name], graphs[name], bounds[name] = (k_ms, p_ms), g_ms, (b_ms, by)
        cold_note = ""
        if cold is not None:
            c_ms, copies = cold_graph_ms(*cold, CKKS_REPS)
            cold_note = f", {c_ms * 1e3:.2f} us cold-L2 (graph over {copies} input copies) = {b_ms / c_ms:.4f} of bound"
        say(f"{tag} C1 {name} {shape}: kernel {k_ms * 1e3:.2f} us eager ({CKKS_REPS} wrapper calls), {g_ms * 1e3:.2f} us from a CUDA graph{cold_note}; plain {p_ms * 1e3:.1f} us; bound {b_ms * 1e3:.2f} us by {by} ({n_bytes / 1e6:.1f} MB; {ops[0] / 1e6:.1f} M FMA, {ops[1] / 1e6:.1f} M ALU, {ops[2] / 1e6:.1f} M either) = {b_ms / g_ms:.4f} of bound from the graph")
        if name == "base_convert":
            old_ms, old_by = bound_ms(n_bytes, base_convert_ops_shoup(B * n, L, P, False), pipe_per_s)
            say(f"{tag} C1 {name} {shape}: the first version's bound (Shoup products added one at a time) {old_ms * 1e3:.2f} us by {old_by} = {old_ms / g_ms:.4f} of it from the graph")
    say(f"{tag} C1 took {time.perf_counter() - t0:.1f} s (host clock)")

    # -- C2: the Rust reference transcript on the card ---------------------------
    t0 = time.perf_counter()
    check_evaluations(transcript(dev))
    say(f"{tag} C2 mul + relinearize + rescale, rotate and conjugate of the Rust reference transcript (N=512, L=8) on the card == the reference's ciphertexts, bit for bit ({time.perf_counter() - t0:.1f} s, host clock)")

    # -- C3: the main path ------------------------------------------------------
    t0 = time.perf_counter()
    sk = C.sk_gen(params, rng)
    rlk = C.rlk_gen(params, sk, rng, dev)
    rtk = C.rtk_gen(params, sk, CKKS_ROT, rng, dev)
    cjk = C.cjk_gen(params, sk, rng, dev)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ms = [rng.standard_normal(params.l) + 1j * rng.standard_normal(params.l) for _ in range(2 * B)]
    cts = [C.sk_encrypt(params, sk, C.encode(params, m, device=dev), qs, rng) for m in ms]
    stack = lambda cs: C.CkksCiphertext(torch.stack([c.b for c in cs]), torch.stack([c.a for c in cs]), qs)  # noqa: E731
    ct0, ct1 = stack(cts[:B]), stack(cts[B:])
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    # the mul makes its sums inside the inverse transforms: the MAC and the
    # inverse alone (held in C1) must not launch on it
    counted = {"rns_ntt": rns.rns_ntt, "rns_intt_mac": rns.rns_intt_mac, "base_convert": rns.base_convert, "rescale": rns.rescale_finish}
    alone = {"rns_intt": rns.rns_intt, "rns_mac": rns.rns_mac}
    for fn in (*counted.values(), *alone.values()):
        fn.launches, fn.by_rows = 0, Counter()
    out = C.mul(params, rlk, ct0, ct1)
    torch.cuda.synchronize()
    by_rows = {name: dict(fn.by_rows) for name, fn in counted.items()}
    for name, fn in (*counted.items(), *alone.items()):
        launches[name] = fn.launches
    say(f"{tag} C3 keys (rlk, a rotation key, cjk) on the card {keygen_s:.2f} s; {2 * B} messages encoded and sk_encrypted {enc_s:.2f} s (host clock, to a sync)")
    say(f"C3 launches of one batch-{B} mul, by rows (K-BASECONV: (input rows, input limbs, output limbs); rns_intt_mac: (output rows, terms)): {by_rows}; rns_intt alone {launches['rns_intt']}, rns_mac alone {launches['rns_mac']}")
    for name in counted:
        if launches[name] == 0:
            raise AssertionError(f"{name} was not launched on the CKKS main path")
    for name in alone:
        if launches[name]:
            raise AssertionError(f"{name} launched alone on the CKKS main path, whose sums are made inside the inverse transforms")
    if out.b.shape != (B, L - 1, n) or out.qs != qs[:-1]:
        raise AssertionError(f"mul output shape {tuple(out.b.shape)} at {len(out.qs)} limbs")
    worst = 200.0
    pts = C.decrypt(params, sk, out)
    for i in range(B):
        got = C.decode(params, pts[i], out.qs)
        d = float(np.max(np.abs(got - ms[i] * ms[B + i])))
        worst = min(worst, 200.0 if d == 0 else -np.log2(d))
    say(f"C3 {B} products decode to m0 m1 within {worst:.1f} bits (budget {CKKS_MUL_BITS} bits, `tests/test_ckks_large.py` at log_n=13)")
    if worst <= CKKS_MUL_BITS:
        raise AssertionError("a decrypted product is outside its budget")
    cpu_key = lambda k: C.CkksKeySwitchingKey(k.b.cpu(), k.a.cpu(), k.qs)  # noqa: E731
    first = lambda ct: C.CkksCiphertext(ct.b[0].contiguous(), ct.a[0].contiguous(), ct.qs)  # noqa: E731
    cpu = lambda ct: C.CkksCiphertext(ct.b.cpu(), ct.a.cpu(), ct.qs)  # noqa: E731
    c0, c1 = cpu(first(ct0)), cpu(first(ct1))
    for label, got, want in (
        ("mul", out, C.mul(params, cpu_key(rlk), c0, c1)),
        ("rotate", C.rotate(params, rtk, ct0), C.rotate(params, C.CkksRotKey(cpu_key(rtk.ksk), rtk.j), c0)),
        ("conjugate", C.conjugate(params, cjk, ct0), C.conjugate(params, cpu_key(cjk), c0)),
    ):
        max_abs_err(got.b[0], want.b)
        max_abs_err(got.a[0], want.a)
        say(f"C3 {label}: the first ciphertext of the batch == the port's CPU path, bit for bit")
    mul_ms = {}
    for batch, (a, b) in ((B, (ct0, ct1)), (1, (first(ct0), first(ct1)))):
        med, lo, hi = spread_ms(lambda a=a, b=b: C.mul(params, rlk, a, b), CKKS_MUL_CALLS)
        say(f"{tag} C3 mul at batch {batch}: {med:.3f} ms per call (median of {CKKS_MUL_CALLS}, {lo:.3f}-{hi:.3f}; CUDA events) = {batch / med * 1e3:.1f} muls/s")
        mul_ms[batch] = med
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    C.mul(params, rlk, ct0, ct1)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    say(f"{tag} C3 mul at batch {B}: host enqueue {host_s * 1e3:.3f} ms, wall with sync {wall_s * 1e3:.3f} ms")
    g_ms = graph_ms(lambda: C.mul(params, rlk, ct0, ct1), 3)
    say(f"{tag} C3 mul at batch {B} from a CUDA graph: {g_ms:.3f} ms per call (device only) = {B / g_ms * 1e3:.1f} muls/s; the device's idle share in an eager call, 1 - graph / eager median = {1 - g_ms / mul_ms[B]:.4f}")
    idle, kernel_ms, top = device_kernel_ms(lambda: C.mul(params, rlk, ct0, ct1))
    if kernel_ms:
        say(f"{tag} C3 mul at batch {B}: device idle share {idle:.4f} (profiler, union of kernel intervals); summed kernel time {kernel_ms:.3f} ms")
        for name, t, count in top:
            say(f"  {t:10.3f} ms  {count:6d} x  {name[:100]}")
    else:
        say(f"{tag} C3 device kernel time and idle share: not measured (the profiler recorded no device activity)")

    # -- C4: the applied entry point -------------------------------------------
    t0 = time.perf_counter()
    res = logistic(10, dev, say=lambda *parts: say("C4", *parts))
    torch.cuda.synchronize()
    say(f"{tag} C4 examples/ckks_logistic.py at log_n=10 on the card: classifications agree {res['agree']:.0%}, {time.perf_counter() - t0:.2f} s (host clock, keys included)")


BOOT = dict(log_n=13, log_qi=55, big_l=23)  # `bench.py:714-778` at --log-n 13: N=2^13, 23 q-primes + 23 p-primes of 55 bits
BOOT_BATCH = 2  # `bench.py:738`
BOOT_SEED = 17  # `bench.py:726`
BOOT_EM = dict(k=24, r=4, degree=34)  # `bench.py:773`
BOOT_SMALL = dict(log_n=4, log_qi=55, big_l=16)  # B2: the ring of `tests/test_torch_ckks_bootstrap_e2e.py`
BOOT_WARM = 3  # warm bootstraps timed one by one
BOOT_REPS = 20  # eager calls and CUDA-graph launches a B1 timing averages
BOOT_BITS = 16.0  # `tests/test_ckks_bootstrap.py::test_full_bootstrap_n8192`
BOOT_LEVELS = 2  # levels left that the same test asks for
BOOT_INSTANCES = (
    "rns_mac_gather_kernel<4>", "rns_intt_mac_gather_kernel<true,13>", "rns_intt_mac_shared_kernel<1>",
    "rns_intt_mac_shared_kernel<2>", "rns_intt_mac_shared_kernel<3>", "rns_intt_mac_shared_kernel<4>",
    "automorphism_kernel<4>", "base_convert_kernel<1>", "base_convert_kernel<0>",
)  # fmt: skip
BOOT_LOW = 5  # SlotToCoeff's limbs at its b sums of 4 terms (the path's 10-row launches)


def gather_mac_ops(values: int, terms: int, sums: int, fused: bool, shared: bool = False) -> np.ndarray:
    """K-RNS-MAC's gathered instances on `values` outputs of each of `sums`
    sums of `terms` products: per sum and value the 128-bit multiply-adds,
    one REDC and the add of its residue mod q (the terms are a run-time
    count; not in the shared-x instances inside the inverse, whose count is
    a constant of one chunk); alone, also the REDC by 2^128 mod q. The
    gather's index loads are not counted (no arithmetic)."""
    return values * sums * (terms * MAC128 + REDC64 + (0 if shared else ADD_Q64) + (0 if fused else REDC64))


def bootstrap_cases(params, batch: int, rng, dev):
    """B1's timed launches at the bootstrap's shapes: the gathered MAC as
    W[j] (a digit of the hoisted mask through sigma_j, the key's b and a
    sums) and as a giant group's b sum (4 diagonals, b read through 3
    permutations and in place) inside the inverse, at CoeffToSlot's 23
    limbs and SlotToCoeff's BOOT_LOW (the shared-x instance), and at 23
    with 4 distinct x (the instance for any x); K-AUTOMORPH on b and a;
    K-BASECONV from one limb (mod_raise, b and a stacked) and from 23
    (the hoist at the top level); the transforms at 46 and 23 limbs;
    K-RESCALE at k=1 and k=23 (the key switch's b and a). Returns
    ({(name, shape): (kernel call, plain call, bytes, instructions)}, the
    operands B1 also checks with every permutation). The transforms at
    BOOT_LOW limbs time `rns_intt` at the gathered sums' rows beside them."""
    from learn_fhe_tpu_torch.models.ckks import bootstrapping as Bt
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.ops import rns
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch

    qs, ps, qps, n, B = params.qs, params.ps, params.qps, params.n, batch
    L, P = len(qs), len(ps)

    def residues(basis, lead):
        x = np.stack([rng.integers(0, q, size=(*lead, n), dtype=np.uint64) for q in basis], axis=-2)
        x.reshape(-1)[:2] = [0, basis[0] - 1]
        return u64_to_torch(x).to(dev)

    plan_q, plan_qp = params.plan(qs), params.plan(qps)
    js = Bt.rotation_indices(Bt.BootstrapParams(params, r=3))
    sig = [C._eval_perm(n, params.pow5(j), dev) for j in js]
    x46, kb, ka = residues(qps, (B,)), residues(qps, ()), residues(qps, ())
    be, pts = residues(qs, (B,)), [residues(qs, ()) for _ in range(4)]
    bes = [be, *(residues(qs, (B,)) for _ in range(3))]
    lo = BOOT_LOW
    plan_lo = params.plan(qs[:lo])
    be_lo, pts_lo = be[:, :lo].contiguous(), [pt[:lo].contiguous() for pt in pts]
    ba = torch.stack([residues(qs, (B,)), residues(qs, (B,))])
    ba46 = torch.stack([x46, residues(qps, (B,))])
    low = torch.stack([residues(qs[:1], (B,)), residues(qs[:1], (B,))])
    rp1, rp23 = rns.rescale_plan(qs, 1), rns.rescale_plan(qps, P)
    conv23 = rns.base_convert(ba46[..., L:, :], rp23.drop, rp23.keep, add=rp23.p_half[L:])
    lazy = max(qps) < 1 << 62
    tab = lambda basis: len(basis) * n * 16  # noqa: E731  (a launch's twiddles and duals)
    b_perms = [None, *sig[:3]]
    code = rns.automorphism_code(n, params.pow5(js[0]), dev)
    negated = int((code < 0).sum())
    cases = {
        ("rns_mac_gather", (B, L + P, n)): (
            lambda: rns.rns_mac([x46], [kb], plan_qp, [ka], sig[:1]), lambda: rns.rns_mac_ref([x46], [kb], plan_qp, [ka], sig[:1]),
            3 * B * (L + P) * n * 8 + 2 * (L + P) * n * 8 + n * 4, gather_mac_ops(B * (L + P) * n, 1, 2, False)),
        ("rns_intt_mac_gather", (B, L, n)): (
            lambda: rns.rns_intt_mac([be] * 4, pts, plan_q, perms=b_perms),
            lambda: rns.rns_intt_mac_ref([be] * 4, pts, plan_q, perms=b_perms),
            2 * B * L * n * 8 + 4 * L * n * 8 + 3 * n * 4 + tab(qs), intt64_ops(B * L, n, lazy) + gather_mac_ops(B * L * n, 4, 1, True, True)),
        ("rns_intt_mac_gather", (B, lo, n)): (
            lambda: rns.rns_intt_mac([be_lo] * 4, pts_lo, plan_lo, perms=b_perms),
            lambda: rns.rns_intt_mac_ref([be_lo] * 4, pts_lo, plan_lo, perms=b_perms),
            2 * B * lo * n * 8 + 4 * lo * n * 8 + 3 * n * 4 + tab(qs[:lo]), intt64_ops(B * lo, n, lazy) + gather_mac_ops(B * lo * n, 4, 1, True, True)),
        ("rns_intt_mac_gather", f"({B}, {L}, {n}) distinct x"): (
            lambda: rns.rns_intt_mac(bes, pts, plan_q, perms=b_perms),
            lambda: rns.rns_intt_mac_ref(bes, pts, plan_q, perms=b_perms),
            5 * B * L * n * 8 + 4 * L * n * 8 + 3 * n * 4 + tab(qs), intt64_ops(B * L, n, lazy) + gather_mac_ops(B * L * n, 4, 1, True)),
        ("automorphism_rns", (2, B, L, n)): (
            lambda: rns.automorphism_rns((ba[0], ba[1]), params.pow5(js[0]), qs),
            lambda: tuple(rns.automorphism_rns_ref(v, params.pow5(js[0]), qs) for v in ba),
            2 * 2 * B * L * n * 8 + n * 4, 2 * B * L * negated * CSUB64),
        ("base_convert", f"1->{L - 1}"): (lambda: rns.base_convert(low, qs[:1], qs[1:]), lambda: rns.base_convert_ref(low, qs[:1], qs[1:]),
                                    2 * B * L * n * 8, base_convert_ops(2 * B * n, qs[:1], L - 1, False)),
        ("base_convert", f"{L}->{P}"): (lambda: rns.base_convert(be, qs, ps), lambda: rns.base_convert_ref(be, qs, ps),
                                        B * (L + P) * n * 8, base_convert_ops(B * n, qs, P, False)),
        ("rns_ntt", (B, L + P, n)): (lambda: rns.rns_ntt(x46, plan_qp), lambda: rns.rns_ntt_ref(x46, plan_qp),
                                     2 * B * (L + P) * n * 8 + tab(qps), ntt64_ops(B * (L + P), n, lazy)),
        ("rns_ntt", (B, L, n)): (lambda: rns.rns_ntt(be, plan_q), lambda: rns.rns_ntt_ref(be, plan_q),
                                 2 * B * L * n * 8 + tab(qs), ntt64_ops(B * L, n, lazy)),
        ("rns_intt", (B, L + P, n)): (lambda: rns.rns_intt(x46, plan_qp), lambda: rns.rns_intt_ref(x46, plan_qp),
                                      2 * B * (L + P) * n * 8 + tab(qps), intt64_ops(B * (L + P), n, lazy)),
        ("rns_intt", (B, L, n)): (lambda: rns.rns_intt(be, plan_q), lambda: rns.rns_intt_ref(be, plan_q),
                                  2 * B * L * n * 8 + tab(qs), intt64_ops(B * L, n, lazy)),
        ("rns_intt", (B, lo, n)): (lambda: rns.rns_intt(be_lo, plan_lo), lambda: rns.rns_intt_ref(be_lo, plan_lo),
                                   2 * B * lo * n * 8 + tab(qs[:lo]), intt64_ops(B * lo, n, lazy)),
        ("rescale", "k=1"): (lambda: rns.rescale_finish(be, None, rp1), lambda: rns.rescale_finish_ref(be, None, rp1),
                             B * (2 * L - 1) * n * 8, rescale_ops(B * (L - 1) * n, True)),
        ("rescale", f"k={P}"): (lambda: rns.rescale_finish(ba46, conv23, rp23), lambda: rns.rescale_finish_ref(ba46, conv23, rp23),
                                3 * 2 * B * L * n * 8, rescale_ops(2 * B * L * n, False)),
    }  # fmt: skip
    return cases, dict(sig=sig, js=js, x46=x46, kb=kb, ka=ka, be=be, bes=bes, pts=pts, ba=ba, low=low, ba46=ba46)


def bootstrap_b1(dev, tag, pipe_per_s, errs, timings, bounds, graphs) -> None:
    """B1 (see the module's docstring); adds the gathered MAC's and
    K-AUTOMORPH's entries to the kernels line's dicts."""
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.ops import rns

    t0 = time.perf_counter()
    params = C.CkksParams(**BOOT)
    qs, ps, qps, n, B = params.qs, params.ps, params.qps, params.n, BOOT_BATCH
    L, P = len(qs), len(ps)
    report = kernels_report()
    for name in BOOT_INSTANCES:
        regs, st, ld, stack = report[name]
        say(f"  ptxas: {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads, {stack} bytes stack frame")
    cases, ops = bootstrap_cases(params, B, np.random.default_rng(41), dev)
    plan_q, plan_qp = params.plan(qs), params.plan(qps)

    def check(name, fn, got_call, plain_call, gathered=False, shared=None):
        before, g_before, s_before = fn.launches, getattr(fn, "gather_launches", 0), getattr(fn, "shared_launches", 0)
        got = got_call()
        if fn.launches != before + 1 or (gathered and fn.gather_launches != g_before + 1):
            raise AssertionError(f"B1 {name}: the wrapper did not launch its kernel once")
        if shared is not None and fn.shared_launches != s_before + int(shared):
            raise AssertionError(f"B1 {name}: the wrapper {'did not take' if shared else 'took'} the shared-x instance")
        want = plain_call()
        for g, w in zip(got, want) if isinstance(got, tuple) else ((got, want),):
            errs[name] = max(errs.get(name, 0.0), max_abs_err(g, w.cpu()))

    # every permutation of the path (its 22 rotations and the identity) in
    # W[j] and in the key switch's sums of 1-4 terms with z, and b's sums of
    # 2-4; the sums with one x (the shared-x instances) and with distinct x
    sig = [*ops["sig"], C._eval_perm(n, 1, dev)]
    x46, kb, ka, be, pts = ops["x46"], ops["kb"], ops["ka"], ops["be"], ops["pts"]
    x46s, bes = (x46, ops["ba46"][1]), ops["bes"]
    for k, p in enumerate(sig):
        check("rns_mac_gather", rns.rns_mac, lambda p=p: rns.rns_mac([x46], [kb], plan_qp, [ka], [p]),
              lambda p=p: rns.rns_mac_ref([x46], [kb], plan_qp, [ka], [p]), True)  # fmt: skip
        terms = k % 4 + 1
        perms = [sig[(k + t) % len(sig)] for t in range(terms)]
        for xs in ([x46] * terms, [x46s[t % 2] for t in range(terms)]):
            check("rns_intt_mac_gather", rns.rns_intt_mac, lambda xs=xs, t=terms, ps_=perms: rns.rns_intt_mac(xs, [kb] * t, plan_qp, [ka] * t, ps_),
                  lambda xs=xs, t=terms, ps_=perms: rns.rns_intt_mac_ref(xs, [kb] * t, plan_qp, [ka] * t, ps_), True, rns._shared_x(xs))  # fmt: skip
        b_perms = [None, *[sig[(k + t) % len(sig)] for t in range(k % 3 + 1)]]  # 2-4 terms, j = 0's in place
        for xs, shared in (([be] * len(b_perms), True), (bes[: len(b_perms)], False)):
            check("rns_intt_mac_gather", rns.rns_intt_mac, lambda xs=xs, ps_=b_perms: rns.rns_intt_mac(xs, pts[: len(ps_)], plan_q, perms=ps_),
                  lambda xs=xs, ps_=b_perms: rns.rns_intt_mac_ref(xs, pts[: len(ps_)], plan_q, perms=ps_), True, shared)  # fmt: skip
    for j in (*ops["js"], 0):
        t = params.pow5(j) if j else -1
        check("automorphism_rns", rns.automorphism_rns, lambda t=t: rns.automorphism_rns((ops["ba"][0], ops["ba"][1]), t, qs),
              lambda t=t: tuple(rns.automorphism_rns_ref(v, t, qs) for v in ops["ba"]))  # fmt: skip
    for lq in range(1, L + 1):  # the hoist from every level
        x = be[:, :lq].contiguous()
        check("base_convert", rns.base_convert, lambda x=x, lq=lq: rns.base_convert(x, qs[:lq], ps), lambda x=x, lq=lq: rns.base_convert_ref(x, qs[:lq], ps))
    wrappers = {"rns_mac_gather": rns.rns_mac, "rns_intt_mac_gather": rns.rns_intt_mac, "automorphism_rns": rns.automorphism_rns,
                "base_convert": rns.base_convert, "rns_ntt": rns.rns_ntt, "rns_intt": rns.rns_intt, "rescale": rns.rescale_finish}  # fmt: skip
    for (name, shape), (kernel, plain, *_) in cases.items():
        shared = None if name != "rns_intt_mac_gather" else not isinstance(shape, str)  # "... distinct x"
        check(name, wrappers[name], kernel, plain, name.endswith("_gather"), shared)
    xr = ops["ba46"]
    rp = rns.rescale_plan(qps, P)
    errs["rescale"] = max(errs["rescale"], max_abs_err(rns.rescale_k(xr, qps, P), rns.rescale_finish_ref(
        xr, rns.base_convert_ref(xr[..., L:, :], rp.drop, rp.keep, add=rp.p_half[L:]), rp).cpu()))  # fmt: skip
    say(f"B1 the gathered rns_mac (W[j]) and rns_intt_mac (1-4 terms with z, and b's sums of 2-4; each with one x, the shared-x instances, and with distinct x) at ({B}, {L + P} | {L}, {n}) through each of the path's {len(sig) - 1} permutations and the identity, K-AUTOMORPH on b and a ({B}, {L}, {n}) for each rotation and t = -1, K-BASECONV from 1 -> {L - 1} and from every level 1..{L} -> {P}, K-RNS-NTT at {L + P} and {L} limbs, K-RESCALE at k=1 and k={P} == plain, each wrapper launching its kernel once a call: ok")
    graphed = {}
    for (name, shape), (kernel, plain, n_bytes, ops_) in cases.items():
        k_ms, g_ms, p_ms = cuda_ms(kernel, BOOT_REPS), graph_ms(kernel, BOOT_REPS), cuda_ms(plain, 3)
        graphed[name, shape] = g_ms
        b_ms, by = bound_ms(n_bytes, ops_, pipe_per_s)
        if name not in timings:  # the new rows of the kernels line
            timings[name], graphs[name], bounds[name] = (k_ms, p_ms), g_ms, (b_ms, by)
        say(f"{tag} B1 {name} {shape}: kernel {k_ms * 1e3:.2f} us eager ({BOOT_REPS} wrapper calls), {g_ms * 1e3:.2f} us from a CUDA graph; plain {p_ms * 1e3:.1f} us; bound {b_ms * 1e3:.2f} us by {by} ({n_bytes / 1e6:.1f} MB; {ops_[0] / 1e6:.1f} M FMA, {ops_[1] / 1e6:.1f} M ALU, {ops_[2] / 1e6:.1f} M either) = {b_ms / g_ms:.4f} of bound from the graph")
    for (name, shape), g_ms in graphed.items():  # the gathered sums beside the inverse transform alone
        if name == "rns_intt_mac_gather":
            rows = (B, L, n) if isinstance(shape, str) else shape
            t_ms = graphed["rns_intt", rows]
            say(f"{tag} B1 rns_intt_mac_gather {shape}: {g_ms * 1e3:.2f} us from a CUDA graph, rns_intt at the same rows {t_ms * 1e3:.2f} us: the sums cost {(g_ms - t_ms) * 1e3:.2f} us")
    say(f"{tag} B1 took {time.perf_counter() - t0:.1f} s (host clock)")


def bootstrap_setup(params, rng, dev, batch: int):
    """Keys and a batch of exhausted ciphertexts, drawn in `bench.py`'s order
    (`bench_ckks_bootstrap`): the secret (sparse ternary, h = 64, where N
    allows), rlk, cjk, the bootstrap key, then per ciphertext its message
    (x 1e-4) and its encryption at the top level, dropped to (q0,)."""
    from learn_fhe_tpu_torch.models.ckks import bootstrapping as Bt
    from learn_fhe_tpu_torch.models.ckks import ckks as C

    sk = C.sk_gen_sparse(params, min(64, params.n // 2), rng)
    rlk, cjk = C.rlk_gen(params, sk, rng, dev), C.cjk_gen(params, sk, rng, dev)
    bk = Bt.key_gen(Bt.BootstrapParams(params, r=3), sk, rng, dev)
    ms = [(rng.standard_normal(params.l) + 1j * rng.standard_normal(params.l)) * 1e-4 for _ in range(batch)]
    lows = [C.to_level(C.sk_encrypt(params, sk, C.encode(params, m, device=dev), params.qs, rng), params.qs[:1]) for m in ms]
    low = C.CkksCiphertext(torch.stack([c.b for c in lows]), torch.stack([c.a for c in lows]), params.qs[:1])
    return sk, rlk, cjk, bk, ms, low


def bootstrap_b2(dev, tag) -> None:
    """B2: the bootstrap at N=16, L=16 on the card == the port's CPU path."""
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.models.ckks import evalmod as E

    t0 = time.perf_counter()
    outs = []
    for device in (dev, torch.device("cpu")):
        params = C.CkksParams(**BOOT_SMALL)
        _, rlk, cjk, bk, _, low = bootstrap_setup(params, np.random.default_rng(BOOT_SEED), device, BOOT_BATCH)
        outs.append(E.bootstrap(params, bk, rlk, cjk, low))
    got, want = outs
    if got.qs != want.qs:
        raise AssertionError("B2: the card's bootstrap ends at another level than the CPU's")
    max_abs_err(got.b, want.b)
    max_abs_err(got.a, want.a)
    say(f"{tag} B2 the bootstrap at N=16, L=16, r=3, default EvalModParams, batch {BOOT_BATCH} on the card == the port's CPU path, bit for bit ({len(got.qs)} levels left; {time.perf_counter() - t0:.1f} s, host clock)")


BOOT_COUNTED = ("rns_ntt", "rns_intt", "rns_mac", "rns_intt_mac", "base_convert", "rescale_finish", "automorphism_rns")


def bootstrap_b3(dev, tag, launches) -> None:
    """B3, the bootstrap path (see the module's docstring): key generation,
    a cold bootstrap, one warm one with the launch counters, the outputs'
    levels and precision, the warm bootstraps' times, the host enqueue, a
    CUDA graph's device time and the profiler. Adds the gathered MAC's and
    K-AUTOMORPH's launches to `launches`."""
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.models.ckks import evalmod as E
    from learn_fhe_tpu_torch.ops import rns

    params = C.CkksParams(**BOOT)
    B, em = BOOT_BATCH, E.EvalModParams(**BOOT_EM)
    fns = {name: getattr(rns, name) for name in BOOT_COUNTED}

    def zero():
        for fn in fns.values():
            fn.launches, fn.by_rows = 0, Counter()
        for fn in (rns.rns_mac, rns.rns_intt_mac):
            fn.gather_launches, fn.gather_by_rows = 0, Counter()
        rns.rns_intt_mac.shared_launches = 0

    zero()
    t0 = time.perf_counter()
    sk, rlk, cjk, bk, ms, low = bootstrap_setup(params, np.random.default_rng(BOOT_SEED), dev, B)
    torch.cuda.synchronize()
    keygen_s = time.perf_counter() - t0
    key_launches = {name: fn.launches for name, fn in fns.items() if fn.launches}
    if not key_launches.get("rns_ntt") or any(k.ksk.b.device != dev for k in bk.rtk.values()):
        raise AssertionError("B3: the bootstrap key was not made on the card by its kernels")
    say(f"{tag} B3 keys (sparse secret h=64, rlk, cjk, {len(bk.rtk)} rotation keys), 2 x {B} messages encoded, encrypted and dropped to (q0,) on the card: {keygen_s:.2f} s (host clock, to a sync); launches {key_launches}")
    run = lambda: E.bootstrap(params, bk, rlk, cjk, low, em)  # noqa: E731
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    say(f"{tag} B3 cold bootstrap of the batch of {B} (the diagonals' and constants' encodes included): {time.perf_counter() - t0:.2f} s (host clock, to a sync)")
    zero()
    out = run()
    torch.cuda.synchronize()
    for name, fn in fns.items():
        launches[f"boot_{name}"] = fn.launches
    launches["rns_mac_gather"], launches["rns_intt_mac_gather"] = rns.rns_mac.gather_launches, rns.rns_intt_mac.gather_launches
    launches["automorphism_rns"] = rns.automorphism_rns.launches
    say(f"B3 launches of one warm bootstrap of the batch of {B}: " + ", ".join(f"{name} {fn.launches}" for name, fn in fns.items()) + f"; the gathered instances: rns_mac {rns.rns_mac.gather_launches}, rns_intt_mac {rns.rns_intt_mac.gather_launches}")
    for name, fn in fns.items():
        say(f"  B3 {name} by rows: {dict(sorted(fn.by_rows.items(), key=str))}")
    say(f"  B3 the gathered rns_intt_mac by (output rows, terms): {dict(sorted(rns.rns_intt_mac.gather_by_rows.items()))}; of its {rns.rns_intt_mac.gather_launches} launches {rns.rns_intt_mac.shared_launches} took the shared-x instance")
    lq1 = sum(c for (_, lq, _), c in rns.base_convert.by_rows.items() if lq == 1)
    must = {"the gathered rns_intt_mac": rns.rns_intt_mac.gather_launches, "its shared-x instance": rns.rns_intt_mac.shared_launches,
            "K-AUTOMORPH": rns.automorphism_rns.launches,
            "K-BASECONV at lq = 1": lq1, "K-RNS-NTT": rns.rns_ntt.launches, "K-RESCALE": rns.rescale_finish.launches,
            "the key switches' rns_intt_mac": rns.rns_intt_mac.launches - rns.rns_intt_mac.gather_launches}  # fmt: skip
    for what, count in must.items():
        if not count:
            raise AssertionError(f"B3: {what} was not launched on the bootstrap")
    levels = len(out.qs)
    if out.b.shape != (B, levels, params.n) or levels < BOOT_LEVELS:
        raise AssertionError(f"B3: the bootstrap's output is {tuple(out.b.shape)} at {levels} levels (at least {BOOT_LEVELS} asked)")
    bits = []
    for i, m in enumerate(ms):
        one = C.CkksCiphertext(out.b[i], out.a[i], out.qs)
        got = C.decode(params, C.decrypt(params, sk, one), out.qs)
        bits.append(float(-np.log2(np.max(np.abs(got - m)) / np.max(np.abs(m)))))
    say(f"B3 the bootstrap of the batch of {B} at N={params.n}, L={len(params.qs)}: {levels} levels left; relative bits of each decrypted ciphertext against its message {[round(b, 2) for b in bits]} (more than {BOOT_BITS} asked, `tests/test_ckks_bootstrap.py::test_full_bootstrap_n8192`)")
    if min(bits) <= BOOT_BITS:
        raise AssertionError("B3: a bootstrapped ciphertext is outside its precision budget")
    times = []
    for _ in range(BOOT_WARM):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    say(f"{tag} B3 warm bootstrap of the batch of {B}: {med:.4f} s (median of {BOOT_WARM}, {min(times):.4f}-{max(times):.4f}; host clock to a sync) = {med / B:.4f} s per ciphertext = {B / med:.3f} bootstraps/s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    say(f"{tag} B3 warm bootstrap: host enqueue {host_s:.4f} s, wall with sync {wall_s:.4f} s")
    g_ms = graph_ms(run, 1)
    say(f"{tag} B3 warm bootstrap from a CUDA graph: {g_ms:.3f} ms per batch of {B} (device only) = {g_ms / B:.3f} ms per ciphertext; the device's idle share in an eager call, 1 - graph / eager median = {1 - g_ms / (med * 1e3):.4f}")
    idle, kernel_ms, top = device_kernel_ms(run)
    if kernel_ms:
        say(f"{tag} B3 warm bootstrap: device idle share {idle:.4f} (profiler, union of kernel intervals); summed kernel time {kernel_ms:.3f} ms")
        for name, t, count in top:
            say(f"  {t:10.3f} ms  {count:6d} x  {name[:100]}")
    else:
        say(f"{tag} B3 device kernel time and idle share: not measured (the profiler recorded no device activity)")


PROD_LOG_N = 16  # `production_config(16)`: N=2^16, L=30 (55 | 52 x 4 | 52 x 3 | 56 x 19 | 52 x 3), P = 2 x 59 bits, dnum 15
PROD_SEED = 2026  # `bench/production_bootstrap_probe.py:70`
PROD_AMP = 0.3  # the probe's --amp
PROD_KEYGROUP = 4  # rotation keys per rtk_gen_many call, in sorted index order (the probe's --keygroup)
PROD_BITS = 14.0  # bootstrap bits asked on the card
PROD_USER_BITS = 10.0  # bits after the user squarings (`PRODUCTION_r05.json`'s after_user_muls_bits_min)
PROD_RECORD = (15.7, 14.1)  # the JAX package's record for this seed and knobs (`PRODUCTION_r05.json`, attempt 1)
PROD_REPS = 5  # eager calls and CUDA-graph launches a P1 timing averages
PROD_TERMS = 8  # a giant group's b sum at the CoeffToSlot chunks (up to 8 baby steps)
PROD_INSTANCES = (
    "rns_ntt_kernel<false,true,16>", "rns_ntt_kernel<true,true,16>", "rns_intt_mac_kernel<true,16,0>",
    "rns_intt_mac_kernel<true,16,1>", "rns_intt_mac_kernel<true,16,2>", "rns_intt_mac_gather_kernel<true,16>",
)  # fmt: skip


def production_cases(params, rng, dev):
    """P1's launches at the production bootstrap's shapes (N=2^16): K-RNS-NTT
    on a key switch's 15 hoisted digits (15, 32, N) and the inverse on a
    ciphertext's b and a (2, 30, N); rns_intt_mac with 1 and 2 terms (a
    `mul`'s tensor, (1, 30, N)) and the key switch's 15 digits with z
    against the key (32, N); the gathered instance as a giant group's b
    sum (PROD_TERMS terms of one x, (1, 30, N): past 2^13 the distinct-x
    instance) and W[j] (`rns_mac`, 15 digits through sigma_j with z);
    K-BASECONV 1 -> 29 (mod_raise, b and a) and 2 -> 30 (a digit's hoist);
    K-RESCALE at k=1 and k=2 (P); K-AUTOMORPH on b and a. Returns {(name,
    shape): (kernel call, plain call, bytes, instructions)}."""
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.ops import rns
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch

    qs, ps, qps, n = params.qs, params.ps, params.qps, params.n
    L, P, D = len(qs), len(ps), params.num_digits

    def residues(basis, lead):
        x = np.stack([rng.integers(0, q, size=(*lead, n), dtype=np.uint64) for q in basis], axis=-2)
        x.reshape(-1)[:2] = [0, basis[0] - 1]
        return u64_to_torch(x).to(dev)

    plan_q, plan_qp = params.plan(qs), params.plan(qps)
    lazy = max(qps) < 1 << 62
    tab = lambda basis: len(basis) * n * 16  # noqa: E731  (a launch's twiddles and duals)
    digits = residues(qps, (D,))
    dl = [digits[d] for d in range(D)]
    kb, ka = [residues(qps, ()) for _ in range(D)], [residues(qps, ()) for _ in range(D)]
    ba = residues(qs, (2,))
    x1, y1, y2 = residues(qs, (1,)), residues(qs, ()), residues(qs, ())
    pts = [residues(qs, ()) for _ in range(PROD_TERMS)]
    js = [1, 2, 3, 4, 5, 6, 7, 8, 16, 24, 32]
    sig = [C._eval_perm(n, params.pow5(j), dev) for j in js]
    b_perms = [None, *sig[: PROD_TERMS - 1]]
    low = residues(qs[:1], (2,))
    dig2 = residues(qs[:2], (1,))
    rest = qs[2:] + ps
    xqp = residues(qps, (2,))
    rp1, rpp = rns.rescale_plan(qs, 1), rns.rescale_plan(qps, P)
    conv = rns.base_convert(xqp[..., L:, :], rpp.drop, rpp.keep, add=rpp.p_half[L:])
    t = params.pow5(js[0])
    negated = int((rns.automorphism_code(n, t, dev) < 0).sum())
    mac_f = lambda values, terms, sums: gather_mac_ops(values, terms, sums, True)  # noqa: E731  (a run-time count of terms)
    cases = {
        ("rns_ntt", (D, L + P, n)): (lambda: rns.rns_ntt(digits, plan_qp), lambda: rns.rns_ntt_ref(digits, plan_qp),
                                     2 * D * (L + P) * n * 8 + tab(qps), ntt64_ops(D * (L + P), n, lazy)),
        ("rns_intt", (2, L, n)): (lambda: rns.rns_intt(ba, plan_q), lambda: rns.rns_intt_ref(ba, plan_q),
                                  2 * 2 * L * n * 8 + tab(qs), intt64_ops(2 * L, n, lazy)),
        ("rns_intt_mac", "1 term"): (lambda: rns.rns_intt_mac([x1], [y1], plan_q), lambda: rns.rns_intt_mac_ref([x1], [y1], plan_q),
                                     3 * L * n * 8 + tab(qs), intt64_ops(L, n, lazy) + rns_mac_ops(L * n, 1, 1, True)),
        ("rns_intt_mac", "2 terms"): (lambda: rns.rns_intt_mac([x1, x1], [y1, y2], plan_q), lambda: rns.rns_intt_mac_ref([x1, x1], [y1, y2], plan_q),
                                      5 * L * n * 8 + tab(qs), intt64_ops(L, n, lazy) + rns_mac_ops(L * n, 2, 1, True)),
        ("rns_intt_mac", f"key switch, {D} digits"): (
            lambda: rns.rns_intt_mac(dl, kb, plan_qp, ka), lambda: rns.rns_intt_mac_ref(dl, kb, plan_qp, ka),
            (3 * D + 2) * (L + P) * n * 8 + tab(qps), intt64_ops(2 * (L + P), n, lazy) + mac_f((L + P) * n, D, 2)),
        ("rns_intt_mac_gather", f"b sum, {PROD_TERMS} terms"): (
            lambda: rns.rns_intt_mac([x1] * PROD_TERMS, pts, plan_q, perms=b_perms),
            lambda: rns.rns_intt_mac_ref([x1] * PROD_TERMS, pts, plan_q, perms=b_perms),
            (2 + PROD_TERMS) * L * n * 8 + (PROD_TERMS - 1) * n * 4 + tab(qs), intt64_ops(L, n, lazy) + mac_f(L * n, PROD_TERMS, 1)),
        ("rns_mac_gather", f"W[j], {D} digits"): (
            lambda: rns.rns_mac(dl, kb, plan_qp, ka, [sig[0]] * D), lambda: rns.rns_mac_ref(dl, kb, plan_qp, ka, [sig[0]] * D),
            (3 * D + 2) * (L + P) * n * 8 + n * 4, gather_mac_ops((L + P) * n, D, 2, False)),
        ("base_convert", f"1->{L - 1}"): (lambda: rns.base_convert(low, qs[:1], qs[1:]), lambda: rns.base_convert_ref(low, qs[:1], qs[1:]),
                                          2 * L * n * 8, base_convert_ops(2 * n, qs[:1], L - 1, False)),
        ("base_convert", f"2->{len(rest)}"): (lambda: rns.base_convert(dig2, qs[:2], rest), lambda: rns.base_convert_ref(dig2, qs[:2], rest),
                                              (2 + len(rest)) * n * 8, base_convert_ops(n, qs[:2], len(rest), False)),
        ("rescale", "k=1"): (lambda: rns.rescale_finish(ba, None, rp1), lambda: rns.rescale_finish_ref(ba, None, rp1),
                             2 * (2 * L - 1) * n * 8, rescale_ops(2 * (L - 1) * n, True)),
        ("rescale", f"k={P}"): (lambda: rns.rescale_finish(xqp, conv, rpp), lambda: rns.rescale_finish_ref(xqp, conv, rpp),
                                3 * 2 * L * n * 8, rescale_ops(2 * L * n, False)),
        ("automorphism_rns", (2, L, n)): (lambda: rns.automorphism_rns((ba[0], ba[1]), t, qs),
                                          lambda: tuple(rns.automorphism_rns_ref(v, t, qs) for v in ba),
                                          2 * 2 * L * n * 8 + n * 4, 2 * L * negated * CSUB64),
    }  # fmt: skip
    return cases


# the kernels line's rows of the production ring: (row, P1's case)
PROD_ROWS = {
    "rns_ntt_n65536": ("rns_ntt", (15, 32, 1 << 16)),
    "rns_intt_n65536": ("rns_intt", (2, 30, 1 << 16)),
    "rns_intt_mac_n65536": ("rns_intt_mac", "key switch, 15 digits"),
    "rns_intt_mac_gather_n65536": ("rns_intt_mac_gather", f"b sum, {PROD_TERMS} terms"),
}


def production_p1(dev, tag, pipe_per_s, errs, timings, bounds, graphs) -> None:
    """P1: the kernels at the production bootstrap's shapes (see the module's
    docstring) against their plain versions, each wrapper launching once a
    call, timed eager and from a CUDA graph against its bound; adds the
    kernels line's rows of the production ring (PROD_ROWS)."""
    from learn_fhe_tpu_torch.models.ckks.production import production_config
    from learn_fhe_tpu_torch.ops import rns

    t0 = time.perf_counter()
    params = production_config(PROD_LOG_N).params
    report = kernels_report()
    for name in PROD_INSTANCES:
        regs, st, ld, stack = report[name]
        say(f"  ptxas: {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads, {stack} bytes stack frame")
    cases = production_cases(params, np.random.default_rng(61), dev)
    wrappers = {"rns_ntt": rns.rns_ntt, "rns_intt": rns.rns_intt, "rns_intt_mac": rns.rns_intt_mac, "rns_intt_mac_gather": rns.rns_intt_mac,
                "rns_mac_gather": rns.rns_mac, "base_convert": rns.base_convert, "rescale": rns.rescale_finish,
                "automorphism_rns": rns.automorphism_rns}  # fmt: skip
    p1_errs = {}
    for (name, shape), (kernel, plain, *_) in cases.items():
        fn = wrappers[name]
        before, shared = fn.launches, rns.rns_intt_mac.shared_launches
        got = kernel()
        if fn.launches != before + 1 or rns.rns_intt_mac.shared_launches != shared:
            raise AssertionError(f"P1 {name} {shape}: the wrapper did not launch its kernel once (or took the shared-x instance)")
        want = plain()
        for g, w in zip(got, want) if isinstance(got, tuple) else ((got, want),):
            p1_errs[name, shape] = max(p1_errs.get((name, shape), 0.0), max_abs_err(g, w.cpu()))
        errs[name] = max(errs.get(name, 0.0), p1_errs[name, shape])
    say(f"P1 at N={params.n}, L={len(params.qs)}, P={len(params.ps)}, dnum {params.num_digits}: K-RNS-NTT (15 digits x 32 limbs), the inverse (b and a), rns_intt_mac with 1, 2 and 15 terms (the last with z), the gathered rns_intt_mac ({PROD_TERMS} terms of one x: the distinct-x instance) and rns_mac (W[j]), K-BASECONV 1->29 and 2->30, K-RESCALE k=1 and k=2, K-AUTOMORPH == plain, each wrapper launching its kernel once a call: ok")
    for (name, shape), (kernel, plain, n_bytes, ops_) in cases.items():
        k_ms, g_ms, p_ms = cuda_ms(kernel, PROD_REPS), graph_ms(kernel, PROD_REPS), cuda_ms(plain, 2)
        b_ms, by = bound_ms(n_bytes, ops_, pipe_per_s)
        for row, case in PROD_ROWS.items():
            if case == (name, shape):
                timings[row], graphs[row], bounds[row], errs[row] = (k_ms, p_ms), g_ms, (b_ms, by), p1_errs[name, shape]
        say(f"{tag} P1 {name} {shape}: kernel {k_ms * 1e3:.2f} us eager ({PROD_REPS} wrapper calls), {g_ms * 1e3:.2f} us from a CUDA graph; plain {p_ms * 1e3:.1f} us; bound {b_ms * 1e3:.2f} us by {by} ({n_bytes / 1e6:.1f} MB; {ops_[0] / 1e6:.1f} M FMA, {ops_[1] / 1e6:.1f} M ALU, {ops_[2] / 1e6:.1f} M either) = {b_ms / g_ms:.4f} of bound from the graph")
    say(f"{tag} P1 took {time.perf_counter() - t0:.1f} s (host clock)")


class _Timed:
    """A module function wrapped to add its host seconds (after a sync where
    `sync`) to a total; `restore` puts the original back."""

    def __init__(self, module, name: str, sync: bool = False):
        self.module, self.name, self.fn, self.sync, self.s = module, name, getattr(module, name), sync, 0.0

        def timed(*a, **k):
            if self.sync:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.fn(*a, **k)
            if self.sync:
                torch.cuda.synchronize()
            self.s += time.perf_counter() - t0
            return out

        setattr(module, name, timed)

    def restore(self) -> None:
        setattr(self.module, self.name, self.fn)


def production_p2(dev, tag, launches) -> None:
    """P2, the production bootstrap's path (see the module's docstring): the
    probe's steps (`bench/production_bootstrap_probe.py`) with the port's
    functions on the card. Adds each kernel's launches in one warm
    bootstrap to `launches` (keys `p2_<name>`)."""
    from learn_fhe_tpu_torch.models.ckks import bootstrapping as Bt
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.models.ckks import evalmod as E
    from learn_fhe_tpu_torch.models.ckks.production import eval_mod_levels, production_config
    from learn_fhe_tpu_torch.ops import rns

    t_p2 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cfg = production_config(PROD_LOG_N)
    params, bp = cfg.params, cfg.bootstrap_params
    say(f"P2 config: {cfg.summary()}")
    fns = {name: getattr(rns, name) for name in BOOT_COUNTED}

    def zero():
        for fn in fns.values():
            fn.launches, fn.by_rows = 0, Counter()
        for fn in (rns.rns_mac, rns.rns_intt_mac):
            fn.gather_launches, fn.gather_by_rows = 0, Counter()
        rns.rns_intt_mac.shared_launches = 0

    # -- keys, in the probe's order, with the host draws, the copies to the
    # card and the device work timed apart
    rng = np.random.default_rng(PROD_SEED)
    parts = {
        "host draws": [_Timed(C, "uniform_zq"), _Timed(C, "dg"), _Timed(C, "zo")],
        "host->device copies": [_Timed(C, "u64_to_torch", sync=True), _Timed(C, "_i64", sync=True)],
        "device work": [_Timed(C, "_ksk_gen_core", sync=True)],
    }
    t0 = time.perf_counter()
    try:
        sk = C.sk_gen(params, rng)
        rlk = C.rlk_gen(params, sk, rng, dev)
        cjk = C.cjk_gen(params, sk, rng, dev)
        t_sk = time.perf_counter() - t0
        needed = Bt.rotation_indices(bp)
        t_idx = time.perf_counter() - t0 - t_sk
        rtk = {}
        for s in range(0, len(needed), PROD_KEYGROUP):
            rtk.update(C.rtk_gen_many(params, sk, needed[s : s + PROD_KEYGROUP], rng, dev))
        torch.cuda.synchronize()
    finally:
        for ts in parts.values():
            for t in ts:
                t.restore()
    keygen_s = time.perf_counter() - t0
    bk = Bt.BootstrapKey(bp, rtk)
    by_part = {part: sum(t.s for t in ts) for part, ts in parts.items()}
    rest = keygen_s - sum(by_part.values())
    say(f"{tag} P2 keys (dense secret, rlk, cjk, {len(rtk)} rotation keys in groups of {PROD_KEYGROUP}): {keygen_s:.2f} s (host clock, to a sync): " + ", ".join(f"{p} {s:.2f} s" for p, s in by_part.items()) + f", the rest (host arithmetic, the BSGS plans' rotation indices {t_idx:.2f} s) {rest:.2f} s; rlk and cjk took {t_sk:.2f} s of it; device memory {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    if len(rtk) != len(needed) or any(k.ksk.b.device != dev for k in rtk.values()):
        raise AssertionError(f"P2: the rotation keys are not the {len(needed)} of the plans, made on the card")

    s_user = Fraction(1 << cfg.log_user)
    m = (rng.standard_normal(params.l) + 1j * rng.standard_normal(params.l)) * PROD_AMP
    pt = C.encode(params, m, (params.qs[0],), scale_int=int(s_user), device=dev)
    low = C.sk_encrypt(params, sk, pt, (params.qs[0],), rng)
    c = float(params.qs[0] / s_user)

    def stages():
        times, ct = {}, low
        for name, call in (
            ("mod_raise", lambda x: E.mod_raise(params, x)),
            ("coeff_to_slot", lambda x: Bt.coeff_to_slot(bk, x)),
            ("eval_mod", lambda x: E.eval_mod(params, rlk, cjk, x, cfg.em, c, S_in=s_user, S_out=s_user)),
            ("slot_to_coeff", lambda x: Bt.slot_to_coeff(bk, x)),
        ):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ct = call(ct)
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t
        return ct, times

    _, cold = stages()
    say(f"{tag} P2 cold bootstrap (the diagonals' and constants' host encodes included): {sum(cold.values()):.2f} s; by stage " + ", ".join(f"{k} {v:.3f} s" for k, v in cold.items()) + " (host clock to a sync)")
    zero()
    out, warm = stages()
    for name, fn in fns.items():
        launches[f"p2_{name}"] = fn.launches
    launches["p2_rns_mac_gather"], launches["p2_rns_intt_mac_gather"] = rns.rns_mac.gather_launches, rns.rns_intt_mac.gather_launches
    say(f"{tag} P2 warm bootstrap: {sum(warm.values()):.3f} s; by stage " + ", ".join(f"{k} {v:.3f} s" for k, v in warm.items()) + " (host clock to a sync)")
    say("P2 launches of one warm bootstrap: " + ", ".join(f"{name} {fn.launches}" for name, fn in fns.items()) + f"; the gathered instances: rns_mac {rns.rns_mac.gather_launches}, rns_intt_mac {rns.rns_intt_mac.gather_launches} (shared-x {rns.rns_intt_mac.shared_launches})")
    for name, fn in fns.items():
        say(f"  P2 {name} by rows: {dict(sorted(fn.by_rows.items(), key=str))}")
    say(f"  P2 the gathered rns_intt_mac by (output rows, terms): {dict(sorted(rns.rns_intt_mac.gather_by_rows.items()))}")
    consumed, predicted = len(params.qs) - len(out.qs), 2 * cfg.n_transform + eval_mod_levels(cfg.em, cfg.baby)
    got = C.decode(params, C.decrypt(params, sk, out), out.qs, scale_int=int(s_user))
    bits = float(-np.log2(np.max(np.abs(got - m)) / np.max(np.abs(m))))
    s_cur, want, ct = s_user, m.copy(), out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    squarings = 0
    while len(ct.qs) >= 2:
        s_cur = s_cur * s_cur / ct.qs[-1]
        ct = C.mul(params, rlk, ct, ct)
        want = want * want
        squarings += 1
    torch.cuda.synchronize()
    mul_s = time.perf_counter() - t0
    raw = C.decode(params, C.decrypt(params, sk, ct), ct.qs, scale_int=1)
    bits2 = float(-np.log2(np.max(np.abs(np.asarray(raw) / float(s_cur) - want)) / max(np.max(np.abs(want)), 1e-300)))
    say(f"P2 the production bootstrap at N={params.n}, L={len(params.qs)}: {len(out.qs)} levels left (1 + {cfg.user_levels} asked), consumed {consumed} = predicted {predicted}; {bits:.2f} relative bits (>= {PROD_BITS} asked; the JAX package's record for this seed and knobs {PROD_RECORD[0]}); after {squarings} user squarings ({mul_s:.3f} s) {bits2:.2f} bits at q0 (>= {PROD_USER_BITS} asked; record {PROD_RECORD[1]}); the flagship spec's >= 20 bits is not asked (the reference's record fails it)")
    if len(out.qs) != 1 + cfg.user_levels or consumed != predicted or squarings != cfg.user_levels:
        raise AssertionError("P2: the bootstrap's levels are not the simulator's")
    if not (bits >= PROD_BITS and bits2 >= PROD_USER_BITS):
        raise AssertionError("P2: the production bootstrap is outside its precision budget")
    if abs(bits - PROD_RECORD[0]) > 0.5 or abs(bits2 - PROD_RECORD[1]) > 0.5:
        say(f"P2 finding: more than 0.5 bits from the JAX package's record ({bits - PROD_RECORD[0]:+.2f}, {bits2 - PROD_RECORD[1]:+.2f})")
    lq1 = sum(k for (_, lq, _), k in rns.base_convert.by_rows.items() if lq == 1)
    must = {"K-RNS-NTT": rns.rns_ntt.launches, "the key switches' rns_intt_mac": rns.rns_intt_mac.launches - rns.rns_intt_mac.gather_launches,
            "the gathered rns_intt_mac": rns.rns_intt_mac.gather_launches, "the gathered rns_mac": rns.rns_mac.gather_launches,
            "K-BASECONV at lq = 1": lq1, "K-RESCALE": rns.rescale_finish.launches, "K-AUTOMORPH": rns.automorphism_rns.launches}  # fmt: skip
    for what, count in must.items():
        if not count:
            raise AssertionError(f"P2: {what} was not launched on the production bootstrap")
    if rns.rns_intt_mac.shared_launches:
        raise AssertionError("P2: the shared-x instance (N = 2^13 only) launched at N = 2^16")

    say(f"{tag} P2 peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB (torch.cuda.max_memory_allocated since P2 began); held now {torch.cuda.memory_allocated() / 1e9:.2f} GB")
    idle, kernel_ms, top = device_kernel_ms(lambda: stages())
    if kernel_ms:
        say(f"{tag} P2 warm bootstrap: device idle share {idle:.4f} (profiler, union of kernel intervals); summed kernel time {kernel_ms:.3f} ms")
        for name, t, count in top:
            say(f"  {t:10.3f} ms  {count:6d} x  {name[:100]}")
    else:
        say(f"{tag} P2 device kernel time and idle share: not measured (the profiler recorded no device activity)")
    say(f"{tag} P2 took {time.perf_counter() - t_p2:.1f} s (host clock)")


def batch_for_cluster(boot, params, cluster: int, dev) -> int | None:
    """The smallest batch for which K-FHEW-BR64's wrapper picks `cluster`
    blocks per ciphertext on this card, or None where no batch picks it."""
    gg, gk = params.rgsw.gadget, params.rlwe.gadget
    batch = 1
    for c in range(cluster + 1, min(boot.WALK64_MAX_CLUSTER, 2 * gg.d, gk.d) + 1):
        batch = max(batch, boot.walk64_resident(c, params, dev) + 1)
    return batch if boot.walk64_cluster(batch, params, dev) == cluster else None


BGV = dict(log_n=14, t=65537, log_qi=45, big_l=4)  # the smallest ring with 4 + 4 primes of 45 bits at 128 bits (utils/security)
BGV_BATCH = 16
BGV_SEED = 17
BGV_REPS = 20  # eager calls and CUDA-graph launches a G1 timing averages
BGV_MUL_CALLS = 5
BGV_PROFILED_MULS = 20
BGV_ROTATIONS = (1, 7)
BGV_INSTANCES = ("bgv_drop_kernel<4>", "bgv_drop_kernel<5>", "bgv_drop_kernel<8>")
# K-BGV-DROP's work, from the u64 operations' SASS counts above: per column
# and drop, the centered residue, two Barrett reductions mod t, the product
# by q_l^-1 mod t and the centered k (two Shoup-sized products and the
# selects); per kept limb and drop, the two centered values into [0, q_i)
# (selects), one Shoup product and two subtracts mod q_i:
# y_i = (x_i - rc) q_l^-1 - kc, as q_l kc q_l^-1 = kc (mod q_i)
DROP_STEP = 2 * SHOUP64 + 3 * CSUB64 + np.array([3, 0, 1])
DROP_LIMB = SHOUP64 + 2 * ADD_Q64 + 2 * CSUB64


def drop_ops(cols: int, limbs: int, k: int, then: int = 0, add_cols: int = 0) -> np.ndarray:
    """K-BGV-DROP on `cols` columns of `limbs` limbs: k drops, the add of
    limbs - k values on `add_cols` of them, then `then` drops."""
    steps = sum(DROP_STEP + (limbs - 1 - s) * DROP_LIMB for s in range(k + then))
    return cols * steps + add_cols * (limbs - k) * ADD_Q64


def bgv_drop_cases(params, rng, dev):
    """G1's launches at N=2^14, batch 16 x (b, a): the key switch's division
    by P (8 limbs, k=4), a mul's whole drop (k=4, the add of d0 and d1, one
    more drop), the rotation's and conjugation's key switch (k=4, the
    permuted b added after the drops), mod_switch at the top level (4 limbs,
    k=1), and 5 limbs at k=1 and k=4. Returns {shape: (kernel call, plain call, bytes, instructions)}."""
    from learn_fhe_tpu_torch.ops import rns
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch

    n, B, t = params.n, BGV_BATCH, params.t
    qs, qps = params.qs, params.qps

    def residues(basis):
        x = np.stack([rng.integers(0, q, size=(B, n), dtype=np.uint64) for q in basis], axis=-2)
        x[0, :, :4] = np.array([[0, q // 2, q // 2 + 1, q - 1] for q in basis])
        return u64_to_torch(x).to(dev)

    cases = {}
    # add: the parts (b, then a) that take an add between the drops
    for basis, k, then, add in ((qps, 4, 0, 0), (qps, 4, 1, 2), (qps, 4, 0, 1), (qs, 1, 0, 0), (qps[:5], 1, 0, 0), (qps[:5], 4, 0, 0)):
        L = len(basis)
        xs = (residues(basis), residues(basis))
        adds = tuple(residues(basis[: L - k]) if i < add else None for i in range(2)) if add else None
        cols, add_cols = 2 * B * n, add * B * n
        n_bytes = 8 * (cols * (L + L - k - then) + add_cols * (L - k))
        label = f"{L}->{L - k - then} (k={k}{', + d0/d1, k=1' if then else ', + b' if add else ''})"
        cases[label] = (
            lambda xs=xs, b=basis, k=k, a=adds, th=then: rns.drop_limbs_t(xs, b, t, k, a, th),
            lambda xs=xs, b=basis, k=k, a=adds, th=then: tuple(
                rns.drop_limbs_t_ref(x, b, t, k, None if a is None else a[i], th) for i, x in enumerate(xs)
            ),
            n_bytes,
            drop_ops(cols, L, k, then, add_cols),
        )
    return cases


def bgv_g1(dev, tag, pipe_per_s, errs, timings, bounds, graphs) -> None:
    """G1 (see the module's docstring): K-BGV-DROP against its plain version
    and its bound; adds its entry to the kernels line's dicts."""
    from learn_fhe_tpu_torch.models.bgv import BgvParams
    from learn_fhe_tpu_torch.ops import rns

    t0 = time.perf_counter()
    params = BgvParams(**BGV)
    report = kernels_report()
    for name in BGV_INSTANCES:
        regs, st, ld, stack = report[name]
        say(f"  ptxas: {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads, {stack} bytes stack frame")
    cases = bgv_drop_cases(params, np.random.default_rng(3), dev)
    for shape, (kernel, plain, *_) in cases.items():
        before = rns.drop_limbs_t.launches
        got = kernel()
        if rns.drop_limbs_t.launches != before + 1:
            raise AssertionError(f"G1 drop_limbs_t {shape}: the wrapper did not launch its kernel once")
        for g, w in zip(got, plain()):
            errs["bgv_drop"] = max(errs.get("bgv_drop", 0.0), max_abs_err(g, w.cpu()))
    say(f"G1 K-BGV-DROP at N={params.n}, batch {BGV_BATCH} x (b, a), {', '.join(cases)} == plain, one launch a call: ok")
    for shape, (kernel, plain, n_bytes, ops) in cases.items():
        k_ms, g_ms, p_ms = cuda_ms(kernel, BGV_REPS), graph_ms(kernel, BGV_REPS), cuda_ms(plain, 3)
        b_ms, by = bound_ms(n_bytes, ops, pipe_per_s)
        if "bgv_drop" not in timings:  # the kernels line takes the key switch's division by P
            timings["bgv_drop"], graphs["bgv_drop"], bounds["bgv_drop"] = (k_ms, p_ms), g_ms, (b_ms, by)
        say(f"{tag} G1 bgv_drop {shape}: kernel {k_ms * 1e3:.2f} us eager ({BGV_REPS} wrapper calls), {g_ms * 1e3:.2f} us from a CUDA graph; plain {p_ms * 1e3:.1f} us; bound {b_ms * 1e3:.2f} us by {by} ({n_bytes / 1e6:.1f} MB; {ops[0] / 1e6:.1f} M FMA, {ops[1] / 1e6:.1f} M ALU, {ops[2] / 1e6:.1f} M either) = {b_ms / g_ms:.4f} of bound from the graph")
    say(f"{tag} G1 took {time.perf_counter() - t0:.1f} s (host clock)")


BGV_COUNTED = ("rns_ntt", "rns_intt", "rns_mac", "rns_intt_mac", "base_convert", "rescale_finish", "automorphism_rns", "drop_limbs_t")


def bgv_g2(dev, tag, launches) -> None:
    """G2, BGV at a deployment's size (see the module's docstring). Adds
    K-BGV-DROP's launches on the path to `launches`."""
    import math

    from learn_fhe_tpu_torch.models import bgv as G
    from learn_fhe_tpu_torch.ops import rns
    from learn_fhe_tpu_torch.utils import security

    t_g2 = time.perf_counter()
    params = G.BgvParams(**BGV)
    n, t, B = params.n, params.t, BGV_BATCH
    log_qp = sum(math.log2(q) for q in params.qps)
    est = security.estimate(n, log_qp)
    say(f"G2 config: BgvParams({BGV}): N={n}, {len(params.qs)} q-primes + {len(params.ps)} p-primes of {params.log_qi} bits (log2 QP {log_qp:.1f}), t={t}, batch {B}, seed {BGV_SEED}; security estimate {est.security_bits} bits (level {est.level}; `utils/security.estimate`)")
    fns = {name: getattr(rns, name) for name in BGV_COUNTED}

    def zero():
        for fn in fns.values():
            fn.launches, fn.by_rows = 0, Counter()

    rng = np.random.default_rng(BGV_SEED)
    keygen = {}

    def timed(part, call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        keygen[part] = time.perf_counter() - t0
        return out

    sk = timed("sk", lambda: G.sk_gen(params, rng))
    pk = timed("pk", lambda: G.pk_gen(params, sk, rng, dev))
    rlk = timed("rlk", lambda: G.rlk_gen(params, sk, rng, dev))
    rtk = {j: timed(f"rtk j={j}", lambda j=j: G.rtk_gen(params, sk, j, rng, dev)) for j in BGV_ROTATIONS}
    cjk = timed("cjk", lambda: G.cjk_gen(params, sk, rng, dev))
    say(f"{tag} G2 key generation on the card (host clock to a sync): " + ", ".join(f"{k} {v:.3f} s" for k, v in keygen.items()) + f"; in all {sum(keygen.values()):.3f} s")

    depth = params.big_l - 1
    msgs = [rng.integers(0, t, size=(B, n), dtype=np.int64) for _ in range(depth + 3)]

    def encrypt(m):
        pts = G.encode(params, m, dev)
        cs = [G.pk_encrypt(params, pk, pts[i], rng) for i in range(B)]
        return G.BgvCiphertext(torch.stack([c.b for c in cs]), torch.stack([c.a for c in cs]), params.qs)

    t0 = time.perf_counter()
    cts = [encrypt(m) for m in msgs]
    torch.cuda.synchronize()
    say(f"{tag} G2 {len(msgs)} x {B} messages encoded and pk_encrypted: {time.perf_counter() - t0:.2f} s (host clock, to a sync)")

    def check(label, ct, want):
        got = G.decrypt(params, sk, ct)
        if got.shape != want.shape or not np.array_equal(got, want % t):
            raise AssertionError(f"G2 {label}: {int((got != want % t).sum())} of {want.size} slots decrypt wrong")
        say(f"G2 {label}: all {want.size} slots of the {B} ciphertexts decrypt exactly (level {len(ct.qs)}, factor {ct.factor})")

    # -- the path, with the launch counters set to 0 just before and read just after
    t0 = time.perf_counter()
    zero()
    acc, acc_m = cts[0], msgs[0]
    chain = []
    for m, ct in zip(msgs[1 : depth + 1], cts[1 : depth + 1]):
        while len(ct.qs) > len(acc.qs):
            ct = G.mod_switch(params, ct)
        acc = G.mul(params, rlk, acc, ct)
        acc_m = acc_m * m % t
        chain.append((acc, acc_m))
    fresh, fm = cts[depth + 1], msgs[depth + 1]
    rots = {j: G.rotate(params, rtk[j], fresh) for j in BGV_ROTATIONS}
    conj = G.conjugate(params, cjk, fresh)
    plain_ct = G.add_plain(params, msgs[depth + 2], G.mod_switch(params, G.mul_plain(params, msgs[depth + 2], fresh)))
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    path = {name: fn.launches for name, fn in fns.items()}
    path_rows = {name: dict(fn.by_rows) for name, fn in fns.items() if fn.launches}
    launches["bgv_drop"] = path["drop_limbs_t"]
    say(f"{tag} G2 the path (a mul chain of depth {depth}, fresh operands brought down by mod_switch; rotate by {BGV_ROTATIONS}; conjugate; mul_plain, mod_switch, add_plain) at batch {B}: {path_s:.3f} s (host clock, to a sync)")
    say(f"G2 launches on the path: {path}; by shape: {path_rows}")
    for name in ("rns_ntt", "rns_intt_mac", "base_convert", "automorphism_rns", "drop_limbs_t"):
        if path[name] == 0:
            raise AssertionError(f"{name} was not launched on the BGV path")
    for name in ("rns_intt", "rns_mac", "rescale_finish"):
        if path[name]:
            raise AssertionError(f"{name} launched on the BGV path, which runs its sums inside the inverse transforms and drops limbs by K-BGV-DROP")
    for d, (ct, want) in enumerate(chain, 1):
        check(f"mul chain depth {d}", ct, want)
    half = n // 2
    for j, ct in rots.items():
        check(f"rotate by {j}", ct, np.concatenate([np.roll(fm[:, :half], -j, -1), np.roll(fm[:, half:], -j, -1)], axis=-1))
    check("conjugate", conj, np.concatenate([fm[:, half:], fm[:, :half]], axis=-1))
    check("mul_plain, mod_switch, add_plain", plain_ct, fm * msgs[depth + 2] + msgs[depth + 2])

    # one batch-16 mul at the top level: its launches by shape
    zero()
    out = G.mul(params, rlk, cts[0], cts[1])
    torch.cuda.synchronize()
    say(f"G2 launches of one batch-{B} mul at the top level, by shape (rns_intt_mac: (output rows, terms); K-BASECONV: (input rows, input limbs, output limbs); K-BGV-DROP: (rows of b and a, limbs, drops)): " + str({name: dict(fn.by_rows) for name, fn in fns.items() if fn.launches}))
    # the first ciphertext's mul against the port's CPU path
    first = lambda ct: G.BgvCiphertext(ct.b[0].cpu(), ct.a[0].cpu(), ct.qs, ct.factor)  # noqa: E731
    rlk_cpu = G.BgvKeySwitchingKey(rlk.b.cpu(), rlk.a.cpu(), rlk.qs)
    t0 = time.perf_counter()
    want = G.mul(params, rlk_cpu, first(cts[0]), first(cts[1]))
    max_abs_err(out.b[0], want.b)
    max_abs_err(out.a[0], want.a)
    if out.factor != want.factor or out.qs != want.qs:
        raise AssertionError("G2: the card's mul carries another factor or level than the CPU's")
    say(f"G2 mul: the first ciphertext of the batch == the port's CPU path, bit for bit ({time.perf_counter() - t0:.1f} s on the CPU)")

    mul_ms = {}
    for batch, (a, b) in ((B, (cts[0], cts[1])), (1, tuple(G.BgvCiphertext(c.b[:1].contiguous(), c.a[:1].contiguous(), c.qs) for c in cts[:2]))):
        med, lo, hi = spread_ms(lambda a=a, b=b: G.mul(params, rlk, a, b), BGV_MUL_CALLS)
        mul_ms[batch] = med
        say(f"{tag} G2 mul at batch {batch}: {med:.3f} ms per call (median of {BGV_MUL_CALLS}, {lo:.3f}-{hi:.3f}; CUDA events) = {batch / med * 1e3:.1f} muls/s")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    G.mul(params, rlk, cts[0], cts[1])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    say(f"{tag} G2 mul at batch {B}: host enqueue {host_s * 1e3:.3f} ms, wall with sync {wall_s * 1e3:.3f} ms")
    g_ms = graph_ms(lambda: G.mul(params, rlk, cts[0], cts[1]), 3)
    say(f"{tag} G2 mul at batch {B} from a CUDA graph: {g_ms:.3f} ms per call (device only) = {B / g_ms * 1e3:.1f} muls/s; 1 - graph / eager median = {1 - g_ms / mul_ms[B]:.4f}")
    # the profiler's idle share holds only where its records add up to the
    # kernel time the graph shows (it has lost records of short windows)
    idle, kernel_ms, top = device_kernel_ms(lambda: [G.mul(params, rlk, cts[0], cts[1]) for _ in range(BGV_PROFILED_MULS)])
    if kernel_ms >= 0.9 * BGV_PROFILED_MULS * g_ms:
        say(f"{tag} G2 {BGV_PROFILED_MULS} muls at batch {B}: device idle share {idle:.4f} (profiler, union of kernel intervals); summed kernel time {kernel_ms:.3f} ms")
        for name, t_, count in top:
            say(f"  {t_:10.3f} ms  {count:6d} x  {name[:100]}")
    else:
        say(f"{tag} G2 device idle share (profiler): not measured; its records of {BGV_PROFILED_MULS} muls sum to {kernel_ms:.3f} ms of kernels against {BGV_PROFILED_MULS * g_ms:.3f} ms from the graph, so records were lost")
    say(f"{tag} G2 took {time.perf_counter() - t_g2:.1f} s (host clock)")


T1_MESSAGES = 4
T1_STEPS = 8  # CMux steps held against the CPU path


def tfhe_t1(dev, tag) -> None:
    """T1: the reference-order PBS (parity=True) at the reference fixture,
    unbatched (see the module's docstring)."""
    from learn_fhe_tpu_torch.models import tfhe
    from learn_fhe_tpu_torch.models.tfhe import tggsw, tglwe, tlwe
    from learn_fhe_tpu_torch.ops import ntt32 as tntt
    from learn_fhe_tpu_torch.ops import torus_crt as tcrt
    from learn_fhe_tpu_torch.utils.interop import u64_to_torch

    t_t1 = time.perf_counter()
    cfg = REFERENCE
    params = tfhe.BootstrapParams(
        tfhe.TlweParams(log_p=cfg["log_p"], padding=1, n=cfg["n"], std_dev=cfg["tlwe_std"], log_b=4, d=5),
        tfhe.TggswParams(tfhe.TglweParams(log_p=cfg["log_p"], padding=1, big_n=cfg["big_n"], k=1, std_dev=cfg["tglwe_std"]), log_b=23, d=1),
    )
    rng = np.random.default_rng(0)
    z = tlwe.sk_gen(params.tlwe, rng)
    key = tfhe.key_gen(params, z, rng, dev)
    n_big = params.big_n
    lut = u64_to_torch(tfhe.lut_table(params.tlwe.log_p, n_big, lambda v: v), dev)
    ms = rng.integers(0, params.tlwe.p, size=T1_MESSAGES)
    cts = [tlwe.sk_encrypt(params.tlwe, z, tlwe.encode(params.tlwe, torch.tensor(int(m), device=dev)), rng) for m in ms]
    counted = (tntt.ntt32, tntt.intt32, tcrt.garner_to_u64, tggsw.cmux_rotate, tggsw.blind_rotate_steps)
    for fn in counted:
        fn.launches = 0
    secs = []
    for m, ct in zip(ms, cts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = tfhe.bootstrap(params, key, lut, ct, parity=True)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        got = int(tlwe.decode(params.tlwe, tlwe.decrypt(params.tlwe, z, out)))
        if got != m:
            raise AssertionError(f"T1: the parity PBS of {m} decrypts to {got}")
    counts = {fn.__name__: fn.launches for fn in counted}
    say(f"{tag} T1 reference-order PBS (parity=True; n={params.tlwe.n}, N={n_big}, unbatched): {T1_MESSAGES} messages {ms.tolist()} decrypt through the identity LUT; {np.median(secs):.3f} s per PBS (median of {T1_MESSAGES}, {min(secs):.3f}-{max(secs):.3f}; host clock to a sync); launches {counts}")
    for name in ("ntt32", "intt32", "garner_to_u64"):
        if counts[name] == 0:
            raise AssertionError(f"T1: {name} was not launched on the parity path")
    if counts["cmux_rotate"] or counts["blind_rotate_steps"]:
        raise AssertionError("T1: the parity path launched the step kernel")
    # the first CMux steps of the first message against the port's CPU path
    a2n, b2n = tfhe.mod_switch_2n(cts[0], n_big)
    cut = lambda k, f: tfhe.BootstrapKey(tggsw.TggswEval(*(f(x[:T1_STEPS]) for x in k.brk)), k.ksk, f(k.mon_v), f(k.mon_d))  # noqa: E731
    v_enc = tglwe.encode(params.tglwe, lut)
    got = tfhe.blind_rotate(params, cut(key, lambda x: x), v_enc, a2n[:T1_STEPS], b2n, parity=True)
    t0 = time.perf_counter()
    want = tfhe.blind_rotate(params, cut(key, lambda x: x.cpu()), v_enc.cpu(), a2n[:T1_STEPS].cpu(), b2n.cpu(), parity=True)
    max_abs_err(got.a, want.a)
    max_abs_err(got.b, want.b)
    say(f"T1 the first {T1_STEPS} CMux steps of the first message on the card == the port's CPU path, bit for bit ({time.perf_counter() - t0:.1f} s on the CPU)")
    say(f"{tag} T1 took {time.perf_counter() - t_t1:.1f} s (host clock)")


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

    t_main = time.perf_counter()
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
    for name, (regs, st, ld, stack) in sorted(report.items()):
        if name.endswith("<11>") or "<" not in name or name == FHEW_INSTANCE or "64" in name or "rns" in name or "automorphism" in name or "bgv" in name:  # N=2048, Garner, FHEW's N=512, the u64, RNS and BGV kernels
            say(f"  ptxas: {name}: {regs} registers, {st} bytes spill stores, {ld} bytes spill loads, {stack} bytes stack frame")
    if not {"ntt32_fwd_kernel<11>", "negacyclic_mul32_kernel<11>", FHEW_INSTANCE, *MK_INSTANCES, *CKKS_INSTANCES, *BOOT_INSTANCES, *BGV_INSTANCES} <= report.keys():
        raise AssertionError("build.log shows no N=2048 instance of K-NTT or K-POLYMUL, no N=512 instance of K-FHEW-BR, or no u64, RNS or BGV kernel")

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

    phase_s = {"build, TFHE": time.perf_counter() - t_main}
    for phase, run in (
        ("FHEW F1-F4", lambda: fhew_phases(dev, tag, pipe_per_s, errs, timings, bounds, launches)),
        ("multi-key M1-M4", lambda: multikey_phases(dev, tag, pipe_per_s, errs, timings, bounds, launches, graphs)),
        ("CKKS C1-C4", lambda: ckks_phases(dev, tag, pipe_per_s, errs, timings, bounds, launches, graphs)),
        ("bootstrap B1", lambda: bootstrap_b1(dev, tag, pipe_per_s, errs, timings, bounds, graphs)),
        ("bootstrap B2", lambda: bootstrap_b2(dev, tag)),
        ("bootstrap B3", lambda: bootstrap_b3(dev, tag, launches)),
        ("production P1", lambda: production_p1(dev, tag, pipe_per_s, errs, timings, bounds, graphs)),
        ("production P2", lambda: production_p2(dev, tag, launches)),
        ("BGV G1", lambda: bgv_g1(dev, tag, pipe_per_s, errs, timings, bounds, graphs)),
        ("BGV G2", lambda: bgv_g2(dev, tag, launches)),
        ("TFHE T1", lambda: tfhe_t1(dev, tag)),
    ):
        t0 = time.perf_counter()
        run()
        phase_s[phase] = time.perf_counter() - t0
    say("phase seconds (host clock): " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()) + f"; in all {time.perf_counter() - t_main:.1f}")

    src = "learn_fhe_tpu_torch/csrc/"
    table = [
        ("ntt32", "ntt32.cu", "bench/pallas_ntt14_experiment.py:166"),
        ("intt32", "ntt32.cu", "bench/pallas_ntt14_experiment.py:183"),  # the polymul's inverse half
        ("negacyclic_mul32", "ntt32.cu", "bench/pallas_ntt14_experiment.py:183"),
        ("garner_to_u64", "torus_crt.cu", "bench/pallas_step_experiment.py:202"),
        ("tfhe_step", "tfhe_step.cu", "bench/pallas_step_experiment.py:202"),
        ("fhew_blind_rotate", "fhew_blind_rotate.cu", "learn_fhe_tpu/models/fhew/bootstrapping.py:423 (XLA scan; no Pallas call)"),
        ("ntt64", "ntt64.cu", "learn_fhe_tpu/ops/ntt.py:135 (XLA fusion; no Pallas call)"),
        ("ntt64_mont", "ntt64.cu", "learn_fhe_tpu/models/fhew/rgsw.py:116-131 and rlwe.py:148-150 (to_montgomery(ntt(x)), XLA fusions; no Pallas call)"),
        ("intt64", "ntt64.cu", "learn_fhe_tpu/ops/ntt.py:189 (XLA fusion; no Pallas call)"),
        ("negacyclic_mul64", "ntt64.cu", "learn_fhe_tpu/ops/ntt.py:261 (XLA fusion; no Pallas call)"),
        ("external_product64", "fhew_u64.cu", "learn_fhe_tpu/models/fhew/rgsw.py:154 (u64 external product, XLA fusion; no Pallas call)"),
        ("fhew_blind_rotate64", "fhew_u64.cu", "learn_fhe_tpu/models/fhew/bootstrapping.py:436 (u64 branch of the XLA scan; no Pallas call)"),
        ("fhew_blind_rotate64_cluster", "fhew_u64.cu", "learn_fhe_tpu/models/fhew/bootstrapping.py:436 (u64 branch of the XLA scan; no Pallas call)"),
        ("rns_ntt", "rns64.cu", "learn_fhe_tpu/ops/rns.py:123 (fwd_stages via rns_ntt, XLA fusion; no Pallas call)"),
        ("rns_intt", "rns64.cu", "learn_fhe_tpu/ops/rns.py:193 (inv_stages via rns_intt, XLA fusion; no Pallas call)"),
        ("rns_mac", "rns64.cu", "learn_fhe_tpu/ops/rns.py:280 and models/ckks/ckks.py:588-597,706-716 (rns_mul_eval, mul's tensor, _ks_dot; XLA fusions; no Pallas call)"),
        ("rns_intt_mac", "rns64.cu", "learn_fhe_tpu/ops/rns.py:193,280,287 and models/ckks/ckks.py:592-597,706-716,738-739 (rns_intt of rns_mul_eval / _ks_dot under one jit; XLA fusions; no Pallas call)"),
        ("base_convert", "rns64.cu", "learn_fhe_tpu/ops/rns.py:356 (extend_bases / switch_bases, XLA fusion; no Pallas call)"),
        ("rescale", "rns64.cu", "learn_fhe_tpu/ops/rns.py:426 (rescale_k, XLA fusion; no Pallas call)"),
        ("rns_mac_gather", "rns64.cu", "learn_fhe_tpu/models/ckks/bootstrapping.py:142-146 (_ks_dot of ae[..., perm] inside _bsgs_apply's jit, XLA fusion; no Pallas call)"),
        ("rns_intt_mac_gather", "rns64.cu", "learn_fhe_tpu/models/ckks/bootstrapping.py:147,152-169 and models/ckks/ckks.py:666-672 (rns_intt of products with be[..., perm] / ae[..., perm] under one jit; XLA fusions; no Pallas call)"),
        ("automorphism_rns", "rns64.cu", "learn_fhe_tpu/models/ckks/ckks.py:605-611 (_automorphism_rns, XLA fusion; no Pallas call)"),
        # the production ring's instances (P1's shapes; their launches are P2's)
        ("rns_ntt_n65536", "rns64.cu", "learn_fhe_tpu/ops/rns.py:123 (fwd_stages via rns_ntt at N=2^16, XLA fusion; no Pallas call)"),
        ("rns_intt_n65536", "rns64.cu", "learn_fhe_tpu/ops/rns.py:193 (inv_stages via rns_intt at N=2^16, XLA fusion; no Pallas call)"),
        ("rns_intt_mac_n65536", "rns64.cu", "learn_fhe_tpu/ops/rns.py:193,280,287 and models/ckks/ckks.py:706-716 (the key switch's rns_intt of _ks_dot at N=2^16, dnum 15; XLA fusions; no Pallas call)"),
        ("rns_intt_mac_gather_n65536", "rns64.cu", "learn_fhe_tpu/models/ckks/bootstrapping.py:147,152-169 (rns_intt of products with be[..., perm] at N=2^16; XLA fusions; no Pallas call)"),
        # BGV's t-corrected limb drop (G1's shapes; its launches are G2's path's)
        ("bgv_drop", "bgv.cu", "learn_fhe_tpu/models/bgv/bgv.py:176 (_drop_limb with its _DropPlan tables :154-173, XLA fusion; no Pallas call)"),
    ]
    # each row's launches on P2's warm production bootstrap
    p2 = {
        "rns_ntt": launches["p2_rns_ntt"], "rns_intt": launches["p2_rns_intt"],
        "rns_mac": launches["p2_rns_mac"] - launches["p2_rns_mac_gather"],
        "rns_intt_mac": launches["p2_rns_intt_mac"] - launches["p2_rns_intt_mac_gather"],
        "base_convert": launches["p2_base_convert"], "rescale": launches["p2_rescale_finish"],
        "rns_mac_gather": launches["p2_rns_mac_gather"], "rns_intt_mac_gather": launches["p2_rns_intt_mac_gather"],
        "automorphism_rns": launches["p2_automorphism_rns"],
    }  # fmt: skip
    for row, (name, _) in PROD_ROWS.items():
        p2[row] = launches[row] = p2[name]
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
                        "p2_launches": p2.get(name, 0),  # on the production bootstrap (P2)
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
