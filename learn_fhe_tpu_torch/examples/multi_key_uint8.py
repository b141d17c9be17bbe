"""End-to-end 2-party multi-key FHEW on the port (`examples/multi_key_uint8.py`,
reference `scheme/fhew/examples/multi_key_uint8.rs`):

crs_gen -> per-party sk + pk shares -> merged pk -> per-party key shares ->
key_share_merge -> pk-encrypt two u8 -> ((a+b)*(a-b)/a)%b homomorphically ->
threshold decryption.

--full takes the reference example's sizes (q = next(two_adic_primes(55,
12)), N=2^11, B=2^11, d=5; LWE n=600, q_ks=2^20, B=2^5, d=4; w=10); the
default is the JAX example's scaled set (54-bit q, N=2^7, B=2^6, d=9; LWE
n=16, q_ks=2^16, B=2^4, d=4; w=5). Everything runs on the current CUDA
device unless --device cpu is given.

    python -m learn_fhe_tpu_torch.examples.multi_key_uint8 --full
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def example_params(full: bool):
    """The reference example's parameters (`multi_key_uint8.rs:15-29`), or
    the scaled set."""
    from learn_fhe_tpu_torch.models.fhew import BootstrapParams, LweParams, RgswParams, RlweParams
    from learn_fhe_tpu_torch.utils.primes import two_adic_primes

    if full:
        q = next(two_adic_primes(55, 12))
        return BootstrapParams(
            RgswParams(RlweParams(q=q, p=4, log_n=11, log_b=11, d=5), log_b=11, d=5),
            LweParams(q=1 << 20, p=4, n=600, log_b=5, d=4),
            w=10,
        )
    q = next(two_adic_primes(54, 8))
    return BootstrapParams(
        RgswParams(RlweParams(q=q, p=4, log_n=7, log_b=6, d=9), log_b=6, d=9),
        LweParams(q=1 << 16, p=4, n=16, log_b=4, d=4),
        w=5,
    )


def wrapping_expression(a: int, b: int) -> int:
    """((a + b) * (a - b) / a) % b in wrapping u8 (`multi_key_uint8.rs:59-67`)."""
    return ((((a + b) % 256) * ((a - b) % 256) % 256) // a) % b


def run(params, a: int, b: int, device, seed: int = 0, n_parties: int = 2, say=print) -> int:
    """The whole protocol; returns the threshold-decrypted result. `say`
    gets a line per step with the seconds since the start (host clock, each
    step ending in a sync on the card)."""
    from learn_fhe_tpu_torch.models.fhew import FhewU8, crs_gen, key_share_gen, key_share_merge, rlwe

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()

    def stamp(msg: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        say(f"[{time.perf_counter() - t0:8.2f} s] {msg}")

    crs = crs_gen(params, rng, device)
    sks = [rlwe.sk_gen(params.rlwe, rng) for _ in range(n_parties)]
    pk_shares = [rlwe.pk_share_gen(params.rlwe, crs.pk_a, sk, rng) for sk in sks]
    pk = rlwe.pk_share_merge(params.rlwe, crs.pk_a, pk_shares)
    stamp("crs + pk shares merged")
    key_shares = [key_share_gen(params, crs, sk, pk, rng) for sk in sks]
    stamp(f"{n_parties} parties' key shares generated")
    bk = key_share_merge(params, crs, key_shares)
    stamp(f"{n_parties}-party key merged")

    ct_a = FhewU8.pk_encrypt(params, bk, pk, a, rng)
    ct_b = FhewU8.pk_encrypt(params, bk, pk, b, rng)
    stamp(f"encrypted a={a}, b={b}")
    s = ct_a.wrapping_add(ct_b)
    stamp("a+b done")
    d = ct_a.wrapping_sub(ct_b)
    stamp("a-b done")
    p = s.wrapping_mul(d)
    stamp("(a+b)*(a-b) done")
    qt = p.wrapping_div(ct_a)
    stamp("/a done")
    r = qt.wrapping_rem(ct_b)
    stamp("%b done")
    got = r.decryption_share_merge([r.share_decrypt(sk, rng) for sk in sks])
    stamp("threshold-decrypted")
    return got


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="the reference example's sizes")
    ap.add_argument("--a", type=int, default=177)
    ap.add_argument("--b", type=int, default=7)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the current one)")
    args = ap.parse_args()

    from learn_fhe_tpu_torch.utils.interop import resolve_device

    device = resolve_device(args.device)
    a, b = args.a % 256, args.b % 256
    got = run(example_params(args.full), a, b, device)
    want = wrapping_expression(a, b)
    print(f"threshold-decrypted: {got}, expected: {want}")
    assert got == want
    print("OK")


if __name__ == "__main__":
    main()
