"""Encrypted logistic-regression inference with CKKS on the port
(`examples/ckks_logistic.py`): one ciphertext packs 64 examples x 8 features
at slot e*8+f;

    dot product    mul_constant(tiled weights) + rotate-and-sum (3 rotations)
    + bias         add_constant
    sigmoid        degree-3 least-squares polynomial: one ct x ct square and
                   one ct x ct multiply (Horner form)

uses 4 of the 6 levels. The decrypted scores are checked against the
cleartext polynomial (tight) and the true sigmoid (the fit's budget), and
the classifications must agree exactly, as the JAX example requires.
Everything runs on the current CUDA device unless --device cpu is given.

    python -m learn_fhe_tpu_torch.examples.ckks_logistic [--log-n 10] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

FEATURES = 8  # power of two so rotate-and-sum stays in-block
EXAMPLES = 64


def run(log_n: int = 10, device=None, say=print) -> dict:
    """The example's pipeline; returns its errors and agreement, raising
    where a check fails."""
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.utils.interop import resolve_device

    device = resolve_device(device)
    rng = np.random.default_rng(7)
    params = C.CkksParams(log_n=log_n, log_qi=55, big_l=6)
    assert params.l >= EXAMPLES * FEATURES

    # model + data (host, cleartext)
    w = rng.standard_normal(FEATURES) * 0.8
    bias = 0.3
    x = rng.standard_normal((EXAMPLES, FEATURES))
    logits = x @ w + bias
    truth = 1.0 / (1.0 + np.exp(-logits))
    r = max(4.0, np.abs(logits).max() * 1.1)
    ts = np.linspace(-r, r, 2001)
    c3, _c2, c1, c0 = np.polyfit(ts, 1.0 / (1.0 + np.exp(-ts)), 3)
    poly = lambda v: c0 + c1 * v + c3 * v**3  # noqa: E731  (c2 ~ 0 by symmetry)

    # keys
    sk = C.sk_gen(params, rng)
    pk = C.pk_gen(params, sk, rng, device)
    rlk = C.rlk_gen(params, sk, rng, device)
    shifts = [FEATURES >> k for k in range(1, FEATURES.bit_length())]  # 4, 2, 1
    rtks = {j: C.rtk_gen(params, sk, j, rng, device) for j in shifts}

    # encrypt the packed batch
    slots = np.zeros(params.l, dtype=np.complex128)
    slots[: EXAMPLES * FEATURES] = x.reshape(-1)
    ct = C.pk_encrypt(params, pk, C.encode(params, slots, device=device), rng)

    # encrypted dot product: w * x, then block rotate-and-sum
    w_tiled = np.zeros(params.l, dtype=np.complex128)
    w_tiled[: EXAMPLES * FEATURES] = np.tile(w, EXAMPLES)
    acc = C.mul_constant(params, w_tiled, ct)
    for j in shifts:
        acc = C.add(acc, C.rotate(params, rtks[j], acc))
    acc = C.add_constant(params, np.full(params.l, bias, dtype=np.complex128), acc)

    # encrypted sigmoid: c0 + x (c1 + c3 x^2)
    sq = C.mul(params, rlk, acc, acc)
    inner = C.add_constant(
        params,
        np.full(params.l, c1, dtype=np.complex128),
        C.mul_constant(params, np.full(params.l, c3, dtype=np.complex128), sq),
    )
    score = C.mul(params, rlk, acc, inner)
    score = C.add_constant(params, np.full(params.l, c0, dtype=np.complex128), score)
    say(f"levels: {params.big_l} -> {len(score.qs)} left")

    got = np.real(C.decode(params, C.decrypt(params, sk, score), score.qs))
    got = got[: EXAMPLES * FEATURES : FEATURES]  # slot e*8 holds example e
    err_poly = float(np.max(np.abs(got - poly(logits))))
    err_true = float(np.max(np.abs(got - truth)))
    agree = float(np.mean((got > 0.5) == (truth > 0.5)))
    say(f"max |ct - cleartext poly|  = {err_poly:.2e}")
    say(f"max |ct - true sigmoid|    = {err_true:.2e} (poly approx budget)")
    say(f"classification agreement   = {agree:.1%}")
    assert err_poly < 1e-4, err_poly  # ciphertext noise only
    assert err_true < 0.08, err_true  # dominated by the degree-3 fit
    assert agree == 1.0, agree
    return {"err_poly": err_poly, "err_true": err_true, "agree": agree}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log-n", type=int, default=10)
    ap.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the current one)")
    args = ap.parse_args()
    run(args.log_n, args.device)
    print("OK")


if __name__ == "__main__":
    main()
