"""The port's CKKS against the committed Rust reference transcript
(`tests/vectors/rust_dump/ckks_*.npy`, `ckks.rs:303-345` at N=512, L=8,
55-bit primes), without JAX: the reference's keys and ciphertexts go into
the port's mul + relinearize + rescale, rotate and conjugate, whose outputs
must equal the reference's bit for bit; encode must reproduce the
reference's F256 integers (precision="f256", rounding="trunc"); the product
decodes within the reference's 2^-30. The checks of
`tests/test_rust_transcripts.py::test_ckks_transcript_parity`, on the CPU's
plain path; `chip_smoke.py` C2 runs the same on the card."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learn_fhe_tpu_torch.models.ckks import ckks as C  # noqa: E402
from learn_fhe_tpu_torch.ops.rns import rns_add, rns_from_i64, rns_mul, rns_ntt, rns_plan, rns_sub  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u64, u64_to_torch  # noqa: E402

DUMP_DIR = os.path.join(os.path.dirname(__file__), "vectors", "rust_dump")


def _load(name):
    return np.load(os.path.join(DUMP_DIR, name + ".npy"))


def transcript(device):
    """The transcript's parameters, secret key, messages, ciphertexts and
    evaluation-basis keys, on `device`."""
    params = C.CkksParams(log_n=9, log_qi=55, big_l=8)
    np.testing.assert_array_equal(_load("ckks_qs"), params.qs)
    np.testing.assert_array_equal(_load("ckks_ps"), params.ps)

    def ct(tag):
        return C.CkksCiphertext(u64_to_torch(_load(f"{tag}_b"), device), u64_to_torch(_load(f"{tag}_a"), device), params.qs)

    def ksk(tag):
        plan = params.plan(params.qps)
        b, a = (rns_ntt(u64_to_torch(_load(f"{tag}_{f}"), device), plan) for f in "ba")
        return C.CkksKeySwitchingKey(b, a, params.qps)

    m0, m1 = _load("ckks_m0"), _load("ckks_m1")
    return dict(
        params=params,
        sk=_load("ckks_sk").view(np.int64),
        m0=m0[:, 0] + 1j * m0[:, 1],
        m1=m1[:, 0] + 1j * m1[:, 1],
        ct0=ct("ckks_ct0"),
        ct1=ct("ckks_ct1"),
        rlk=ksk("ckks_rlk"),
        rtk=C.CkksRotKey(ksk("ckks_rtk1"), 1),
        cjk=ksk("ckks_cjk"),
    )


def check_evaluations(t) -> dict[str, C.CkksCiphertext]:
    """mul, rotate and conjugate of the transcript's ciphertexts, each equal
    to the reference's; returns them."""
    params = t["params"]
    outs = {
        "mul": C.mul(params, t["rlk"], t["ct0"], t["ct1"]),
        "rot1": C.rotate(params, t["rtk"], t["ct0"]),
        "conj": C.conjugate(params, t["cjk"], t["ct0"]),
    }
    for tag, out in outs.items():
        for f in "ba":
            got = torch_to_u64(getattr(out, f))
            if not np.array_equal(got, _load(f"ckks_{tag}_{f}")):
                raise AssertionError(f"{tag}.{f} differs from the Rust reference transcript")
    return outs


@pytest.fixture(scope="module")
def cpu_transcript():
    return transcript("cpu")


def test_mul_rotate_conjugate_equal_the_reference(cpu_transcript):
    check_evaluations(cpu_transcript)


def test_mul_decodes_within_the_reference_budget(cpu_transcript):
    t = cpu_transcript
    params, sk = t["params"], t["sk"]
    out = C.mul(params, t["rlk"], t["ct0"], t["ct1"])
    dec = C.decode(params, C.decrypt(params, sk, out), out.qs)
    ref = _load("ckks_mul_dec")
    assert np.max(np.abs(dec - t["m0"] * t["m1"])) < 2.0**-30
    assert np.max(np.abs(dec - (ref[:, 0] + 1j * ref[:, 1]))) < 2.0**-30


def test_encode_reproduces_the_reference_f256_integers(cpu_transcript):
    """pt0 = ct0.b + ct0.a sk - e0 over qs (`ckks.rs:215-225`), from the
    dumped limbs, equals the port's encode with the reference's truncation."""
    t = cpu_transcript
    params = t["params"]
    plan = rns_plan(params.qs, params.n)
    np.testing.assert_array_equal(_load("ckks_enc0_a"), torch_to_u64(t["ct0"].a))
    sk_rns = rns_from_i64(torch.from_numpy(t["sk"].copy()), plan)
    e = u64_to_torch(_load("ckks_enc0_e"))
    pt_ref = rns_sub(rns_add(t["ct0"].b, rns_mul(t["ct0"].a, sk_rns, plan), plan), e, plan)
    pt = C.encode(params, t["m0"], params.qs, precision="f256", rounding="trunc", device="cpu")
    assert torch.equal(pt, pt_ref)
