"""The port's reference-order TFHE bootstrap (`bootstrap(..., parity=True)`)
against the Rust reference transcript, without JAX: the reference's
bootstrap key, key-switching key and input ciphertexts
(`tests/vectors/rust_dump/tfhe_*.npy`, fixture `bootstrapping.rs:141-152`:
TLWE n=1024, TGGSW N=2048, k=1, B=2^23, d=1) go through the port's
parity bootstrap with the identity LUT on the CPU, whose ciphertexts must
equal the reference's bit for bit and decrypt to the input. The checks of
`tests/test_rust_transcripts.py::test_tfhe_pbs_transcript_parity`'s parity
branch.

The key material (151 MB) is regenerable and kept out of git: without
`tfhe_brk.npy` (`make parity` makes it locally) the test skips, as that
test does."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import learn_fhe_tpu_torch.models.tfhe as tfhe  # noqa: E402
from learn_fhe_tpu_torch.models.tfhe import tggsw, tlwe  # noqa: E402
from learn_fhe_tpu_torch.ops.torus_crt import monomial_eval_table, required_bound_bits  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import u32_to_torch, u64_to_torch  # noqa: E402

DUMP_DIR = os.path.join(os.path.dirname(__file__), "vectors", "rust_dump")

needs_tfhe_keys = pytest.mark.skipif(
    not os.path.isfile(os.path.join(DUMP_DIR, "tfhe_brk.npy")),
    reason="TFHE transcript key material absent — regenerate with `make parity` (~40 min, one-time per checkout)",
)


def _load(name):
    return np.load(os.path.join(DUMP_DIR, name + ".npy"))


@pytest.mark.slow
@needs_tfhe_keys
def test_tfhe_parity_bootstrap_matches_reference_transcript():
    params = tfhe.BootstrapParams(
        tfhe.TlweParams(log_p=4, padding=1, n=1024, std_dev=1.339775301998614e-7, log_b=4, d=5),
        tfhe.TggswParams(tfhe.TglweParams(log_p=4, padding=1, big_n=2048, k=1, std_dev=2.845267479601915e-15), log_b=23, d=1),
    )
    n_lwe, big_n, k, d_ks = 1024, 2048, 1, 5
    brk_raw = u64_to_torch(_load("tfhe_brk"))  # (n_lwe, (k+1)d, k+1, big_n)
    brk = tggsw.to_eval(params.tggsw, tggsw.TggswCiphertext(brk_raw[:, :, :k, :].contiguous(), brk_raw[:, :, k, :].contiguous()))
    ksk = tlwe.TlweKeySwitchingKey(
        u64_to_torch(_load("tfhe_ksk_a").reshape(d_ks, k * big_n, n_lwe)),
        u64_to_torch(_load("tfhe_ksk_b").reshape(d_ks, k * big_n)),
    )
    mv, md = monomial_eval_table(big_n, required_bound_bits(big_n, params.tggsw.log_b, (k + 1) * params.tggsw.d))
    key = tfhe.BootstrapKey(brk, ksk, u32_to_torch(mv), u32_to_torch(md))
    z = _load("tfhe_sk_z").view(np.int64)
    in_a, in_b = _load("tfhe_pbs_in_a"), _load("tfhe_pbs_in_b")
    ref_a, ref_b = _load("tfhe_pbs_identity_out_a"), _load("tfhe_pbs_identity_out_b")
    np.testing.assert_array_equal(_load("tfhe_table_identity"), np.arange(16))
    lut = u64_to_torch(tfhe.lut_table(4, big_n, lambda v: v))
    for m in range(16):
        ct = tlwe.TlweCiphertext(u64_to_torch(in_a[m]), u64_to_torch(np.asarray(in_b[m])))
        out = tfhe.bootstrap(params, key, lut, ct, parity=True)
        np.testing.assert_array_equal(out.a.numpy().view(np.uint64), ref_a[m])
        assert int(out.b.numpy().view(np.uint64)) == int(ref_b[m]), m
        assert int(tlwe.decode(params.tlwe, tlwe.decrypt(params.tlwe, z, out))) == m
