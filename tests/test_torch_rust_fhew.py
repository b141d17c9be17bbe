"""The port against the Rust reference's FHEW transcripts.

`tests/test_rust_transcripts.py` reads the transcripts that
tools/rust-dump (or the independent oracle tools/pydump) dumped from the
reference's protocols into the JAX package's pipelines; here the same
files go through the port's:

  - the single-key gate transcript (`boolean.rs:225-239`: q = 268409857,
    N=512, B=2^7, d=4; LWE n=100, q_ks=2^16; w=10): the dumped brk, ak and
    LWE key switching key through `rgsw.to_eval`, `rlwe.make_ksk` and
    `_pack_key`, and the dumped gate inputs through `gates.gate_batch`,
    which must give every `fhew_gate_*_out` bit for bit;
  - the multi-key merges that need no brk (`boolean.rs:321-335`, q ~ 2^54,
    N=512): `pk_share_merge` of the dumped pk shares must give
    `fhew_mk_pk_b`, `lwe.ksk_share_merge` of the dumped ksk shares
    `fhew_mk_ksk_b`.

Without the transcript files the tests skip, under the JAX tests' conditions.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learn_fhe_tpu_torch.models import fhew  # noqa: E402
from learn_fhe_tpu_torch.models.fhew import gates, lwe, rgsw, rlwe  # noqa: E402
from learn_fhe_tpu_torch.models.fhew.bootstrapping import _pack_key  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u64, u64_to_torch  # noqa: E402
from learn_fhe_tpu_torch.utils.primes import two_adic_primes  # noqa: E402

DUMP_DIR = os.path.join(os.path.dirname(__file__), "vectors", "rust_dump")

needs_transcripts = pytest.mark.skipif(
    not os.path.isfile(os.path.join(DUMP_DIR, "fhew_rng_probe.npy")),
    reason="no rust transcript dump present (run tools/rust-dump with cargo, "
    "or the independent oracle: python tools/pydump/*_dump.py)",
)

needs_mk_setup = pytest.mark.skipif(
    not os.path.isfile(os.path.join(DUMP_DIR, "fhew_mk_pk_b.npy")),
    reason="no multi-key transcript present (python tools/pydump/fhew_mk_dump.py)",
)


def _load(name):
    return np.load(os.path.join(DUMP_DIR, name + ".npy"))


def _t(name, *shape):
    x = _load(name)
    return u64_to_torch(x.reshape(shape) if shape else x)


def _params(bits, d, log_b):
    q = next(two_adic_primes(bits, 10))
    return fhew.BootstrapParams(
        fhew.RgswParams(fhew.RlweParams(q=q, p=4, log_n=9, log_b=log_b, d=d), log_b=log_b, d=d),
        fhew.LweParams(q=1 << 16, p=4, n=100, log_b=4, d=4),
        w=10,
    )


@pytest.fixture(scope="module")
def gate_setup():
    """The dumped single-key keys moved into the port's evaluation-basis
    residency, and the dumped secret key and gate inputs."""
    params = _params(28, 4, 7)
    n, d_s, n_s = params.n, 4, 100
    ksk = lwe.LweKeySwitchingKey(_t("fhew_ksk_a", d_s, n, n_s), _t("fhew_ksk_b", d_s, n))
    brk_raw = _t("fhew_brk")  # (n_s, 2d, 2, n)
    brk_eval = rgsw.to_eval(params.rgsw, rgsw.RgswCiphertext(brk_raw[:, :, 0].contiguous(), brk_raw[:, :, 1].contiguous()))
    np.testing.assert_array_equal(_load("fhew_ak_t").view(np.int64), np.asarray(params.ak_t))
    ak_raw = _t("fhew_ak")  # (w+1, d, 2, n)
    ak_ksks = [rlwe.make_ksk(params.rlwe, rlwe.RlweCiphertext(ak_raw[v, :, 0], ak_raw[v, :, 1])) for v in range(ak_raw.shape[0])]
    key = _pack_key(params, ksk, brk_eval, ak_ksks)
    z = _load("fhew_sk_z").view(np.int64)
    in_a, in_b = _t("fhew_gate_in_a", 4, 2, n), _t("fhew_gate_in_b", 4, 2)
    return params, key, z, in_a, in_b


COMBOS = [(0, 0), (0, 1), (1, 0), (1, 1)]
TRUTH = {
    "nand": lambda a, b: not (a and b),
    "and": lambda a, b: a and b,
    "or": lambda a, b: a or b,
    "xor": lambda a, b: a != b,
}


@needs_transcripts
def test_dumped_gate_inputs_decrypt(gate_setup):
    params, _, z, in_a, in_b = gate_setup
    for i, pair in enumerate(COMBOS):
        for j, m in enumerate(pair):
            ct = lwe.LweCiphertext(in_a[i, j], in_b[i, j])
            assert bool(gates.decode_bool(params, lwe.decrypt(params.lwe_z, z, ct))) == bool(m), (i, j)


@needs_transcripts
@pytest.mark.parametrize("name", list(TRUTH))
def test_gate_transcript_bit_identical(gate_setup, name):
    """The reference's gate outputs, bit for bit: the four input pairs in
    one gate batch under the dumped keys."""
    params, key, z, in_a, in_b = gate_setup
    specs = [(name, lwe.LweCiphertext(in_a[i, 0], in_b[i, 0]), lwe.LweCiphertext(in_a[i, 1], in_b[i, 1])) for i in range(4)]
    outs = gates.gate_batch(params, key, specs)
    out_a, out_b = _load(f"fhew_gate_{name}_out_a").reshape(4, params.n), _load(f"fhew_gate_{name}_out_b").reshape(4)
    for i, ((m0, m1), out) in enumerate(zip(COMBOS, outs)):
        np.testing.assert_array_equal(torch_to_u64(out.a), out_a[i], err_msg=f"{name} {i}")
        assert int(torch_to_u64(out.b)) == int(out_b[i]), (name, i)
        assert bool(gates.decode_bool(params, lwe.decrypt(params.lwe_z, z, out))) == TRUTH[name](bool(m0), bool(m1))


@needs_transcripts
@needs_mk_setup
def test_multikey_merges_without_brk():
    """`pk_share_merge` and the LWE `ksk_share_merge` of the dumped shares
    against the reference's merged pk and key switching key
    (`bootstrapping.rs:251-293`); the fixture's q ~ 2^54 runs the u64 engine."""
    params = _params(54, 9, 6)
    n, d_s, n_s = params.n, 4, 100
    assert not params.rgsw.use_u32
    np.testing.assert_array_equal(_load("fhew_mk_ak_t").view(np.int64), np.asarray(params.ak_t))
    crs_pk_a = _t("fhew_mk_crs_pk_a")
    pk = rlwe.pk_share_merge(params.rlwe, crs_pk_a, [_t(f"fhew_mk_pk_share{p}") for p in range(2)])
    np.testing.assert_array_equal(torch_to_u64(pk.b), _load("fhew_mk_pk_b"))
    assert torch.equal(pk.a, crs_pk_a)
    crs_ksk_a = _t("fhew_mk_crs_ksk_a", d_s, n, n_s)
    ksk = lwe.ksk_share_merge(params.lwe_s, crs_ksk_a, [_t(f"fhew_mk_ksk_b_share{p}", d_s, n) for p in range(2)])
    np.testing.assert_array_equal(torch_to_u64(ksk.b), _load("fhew_mk_ksk_b").reshape(d_s, n))
