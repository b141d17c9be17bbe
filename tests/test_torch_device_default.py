"""The port's entry points put what they make on the card unless the caller
asks for the CPU: without a CUDA device they raise, they never fall back to
the CPU quietly. Whether a device is present is decided inside each test."""

from types import SimpleNamespace as NS

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import learn_fhe_tpu_torch.models.tfhe as tfhe  # noqa: E402
from learn_fhe_tpu_torch.models.tfhe import tlwe  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import bootstrap_key_from_numpy, resolve_device  # noqa: E402

PARAMS = tfhe.BootstrapParams(
    tfhe.TlweParams(log_p=2, padding=1, n=8, std_dev=1.34e-7, log_b=4, d=5),
    tfhe.TggswParams(
        tfhe.TglweParams(log_p=2, padding=1, big_n=16, k=1, std_dev=2.85e-15), log_b=23, d=1
    ),
)


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _numpy_key(key):
    """The JAX package's key layout (one array per prime), as numpy leaves."""
    brk = NS(**{f: tuple(getattr(key.brk, f).numpy().swapaxes(0, 1)) for f in ("av", "ad", "bv", "bd")})
    ksk = NS(a=key.ksk.a.numpy().view(np.uint64), b=key.ksk.b.numpy().view(np.uint64))
    return NS(brk=brk, ksk=ksk, mon_v=tuple(key.mon_v.numpy()), mon_d=tuple(key.mon_d.numpy()))


def _all_leaves(key):
    return [*key.brk, *key.ksk, key.mon_v, key.mon_d]


def test_resolve_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_key_gen_raises_without_cuda(no_cuda):
    rng = np.random.default_rng(0)
    z = tlwe.sk_gen(PARAMS.tlwe, rng)
    with pytest.raises(RuntimeError, match="GPU"):
        tfhe.key_gen(PARAMS, z, rng)


def test_ksk_gen_raises_without_cuda(no_cuda):
    rng = np.random.default_rng(0)
    z = tlwe.sk_gen(PARAMS.tlwe, rng)
    with pytest.raises(RuntimeError, match="GPU"):
        tlwe.ksk_gen(PARAMS.tlwe, z, z, rng)


def test_bootstrap_key_from_numpy_raises_without_cuda(no_cuda):
    rng = np.random.default_rng(0)
    key = tfhe.key_gen(PARAMS, tlwe.sk_gen(PARAMS.tlwe, rng), rng, "cpu")
    with pytest.raises(RuntimeError, match="GPU"):
        bootstrap_key_from_numpy(_numpy_key(key))


def test_entry_points_on_cpu_when_asked():
    rng = np.random.default_rng(0)
    z = tlwe.sk_gen(PARAMS.tlwe, rng)
    key = tfhe.key_gen(PARAMS, z, rng, "cpu")
    assert all(t.device.type == "cpu" for t in _all_leaves(key))
    ksk = tlwe.ksk_gen(PARAMS.tlwe, z, z, rng, device="cpu")
    assert all(t.device.type == "cpu" for t in ksk)
    carried = bootstrap_key_from_numpy(_numpy_key(key), device="cpu")
    for got, want in zip(_all_leaves(carried), _all_leaves(key)):
        assert got.device.type == "cpu" and torch.equal(got, want)


@pytest.mark.cuda
def test_key_gen_defaults_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    key = tfhe.key_gen(PARAMS, tlwe.sk_gen(PARAMS.tlwe, rng), rng)
    assert all(t.device.type == "cuda" for t in _all_leaves(key))
