"""The port's entry points put what they make on the card unless the caller
asks for the CPU: without a CUDA device they raise, they never fall back to
the CPU quietly. Whether a device is present is decided inside each test."""

from types import SimpleNamespace as NS

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import learn_fhe_tpu_torch.models.fhew as fhew  # noqa: E402
import learn_fhe_tpu_torch.models.tfhe as tfhe  # noqa: E402
from learn_fhe_tpu_torch.models.tfhe import tlwe  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import (  # noqa: E402
    bootstrap_key_from_numpy,
    fhew_bootstrap_key_from_numpy,
    resolve_device,
)
from learn_fhe_tpu_torch.utils.primes import two_adic_primes  # noqa: E402

PARAMS = tfhe.BootstrapParams(
    tfhe.TlweParams(log_p=2, padding=1, n=8, std_dev=1.34e-7, log_b=4, d=5),
    tfhe.TggswParams(
        tfhe.TglweParams(log_p=2, padding=1, big_n=16, k=1, std_dev=2.85e-15), log_b=23, d=1
    ),
)

_FQ = next(two_adic_primes(28, 5))
FHEW_PARAMS = fhew.BootstrapParams(
    fhew.RgswParams(fhew.RlweParams(q=_FQ, p=4, log_n=4, log_b=7, d=4), log_b=7, d=4),
    fhew.LweParams(q=1 << 16, p=4, n=4, log_b=4, d=4),
    w=2,
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


def _fhew_key(device):
    rng = np.random.default_rng(0)
    return fhew.key_gen(FHEW_PARAMS, fhew.rlwe.sk_gen(FHEW_PARAMS.rlwe, rng), rng, device)


def _fhew_numpy_key(key):
    """The JAX package's FHEW key layout, as numpy leaves."""
    def leaf(t):
        x = t.numpy()
        return x.view(np.uint32) if t.dtype == torch.int32 else x.view(np.uint64) if t.dtype == torch.int64 else x

    return NS(**{f: leaf(getattr(key, f)) for f in fhew.BootstrapKey._fields})


def test_fhew_key_gen_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="GPU"):
        _fhew_key(None)


def test_fhew_bootstrap_key_from_numpy_raises_without_cuda(no_cuda):
    key = _fhew_key("cpu")
    with pytest.raises(RuntimeError, match="GPU"):
        fhew_bootstrap_key_from_numpy(_fhew_numpy_key(key))
    carried = fhew_bootstrap_key_from_numpy(_fhew_numpy_key(key), device="cpu")
    for f in fhew.BootstrapKey._fields:
        assert getattr(carried, f).device.type == "cpu" and torch.equal(getattr(carried, f), getattr(key, f))


_MQ = next(two_adic_primes(54, 5))
MK_PARAMS = fhew.BootstrapParams(
    fhew.RgswParams(fhew.RlweParams(q=_MQ, p=4, log_n=4, log_b=6, d=9), log_b=6, d=9),
    fhew.LweParams(q=1 << 16, p=4, n=4, log_b=4, d=4),
    w=2,
)


def test_crs_gen_and_pk_gen_raise_without_cuda(no_cuda):
    """The multi-key entry points that make what the parties share."""
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="GPU"):
        fhew.crs_gen(MK_PARAMS, rng)
    with pytest.raises(RuntimeError, match="GPU"):
        fhew.rlwe.pk_gen(MK_PARAMS.rlwe, fhew.rlwe.sk_gen(MK_PARAMS.rlwe, rng), rng)


def test_fhew_crs_and_u64_key_from_numpy_raise_without_cuda(no_cuda):
    """The u64 engine's carry-over (key with no duals, CRS, key share)."""
    from learn_fhe_tpu_torch.utils.interop import fhew_crs_from_numpy, fhew_key_share_from_numpy

    rng = np.random.default_rng(0)
    crs = fhew.crs_gen(MK_PARAMS, rng, "cpu")
    z = fhew.rlwe.sk_gen(MK_PARAMS.rlwe, rng)
    pk = fhew.rlwe.pk_gen(MK_PARAMS.rlwe, z, rng, "cpu")
    share = fhew.key_share_gen(MK_PARAMS, crs, z, pk, rng)
    key = fhew.key_share_merge(MK_PARAMS, crs, [share])
    np_crs = NS(**{f: getattr(crs, f).numpy().view(np.uint64) for f in crs._fields})
    np_share = NS(ksk_b=share.ksk_b.numpy().view(np.uint64), brk=NS(a=share.brk.a.numpy().view(np.uint64), b=share.brk.b.numpy().view(np.uint64)), ak_b=share.ak_b.numpy().view(np.uint64))
    np_key = NS(**{f: None if getattr(key, f) is None else _fhew_numpy_key_leaf(getattr(key, f)) for f in fhew.BootstrapKey._fields})
    for fn, arg in ((fhew_crs_from_numpy, np_crs), (fhew_key_share_from_numpy, np_share), (fhew_bootstrap_key_from_numpy, np_key)):
        with pytest.raises(RuntimeError, match="GPU"):
            fn(arg)
    assert all(torch.equal(x, y) for x, y in zip(fhew_crs_from_numpy(np_crs, device="cpu"), crs))
    got = fhew_key_share_from_numpy(np_share, device="cpu")
    assert torch.equal(got.brk.a, share.brk.a) and torch.equal(got.ak_b, share.ak_b)
    carried = fhew_bootstrap_key_from_numpy(np_key, device="cpu")
    for f in fhew.BootstrapKey._fields:
        x, y = getattr(carried, f), getattr(key, f)
        assert (x is None and y is None) or torch.equal(x, y), f


def _fhew_numpy_key_leaf(t):
    x = t.numpy()
    return x.view(np.uint32) if t.dtype == torch.int32 else x.view(np.uint64) if t.dtype == torch.int64 else x


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


@pytest.mark.cuda
def test_fhew_key_gen_defaults_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    key = _fhew_key(None)
    assert all(t.device.type == "cuda" for t in key)


CKKS_PARAMS = dict(log_n=3, log_qi=30, big_l=2)


def test_ckks_key_gen_and_encryption_raise_without_cuda(no_cuda):
    from learn_fhe_tpu_torch.models import ckks
    from learn_fhe_tpu_torch.utils.interop import ckks_ciphertext_from_numpy, ckks_ksk_from_numpy

    params = ckks.CkksParams(**CKKS_PARAMS)
    rng = np.random.default_rng(0)
    sk = ckks.sk_gen(params, rng)
    for make in (
        lambda: ckks.pk_gen(params, sk, rng),
        lambda: ckks.rlk_gen(params, sk, rng),
        lambda: ckks.cjk_gen(params, sk, rng),
        lambda: ckks.rtk_gen(params, sk, 1, rng),
        lambda: ckks.rtk_gen_many(params, sk, [1, 2], rng),
        lambda: ckks.encode(params, np.zeros(params.l)),
        lambda: ckks_ksk_from_numpy(NS(b=np.zeros((4, 8), np.uint64), a=np.zeros((4, 8), np.uint64), qs=params.qps)),
        lambda: ckks_ciphertext_from_numpy(NS(b=np.zeros((2, 8), np.uint64), a=np.zeros((2, 8), np.uint64), qs=params.qs)),
    ):
        with pytest.raises(RuntimeError, match="GPU"):
            make()


def test_ckks_entry_points_on_cpu_when_asked():
    from learn_fhe_tpu_torch.models import ckks
    from learn_fhe_tpu_torch.utils.interop import ckks_ciphertext_from_numpy, ckks_ksk_from_numpy

    params = ckks.CkksParams(**CKKS_PARAMS)
    rng = np.random.default_rng(0)
    sk = ckks.sk_gen(params, rng)
    pk = ckks.pk_gen(params, sk, rng, device="cpu")
    rlk = ckks.rlk_gen(params, sk, rng, device="cpu")
    rtk = ckks.rtk_gen_many(params, sk, [1], rng, device="cpu")[1]
    ct = ckks.pk_encrypt(params, pk, ckks.encode(params, np.ones(params.l), device="cpu"), rng)
    ct2 = ckks.sk_encrypt(params, sk, ckks.encode(params, np.ones(params.l), device="cpu"), params.qs, rng)
    for t in (pk.b, rlk.b, rtk.ksk.a, ct.a, ct2.b):
        assert t.device.type == "cpu"
    leaves = lambda x: NS(b=x.b.numpy().view(np.uint64), a=x.a.numpy().view(np.uint64), qs=x.qs)  # noqa: E731
    assert torch.equal(ckks_ksk_from_numpy(leaves(rlk), device="cpu").b, rlk.b)
    assert torch.equal(ckks_ciphertext_from_numpy(leaves(ct), device="cpu").a, ct.a)


@pytest.mark.cuda
def test_ckks_key_gen_defaults_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from learn_fhe_tpu_torch.models import ckks

    params = ckks.CkksParams(**CKKS_PARAMS)
    rng = np.random.default_rng(0)
    sk = ckks.sk_gen(params, rng)
    rlk = ckks.rlk_gen(params, sk, rng)
    ct = ckks.sk_encrypt(params, sk, ckks.encode(params, np.ones(params.l)), params.qs, rng)
    assert rlk.b.device.type == "cuda" and ct.b.device.type == "cuda"


def _bootstrap_params():
    from learn_fhe_tpu_torch.models import ckks

    return ckks.BootstrapParams(ckks.CkksParams(log_n=3, log_qi=30, big_l=3), r=3)


def test_ckks_bootstrap_key_gen_and_carry_over_raise_without_cuda(no_cuda):
    from learn_fhe_tpu_torch.models import ckks
    from learn_fhe_tpu_torch.utils.interop import ckks_bootstrap_key_from_numpy

    bp = _bootstrap_params()
    rng = np.random.default_rng(0)
    sk = ckks.sk_gen(bp.params, rng)
    with pytest.raises(RuntimeError, match="GPU"):
        ckks.key_gen(bp, sk, rng)
    ksk = NS(b=np.zeros((6, 8), np.uint64), a=np.zeros((6, 8), np.uint64), qs=bp.params.qps)
    with pytest.raises(RuntimeError, match="GPU"):
        ckks_bootstrap_key_from_numpy(NS(bp=bp, rtk={1: NS(ksk=ksk, j=1)}))


def test_ckks_bootstrap_key_on_cpu_when_asked():
    from learn_fhe_tpu_torch.models import ckks
    from learn_fhe_tpu_torch.utils.interop import ckks_bootstrap_key_from_numpy

    bp = _bootstrap_params()
    rng = np.random.default_rng(0)
    bk = ckks.key_gen(bp, ckks.sk_gen(bp.params, rng), rng, device="cpu")
    assert bk.rtk and all(k.ksk.b.device.type == "cpu" for k in bk.rtk.values())
    leaves = {j: NS(ksk=NS(b=k.ksk.b.numpy().view(np.uint64), a=k.ksk.a.numpy().view(np.uint64), qs=k.ksk.qs), j=k.j) for j, k in bk.rtk.items()}
    carried = ckks_bootstrap_key_from_numpy(NS(bp=bp, rtk=leaves), device="cpu")
    assert all(torch.equal(carried.rtk[j].ksk.a, k.ksk.a) for j, k in bk.rtk.items())


@pytest.mark.cuda
def test_ckks_bootstrap_key_gen_defaults_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from learn_fhe_tpu_torch.models import ckks

    bp = _bootstrap_params()
    rng = np.random.default_rng(0)
    bk = ckks.key_gen(bp, ckks.sk_gen(bp.params, rng), rng)
    assert all(k.ksk.b.device.type == "cuda" for k in bk.rtk.values())


BGV_PARAMS = dict(log_n=4, t=65537, log_qi=45, big_l=2)


def _bgv_makers(params, sk, rng, **device):
    """Each BGV key generation entry point, by name."""
    from learn_fhe_tpu_torch.models import bgv
    from learn_fhe_tpu_torch.models.bgv.bgv import ksk_gen

    return {
        "pk_gen": lambda: bgv.pk_gen(params, sk, rng, **device),
        "ksk_gen": lambda: ksk_gen(params, sk, sk, rng, **device),
        "rlk_gen": lambda: bgv.rlk_gen(params, sk, rng, **device),
        "rtk_gen": lambda: bgv.rtk_gen(params, sk, 1, rng, **device).ksk,
        "cjk_gen": lambda: bgv.cjk_gen(params, sk, rng, **device),
    }


def _carry_makers(params, **device):
    """The interop entry points that carry BGV and TGSW values over from the
    JAX package's layout (numpy leaves), by name."""
    from learn_fhe_tpu_torch.utils.interop import (
        bgv_ciphertext_from_numpy,
        bgv_ksk_from_numpy,
        tggsw_ciphertext_from_numpy,
        tgsw_ciphertext_from_numpy,
    )

    n, u64 = params.n, np.uint64
    ksk = NS(b=np.ones((len(params.qps), n), u64), a=np.full((len(params.qps), n), 2, u64), qs=params.qps)
    return {
        "bgv_ciphertext_from_numpy": lambda: bgv_ciphertext_from_numpy(
            NS(b=np.ones((len(params.qs), n), u64), a=np.full((len(params.qs), n), 3, u64), qs=params.qs, factor=1), **device
        ),
        "bgv_ksk_from_numpy": lambda: bgv_ksk_from_numpy(ksk, **device),
        "bgv_ksk_from_numpy (rotation key)": lambda: bgv_ksk_from_numpy(NS(ksk=ksk, j=1), **device).ksk,
        "tgsw_ciphertext_from_numpy": lambda: tgsw_ciphertext_from_numpy(NS(a=np.ones((2, 4, 8), u64), b=np.ones((2, 4), u64)), **device),
        "tggsw_ciphertext_from_numpy": lambda: tggsw_ciphertext_from_numpy(
            NS(a=np.ones((4, 1, 16), u64), b=np.full((4, 16), 5, u64)), **device
        ),
    }


@pytest.mark.parametrize("name", ["pk_gen", "ksk_gen", "rlk_gen", "rtk_gen", "cjk_gen"])
def test_bgv_key_gen_raises_without_cuda(no_cuda, name):
    from learn_fhe_tpu_torch.models import bgv

    params = bgv.BgvParams(**BGV_PARAMS)
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="GPU"):
        _bgv_makers(params, bgv.sk_gen(params, rng), rng)[name]()


@pytest.mark.parametrize("name", ["pk_gen", "ksk_gen", "rlk_gen", "rtk_gen", "cjk_gen"])
def test_bgv_key_gen_on_cpu_when_asked(name):
    from learn_fhe_tpu_torch.models import bgv

    params = bgv.BgvParams(**BGV_PARAMS)
    rng = np.random.default_rng(0)
    out = _bgv_makers(params, bgv.sk_gen(params, rng), rng, device="cpu")[name]()
    assert out.b.device.type == "cpu" and out.a.device.type == "cpu"


@pytest.mark.parametrize(
    "name", ["bgv_ciphertext_from_numpy", "bgv_ksk_from_numpy", "bgv_ksk_from_numpy (rotation key)", "tgsw_ciphertext_from_numpy", "tggsw_ciphertext_from_numpy"]
)
def test_bgv_and_tgsw_carry_over_raises_without_cuda(no_cuda, name):
    from learn_fhe_tpu_torch.models import bgv

    with pytest.raises(RuntimeError, match="GPU"):
        _carry_makers(bgv.BgvParams(**BGV_PARAMS))[name]()


@pytest.mark.parametrize(
    "name", ["bgv_ciphertext_from_numpy", "bgv_ksk_from_numpy", "bgv_ksk_from_numpy (rotation key)", "tgsw_ciphertext_from_numpy", "tggsw_ciphertext_from_numpy"]
)
def test_bgv_and_tgsw_carry_over_on_cpu_when_asked(name):
    from learn_fhe_tpu_torch.models import bgv

    out = _carry_makers(bgv.BgvParams(**BGV_PARAMS), device="cpu")[name]()
    assert out.b.device.type == "cpu" and out.a.device.type == "cpu"
    assert int(out.b.reshape(-1)[0]) in (1, 5)


@pytest.mark.cuda
def test_bgv_key_gen_and_carry_over_default_to_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from learn_fhe_tpu_torch.models import bgv

    params = bgv.BgvParams(**BGV_PARAMS)
    rng = np.random.default_rng(0)
    made = {**_bgv_makers(params, bgv.sk_gen(params, rng), rng), **_carry_makers(params)}
    for name, make in made.items():
        out = make()
        assert out.b.device.type == "cuda" and out.a.device.type == "cuda", name


def test_parallel_entry_points_default_to_the_card():
    """The meshes and the dry run default to the CUDA device; the CPU tests
    pass device_type="cpu" / device="cpu"."""
    import inspect

    from learn_fhe_tpu_torch.parallel import coef, distributed, dryrun, mesh, multiparty

    for fn in (mesh.make_mesh, mesh.axis_mesh, coef.coef_mesh, multiparty.party_mesh, distributed.global_mesh):
        assert inspect.signature(fn).parameters["device_type"].default == "cuda", fn.__name__
    assert inspect.signature(dryrun.run).parameters["device"].default == "cuda"


def test_dryrun_raises_without_cuda(no_cuda):
    from learn_fhe_tpu_torch.parallel import dryrun

    with pytest.raises(SystemExit, match="no CUDA device"):
        dryrun.run(2)
    with pytest.raises(SystemExit, match="no CUDA device"):
        dryrun.main(["--ranks", "2"])


def test_large_ring_wrappers_on_cpu_when_asked():
    """Past 2048 the u32 and u64 wrappers run their plain versions for CPU
    tensors and count no launch."""
    from learn_fhe_tpu_torch.ops import ntt as ntt64
    from learn_fhe_tpu_torch.ops import ntt32, rns

    q32 = next(two_adic_primes(31, 13))
    p32 = ntt32.ntt32_plan(q32, 4096)
    x = torch.from_numpy(np.random.default_rng(0).integers(0, q32, size=(2, 4096)).astype(np.int32))
    q64 = next(two_adic_primes(55, 13))
    p64 = ntt64.ntt_plan(q64, 4096)
    y = torch.from_numpy(np.random.default_rng(1).integers(0, q64, size=(2, 4096)).astype(np.int64))
    counted = (ntt32.ntt32, ntt32.intt32, ntt32.negacyclic_mul32, rns.rns_ntt, rns.rns_intt, rns.rns_intt_mac)
    before = [f.launches for f in counted]
    assert torch.equal(ntt32.negacyclic_mul32(x, x, p32), ntt32.negacyclic_mul32_ref(x, x, p32))
    assert torch.equal(ntt64.negacyclic_mul64(y, y, p64), ntt64.negacyclic_mul64_ref(y, y, p64))
    assert [f.launches for f in counted] == before
