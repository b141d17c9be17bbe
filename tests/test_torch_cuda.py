"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one. They import no
JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each kernel's output must equal (`torch.equal`) its plain version's on a CPU
copy of the same inputs: all of it is exact integer arithmetic.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from learn_fhe_tpu_torch.models import tfhe  # noqa: E402
from learn_fhe_tpu_torch.models.tfhe import tggsw, tlwe  # noqa: E402
from learn_fhe_tpu_torch.models.tfhe.tglwe import TglweCiphertext  # noqa: E402
from learn_fhe_tpu_torch.ops import ntt32 as tntt  # noqa: E402
from learn_fhe_tpu_torch.ops import torus_crt as tcrt  # noqa: E402
from learn_fhe_tpu_torch.ops.modular32 import shoup32  # noqa: E402
from learn_fhe_tpu_torch.parallel.batch import tfhe_pbs_batch  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import u32_to_torch, u64_to_torch  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def _step_plan(n):
    return tcrt.torus_crt_plan(n, tcrt.required_bound_bits(n, 23, 2))


def _same(got: torch.Tensor, want: torch.Tensor) -> None:
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


def _key_plan(n):
    return tcrt.torus_crt_plan(n, tcrt.required_bound_bits(n, 2, 1))


@pytest.mark.parametrize("n", [1 << k for k in range(1, 12)])
def test_ntt_kernels_match_plain(dev, n):
    """K-NTT, its inverse and K-POLYMUL at every ring, on 1 row, 3 rows and
    (below N=2048, where a block holds 2048 / N rows) a row count that
    leaves the last block ragged, with inputs holding 0 and q - 1, under
    every prime of the step plan (B=2^23, R=2) and of key generation's
    (B=2, R=1)."""
    rng = np.random.default_rng(n)
    counts = [1, 3] + ([2 * (2048 // n) + 3] if n < 2048 else [])
    primes = dict.fromkeys(_step_plan(n).primes + _key_plan(n).primes)
    for q in primes:
        plan = tntt.ntt32_plan(q, n)
        for rows in counts:
            a = rng.integers(0, q, size=(rows, n), dtype=np.uint32)
            b = rng.integers(0, q, size=(rows, n), dtype=np.uint32)
            a[0, 0], a[-1, -1], b[0, -1], b[-1, 0] = 0, q - 1, q - 1, 0
            a, b = u32_to_torch(a), u32_to_torch(b)
            _same(tntt.ntt32(a.to(dev), plan), tntt.ntt32_ref(a, plan))
            _same(tntt.intt32(a.to(dev), plan), tntt.intt32_ref(a, plan))
            _same(tntt.negacyclic_mul32(a.to(dev), b.to(dev), plan), tntt.negacyclic_mul32_ref(a, b, plan))


@pytest.mark.parametrize("log_b,rows", [(23, 2), (2, 1)])
def test_garner_kernel_matches_plain(dev, log_b, rows):
    plan = tcrt.torus_crt_plan(256, tcrt.required_bound_bits(256, log_b, rows))
    rng = np.random.default_rng(log_b)
    res = u32_to_torch(np.stack([rng.integers(0, q, size=(3, 256), dtype=np.uint32) for q in plan.primes]))
    _same(tcrt.garner_to_u64(res.to(dev), plan), tcrt.garner_to_u64_ref(res, plan))


# every width of the last radix-8 pass, alone and after full passes
@pytest.mark.parametrize(
    "n,batch", [(2, 3), (4, 3), (8, 3), (16, 3), (32, 3), (64, 3), (128, 3), (256, 5), (512, 3), (1024, 3), (2048, 3)]
)
def test_step_kernel_matches_plain(dev, n, batch):
    params = tfhe.TggswParams(
        tfhe.TglweParams(log_p=4, padding=1, big_n=n, k=1, std_dev=2.85e-15), log_b=23, d=1
    )
    plan = _step_plan(n)
    rng = np.random.default_rng(n)
    av = np.stack([rng.integers(0, q, size=(2, 1, n), dtype=np.uint32) for q in plan.primes])
    bv = np.stack([rng.integers(0, q, size=(2, n), dtype=np.uint32) for q in plan.primes])
    ad = np.stack([shoup32(v, q) for v, q in zip(av, plan.primes)])
    bd = np.stack([shoup32(v, q) for v, q in zip(bv, plan.primes)])
    key = tggsw.TggswEval(*(u32_to_torch(x) for x in (av, ad, bv, bd)))
    mv, md = (u32_to_torch(x) for x in tcrt.monomial_eval_table(n, tcrt.required_bound_bits(n, 23, 2)))
    a = u64_to_torch(rng.integers(0, 1 << 64, size=(batch, 1, n), dtype=np.uint64))
    b = u64_to_torch(rng.integers(0, 1 << 64, size=(batch, n), dtype=np.uint64))
    s = torch.from_numpy(rng.integers(0, 2 * n + 1, size=batch))
    s[0] = 2 * n
    want = tggsw.cmux_rotate_ref(params, key, TglweCiphertext(a.clone(), b.clone()), s, mv, md)
    acc = TglweCiphertext(a.to(dev), b.to(dev))
    before = tggsw.cmux_rotate.launches
    out = tggsw.cmux_rotate(
        params, tggsw.TggswEval(*(x.to(dev) for x in key)), acc, s.to(dev), mv.to(dev), md.to(dev)
    )
    assert tggsw.cmux_rotate.launches == before + 1 and out.a is acc.a
    _same(out.a, want.a)
    _same(out.b, want.b)


def _real_key(n_lwe, big_n):
    """A bootstrap key from key_gen (on the CPU) with n_lwe steps at ring big_n."""
    params = tfhe.BootstrapParams(
        tfhe.TlweParams(log_p=4, padding=1, n=n_lwe, std_dev=1.34e-7, log_b=4, d=5),
        tfhe.TggswParams(
            tfhe.TglweParams(log_p=4, padding=1, big_n=big_n, k=1, std_dev=2.85e-15), log_b=23, d=1
        ),
    )
    rng = np.random.default_rng(big_n + n_lwe)
    return params, tfhe.key_gen(params, tlwe.sk_gen(params.tlwe, rng), rng, "cpu")


_REAL_KEYS = {}


def _cached_real_key(n_lwe, big_n):
    if (n_lwe, big_n) not in _REAL_KEYS:
        _REAL_KEYS[n_lwe, big_n] = _real_key(n_lwe, big_n)
    return _REAL_KEYS[n_lwe, big_n]


def _acc_and_exps(rng, batch, n, steps):
    a = u64_to_torch(rng.integers(0, 1 << 64, size=(batch, 1, n), dtype=np.uint64))
    b = u64_to_torch(rng.integers(0, 1 << 64, size=(batch, n), dtype=np.uint64))
    s = rng.integers(0, 2 * n + 1, size=(steps, batch))
    edge = np.array([0, n, 2 * n - 1, 2 * n])  # mod_switch_2n can give 2N, which is X^0
    s.reshape(-1)[: min(4, s.size)] = edge[: min(4, s.size)]
    return a, b, torch.from_numpy(s)


@pytest.mark.parametrize("batch", [1, 5, 128])
@pytest.mark.parametrize("n", [256, 2048])
def test_cluster_step_kernel_matches_plain_with_real_key(dev, n, batch):
    """One launch of the cluster step kernel at the given batch against
    cmux_rotate_ref, with a key from key_gen and exponents 0, N, 2N-1, 2N."""
    params, key = _cached_real_key(16, n)
    rng = np.random.default_rng(n + batch)
    a, b, s = _acc_and_exps(rng, batch, n, 1)
    key0 = tggsw.TggswEval(*(t[3] for t in key.brk))
    want = tggsw.cmux_rotate_ref(params.tggsw, key0, TglweCiphertext(a.clone(), b.clone()), s[0], key.mon_v, key.mon_d)
    acc = TglweCiphertext(a.to(dev), b.to(dev))
    out = tggsw.cmux_rotate(
        params.tggsw, tggsw.TggswEval(*(t.to(dev) for t in key0)), acc, s[0].to(dev), key.mon_v.to(dev), key.mon_d.to(dev)
    )
    _same(out.a, want.a)
    _same(out.b, want.b)


@pytest.mark.parametrize("n", [256, 2048])
def test_blind_rotate_steps_matches_cpu_loop(dev, n):
    """16 steps from one C call on the card against the CPU loop of
    cmux_rotate_ref, with a key from key_gen."""
    params, key = _cached_real_key(16, n)
    rng = np.random.default_rng(n)
    a, b, s = _acc_and_exps(rng, 5, n, 16)
    want = tggsw.blind_rotate_steps(params.tggsw, key.brk, TglweCiphertext(a.clone(), b.clone()), s, key.mon_v, key.mon_d)
    acc = TglweCiphertext(a.to(dev), b.to(dev))
    before = tggsw.blind_rotate_steps.launches
    out = tggsw.blind_rotate_steps(
        params.tggsw, tggsw.TggswEval(*(t.to(dev) for t in key.brk)), acc, s.to(dev), key.mon_v.to(dev), key.mon_d.to(dev)
    )
    assert tggsw.blind_rotate_steps.launches == before + 16 and out.a is acc.a
    _same(out.a, want.a)
    _same(out.b, want.b)


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    plan = _step_plan(256).plans[0]
    x = torch.zeros((4, 256), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        tntt.ntt32(x.long(), plan)  # wrong dtype
    with pytest.raises(ValueError):
        tntt.ntt32(x.t(), plan)  # not contiguous / wrong length
    big = tntt.ntt32_plan(_step_plan(4096).primes[0], 4096)
    with pytest.raises(ValueError):
        tntt.ntt32(torch.zeros((1, 4096), dtype=torch.int32, device=dev), big)
    with pytest.raises(ValueError):  # not 16-byte aligned
        tntt.ntt32(torch.zeros(2 * 256 + 1, dtype=torch.int32, device=dev)[1:].view(2, 256), plan)
    small_q = tntt.ntt32_plan(7681, 256)  # below 2^30: the product's reduction needs q > 2^30
    with pytest.raises(ValueError):
        tntt.negacyclic_mul32(x, x, small_q)
    params = tfhe.TggswParams(
        tfhe.TglweParams(log_p=4, padding=1, big_n=64, k=2, std_dev=1e-11), log_b=12, d=2
    )
    acc = TglweCiphertext(
        torch.zeros((1, 2, 64), dtype=torch.int64, device=dev),
        torch.zeros((1, 64), dtype=torch.int64, device=dev),
    )
    with pytest.raises(ValueError):
        tggsw.cmux_rotate(params, None, acc, None, None, None)
    with pytest.raises(ValueError):
        tggsw.blind_rotate_steps(params, None, acc, None, None, None)


def test_key_switch_int8_matmul_matches_cpu(dev):
    rng = np.random.default_rng(7)
    params = tfhe.TlweParams(log_p=4, padding=1, n=40, std_dev=1e-8, log_b=4, d=5)
    ksk = tlwe.TlweKeySwitchingKey(
        u64_to_torch(rng.integers(0, 1 << 64, size=(5, 96, 40), dtype=np.uint64)),
        u64_to_torch(rng.integers(0, 1 << 64, size=(5, 96), dtype=np.uint64)),
    )
    ct = tlwe.TlweCiphertext(
        u64_to_torch(rng.integers(0, 1 << 64, size=(3, 96), dtype=np.uint64)),
        u64_to_torch(rng.integers(0, 1 << 64, size=(3,), dtype=np.uint64)),
    )
    want = tlwe.key_switch(params, ksk, ct)
    got = tlwe.key_switch(
        params, tlwe.TlweKeySwitchingKey(*(x.to(dev) for x in ksk)), tlwe.TlweCiphertext(*(x.to(dev) for x in ct))
    )
    _same(got.a, want.a)
    _same(got.b, want.b)


def test_pbs_batch_on_card_matches_cpu(dev):
    """The whole slice at N=256, n=64, batch 8: keys made on the card and on
    the CPU from one seed, and the PBS outputs, are bit-identical."""
    params = tfhe.BootstrapParams(
        tfhe.TlweParams(log_p=2, padding=1, n=64, std_dev=1.34e-7, log_b=4, d=5),
        tfhe.TggswParams(
            tfhe.TglweParams(log_p=2, padding=1, big_n=256, k=1, std_dev=2.85e-15), log_b=23, d=1
        ),
    )
    keys, outs = [], []
    for device in ("cpu", dev):
        rng = np.random.default_rng(17)
        z = tlwe.sk_gen(params.tlwe, rng)
        key = tfhe.key_gen(params, z, rng, device)
        ms = torch.arange(8, device=device) % params.tlwe.p
        cts = tlwe.sk_encrypt(params.tlwe, z, tlwe.encode(params.tlwe, ms), rng)
        tab = u64_to_torch(tfhe.lut_table(params.tlwe.log_p, params.big_n, lambda v: v), device)
        out = tfhe_pbs_batch(params, key, tab, cts)
        assert torch.equal(tlwe.decode(params.tlwe, tlwe.decrypt(params.tlwe, z, out)), ms)
        keys.append(key)
        outs.append(out)
    torch.cuda.synchronize()
    for got, want in zip(keys[1].brk + keys[1].ksk, keys[0].brk + keys[0].ksk):
        assert torch.equal(got.cpu(), want)
    assert torch.equal(outs[1].a.cpu(), outs[0].a) and torch.equal(outs[1].b.cpu(), outs[0].b)
