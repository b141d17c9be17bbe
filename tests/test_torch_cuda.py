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
    small_q = tntt.ntt32_plan(7681, 256)  # below 2^30: two K-NTT launches, the product in torch, intt32
    before = tntt.negacyclic_mul32.launches
    y = torch.from_numpy(np.random.default_rng(3).integers(0, 7681, size=(4, 256), dtype=np.int32))
    _same(tntt.negacyclic_mul32(y.to(dev), y.flip(0).to(dev), small_q), tntt.negacyclic_mul32_ref(y, y.flip(0), small_q))
    assert tntt.negacyclic_mul32.launches == before
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


# -- FHEW: K-FHEW-BR, the C schedule, K-NTT at the 28-bit primes -----------------

_FHEW = {}


def _fhew_env(log_n):
    """FHEW params (B=2^7, d=4, LWE n=16 at N=128; the reference fixture's
    n=100, w=10 at N=512) and a key from key_gen on the CPU."""
    from learn_fhe_tpu_torch.models import fhew
    from learn_fhe_tpu_torch.utils.primes import two_adic_primes

    if log_n not in _FHEW:
        q = next(two_adic_primes(28, log_n + 1))
        n_lwe, w = (16, 5) if log_n == 7 else (100, 10)
        params = fhew.BootstrapParams(
            fhew.RgswParams(fhew.RlweParams(q=q, p=4, log_n=log_n, log_b=7, d=4), log_b=7, d=4),
            fhew.LweParams(q=1 << 16, p=4, n=n_lwe, log_b=4, d=4),
            w=w,
        )
        rng = np.random.default_rng(log_n)
        _FHEW[log_n] = params, fhew.key_gen(params, fhew.rlwe.sk_gen(params.rlwe, rng), rng, "cpu")
    return _FHEW[log_n]


def _walk_against_plain(dev, params, key, e_idx, a_idx, rng, error=0):
    """K-FHEW-BR over (e_idx, a_idx) from random accumulators, one launch,
    against blind_rotate_core_fused_ref (on the CPU up to batch 5, else on
    CUDA tensors, where it runs on K-NTT); the error word must read `error`."""
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext

    batch = e_idx.shape[0]
    acc = RlweCiphertext(*(u32_to_torch(rng.integers(0, params.big_q, size=(batch, params.n), dtype=np.uint32)) for _ in "ab"))
    acc.a[0, :2], acc.b[0, -2:] = 0, params.big_q - 1
    ref_dev = "cpu" if batch <= 5 else dev
    on = lambda t, d: boot.BootstrapKey(*(x.to(d) for x in t))  # noqa: E731
    valid_e = torch.where((e_idx < -1) | (e_idx >= key.brk_a.shape[0]), -1, e_idx)
    valid_a = torch.where((a_idx < -1) | (a_idx >= key.ak_a.shape[0]), -1, a_idx)
    cut = ((valid_e != e_idx) | (valid_a != a_idx)).long().cumsum(1) > 0  # a walk ends at its first bad index
    want = boot.blind_rotate_core_fused_ref(
        params, on(key, ref_dev), valid_e.masked_fill(cut, -1).to(ref_dev), valid_a.masked_fill(cut, -1).to(ref_dev),
        RlweCiphertext(acc.a.to(ref_dev), acc.b.to(ref_dev)),
    )  # fmt: skip
    word = boot.walk_error(dev)
    word.zero_()
    before = boot.blind_rotate_core_fused.launches
    got = boot.blind_rotate_core_fused(params, on(key, dev), e_idx.to(dev), a_idx.to(dev), RlweCiphertext(acc.a.to(dev), acc.b.to(dev)))
    assert boot.blind_rotate_core_fused.launches == before + 1
    _same(got.a, want.a.cpu())
    _same(got.b, want.b.cpu())
    assert int(word.item()) == error
    word.zero_()


@pytest.mark.parametrize("batch", [1, 5, 128, 133, 1024])
@pytest.mark.parametrize("log_n", [7, 9])
def test_fhew_blind_rotate_kernel_matches_plain(dev, log_n, batch):
    """One launch of K-FHEW-BR over a batch's whole fused schedule, from
    random odd masks, against blind_rotate_core_fused_ref."""
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot

    params, key = _fhew_env(log_n)
    rng = np.random.default_rng(batch)
    a2n = torch.from_numpy(2 * rng.integers(0, params.n, size=(batch, params.lwe_s.n)) + 1)
    _walk_against_plain(dev, params, key, *boot.schedule(params, a2n), rng)


def _compact(idx: torch.Tensor) -> torch.Tensor:
    """Each row's entries >= 0 moved to its front, -1 after them."""
    out = torch.full_like(idx, -1)
    for r, row in enumerate(idx):
        kept = row[row >= 0]
        out[r, : kept.numel()] = kept
    return out


@pytest.mark.parametrize("kind", ["ext-only", "auto-only", "empty", "ragged"])
@pytest.mark.parametrize("log_n", [7, 9])
def test_fhew_blind_rotate_kernel_on_synthetic_schedules(dev, log_n, kind):
    """Schedules the gates never make, at batch 133: every row's external
    products alone, its automorphisms alone, no step at all, and each row
    cut at its own length (some at 0 steps)."""
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot

    params, key = _fhew_env(log_n)
    rng = np.random.default_rng(len(kind))
    e_idx, a_idx = boot.schedule(params, torch.from_numpy(2 * rng.integers(0, params.n, size=(133, params.lwe_s.n)) + 1))
    none = torch.full_like(e_idx, -1)
    if kind == "ext-only":
        e_idx, a_idx = _compact(e_idx), none
    elif kind == "auto-only":
        e_idx, a_idx = none, _compact(a_idx)
    elif kind == "empty":
        e_idx, a_idx = none, none.clone()
    else:
        ends = torch.from_numpy(rng.integers(0, e_idx.shape[1] + 1, size=(133, 1)))
        ends[:3, 0] = torch.tensor([0, 1, e_idx.shape[1]])
        past = torch.arange(e_idx.shape[1])[None] >= ends
        e_idx, a_idx = e_idx.masked_fill(past, -1), a_idx.masked_fill(past, -1)
    _walk_against_plain(dev, params, key, e_idx, a_idx, rng)


@pytest.mark.parametrize("log_n", [3, 7, 11])
def test_fhew_blind_rotate_kernel_per_row_reduction(dev, log_n):
    """The largest q (31 bits) and digit-row count (2d = 16) the wrapper
    takes, where rows * (q-1)^2 >= 2^64 and the kernel reduces its u64
    sum every 4 rows: at N=8 and N=2048 the key rows are read from device
    memory (too small to copy, or too large to fit beside the digit
    buffer), at N=128 they are copied into shared memory."""
    from learn_fhe_tpu_torch.models import fhew
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.utils.primes import two_adic_primes

    q = next(two_adic_primes(31, log_n + 1))
    params = fhew.BootstrapParams(
        fhew.RgswParams(fhew.RlweParams(q=q, p=4, log_n=log_n, log_b=3, d=8), log_b=3, d=8),
        fhew.LweParams(q=1 << 16, p=4, n=6, log_b=4, d=4),
        w=3,
    )
    assert max(2 * 8, 8) == boot.FHEW_MAX_ROWS and boot.contraction_chunk(q, boot.FHEW_MAX_ROWS) == 4
    rng = np.random.default_rng(log_n)
    key = fhew.key_gen(params, fhew.rlwe.sk_gen(params.rlwe, rng), rng, "cpu")
    a2n = torch.from_numpy(2 * rng.integers(0, params.n, size=(5, params.lwe_s.n)) + 1)
    _walk_against_plain(dev, params, key, *boot.schedule(params, a2n), rng)


def test_fhew_blind_rotate_kernel_flags_an_index_outside_the_key(dev):
    """Indices the host check would refuse, given to the wrapper directly:
    each such walk ends before the bad step and sets its bit of the error
    word (1: ext, 2: auto); the other ciphertexts walk on."""
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot

    params, key = _fhew_env(7)
    rng = np.random.default_rng(21)
    e_idx, a_idx = boot.schedule(params, torch.from_numpy(2 * rng.integers(0, params.n, size=(5, params.lwe_s.n)) + 1))
    e_idx[1, 3], a_idx[2, 0], e_idx[3, 0], a_idx[3, 4] = params.lwe_s.n, params.w + 1, -7, -2
    _walk_against_plain(dev, params, key, e_idx, a_idx, rng, error=3)


def test_fhew_blind_rotate_makes_no_host_sync(dev):
    """The walk's wrapper under torch.cuda.set_sync_debug_mode("error"): no
    read back to the host, and the result still equals the plain version."""
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext

    params, key = _fhew_env(9)
    rng = np.random.default_rng(4)
    e_idx, a_idx = boot.schedule(params, torch.from_numpy(2 * rng.integers(0, params.n, size=(4, params.lwe_s.n)) + 1))
    acc = RlweCiphertext(*(u32_to_torch(rng.integers(0, params.big_q, size=(4, params.n), dtype=np.uint32)) for _ in "ab"))
    want = boot.blind_rotate_core_fused_ref(params, key, e_idx, a_idx, acc)
    key_d = boot.BootstrapKey(*(x.to(dev) for x in key))
    args = (params, key_d, e_idx.to(dev), a_idx.to(dev), RlweCiphertext(acc.a.to(dev), acc.b.to(dev)))
    boot.blind_rotate_core_fused(*args)  # builds the library, uploads the tables, makes the error word
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = boot.blind_rotate_core_fused(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same(got.a, want.a)
    _same(got.b, want.b)
    assert int(boot.walk_error(dev).item()) == 0


@pytest.mark.parametrize("log_n", [7, 9])
def test_fhew_schedule_c_matches_python(dev, log_n):
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot

    params, _ = _fhew_env(log_n)
    a = 2 * np.random.default_rng(log_n).integers(0, params.n, size=(128, params.lwe_s.n)) + 1
    want = boot.fuse_schedule(*boot.build_schedule(params, a))
    got = boot.schedule_native(params, a)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got_dev = boot.schedule(params, torch.from_numpy(a).to(dev))
    for g, w in zip(got_dev, want):
        assert g.device.type == "cuda" and np.array_equal(g.cpu().numpy(), w)


@pytest.mark.parametrize("q,n", [(268409857, 512), (268432897, 128)])
def test_ntt_kernels_at_fhew_primes(dev, q, n):
    """K-NTT and intt32 at FHEW's 28-bit primes, on key generation's row
    count and a ragged last block, and the product routed through them."""
    plan = tntt.ntt32_plan(q, n)
    rng = np.random.default_rng(n)
    for rows in (800, 19):
        a = rng.integers(0, q, size=(rows, n), dtype=np.uint32)
        a[0, 0], a[-1, -1] = 0, q - 1
        a = u32_to_torch(a)
        _same(tntt.ntt32(a.to(dev), plan), tntt.ntt32_ref(a, plan))
        _same(tntt.intt32(a.to(dev), plan), tntt.intt32_ref(a, plan))
        _same(tntt.negacyclic_mul32(a.to(dev), a.flip(0).to(dev), plan), tntt.negacyclic_mul32_ref(a, a.flip(0), plan))


def test_fhew_gate_batch_on_card_matches_cpu(dev):
    """Keys from one seed on the card and on the CPU, and a NAND batch of 8
    through fhew_gate_batch: bit-identical, and right."""
    from learn_fhe_tpu_torch.models import fhew
    from learn_fhe_tpu_torch.models.fhew import gates, lwe
    from learn_fhe_tpu_torch.parallel.batch import fhew_gate_batch

    params, _ = _fhew_env(7)
    outs = []
    for device in ("cpu", dev):
        rng = np.random.default_rng(5)
        z = fhew.rlwe.sk_gen(params.rlwe, rng)
        key = fhew.key_gen(params, z, rng, device)
        m0, m1 = torch.tensor([0, 0, 1, 1] * 2, device=device), torch.tensor([0, 1, 0, 1] * 2, device=device)
        c0 = lwe.sk_encrypt(params.lwe_z, z, gates.encode_bool(params, m0), rng)
        c1 = lwe.sk_encrypt(params.lwe_z, z, gates.encode_bool(params, m1), rng)
        out = fhew_gate_batch(params, key, "nand", c0, c1)
        assert torch.equal(gates.decode_bool(params, lwe.decrypt(params.lwe_z, z, out)), ~(m0.bool() & m1.bool()))
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[1].a.cpu(), outs[0].a) and torch.equal(outs[1].b.cpu(), outs[0].b)


# -- the u64 engine: K-NTT64, K-POLYMUL64, K-EXTPROD64, K-FHEW-BR64 -------------


def _u64(rng, q, shape):
    x = rng.integers(0, q, size=shape, dtype=np.uint64)
    x.reshape(-1)[:2] = [0, q - 1]
    return u64_to_torch(x)


def _prime64(bits, log_n):
    from learn_fhe_tpu_torch.utils.primes import two_adic_primes

    return next(two_adic_primes(bits, log_n + 1))


@pytest.mark.parametrize("n", [1 << k for k in range(1, 12)])
def test_ntt64_kernels_match_plain(dev, n):
    """K-NTT64 (both outputs), its inverse and K-POLYMUL64 at every ring, on
    1 row, 3 rows and (below N=2048, where a block holds 2048 / N rows) a
    row count that leaves the last block ragged, at the full multi-key
    set's 55-bit prime, at a 62-bit one (both lazy) and at a 63-bit one
    (the eager instances)."""
    from learn_fhe_tpu_torch.ops import ntt as ntt64

    rng = np.random.default_rng(n)
    counts = [1, 3] + ([2 * (2048 // n) + 3] if n < 2048 else [])
    for bits in (55, 62, 63):
        plan = ntt64.ntt_plan(_prime64(bits, 11), n)
        for rows in counts:
            a, b = _u64(rng, plan.q, (rows, n)), _u64(rng, plan.q, (rows, n))
            _same(ntt64.ntt64(a.to(dev), plan), ntt64.ntt64_ref(a, plan))
            _same(ntt64.ntt64_mont(a.to(dev), plan), ntt64.ntt64_mont_ref(a, plan))
            _same(ntt64.intt64(a.to(dev), plan), ntt64.intt64_ref(a, plan))
            _same(ntt64.negacyclic_mul64(a.to(dev), b.to(dev), plan), ntt64.negacyclic_mul64_ref(a, b, plan))


_FIXTURES64 = {  # (q bits, log N, log_b, d): the multi-key test fixture and the full set
    "mk54": (54, 7, 6, 9),
    "full": (55, 11, 11, 5),
}
# A prime in [2^62, 2^63), which the kernels run on their eager instance
# (d = 1: two rows of products below q 2^64).
_EAGER64 = (63, 7, 20, 1)


@pytest.mark.parametrize("fixture", list(_FIXTURES64))
@pytest.mark.parametrize("key_switch", [False, True])
def test_external_product64_kernel_matches_plain(dev, fixture, key_switch):
    """K-EXTPROD64 on 7 ciphertexts against 3 keys (an index per
    ciphertext), as an external product (2d rows) and as a key switch (d
    rows), at both multi-key fixtures' rows, and rgsw.internal_product on
    the card against the CPU."""
    from learn_fhe_tpu_torch.models.fhew import rgsw
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext
    from learn_fhe_tpu_torch.ops.gadget import Gadget
    from learn_fhe_tpu_torch.ops.ntt import ntt_plan

    bits, log_n, log_b, d = _FIXTURES64[fixture]
    n = 1 << log_n
    q = _prime64(bits, log_n)
    plan, gadget = ntt_plan(q, n), Gadget(q, log_b, d)
    rows = d if key_switch else 2 * d
    rng = np.random.default_rng(bits + key_switch)
    ka, kb = _u64(rng, q, (3, rows, n)), _u64(rng, q, (3, rows, n))
    ct = RlweCiphertext(_u64(rng, q, (7, n)), _u64(rng, q, (7, n)))
    idx = torch.tensor([0, 2, 1, 1, 0, 2, 2], dtype=torch.int32)
    want = rgsw.external_product64_ref(gadget, plan, ka, kb, idx, ct, key_switch)
    before = rgsw.external_product64.launches
    got = rgsw.external_product64(
        gadget, plan, ka.to(dev), kb.to(dev), idx.to(dev), RlweCiphertext(ct.a.to(dev), ct.b.to(dev)), key_switch
    )
    assert rgsw.external_product64.launches == before + 1
    _same(got.a, want.a)
    _same(got.b, want.b)
    if not key_switch:
        from learn_fhe_tpu_torch.models import fhew

        params = fhew.RgswParams(fhew.RlweParams(q=q, p=4, log_n=log_n, log_b=log_b, d=d), log_b=log_b, d=d)
        key = rgsw.RgswEval(ka[:2], kb[:2])
        share = rgsw.RgswCiphertext(_u64(rng, q, (2, 2 * d, n)), _u64(rng, q, (2, 2 * d, n)))
        want = rgsw.internal_product(params, key, share)
        got = rgsw.internal_product(params, rgsw.RgswEval(key.a.to(dev), key.b.to(dev)), rgsw.RgswCiphertext(share.a.to(dev), share.b.to(dev)))
        _same(got.a, want.a)
        _same(got.b, want.b)


# K-NTT64 and intt64 at N=2048 at the rows the multi-key path launches
# K-NTT64's Montgomery instance at (5: make_ksk; 600: a merge chunk's
# to_eval; 6000: the final to_eval) and at a few more (every other ring:
# test_ntt64_kernels_match_plain).
@pytest.mark.parametrize("rows", [1, 3, 5, 19, 600, 6000])
@pytest.mark.parametrize("bits", [55, 63])
def test_ntt64_transforms_at_path_shapes(dev, rows, bits):
    """`ntt64_mont`, `ntt64` and `intt64` against their plain versions (run
    on the card, on the same inputs), at the full set's 55-bit prime (the
    lazy instances) and a 63-bit one (the eager), each one launch counted by
    its rows."""
    from learn_fhe_tpu_torch.ops import ntt as ntt64

    plan = ntt64.ntt_plan(_prime64(bits, 11), 2048)
    x = _u64(np.random.default_rng(rows + bits), plan.q, (rows, 2048)).to(dev)
    for fn, ref in ((ntt64.ntt64_mont, ntt64.ntt64_mont_ref), (ntt64.ntt64, ntt64.ntt64_ref), (ntt64.intt64, ntt64.intt64_ref)):
        want = ref(x, plan).cpu()
        before, by_rows = fn.launches, fn.by_rows[rows]
        _same(fn(x, plan), want)
        assert (fn.launches, fn.by_rows[rows]) == (before + 1, by_rows + 1)


def test_to_eval_is_one_launch_per_operand(dev):
    """`rgsw.to_eval` and `rlwe._to_eval_mont` at the full set launch
    K-NTT64's Montgomery instance once per operand and plain `ntt64` never,
    and equal their plain versions on the CPU."""
    from learn_fhe_tpu_torch.models import fhew
    from learn_fhe_tpu_torch.models.fhew import rgsw, rlwe
    from learn_fhe_tpu_torch.ops import ntt as ntt64

    _, log_n, log_b, d = _FIXTURES64["full"]
    q = _prime64(55, 11)
    params = fhew.RgswParams(fhew.RlweParams(q=q, p=4, log_n=log_n, log_b=log_b, d=d), log_b=log_b, d=d)
    rng = np.random.default_rng(6)
    ct = rgsw.RgswCiphertext(_u64(rng, q, (3, 2 * d, 1 << log_n)), _u64(rng, q, (3, 2 * d, 1 << log_n)))
    want = rgsw.to_eval(params, ct)
    counts = (ntt64.ntt64_mont.launches, ntt64.ntt64.launches)
    got = rgsw.to_eval(params, rgsw.RgswCiphertext(ct.a.to(dev), ct.b.to(dev)))
    assert (ntt64.ntt64_mont.launches, ntt64.ntt64.launches) == (counts[0] + 2, counts[1])
    _same(got.a, want.a)
    _same(got.b, want.b)
    got = rlwe._to_eval_mont(params.rlwe, ct.a[0].to(dev))
    assert (ntt64.ntt64_mont.launches, ntt64.ntt64.launches) == (counts[0] + 3, counts[1])
    _same(got, want.a[0])


def test_ntt64_wrappers_do_not_sync(dev):
    """`ntt64_mont`, `ntt64` and `intt64` under
    torch.cuda.set_sync_debug_mode("error") (after a first call has put the
    plan's tables on the card): no read back to the host."""
    from learn_fhe_tpu_torch.ops import ntt as ntt64

    plan = ntt64.ntt_plan(_prime64(55, 11), 2048)
    x = _u64(np.random.default_rng(7), plan.q, (5, 2048)).to(dev)
    fns = ((ntt64.ntt64_mont, ntt64.ntt64_mont_ref), (ntt64.ntt64, ntt64.ntt64_ref), (ntt64.intt64, ntt64.intt64_ref))
    for fn, _ in fns:
        fn(x, plan)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [fn(x, plan) for fn, _ in fns]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for y, (_, ref) in zip(got, fns):
        _same(y, ref(x, plan).cpu())


def test_ntt64_wrappers_refuse_rows_off_16_byte_alignment(dev):
    """K-NTT64 and intt64 read rows in 16-byte loads: a contiguous operand
    whose data starts 8 bytes off a 16-byte boundary raises before any
    launch, at N=2048 and N=4; the aligned operand beside it runs."""
    from learn_fhe_tpu_torch.ops import ntt as ntt64

    q = _prime64(55, 11)
    for n in (2048, 4):
        plan = ntt64.ntt_plan(q, n)
        flat = _u64(np.random.default_rng(n), q, (3 * n + 1,)).to(dev)
        x = flat[1:].view(3, n)
        assert x.is_contiguous() and x.data_ptr() % 16 == 8
        for fn, ref in ((ntt64.ntt64_mont, ntt64.ntt64_mont_ref), (ntt64.ntt64, ntt64.ntt64_ref), (ntt64.intt64, ntt64.intt64_ref)):
            before = fn.launches
            with pytest.raises(ValueError, match="16-byte aligned"):
                fn(x, plan)
            assert fn.launches == before
            aligned = x.clone()
            _same(fn(aligned, plan), ref(aligned, plan).cpu())


# K-POLYMUL64 at the rows the multi-key path launches it at (1: the pk
# shares; 5: ak_share_gen; 8: the u8 pk_encrypts; 6000: pk_encrypt_rgsw),
# around a full first wave of blocks (132 SMs on an H100) and past 6000.
@pytest.mark.parametrize("rows", [1, 5, 8, 131, 132, 133, 6000, 6001])
@pytest.mark.parametrize("bits", [55, 62, 63])
def test_negacyclic_mul64_kernel_at_path_shapes(dev, rows, bits):
    """K-POLYMUL64 at N=2048 against its plain version (run on the card, on
    the same inputs), at the full set's 55-bit prime, a 62-bit one (both
    lazy) and a 63-bit one (the eager instance)."""
    from learn_fhe_tpu_torch.ops import ntt as ntt64

    plan = ntt64.ntt_plan(_prime64(bits, 11), 2048)
    rng = np.random.default_rng(rows + bits)
    a, b = _u64(rng, plan.q, (rows, 2048)).to(dev), _u64(rng, plan.q, (rows, 2048)).to(dev)
    want = ntt64.negacyclic_mul64_ref(a, b, plan).cpu()
    before = ntt64.negacyclic_mul64.launches
    _same(ntt64.negacyclic_mul64(a, b, plan), want)
    assert ntt64.negacyclic_mul64.launches == before + 1
    assert ntt64.negacyclic_mul64.by_rows[rows] >= 1


@pytest.mark.parametrize("count", [1, 7, 10, 600, 601])
@pytest.mark.parametrize("key_switch", [False, True])
@pytest.mark.parametrize("fixture", ["full", "eager"])
def test_external_product64_kernel_at_merge_shapes(dev, count, key_switch, fixture):
    """K-EXTPROD64 on `count` products against its plain version (run on the
    card): at the full set, keys as a merge chunk holds them (10
    consecutive products a key, 600 = one chunk, 601 a ragged one), and on
    a 63-bit prime (the eager instance, d = 1, N=128); as an external
    product and as a key switch."""
    from learn_fhe_tpu_torch.models.fhew import rgsw
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext
    from learn_fhe_tpu_torch.ops.gadget import Gadget
    from learn_fhe_tpu_torch.ops.ntt import ntt_plan

    bits, log_n, log_b, d = _FIXTURES64["full"] if fixture == "full" else _EAGER64
    n = 1 << log_n
    q = _prime64(bits, log_n)
    plan, gadget = ntt_plan(q, n), Gadget(q, log_b, d)
    rows = d if key_switch else 2 * d
    keys = -(-count // 10)
    rng = np.random.default_rng(count + 2 * key_switch)
    ka, kb = _u64(rng, q, (keys, rows, n)).to(dev), _u64(rng, q, (keys, rows, n)).to(dev)
    ct = RlweCiphertext(_u64(rng, q, (count, n)).to(dev), _u64(rng, q, (count, n)).to(dev))
    idx = (torch.arange(count, dtype=torch.int32) // 10).to(dev)
    want = rgsw.external_product64_ref(gadget, plan, ka, kb, idx, ct, key_switch)
    got = rgsw.external_product64(gadget, plan, ka, kb, idx, ct, key_switch)
    _same(got.a, want.a.cpu())
    _same(got.b, want.b.cpu())
    assert rgsw.external_product64.by_count[count] >= 1


@pytest.mark.parametrize("key_switch", [False, True])
def test_external_product64_flags_a_key_index_outside_the_key(dev, key_switch):
    """An index outside the key leaves that output as its input and ORs 1
    into the error word; the other products are right."""
    from learn_fhe_tpu_torch.models.fhew import rgsw
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext
    from learn_fhe_tpu_torch.ops.gadget import Gadget
    from learn_fhe_tpu_torch.ops.ntt import ntt_plan
    from learn_fhe_tpu_torch.utils import kernels

    bits, log_n, log_b, d = _FIXTURES64["full"]
    n, q = 1 << log_n, _prime64(bits, log_n)
    plan, gadget = ntt_plan(q, n), Gadget(q, log_b, d)
    rows = d if key_switch else 2 * d
    rng = np.random.default_rng(9)
    ka, kb = _u64(rng, q, (2, rows, n)), _u64(rng, q, (2, rows, n))
    ct = RlweCiphertext(_u64(rng, q, (4, n)), _u64(rng, q, (4, n)))
    idx = torch.tensor([0, 2, 1, -1], dtype=torch.int32)
    word = kernels.error_word(dev)
    word.zero_()
    got = rgsw.external_product64(
        gadget, plan, ka.to(dev), kb.to(dev), idx.to(dev), RlweCiphertext(ct.a.to(dev), ct.b.to(dev)), key_switch
    )
    torch.cuda.synchronize()
    assert int(word.item()) == 1
    word.zero_()
    good = torch.tensor([True, False, True, False])
    want = rgsw.external_product64_ref(gadget, plan, ka, kb, idx.clamp(0, 1), ct, key_switch)
    assert torch.equal(got.a.cpu()[good], want.a[good]) and torch.equal(got.b.cpu()[good], want.b[good])
    assert torch.equal(got.a.cpu()[~good], ct.a[~good]) and torch.equal(got.b.cpu()[~good], ct.b[~good])


@pytest.mark.parametrize("n", [1 << k for k in range(1, 12)])
@pytest.mark.parametrize("key_switch", [False, True])
def test_external_product64_kernel_at_every_ring(dev, n, key_switch):
    """K-EXTPROD64 at every ring the kernel takes, 2 <= N <= 2048 (at N <= 4
    no head pass: the contraction makes its digits and the first inverse
    pass writes device memory), on the full set's 55-bit gadget, as an
    external product and as a key switch, against its plain version."""
    from learn_fhe_tpu_torch.models.fhew import rgsw
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext
    from learn_fhe_tpu_torch.ops.gadget import Gadget
    from learn_fhe_tpu_torch.ops.ntt import ntt_plan

    _, _, log_b, d = _FIXTURES64["full"]
    q = _prime64(55, n.bit_length() - 1)
    plan, gadget = ntt_plan(q, n), Gadget(q, log_b, d)
    rows = d if key_switch else 2 * d
    rng = np.random.default_rng(n + key_switch)
    ka, kb = _u64(rng, q, (3, rows, n)), _u64(rng, q, (3, rows, n))
    ct = RlweCiphertext(_u64(rng, q, (5, n)), _u64(rng, q, (5, n)))
    idx = torch.tensor([2, 0, 1, 2, 0], dtype=torch.int32)
    want = rgsw.external_product64_ref(gadget, plan, ka, kb, idx, ct, key_switch)
    got = rgsw.external_product64(
        gadget, plan, ka.to(dev), kb.to(dev), idx.to(dev), RlweCiphertext(ct.a.to(dev), ct.b.to(dev)), key_switch
    )
    _same(got.a, want.a)
    _same(got.b, want.b)


def test_u64_kernels_refuse_rows_off_16_byte_alignment(dev):
    """K-POLYMUL64 at N=2048 (rows brought in by bulk copies) and K-EXTPROD64
    (key rows read with 16-byte loads) raise on a contiguous view whose data
    starts 8 bytes off a 16-byte boundary, before any launch; K-POLYMUL64
    at N=256, which reads its rows a value at a time, takes it."""
    from learn_fhe_tpu_torch.models.fhew import rgsw
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext
    from learn_fhe_tpu_torch.ops import ntt as ntt64
    from learn_fhe_tpu_torch.ops.gadget import Gadget

    rng = np.random.default_rng(16)
    q = _prime64(55, 11)
    for n, raises in ((2048, True), (256, False)):
        plan = ntt64.ntt_plan(q, n)
        flat = _u64(rng, q, (2 * 3 * n + 1,)).to(dev)
        a, b = flat[1 : 3 * n + 1].view(3, n), flat[3 * n + 1 :].view(3, n)
        assert a.is_contiguous() and a.data_ptr() % 16 == 8
        before = ntt64.negacyclic_mul64.launches
        if raises:
            with pytest.raises(ValueError, match="16-byte aligned"):
                ntt64.negacyclic_mul64(a, b, plan)
            assert ntt64.negacyclic_mul64.launches == before
        else:
            _same(ntt64.negacyclic_mul64(a, b, plan), ntt64.negacyclic_mul64_ref(a.cpu(), b.cpu(), plan))
    _, log_n, log_b, d = _FIXTURES64["full"]
    n = 1 << log_n
    plan, gadget = ntt64.ntt_plan(q, n), Gadget(q, log_b, d)
    flat = _u64(rng, q, (2 * d * n + 1,)).to(dev)
    ka = flat[1:].view(1, 2 * d, n)
    kb = _u64(rng, q, (1, 2 * d, n)).to(dev)
    ct = RlweCiphertext(_u64(rng, q, (2, n)).to(dev), _u64(rng, q, (2, n)).to(dev))
    idx = torch.zeros(2, dtype=torch.int32, device=dev)
    before = rgsw.external_product64.launches
    for key_a, key_b in ((ka, kb), (kb, ka)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            rgsw.external_product64(gadget, plan, key_a, key_b, idx, ct, False)
    assert rgsw.external_product64.launches == before


_FHEW64 = {}


def _fhew64_env(name):
    """The multi-key test fixture (54-bit q, N=128, B=2^6, d=9; LWE n=16,
    w=5) with a key from key_gen on the CPU, or with random evaluation-basis
    key rows (the walk is arithmetic on whatever rows it is given) the full
    multi-key set (55-bit q, N=2048, B=2^11, d=5; LWE n=600, q_ks=2^20,
    w=10) or a 63-bit prime at N=128 (B=2^20, d=1; the LWE side of the test
    fixture), which takes the kernels' eager instance."""
    from learn_fhe_tpu_torch.models import fhew
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.ops.poly import automorphism_map

    if name not in _FHEW64:
        bits, log_n, log_b, d = _EAGER64 if name == "eager" else _FIXTURES64[name]
        q = _prime64(bits, log_n)
        full = name == "full"
        params = fhew.BootstrapParams(
            fhew.RgswParams(fhew.RlweParams(q=q, p=4, log_n=log_n, log_b=log_b, d=d), log_b=log_b, d=d),
            fhew.LweParams(q=1 << (20 if full else 16), p=4, n=600 if full else 16, log_b=5 if full else 4, d=4),
            w=10 if full else 5,
        )
        rng = np.random.default_rng(log_n)
        if name != "mk54":
            n, n_lwe, maps = params.n, params.lwe_s.n, [automorphism_map(params.n, t) for t in params.ak_t]
            key = boot.BootstrapKey(
                u64_to_torch(np.zeros((4, n, n_lwe), dtype=np.uint64)), u64_to_torch(np.zeros((4, n), dtype=np.uint64)),
                _u64(rng, q, (n_lwe, 2 * d, n)), _u64(rng, q, (n_lwe, 2 * d, n)),
                _u64(rng, q, (params.w + 1, d, n)), _u64(rng, q, (params.w + 1, d, n)),
                torch.from_numpy(np.stack([m[0] for m in maps]).astype(np.int32)), torch.from_numpy(np.stack([m[1] for m in maps])),
            )  # fmt: skip
        else:
            key = fhew.key_gen(params, fhew.rlwe.sk_gen(params.rlwe, rng), rng, "cpu")
        _FHEW64[name] = params, key
    return _FHEW64[name]


def _walk64_against_plain(dev, params, key, e_idx, a_idx, rng, error=0):
    """K-FHEW-BR64 over (e_idx, a_idx) from random accumulators, one launch,
    against blind_rotate_core_fused_ref's u64 branch (plain torch: on the
    CPU up to batch 5 at N=128, else on CUDA tensors); the error word must
    read `error`."""
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext

    batch = e_idx.shape[0]
    acc = RlweCiphertext(_u64(rng, params.big_q, (batch, params.n)), _u64(rng, params.big_q, (batch, params.n)))
    ref_dev = "cpu" if batch <= 5 and params.n <= 128 else dev
    on = lambda t, d: boot.BootstrapKey(*(None if x is None else x.to(d) for x in t))  # noqa: E731
    valid_e = torch.where((e_idx < -1) | (e_idx >= key.brk_a.shape[0]), -1, e_idx)
    valid_a = torch.where((a_idx < -1) | (a_idx >= key.ak_a.shape[0]), -1, a_idx)
    cut = ((valid_e != e_idx) | (valid_a != a_idx)).long().cumsum(1) > 0
    want = boot.blind_rotate_core_fused_ref(
        params, on(key, ref_dev), valid_e.masked_fill(cut, -1).to(ref_dev), valid_a.masked_fill(cut, -1).to(ref_dev),
        RlweCiphertext(acc.a.to(ref_dev), acc.b.to(ref_dev)),
    )  # fmt: skip
    word = boot.walk_error(dev)
    word.zero_()
    before = boot.blind_rotate_core_fused64.launches
    got = boot.blind_rotate_core_fused(params, on(key, dev), e_idx.to(dev), a_idx.to(dev), RlweCiphertext(acc.a.to(dev), acc.b.to(dev)))
    assert boot.blind_rotate_core_fused64.launches == before + 1
    _same(got.a, want.a.cpu())
    _same(got.b, want.b.cpu())
    assert int(word.item()) == error
    word.zero_()


def _batch_for_cluster(dev, params, cluster):
    """The smallest batch for which K-FHEW-BR64's wrapper picks `cluster`
    blocks per ciphertext on this card (1 where the cap picks it, else one
    more than the largest batch that a larger cluster takes); the test
    skips where no batch picks it."""
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot

    batch = 1
    for c in range(cluster + 1, min(boot.WALK64_MAX_CLUSTER, 2 * params.rgsw.gadget.d, params.rlwe.gadget.d) + 1):
        batch = max(batch, boot.walk64_resident(c, params, dev) + 1)
    if boot.walk64_cluster(batch, params, dev) != cluster:
        pytest.skip(f"no batch picks C={cluster} on this card")
    return batch


# Every cluster size the wrapper can pick: up to 8 at the 54-bit fixture
# (2d = 18, d = 9), up to 5 at the full set (2d = 10, d = 5), 1 at the
# 63-bit prime (2d = 2, d = 1); the batches that pick them depend on the card.
_CLUSTER_CASES = [("mk54", c) for c in range(1, 9)] + [("full", c) for c in range(1, 6)] + [("eager", 1)]


@pytest.mark.parametrize("name,cluster", _CLUSTER_CASES)
def test_fhew_blind_rotate64_kernel_matches_plain(dev, name, cluster):
    """One launch of K-FHEW-BR64 over a batch's whole fused schedule, from
    random odd masks, against the plain walk, at a batch that makes the
    wrapper pick `cluster` blocks per ciphertext: 2d = 18 rows at the 54-bit
    fixture, 2d = 10 at the full set, 2d = 2 at the 63-bit prime (eager
    instance); and at batch 128 of the 54-bit fixture, where it picks 1."""
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot

    params, key = _fhew64_env(name)
    batch = _batch_for_cluster(dev, params, cluster)
    batches = [batch] + ([128] if (name, cluster) == ("mk54", 1) else [])
    for b in batches:
        rng = np.random.default_rng(b)
        a2n = torch.from_numpy(2 * rng.integers(0, params.n, size=(b, params.lwe_s.n)) + 1)
        _walk64_against_plain(dev, params, key, *boot.schedule(params, a2n), rng)


@pytest.mark.parametrize("cluster", range(1, 9))
def test_fhew_blind_rotate64_kernel_flags_an_index_outside_the_key(dev, cluster):
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot

    params, key = _fhew64_env("mk54")
    batch = _batch_for_cluster(dev, params, cluster)
    rng = np.random.default_rng(21)
    e_idx, a_idx = boot.schedule(params, torch.from_numpy(2 * rng.integers(0, params.n, size=(batch, params.lwe_s.n)) + 1))
    if batch >= 4:
        e_idx[1, 3], a_idx[2, 0], e_idx[3, 0], a_idx[3, 4] = params.lwe_s.n, params.w + 1, -7, -2
    else:  # both indices of one step outside the key
        e_idx[0, 3], a_idx[0, 3] = params.lwe_s.n, params.w + 1
    _walk64_against_plain(dev, params, key, e_idx, a_idx, rng, error=3)


@pytest.mark.parametrize("cluster", range(1, 9))
def test_fhew_blind_rotate64_makes_no_host_sync(dev, cluster):
    from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot
    from learn_fhe_tpu_torch.models.fhew.rlwe import RlweCiphertext

    params, key = _fhew64_env("mk54")
    batch = _batch_for_cluster(dev, params, cluster)
    rng = np.random.default_rng(4)
    e_idx, a_idx = boot.schedule(params, torch.from_numpy(2 * rng.integers(0, params.n, size=(batch, params.lwe_s.n)) + 1))
    acc = RlweCiphertext(_u64(rng, params.big_q, (batch, params.n)), _u64(rng, params.big_q, (batch, params.n)))
    want = boot.blind_rotate_core_fused_ref(params, key, e_idx, a_idx, acc)
    key_d = boot.BootstrapKey(*(None if x is None else x.to(dev) for x in key))
    args = (params, key_d, e_idx.to(dev), a_idx.to(dev), RlweCiphertext(acc.a.to(dev), acc.b.to(dev)))
    boot.blind_rotate_core_fused(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = boot.blind_rotate_core_fused(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    _same(got.a, want.a)
    _same(got.b, want.b)
    assert int(boot.walk_error(dev).item()) == 0


def test_fhew_multikey_on_card_matches_cpu(dev):
    """The multi-key path at the 54-bit fixture from one seed on the card and
    on the CPU (crs, pk and key shares, the merge, two pk-encrypted bits, an
    AND, the threshold decryption): bit-identical, and right."""
    from learn_fhe_tpu_torch.models import fhew

    params, _ = _fhew64_env("mk54")
    outs = []
    for device in ("cpu", dev):
        rng = np.random.default_rng(5)
        crs = fhew.crs_gen(params, rng, device)
        sks = [fhew.rlwe.sk_gen(params.rlwe, rng) for _ in range(2)]
        pk = fhew.rlwe.pk_share_merge(params.rlwe, crs.pk_a, [fhew.rlwe.pk_share_gen(params.rlwe, crs.pk_a, sk, rng) for sk in sks])
        key = fhew.key_share_merge(params, crs, [fhew.key_share_gen(params, crs, sk, pk, rng) for sk in sks])
        out = fhew.FhewBool.pk_encrypt(params, key, pk, True, rng) & fhew.FhewBool.pk_encrypt(params, key, pk, True, rng)
        assert out.decryption_share_merge([out.share_decrypt(sk, rng) for sk in sks]) is True
        outs.append((key.brk_a, out.ct.a, out.ct.b))
    torch.cuda.synchronize()
    for c, g in zip(*outs):
        assert torch.equal(g.cpu(), c)


# -- CKKS: the RNS u64 kernels (csrc/rns64.cu) --------------------------------


def _rns_primes(limbs: int, log_n: int = 13, bits: int = 55) -> tuple[int, ...]:
    from learn_fhe_tpu_torch.utils.primes import two_adic_primes

    it = two_adic_primes(bits, log_n + 1)
    return tuple(next(it) for _ in range(limbs))


def _rns_residues(rng, qs, lead, n):
    return u64_to_torch(np.stack([rng.integers(0, q, size=(*lead, n), dtype=np.uint64) for q in qs], axis=-2))


@pytest.mark.parametrize("log_n", range(1, 14))
@pytest.mark.parametrize("limbs", [1, 8, 16, 23])
@pytest.mark.parametrize("batch", [1, 16])
def test_rns_kernels_match_plain(dev, log_n, limbs, batch):
    """K-RNS-NTT (forward and inverse), K-RNS-MAC (1 and 2 terms, two sums,
    a key broadcast over the batch), K-BASECONV (limbs -> limbs and a limb
    slice) and K-RESCALE (k = 1 and k = limbs // 2) at every ring N=2..2^13,
    on inputs holding 0 and q - 1; at N=2, L=23, batch 1 the elementwise
    kernels' last block is ragged (46 values)."""
    from learn_fhe_tpu_torch.ops import rns

    n = 1 << log_n
    rng = np.random.default_rng(log_n * 100 + limbs + batch)
    qps = _rns_primes(2 * limbs)
    qs, ps = qps[:limbs], qps[limbs:]
    x, y = _rns_residues(rng, qs, (batch,), n), _rns_residues(rng, qs, (batch,), n)
    x[0, 0, 0], x[-1, -1, -1] = 0, qs[-1] - 1
    plan = rns.rns_plan(qs, n)
    x, y = x.to(dev), y.to(dev)
    # the plain versions run on the same tensors on the card (plain torch:
    # the same values as on the CPU, in far less time at these sizes)
    same = lambda got, want: _same(got, want.cpu())  # noqa: E731
    same(rns.rns_ntt(x, plan), rns.rns_ntt_ref(x, plan))
    same(rns.rns_intt(x, plan), rns.rns_intt_ref(x, plan))
    same(rns.rns_mac([x], [y], plan), rns.rns_mac_ref([x], [y], plan))
    same(rns.rns_mac([x, y], [y, x], plan, [x, x]), rns.rns_mac_ref([x, y], [y, x], plan, [x, x]))
    key = y[0].contiguous()
    same(rns.rns_mac([x], [key], plan), rns.rns_mac_ref([x], [key], plan))
    same(rns.base_convert(x, qs, ps), rns.base_convert_ref(x, qs, ps))
    if limbs > 1:
        half = limbs // 2
        same(rns.base_convert(x[:, half:], qs[half:], ps[:3]), rns.base_convert_ref(x[:, half:], qs[half:], ps[:3]))
        for k in sorted({1, half}):
            rp = rns.rescale_plan(qs, k)
            conv = None if k == 1 else rns.base_convert_ref(x[:, limbs - k :], rp.drop, rp.keep, add=rp.p_half[limbs - k :])
            same(rns.rescale_k(x, qs, k), rns.rescale_finish_ref(x, conv, rp))
    assert rns.rns_ntt_ref(x.cpu()[:1, :1], rns.rns_plan(qs[:1], n)).equal(rns.rns_ntt(x[:1, :1].contiguous(), rns.rns_plan(qs[:1], n)).cpu())


# (limbs, leading axes) of the rows K-RNS-NTT is held at: 1, 3, 128 and 513 rows
_RNS_ROWS = [(1, (1,)), (3, (1,)), (8, (16,)), (19, (27,))]
# past N = 2^13: 1, 3 and 64 rows, and 60 (the production ladder's 30 q-limbs
# and 32 q + p of a ciphertext's b and a)
_RNS_BIG_ROWS = [(1, (1,)), (3, (1,)), (32, (2,)), (30, (2,))]
_RNS_ROW_CASES = [
    *((log_n, limbs, lead, bits) for log_n in (10, 11, 12, 13) for limbs, lead in _RNS_ROWS for bits in (55, 63)),
    *((log_n, limbs, lead, bits) for log_n in (14, 15, 16) for limbs, lead in _RNS_BIG_ROWS for bits in (55, 59)),
]


@pytest.mark.parametrize("log_n,limbs,lead,bits", _RNS_ROW_CASES)
def test_rns_transforms_at_row_counts(dev, log_n, limbs, lead, bits):
    """K-RNS-NTT's instances (forward and inverse, lazy at 55 bits and eager
    at 63: the cluster per row at N = 2^13 with its shapes constant and at
    2^11, 2^12, a block per row at 2^10) on 1, 3, 128 and 513 rows holding 0
    and q - 1, each row under its own limb's tables; past 2^13 (the lazy
    clusters of 2, 4 and 8 blocks at 2^14, 2^15 and 2^16) at 55 and 59 bits
    (the production ladder's widest primes) on 1, 3, 60 and 64 rows."""
    from learn_fhe_tpu_torch.ops import rns

    n = 1 << log_n
    qs = _rns_primes(limbs, log_n, bits)
    x = _rns_residues(np.random.default_rng(log_n * 1000 + limbs + bits), qs, lead, n)
    x.view(-1)[0], x[..., -1, -1] = 0, qs[-1] - 1
    plan = rns.rns_plan(qs, n)
    x = x.to(dev)
    _same(rns.rns_ntt(x, plan), rns.rns_ntt_ref(x, plan).cpu())
    _same(rns.rns_intt(x, plan), rns.rns_intt_ref(x, plan).cpu())


def test_rns_transforms_on_a_ladder(dev):
    """The 45/55-bit ladder of `tests/test_ckks_dnum.py` with its p-primes
    at N = 2^13, batch 16: both transforms over the q + p basis."""
    from learn_fhe_tpu_torch.models.ckks.ckks import CkksParams
    from learn_fhe_tpu_torch.ops import rns

    params = CkksParams(log_n=13, log_qi=55, big_l=6, log_qis=(55, 45, 45, 55, 45, 45), log_ps=(55, 55), dnum=3)
    plan = params.plan(params.qps)
    x = _rns_residues(np.random.default_rng(45), params.qps, (16,), 1 << 13).to(dev)
    _same(rns.rns_ntt(x, plan), rns.rns_ntt_ref(x, plan).cpu())
    _same(rns.rns_intt(x, plan), rns.rns_intt_ref(x, plan).cpu())


@pytest.mark.parametrize("lq", [*range(1, 17), 23, 64])
@pytest.mark.parametrize("bits", [55, 62])
def test_base_convert_kernel_at_every_limb_count(dev, lq, bits):
    """K-BASECONV's instances (lq = 1, 2, 8 with the limbs in registers, any
    other lq up to 64 in shared memory) on a limb slice of a wider tensor
    (rows contiguous, the batch stride the wider tensor's), with and without
    an added constant, into 5 output limbs; at 62 bits a 128-bit sum holds 4
    terms, so lq > 4 takes more than one chunk."""
    from learn_fhe_tpu_torch.ops import rns

    n, lp = 1 << 13, 5
    qs = _rns_primes(lq + 2, 13, bits)
    ps = _rns_primes(lp, 12, 55)
    x = _rns_residues(np.random.default_rng(lq * 7 + bits), qs, (4,), n)
    x.view(-1)[0], x[..., -1, -1] = 0, qs[-1] - 1
    view = x.to(dev)[:, 1 : lq + 1]
    src = qs[1 : lq + 1]
    add = tuple(q // 2 for q in src)
    for a in (None, add):
        _same(rns.base_convert(view, src, ps, add=a), rns.base_convert_ref(view, src, ps, add=a).cpu())


def _mac_operands(rng, qs, lead, n, terms, with_z, broadcast):
    """terms x of (*lead, L, N), as many y (and z) of that shape or, with
    broadcast, of (L, N), on the CPU; x holding 0 and q - 1."""
    xs = [_rns_residues(rng, qs, lead, n) for _ in range(terms)]
    xs[0].view(-1)[0], xs[-1][..., -1, -1] = 0, qs[-1] - 1
    w_lead = () if broadcast else lead
    ys = [_rns_residues(rng, qs, w_lead, n) for _ in range(terms)]
    zs = [_rns_residues(rng, qs, w_lead, n) for _ in range(terms)] if with_z else None
    return xs, ys, zs


def _check_intt_mac(dev, plan, xs, ys, zs):
    from learn_fhe_tpu_torch.ops import rns

    on = lambda ts: None if ts is None else [t.to(dev) for t in ts]  # noqa: E731
    xd, yd, zd = on(xs), on(ys), on(zs)
    launches = rns.rns_intt_mac.launches
    # the plain version runs on the same tensors on the card: the CPU's values, sooner
    _same(rns.rns_intt_mac(xd, yd, plan, zd), rns.rns_intt_mac_ref(xd, yd, plan, zd).cpu())
    assert rns.rns_intt_mac.launches == launches + 1


@pytest.mark.parametrize("log_n", range(1, 17))
@pytest.mark.parametrize("bits", [55, 62, 63])
def test_rns_intt_mac_at_every_ring(dev, log_n, bits):
    """rns_intt_mac (the MAC sums inside K-RNS-NTT's inverse: a cluster per
    row from N = 2048, at N = 2^13 and past it with the 1- and 2-term
    instances; a block per row below) at every ring N = 2..2^16, lazy at 55
    and 62 bits (where a 128-bit sum holds 4 products, so 16 terms take 4
    REDCs) and eager at 63 (2 products a REDC; past 2^13 the wrapper raises:
    the instances there are lazy), on 1, 2, 3 and 16 terms, with and without
    z, with y and z of x's shape or a key broadcast over the batch: equal to
    rns_intt_ref(rns_mac_ref(..))."""
    from learn_fhe_tpu_torch.ops import rns

    n = 1 << log_n
    qs = _rns_primes(3, log_n, bits)
    plan = rns.rns_plan(qs, n)
    rng = np.random.default_rng(log_n * 100 + bits)
    if log_n > 13 and bits == 63:
        x = torch.zeros((2, 3, n), dtype=torch.int64, device=dev)
        with pytest.raises(ValueError):
            rns.rns_intt_mac([x], [x], plan)
        return
    for terms, with_z, broadcast in [(1, False, False), (1, True, True), (2, False, True), (2, True, False), (3, True, True), (16, False, False), (16, True, True)]:
        _check_intt_mac(dev, plan, *_mac_operands(rng, qs, (2,), n, terms, with_z, broadcast))


@pytest.mark.parametrize("log_n", [10, 11, 13])
@pytest.mark.parametrize("limbs,lead", _RNS_ROWS)
@pytest.mark.parametrize("bits", [55, 63])
def test_rns_intt_mac_at_row_counts(dev, log_n, limbs, lead, bits):
    """rns_intt_mac on 1, 3, 128 and 513 x rows (2, 6, 256 and 1026 output
    rows with z), 1 and 2 terms, each row under its own limb's tables, the
    key broadcast or not; lazy at 55 bits, eager at 63."""
    from learn_fhe_tpu_torch.ops import rns

    n = 1 << log_n
    qs = _rns_primes(limbs, log_n, bits)
    plan = rns.rns_plan(qs, n)
    rng = np.random.default_rng(log_n * 1000 + limbs + bits)
    for terms, with_z, broadcast in [(1, False, False), (1, True, True), (2, False, True), (2, True, False)]:
        _check_intt_mac(dev, plan, *_mac_operands(rng, qs, lead, n, terms, with_z, broadcast))


def test_rns_intt_mac_on_limb_slices_and_misaligned_views(dev):
    """Keys that are slices of a wider key's limbs (contiguous rows at an
    offset, as the key switch's active level selects them) give the plain
    version's values; an x, y or z off 16-byte alignment raises."""
    from learn_fhe_tpu_torch.ops import rns

    n, limbs = 1 << 13, 8
    qs = _rns_primes(limbs + 2)
    plan = rns.rns_plan(qs[1 : limbs + 1], n)
    rng = np.random.default_rng(17)
    x = _rns_residues(rng, qs[1 : limbs + 1], (4,), n).to(dev)
    wide = [_rns_residues(rng, qs, (), n).to(dev) for _ in range(2)]
    kb, ka = (w[1 : limbs + 1] for w in wide)
    assert kb.is_contiguous() and kb.data_ptr() != wide[0].data_ptr()
    _same(rns.rns_intt_mac([x], [kb], plan, [ka]), rns.rns_intt_mac_ref([x], [kb], plan, [ka]).cpu())
    _same(rns.rns_intt_mac([x, x], [kb, ka], plan), rns.rns_intt_mac_ref([x, x], [kb, ka], plan).cpu())
    flat = torch.zeros(limbs * n + 1, dtype=torch.int64, device=dev)
    off = flat[1:].view(limbs, n)
    for args in (([off[None]], [kb]), ([x], [off]), ([x], [kb], [off])):
        with pytest.raises(ValueError):
            rns.rns_intt_mac(args[0], args[1], plan, *args[2:])
        with pytest.raises(ValueError):
            rns.rns_mac(args[0], args[1], plan, *args[2:])


def test_base_convert_kernel_past_its_shared_memory(dev):
    """64 input limbs into more output limbs than the tables of one launch
    hold in a block's shared memory: the wrapper launches K-BASECONV on
    slices of the output primes; the result is the plain version's."""
    from learn_fhe_tpu_torch.ops import rns

    primes = _rns_primes(64 + rns._conv_out_limbs(64) + 7)
    qs, ps = primes[:64], primes[64:]
    x = _rns_residues(np.random.default_rng(164), qs, (2,), 1 << 10).to(dev)
    launches = rns.base_convert.launches
    _same(rns.base_convert(x, qs, ps), rns.base_convert_ref(x, qs, ps).cpu())
    assert rns.base_convert.launches - launches == -(-len(ps) // rns._conv_out_limbs(64))


def test_rns_wrappers_do_not_sync(dev):
    """`rns_ntt`, `rns_intt`, `rns_intt_mac` (a cluster per row, and a block
    per row; one term, two terms with z and a broadcast key) and
    `base_convert` (an instance with the limbs in registers and one with
    them in shared memory, with and without an added constant) under
    torch.cuda.set_sync_debug_mode("error"), after a first call has put the
    tables on the card: no read back to the host."""
    from learn_fhe_tpu_torch.ops import rns

    qs = _rns_primes(8)
    rng = np.random.default_rng(8)
    calls = []
    for n in (1 << 13, 1 << 9):
        plan = rns.rns_plan(qs, n)
        x = _rns_residues(rng, qs, (2,), n).to(dev)
        calls += [(rns.rns_ntt, rns.rns_ntt_ref, (x, plan)), (rns.rns_intt, rns.rns_intt_ref, (x, plan))]
        key = _rns_residues(rng, qs, (), n).to(dev)
        calls += [
            (rns.rns_intt_mac, rns.rns_intt_mac_ref, ([x], [x], plan)),
            (rns.rns_intt_mac, rns.rns_intt_mac_ref, ([x, x], [key, key], plan, [key, x[0]])),
        ]
    x = _rns_residues(rng, qs, (2,), 1 << 13).to(dev)
    for src in (qs, qs[:5]):
        for add in (None, tuple(q // 2 for q in src)):
            calls.append((rns.base_convert, rns.base_convert_ref, (x[:, : len(src)], src, _rns_primes(3, 12), add)))
    for fn, _, args in calls:
        fn(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [fn(*args) for fn, _, args in calls]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for y, (_, ref, args) in zip(got, calls):
        _same(y, ref(*args).cpu())


@pytest.mark.parametrize("level", [2, 3, 4, 5, 6])
def test_rescale_kernel_on_a_ladder(dev, level):
    """45/55-bit ladder: the dropped limb reduced by Barrett for some kept
    primes and taken raw for others."""
    from learn_fhe_tpu_torch.models.ckks.ckks import CkksParams
    from learn_fhe_tpu_torch.ops import rns

    params = CkksParams(log_n=13, log_qi=55, big_l=6, log_qis=(55, 45, 45, 55, 45, 45), log_ps=(55, 55), dnum=3)
    qs = params.qs[:level]
    x = _rns_residues(np.random.default_rng(level), qs, (16,), 1 << 13)
    for k in range(1, level):
        _same(rns.rescale_k(x.to(dev), qs, k), rns.rescale_k(x, qs, k))


def test_rns_wrappers_refuse_what_the_kernels_do_not_take(dev):
    from learn_fhe_tpu_torch.ops import rns

    qs = _rns_primes(4)
    plan = rns.rns_plan(qs, 1 << 10)
    x = torch.zeros((2, 4, 1 << 10), dtype=torch.int64, device=dev)
    flat = torch.zeros(2 * 4 * 1024 + 1, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError):
        rns.rns_ntt(flat[1:].view(2, 4, 1024), plan)  # off 16-byte alignment
    with pytest.raises(ValueError):
        rns.rns_ntt(x[:, :3], rns.rns_plan(qs[:3], 1 << 10))  # not contiguous
    with pytest.raises(ValueError):
        rns.rns_mac([x], [x[:1]], plan)  # y neither x's shape nor (L, N)
    with pytest.raises(ValueError):
        rns.rescale_finish(x.float(), None, rns.rescale_plan(qs, 1))
    with pytest.raises(ValueError):
        rns.base_convert(x.transpose(0, 1), qs, qs)  # leading axes do not merge
    with pytest.raises(ValueError):  # past the largest ring
        rns.rns_ntt(torch.zeros((2, 4, 1 << 17), dtype=torch.int64, device=dev), rns.rns_plan(_rns_primes(4, 17), 1 << 17))
    eager = rns.rns_plan(_rns_primes(4, 14, 63), 1 << 14)
    x14 = torch.zeros((2, 4, 1 << 14), dtype=torch.int64, device=dev)
    for call in (lambda: rns.rns_ntt(x14, eager), lambda: rns.rns_intt(x14, eager), lambda: rns.rns_intt_mac([x14], [x14], eager)):
        with pytest.raises(ValueError):  # past 2^13 the instances are lazy
            call()


def test_production_ring_kernels(dev):
    """At the production bootstrap's N = 2^16 and primes (`production_config
    (16)`: 30 q-primes of 52-56 bits, 2 p-primes of 59): rns_intt_mac with
    1 and 2 terms (the mul's tensor), 3, and 15 digits with z against a key
    broadcast over the batch (the key switch), the gathered instance with
    one x and with distinct x (neither takes the shared-x instance, which
    stays at 2^13), K-BASECONV 1 -> 29 (mod_raise, b and a stacked) and 2
    -> 30 (a digit's hoist), K-RESCALE at k = 1 and k = 2 (P), and
    K-AUTOMORPH on b and a: equal to their plain versions on the card."""
    from learn_fhe_tpu_torch.models.ckks.production import production_config
    from learn_fhe_tpu_torch.ops import rns

    params = production_config(16).params
    qs, ps, qps, n = params.qs, params.ps, params.qps, params.n
    rng = np.random.default_rng(16)
    on = lambda ts: None if ts is None else [t.to(dev) for t in ts]  # noqa: E731
    plan_q, plan_qp = params.plan(qs), params.plan(qps)
    for plan, basis, terms, with_z, broadcast in [(plan_q, qs, 1, False, False), (plan_q, qs, 2, False, False), (plan_q, qs, 3, True, True), (plan_qp, qps, 15, True, True)]:  # fmt: skip
        _check_intt_mac(dev, plan, *_mac_operands(rng, basis, (1,), n, terms, with_z, broadcast))
    tabs = _perm_tables(rng, n, dev)
    xs, ys, zs = (on(t) for t in _mac_operands(rng, qs, (1,), n, 4, True, True))
    perms = [None, *tabs[2:5]]
    for xk in (xs, [xs[0]] * 4):
        before = rns.rns_intt_mac.shared_launches
        _same(rns.rns_intt_mac(xk, ys, plan_q, zs, perms), rns.rns_intt_mac_ref(xk, ys, plan_q, zs, perms).cpu())
        assert rns.rns_intt_mac.shared_launches == before
    low = _rns_residues(rng, qs[:1], (2,), n).to(dev)
    _same(rns.base_convert(low, qs[:1], qs[1:]), rns.base_convert_ref(low, qs[:1], qs[1:]).cpu())
    digit = _rns_residues(rng, qs[:2], (1,), n).to(dev)
    rest = qs[2:] + ps
    _same(rns.base_convert(digit, qs[:2], rest), rns.base_convert_ref(digit, qs[:2], rest).cpu())
    x = _rns_residues(rng, qs, (2,), n).to(dev)
    _same(rns.rescale_k(x, qs, 1), rns.rescale_finish_ref(x, None, rns.rescale_plan(qs, 1)).cpu())
    xp = _rns_residues(rng, qps, (2,), n).to(dev)
    rp = rns.rescale_plan(qps, len(ps))
    conv = rns.base_convert_ref(xp[..., len(qs) :, :], rp.drop, rp.keep, add=rp.p_half[len(qs) :])
    _same(rns.rescale_k(xp, qps, len(ps)), rns.rescale_finish_ref(xp, conv, rp).cpu())
    for t in (params.pow5(1), params.pow5(1 << 14), -1):
        b, a = rns.automorphism_rns((x[0], x[1]), t, qs)
        _same(b, rns.automorphism_rns_ref(x[0], t, qs).cpu())
        _same(a, rns.automorphism_rns_ref(x[1], t, qs).cpu())


def _perm_tables(rng, n, dev):
    """Index tables of the gathered instances: evaluation-slot permutations
    (`eval_automorphism_perm`, as CKKS's rotations read them) where N >= 4,
    a random permutation and the identity."""
    from learn_fhe_tpu_torch.ops.ntt import eval_automorphism_perm

    tabs = [rng.permutation(n), np.arange(n)]
    if n >= 4:
        tabs += [eval_automorphism_perm(n, pow(5, j, 2 * n)) for j in (1, 3)] + [eval_automorphism_perm(n, 2 * n - 1)]
    return [torch.from_numpy(t.astype(np.int32)).to(dev) for t in tabs]


@pytest.mark.parametrize("log_n", range(1, 17))
@pytest.mark.parametrize("bits", [55, 62, 63])
def test_gathered_mac_at_every_ring(dev, log_n, bits):
    """K-RNS-MAC's gathered instances (rns_mac and rns_intt_mac with perms)
    at every ring N = 2..2^16, lazy at 55 and 62 bits and eager at 63 (past
    2^13 only rns_mac: rns_intt_mac raises there on eager primes), on 1,
    2, 3 and 16 terms, with and without z, with y and z of x's shape or a
    key broadcast over the batch, each term read through a random
    permutation, an evaluation-slot permutation, the identity or no table:
    equal to the plain versions (x[..., perm] then the sum). Each also with
    one x in every term, which `rns_intt_mac` takes to its shared-x
    instance where there is one (lazy, N = 2^13, up to 4 terms)."""
    from learn_fhe_tpu_torch.ops import rns

    n = 1 << log_n
    qs = _rns_primes(3, log_n, bits)
    plan = rns.rns_plan(qs, n)
    rng = np.random.default_rng(log_n * 100 + bits + 7)
    tabs = _perm_tables(rng, n, dev)
    cases = [(1, False, False), (1, True, True), (2, False, True), (2, True, False), (3, True, True), (4, False, True), (4, True, True), (16, False, False), (16, True, True)]  # fmt: skip
    for terms, with_z, broadcast in cases:
        xs, ys, zs = _mac_operands(rng, qs, (2,), n, terms, with_z, broadcast)
        on = lambda ts: None if ts is None else [t.to(dev) for t in ts]  # noqa: E731
        xd, yd, zd = on(xs), on(ys), on(zs)
        perms = [None if k % 4 == 3 else tabs[k % len(tabs)] for k in range(terms)]
        for xk in (xd, [xd[0]] * terms):
            shared = rns._row_instance(xk, plan)
            assert shared == (xk[0] is xk[-1] and log_n == 13 and max(qs) < 1 << 62 and terms <= 4)
            for fn, ref in ((rns.rns_mac, rns.rns_mac_ref), (rns.rns_intt_mac, rns.rns_intt_mac_ref)):
                if fn is rns.rns_intt_mac and log_n > 13 and bits == 63:
                    with pytest.raises(ValueError):
                        fn(xk, yd, plan, zd, perms)
                    continue
                before, gathered, s_before = fn.launches, fn.gather_launches, rns.rns_intt_mac.shared_launches
                _same(fn(xk, yd, plan, zd, perms), ref(xk, yd, plan, zd, perms).cpu())
                assert (fn.launches, fn.gather_launches) == (before + 1, gathered + 1)
                assert rns.rns_intt_mac.shared_launches == s_before + int(shared and fn is rns.rns_intt_mac)


@pytest.mark.parametrize("log_n", [10, 11, 13])
@pytest.mark.parametrize("limbs,lead", _RNS_ROWS)
def test_gathered_mac_at_row_counts(dev, log_n, limbs, lead):
    """The gathered rns_intt_mac on 1, 3, 128 and 513 x rows, the
    bootstrap's shapes among them (a batch of 2 at 46 limbs with z; b's
    sum at 23 limbs with a term read in place), with distinct x and with
    one x (the shared-x instance at N = 2^13)."""
    from learn_fhe_tpu_torch.ops import rns

    n = 1 << log_n
    qs = _rns_primes(limbs, log_n)
    plan = rns.rns_plan(qs, n)
    rng = np.random.default_rng(log_n * 1000 + limbs)
    tabs = _perm_tables(rng, n, dev)
    for terms, with_z in [(1, True), (3, True), (4, False)]:
        xs, ys, zs = (None if t is None else [v.to(dev) for v in t] for t in _mac_operands(rng, qs, lead, n, terms, with_z, True))
        perms = [tabs[k % len(tabs)] if k else None for k in range(terms)]
        for xk in (xs, [xs[0]] * terms):
            before = rns.rns_intt_mac.shared_launches
            _same(rns.rns_intt_mac(xk, ys, plan, zs, perms), rns.rns_intt_mac_ref(xk, ys, plan, zs, perms).cpu())
            assert rns.rns_intt_mac.shared_launches == before + int(log_n == 13 and xk[0] is xk[-1] and terms > 1)  # 1 term: no table
    for limbs2 in (23, 46):
        qs2 = _rns_primes(limbs2, log_n)
        plan2 = rns.rns_plan(qs2, n)
        xs, ys, zs = (None if t is None else [v.to(dev) for v in t] for t in _mac_operands(rng, qs2, (2,), n, 1, True, True))
        _same(rns.rns_mac(xs, ys, plan2, zs, tabs[2:3]), rns.rns_mac_ref(xs, ys, plan2, zs, tabs[2:3]).cpu())


@pytest.mark.parametrize("log_n", range(1, 17))
def test_automorphism_kernel_at_every_ring(dev, log_n):
    """K-AUTOMORPH at every ring N = 2..2^16 for t = 5^j and -1, on one
    tensor and on a pair (b and a in one launch), holding 0 and q - 1 (the
    negation of 0 is 0); a strided input is copied first."""
    from learn_fhe_tpu_torch.ops import rns

    n = 1 << log_n
    qs = _rns_primes(5, log_n, 62)
    rng = np.random.default_rng(log_n + 40)
    x, y = (_rns_residues(rng, qs, (2,), n).to(dev) for _ in range(2))
    x[0, :, : n // 2] = 0
    x[1, -1, -1] = qs[-1] - 1
    for t in (5, 25, pow(5, 11, 2 * n), -1):
        before = rns.automorphism_rns.launches
        _same(rns.automorphism_rns(x, t, qs), rns.automorphism_rns_ref(x, t, qs).cpu())
        b, a = rns.automorphism_rns((x, y), t, qs)
        _same(b, rns.automorphism_rns_ref(x, t, qs).cpu())
        _same(a, rns.automorphism_rns_ref(y, t, qs).cpu())
        assert rns.automorphism_rns.launches == before + 2
    view = x[:, 1:4]
    _same(rns.automorphism_rns(view, -1, qs[1:4]), rns.automorphism_rns_ref(view, -1, qs[1:4]).cpu())


@pytest.mark.parametrize("lq", range(1, 24))
def test_base_convert_at_the_bootstrap_levels(dev, lq):
    """K-BASECONV at the bootstrap's shapes (N = 2^13, a batch of 2): a
    level's lq q-limbs into the 23 p-primes (the hoist), and at lq = 1 the
    bottom limb into the other 22 q-primes (mod_raise, b and a stacked)."""
    from learn_fhe_tpu_torch.ops import rns

    primes = _rns_primes(46)
    qs, ps = primes[:23], primes[23:]
    x = _rns_residues(np.random.default_rng(lq + 300), qs[:lq], (2,), 1 << 13).to(dev)
    _same(rns.base_convert(x, qs[:lq], ps), rns.base_convert_ref(x, qs[:lq], ps).cpu())
    if lq == 1:
        ba = torch.stack([x, x.flip(0)])
        _same(rns.base_convert(ba, qs[:1], qs[1:]), rns.base_convert_ref(ba, qs[:1], qs[1:]).cpu())


def test_ckks_bootstrap_on_card_matches_cpu(dev):
    """The bootstrap at N=16, L=16, r=3 and the default EvalModParams on a
    batch of 2: the card's output equals the plain path's on the CPU, and
    the gathered rns_intt_mac and rns_mac, K-AUTOMORPH, K-BASECONV,
    K-RNS-NTT and K-RESCALE launch on it."""
    from learn_fhe_tpu_torch.models.ckks import bootstrapping as B
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.models.ckks import evalmod as E
    from learn_fhe_tpu_torch.ops import rns

    outs = []
    for device in (dev, "cpu"):
        params = C.CkksParams(log_n=4, log_qi=55, big_l=16)
        rng = np.random.default_rng(17)
        sk = C.sk_gen(params, rng)
        rlk, cjk = C.rlk_gen(params, sk, rng, device), C.cjk_gen(params, sk, rng, device)
        bk = B.key_gen(B.BootstrapParams(params, r=3), sk, rng, device)
        lows = [
            C.to_level(C.sk_encrypt(params, sk, C.encode(params, rng.standard_normal(params.l) * 1e-4, device=device), params.qs, rng), params.qs[:1])
            for _ in range(2)
        ]
        low = C.CkksCiphertext(torch.stack([c.b for c in lows]), torch.stack([c.a for c in lows]), params.qs[:1])
        fns = (rns.rns_intt_mac, rns.rns_mac, rns.automorphism_rns, rns.base_convert, rns.rns_ntt, rns.rescale_finish)
        for fn in fns:
            fn.launches = 0
        rns.rns_intt_mac.gather_launches = rns.rns_mac.gather_launches = 0
        outs.append(E.bootstrap(params, bk, rlk, cjk, low))
        if device is dev:
            torch.cuda.synchronize()
            assert all(fn.launches for fn in fns), {fn.__name__: fn.launches for fn in fns}
            assert rns.rns_intt_mac.gather_launches and rns.rns_mac.gather_launches == rns.rns_mac.launches
    (got, want) = outs
    assert got.qs == want.qs and len(got.qs) >= 2
    _same(got.b, want.b)
    _same(got.a, want.a)


def test_ckks_mul_rotate_on_card_match_cpu(dev):
    """A batch-16 mul, a rotate, a conjugate and two hoisted rotations at
    N=2^10, L=8 on the card equal the plain path's on the CPU; K-RNS-NTT,
    the inverse with its MAC source, K-BASECONV and K-RESCALE launch on the
    mul, the MAC and the inverse alone do not; a rotate launches K-AUTOMORPH
    once (b and a) and no gathered MAC; the hoisted rotations one hoist,
    then per rotation the gathered MAC inside the inverse and K-AUTOMORPH of
    b alone."""
    from learn_fhe_tpu_torch.models.ckks import ckks as C
    from learn_fhe_tpu_torch.ops import rns

    params = C.CkksParams(log_n=10, log_qi=55, big_l=8)
    rng = np.random.default_rng(3)
    sk = C.sk_gen(params, rng)
    rlk = C.rlk_gen(params, sk, rng)
    rtk = C.rtk_gen(params, sk, 3, rng)
    cjk = C.cjk_gen(params, sk, rng)
    ms = [rng.random(params.l) + 1j * rng.random(params.l) for _ in range(32)]
    cts = [C.sk_encrypt(params, sk, C.encode(params, m), params.qs, rng) for m in ms]
    stack = lambda cs: C.CkksCiphertext(torch.stack([c.b for c in cs]), torch.stack([c.a for c in cs]), params.qs)  # noqa: E731
    ct0, ct1 = stack(cts[:16]), stack(cts[16:])
    counted = (rns.rns_ntt, rns.rns_intt_mac, rns.base_convert, rns.rescale_finish)
    for fn in (*counted, rns.rns_intt, rns.rns_mac):
        fn.launches = 0
    out = C.mul(params, rlk, ct0, ct1)
    torch.cuda.synchronize()
    assert all(fn.launches for fn in counted), {fn.__name__: fn.launches for fn in counted}
    assert rns.rns_intt.launches == rns.rns_mac.launches == 0  # the sums are made inside the inverse
    cpu_ct = lambda c: C.CkksCiphertext(c.b.cpu(), c.a.cpu(), c.qs)  # noqa: E731
    cpu_key = lambda k: C.CkksKeySwitchingKey(k.b.cpu(), k.a.cpu(), k.qs)  # noqa: E731
    c0, c1 = cpu_ct(C.CkksCiphertext(ct0.b[0], ct0.a[0], params.qs)), cpu_ct(C.CkksCiphertext(ct1.b[0], ct1.a[0], params.qs))
    want = C.mul(params, cpu_key(rlk), c0, c1)
    _same(out.b[0], want.b)
    _same(out.a[0], want.a)
    # a rotate: K-AUTOMORPH once (b and a), the key switch's hoist
    # (K-BASECONV q -> p, one forward transform), its dot inside the
    # inverse, the rescale by P (K-BASECONV + K-RESCALE); no MAC alone, no
    # gather
    counted = (rns.automorphism_rns, rns.rns_ntt, rns.rns_intt_mac, rns.base_convert, rns.rescale_finish, rns.rns_mac)
    for fn in counted:
        fn.launches = 0
    rns.rns_intt_mac.gather_launches = 0
    got_rot = C.rotate(params, rtk, ct0)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == [1, 1, 1, 2, 1, 0] and rns.rns_intt_mac.gather_launches == 0
    want_rot = C.rotate(params, C.CkksRotKey(cpu_key(rtk.ksk), rtk.j), c0)
    _same(got_rot.a[0], want_rot.a)
    _same(got_rot.b[0], want_rot.b)
    got_conj = C.conjugate(params, cjk, ct0)
    want_conj = C.conjugate(params, cpu_key(cjk), c0)
    _same(got_conj.b[0], want_conj.b)
    # hoisted rotations: one hoist, then per rotation the gathered dot
    # inside the inverse (no permuted copy) and K-AUTOMORPH of b alone
    rtk2 = C.rtk_gen(params, sk, 7, rng)
    for fn in counted:
        fn.launches = 0
    got_h = C.hoisted_rotations(params, (rtk, rtk2), ct0, (3, 7))
    torch.cuda.synchronize()
    assert [fn.launches for fn in counted] == [2, 1, 2, 3, 2, 0] and rns.rns_intt_mac.gather_launches == 2
    want_h = C.hoisted_rotations(params, (C.CkksRotKey(cpu_key(rtk.ksk), 3), C.CkksRotKey(cpu_key(rtk2.ksk), 7)), c0, (3, 7))
    for g, w in zip(got_h, want_h):
        _same(g.b[0], w.b)
        _same(g.a[0], w.a)
    dec = C.decode(params, C.decrypt(params, sk, C.CkksCiphertext(out.b[5], out.a[5], out.qs)), out.qs)
    assert np.max(np.abs(dec - ms[5] * ms[21])) < 2.0**-30


# -- K-BGV-DROP, BGV and the reference-order TFHE path ----------------------------


def _bgv_primes(count: int = 16) -> tuple[int, ...]:
    """count 45-bit primes of one bit length, NTT-friendly up to N = 2^15."""
    from itertools import islice

    from learn_fhe_tpu_torch.utils.primes import two_adic_primes

    return tuple(islice(two_adic_primes(45, 16), count))


@pytest.mark.parametrize("log_n", range(6, 16))
def test_bgv_drop_kernel_at_every_limb_count(dev, log_n):
    """K-BGV-DROP against its plain version at N=2^log_n for every limb count
    L = 2..16 and every k = 1..L-1: on b and a in one launch with the add
    of the kept limbs on b and, where a limb is left for it, one drop after
    the add; and on one tensor alone. The residues hold 0, q/2, q/2 + 1 and
    q - 1."""
    from learn_fhe_tpu_torch.ops import rns

    qs, t, n = _bgv_primes(), 65537, 1 << log_n
    rng = np.random.default_rng(log_n)
    lead = (2,) if log_n < 13 else (1,)

    def residues(basis):
        x = np.stack([rng.integers(0, q, size=(*lead, n), dtype=np.uint64) for q in basis], axis=-2)
        x[0, :, :4] = np.array([[0, q // 2, q // 2 + 1, q - 1] for q in basis])
        return u64_to_torch(x)

    for limbs in range(2, 17):
        basis = qs[:limbs]
        xb, xa = residues(basis), residues(basis)
        for k in range(1, limbs):
            then = int(k < limbs - 1)
            add = residues(basis[: limbs - k])
            before = rns.drop_limbs_t.launches
            got = rns.drop_limbs_t((xb.to(dev), xa.to(dev)), basis, t, k, (add.to(dev), None), then)
            assert rns.drop_limbs_t.launches == before + 1
            _same(got[0], rns.drop_limbs_t_ref(xb, basis, t, k, add, then))
            _same(got[1], rns.drop_limbs_t_ref(xa, basis, t, k, None, then))
            _same(rns.drop_limbs_t(xb.to(dev), basis, t, k), rns.drop_limbs_t_ref(xb, basis, t, k))


def test_bgv_drop_refuses_what_the_kernel_does_not_take(dev):
    from learn_fhe_tpu_torch.ops import rns
    from learn_fhe_tpu_torch.utils.primes import two_adic_primes

    qs, t = _bgv_primes(), 65537
    x = torch.zeros((2, 17, 64), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="limbs"):
        rns.drop_limbs_t(x, qs + (next(two_adic_primes(45, 16)),), t, 1)  # 17 limbs
    mixed = (qs[0], next(two_adic_primes(30, 16)))
    with pytest.raises(ValueError, match="max"):
        rns.drop_limbs_t(x[:, :2].contiguous(), mixed, t, 1)
    with pytest.raises(ValueError, match="aligned"):
        rns.drop_limbs_t(torch.zeros(2 * 4 * 64 + 1, dtype=torch.int64, device=dev)[1:].view(2, 4, 64), qs[:4], t, 1)
    with pytest.raises(ValueError, match="contiguous"):
        rns.drop_limbs_t(x[:, :4], qs[:4], t, 1)


def test_bgv_ops_on_card_match_cpu(dev):
    """BGV at N=2^10 (4 + 4 primes of 45 bits) on a batch of 2: mul, a mul at
    the next level, mod_switch, rotate, conjugate, key_switch at a lower
    level, mul_plain and add_plain on the card equal the plain path's on the
    CPU, and decrypt right; one mul launches K-RNS-NTT, `rns_intt_mac`,
    K-BASECONV and K-BGV-DROP once each but the transforms and sums."""
    from learn_fhe_tpu_torch.models import bgv as G
    from learn_fhe_tpu_torch.ops import rns

    params = G.BgvParams(log_n=10)
    rng = np.random.default_rng(5)
    sk = G.sk_gen(params, rng)
    pk, rlk = G.pk_gen(params, sk, rng, dev), G.rlk_gen(params, sk, rng, dev)
    rtk, cjk = G.rtk_gen(params, sk, 3, rng, dev), G.cjk_gen(params, sk, rng, dev)
    ms = [rng.integers(0, params.t, size=(2, params.n)) for _ in range(3)]

    def encrypt(m):
        cs = [G.pk_encrypt(params, pk, G.encode(params, row, dev), rng) for row in m]
        return G.BgvCiphertext(torch.stack([c.b for c in cs]), torch.stack([c.a for c in cs]), params.qs)

    c0, c1, c2 = (encrypt(m) for m in ms)
    cpu = lambda c: G.BgvCiphertext(c.b.cpu(), c.a.cpu(), c.qs, c.factor)  # noqa: E731
    key = lambda k: G.BgvKeySwitchingKey(k.b.cpu(), k.a.cpu(), k.qs)  # noqa: E731
    for fn in (rns.rns_ntt, rns.rns_intt_mac, rns.base_convert, rns.drop_limbs_t):
        fn.launches = 0
    prod = G.mul(params, rlk, c0, c1)
    torch.cuda.synchronize()
    assert (rns.rns_ntt.launches, rns.rns_intt_mac.launches, rns.base_convert.launches, rns.drop_limbs_t.launches) == (5, 4, 1, 1)
    low = G.mod_switch(params, c2)
    cases = (
        (prod, G.mul(params, key(rlk), cpu(c0), cpu(c1)), ms[0] * ms[1]),
        (G.mul(params, rlk, prod, low), G.mul(params, key(rlk), G.mul(params, key(rlk), cpu(c0), cpu(c1)), G.mod_switch(params, cpu(c2))), ms[0] * ms[1] * ms[2]),
        (low, G.mod_switch(params, cpu(c2)), ms[2]),
        (G.rotate(params, rtk, c0), G.rotate(params, G.BgvRotKey(key(rtk.ksk), rtk.j), cpu(c0)), None),
        (G.conjugate(params, cjk, c0), G.conjugate(params, key(cjk), cpu(c0)), None),
        (G.key_switch(params, rlk, G.mod_switch(params, low)), G.key_switch(params, key(rlk), G.mod_switch(params, G.mod_switch(params, cpu(c2)))), None),
        (G.add_plain(params, ms[1], G.mul_plain(params, ms[0], low)), G.add_plain(params, ms[1], G.mul_plain(params, ms[0], G.mod_switch(params, cpu(c2)))), ms[0] * ms[2] + ms[1]),
    )
    for got, want, m in cases:
        assert got.qs == want.qs and got.factor == want.factor
        _same(got.b, want.b)
        _same(got.a, want.a)
        if m is not None:
            np.testing.assert_array_equal(G.decrypt(params, sk, got), m % params.t)


def test_parity_external_product_and_cmux_on_card_match_cpu(dev):
    """The TGGSW external product and CMux of the reference-order blind
    rotation at N=2048 (k=1, B=2^23, d=1) on the card equal the plain path's
    on the CPU, and launch K-NTT, intt32 and K-GARNER."""
    from learn_fhe_tpu_torch.models.tfhe import tglwe

    gg = tfhe.TggswParams(tfhe.TglweParams(log_p=4, padding=1, big_n=2048, k=1, std_dev=2.845267479601915e-15), log_b=23, d=1)
    rng = np.random.default_rng(11)
    sk = tglwe.sk_gen(gg.tglwe, rng)
    bits = np.zeros((2, 2048), dtype=np.uint64)
    bits[1, 0] = 1
    key = tggsw.to_eval(gg, tggsw.sk_encrypt(gg, sk, u64_to_torch(bits), rng))
    acc = [TglweCiphertext(u64_to_torch(rng.integers(0, 1 << 64, size=(1, 2048), dtype=np.uint64)),
                           u64_to_torch(rng.integers(0, 1 << 64, size=2048, dtype=np.uint64))) for _ in range(2)]  # fmt: skip
    on = lambda c: TglweCiphertext(c.a.to(dev), c.b.to(dev))  # noqa: E731
    for fn in (tntt.ntt32, tntt.intt32, tcrt.garner_to_u64):
        fn.launches = 0
    for i in range(2):
        key_i = tggsw.TggswEval(*(x[i] for x in key))
        key_d = tggsw.TggswEval(*(x[i].to(dev) for x in key))
        for got, want in (
            (tggsw.external_product(gg, key_d, on(acc[0])), tggsw.external_product(gg, key_i, acc[0])),
            (tggsw.cmux(gg, key_d, on(acc[0]), on(acc[1])), tggsw.cmux(gg, key_i, acc[0], acc[1])),
        ):
            _same(got.a, want.a)
            _same(got.b, want.b)
    assert tntt.ntt32.launches and tntt.intt32.launches and tcrt.garner_to_u64.launches
