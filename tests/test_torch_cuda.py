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
