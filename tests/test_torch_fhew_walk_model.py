"""A model of K-FHEW-BR's index math (`learn_fhe_tpu_torch/csrc/
fhew_blind_rotate.cu`), held bit for bit against the JAX package on the CPU.

The kernel runs only on a CUDA device, so the CPU tests model its layout
in torch: the swizzled 2-row accumulator and digit buffer, pass 0 of the
forward NTT making its digits (in closed form) from acc or from the
gathered a, the
passes of up to 3 layers between them, the contraction with its V values
per access and its u64 sums of `chunk` rows each reduced, the inverse
passes in place on acc with the gathered b added in the last. Plain int64
arithmetic mod q stands in for the Shoup butterflies (both are exact); the
contraction's reduction is the kernel's own, on u64 bit patterns carried in
int64. Also here: the host's choice of that reduction, and the host check
of a schedule's indices.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import learn_fhe_tpu.models.fhew as jfhew  # noqa: E402
from learn_fhe_tpu.models.fhew import rgsw as jrgsw  # noqa: E402
from learn_fhe_tpu.models.fhew import rlwe as jrlwe  # noqa: E402
from learn_fhe_tpu.utils.primes import two_adic_primes  # noqa: E402
import learn_fhe_tpu_torch.models.fhew as fhew  # noqa: E402
from learn_fhe_tpu_torch.models.fhew import bootstrapping as boot  # noqa: E402
from learn_fhe_tpu_torch.ops.poly import automorphism_map  # noqa: E402
from tests.test_torch_ntt32 import _fwd_radix, _inv_radix, _pass_twiddles, _pass_widths, _swizzle  # noqa: E402

M32 = (1 << 32) - 1
THREADS = 512  # the kernel's block: the contraction's V keeps 2N / V >= 512 items where N allows


def _umulhi(a: torch.Tensor, b: int) -> torch.Tensor:
    """__umulhi of u32 values held in int64, without a 64-bit overflow."""
    return ((a >> 16) * b + (((a & 0xFFFF) * b) >> 16)) >> 16


def _mul_shoup(a: torch.Tensor, w: int, w_shoup: int, q: int) -> torch.Tensor:
    r = (a * w - _umulhi(a, w_shoup) * q) & M32
    return torch.where(r >= q, r - q, r)


def _reduce64(s: torch.Tensor, q: int) -> torch.Tensor:
    """The kernel's reduce64 on u64 bit patterns in int64: hi * (2^32 mod
    q) + lo, each by a Shoup product."""
    r32 = (1 << 32) % q
    hi, lo = (s >> 32) & M32, s & M32
    t = _mul_shoup(hi, r32, (r32 << 32) // q, q) + _mul_shoup(lo, 1, (1 << 32) // q, q)
    return torch.where(t >= q, t - q, t)


def _digit(x: torch.Tensor, g, i: int, q: int) -> torch.Tensor:
    """zq_digit: digit i of residues x in closed form, field i of the
    centered lift plus `off` at every digit, less off (u32 lanes)."""
    if g.rounding_bits:
        s = x + (((1 << g.rounding_bits) >> 1) % q)
        x = torch.where(s >= q, s - q, s) >> g.rounding_bits
    v = torch.where(x < (q >> 1), x, x - q) & M32
    off = (1 << (g.log_b - 1)) - 1 if g.log_b >= 2 else 1
    offsets = sum(off << (k * g.log_b) for k in range(g.d))
    field = (((v + offsets) & M32) >> (i * g.log_b)) & ((1 << g.log_b) - 1)
    return (field - off) % q


def _buffer(rows: int, log_n: int, batch: int) -> torch.Tensor:
    values = -(-(rows << log_n) // 32) * 32
    return torch.full((batch, values), -1, dtype=torch.int64)


def _forward(buf: torch.Tensor, rows: int, plan, first) -> None:
    """The forward passes over `rows` digit rows: pass 0's items take their
    values from first(row, j) (the digits, made in registers), the later
    passes from the swizzled buffer."""
    log_n, q = plan.log_n, plan.q
    psi = torch.from_numpy(plan.psi_br.astype(np.int64))
    for p, w in enumerate(_pass_widths(log_n)):
        l0 = 3 * p
        log_h, log_items = log_n - l0 - w, log_n - w
        t = torch.arange(rows << log_items)
        row, i = t >> log_items, t & ((1 << log_items) - 1)
        hi = i >> log_h
        base = (row << log_n) + (hi << (log_n - l0)) + (i & ((1 << log_h) - 1))
        idx = base[:, None] + (torch.arange(1 << w) << log_h)  # (items, 2^w)
        if p == 0:
            x = torch.stack([first(int(r), idx[row == r] - (r << log_n)) for r in range(rows)], 1).flatten(1, 2)
        else:
            x = buf[:, _swizzle(idx)]
        _fwd_radix(x, _pass_twiddles(psi, l0, w, hi), q)
        buf[:, _swizzle(idx)] = x


def _contract(buf, acc, rows, ka, kb, plan, chunk) -> None:
    """Items (o, j): V neighbouring coefficients of output o (acc's a, then
    b), summed over `chunk` rows at a time in u64, each sum reduced and
    added mod q; written to row o of acc."""
    n, log_n, q = plan.n, plan.log_n, plan.q
    v = min(4, max(1, n // (THREADS // 2)))
    cols = n // v
    assert 2 * cols >= min(THREADS, 2 * n), "an item for every thread where N allows"
    t = torch.arange(2 * cols)
    o = (t >= cols).long()
    j = ((t - o * cols) * v)[:, None] + torch.arange(v)  # (items, V)
    out = torch.zeros(buf.shape[0], *j.shape, dtype=torch.int64)
    for r0 in range(0, rows, chunk):
        s = torch.zeros_like(out)
        for r in range(r0, min(rows, r0 + chunk)):
            x = buf[:, _swizzle((r << log_n) + j)]
            y = torch.where((o == 0)[None, :, None], ka[:, r][:, j], kb[:, r][:, j])
            s = s + x * y  # int64 sums wrap as u64 sums do
        out = (out + _reduce64(s, q)) % q
    acc[:, _swizzle((o[:, None] << log_n) + j)] = out


def _inverse(acc, plan, gb=None) -> None:
    """The inverse passes in place on acc's two rows; the last scales by
    1/N and adds gb to row 1 when given."""
    log_n, q = plan.log_n, plan.q
    psi_inv = torch.from_numpy(plan.psi_inv_br.astype(np.int64))
    widths = _pass_widths(log_n)
    for p in reversed(range(len(widths))):
        l0, w = 3 * p, widths[p]
        log_h, log_items = log_n - l0 - w, log_n - w
        t = torch.arange(2 << log_items)
        row, i = t >> log_items, t & ((1 << log_items) - 1)
        hi = i >> log_h
        col = (hi << (log_n - l0)) + (i & ((1 << log_h) - 1))
        idx = ((row << log_n) + col)[:, None] + (torch.arange(1 << w) << log_h)
        x = acc[:, _swizzle(idx)]
        _inv_radix(x, _pass_twiddles(psi_inv, l0, w, hi), q)
        if p == 0:
            x = x * plan.n_inv % q
            if gb is not None:
                cj = col[:, None] + (torch.arange(1 << w) << log_h)
                add = torch.where((row == 1)[None, :, None], gb[:, cj], 0)
                x = (x + add) % q
        acc[:, _swizzle(idx)] = x


def _load_acc(a: np.ndarray, b: np.ndarray, log_n: int) -> torch.Tensor:
    n = 1 << log_n
    acc = _buffer(2, log_n, a.shape[0])
    acc[:, _swizzle(torch.arange(2 * n))] = torch.from_numpy(np.concatenate([a, b], 1).astype(np.int64))
    return acc


def _read_acc(acc: torch.Tensor, log_n: int) -> np.ndarray:
    n = 1 << log_n
    out = acc[:, _swizzle(torch.arange(2 * n))]
    assert (out >= 0).all()
    return out.reshape(-1, 2, n).numpy().astype(np.uint64)


def model_external_product(params, a, b, ka, kb, chunk):
    """One external product as the kernel runs it: rows 0..d-1 the digits of
    acc's a, d..2d-1 those of b; returns (B, 2, N) u64."""
    g, plan = params.rgsw.gadget, params.rlwe.plan32
    log_n, rows = plan.log_n, 2 * g.d
    acc, buf = _load_acc(a, b, log_n), _buffer(rows, log_n, a.shape[0])

    def first(row, j):
        src = 1 if row >= g.d else 0
        return _digit(acc[:, _swizzle((src << log_n) + j)], g, row - src * g.d, plan.q)

    _forward(buf, rows, plan, first)
    _contract(buf, acc, rows, ka, kb, plan, chunk)
    _inverse(acc, plan)
    return _read_acc(acc, log_n)


def model_automorphism(params, a, b, t, ka, kb, chunk):
    """One automorphism X -> X^t with its key switch as the kernel runs it:
    the gathered a's digits in pass 0, the gathered b added in the last
    inverse pass; returns (B, 2, N) u64."""
    g, plan = params.rlwe.gadget, params.rlwe.plan32
    log_n, q, n = plan.log_n, plan.q, plan.n
    src, sign = (torch.from_numpy(m) for m in automorphism_map(n, t))
    acc, buf = _load_acc(a, b, log_n), _buffer(g.d, log_n, a.shape[0])

    def gathered(row_off, j):
        v = acc[:, _swizzle(row_off + src[j])]
        return torch.where(sign[j] & (v != 0), q - v, v)

    gb = gathered(n, torch.arange(n))
    _forward(buf, g.d, plan, lambda row, j: _digit(gathered(0, j), g, row, q))
    _contract(buf, acc, g.d, ka, kb, plan, chunk)
    _inverse(acc, plan, gb)
    return _read_acc(acc, log_n)


def _params(mod, q, log_n, log_b, d):
    return mod.BootstrapParams(
        mod.RgswParams(mod.RlweParams(q=q, p=4, log_n=log_n, log_b=log_b, d=d), log_b=log_b, d=d),
        mod.LweParams(q=1 << 16, p=4, n=8, log_b=4, d=4),
        w=3,
    )


def _inputs(rng, q, batch, rows, n):
    a = rng.integers(0, q, size=(batch, n), dtype=np.uint64)
    b = rng.integers(0, q, size=(batch, n), dtype=np.uint64)
    a[0, :3], b[0, -2:] = [0, 1, q - 1], [q - 1, 0]
    key = [rng.integers(0, q, size=(batch, rows, n), dtype=np.uint64) for _ in "ab"]
    key[0][0, 0, :2] = q - 1
    return a, b, key


def _dual(k: np.ndarray, q: int) -> np.ndarray:
    return ((k << np.uint64(32)) // np.uint64(q)).astype(np.uint32)


# The reference fixture's gadget at every N = 8..512 with a 28-bit prime,
# where one u64 sum takes every row, and the largest digit-row count the
# kernel takes (2d = 16) at a 31-bit prime, where a sum takes 4 rows.
CASES = [(28, log_n, 7, 4) for log_n in range(3, 10)] + [(31, 7, 3, 8)]


@pytest.mark.parametrize("bits,log_n,log_b,d", CASES)
def test_walk_model_matches_jax(bits, log_n, log_b, d):
    """The model's external product and automorphism (X -> X^-g and X^g),
    bit for bit against the JAX package's `rgsw.external_product` and
    `rlwe.automorphism` (u32 branch), with the chunk the host picks and
    with a reduction after every row."""
    q = next(two_adic_primes(bits, log_n + 1))
    params, jparams = _params(fhew, q, log_n, log_b, d), _params(jfhew, q, log_n, log_b, d)
    n, rows = 1 << log_n, max(2 * d, d)
    chunk = boot.contraction_chunk(q, rows)
    assert chunk == (rows if bits == 28 else 4)
    rng = np.random.default_rng(log_n * 100 + bits)
    a, b, (ka, kb) = _inputs(rng, q, 2, 2 * d, n)
    ct = jrlwe.RlweCiphertext(jnp.asarray(a), jnp.asarray(b))
    want = []
    for i in range(2):
        key = jrgsw.RgswEval(*(jnp.asarray(k[i].astype(np.uint32)) for k in (ka, kb)), *(jnp.asarray(_dual(k[i], q)) for k in (ka, kb)))
        out = jax.jit(jrgsw.external_product, static_argnums=0)(jparams.rgsw, key, jrlwe.RlweCiphertext(ct.a[i], ct.b[i]))
        want.append(np.stack([np.asarray(out.a), np.asarray(out.b)]))
    ka_t, kb_t = (torch.from_numpy(k.astype(np.int64)) for k in (ka, kb))
    for c in {chunk, 1}:
        np.testing.assert_array_equal(model_external_product(params, a, b, ka_t, kb_t, c), np.stack(want))
    for t in params.ak_t[:2]:
        ks = [k[:, :d] for k in (ka, kb)]
        want = []
        for i in range(2):
            ksk = jrlwe.RlweKeySwitchingKey(*(jnp.asarray(k[i].astype(np.uint32)) for k in ks), *(jnp.asarray(_dual(k[i], q)) for k in ks))
            out = jrlwe.automorphism(jparams.rlwe, jrlwe.RlweAutoKey(t, ksk), jrlwe.RlweCiphertext(ct.a[i], ct.b[i]))
            want.append(np.stack([np.asarray(out.a), np.asarray(out.b)]))
        for c in {min(chunk, d), 1}:
            got = model_automorphism(params, a, b, t, *(torch.from_numpy(k.astype(np.int64)) for k in ks), c)
            np.testing.assert_array_equal(got, np.stack(want))


@pytest.mark.parametrize("rows", range(1, boot.FHEW_MAX_ROWS + 1))
def test_lazy_sum_bound_picks_per_row_path_where_it_must(rows):
    """Over every q < 2^31 the wrapper takes, contraction_chunk(q, rows) is
    the most rows whose u64 sum of the worst products, (q-1)^2 each, cannot
    overflow: all `rows` up to the largest q with rows * (q-1)^2 < 2^64,
    fewer above it, and one (a reduction after every row) only where two
    products would already overflow, which no q < 2^31 reaches. Each chunk's
    sum, reduced and added mod q, is exact."""
    top = math.isqrt(((1 << 64) - 1) // rows) + 1  # the largest q with rows * (q-1)^2 < 2^64
    assert rows * (top - 1) ** 2 < 1 << 64 <= rows * top**2
    for q in (3, 268409857, top - 1, top, top + 1, top + 2, (1 << 31) - 1):
        if q >= 1 << 31:
            continue
        chunk = boot.contraction_chunk(q, rows)
        assert 1 <= chunk <= rows and (chunk == rows) == (q <= top)
        assert chunk * (q - 1) ** 2 < 1 << 64
        assert chunk == rows or (chunk + 1) * (q - 1) ** 2 >= 1 << 64
        worst = torch.full((rows,), q - 1, dtype=torch.int64)
        got = 0
        for r0 in range(0, rows, chunk):
            got = (got + int(_reduce64((worst[r0 : r0 + chunk] ** 2).sum(), q))) % q
        assert got == rows * (q - 1) ** 2 % q
    assert boot.contraction_chunk(268409857, 8) == 8  # the reference fixture reduces once
    assert [boot.contraction_chunk((1 << 31) - 1, r) for r in (1, 4, 5, 16)] == [1, 4, 4, 4]


@pytest.mark.parametrize("bits", [28, 31])
def test_closed_form_digits_match_jax(bits):
    """The kernel's closed-form digit (no walk over the digits below it)
    equals the JAX package's decompose_zq32 for every gadget the u32 engine
    takes, B = 2 included, on random residues and the edges."""
    from learn_fhe_tpu.ops import gadget as jgadget
    from learn_fhe_tpu_torch.ops.gadget import Gadget

    q = next(two_adic_primes(bits, 10))
    rng = np.random.default_rng(bits)
    x = rng.integers(0, q, size=2048, dtype=np.uint64)
    x[:6] = [0, 1, q - 1, q // 2, q // 2 + 1, q // 2 - 1]
    for log_b in range(1, 12):
        for d in range(1, 31 // log_b + 1):
            g = Gadget(q, log_b, d)
            want = np.asarray(jgadget.decompose_zq32(jnp.asarray(x), jgadget.Gadget(q, log_b, d)))
            got = np.stack([_digit(torch.from_numpy(x.astype(np.int64)), g, i, q).numpy() for i in range(d)])
            np.testing.assert_array_equal(got, want.astype(np.int64), err_msg=f"log_b={log_b}, d={d}")


def test_reduce64_is_exact_for_any_u64():
    """reduce64 (hi * (2^32 mod q) + lo by two Shoup products) gives s mod
    q for s anywhere in [0, 2^64), at primes up to 2^31."""
    rng = np.random.default_rng(9)
    s = rng.integers(0, 1 << 64, size=4096, dtype=np.uint64)
    s[:3] = [0, (1 << 64) - 1, 1 << 63]
    for q in (12289, 268409857, (1 << 31) - 1):
        got = _reduce64(torch.from_numpy(s.view(np.int64)), q).numpy()
        np.testing.assert_array_equal(got, (s % np.uint64(q)).astype(np.int64))


def test_schedule_host_check_rejects_out_of_range():
    """check_schedule (run where the C schedule is built, and on the CPU
    path) refuses an index outside the key, and schedule_native a mask
    outside Z_2N before it reaches the C code."""
    params = _params(fhew, next(two_adic_primes(28, 8)), 7, 7, 4)
    n, w = params.lwe_s.n, params.w
    e = np.array([[0, n - 1, -1], [3, -1, -1]], dtype=np.int32)
    a = np.array([[-1, 0, w], [w, -1, -1]], dtype=np.int32)
    boot.check_schedule(params, e, a)
    for bad_e, bad_a in ((n, 0), (-2, 0), (0, w + 1), (0, -2)):
        e2, a2 = e.copy(), a.copy()
        e2[1, 1], a2[1, 1] = bad_e, bad_a
        with pytest.raises(ValueError, match="out of range"):
            boot.check_schedule(params, e2, a2)
    mask = 2 * np.ones((2, n), dtype=np.int64) + 1
    for v in (-1, params.q):
        mask[1, 2] = v
        with pytest.raises(ValueError, match="Z_"):
            boot.schedule_native(params, mask)
    got = boot.schedule(params, torch.from_numpy(mask.clip(0, params.q - 1) | 1))
    boot.check_schedule(params, *(x.numpy() for x in got))
