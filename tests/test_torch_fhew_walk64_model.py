"""A model of K-FHEW-BR64's arithmetic (`learn_fhe_tpu_torch/csrc/u64.cuh`,
`fhew_u64.cu`), held bit for bit against the JAX package on the CPU.

The kernel runs only on a CUDA device, so the CPU tests model in torch, on
u64 bit patterns carried in int64, what it computes: Harvey's lazy forward
and inverse butterflies with their [0, 4q) and [0, 2q) ranges (checked at
every layer), the one canonicalisation at the end of each transform, and a
phase split over the C blocks of a cluster: each block's share of the digit
rows, their 128-bit sums against the key rows, one REDC per block, the
partial residues added mod q a slice per block and written into every
block's acc, and the inverse NTTs that every block runs on its own copy.
Also here: the host's choice of the cluster size from the batch and the
rows, and the q < 2^62 gate of the lazy instance.
"""

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
from learn_fhe_tpu_torch.ops.gadget import decompose_zq  # noqa: E402
from learn_fhe_tpu_torch.ops.modular import as_i64, mulhi64  # noqa: E402
from learn_fhe_tpu_torch.ops.ntt import intt64_ref, lazy_butterflies, ntt64_ref, ntt_plan, plan_tables  # noqa: E402
from learn_fhe_tpu_torch.ops.poly import automorphism_map  # noqa: E402

SIGN = -(1 << 63)
CPU = torch.device("cpu")


def _ult(a, b) -> torch.Tensor:
    """a < b as u64 on int64 bit patterns."""
    return (a ^ SIGN) < (torch.as_tensor(b, dtype=torch.int64) ^ SIGN)


def _csub(s: torch.Tensor, m: int) -> torch.Tensor:
    """min(s, s - m) as u64: s mod m for s < 2m."""
    t = s - as_i64(m)
    return torch.where(_ult(t, s), t, s)


def _shoup_lazy(a, w, ws, q: int) -> torch.Tensor:
    """a w - floor(a ws / 2^64) q, in [0, 2q), with no last subtract."""
    return a * w - mulhi64(a, ws) * q


def _below(x: torch.Tensor, bound: int) -> bool:
    return bool(_ult(x, as_i64(bound)).all())


def lazy_ntt(x: torch.Tensor, plan) -> torch.Tensor:
    """The kernel's forward passes, layer by layer (a pass of W layers runs
    the same butterflies in the same order): x0 into [0, 2q), x1 w lazy,
    both outputs below 4q; canonical after the last layer."""
    n, q, t = plan.n, plan.q, plan_tables(plan, CPU)
    batch, out = x.shape[:-1], x
    for layer in range(plan.log_n):
        m = 1 << layer
        x4 = out.reshape(*batch, m, 2, n >> (layer + 1))
        u = _csub(x4[..., 0, :], 2 * q)
        v = _shoup_lazy(x4[..., 1, :], t.psi[m : 2 * m, None], t.psi_s[m : 2 * m, None], q)
        out = torch.stack([u + v, u - v + 2 * q], dim=-2).reshape(*batch, n)
        assert _below(out, 4 * q), "a forward value left [0, 4q)"
    return _csub(_csub(out, 2 * q), q)


def lazy_intt(x: torch.Tensor, plan) -> torch.Tensor:
    """The kernel's inverse passes: x0 + x1 brought below 2q, (x0 - x1 + 2q)
    w lazy below 2q; the 1/N scale makes the values canonical."""
    n, q, t = plan.n, plan.q, plan_tables(plan, CPU)
    batch, out = x.shape[:-1], x
    assert _below(out, 2 * q)
    for layer in reversed(range(plan.log_n)):
        m = 1 << layer
        x4 = out.reshape(*batch, m, 2, n >> (layer + 1))
        u, v = x4[..., 0, :], x4[..., 1, :]
        d = _shoup_lazy(u - v + 2 * q, t.psi_inv[m : 2 * m, None], t.psi_inv_s[m : 2 * m, None], q)
        out = torch.stack([_csub(u + v, 2 * q), d], dim=-2).reshape(*batch, n)
        assert _below(out, 2 * q), "an inverse value left [0, 2q)"
    return _csub(_shoup_lazy(out, plan.n_inv, as_i64(plan.n_inv_shoup), q), q)


def _mac128(hi, lo, a, b):
    p = a * b
    lo = lo + p
    return hi + mulhi64(a, b) + _ult(lo, p).long(), lo


def _redc(hi, lo, plan) -> torch.Tensor:
    q = plan.q
    k = lo * as_i64(plan.zq.neg_q_inv)
    return _csub(hi + mulhi64(k, q) + (lo != 0).long(), q)


def model_phase(digits, ka, kb, plan, cluster, gb=None):
    """One phase on a cluster of `cluster` blocks: digits (B, R, N) residues,
    key rows ka, kb (R, N); block c takes rows [c R / C, (c+1) R / C). Each
    block's forward NTTs and 128-bit contraction, its REDC into a partial
    residue (a then b, 2N values); block c adds slice c of the 2N
    coefficients over every block's partials mod q and writes the sums
    into every block's acc; each block runs the two inverse NTTs on its own
    acc (b += gb after the scale where gb is given). All blocks must end
    with the same acc, which is returned as (a, b)."""
    q, rows = plan.q, digits.shape[1]
    parts = []
    for c in range(cluster):
        first, last = c * rows // cluster, (c + 1) * rows // cluster
        assert (last - first) * (q - 1) ** 2 < q << 64  # each block's REDC bound
        ev = lazy_ntt(digits[:, first:last], plan)
        zero = torch.zeros_like(digits[:, 0])
        sums = [[zero, zero], [zero, zero]]
        for r in range(last - first):
            for o, key in enumerate((ka, kb)):
                sums[o] = list(_mac128(*sums[o], ev[:, r], key[first + r]))
        parts.append([_redc(*sums[o], plan) for o in range(2)])
    n = digits.shape[-1]
    accs = [torch.full((digits.shape[0], 2 * n), -1, dtype=torch.int64) for _ in range(cluster)]
    for c in range(cluster):  # block c adds slice c of the 2N sums and writes it into every acc
        cols = slice(c * 2 * n // cluster, (c + 1) * 2 * n // cluster)
        s = torch.zeros_like(accs[0][:, cols])
        for part in parts:
            s = _csub(s + torch.cat(part, dim=-1)[:, cols], q)
        for acc in accs:
            acc[:, cols] = s
    outs = []
    for acc in accs:  # every block runs both inverse NTTs on its own acc
        assert (acc >= 0).all(), "a coefficient no block summed"
        a, b = lazy_intt(acc[:, :n], plan), lazy_intt(acc[:, n:], plan)
        outs.append([a, b if gb is None else _csub(b + gb, q)])
    for other in outs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(outs[0], other))
    return outs[0]


def model_external_product(params, a, b, ka, kb, cluster):
    g, plan = params.rgsw.gadget, params.rlwe.plan
    digits = torch.cat([decompose_zq(a, g), decompose_zq(b, g)]).movedim(0, 1)  # (B, 2d, N)
    return model_phase(digits, ka, kb, plan, cluster)


def model_automorphism(params, a, b, t, ka, kb, cluster):
    g, plan, q = params.rlwe.gadget, params.rlwe.plan, params.big_q
    src, sign = (torch.from_numpy(m) for m in automorphism_map(params.n, t))

    def gathered(x):
        v = x[:, src]
        return torch.where(sign & (v != 0), q - v, v)

    digits = decompose_zq(gathered(a), g).movedim(0, 1)  # (B, d, N)
    return model_phase(digits, ka, kb, plan, cluster, gb=gathered(b))


def _params(mod, q, log_n, log_b, d):
    return mod.BootstrapParams(
        mod.RgswParams(mod.RlweParams(q=q, p=4, log_n=log_n, log_b=log_b, d=d), log_b=log_b, d=d),
        mod.LweParams(q=1 << 16, p=4, n=8, log_b=4, d=4),
        w=3,
    )


# The multi-key test fixture of chip_smoke.py M3 (54-bit q, N = 128, B = 2^6,
# d = 9: 2d = 18) and the full set's 55-bit prime and gadget (B = 2^11, d =
# 5: 2d = 10) at N = 256.
CASES = {"mk54": (54, 8, 7, 6, 9), "full-prime": (55, 12, 8, 11, 5)}


@pytest.mark.parametrize("case", list(CASES))
def test_walk64_model_matches_jax(case):
    """The model's external product and automorphism (X -> X^t with its key
    switch) at cluster sizes 1, 2, 3, 5 and the cap, bit for bit against
    the JAX package's u64 `rgsw.external_product` and `rlwe.automorphism`,
    one compile each."""
    bits, two_adic, log_n, log_b, d = CASES[case]
    q = next(two_adic_primes(bits, two_adic))
    assert lazy_butterflies(q)
    params, jparams = _params(fhew, q, log_n, log_b, d), _params(jfhew, q, log_n, log_b, d)
    n = 1 << log_n
    rng = np.random.default_rng(bits)
    a = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    b = rng.integers(0, q, size=(2, n), dtype=np.uint64)
    a[0, :3], b[0, -2:] = [0, 1, q - 1], [q - 1, 0]
    ka, kb = (rng.integers(0, q, size=(2 * d, n), dtype=np.uint64) for _ in "ab")
    ka[0, :2] = q - 1
    ct = jrlwe.RlweCiphertext(jnp.asarray(a), jnp.asarray(b))
    ext = jax.jit(jrgsw.external_product, static_argnums=0)(jparams.rgsw, jrgsw.RgswEval(jnp.asarray(ka), jnp.asarray(kb)), ct)
    t = params.ak_t[1]
    ksk = jrlwe.RlweKeySwitchingKey(jnp.asarray(ka[:d]), jnp.asarray(kb[:d]))
    auto = jax.jit(lambda k, c: jrlwe._automorphism_core(jparams.rlwe, t, k, c))(ksk, ct)
    ta, tb, tka, tkb = (torch.from_numpy(x.view(np.int64)) for x in (a, b, ka, kb))
    for cluster in sorted({1, 2, 3, 5, min(boot.WALK64_MAX_CLUSTER, 2 * d, d)}):
        got = model_external_product(params, ta, tb, tka, tkb, cluster)
        np.testing.assert_array_equal(torch.stack(got).numpy().view(np.uint64), np.stack([ext.a, ext.b]), err_msg=f"C={cluster}")
        got = model_automorphism(params, ta, tb, t, tka[:d], tkb[:d], cluster)
        np.testing.assert_array_equal(torch.stack(got).numpy().view(np.uint64), np.stack([auto.a, auto.b]), err_msg=f"C={cluster}")


@pytest.mark.parametrize("bits", [54, 55, 62])
def test_lazy_transforms_match_the_plain_ntt(bits):
    """The lazy transforms hold their ranges and give the plain radix-2
    transforms' residues at the multi-key primes and at the largest
    two-adic prime below 2^62, the top of the lazy instance's range, on
    random rows and the edge values."""
    q = next(two_adic_primes(bits, 9))
    assert lazy_butterflies(q) and 4 * q < 1 << 64
    plan = ntt_plan(q, 256)
    rng = np.random.default_rng(bits)
    x = rng.integers(0, q, size=(4, 256), dtype=np.uint64)
    x[0] = q - 1
    x[1, ::2] = 0
    tx = torch.from_numpy(x.view(np.int64))
    assert torch.equal(lazy_ntt(tx, plan), ntt64_ref(tx, plan))
    assert torch.equal(lazy_intt(tx, plan), intt64_ref(tx, plan))
    assert torch.equal(lazy_intt(lazy_ntt(tx, plan), plan), tx)


@pytest.mark.parametrize("q", [3, (1 << 62) - 57, 1 << 62, (1 << 62) + 135, next(two_adic_primes(63, 8))])
def test_lazy_instance_only_below_2_62(q):
    """The wrappers ask for the lazy instance exactly where its ranges fit
    in a u64 (4q < 2^64, so q < 2^62); every prime in [2^62, 2^63), which
    the JAX package's u64 engine takes, runs on the eager instance."""
    assert lazy_butterflies(q) == (4 * q < 1 << 64) == (q < 1 << 62)


# (batch, rows_g, rows_k, the cluster size picked) under a table of resident
# clusters like an H100's: fewer clusters the larger they are, and fewer than
# 132 / C (a cluster's blocks share one GPC).
_RESIDENT = {2: 66, 3: 44, 4: 32, 5: 24, 6: 20, 7: 16, 8: 16}
_CHOICES = [
    (1, 10, 5, 5), (2, 10, 5, 5), (24, 10, 5, 5), (25, 10, 5, 4), (32, 10, 5, 4), (33, 10, 5, 3), (44, 10, 5, 3),
    (45, 10, 5, 2), (66, 10, 5, 2), (67, 10, 5, 1), (128, 10, 5, 1), (1024, 10, 5, 1),
    (1, 18, 9, 8), (16, 18, 9, 8), (17, 18, 9, 6), (128, 18, 9, 1), (1, 2, 1, 1), (1, 4, 3, 3),
]


@pytest.mark.parametrize("batch,rows_g,rows_k,want", _CHOICES)
def test_cluster_size_from_batch_and_rows(batch, rows_g, rows_k, want):
    """walk64_cluster_size: the largest C up to min(8, rows_g, rows_k) at
    which all of the batch's clusters are resident at once, else 1 (a batch
    of 128 at the full set, 2d = 10, d = 5, takes one block each)."""
    asked = []

    def resident(c):
        asked.append(c)
        return _RESIDENT[c]

    assert boot.walk64_cluster_size(batch, rows_g, rows_k, resident) == want
    assert all(2 <= c <= min(boot.WALK64_MAX_CLUSTER, rows_g, rows_k) for c in asked)
