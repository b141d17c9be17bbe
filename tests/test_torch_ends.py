"""Port vs JAX: the two ends of the bootstrap paths that run as one launch
each on the card, held bit for bit against the JAX package on the CPU.

- `blind_rotate_front_ref` (K-TFHE-PRE's plain version): the mod switch to
  Z_2N, the zero accumulator and its rotation by (-b) mod 2N, the exponents
  transposed, against `mod_switch_2n` and `jax.vmap(tglwe.rotate)`, as the
  JAX package's `blind_rotate` composes them.
- `sample_extract_ref` (K-EXTRACT's plain version): the extract of
  coefficient i with b_add added to b mod Q, against `rlwe.sample_extract`
  and `add_mod`.

No key is made: the inputs are random words from a numpy seed, with the
edge values (exponents 0, N, 2N - 1 and 2N; words near 2^64 - 1, whose
rounding add wraps; residues 0 and Q - 1) among them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from learn_fhe_tpu.models.fhew import rlwe as jrlwe  # noqa: E402
from learn_fhe_tpu.models.fhew.params import RlweParams as JRlweParams  # noqa: E402
from learn_fhe_tpu.models.tfhe import TglweParams as JTglweParams  # noqa: E402
from learn_fhe_tpu.models.tfhe import bootstrapping as jboot  # noqa: E402
from learn_fhe_tpu.models.tfhe import tglwe as jtglwe  # noqa: E402
from learn_fhe_tpu.models.tfhe import tlwe as jtlwe  # noqa: E402
from learn_fhe_tpu.ops import modular as jmodular  # noqa: E402
from learn_fhe_tpu.utils.primes import two_adic_primes  # noqa: E402
import learn_fhe_tpu_torch.models.tfhe as tfhe  # noqa: E402
from learn_fhe_tpu_torch.models.fhew import rlwe  # noqa: E402
from learn_fhe_tpu_torch.models.fhew.params import RlweParams  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u64, u64_to_torch  # noqa: E402


def _tfhe_params(n, big_n, k):
    return tfhe.BootstrapParams(
        tfhe.TlweParams(log_p=2, padding=1, n=n, std_dev=1e-8, log_b=4, d=5),
        tfhe.TggswParams(tfhe.TglweParams(log_p=2, padding=1, big_n=big_n, k=k, std_dev=1e-15), log_b=23, d=1),
    )


def _front_inputs(rng, batch, n, big_n, switched):
    """(a, b, v) as u64 arrays: exponents in [0, 2N] with b's edge values,
    or torus words with words near 2^64 - 1 and at the rounding's edges."""
    two_n = 2 * big_n
    if switched:
        a = rng.integers(0, two_n + 1, size=(batch, n), dtype=np.uint64)
        b = rng.integers(0, two_n + 1, size=(batch,), dtype=np.uint64)
        edges = np.array([0, big_n, two_n - 1, two_n], dtype=np.uint64)
        a.reshape(-1)[: min(4, a.size)] = edges[: min(4, a.size)]
    else:
        a = rng.integers(0, 1 << 64, size=(batch, n), dtype=np.uint64)
        b = rng.integers(0, 1 << 64, size=(batch,), dtype=np.uint64)
        bits = 64 - two_n.bit_length() + 1
        half = (1 << bits) >> 1
        edges = np.array([2**64 - 1, 2**64 - half, 2**64 - half - 1, half - 1, half, 0], dtype=np.uint64)
        a.reshape(-1)[: min(6, a.size)] = edges[: min(6, a.size)]
    b[: min(4, batch)] = edges[: min(4, batch)]
    v = rng.integers(0, 1 << 64, size=(big_n,), dtype=np.uint64)
    v[0], v[-1] = 0, 2**64 - 1
    return a, b, v


# (B, n, N, k): a batch of one, a ragged batch and n (not multiples of 32), two
# ring components
FRONT_CASES = [(1, 16, 16, 1), (5, 33, 64, 1), (8, 7, 128, 2)]


@pytest.mark.parametrize("encode", [False, True])
@pytest.mark.parametrize("switched", [False, True])
@pytest.mark.parametrize("batch,n,big_n,k", FRONT_CASES)
def test_blind_rotate_front_ref_matches_jax(switched, encode, batch, n, big_n, k):
    """The exps (n, B) and the rotated accumulator, bit for bit, from torus
    words (switched=False) and from exponents (switched=True), from an
    encoded LUT and (encode=True) from the LUT's values, which the front
    encodes as `tglwe.encode` does."""
    params = _tfhe_params(n, big_n, k)
    a, b, v = _front_inputs(np.random.default_rng(batch + n + 2 * switched), batch, n, big_n, switched)
    if encode:
        v %= np.uint64(params.tglwe.p)
    args = (params, u64_to_torch(v), u64_to_torch(a), u64_to_torch(b), switched, encode)
    exps, acc = tfhe.bootstrapping.blind_rotate_front_ref(*args)
    jv = jtglwe.encode(JTglweParams(log_p=2, padding=1, big_n=big_n, k=k, std_dev=1e-15), jnp.asarray(v)) if encode else jnp.asarray(v)
    if switched:
        ja, jb = jnp.asarray(a.astype(np.int64)), jnp.asarray(b.astype(np.int64))
    else:
        ja, jb = jboot.mod_switch_2n(jtlwe.TlweCiphertext(jnp.asarray(a), jnp.asarray(b)), big_n)
    acc0 = jtglwe.TglweCiphertext(
        jnp.zeros((batch, k, big_n), dtype=jnp.uint64), jnp.broadcast_to(jv, (batch, big_n))
    )
    want = jax.vmap(jtglwe.rotate)(acc0, (-jb) % (2 * big_n))
    assert exps.shape == (n, batch) and exps.dtype == torch.int64
    np.testing.assert_array_equal(exps.numpy(), np.asarray(ja).T)
    np.testing.assert_array_equal(torch_to_u64(acc.a), np.asarray(want.a))
    np.testing.assert_array_equal(torch_to_u64(acc.b), np.asarray(want.b))
    if not switched:
        assert int(np.asarray(ja).max()) <= 2 * big_n - 1  # the rounding add wraps: 2N never appears from u64 words
    # on CPU tensors the wrapper is its plain version, and launches nothing
    launches = tfhe.blind_rotate_front.launches
    got = tfhe.blind_rotate_front(*args)
    assert torch.equal(got[0], exps) and torch.equal(got[1].a, acc.a) and torch.equal(got[1].b, acc.b)
    assert tfhe.blind_rotate_front.launches == launches


def _rlwe_params(mod, bits, log_n):
    return mod(q=next(two_adic_primes(bits, log_n + 1)), p=4, log_n=log_n, log_b=7, d=4)


@pytest.mark.parametrize("bits,dtype", [(28, torch.int32), (54, torch.int64)])
@pytest.mark.parametrize("at", ["first", "last", "middle"])
@pytest.mark.parametrize("b_add", ["zero", "q_by_8"])
def test_sample_extract_ref_matches_jax(bits, dtype, at, b_add):
    """The LWE ciphertext of coefficient i of a batch of RLWE ciphertexts
    (int32 residues as the u32 engine's walk leaves them, or int64), with
    b_add 0 or round(Q/8), bit for bit, int64 out."""
    log_n = 7
    params, jparams = _rlwe_params(RlweParams, bits, log_n), _rlwe_params(JRlweParams, bits, log_n)
    q, big_n = params.q, params.n
    i = {"first": 0, "last": big_n - 1, "middle": 37}[at]
    add = 0 if b_add == "zero" else round(q / 8.0)
    rng = np.random.default_rng(bits + i)
    a = rng.integers(0, q, size=(6, big_n), dtype=np.uint64)
    b = rng.integers(0, q, size=(6, big_n), dtype=np.uint64)
    a[0, :2], a[1, -2:], b[:2, i] = [0, q - 1], [q - 1, 0], [q - 1, 0]
    ct = rlwe.RlweCiphertext(torch.from_numpy(a.astype(np.int64)).to(dtype), torch.from_numpy(b.astype(np.int64)).to(dtype))
    got = rlwe.sample_extract_ref(params, ct, i, add)
    ext = jrlwe.sample_extract(jparams, jrlwe.RlweCiphertext(jnp.asarray(a), jnp.asarray(b)), i)
    want_b = jmodular.add_mod(ext.b, np.uint64(add), q) if add else ext.b
    assert got.a.dtype == torch.int64 and got.b.dtype == torch.int64
    np.testing.assert_array_equal(torch_to_u64(got.a), np.asarray(ext.a))
    np.testing.assert_array_equal(torch_to_u64(got.b), np.asarray(want_b))
    launches = rlwe.sample_extract.launches
    wrapped = rlwe.sample_extract(params, ct, i, b_add=add)
    assert torch.equal(wrapped.a, got.a) and torch.equal(wrapped.b, got.b)
    assert rlwe.sample_extract.launches == launches


def test_sample_extract_takes_any_batch_shape_and_checks_b_add():
    """An unbatched ciphertext and a 2-D batch keep their shapes; a b_add
    outside [0, Q) raises."""
    params = _rlwe_params(RlweParams, 28, 4)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(0, params.q, size=(2, 3, params.n)))
    b = torch.from_numpy(rng.integers(0, params.q, size=(2, 3, params.n)))
    flat = rlwe.sample_extract(params, rlwe.RlweCiphertext(a.reshape(6, -1), b.reshape(6, -1)), 3)
    got = rlwe.sample_extract(params, rlwe.RlweCiphertext(a, b), 3)
    assert got.a.shape == (2, 3, params.n) and got.b.shape == (2, 3)
    assert torch.equal(got.a.reshape(6, -1), flat.a) and torch.equal(got.b.reshape(6), flat.b)
    one = rlwe.sample_extract(params, rlwe.RlweCiphertext(a[1, 2], b[1, 2]), 3)
    assert one.a.shape == (params.n,) and one.b.shape == () and torch.equal(one.a, flat.a[5])
    with pytest.raises(ValueError):
        rlwe.sample_extract(params, rlwe.RlweCiphertext(a, b), 3, b_add=params.q)
