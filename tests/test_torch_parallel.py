"""Port vs JAX: the parallel layer on gloo ranks on the CPU.

Each world of D ranks is spawned once for the file, as
`python -m learn_fhe_tpu_torch.parallel.dryrun --device cpu --size small`
(the ranks import no JAX and no test module; they meet at a FileStore under
the test's temporary directory). Rank 0 gathers every sharded result, holds
it against the port's unsharded result, and writes it to a file; here the
same inputs (made from the same seeds with numpy) go through the JAX
package's coefficient-sharded transforms on conftest.py's 8-device CPU
mesh, its batch-sharded PBS and gate, and its share merge, element for
element. The sharded inverse scales by n^-1 before its cross layers, the
JAX package after them: `test_coef_sharded_matches_jax` is what shows the
values agree. The limb-sharded CKKS and BGV `mul`, the limb x coefficient
rotation and the dnum ladder's digit-sharded `mul` (`parallel/limb.py`)
are held against the JAX package's `C.mul`, `G.mul` and `C.rotate` on the
same seeds: limb-sharded on the 8-device mesh where the world is one limb
group of 8, else unsharded (`tests/test_parallel.py` holds the JAX
package's two equal); each JAX call is made once.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from learn_fhe_tpu.ops import rns as jrns  # noqa: E402
from learn_fhe_tpu.ops.modular32 import add_mod32, mul_shoup32, sub_mod32  # noqa: E402
from learn_fhe_tpu.parallel import coef as jcoef  # noqa: E402
from learn_fhe_tpu.parallel import coef32 as jcoef32  # noqa: E402
from learn_fhe_tpu_torch.parallel import coef as tcoef  # noqa: E402
from learn_fhe_tpu_torch.parallel import coef32 as tcoef32  # noqa: E402
from learn_fhe_tpu_torch.parallel import dryrun  # noqa: E402
from learn_fhe_tpu_torch.utils.interop import torch_to_u32, torch_to_u64, u32_to_torch, u64_to_torch  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SMALL = dryrun.SIZES["small"]
_ENV_DROP = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "XLA_FLAGS", "JAX_PLATFORMS")


def _world_cmd(tmp: Path, ranks: int, phases: tuple[str, ...], limb_ranks: int) -> list[str]:
    """A world of `ranks` gloo ranks on the CPU, rank 0's results to tmp/out.npz."""
    return [
        sys.executable, "-m", "learn_fhe_tpu_torch.parallel.dryrun", "--ranks", str(ranks), "--device", "cpu", "--size", "small",
        "--phases", ",".join(phases), "--limb-ranks", str(limb_ranks), "--store", str(tmp), "--out", str(tmp / "out.npz"),
    ]  # fmt: skip


# D = 2, 4 and 8: (phases, n_limb). The PBS and gate batches and the limb x
# coefficient rotation in the world of 4 (a 2 x 2 mesh); the world of 8 is
# one limb group of 8: one q limb and one p limb a rank
WORLDS = {
    2: (("coef", "coef32", "merge", "ckks_limb", "bgv_limb", "dnum"), 2),
    4: (dryrun.PHASES, 2),
    8: (("coef", "coef32", "merge", "ckks_limb"), 8),
}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds, started together; rank 0's results of each."""
    env = {k: v for k, v in os.environ.items() if k not in _ENV_DROP}
    tmps = {d: tmp_path_factory.mktemp(f"world{d}") for d in WORLDS}
    procs = {
        d: subprocess.Popen(_world_cmd(tmps[d], d, *w), cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for d, w in WORLDS.items()
    }
    outs = {d: p.communicate(timeout=600)[0] for d, p in procs.items()}
    for d, p in procs.items():
        assert p.returncode == 0 and f"dryrun OK: {d} ranks (cpu, small)" in outs[d], outs[d]
    return {d: dict(np.load(tmps[d] / "out.npz")) for d in WORLDS}


# (D, case of SMALL): case 0 is N = 2^9, case 1 N = 2^8 (tests/test_parallel.py's rings)
CASES = [(2, 0), (4, 1), (8, 1)]


@pytest.mark.parametrize("d,case", CASES)
def test_coef_sharded_matches_jax(worlds, d, case):
    """The port's u64 coef_sharded_ntt / intt / mul on D gloo ranks == the
    JAX package's on a D-device mesh."""
    qs, a, b = dryrun.coef_inputs(SMALL.coef[case], seed=10 + case)
    mesh = jcoef.coef_mesh(d)
    sa, sb = (jcoef.shard_coef(mesh, jnp.asarray(v)) for v in (a, b))
    want = {
        "ntt": jcoef.coef_sharded_ntt(mesh, sa, qs),
        "intt": jcoef.coef_sharded_intt(mesh, sa, qs),
        "mul": jcoef.coef_sharded_mul(mesh, sa, sb, qs),
    }
    for k, v in want.items():
        np.testing.assert_array_equal(worlds[d][f"coef{case}_{k}"], np.asarray(v), err_msg=f"coef_sharded_{k}")


@pytest.mark.parametrize("d,case", CASES)
def test_coef32_sharded_matches_jax(worlds, d, case):
    """The port's u32 coef32_sharded_ntt / intt / mul (K-NTT / intt32 local
    tails) on D gloo ranks == the JAX package's (radix-2 tails)."""
    q, a, b = dryrun.coef32_inputs(SMALL.coef32[case], seed=20 + case)
    mesh = jcoef.coef_mesh(d)
    sa, sb = (jcoef.shard_coef(mesh, jnp.asarray(v)) for v in (a, b))
    want = {
        "ntt": jcoef32.coef32_sharded_ntt(mesh, sa, q),
        "intt": jcoef32.coef32_sharded_intt(mesh, sa, q),
        "mul": jcoef32.coef32_sharded_mul(mesh, sa, sb, q),
    }
    for k, v in want.items():
        np.testing.assert_array_equal(worlds[d][f"coef32_{case}_{k}"], np.asarray(v), err_msg=f"coef32_sharded_{k}")


def test_merge_shares_matches_jax(worlds):
    """merge_shares of 8 parties, one a rank, == the JAX package's over an
    8-device 'party' mesh (each world's rank 0 also held its merge against
    the numpy sum mod q)."""
    from learn_fhe_tpu.parallel.multiparty import merge_shares, party_mesh

    d = 8
    shares = dryrun.merge_inputs(SMALL, d)
    mesh = party_mesh(d)
    got = merge_shares(mesh, jax.device_put(jnp.asarray(shares), NamedSharding(mesh, P("party"))), SMALL.merge_q)
    np.testing.assert_array_equal(worlds[d]["merge"], np.asarray(got.addressable_data(0)))


def test_sharded_pbs_decrypts_as_jax(worlds):
    """The port's batch-sharded PBS over 4 ranks and the JAX package's over
    a 4-device 'batch' mesh, same fixture (N = 256) and messages: both
    decrypt to the messages."""
    from learn_fhe_tpu.models.tfhe import BootstrapParams, TggswParams, TglweParams, TlweParams, key_gen, lut_table, tglwe, tlwe
    from learn_fhe_tpu.models.tfhe.bootstrapping import mod_switch_2n
    from learn_fhe_tpu.parallel import make_mesh, replicate, shard_batch, tfhe_pbs_batch_device

    tp = dryrun.tfhe_params("small")  # tests/test_parallel.py's fixture, in both packages
    params = BootstrapParams(
        TlweParams(log_p=2, padding=1, n=64, std_dev=1.34e-7, log_b=4, d=5),
        TggswParams(TglweParams(log_p=2, padding=1, big_n=256, k=1, std_dev=2.85e-15), log_b=23, d=1),
    )
    assert (tp.tlwe.n, tp.big_n, tp.tlwe.log_p) == (params.tlwe.n, params.big_n, params.tlwe.log_p)
    rng = np.random.default_rng(0)
    z = tlwe.sk_gen(params.tlwe, rng)
    key = key_gen(params, z, rng)
    ms = dryrun.pbs_messages(tp, SMALL.pbs_batch).astype(np.uint64)
    cts = tlwe.sk_encrypt(params.tlwe, z, tlwe.encode(params.tlwe, jnp.asarray(ms)), np.random.default_rng(4))
    a2n, b2n = mod_switch_2n(cts, params.big_n)
    mesh = make_mesh(n_batch=4, n_limb=1, devices=jax.devices()[:4])
    key_r = jax.tree.map(lambda x: replicate(mesh, x), key)
    v_enc = tglwe.encode(params.tglwe, jnp.asarray(lut_table(tp.tlwe.log_p, params.big_n, lambda v: v)))
    out = tfhe_pbs_batch_device(params, key_r, replicate(mesh, v_enc), shard_batch(mesh, a2n), shard_batch(mesh, b2n))
    jax_bits = np.asarray(tlwe.decode(params.tlwe, tlwe.decrypt(params.tlwe, z, out)))
    np.testing.assert_array_equal(jax_bits, ms)
    np.testing.assert_array_equal(worlds[4]["pbs_bits"], jax_bits)


def test_sharded_gate_decrypts_as_jax(worlds):
    """A NAND batch over 4 ranks and over the JAX package's 4-device mesh
    at the N = 128 fixture: the same bits, the truth table's."""
    from learn_fhe_tpu.models.fhew import BootstrapParams as FBP, LweParams, RgswParams, RlweParams, gates, lwe, rlwe
    from learn_fhe_tpu.models.fhew import key_gen as fkey_gen
    from learn_fhe_tpu.parallel import fhew_gate_batch, make_mesh, replicate, shard_batch
    from learn_fhe_tpu.utils.primes import two_adic_primes

    q = next(two_adic_primes(28, 8))  # tests/test_parallel.py's fixture, in both packages
    params = FBP(
        RgswParams(RlweParams(q=q, p=4, log_n=7, log_b=7, d=4), log_b=7, d=4),
        LweParams(q=1 << 16, p=4, n=16, log_b=4, d=4),
        w=5,
    )
    fp = dryrun.fhew_params("small")
    assert (fp.q, fp.n, fp.rlwe.log_n) == (params.q, params.n, params.rlwe.log_n)
    rng = np.random.default_rng(0)
    z = rlwe.sk_gen(params.rlwe, rng)
    key = fkey_gen(params, z, rng)
    m0, m1 = dryrun.gate_messages(SMALL.gate_batch)
    enc = np.random.default_rng(7)
    c0, c1 = (lwe.sk_encrypt(params.lwe_z, z, gates.encode_bool(params, m.astype(bool)), enc) for m in (m0, m1))
    mesh = make_mesh(n_batch=4, n_limb=1, devices=jax.devices()[:4])
    key_r = jax.tree.map(lambda x: replicate(mesh, x), key)
    shard = lambda c: type(c)(shard_batch(mesh, c.a), shard_batch(mesh, c.b))  # noqa: E731
    out = fhew_gate_batch(params, key_r, "nand", shard(c0), shard(c1))
    jax_bits = np.asarray(gates.decode_bool(params, lwe.decrypt(params.lwe_z, z, out))).astype(np.int64)
    np.testing.assert_array_equal(jax_bits, 1 - (m0 & m1))
    np.testing.assert_array_equal(worlds[4]["gate_bits"], jax_bits)


# ---------------------------------------------------------------------------
# The limb-sharded key switch (`parallel/limb.py`) against the JAX package
# ---------------------------------------------------------------------------

LIMB_CASES = [(d, p) for d, (phases, _) in WORLDS.items() for p in phases if p in dryrun.LIMB_PHASES]


def _jax_ckks(params, seed, n_cts, key, amp=0.5):
    """The JAX package's sk, key, messages and ciphertexts drawn as
    `dryrun.ckks_inputs` draws the port's (unbatched)."""
    from learn_fhe_tpu.models.ckks import ckks as JC

    rng = np.random.default_rng(seed)
    sk = JC.sk_gen(params, rng)
    k = JC.rlk_gen(params, sk, rng) if key == "rlk" else JC.rtk_gen(params, sk, 1, rng)
    ms, cts = [], []
    for _ in range(n_cts):
        m = (rng.standard_normal(params.l) + 1j * rng.standard_normal(params.l)) * amp
        ms.append(m)
        cts.append(JC.sk_encrypt(params, sk, JC.encode(params, m), params.qs, rng))
    return sk, k, ms, cts


@pytest.fixture(scope="module")
def jax_limb():
    """Each limb phase's JAX result, made at its first use: (params, sk,
    result, what it decrypts to); `ckks_limb_8` limb-sharded over the
    8-device mesh."""
    from learn_fhe_tpu.models.bgv import bgv as JG
    from learn_fhe_tpu.models.ckks import ckks as JC
    from learn_fhe_tpu.models.ckks.production import ProductionConfig
    from learn_fhe_tpu.parallel.mesh import make_mesh

    def ckks_mul(sharded=False):
        params = JC.CkksParams(**SMALL.ckks)
        sk, rlk, (m0, m1), (ct0, ct1) = _jax_ckks(params, dryrun.SEEDS["ckks_limb"], 2, "rlk")
        if sharded:
            mesh = make_mesh(n_batch=1, n_limb=8)
            put = lambda x: jax.device_put(x, NamedSharding(mesh, P("limb", None)))  # noqa: E731
            ct0, ct1 = (JC.CkksCiphertext(put(c.b), put(c.a), c.qs) for c in (ct0, ct1))
            rlk = JC.CkksKeySwitchingKey(put(rlk.b), put(rlk.a), rlk.qs)
        return params, sk, JC.mul(params, rlk, ct0, ct1), m0 * m1

    def ks2d():
        params = JC.CkksParams(**SMALL.ckks)
        sk, rtk, (m,), (ct,) = _jax_ckks(params, dryrun.SEEDS["ks2d"], 1, "rtk")
        return params, sk, JC.rotate(params, rtk, ct), np.roll(m, -1)

    def dnum():
        params = ProductionConfig(**SMALL.dnum).params
        sk, rlk, (m,), (ct,) = _jax_ckks(params, dryrun.SEEDS["dnum"], 1, "rlk", amp=0.3)
        return params, sk, JC.mul(params, rlk, ct, ct), m * m

    def bgv_mul():
        params = JG.BgvParams(**SMALL.bgv)
        rng = np.random.default_rng(dryrun.SEEDS["bgv_limb"])
        sk = JG.sk_gen(params, rng)
        rlk = JG.rlk_gen(params, sk, rng)
        ms, cts = [], []
        for _ in range(2):
            ms.append(rng.integers(0, params.t, size=params.n, dtype=np.int64))
            cts.append(JG.sk_encrypt(params, sk, JG.encode(params, ms[-1]), params.qs, rng))
        return params, sk, JG.mul(params, rlk, *cts), (ms[0] * ms[1]) % params.t

    makers = {"ckks_limb": ckks_mul, "ckks_limb_8": lambda: ckks_mul(sharded=True), "bgv_limb": bgv_mul, "ks2d": ks2d, "dnum": dnum}
    made = {}

    def get(name):
        if name not in made:
            made[name] = makers[name]()
        return made[name]

    return get


@pytest.mark.parametrize("d,phase", LIMB_CASES)
def test_limb_sharded_ops_match_jax(worlds, jax_limb, d, phase):
    """The port's sharded CKKS `mul` (8 + 8 limbs), BGV `mul` (4 + 4), limb x
    coefficient rotation and digit-sharded dnum `mul` on D gloo ranks ==
    the JAX package's on the same seeds, bit for bit; and the result
    decrypts: CKKS within 1e-5 of the messages' product (the rotated
    message), BGV to the product mod t exactly."""
    from learn_fhe_tpu.models.bgv import bgv as JG
    from learn_fhe_tpu.models.ckks import ckks as JC

    params, sk, want, message = jax_limb(f"{phase}_8" if (d, phase) == (8, "ckks_limb") else phase)
    got = worlds[d]
    np.testing.assert_array_equal(got[f"{phase}_b"], np.asarray(want.b), err_msg=f"{phase} b")
    np.testing.assert_array_equal(got[f"{phase}_a"], np.asarray(want.a), err_msg=f"{phase} a")
    ct = type(want)(jnp.asarray(got[f"{phase}_b"]), jnp.asarray(got[f"{phase}_a"]), *[getattr(want, f) for f in ("qs", "factor") if hasattr(want, f)])
    if phase == "bgv_limb":
        np.testing.assert_array_equal(np.asarray(JG.decrypt(params, sk, ct)) % params.t, message)
    else:
        err = np.max(np.abs(JC.decode(params, JC.decrypt(params, sk, ct), ct.qs) - message))
        assert err < 1e-5, err


# the collectives one sharded operation issues on every rank, by the design
# (`parallel/limb.py`): the mul's four all-to-alls; the rotation's all_gather,
# four all-to-alls and log2(n_batch) exchanges each way; one all_gather of
# the digits' partial sums
DESIGN = {
    "ckks_limb": {"all_to_all": 4},
    "bgv_limb": {"all_to_all": 4},
    "ks2d": {"all_to_all": 4, "all_gather": 1, "exchange": 2},
    "dnum": {"all_gather": 1},
}


@pytest.mark.parametrize("d,phase", LIMB_CASES)
def test_sharded_ops_issue_the_designs_collectives(worlds, d, phase):
    """Counted by `distributed.CALLS` on every rank around the one sharded
    call: a limb-sharded `mul` issues at most 4 collectives (the JAX
    package's GSPMD 26-36), each operation exactly its design's."""
    calls = worlds[d][f"op_{phase}_calls"]  # (ranks, dryrun.COLLECTIVES)
    assert calls.shape == (d, len(dryrun.COLLECTIVES))
    want = [DESIGN[phase].get(c, 0) for c in dryrun.COLLECTIVES]
    for rank in range(d):
        assert calls[rank].tolist() == want, (rank, dict(zip(dryrun.COLLECTIVES, calls[rank].tolist())))
        if phase in ("ckks_limb", "bgv_limb"):
            assert calls[rank].sum() <= 4
    sent = worlds[d][f"op_{phase}_bytes"]  # bytes sent to other ranks, by kind
    assert ((sent > 0) == (calls > 0)).all(), sent


@pytest.mark.parametrize("n_limbs,n_ranks", [(8, 2), (15, 2), (7, 2), (21, 8), (8, 8), (7, 8), (2, 4)])
def test_limb_bounds_cut_as_array_split(n_limbs, n_ranks):
    from learn_fhe_tpu_torch.parallel.mesh import limb_bounds, limb_sizes

    cuts = np.array_split(np.arange(n_limbs), n_ranks)
    assert [list(range(s, e)) for s, e in limb_bounds(n_limbs, n_ranks)] == [c.tolist() for c in cuts]
    assert limb_sizes(n_limbs, n_ranks) == [len(c) for c in cuts]


def test_a_rank_without_a_q_limb_raises():
    """BGV's 4 q limbs over 8 'limb' ranks: the port raises (JAX's GSPMD pads)."""
    from learn_fhe_tpu_torch.models.bgv import bgv as TG
    from learn_fhe_tpu_torch.parallel.limb import qp_rows

    params = TG.BgvParams(**SMALL.bgv)
    with pytest.raises(ValueError, match="would leave a rank none"):
        qp_rows(params, params.qs, 0, 8)
    assert qp_rows(params, params.qs, 3, 4) == ((params.qs[3],), (params.ps[3],))


# ---------------------------------------------------------------------------
# Plans and K-COEF-CROSS's plain version against the JAX package (one process)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_coef_plans_match_jax(d):
    qs, _, _ = dryrun.coef_inputs(SMALL.coef[1])
    jp, tp = jcoef.coef_ntt_plan(qs, 256, d), tcoef.coef_ntt_plan(qs, 256, d)
    for f in ("cross_tw", "cross_tw_shoup", "cross_tw_inv", "cross_tw_inv_shoup", "local_psi", "local_psi_shoup", "local_psi_inv", "local_psi_inv_shoup", "n_inv", "n_inv_shoup"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(jp, f), err_msg=f)
    q = dryrun.coef32_inputs(SMALL.coef32[1])[0]
    jp32, tp32 = jcoef32.coef32_plan(q, 256, d), tcoef32.coef32_plan(q, 256, d)
    for f in ("cross_tw", "cross_tw_shoup", "cross_tw_inv", "cross_tw_inv_shoup", "local_psi", "local_psi_shoup", "local_psi_inv", "local_psi_inv_shoup"):
        np.testing.assert_array_equal(getattr(tp32, f), getattr(jp32, f), err_msg=f)
    assert (tp32.n_inv, tp32.n_inv_shoup) == (jp32.n_inv, jp32.n_inv_shoup)


def _jax_cross64(x, recv, plan, layer, rank, inverse):
    """`learn_fhe_tpu/parallel/coef.py:157-167` / `:180-190`, rank `rank`'s
    layer body with the JAX package's modular ops."""
    q = jnp.asarray(plan.q_arr)
    upper = ((rank >> (plan.log_d - layer - 1)) & 1) == 1
    tab, tab_s = (plan.cross_tw_inv, plan.cross_tw_inv_shoup) if inverse else (plan.cross_tw, plan.cross_tw_shoup)
    t, ts = jnp.asarray(tab[layer][rank]), jnp.asarray(tab_s[layer][rank])
    u, v = jnp.where(upper, recv, x), jnp.where(upper, x, recv)
    if inverse:
        return jnp.where(upper, jrns.mul_shoup_v(jrns.sub_mod_v(u, v, q), t, ts, q), jrns.add_mod_v(u, v, q))
    tv = jrns.mul_shoup_v(v, t, ts, q)
    return jnp.where(upper, jrns.sub_mod_v(u, tv, q), jrns.add_mod_v(u, tv, q))


def _jax_cross32(x, recv, plan, layer, rank, inverse):
    """`learn_fhe_tpu/parallel/coef32.py:148-158` / `:171-181`."""
    q = plan.q
    upper = ((rank >> (plan.log_d - layer - 1)) & 1) == 1
    tab, tab_s = (plan.cross_tw_inv, plan.cross_tw_inv_shoup) if inverse else (plan.cross_tw, plan.cross_tw_shoup)
    t, ts = jnp.asarray(tab[layer, rank]), jnp.asarray(tab_s[layer, rank])
    u, v = jnp.where(upper, recv, x), jnp.where(upper, x, recv)
    if inverse:
        return jnp.where(upper, mul_shoup32(sub_mod32(u, v, q), t, ts, q), add_mod32(u, v, q))
    tv = mul_shoup32(v, t, ts, q)
    return jnp.where(upper, sub_mod32(u, tv, q), add_mod32(u, tv, q))


@pytest.mark.parametrize("d", [2, 4, 8])
def test_coef_cross_plain_matches_jax_layer_body(d):
    """K-COEF-CROSS's plain versions (u64, u32) == the JAX package's layer
    bodies at every layer of every rank, forward and inverse, with edge
    values; on CPU tensors the wrappers take them and count no launch."""
    qs, x, v = dryrun.coef_inputs(((2,), 9, 3, 55), seed=d)
    m = x.shape[-1] // d
    x, v = x[..., :m].copy(), v[..., :m].copy()
    x[0, :, 0], v[-1, :, -1] = np.array(qs) - 1, np.array(qs) - 1
    q32, x32, v32 = dryrun.coef32_inputs(((3,), 9, 28), seed=d)
    x32, v32 = x32[..., : 512 // d].copy(), v32[..., : 512 // d].copy()
    x32[0, 0], v32[-1, -1] = q32 - 1, q32 - 1
    cases = (
        (tcoef.coef_cross, tcoef.coef_ntt_plan(qs, 512, d), jcoef.coef_ntt_plan(qs, 512, d), _jax_cross64, x, v, u64_to_torch, torch_to_u64),
        (tcoef32.coef32_cross, tcoef32.coef32_plan(q32, 512, d), jcoef32.coef32_plan(q32, 512, d), _jax_cross32, x32, v32, u32_to_torch, torch_to_u32),
    )
    for fn, tp, jp, body, a, b, to_t, to_np in cases:
        before = fn.launches
        for rank in range(d):
            for layer in range(tp.log_d):
                for inverse in (False, True):
                    got = to_np(fn(to_t(a), to_t(b), tp, layer, rank, inverse))
                    np.testing.assert_array_equal(got, np.asarray(body(jnp.asarray(a), jnp.asarray(b), jp, layer, rank, inverse)))
        assert fn.launches == before
