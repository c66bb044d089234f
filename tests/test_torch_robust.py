"""The hostile fleet in the port against the JAX package: aggregator specs,
attack tables and values, DP uplinks, the robust merge (B10's plain
version against the JAX reference and the Pallas kernel in interpret
mode), the Krum selection, ``sync_merge_stacked(agg=...)``, and the
serial PSEngine over attack × aggregator × backend, with DP, q8 with error
feedback and faults in the grid.

Bars: specs, names, fingerprints, membership tables, Krum masks and the
sign-flip, zero and collusion values are exact. Noise-driven values
(scaled-noise attack, DP noise) agree at rtol 1e-5 / atol 3e-5: torch's
and XLA's erfinv differ by a few ulps on the same uniforms (ROADMAP C3).
The DP clip and the trimmed merge agree at 1e-6 (the merge sums its
survivors in another order). Engine residual traces agree at rtol 1e-5 /
atol 1e-6, and the attacked workers are the same. Within the port, the
zero-budget aggregators are bit-identical to no aggregator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ps as jps
from repro.core import AdaSEGConfig as JaxCfg
from repro.kernels.sync_compress import kernel as jk
from repro.kernels.sync_compress import ops as jops
from repro.kernels.sync_compress import ref as jref
from repro.problems import make_bilinear_game as jax_game
from repro_torch import interop
from repro_torch import ps as tps
from repro_torch import random as jr
from repro_torch.core import AdaSEGConfig
from repro_torch.kernels.sync_compress import kernel as tk
from repro_torch.kernels.sync_compress import ops as tops
from repro_torch.kernels.sync_compress import ref as tref
from repro_torch.problems import make_bilinear_game

M, R = 8, 4
CFG = dict(g0=1.0, diameter=2.0, alpha=1.0, k=4)
TOL = dict(rtol=1e-5, atol=1e-6)
NOISE_TOL = dict(rtol=1e-5, atol=3e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# Policies: specs, names, fingerprints, membership tables
# ---------------------------------------------------------------------------

AGGREGATORS = {
    "weighted_mean": lambda mod: mod.WeightedMean(),
    "trimmed0": lambda mod: mod.TrimmedMean(beta=0.0),
    "trimmed20": lambda mod: mod.TrimmedMean(beta=0.2),
    "trimmed45": lambda mod: mod.TrimmedMean(beta=0.45),
    "median": lambda mod: mod.CoordinateMedian(),
    "krum0": lambda mod: mod.MultiKrum(f=0),
    "krum2": lambda mod: mod.MultiKrum(f=2),
    "krum_single": lambda mod: mod.MultiKrum(f=1, m_select=1),
    "krum_wide": lambda mod: mod.MultiKrum(f=3, m_select=20),
}


@pytest.mark.parametrize("name", list(AGGREGATORS))
def test_aggregator_specs_match_jax(name):
    ours, theirs = AGGREGATORS[name](tps), AGGREGATORS[name](jps)
    assert ours.name == theirs.name
    assert ours.fingerprint == theirs.fingerprint
    for m in range(1, 13):
        assert ours.spec(m) == theirs.spec(m), m
        assert ours.reject_frac(m) == theirs.reject_frac(m), m


@pytest.mark.parametrize("make", [
    lambda mod: mod.TrimmedMean(beta=0.5),
    lambda mod: mod.TrimmedMean(beta=-0.1),
    lambda mod: mod.MultiKrum(f=-1),
    lambda mod: mod.MultiKrum(f=1, m_select=0),
    lambda mod: mod.DPUplink(clip=0.0),
    lambda mod: mod.DPUplink(clip=1.0, sigma=-1.0),
])
def test_policy_validation_matches_jax(make):
    for mod in (jps, tps):
        with pytest.raises(ValueError):
            make(mod)


ATTACKS = {
    "sign_flip": lambda mod, pr: mod.SignFlipAttack(
        fraction=0.25, scale=8.0, seed=11, per_round=pr),
    "scaled_noise": lambda mod, pr: mod.ScaledNoiseAttack(
        fraction=0.3, scale=10.0, seed=1, per_round=pr),
    "zero": lambda mod, pr: mod.ZeroAttack(fraction=0.4, seed=3,
                                           per_round=pr),
    "collusion": lambda mod, pr: mod.CollusionAttack(
        fraction=0.2, eps=1.5, seed=2, per_round=pr),
}


@pytest.mark.parametrize("per_round", [False, True])
@pytest.mark.parametrize("attack", list(ATTACKS))
def test_attack_tables_and_names_match_jax(attack, per_round):
    ours, theirs = ATTACKS[attack](tps, per_round), ATTACKS[attack](jps,
                                                                    per_round)
    assert (ours.name, ours.fingerprint) == (theirs.name, theirs.fingerprint)
    for m, r in ((M, 7), (5, 3), (13, 6)):
        assert ours.count(m) == theirs.count(m)
        got, want = ours.attacked(m, r), theirs.attacked(m, r)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _payload(seed=0, m=M):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (m, 33)).astype(np.float32),
            rng.uniform(-1, 1, (m, 4, 5)).astype(np.float32))


def _keys(seed=5, m=M):
    keys = jax.random.split(jax.random.PRNGKey(seed), m)
    return keys, interop.key_from_numpy(np.asarray(keys), device="cpu")


@pytest.mark.parametrize("attack", ["sign_flip", "zero", "collusion"])
def test_deterministic_attacks_exact(attack):
    """The attack as the JAX engine runs it (under jit) and the port's, on
    the same payload and mask: identical bits; honest rows untouched."""
    z = _payload()
    mask = np.array([True, False, False, True, False, False, True, False])
    jkeys, tkeys = _keys()
    want = jax.jit(lambda p, mk, k: ATTACKS[attack](jps, False).apply(
        p, mk, k))(tuple(map(jnp.asarray, z)), jnp.asarray(mask), jkeys)
    got = ATTACKS[attack](tps, False).apply(tuple(map(_t, z)), _t(mask),
                                           tkeys)
    for a, b, orig in zip(got, want, z):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy()[~mask], orig[~mask])


def test_scaled_noise_attack_matches_jax():
    z = _payload(1)
    mask = np.array([False, True] * (M // 2))
    jkeys, tkeys = _keys(7)
    pol = ("scaled_noise", False)
    want = jax.jit(lambda p, mk, k: ATTACKS[pol[0]](jps, pol[1]).apply(
        p, mk, k))(tuple(map(jnp.asarray, z)), jnp.asarray(mask), jkeys)
    got = ATTACKS[pol[0]](tps, pol[1]).apply(tuple(map(_t, z)), _t(mask),
                                            tkeys)
    for a, b, orig in zip(got, want, z):
        _close(a, b, **NOISE_TOL)
        np.testing.assert_array_equal(a.numpy()[~mask], orig[~mask])
        assert np.abs(a.numpy()[mask] - orig[mask]).max() > 1.0


@pytest.mark.parametrize("sigma", [0.0, 0.1])
def test_dp_uplink_matches_jax(sigma):
    """Joint l2 clip across the leaves (rows with norm below the clip pass
    unscaled), then noise of stddev sigma·clip from per-leaf keys."""
    z = list(_payload(2))
    for leaf in z:
        leaf[0] *= 0.01                    # one worker inside the ball
    jkeys, tkeys = _keys(9)
    want = jax.jit(lambda p, k: jps.DPUplink(clip=2.0, sigma=sigma).apply(
        p, k))(tuple(map(jnp.asarray, z)), jkeys)
    got = tps.DPUplink(clip=2.0, sigma=sigma).apply(tuple(map(_t, z)), tkeys)
    for a, b in zip(got, want):
        if sigma:
            _close(a, b, **NOISE_TOL)
        else:
            _close(a, b, rtol=1e-6, atol=1e-6)
    if not sigma:
        norms = torch.sqrt(sum(v.reshape(M, -1).square().sum(1) for v in got))
        assert bool((norms <= 2.0 * (1 + 1e-6)).all())
        np.testing.assert_array_equal(got[0][0].numpy(), z[0][0])
    assert tps.DPUplink(clip=2.0, sigma=sigma).fingerprint == jps.DPUplink(
        clip=2.0, sigma=sigma).fingerprint


# ---------------------------------------------------------------------------
# The robust merge (B10's plain version) and Krum
# ---------------------------------------------------------------------------

def _merge_case(m, case, n=300, seed=0):
    rng = np.random.default_rng(seed + m)
    z = rng.standard_normal((m, n)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, m).astype(np.float32)
    incl = np.ones(m, np.float32)
    recv = old = None
    if case == "ties":
        # nine levels: every column full of ties, broken by row index with
        # non-uniform weights
        z = np.round(np.clip(z, -1, 1) * 4) / 4
    if case == "gated":
        incl[[1, m - 1]] = 0.0
        w[[1, m - 1]] = 0.0
        recv = incl > 0
        old = rng.standard_normal((m, n)).astype(np.float32)
    return z.astype(np.float32), w, incl, recv, old


@pytest.mark.parametrize("case", ["plain", "ties", "gated"])
@pytest.mark.parametrize("m", [5, 8])
def test_trimmed_merge_ref_matches_jax(m, case):
    """Every trim from 1 to ⌊(M−1)/2⌋ (the median), odd and even M, against
    the JAX reference under jit and the Pallas kernel in interpret mode."""
    z, w, incl, recv, old = _merge_case(m, case)
    for trim in range(1, (m - 1) // 2 + 1):
        got = tref.trimmed_merge_ref(
            _t(z), _t(w), _t(incl), trim=trim,
            recv=None if recv is None else _t(recv),
            old=None if old is None else _t(old))
        want = jax.jit(lambda z, w, i, r, o: jref.trimmed_merge_ref(
            z, w, i, trim=trim, recv=r, old=o))(z, w, incl, recv, old)
        pallas = jk.trimmed_merge_stacked(
            jnp.asarray(z), w, incl,
            None if recv is None else jnp.asarray(recv, jnp.float32),
            None if old is None else jnp.asarray(old), trim=trim, block=128,
            interpret=True)
        _close(got, want, rtol=0, atol=1e-6)
        _close(got, pallas, rtol=0, atol=1e-6)
        if recv is not None:
            np.testing.assert_array_equal(got.numpy()[~recv], old[~recv])


def test_trimmed_merge_at_full_trim_is_the_weighted_median():
    """Odd M at the maximal trim keeps one row per coordinate: the median
    value itself (w·z / w, within an ulp), whatever the weights."""
    z, w, incl, _, _ = _merge_case(7, "plain")
    got = tref.trimmed_merge_ref(_t(z), _t(w), _t(incl), trim=3)
    _close(got.numpy()[0], np.median(z, axis=0), rtol=1e-6, atol=0)


# A fleet one row past the card's staged path (1350 rows; the streamed
# path takes it): ties everywhere and a dead row, against the JAX reference
# under jit, compiled once for the module.
BIG_M, BIG_N, BIG_TRIM, BIG_DEAD = 1351, 37, 270, 5


@pytest.fixture(scope="module")
def big_fleet():
    rng = np.random.default_rng(22)
    z = np.round(rng.uniform(-1, 1, (BIG_M, BIG_N)) * 4).astype(np.float32) / 4
    w = rng.uniform(0.2, 2.0, BIG_M).astype(np.float32)
    incl = np.ones(BIG_M, np.float32)
    w[BIG_DEAD] = incl[BIG_DEAD] = 0.0
    recv = incl > 0
    old = rng.standard_normal((BIG_M, BIG_N)).astype(np.float32)
    want = jax.jit(lambda z, w, i, r, o: jref.trimmed_merge_ref(
        z, w, i, trim=BIG_TRIM, recv=r, old=o))(z, w, incl, recv, old)
    return (z, w, incl, recv, old), np.asarray(want)


def test_trimmed_merge_ref_past_the_staged_rows_matches_jax(big_fleet):
    (z, w, incl, recv, old), want = big_fleet
    got = tref.trimmed_merge_ref(_t(z), _t(w), _t(incl), trim=BIG_TRIM,
                                 recv=_t(recv), old=_t(old))
    _close(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.numpy()[BIG_DEAD], old[BIG_DEAD])


@pytest.mark.parametrize("use_kernel", [True, False])
def test_sync_merge_stacked_trimmed_past_the_staged_rows_matches_jax(
        big_fleet, use_kernel):
    """The server side as the engine calls it: the dead row's zero weight
    leaves it out of the order and its ``recv`` keeps ``old``."""
    (z, w, _, recv, old), want = big_fleet
    (got,) = tops.sync_merge_stacked((_t(z),), _t(w), _t(recv), (_t(old),),
                                     normalize=True, agg=("trimmed", BIG_TRIM),
                                     use_kernel=use_kernel)
    _close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("rows,path", [
    (1, tk.TRIMMED_STAGED), (64, tk.TRIMMED_STAGED),
    (1350, tk.TRIMMED_STAGED), (1351, tk.TRIMMED_STREAMED),
    (2048, tk.TRIMMED_STREAMED), (10000, tk.TRIMMED_STREAMED),
    (65535, tk.TRIMMED_STREAMED), (70000, tk.TRIMMED_STREAMED)])
def test_trimmed_merge_path_choice(rows, path):
    """The staged path while its slice fits the opt-in shared memory (1350
    rows: the (M, 32) column, w, incl, recv, a keep byte a row and column,
    33 scalars), the streamed path past it, with no row limit."""
    def staged_bytes(m):
        return m * (4 * (32 + 3) + 32) + 4 * (32 + 1)

    assert tk.TRIMMED_STAGED_ROWS == 1350
    assert staged_bytes(1350) <= tk.SHARED_BYTES < staged_bytes(1351)
    assert tk.trimmed_path(rows) == path


def _krum_case(case):
    rng = np.random.default_rng(3)
    z = (rng.integers(-3, 4, (M, 12)).astype(np.float32),
         rng.integers(-3, 4, (M, 2, 3)).astype(np.float32))
    w = None
    if case == "ties":
        # duplicated rows: exact, equal scores (integer arithmetic)
        for leaf in z:
            leaf[4] = leaf[1]
            leaf[6] = leaf[1]
            leaf[7] = leaf[2]
    if case == "weights":
        w = rng.uniform(0.5, 2.0, M).astype(np.float32)
        w[[0, 5]] = 0.0
    return z, w


@pytest.mark.parametrize("f,m_sel", [(2, 6), (1, 1), (3, 8), (2, 3)])
@pytest.mark.parametrize("case", ["random", "ties", "weights"])
def test_krum_select_matches_jax(case, f, m_sel):
    z, w = _krum_case(case)
    want = jax.jit(lambda z, w: jops._krum_select(
        [v.reshape(M, -1) for v in z], w, f=f, m_sel=m_sel))(z, w)
    got = tops._krum_select([_t(v).reshape(M, -1) for v in z],
                            None if w is None else _t(w), f=f, m_sel=m_sel)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


MERGE_AGGS = [("trimmed", 2), ("trimmed", 3), ("krum", 2, 5), ("krum", 1, 1)]


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("agg", MERGE_AGGS, ids=str)
def test_sync_merge_stacked_agg_matches_jax(agg, use_kernel):
    """The robust server side on a two-leaf payload, ungated and gated
    (two dead workers keep ``old``)."""
    z = _payload(4)
    rng = np.random.default_rng(5)
    w = rng.uniform(0.5, 2.0, M).astype(np.float32)
    recv = np.ones(M, bool)
    recv[[2, 5]] = False
    w_gated = np.where(recv, w, 0.0).astype(np.float32)
    old = _payload(6)
    for ww, rr, oo in ((w, None, None), (w_gated, recv, old)):
        want = jops.sync_merge_stacked(
            tuple(map(jnp.asarray, z)), jnp.asarray(ww),
            None if rr is None else jnp.asarray(rr),
            None if oo is None else tuple(map(jnp.asarray, oo)),
            normalize=True, agg=agg, use_kernel=use_kernel)
        got = tops.sync_merge_stacked(
            tuple(map(_t, z)), _t(ww), None if rr is None else _t(rr),
            None if oo is None else tuple(map(_t, oo)), normalize=True,
            agg=agg, use_kernel=use_kernel)
        for a, b in zip(got, want):
            assert a.shape == b.shape
            _close(a, b, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def games():
    return (jax_game(jax.random.PRNGKey(0), n=8, sigma=0.1),
            make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=8, sigma=0.1,
                               device="cpu"))


def _jax_engine(jg, codec_backend="reference", rounds=R, m=M, **kw):
    return jps.PSEngine(jg.problem,
                        jps.PSConfig(adaseg=JaxCfg(**CFG), num_workers=m,
                                     rounds=rounds,
                                     codec_backend=codec_backend, **kw),
                        rng=jax.random.PRNGKey(2), eval_fn=jg.residual)


def _port_engine(tg, codec_backend="reference", rounds=R, m=M, **kw):
    return tps.PSEngine(tg.problem,
                        tps.PSConfig(adaseg=AdaSEGConfig(**CFG),
                                     num_workers=m, rounds=rounds,
                                     codec_backend=codec_backend, **kw),
                        rng=jr.PRNGKey(2, device="cpu"), eval_fn=tg.residual,
                        device="cpu")


FLEETS = {
    "sign_flip_mean": lambda mod: dict(
        byzantine=mod.SignFlipAttack(fraction=0.25, scale=8.0, seed=11)),
    "sign_flip_trimmed": lambda mod: dict(
        byzantine=mod.SignFlipAttack(fraction=0.25, scale=8.0, seed=11),
        aggregator=mod.TrimmedMean(beta=0.25)),
    "noise_median": lambda mod: dict(
        byzantine=mod.ScaledNoiseAttack(fraction=0.25, seed=1,
                                        per_round=True),
        aggregator=mod.CoordinateMedian()),
    "collusion_krum": lambda mod: dict(
        byzantine=mod.CollusionAttack(fraction=0.25, seed=2),
        aggregator=mod.MultiKrum(f=2)),
    "zero_dp": lambda mod: dict(
        byzantine=mod.ZeroAttack(fraction=0.25, seed=3, per_round=True),
        dp=mod.DPUplink(clip=1.0, sigma=0.1)),
    "clean_median_top25": lambda mod: dict(
        aggregator=mod.CoordinateMedian(),
        compressor=mod.TopKCompressor(fraction=0.25)),
    "stack_q8_faults": lambda mod: dict(
        byzantine=mod.SignFlipAttack(fraction=0.25, scale=8.0, seed=11),
        dp=mod.DPUplink(clip=2.0, sigma=1e-3),
        compressor=mod.StochasticQuantizeCompressor(bits=8),
        faults=mod.BernoulliFaults(p=0.3, seed=5),
        aggregator=mod.TrimmedMean(beta=0.25)),
}


@pytest.mark.parametrize("codec_backend", ["reference", "fused"])
@pytest.mark.parametrize("fleet", list(FLEETS))
def test_engine_robust_matches_jax(games, fleet, codec_backend):
    jg, tg = games
    je = _jax_engine(jg, codec_backend, **FLEETS[fleet](jps))
    te = _port_engine(tg, codec_backend, **FLEETS[fleet](tps))
    z_j, z_t = je.run(), te.run()
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in je.trace.rounds])
    for a, b in zip(z_t, z_j):
        _close(a, b)
    for a, b in zip(te.state.z_tilde, je.state.z_tilde):
        _close(a, b)
    for a, b in zip(te._ef, jax.tree.leaves(je._ef)):
        _close(a, b)
    for rt, rj in zip(te.trace.rounds, je.trace.rounds):
        assert rt.byzantine_workers == rj.byzantine_workers
        assert (rt.alive, rt.bytes_up) == (rj.alive, rj.bytes_up)
    for key in ("byzantine", "aggregator", "dp", "compressor", "faults"):
        assert te.trace.meta.get(key) == je.trace.meta.get(key), key
    assert (te._robust is None) == (je._robust is None)


def test_robust_codec_backends_agree_bitwise_within_the_port(games):
    _, tg = games
    runs = []
    for cb in ("reference", "fused"):
        eng = _port_engine(tg, cb, **FLEETS["stack_q8_faults"](tps))
        runs.append((eng.run(), eng))
    (z_r, ref), (z_f, fused) = runs
    for a, b in zip((*z_r, *ref._ef), (*z_f, *fused._ef)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ([r.residual for r in ref.trace.rounds]
            == [r.residual for r in fused.trace.rounds])


ZERO_BUDGET = [
    ("weighted_mean", lambda: tps.WeightedMean(), M),
    ("trimmed0", lambda: tps.TrimmedMean(beta=0.0), M),
    ("krum0", lambda: tps.MultiKrum(f=0), M),
    ("median_of_2", lambda: tps.CoordinateMedian(), 2),
]


@pytest.mark.parametrize("codec_backend", ["reference", "fused"])
@pytest.mark.parametrize("name,make,m", ZERO_BUDGET,
                         ids=[z[0] for z in ZERO_BUDGET])
def test_zero_budget_is_bit_identical_to_no_aggregator(games, name, make, m,
                                                       codec_backend):
    _, tg = games
    base = _port_engine(tg, codec_backend, m=m)
    agg = _port_engine(tg, codec_backend, m=m, aggregator=make())
    assert agg._robust is None
    z_b, z_a = base.run(), agg.run()
    for a, b in zip((*z_b, *base.state.z_tilde), (*z_a, *agg.state.z_tilde)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ([r.residual for r in base.trace.rounds]
            == [r.residual for r in agg.trace.rounds])
    assert "aggregator" not in agg.trace.meta


def test_median_beats_the_plain_mean_under_attack(games):
    _, tg = games
    attack = tps.SignFlipAttack(fraction=0.25, scale=8.0, seed=11)
    finals = {}
    for label, agg in (("mean", None), ("median", tps.CoordinateMedian())):
        eng = _port_engine(tg, "fused", rounds=6, byzantine=attack,
                           aggregator=agg)
        eng.run()
        finals[label] = eng.trace.rounds[-1].residual
    assert finals["median"] < finals["mean"]
