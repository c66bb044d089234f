"""Sampled-client rounds in the port (``repro_torch.ps.ClientSampler``,
``make_sampled_chunk``, ``PSEngine`` and ``AsyncPSEngine`` with
``sampler=``) against the JAX package, from one seed, at
``tests/test_fleet.py``'s size (n=10, K=3, R=6), and their invariants
within the port.

Bars. The sampler's tables are the same numpy draws in both packages, so
they, the fingerprints and every host-side record (the drawn ids, the
per-lane local steps and aliveness, bytes, the attackers, the meta, and
the async engine's simulated times and staleness) are equal exactly.
Residual traces, the fleet state and z̄ agree at rtol 1e-5 / atol 1e-6
(ROADMAP C3); error-feedback residuals under the ×8 sign-flip attack take
atol 1e-5, as in ``test_torch_server_opt.py``. Within the port, bit for
bit: a rerun, a resume, spans and metrics off, ``sample == fleet``
against ``sampler=None``, and the rows of undrawn workers across a round.

G₀ is n = 10, near the game's gradient bound, as on the card (ROADMAP
C4). ``test_fleet.py`` runs G₀ = 1, where a worker drawn for the first
time starts at η = D/G₀ = 2, far past the Lipschitz step, from an anchor
merged over lanes whose η differ: its three steps grow the anchor's
last-ulp difference between the packages (6e-8) about thirtyfold, and
later rounds carry that on, so the final states differ by up to 1e-4
while the residual traces still agree at rtol 1e-5. That configuration
is held on its traces and host records
(``test_g0_one_traces_match_jax``).

The outer optimizer runs Nesterov at fleet 8 / sample 4. With Adam, a
fleet of 6 would make the JAX package's first Δ partly rounding noise
(its anchor is ``jnp.mean``, the port's the merge itself: ROADMAP C6(b)),
which Adam's normalised step turns into moves of ±lr; Nesterov's step is
linear in Δ, so the two packages stay within the bar.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro import ps as jps
from repro.core import AdaSEGConfig as JaxCfg
from repro.problems import make_bilinear_game as jax_game
from repro_torch import interop
from repro_torch import ps as tps
from repro_torch import random as jr
from repro_torch.checkpoint import serialize as ser
from repro_torch.core import AdaSEGConfig
from repro_torch.obs import MetricsRegistry, SpanTracer

N, K, R = 10, 3, 6
CFG = dict(g0=float(N), diameter=2.0, alpha=1.0, k=K)
TOL = dict(rtol=1e-5, atol=1e-6)
EF_TOL = dict(rtol=1e-5, atol=1e-5)
CODEC_BACKENDS = ("reference", "fused")

# Each case: (fleet, sample, PSConfig fields) for either package.
CASES = {
    "plain": lambda mod: (10, 4, {}),
    "stragglers_faults_q8": lambda mod: (10, 4, dict(
        schedule=mod.StragglerSchedule(k=K, min_frac=0.4, seed=2,
                                       slow_workers=(1, 7)),
        faults=mod.BernoulliFaults(p=0.2, seed=3),
        compressor=mod.StochasticQuantizeCompressor(bits=8))),
    "signflip_trimmed": lambda mod: (8, 4, dict(
        byzantine=mod.SignFlipAttack(fraction=0.5, scale=8.0, seed=5),
        aggregator=mod.TrimmedMean(beta=0.25))),
    "nesterov": lambda mod: (8, 4, dict(
        server_opt=mod.ServerNesterov(lr=1.0, beta=0.3))),
}


@pytest.fixture(scope="module")
def games():
    jg = jax_game(jax.random.PRNGKey(0), n=N, sigma=0.1)
    tg = interop.game_from_numpy(np.asarray(jg.a), np.asarray(jg.b),
                                 np.asarray(jg.c), 0.1, device="cpu")
    return jg, tg


def _config(mod, case, *, seed=1, sample=None, rounds=R, g0=CFG["g0"],
            **extra):
    fleet, s, kw = CASES[case](mod)
    cfg = (JaxCfg if mod is jps else AdaSEGConfig)(**{**CFG, "g0": g0})
    sampler = mod.ClientSampler(sample=sample or s, seed=seed)
    fields = dict(adaseg=cfg, num_workers=fleet, rounds=rounds,
                  sampler=sampler, **kw)
    fields.update(extra)
    return mod.PSConfig(**fields)


def _jax_engine(jg, case, problem=None, **extra):
    return jps.PSEngine(problem or jg.problem, _config(jps, case, **extra),
                        rng=jax.random.PRNGKey(2), eval_fn=jg.residual)


def _port_engine(tg, case, problem=None, eng_kw=None, **extra):
    return tps.PSEngine(problem or tg.problem, _config(tps, case, **extra),
                        rng=jr.PRNGKey(2, device="cpu"), eval_fn=tg.residual,
                        device="cpu", **(eng_kw or {}))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _host(eng):
    """Every host-side field of every record."""
    return [(r.round, r.local_steps, r.alive, r.bytes_up, r.bytes_down,
             r.sampled_workers, r.byzantine_workers, r.sim_time_s,
             r.staleness, r.idle_frac, r.outer_lr is None)
            for r in eng.trace.rounds]


def _leaves(tree):
    return [x for x in ser.tree_flatten(tree) if isinstance(x, torch.Tensor)]


def _bitwise(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _assert_same_run(a, b):
    """Two port sync engines' runs to the bit: store, EF, srv, trace."""
    _bitwise(_leaves(a.state), _leaves(b.state))
    _bitwise(_leaves(a._ef), _leaves(b._ef))
    _bitwise(_leaves(a._srv), _leaves(b._srv))
    _bitwise(a.z_bar(), b.z_bar())
    assert ([r.residual for r in a.trace.rounds]
            == [r.residual for r in b.trace.rounds])
    assert _host(a) == _host(b)


def _assert_matches_jax(te, je, ef_tol=TOL):
    assert _host(te) == _host(je)
    assert te.trace.meta == je.trace.meta
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in je.trace.rounds])
    for f in ("eta_min", "eta_max", "eta_mean"):
        _close([getattr(r, f) for r in te.trace.rounds],
               [getattr(r, f) for r in je.trace.rounds])
    for f in ("z_tilde", "z_bar"):
        for a, b in zip(getattr(te.state, f), getattr(je.state, f)):
            _close(a, b)
    _close(te.state.sum_sq, je.state.sum_sq)
    np.testing.assert_array_equal(te.state.t.numpy(),
                                  np.asarray(je.state.t))
    np.testing.assert_array_equal(te.state.worker_id.numpy(),
                                  np.asarray(je.state.worker_id))
    for a, b in zip(te._ef, jax.tree.leaves(je._ef)):
        _close(a, b, **ef_tol)
    for a, b in zip(te.z_bar(), je.z_bar()):
        _close(a, b)


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

SAMPLERS = [
    (dict(sample=4, seed=1), 10, 6),
    (dict(sample=3, seed=7), 6, 9),
    (dict(sample=64, seed=3), 10000, 5),
    (dict(sample=5, seed=5), 5, 3),
    (dict(sample=2, seed=0, weights=(1.0, 2.0, 4.0, 8.0, 0.0, 0.5)), 6, 40),
    (dict(sample=1, seed=9, weights=(0.1, 0.2, 0.3)), 3, 50),
]


@pytest.mark.parametrize("kw,fleet,rounds", SAMPLERS)
def test_sampler_tables_match_jax(kw, fleet, rounds):
    ours, theirs = tps.ClientSampler(**kw), jps.ClientSampler(**kw)
    assert (ours.name, ours.fingerprint) == (theirs.name, theirs.fingerprint)
    d = ours.draws(fleet, rounds)
    assert d.dtype == np.int32 and d.shape == (rounds, kw["sample"])
    np.testing.assert_array_equal(d, theirs.draws(fleet, rounds))
    assert (np.diff(d, axis=1) > 0).all()
    p = ours.participation(fleet, rounds)
    np.testing.assert_array_equal(p, theirs.participation(fleet, rounds))
    assert (p.sum(axis=1) == kw["sample"]).all()


@pytest.mark.parametrize("make,match", [
    (lambda mod: mod.ClientSampler(sample=0), "sample"),
    (lambda mod: mod.ClientSampler(sample=9).draws(4, 2), "exceeds fleet"),
    (lambda mod: mod.ClientSampler(sample=1, weights=(-1.0, 1.0)),
     "weights"),
    (lambda mod: mod.ClientSampler(sample=1, weights=(0.0, 0.0)),
     "weights"),
    (lambda mod: mod.ClientSampler(sample=1, weights=(1.0, 2.0)).draws(3, 1),
     "weights has length"),
])
def test_sampler_validation_matches_jax(make, match):
    for mod in (jps, tps):
        with pytest.raises(ValueError, match=match) as err:
            make(mod)
        if mod is jps:
            theirs = str(err.value)
        else:
            assert str(err.value) == theirs


def test_sampler_fingerprints_tell_laws_apart():
    fps = {tps.ClientSampler(**kw).fingerprint
           for kw in (dict(sample=3, seed=1), dict(sample=3, seed=9),
                      dict(sample=4, seed=1),
                      dict(sample=3, seed=1, weights=(1.0, 1.0, 2.0)))}
    assert len(fps) == 4


# ---------------------------------------------------------------------------
# The sync engine against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec_backend", CODEC_BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_sampled_engine_matches_jax(games, case, codec_backend):
    jg, tg = games
    je = _jax_engine(jg, case, codec_backend=codec_backend)
    te = _port_engine(tg, case, codec_backend=codec_backend)
    je.run()
    te.run()
    _assert_matches_jax(te, je, EF_TOL if case == "signflip_trimmed"
                        else TOL)
    fleet, sample, _ = CASES[case](tps)
    draws = te.sampler.draws(fleet, R)
    for r, rec in enumerate(te.trace.rounds):
        assert rec.sampled_workers == draws[r].tolist()
        assert len(rec.local_steps) == len(rec.alive) == sample
        if rec.byzantine_workers is not None:
            assert set(rec.byzantine_workers) <= set(rec.sampled_workers)
    if case == "nesterov":
        # ONE global outer clock: t advances once a round, not per lane
        assert int(te._srv[2]) == int(je._srv[2]) == R
        for a, b in zip(te._srv[0], je._srv[0]):
            _close(a, b)
        _close([r.delta_norm for r in te.trace.rounds],
               [r.delta_norm for r in je.trace.rounds])
    if case == "signflip_trimmed":
        assert any(rec.byzantine_workers for rec in te.trace.rounds)


@pytest.mark.parametrize("codec_backend", CODEC_BACKENDS)
@pytest.mark.parametrize("case", ["plain", "stragglers_faults_q8"])
def test_g0_one_traces_match_jax(games, case, codec_backend):
    """``test_fleet.py``'s own G₀ = 1: traces at rtol 1e-5 / atol 1e-6 and
    every host record exactly (the states are not held: see above)."""
    jg, tg = games
    je = _jax_engine(jg, case, g0=1.0, codec_backend=codec_backend)
    te = _port_engine(tg, case, g0=1.0, codec_backend=codec_backend)
    je.run()
    te.run()
    assert _host(te) == _host(je)
    assert te.trace.meta == je.trace.meta
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in je.trace.rounds])
    for f in ("eta_min", "eta_max", "eta_mean"):
        _close([getattr(r, f) for r in te.trace.rounds],
               [getattr(r, f) for r in je.trace.rounds])


def test_sampled_plain_smoke_and_ledger(games):
    _, tg = games
    te = _port_engine(tg, "plain")
    te.run()
    assert te.trace.meta["sampler"] == "sample4-uniform-seed1"
    assert te.trace.meta["sample"] == 4 and te.trace.meta["workers"] == 10
    assert all(rec.local_steps == [K] * 4 for rec in te.trace.rounds)
    assert te.trace.total_steps == R * 4 * K
    # Line 14 over the fleet: workers never drawn weigh nothing in z̄
    drawn = np.unique(te.sampler.draws(10, R))
    assert te._eff_steps.sum(axis=0)[drawn].min() > 0
    assert (np.delete(te._eff_steps.sum(axis=0), drawn) == 0).all()


def test_heterogeneous_lanes_draw_as_their_fleet_workers(games):
    """The gathered ``worker_id`` keeps the fleet ids, so a heterogeneous
    oracle draws for a lane as it would for that fleet worker: the sampled
    run agrees with the JAX package's on Dirichlet-shifted workers."""
    jg, tg = games
    jp = jps.heterogeneous_bilinear(jg, 10, jax.random.PRNGKey(7),
                                    alpha=0.4)
    tp = tps.heterogeneous_bilinear(tg, 10, jr.PRNGKey(7, device="cpu"),
                                    alpha=0.4)
    je = _jax_engine(jg, "plain", problem=jp)
    te = _port_engine(tg, "plain", problem=tp)
    je.run()
    te.run()
    _assert_matches_jax(te, je)
    # and a homogeneous run differs: the shifts reach the drawn lanes
    plain = _port_engine(tg, "plain")
    plain.run()
    assert ([r.residual for r in plain.trace.rounds]
            != [r.residual for r in te.trace.rounds])


# ---------------------------------------------------------------------------
# The async engine against the JAX package
# ---------------------------------------------------------------------------

def _async_config(mod, tau, **extra):
    cfg = (JaxCfg if mod is jps else AdaSEGConfig)(**CFG)
    fields = dict(
        adaseg=cfg, num_workers=8, rounds=R,
        sampler=mod.ClientSampler(sample=3, seed=1),
        latency=mod.ConstantLatency(step_s=1.0, up_s=0.2, down_s=0.1),
        staleness_bound=tau)
    fields.update(extra)
    return mod.AsyncPSConfig(**fields)


def _jax_async(jg, tau, **extra):
    return jps.AsyncPSEngine(jg.problem, _async_config(jps, tau, **extra),
                             rng=jax.random.PRNGKey(2), eval_fn=jg.residual)


def _port_async(tg, tau, eng_kw=None, **extra):
    return tps.AsyncPSEngine(tg.problem, _async_config(tps, tau, **extra),
                             rng=jr.PRNGKey(2, device="cpu"),
                             eval_fn=tg.residual, device="cpu",
                             **(eng_kw or {}))


def _assert_same_async(a, b):
    _bitwise(_leaves(a.state), _leaves(b.state))
    _bitwise(_leaves(a._ef), _leaves(b._ef))
    _bitwise(a._srv_payload, b._srv_payload)
    _bitwise(a.z_bar(), b.z_bar())
    assert [dataclasses.asdict(r) for r in a.trace.rounds] == [
        dataclasses.asdict(r) for r in b.trace.rounds]
    assert a.sim_time == b.sim_time and a.n_admissions == b.n_admissions


@pytest.mark.parametrize("codec_backend", CODEC_BACKENDS)
@pytest.mark.parametrize("tau", [math.inf, 2.0])
def test_sampled_async_matches_jax(games, tau, codec_backend):
    """Undrawn rounds cost no simulated time and no record, the staleness
    gate does not deadlock on them, and Σ local_steps is the sampled work;
    every host record and the clock equal the JAX engine's."""
    jg, tg = games
    je = _jax_async(jg, tau, codec_backend=codec_backend)
    te = _port_async(tg, tau, codec_backend=codec_backend)
    jz = je.run()
    tz = te.run()
    assert te.done and je.done
    assert _host(te) == _host(je)
    assert te.sim_time == je.sim_time
    assert te.n_admissions == je.n_admissions
    assert te.idle_fraction() == je.idle_fraction()
    assert te.trace.meta == je.trace.meta
    assert te.trace.meta["sampler"] == "sample3-uniform-seed1"
    assert te.trace.total_steps == R * 3 * K
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in je.trace.rounds])
    for a, b in zip(tz, jax.tree.leaves(jz)):
        _close(a, b)
    for a, b in zip(te.state.z_tilde, je.state.z_tilde):
        _close(a, b)
    # a worker's uplinks are exactly its drawn rounds
    part = te.sampler.participation(8, R)
    sent = np.zeros(8, int)
    for rec in te.trace.rounds:
        sent += np.asarray(rec.alive, int)
    np.testing.assert_array_equal(sent, part.sum(axis=0))


def test_sampled_async_never_takes_the_lockstep_chunk(games):
    """Even where every worker is drawn (sample == fleet) at τ=0, the
    sampled async engine runs its per-arrival path, as the JAX one does."""
    jg, tg = games
    te = _port_async(tg, 0.0, sampler=tps.ClientSampler(sample=8, seed=1))
    je = _jax_async(jg, 0.0, sampler=jps.ClientSampler(sample=8, seed=1))
    assert te._lockstep_chunk is None
    te.run()
    je.run()
    assert _host(te) == _host(je)
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in je.trace.rounds])


# ---------------------------------------------------------------------------
# Checkpoints across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "stragglers_faults_q8",
                                  "nesterov"])
def test_jax_sampled_checkpoint_restores_into_the_port(games, tmp_path,
                                                       case):
    jg, tg = games
    whole = _jax_engine(jg, case)
    whole.run()
    part = _jax_engine(jg, case)
    part.run(until_round=3)
    path = str(tmp_path / "ck")
    part.save(path)
    te = _port_engine(tg, case).restore(path)
    assert te.round == 3 and te.trace.rounds == []
    z_t = te.run()
    assert _host(te) == _host(whole)[3:]
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in whole.trace.rounds[3:]])
    for a, b in zip(z_t, whole.z_bar()):
        _close(a, b)


@pytest.mark.parametrize("case", ["plain", "stragglers_faults_q8",
                                  "nesterov"])
def test_port_sampled_checkpoint_loads_into_jax(games, tmp_path, case):
    jg, tg = games
    whole = _port_engine(tg, case)
    whole.run()
    part = _port_engine(tg, case)
    part.run(until_round=3)
    path = str(tmp_path / "ck")
    part.save(path)
    tree = part._ckpt_tree()
    assert tree["sampler_fp"].dtype == np.uint32
    assert int(tree["sampler_fp"]) == part.sampler.fingerprint
    je = _jax_engine(jg, case).restore(path)
    assert je.round == 3
    je.run()
    assert _host(je) == _host(whole)[3:]
    _close([r.residual for r in je.trace.rounds],
           [r.residual for r in whole.trace.rounds[3:]])


def test_sampled_async_checkpoints_cross_both_ways(games, tmp_path):
    """The async layout has no sampler fingerprint in either package: a
    checkpoint taken mid-queue in one finishes in the other."""
    jg, tg = games
    jwhole, twhole = _jax_async(jg, 2.0), _port_async(tg, 2.0)
    jwhole.run()
    twhole.run()
    for src, dst, whole in (("jax", "port", jwhole), ("port", "jax", twhole)):
        part = _jax_async(jg, 2.0) if src == "jax" else _port_async(tg, 2.0)
        part.run(until_admissions=3)
        assert not part.done
        path = str(tmp_path / f"{src}.ckpt")
        part.save(path)
        eng = (_port_async(tg, 2.0) if dst == "port"
               else _jax_async(jg, 2.0)).restore(path)
        eng.run()
        assert _host(eng) == _host(whole)[3:]
        assert eng.sim_time == whole.sim_time
        _close([r.residual for r in eng.trace.rounds],
               [r.residual for r in whole.trace.rounds[3:]])


def test_restore_refuses_another_sampler_or_layout(games, tmp_path):
    _, tg = games
    path = str(tmp_path / "ck")
    eng = _port_engine(tg, "plain")
    eng.run(until_round=2)
    eng.save(path)
    with pytest.raises(ValueError, match="sampler"):
        _port_engine(tg, "plain", seed=9).restore(path)
    with pytest.raises(ValueError):
        _port_engine(tg, "plain", sampler=None).restore(path)
    dense_path = str(tmp_path / "dense")
    _port_engine(tg, "plain", sampler=None).save(dense_path)
    with pytest.raises(ValueError):
        _port_engine(tg, "plain").restore(dense_path)


# ---------------------------------------------------------------------------
# Bit-identity within the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec_backend", CODEC_BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_rerun_and_resume_are_bit_identical(games, tmp_path, case,
                                            codec_backend):
    _, tg = games
    whole = _port_engine(tg, case, codec_backend=codec_backend)
    whole.run()
    again = _port_engine(tg, case, codec_backend=codec_backend)
    again.run()
    _assert_same_run(whole, again)
    part = _port_engine(tg, case, codec_backend=codec_backend)
    part.run(until_round=2)
    path = str(tmp_path / "ck")
    part.save(path)
    resumed = _port_engine(tg, case, codec_backend=codec_backend)
    resumed.restore(path).run()
    _bitwise(_leaves(resumed.state), _leaves(whole.state))
    _bitwise(_leaves(resumed._ef), _leaves(whole._ef))
    _bitwise(_leaves(resumed._srv), _leaves(whole._srv))
    assert _host(resumed) == _host(whole)[2:]
    assert ([r.residual for r in resumed.trace.rounds]
            == [r.residual for r in whole.trace.rounds[2:]])


def test_spans_and_metrics_off_are_bit_identical(games):
    _, tg = games
    kw = dict(codec_backend="fused")
    on = _port_engine(tg, "stragglers_faults_q8", **kw)
    off = _port_engine(tg, "stragglers_faults_q8", eng_kw=dict(
        tracer=SpanTracer(enabled=False),
        metrics=MetricsRegistry(enabled=False)), **kw)
    on.run()
    off.run()
    _assert_same_run(on, off)
    assert on.tracer.spans and on.metrics.records
    assert not off.tracer.spans and not off.metrics.records
    rounds = [sp for sp in on.tracer.spans if sp.cat == "round"]
    assert [sp.attrs["sampled_workers"] for sp in rounds] == [
        r.sampled_workers for r in on.trace.rounds]


@pytest.mark.parametrize("codec_backend", CODEC_BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_full_sample_is_bit_identical_to_no_sampler(games, case,
                                                    codec_backend):
    """``sample == fleet`` gathers every row in order, runs the serial
    chunk's own round on it, and writes it back: the same numbers as
    ``sampler=None``, to the bit."""
    _, tg = games
    fleet, _, _ = CASES[case](tps)
    full = _port_engine(tg, case, sample=fleet, codec_backend=codec_backend)
    dense = _port_engine(tg, case, sampler=None, codec_backend=codec_backend)
    full.run()
    dense.run()
    _bitwise(_leaves(full.state), _leaves(dense.state))
    _bitwise(_leaves(full._ef), _leaves(dense._ef))
    _bitwise(_leaves(full._srv), _leaves(dense._srv))
    _bitwise(full.z_bar(), dense.z_bar())
    for a, b in zip(full.trace.rounds, dense.trace.rounds):
        assert a.sampled_workers == list(range(fleet))
        assert (a.residual, a.eta_min, a.eta_max, a.eta_mean, a.local_steps,
                a.alive, a.bytes_up, a.byzantine_workers, a.delta_norm) == (
            b.residual, b.eta_min, b.eta_max, b.eta_mean, b.local_steps,
            b.alive, b.bytes_up, b.byzantine_workers, b.delta_norm)


@pytest.mark.parametrize("case", list(CASES))
def test_undrawn_rows_stay_frozen(games, case):
    """Round by round: the store rows (state and error feedback) of every
    worker not drawn are bit-identical before and after the round, and the
    drawn rows are written in place into the same tensors."""
    _, tg = games
    eng = _port_engine(tg, case, codec_backend="fused")
    fleet = eng.config.num_workers
    store = _leaves((eng.state, eng._ef))
    for r in range(R):
        before = [v.clone() for v in _leaves((eng.state, eng._ef))]
        eng.step_round()
        after = _leaves((eng.state, eng._ef))
        assert all(a is b for a, b in zip(after, store))
        undrawn = np.setdiff1d(np.arange(fleet), eng._draws[r])
        rows = torch.as_tensor(undrawn)
        for b, a in zip(before, after):
            torch.testing.assert_close(a[rows], b[rows], rtol=0, atol=0)
        moved = [bool((a[torch.as_tensor(eng._draws[r], dtype=torch.long)]
                       != b[torch.as_tensor(eng._draws[r],
                                            dtype=torch.long)]).any())
                 for b, a in zip(before, after)]
        assert any(moved)


def test_shared_init_leaves_are_written_apart(games):
    """An optimizer's init may give two fields one tensor (the zoo's Adam
    hands its two moment trees the same zeros); the sampled engine parts
    them before it writes rows in place, and still matches the JAX
    package's run."""
    from repro.optim import MinimaxWorker as JaxMinimaxWorker
    from repro.optim import adam_minimax as jax_adam
    from repro_torch.optim import MinimaxWorker, adam_minimax

    jg, tg = games
    je = jps.PSEngine(jg.problem, jps.PSConfig(
        worker=JaxMinimaxWorker(jax_adam(0.05)), local_k=K, num_workers=6,
        rounds=R, sampler=jps.ClientSampler(sample=3, seed=4)),
        rng=jax.random.PRNGKey(2), eval_fn=jg.residual)
    te = tps.PSEngine(tg.problem, tps.PSConfig(
        worker=MinimaxWorker(adam_minimax(0.05)), local_k=K, num_workers=6,
        rounds=R, sampler=tps.ClientSampler(sample=3, seed=4)),
        rng=jr.PRNGKey(2, device="cpu"), eval_fn=tg.residual, device="cpu")
    ptrs = [v.untyped_storage().data_ptr() for v in _leaves(te.state)]
    assert len(set(ptrs)) == len(ptrs)
    je.run()
    te.run()
    assert _host(te) == _host(je)
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in je.trace.rounds])
    for a, b in zip(_leaves(te.state), jax.tree.leaves(je.state)):
        _close(a, b)


@pytest.mark.parametrize("tau", [math.inf, 2.0])
def test_sampled_async_rerun_resume_spans_off_bit_identical(games, tmp_path,
                                                            tau):
    _, tg = games
    kw = dict(codec_backend="fused",
              compressor=tps.StochasticQuantizeCompressor(bits=8))
    first = _port_async(tg, tau, **kw)
    first.run()
    again = _port_async(tg, tau, **kw)
    again.run()
    _assert_same_async(first, again)
    part = _port_async(tg, tau, **kw)
    part.run(until_admissions=3)
    path = str(tmp_path / "ck")
    part.save(path)
    resumed = _port_async(tg, tau, **kw).restore(path)
    resumed.run()
    _bitwise(_leaves(resumed.state), _leaves(first.state))
    _bitwise(_leaves(resumed._ef), _leaves(first._ef))
    assert resumed.sim_time == first.sim_time
    assert [dataclasses.asdict(r) for r in resumed.trace.rounds] == [
        dataclasses.asdict(r) for r in first.trace.rounds[3:]]
    off = _port_async(tg, tau, eng_kw=dict(
        tracer=SpanTracer(enabled=False),
        metrics=MetricsRegistry(enabled=False)), **kw)
    off.run()
    _assert_same_async(first, off)
    assert not off.tracer.spans and not off.metrics.records
