"""The port's event-driven async Parameter-Server (``repro_torch.ps.
AsyncPSEngine`` and the ``latency`` models) against the JAX package's, from
one seed, at ``tests/test_ps_async.py``'s size (M=4, n=10, R=6, K=5), and
its invariants within the port.

Bars. Everything the event machine computes on the host (simulated times,
staleness, aliveness, local steps, bytes, idle fractions, the admission
sequence, the latency tables) equals the JAX engine's exactly: both run
the same float64 numpy. Traces, η statistics, z̄, the fleet state and the
error-feedback residuals agree at rtol 1e-5 / atol 1e-6, the engines'
bar (the packages differ in f32 sum order and erfinv ulps, ROADMAP C3),
but the error-feedback residuals take atol 1e-5: an async residual is the
unweighted payload less its quantisation (~1e-3), so its absolute error
is the payload's, whose bar is rtol 1e-5 on entries up to 1 (the box).
(The sync engine weights the message by w ≈ 1/M first.)
Within the port, bit for bit: τ=0 and worker-equal latency against the
port's ``PSEngine`` (clean, robust, outer optimizer), a multi-hot phase
batch against the same phases one at a time, the two codec backends, a
rerun, a resume mid-event-queue, and spans and metrics off.

The outer optimizer's anchor is the port's (ROADMAP C6(b)); at M=4 its
first Δ against the JAX package's ``jnp.mean`` anchor is 0 in both.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro import ps as jps
from repro.core import AdaSEGConfig as JaxCfg
from repro.optim import MinimaxWorker as JaxMinimaxWorker
from repro.optim import adam_minimax as jax_adam
from repro.optim import segda as jax_segda
from repro.problems import make_bilinear_game as jax_game
from repro_torch import interop
from repro_torch import ps as tps
from repro_torch import random as jr
from repro_torch.checkpoint import serialize as ser
from repro_torch.core import AdaSEGConfig
from repro_torch.obs import MetricsRegistry, SpanTracer
from repro_torch.optim import MinimaxWorker, adam_minimax, segda

M, R, K, N = 4, 6, 5, 10
CFG = dict(g0=1.0, diameter=2.0, alpha=1.0, k=K)
TOL = dict(rtol=1e-5, atol=1e-6)
EF_TOL = dict(rtol=1e-5, atol=1e-5)


def _straggler(mod):
    return mod.ConstantLatency(step_s=(1.0, 1.0, 1.0, 6.0), up_s=0.2,
                               down_s=0.1)


def _hostile(mod):
    return dict(byzantine=mod.SignFlipAttack(fraction=0.25, scale=8.0,
                                             seed=11),
                aggregator=mod.TrimmedMean(beta=0.25),
                dp=mod.DPUplink(clip=2.0, sigma=1e-3))


# Each case: (τ, latency, PSConfig fields, worker) for either package.
CASES = {
    "tau0": lambda mod: (0.0, _straggler(mod), {}, None),
    "tau2": lambda mod: (2.0, _straggler(mod), {}, None),
    "tauinf": lambda mod: (math.inf, _straggler(mod), {}, None),
    "markov": lambda mod: (2.0, mod.MarkovLatency(
        step_s=1.0, slow_factor=6.0, p_slow=0.2, p_recover=0.4, up_s=0.3,
        down_s=0.2, seed=5, start_slow=(1,)), {}, None),
    "faults": lambda mod: (2.0, _straggler(mod),
                           dict(faults=mod.BernoulliFaults(p=0.2, seed=3)),
                           None),
    "q8_ef": lambda mod: (2.0, _straggler(mod), dict(
        compressor=mod.StochasticQuantizeCompressor(bits=8)), None),
    "robust_dp": lambda mod: (2.0, _straggler(mod), _hostile(mod), None),
    "nesterov": lambda mod: (2.0, _straggler(mod), dict(
        server_opt=mod.ServerNesterov(lr=1.0, beta=0.3)), None),
    "adam": lambda mod: (math.inf, _straggler(mod), dict(
        server_opt=mod.ServerAdam(lr=0.5)), None),
    "segda": lambda mod: (2.0, _straggler(mod), {}, "segda"),
    "adam_worker": lambda mod: (2.0, _straggler(mod), {}, "adam"),
}


@pytest.fixture(scope="module")
def games():
    jg = jax_game(jax.random.PRNGKey(0), n=N, sigma=0.1)
    tg = interop.game_from_numpy(np.asarray(jg.a), np.asarray(jg.b),
                                 np.asarray(jg.c), 0.1, device="cpu")
    return jg, tg


def _worker_kw(mod, worker):
    if worker is None:
        cfg = (JaxCfg if mod is jps else AdaSEGConfig)(**CFG)
        return dict(adaseg=cfg)
    if mod is jps:
        opt = {"segda": jax_segda, "adam": jax_adam}[worker](0.05)
        return dict(worker=JaxMinimaxWorker(opt), local_k=K)
    opt = {"segda": segda, "adam": adam_minimax}[worker](0.05)
    return dict(worker=MinimaxWorker(opt), local_k=K)


def _config(mod, case, rounds=R, **extra):
    tau, lat, kw, worker = CASES[case](mod)
    fields = dict(num_workers=M, rounds=rounds, latency=lat,
                  staleness_bound=tau, **_worker_kw(mod, worker), **kw)
    fields.update(extra)
    return mod.AsyncPSConfig(**fields)


def _jax_engine(jg, case, **extra):
    return jps.AsyncPSEngine(jg.problem, _config(jps, case, **extra),
                             rng=jax.random.PRNGKey(2), eval_fn=jg.residual)


def _port_engine(tg, case, *, seed=2, eng_kw=None, **extra):
    return tps.AsyncPSEngine(tg.problem, _config(tps, case, **extra),
                             rng=jr.PRNGKey(seed, device="cpu"),
                             eval_fn=tg.residual, device="cpu",
                             **(eng_kw or {}))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _host(eng):
    """Every host-side field of every record."""
    return [(r.round, r.local_steps, r.alive, r.bytes_up, r.bytes_down,
             r.sim_time_s, r.staleness, r.idle_frac, r.byzantine_workers,
             r.outer_lr is None)
            for r in eng.trace.rounds]


def _leaves(tree):
    return [x for x in ser.tree_flatten(tree) if isinstance(x, torch.Tensor)]


def _bitwise(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _assert_same_run(a, b):
    """Two port engines' runs to the bit: state, EF, table, trace."""
    _bitwise(_leaves(a.state), _leaves(b.state))
    _bitwise(_leaves(a._ef), _leaves(b._ef))
    _bitwise(a._srv_payload, b._srv_payload)
    _bitwise(a.z_bar(), b.z_bar())
    assert [dataclasses.asdict(r) for r in a.trace.rounds] == [
        dataclasses.asdict(r) for r in b.trace.rounds]
    assert a.sim_time == b.sim_time and a.n_admissions == b.n_admissions


# ---------------------------------------------------------------------------
# Latency models
# ---------------------------------------------------------------------------

LATENCIES = {
    "constant": lambda mod: mod.ConstantLatency(step_s=(1., 2., 1., 3.),
                                                up_s=0.5),
    "lognormal": lambda mod: mod.LognormalLatency(
        step_s=1.0, sigma=0.7, up_s=0.1, net_sigma=0.3, seed=11),
    "markov": lambda mod: mod.MarkovLatency(
        step_s=1.0, slow_factor=8.0, p_slow=0.2, p_recover=0.3, seed=12,
        start_slow=(1,)),
    "trace": lambda mod: mod.TraceLatency(
        step_s=[[1., 2., 1., 4.], [2., 1., 1., 1.]], up_s=0.3),
}


@pytest.mark.parametrize("name", list(LATENCIES))
def test_latency_tables_equal_jax(name):
    ours = LATENCIES[name](tps).tables(4, 9)
    theirs = LATENCIES[name](jps).tables(4, 9)
    for f in ("step_s", "up_s", "down_s"):
        got, want = getattr(ours, f), getattr(theirs, f)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    again = LATENCIES[name](tps).tables(4, 9)
    np.testing.assert_array_equal(again.step_s, ours.step_s)


def test_latency_validation_matches_jax():
    for mod in (jps, tps):
        with pytest.raises(ValueError):
            mod.TraceLatency(step_s=[[1., 2., 3.]]).tables(2, 4)
        with pytest.raises(ValueError):
            mod.ConstantLatency(step_s=(1.0, -1.0)).tables(2, 1)
        with pytest.raises(ValueError):
            mod.ConstantLatency(step_s=(1.0, 2.0, 3.0)).tables(2, 1)


# ---------------------------------------------------------------------------
# Against the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_async_engine_matches_jax(games, case):
    jg, tg = games
    je, te = _jax_engine(jg, case), _port_engine(tg, case)
    z_j, z_t = je.run(), te.run()
    assert _host(te) == _host(je)
    assert te.sim_time == je.sim_time
    assert te.n_admissions == je.n_admissions
    assert te.idle_fraction() == je.idle_fraction()
    assert int(te._steps_cum.sum()) == int(np.asarray(je._steps_cum).sum())
    for key in ("latency", "staleness_bound", "staleness_discount",
                "compressor", "faults", "execution", "optimizer"):
        assert te.trace.meta[key] == je.trace.meta[key], key
    tr, jr_ = te.trace.rounds, je.trace.rounds
    _close([r.residual for r in tr], [r.residual for r in jr_])
    for f in ("eta_min", "eta_max", "eta_mean"):
        _close([getattr(r, f) for r in tr], [getattr(r, f) for r in jr_])
    if tr[0].outer_lr is not None or jr_[0].outer_lr is not None:
        _close([r.delta_norm for r in tr[:-1]],
               [r.delta_norm for r in jr_[:-1]])
    for a, b in zip(z_t, jax.tree.leaves(z_j)):
        _close(a, b)
    state_t, state_j = _leaves(te.state), jax.tree.leaves(je.state)
    assert len(state_t) == len(state_j)
    for a, b in zip(state_t, state_j):
        _close(a, b)
    ef_t, ef_j = _leaves(te._ef), jax.tree.leaves(je._ef)
    assert len(ef_t) == len(ef_j)
    for a, b in zip(ef_t, ef_j):
        _close(a, b, **EF_TOL)
    for a, b in zip(te._srv_payload, jax.tree.leaves(je._srv_payload)):
        _close(a, b)


# Equal step times and zero uplink delay: every START spawns a
# same-instant ARRIVE, and workers 0 and 2 (K = 2) tie with each other,
# as 1 and 3 (K = 4) do. The admission sequence, pinned from the JAX
# engine: (sim time, admitted workers).
TIE_SEQUENCE = [
    (0.0, [0, 1, 2, 3]), (2.5, [0, 2]), (4.5, [1, 3]), (5.0, [0, 2]),
    (9.0, [1, 3]), (13.5, [])]


def test_tie_order_pinned(games):
    jg, tg = games

    def cfg(mod):
        return mod.AsyncPSConfig(
            adaseg=(JaxCfg if mod is jps else AdaSEGConfig)(**CFG),
            num_workers=M, rounds=3,
            schedule=mod.FixedSchedule((2, 4, 2, 4)),
            latency=mod.ConstantLatency(step_s=1.0, up_s=0.0,
                                        down_s=(0.5, 0.5, 0.5, 0.5)),
            staleness_bound=math.inf)

    je = jps.AsyncPSEngine(jg.problem, cfg(jps), rng=jax.random.PRNGKey(2))
    te = tps.AsyncPSEngine(tg.problem, cfg(tps),
                           rng=jr.PRNGKey(2, device="cpu"), device="cpu")
    je.run()
    te.run()

    def seq(eng):
        return [(r.sim_time_s, [m for m, a in enumerate(r.alive) if a])
                for r in eng.trace.rounds]

    assert seq(te) == seq(je) == TIE_SEQUENCE
    assert _host(te) == _host(je)


# ---------------------------------------------------------------------------
# Within the port
# ---------------------------------------------------------------------------

LOCKSTEP = {
    "clean": lambda mod: {},
    "robust": lambda mod: dict(
        byzantine=mod.SignFlipAttack(fraction=0.25, scale=8.0, seed=11),
        aggregator=mod.TrimmedMean(beta=0.25)),
    "outer": lambda mod: dict(server_opt=mod.ServerNesterov(lr=1.0,
                                                            beta=0.3)),
}


@pytest.mark.parametrize("codec_backend", ["reference", "fused"])
@pytest.mark.parametrize("latency", ["barrier", "equal"])
@pytest.mark.parametrize("fleet", list(LOCKSTEP))
def test_lockstep_is_bit_identical_to_psengine(games, fleet, latency,
                                               codec_backend):
    """τ=0 under a straggler (a barrier) and worker-equal latency under
    τ=∞: every admission is the whole fleet in one round, so the async
    engine is the port's PSEngine, bit for bit, hostile fleets and outer
    optimizers included (the invariant the JAX package's
    ``test_async_lockstep_robust_parity_bit_exact`` misses at the last
    ulp)."""
    _, tg = games
    # the barrier holds heterogeneous K too; equal latency needs equal K
    kw = dict(LOCKSTEP[fleet](tps), codec_backend=codec_backend,
              schedule=(tps.FixedSchedule((5, 4, 3, 2))
                        if latency == "barrier" else None))
    sync = tps.PSEngine(tg.problem,
                        tps.PSConfig(adaseg=AdaSEGConfig(**CFG),
                                     num_workers=M, rounds=R, **kw),
                        rng=jr.PRNGKey(4, device="cpu"), device="cpu")
    z_sync = sync.run()
    lat, tau = ((_straggler(tps), 0.0) if latency == "barrier" else
                (tps.ConstantLatency(step_s=1.0, up_s=0.5, down_s=0.25),
                 math.inf))
    a = tps.AsyncPSEngine(
        tg.problem,
        tps.AsyncPSConfig(adaseg=AdaSEGConfig(**CFG), num_workers=M,
                          rounds=R, latency=lat, staleness_bound=tau, **kw),
        rng=jr.PRNGKey(4, device="cpu"), device="cpu")
    z_async = a.run()
    assert a.n_admissions == R
    assert all(r.staleness == [0] * M for r in a.trace.rounds[:-1])
    _bitwise(z_sync, z_async)
    _bitwise(_leaves(sync.state), _leaves(a.state))
    if fleet == "outer":
        _bitwise(_leaves(sync._srv), _leaves(a._srv))
        assert ([r.delta_norm for r in sync.trace.rounds]
                == [r.delta_norm for r in a.trace.rounds[:-1]])
    if latency == "equal":
        assert a.sim_time == pytest.approx(R * (K + 0.75))


def test_multi_hot_phase_batch_equals_one_hot(games):
    """Phases of four workers in three different rounds, run as one batch
    and one at a time in any order, give the same fleet to the bit."""
    _, tg = games
    cfg = _config(tps, "tau2")

    def engine():
        e = tps.AsyncPSEngine(tg.problem, cfg,
                              rng=jr.PRNGKey(7, device="cpu"), device="cpu")
        e._ev_round[:] = [1, 3, 1, 2]        # the phases of rounds 0, 2, 0, 1
        return e

    batch = engine()
    batch._run_phases([0, 1, 2, 3])
    single = engine()
    for m in (3, 1, 0, 2):
        single._run_phases([m])
    _bitwise(_leaves(batch.state), _leaves(single.state))
    assert batch._steps_cum.tolist() == single._steps_cum.tolist() == [K] * M
    assert batch.state.t.tolist() == [K] * M
    # each lane took its own round's keys: lanes 0 and 2 (round 0) moved
    # otherwise than lane 1 (round 2) would have from the same state
    fresh = engine()
    fresh._ev_round[:] = [3, 3, 3, 3]
    fresh._run_phases([0])
    assert not torch.equal(fresh.state.z_tilde[0][0],
                           batch.state.z_tilde[0][0])


@pytest.mark.parametrize("case", ["q8_ef", "robust_dp", "nesterov",
                                  "faults"])
def test_codec_backends_agree_bitwise(games, case):
    _, tg = games
    ref = _port_engine(tg, case, codec_backend="reference")
    fused = _port_engine(tg, case, codec_backend="fused")
    ref.run()
    fused.run()
    _assert_same_run(ref, fused)


def _resume_case(mod):
    return dict(
        schedule=mod.StragglerSchedule(k=K, min_frac=0.5, seed=2,
                                       slow_workers=(3,)),
        compressor=mod.StochasticQuantizeCompressor(bits=8),
        faults=mod.BernoulliFaults(p=0.1, seed=3),
        server_opt=mod.ServerAdam(lr=0.5), **_hostile(mod))


def test_rerun_and_resume_mid_queue_are_bit_identical(games, tmp_path):
    """The full hostile stack under Markov latency: a rerun, a run driven
    in chunks of two admissions, and a run killed at admission 4, saved,
    restored into a fresh engine and finished all equal one uninterrupted
    run bit for bit."""
    _, tg = games

    def engine():
        return _port_engine(tg, "markov", rounds=8, codec_backend="fused",
                            **_resume_case(tps))

    whole = engine()
    whole.run()
    again = engine()
    again.run()
    _assert_same_run(whole, again)
    chunked = engine()
    n = 0
    while not chunked.done:
        n += 2
        chunked.run(until_admissions=n)
    _assert_same_run(whole, chunked)
    path = str(tmp_path / "async.ckpt")
    part = engine()
    part.run(until_admissions=4)
    assert not part.done and part.n_admissions == 4
    part.save(path)
    resumed = engine().restore(path)
    resumed.run()
    _bitwise(_leaves(whole.state), _leaves(resumed.state))
    _bitwise(_leaves(whole._ef), _leaves(resumed._ef))
    _bitwise(_leaves(whole._srv), _leaves(resumed._srv))
    _bitwise(whole.z_bar(), resumed.z_bar())
    assert whole.sim_time == resumed.sim_time
    assert [dataclasses.asdict(r) for r in whole.trace.rounds[4:]] == [
        dataclasses.asdict(r) for r in resumed.trace.rounds]


def test_tracing_off_is_bit_identical(games):
    _, tg = games
    kw = dict(codec_backend="fused", **_resume_case(tps))
    on = _port_engine(tg, "tau2", **kw)
    off = _port_engine(tg, "tau2", eng_kw=dict(
        tracer=SpanTracer(enabled=False),
        metrics=MetricsRegistry(enabled=False)), **kw)
    on.run()
    off.run()
    _assert_same_run(on, off)
    assert on.tracer.spans and on.metrics.records
    assert not off.tracer.spans and not off.metrics.records


def test_refusals(games):
    """A negative staleness bound is refused by both packages; a sampler,
    once refused here, now builds a sampled engine that runs to its end,
    with the JAX engine's host records (``test_torch_sampler.py`` holds
    the sampled path in full)."""
    jg, tg = games
    with pytest.raises(ValueError, match="staleness_bound"):
        _jax_engine(jg, "tau2", staleness_bound=-1.0)
    with pytest.raises(ValueError, match="staleness_bound"):
        _port_engine(tg, "tau2", staleness_bound=-1.0)
    te = _port_engine(tg, "tau2", sampler=tps.ClientSampler(sample=2,
                                                            seed=1))
    je = _jax_engine(jg, "tau2", sampler=jps.ClientSampler(sample=2, seed=1))
    te.run()
    je.run()
    assert te.done and te.trace.meta["sample"] == 2
    assert te.trace.total_steps == R * 2 * K
    assert _host(te) == _host(je) and te.sim_time == je.sim_time


def test_default_device_is_the_card(games):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    _, tg = games
    with pytest.raises(RuntimeError):
        tps.AsyncPSEngine(tg.problem, _config(tps, "tau2"),
                          rng=jr.PRNGKey(2, device="cpu"))


def test_example_runs_on_the_cpu(tmp_path, capsys):
    """``examples/torch_ps_simulate.py`` at its sizes: all four acts, both
    resumes bit-exact, both Perfetto files valid."""
    import importlib.util
    import json
    from pathlib import Path

    from repro_torch.obs import validate_trace_events

    path = Path(__file__).resolve().parent.parent / "examples" / \
        "torch_ps_simulate.py"
    spec = importlib.util.spec_from_file_location("torch_ps_simulate", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu", "--trace-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "resumed and finished at round 30" in out
    assert "LocalSEGDA" in out
    assert "bit-exact with the uninterrupted run: True" in out
    assert out.count("bit-exact with the uninterrupted run: True") == 2
    assert "-- hostile: resumed mid-attack" in out
    for name in ("perfetto_sync_wall.json", "perfetto_async_sim.json"):
        validate_trace_events(json.loads((tmp_path / name).read_text()))
