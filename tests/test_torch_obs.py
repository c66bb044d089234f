"""Observability in the port (``repro_torch.obs``): the metrics registry,
the modeled sync cost and its pass model, the Perfetto export, and the
engine's metrics, against the JAX package where both have them.

Bars: the metric records the engine emits equal the JAX engine's (names,
kinds and labels in order; counters exactly; the η spread and ‖Δ‖ at rtol
1e-5, the engines' traces' own bar) but for the measured round wall and
the modeled seconds, which divide by the card's bandwidth in the port
(3.35e12 B/s) and by the TPU's in the JAX package; the trace-event payload
of identical spans equals the JAX package's exactly; the reference column
of the pass model and its bytes equal the JAX package's; the port's fused
column is its own (ROADMAP C19) and pinned here. Spans and metrics on or
off give bit-identical trajectories.
"""
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import ps as jps
from repro.core import AdaSEGConfig as JaxCfg
from repro.kernels.sync_compress.ops import CODEC_PASS_MODEL as JAX_PASSES
from repro.obs.spans import Span as JaxSpan
from repro.problems import make_bilinear_game as jax_game
from repro.problems import make_wgan_problem as jax_wgan
from repro_torch import interop
from repro_torch import ps as tps
from repro_torch import random as jr
from repro_torch.core import AdaSEGConfig
from repro_torch.hardware import HBM_BW
from repro_torch.kernels.sync_compress.ops import CODEC_PASS_MODEL, codec_passes
from repro_torch.obs import (
    MetricsRegistry,
    Span,
    SpanTracer,
    modeled_sync_cost,
    save_trace_events,
    to_trace_events,
    validate_trace_events,
)
from repro_torch.problems import make_bilinear_game, make_wgan_problem

M, R, K = 4, 5, 4
N = 10
CFG = dict(g0=1.0, diameter=2.0, alpha=1.0, k=K)


@pytest.fixture(scope="module")
def game():
    return make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=N, sigma=0.1,
                              device="cpu")


def _engine(game, m=M, rounds=R, **kw):
    cfg_kw = {k: v for k, v in kw.items() if k not in ("tracer", "metrics")}
    eng_kw = {k: v for k, v in kw.items() if k in ("tracer", "metrics")}
    return tps.PSEngine(game.problem,
                        tps.PSConfig(adaseg=AdaSEGConfig(**CFG),
                                     num_workers=m, rounds=rounds, **cfg_kw),
                        rng=jr.PRNGKey(4, device="cpu"),
                        eval_fn=game.residual, device="cpu", **eng_kw)


def _off():
    return dict(tracer=SpanTracer(enabled=False),
                metrics=MetricsRegistry(enabled=False))


def _assert_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# The registry
# ---------------------------------------------------------------------------

def test_metrics_jsonl_roundtrip(tmp_path):
    reg = MetricsRegistry()
    reg.inc("bytes_up", 80.0, engine="sync")
    reg.inc("bytes_up", 40.0, engine="sync")
    reg.set_gauge("eta_spread", 1.25)
    reg.observe("round_wall_s", 0.01, t_sim=3.0, modeled_hbm_passes=11)
    path = tmp_path / "metrics.jsonl"
    reg.save_jsonl(str(path))
    back = MetricsRegistry.load_jsonl(str(path))
    assert back.records == reg.records
    assert back.total("bytes_up") == 120.0
    assert back.last("eta_spread") == 1.25
    assert back.histogram("round_wall_s")["count"] == 1
    assert back.names() == ["bytes_up", "eta_spread", "round_wall_s"]
    # the JAX package's loader reads the port's file, record for record
    assert jobs.MetricsRegistry.load_jsonl(str(path)).records == reg.records


def test_disabled_metrics_record_nothing():
    reg = MetricsRegistry(enabled=False)
    reg.inc("bytes_up", 80.0)
    reg.set_gauge("eta_spread", 2.0)
    reg.observe("round_wall_s", 1.0)
    assert reg.records == [] and reg.total("bytes_up") == 0.0
    assert reg.last("eta_spread") is None
    assert reg.histogram("round_wall_s") == {"count": 0}


# ---------------------------------------------------------------------------
# The pass model and the modeled cost
# ---------------------------------------------------------------------------

def test_fused_pass_counts_are_the_ports_kernels():
    """The fused column counts the port's sync kernels, a read or a write
    of one (M, n) array a pass: identity B5 (z, out); quantize B6 (z, ef)
    and B7 (z, ef, sent, ef); top-k B8 (z, ef, eff) and B9 (eff, mask,
    sent, ef). The reference column is the JAX package's."""
    assert CODEC_PASS_MODEL == {"identity": (4, 2), "quantize": (11, 6),
                                "topk": (10, 7)}
    assert {k: v[0] for k, v in CODEC_PASS_MODEL.items()} == {
        k: v[0] for k, v in JAX_PASSES.items()}
    assert codec_passes(("topk", 0.25)) == (10, 7)
    with pytest.raises(ValueError):
        codec_passes(("gzip",))


@pytest.mark.parametrize("spec", [("identity",), ("quantize", 8),
                                  ("topk", 0.25)])
def test_modeled_cost_reference_column_matches_jax(spec):
    want = jobs.modeled_sync_cost(spec, 4096.0, workers=4)
    got = modeled_sync_cost(spec, 4096.0, workers=4)
    assert got["hbm_passes"] == want["hbm_passes"]
    assert got["hbm_bytes"] == want["hbm_bytes"]
    assert got["hbm_s"] == got["hbm_bytes"] / HBM_BW
    fused = modeled_sync_cost(spec, 4096.0, workers=4, backend="fused")
    assert fused["hbm_passes"] == CODEC_PASS_MODEL[spec[0]][1]
    assert fused["hbm_s"] < got["hbm_s"]


def test_modeled_cost_without_a_spec_is_nan():
    c = modeled_sync_cost(None, 1.0, workers=1)
    assert all(math.isnan(v) for v in c.values())
    assert HBM_BW == 3.35e12


# ---------------------------------------------------------------------------
# Perfetto export
# ---------------------------------------------------------------------------

def _span_pairs():
    """The same spans in both packages (fixed times on both clocks)."""
    fields = [
        dict(name="run [0,2)", cat="run", wall_t0=10.0, wall_t1=10.5, id=0,
             attrs={"engine": "sync"}),
        dict(name="round 0", cat="round", wall_t0=10.0, wall_t1=10.2,
             parent=0, id=1, attrs={"bytes_up": 80.0, "residual": None,
                                    "alive": [True, False]}),
        dict(name="uplink r0", cat="uplink", track="worker/1", sim_t0=0.5,
             sim_t1=0.7, wall_t0=10.25, wall_t1=10.3, id=2,
             attrs={"bytes": 64}),
        dict(name="local-compute r0", cat="", track="worker/0", sim_t0=0.0,
             sim_t1=2.0, id=3),
    ]
    return [Span(**f) for f in fields], [JaxSpan(**f) for f in fields]


@pytest.mark.parametrize("clock", ["wall", "sim"])
def test_trace_events_match_jax(clock):
    ours, theirs = _span_pairs()
    got = to_trace_events(ours, clock=clock, pid=3)
    want = jobs.to_trace_events(theirs, clock=clock, pid=3)
    assert got == want
    validate_trace_events(got)
    with pytest.raises(ValueError, match="clock"):
        to_trace_events(ours, clock="tpu")


def test_perfetto_export_sync_wall(game, tmp_path):
    engine = _engine(game)
    engine.run(checkpoint_every=2)
    path = tmp_path / "sync.json"
    payload = save_trace_events(str(path), engine.tracer, clock="wall")
    validate_trace_events(payload)
    assert json.loads(path.read_text()) == payload
    names = {e["name"] for e in payload["traceEvents"] if e["ph"] == "X"}
    assert {f"round {r}" for r in range(R)} <= names
    assert any(n.startswith("chunk") for n in names)
    assert any(n.startswith("run") for n in names)
    rounds = engine.tracer.by_cat("round")
    chunks = {s.id: s for s in engine.tracer.by_cat("chunk")}
    for sp in rounds:                   # rounds nest inside their chunk
        ch = chunks[sp.parent]
        assert ch.wall_t0 <= sp.wall_t0 and sp.wall_t1 <= ch.wall_t1 + 1e-9
    jobs.validate_trace_events(payload)   # the JAX package's check agrees


def test_export_rejects_bad_payloads():
    with pytest.raises(ValueError, match="traceEvents"):
        validate_trace_events({})
    bad = {"traceEvents": [{"ph": "X", "pid": 1, "tid": 0, "name": "a",
                            "ts": 0.0, "dur": -5.0}]}
    with pytest.raises(ValueError, match="negative"):
        validate_trace_events(bad)
    overlap = {"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "pid": 1, "tid": 0, "name": "b", "ts": 5.0, "dur": 10.0},
    ]}
    with pytest.raises(ValueError, match="partially overlaps"):
        validate_trace_events(overlap)
    with pytest.raises(ValueError, match="missing 'pid'"):
        validate_trace_events({"traceEvents": [{"ph": "M", "tid": 0,
                                                "name": "x"}]})
    with pytest.raises(ValueError, match="unexpected phase"):
        validate_trace_events({"traceEvents": [{"ph": "B", "pid": 1,
                                                "tid": 0, "name": "x"}]})


# ---------------------------------------------------------------------------
# The engine's metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec_backend,passes", [("reference", 11),
                                                  ("fused", 6)])
def test_sync_metrics_carry_modeled_cost(game, codec_backend, passes):
    engine = _engine(game, compressor=tps.StochasticQuantizeCompressor(bits=8),
                     codec_backend=codec_backend)
    engine.run()
    assert engine.metrics.total("bytes_up") == engine.trace.total_bytes_up
    hist = engine.metrics.histogram("round_wall_s")
    assert hist["count"] == R and hist["min"] > 0.0
    rec = [r for r in engine.metrics.records
           if r["name"] == "round_wall_s"][0]
    assert rec["labels"]["modeled_hbm_passes"] == passes
    assert rec["labels"]["modeled_hbm_s"] == pytest.approx(
        passes * engine._dense_bytes * M / HBM_BW, rel=1e-12)
    assert rec["labels"]["codec"] == engine.compressor.name
    assert engine.metrics.total("local_steps") == M * K * R


def test_checkpoint_bytes_metric(game, tmp_path):
    engine = _engine(game, rounds=2)
    engine.run(checkpoint_path=str(tmp_path / "ck.msgpack"))
    sp = engine.tracer.by_cat("checkpoint")[-1]
    assert engine.metrics.total("checkpoint_bytes") == sp.attrs["bytes"] > 0


def _hostile_kw(mod):
    return dict(compressor=mod.StochasticQuantizeCompressor(bits=8),
                byzantine=mod.SignFlipAttack(fraction=0.25, scale=8.0,
                                             seed=1),
                aggregator=mod.TrimmedMean(beta=0.25),
                server_opt=mod.ServerNesterov(lr=1.0, beta=0.3))


def test_engine_metric_records_match_jax():
    """The JAX engine's records, one for one, on a hostile fleet with q8,
    a trimmed mean and outer Nesterov (M = 8: C6)."""
    m, rounds = 8, 3
    jg = jax_game(jax.random.PRNGKey(0), n=N, sigma=0.1)
    tg = interop.game_from_numpy(np.asarray(jg.a), np.asarray(jg.b),
                                 np.asarray(jg.c), 0.1, device="cpu")
    je = jps.PSEngine(jg.problem,
                      jps.PSConfig(adaseg=JaxCfg(**CFG), num_workers=m,
                                   rounds=rounds, **_hostile_kw(jps)),
                      rng=jax.random.PRNGKey(4), eval_fn=jg.residual)
    je.run()
    te = _engine(tg, m=m, rounds=rounds, **_hostile_kw(tps))
    te.run()
    want, got = je.metrics.records, te.metrics.records
    assert [(r["kind"], r["name"]) for r in got] == [
        (r["kind"], r["name"]) for r in want]
    names = {r["name"] for r in got}
    assert {"bytes_up", "bytes_down", "local_steps", "eta_spread",
            "outer_delta_norm", "byzantine_workers", "agg_reject_frac",
            "round_wall_s"} <= names
    for g, w in zip(got, want):
        gl, wl = dict(g.get("labels", {})), dict(w.get("labels", {}))
        if g["name"] == "round_wall_s":
            assert gl.pop("modeled_hbm_s") > 0.0
            wl.pop("modeled_hbm_s")
        else:
            np.testing.assert_allclose(g["value"], w["value"], rtol=1e-5)
            if g["kind"] == "counter":
                assert g["value"] == w["value"]
        assert gl == wl


def test_make_ps_engine_accepts_metrics():
    from repro_torch.launch import TrainPlan, make_ps_engine
    from repro_torch.models import tiny_lm_config

    plan = TrainPlan(cfg=tiny_lm_config(), adaseg=AdaSEGConfig(
        g0=20.0, diameter=2.0, k=2, average_output=False),
        worker_mode="paper", k_local=2, global_batch=4, seq=8,
        workers_override=2)
    reg = MetricsRegistry()
    eng = make_ps_engine(plan, jr.PRNGKey(0, device="cpu"), rounds=1,
                         metrics=reg, device="cpu")
    eng.run()
    assert eng.metrics is reg
    assert reg.total("bytes_up") == eng.trace.total_bytes_up > 0
    assert reg.histogram("round_wall_s")["count"] == 1


def _async_engines(**kw):
    """The JAX and the port's async engines on one game (identical
    coefficients) under a 6× straggler at τ=2, each with ``kw``'s layers."""
    jg = jax_game(jax.random.PRNGKey(0), n=N, sigma=0.1)
    tg = interop.game_from_numpy(np.asarray(jg.a), np.asarray(jg.b),
                                 np.asarray(jg.c), 0.1, device="cpu")

    def config(mod, cfg):
        return mod.AsyncPSConfig(
            adaseg=cfg(**CFG), num_workers=M, rounds=R,
            latency=mod.ConstantLatency(step_s=(1.0, 1.0, 1.0, 6.0),
                                        up_s=0.2, down_s=0.1),
            staleness_bound=2.0, **{k: f(mod) for k, f in kw.items()})

    je = jps.AsyncPSEngine(jg.problem, config(jps, JaxCfg),
                           rng=jax.random.PRNGKey(4), eval_fn=jg.residual)
    te = tps.AsyncPSEngine(tg.problem, config(tps, AdaSEGConfig),
                           rng=jr.PRNGKey(4, device="cpu"),
                           eval_fn=tg.residual, device="cpu")
    return je, te


def test_async_metric_records_match_jax():
    """The async engine's records, one for one, as the JAX engine emits
    them (``engine="async"``): q8, a trimmed mean and outer Nesterov under
    a straggler. The wall of each admission and its modeled seconds are
    measured and modeled for each package's own device."""
    je, te = _async_engines(
        compressor=lambda mod: mod.StochasticQuantizeCompressor(bits=8),
        byzantine=lambda mod: mod.SignFlipAttack(fraction=0.25, scale=8.0,
                                                 seed=1),
        aggregator=lambda mod: mod.TrimmedMean(beta=0.25),
        server_opt=lambda mod: mod.ServerNesterov(lr=1.0, beta=0.3))
    je.run()
    te.run()
    want, got = je.metrics.records, te.metrics.records
    assert [(r["kind"], r["name"]) for r in got] == [
        (r["kind"], r["name"]) for r in want]
    names = {r["name"] for r in got}
    assert {"bytes_up", "bytes_down", "admissions", "eta_spread",
            "byzantine_workers", "agg_reject_frac", "outer_delta_norm",
            "idle_frac", "staleness", "admission_wall_s"} <= names
    for g, w in zip(got, want):
        gl, wl = dict(g.get("labels", {})), dict(w.get("labels", {}))
        assert gl.get("engine") == "async"
        if g["name"] == "admission_wall_s":
            assert g["value"] > 0.0 and gl.pop("modeled_hbm_s") > 0.0
            wl.pop("modeled_hbm_s")
        else:
            np.testing.assert_allclose(g["value"], w["value"], rtol=1e-5)
            if g["kind"] == "counter" or g["name"] in ("staleness",
                                                       "idle_frac"):
                assert g["value"] == w["value"]
        assert gl == wl


def test_async_perfetto_export_sim_clock(tmp_path):
    """The τ=2 run's spans on the simulated clock: a valid payload (the
    JAX package's check agrees), one track per worker beside the server's,
    and the same simulated intervals as the JAX engine's spans."""
    je, te = _async_engines()
    je.run()
    te.run()
    path = tmp_path / "async.json"
    payload = save_trace_events(str(path), te.tracer, clock="sim")
    validate_trace_events(payload)
    jobs.validate_trace_events(payload)
    assert json.loads(path.read_text()) == payload
    assert set(te.tracer.tracks()) == {"server"} | {
        f"worker/{m}" for m in range(M)}
    names = {e["name"] for e in payload["traceEvents"] if e["ph"] == "X"}
    assert {"admission 0", "uplink r0", "local-compute r0", "final"} <= names

    def sim(tracer):
        return [(s.name, s.cat, s.track, s.sim_t0, s.sim_t1)
                for s in tracer.spans if s.sim_t0 is not None]

    assert sim(te.tracer) == sim(je.tracer)


# ---------------------------------------------------------------------------
# Spans and metrics cannot change a result
# ---------------------------------------------------------------------------

def test_sync_engine_tracing_inert(game):
    on, off = _engine(game), _engine(game, **_off())
    _assert_equal(on.run(), off.run())
    assert on.tracer.spans and on.metrics.records
    assert not off.tracer.spans and not off.metrics.records


@pytest.mark.parametrize("codec_backend", ["reference", "fused"])
def test_hostile_fused_codec_tracing_inert(game, codec_backend):
    kw = dict(_hostile_kw(tps), codec_backend=codec_backend)
    on, off = _engine(game, m=8, **kw), _engine(game, m=8, **kw, **_off())
    _assert_equal(on.run(), off.run())
    _assert_equal(on.state.z_tilde, off.state.z_tilde)
    _assert_equal(on._ef, off._ef)
    assert [r.residual for r in on.trace.rounds] == [
        r.residual for r in off.trace.rounds]


def test_wgan_engine_tracing_inert():
    from repro_torch.models import ModelWorker

    wg = make_wgan_problem(jr.PRNGKey(0, device="cpu"), hidden=8, batch=8)
    cfg = AdaSEGConfig(g0=50.0, diameter=1.0, alpha=1.0, k=2,
                       average_output=False)

    def run(**kw):
        eng = tps.PSEngine(
            wg.problem, tps.PSConfig(
                worker=ModelWorker(cfg, backend="fused", arch="wgan_gp"),
                local_k=2, num_workers=3, rounds=2, codec_backend="fused",
                compressor=tps.StochasticQuantizeCompressor(bits=8)),
            rng=jr.PRNGKey(1, device="cpu"), device="cpu", **kw)
        return eng.run(), eng

    (z_on, e_on), (z_off, e_off) = run(), run(**_off())
    _assert_equal(z_on, z_off)
    _assert_equal(e_on.state.z_tilde, e_off.state.z_tilde)
    assert e_on.metrics.total("bytes_up") == e_on.trace.total_bytes_up


def test_jax_wgan_name_is_the_ports():
    """The heterogeneous name the engines fingerprint the worker with."""
    jw = jax_wgan(jax.random.PRNGKey(0), hidden=4, batch=4)
    tw = make_wgan_problem(jr.PRNGKey(0, device="cpu"), hidden=4, batch=4)
    assert tw.problem.name == jw.problem.name
