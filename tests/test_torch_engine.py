"""The slices as a whole: the port's serial PSEngine (and the one-shot
``run_local_adaseg`` under it) against the JAX package's, from the same
seed — the identity main path, and the compressed, fault-tolerant sync
(top-k and 8-bit stochastic quantization with error feedback, fault
policies, schedules).

Cross-package bars are tolerances (rtol 1e-5 / atol 1e-6 on traces, iterates,
accumulators and error-feedback residuals; step counts, aliveness and bytes
exact): the two sides draw bit-identical keys, coefficients, initial
iterates and codec uniforms, and differ only in f32 sum order and erfinv
ulps. On these seeds no stochastic rounding decision flips between the two
(a flip would move one element by a whole level, scale/255, and fail the
bar). Within the port, the two codec backends agree bit for bit on the
CPU, and reruns and resumed runs are bit-identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AdaSEGConfig as JaxCfg
from repro.core import init as jax_init
from repro.core import local_step as jax_local_step
from repro.core import projections as jproj
from repro.core import run_local_adaseg as jax_run
from repro.core import sync_weighted_stacked as jax_sync
from repro.problems import make_bilinear_game as jax_game
from repro import ps as jps
from repro.ps import PSConfig as JaxPSConfig
from repro.ps import PSEngine as JaxPSEngine
from repro.ps.trace import TraceRecorder as JaxTraceRecorder
from repro_torch import interop
from repro_torch import random as jr
from repro_torch.core import (
    AdaSEGConfig,
    init,
    local_step,
    projections,
    run_local_adaseg,
    sync_weighted_stacked,
)
from repro_torch import ps as tps
from repro_torch.problems import make_bilinear_game
from repro_torch.ps import PSConfig, PSEngine

M, R = 4, 20
CFG = dict(g0=1.0, diameter=2.0, k=5)
TOL = dict(rtol=1e-5, atol=1e-6)
COMBOS = [(b, c) for b in ("reference", "fused")
          for c in ("reference", "fused")]


@pytest.fixture(scope="module")
def games():
    return (jax_game(jax.random.PRNGKey(0), n=10, sigma=0.1),
            make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=10, sigma=0.1,
                               device="cpu"))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _port_engine(tg, backend="reference", codec_backend="reference",
                 rounds=R, **kw):
    return PSEngine(tg.problem,
                    PSConfig(adaseg=AdaSEGConfig(**CFG), num_workers=M,
                             rounds=rounds, backend=backend,
                             codec_backend=codec_backend, **kw),
                    rng=jr.PRNGKey(2, device="cpu"), eval_fn=tg.residual,
                    device="cpu")


@pytest.mark.parametrize("backend,codec_backend", COMBOS)
def test_engine_matches_jax_engine(games, backend, codec_backend):
    jg, tg = games
    je = JaxPSEngine(jg.problem,
                     JaxPSConfig(adaseg=JaxCfg(**CFG), num_workers=M,
                                 rounds=R, backend=backend,
                                 codec_backend=codec_backend),
                     rng=jax.random.PRNGKey(2), eval_fn=jg.residual)
    z_j = je.run()
    te = _port_engine(tg, backend, codec_backend)
    z_t = te.run()

    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in je.trace.rounds])
    for a, b in zip(z_t, z_j):
        _close(a, b)
    for a, b in zip(te.state.z_tilde, je.state.z_tilde):
        _close(a, b)
    _close(te.state.sum_sq, je.state.sum_sq)
    _close(te.state.grad_sq_sum, je.state.grad_sq_sum)
    np.testing.assert_array_equal(te.state.t.numpy(), np.asarray(je.state.t))
    for rt, rj in zip(te.trace.rounds, je.trace.rounds):
        assert rt.local_steps == rj.local_steps
        assert (rt.bytes_up, rt.bytes_down) == (rj.bytes_up, rj.bytes_down)
        _close([rt.eta_min, rt.eta_max, rt.eta_mean],
               [rj.eta_min, rj.eta_max, rj.eta_mean])
    for key in ("problem", "optimizer", "workers", "rounds", "schedule",
                "compressor", "faults", "backend", "codec_backend",
                "execution"):
        assert te.trace.meta[key] == je.trace.meta[key], key


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_local_step_matches_jax_with_mask(games, backend):
    """One masked step of the stacked fleet vs JAX's vmapped step: state
    and aux; masked workers keep their state bit for bit."""
    jg, tg = games
    cfg_j, cfg_t = JaxCfg(**CFG), AdaSEGConfig(**CFG)
    keys = jax.random.split(jax.random.PRNGKey(1), M)
    st_j = jax.vmap(lambda k, w: jax_init(jg.problem, cfg_j, k, w))(
        keys, jnp.arange(M, dtype=jnp.int32))
    st_t = init(tg.problem, cfg_t,
                interop.key_from_numpy(np.asarray(keys), device="cpu"))
    enabled = np.array([True, False, True, True])
    for r in jax.random.split(jax.random.PRNGKey(3), 3):
        rk = jax.random.split(r, M)
        st_j, aux_j = jax.vmap(
            lambda s, k, e: jax_local_step(jg.problem, cfg_j, s, k,
                                           enabled=e, backend=backend)
        )(st_j, rk, jnp.asarray(enabled))
        prev = st_t
        st_t, aux_t = local_step(
            tg.problem, cfg_t, st_t,
            interop.key_from_numpy(np.asarray(rk), device="cpu"),
            enabled=torch.from_numpy(enabled), backend=backend)
        for a, b in zip(st_t.z_tilde, st_j.z_tilde):
            _close(a, b)
        _close(st_t.sum_sq, st_j.sum_sq)
        for field in ("eta", "z_sq", "grad_norm_sq"):
            _close(getattr(aux_t, field), getattr(aux_j, field))
        torch.testing.assert_close(st_t.z_tilde[0][1], prev.z_tilde[0][1],
                                   rtol=0, atol=0)
    np.testing.assert_array_equal(st_t.t.numpy(), [3, 0, 3, 3])


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_l2_ball_variant_matches_jax(games, backend):
    """run_local_adaseg on the l2 ball: the fused path is the two-pass
    explore/finish scheme."""
    jg, tg = games
    cfg = dict(g0=1.0, diameter=3.0, k=5)
    z_j, (s_j, h_j) = jax_run(
        dataclasses.replace(jg.problem, project=jproj.l2_ball(1.5)),
        JaxCfg(**cfg), num_workers=3, rounds=4, rng=jax.random.PRNGKey(3),
        backend=backend)
    z_t, (s_t, h_t) = run_local_adaseg(
        dataclasses.replace(tg.problem, project=projections.l2_ball(1.5)),
        AdaSEGConfig(**cfg), num_workers=3, rounds=4,
        rng=jr.PRNGKey(3, device="cpu"), backend=backend, device="cpu")
    for a, b in zip(z_t, z_j):
        _close(a, b)
    _close(s_t.sum_sq, s_j.sum_sq)
    _close(h_t.z_sq, h_j.z_sq)
    assert h_t.z_sq.shape == (4, 5, 3)
    norms = torch.sqrt(sum(v.square().sum(1) for v in s_t.z_tilde))
    assert bool((norms <= 1.5 * (1 + 1e-6)).all())


def test_opaque_projection_falls_back_bitwise(games):
    """A projection without a spec (simplex) runs the reference math under
    backend="fused": bit-identical within the port, close to JAX."""
    jg, tg = games
    cfg = dict(g0=1.0, diameter=3.0, k=5)
    prob = dataclasses.replace(tg.problem, project=projections.simplex())
    runs = [run_local_adaseg(prob, AdaSEGConfig(**cfg), num_workers=2,
                             rounds=2, rng=jr.PRNGKey(4, device="cpu"),
                             backend=b, device="cpu")[0]
            for b in ("reference", "fused")]
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    z_j, _ = jax_run(dataclasses.replace(jg.problem,
                                         project=jproj.simplex()),
                     JaxCfg(**cfg), num_workers=2, rounds=2,
                     rng=jax.random.PRNGKey(4))
    for a, b in zip(runs[0], z_j):
        _close(a, b)


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_sync_weighted_stacked_matches_jax(backend):
    rng = np.random.default_rng(0)
    z = (rng.uniform(-1, 1, (M, 6)).astype(np.float32),
         rng.uniform(-1, 1, (M, 2, 3)).astype(np.float32))
    inv_eta = rng.uniform(0.5, 3.0, (M,)).astype(np.float32)
    want = jax_sync(tuple(map(jnp.asarray, z)), jnp.asarray(inv_eta),
                    backend=backend)
    got = sync_weighted_stacked(tuple(map(torch.from_numpy, z)),
                                torch.from_numpy(inv_eta), backend=backend)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b, rtol=1e-6, atol=1e-6)


def test_rerun_and_resume_are_bit_identical(games):
    _, tg = games
    one = _port_engine(tg, "fused", "fused")
    z_one = one.run()
    again = _port_engine(tg, "fused", "fused").run()
    split = _port_engine(tg, "fused", "fused")
    split.run(until_round=7)
    assert split.round == 7
    z_split = split.run()
    for a, b, c in zip(z_one, again, z_split):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert ([r.residual for r in one.trace.rounds]
            == [r.residual for r in split.trace.rounds])
    stepped = _port_engine(tg, "fused", "fused", rounds=2)
    stepped.step_round()
    stepped.step_round()
    with pytest.raises(ValueError):
        stepped.step_round()


def test_trace_loads_with_the_reference_loader(games, tmp_path):
    """Same trace JSON v8: the JAX package's loader reads a port trace."""
    _, tg = games
    eng = _port_engine(tg, rounds=3)
    eng.run()
    eng.trace.save(str(tmp_path / "t.json"))
    back = JaxTraceRecorder.load(str(tmp_path / "t.json"))
    assert back.version == 8
    assert ([r.residual for r in back.rounds]
            == [r.residual for r in eng.trace.rounds])
    assert {s.cat for s in eng.tracer.spans} >= {"run", "chunk", "round"}


def test_state_from_numpy_reproduces_the_port_init(games):
    """The JAX engine's initial fleet state, carried over as numpy, equals
    the port's own (keys, init draws and projection are bit-exact)."""
    jg, tg = games
    je = JaxPSEngine(jg.problem, JaxPSConfig(adaseg=JaxCfg(**CFG),
                                             num_workers=M, rounds=R),
                     rng=jax.random.PRNGKey(2))
    fields = {k: (tuple(np.asarray(v) for v in getattr(je.state, k))
                  if k in ("z_tilde", "z_bar")
                  else np.asarray(getattr(je.state, k)))
              for k in je.state._fields}
    carried = interop.state_from_numpy(fields, device="cpu")
    own = _port_engine(tg).state
    for a, b in zip(carried, own):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("field,value", [
    ("byzantine", tps.SignFlipAttack(fraction=0.25, scale=8.0, seed=1)),
    ("sampler", tps.ClientSampler(sample=2, seed=1)),
    ("server_opt", tps.ServerNesterov(lr=1.0, beta=0.3)),
    ("aggregator", tps.TrimmedMean(beta=0.25)),
])
def test_later_slices_raise_not_implemented(games, field, value):
    """The sharded path (``mesh=``) still raises; the hostile fleet, the
    outer optimizer and client sampling, ported since, build and run a
    round (a sampled round on the 2 drawn lanes of the fleet of M)."""
    _, tg = games
    eng = _port_engine(tg, rounds=1, **{field: value})
    eng.run()
    rec = eng.trace.rounds[0]
    assert eng.round == 1 and np.isfinite(rec.residual)
    assert (rec.delta_norm is not None) == (field == "server_opt")
    assert (rec.byzantine_workers is not None) == (field == "byzantine")
    assert (rec.sampled_workers is not None) == (field == "sampler")
    if field == "sampler":
        assert rec.sampled_workers == value.draws(M, 1)[0].tolist()
        assert rec.local_steps == [CFG["k"]] * 2
    with pytest.raises(NotImplementedError):
        PSEngine(tg.problem, PSConfig(adaseg=AdaSEGConfig(**CFG),
                                      num_workers=M, rounds=R),
                 rng=jr.PRNGKey(2, device="cpu"), mesh=object(),
                 device="cpu")


# ---------------------------------------------------------------------------
# Compressed, fault-tolerant sync: codecs with error feedback, fault
# policies and schedules (n=8, M=4, K=4, as the JAX package's own
# codec-backend parity test).
# ---------------------------------------------------------------------------

CODEC_CFG = dict(g0=1.0, diameter=2.0, alpha=1.0, k=4)
CODECS = {
    "identity": lambda mod: mod.IdentityCompressor(),
    "top25": lambda mod: mod.TopKCompressor(fraction=0.25),
    "q8": lambda mod: mod.StochasticQuantizeCompressor(bits=8),
}


def _hostile(mod):
    return dict(faults=mod.BernoulliFaults(p=0.3, seed=5),
                schedule=mod.StragglerSchedule(k=4, min_frac=0.5, seed=7))


@pytest.fixture(scope="module")
def small_games():
    return (jax_game(jax.random.PRNGKey(0), n=8, sigma=0.1),
            make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=8, sigma=0.1,
                               device="cpu"))


def _jax_codec_engine(jg, codec_backend="reference", rounds=3, **kw):
    return JaxPSEngine(jg.problem,
                       JaxPSConfig(adaseg=JaxCfg(**CODEC_CFG), num_workers=M,
                                   rounds=rounds, codec_backend=codec_backend,
                                   **kw),
                       rng=jax.random.PRNGKey(2), eval_fn=jg.residual)


def _port_codec_engine(tg, codec_backend="reference", rounds=3, **kw):
    return PSEngine(tg.problem,
                    PSConfig(adaseg=AdaSEGConfig(**CODEC_CFG), num_workers=M,
                             rounds=rounds, codec_backend=codec_backend,
                             **kw),
                    rng=jr.PRNGKey(2, device="cpu"), eval_fn=tg.residual,
                    device="cpu")


def _assert_matches_jax(te, z_t, je, z_j):
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in je.trace.rounds])
    for a, b in zip(z_t, z_j):
        _close(a, b)
    for a, b in zip(te.state.z_tilde, je.state.z_tilde):
        _close(a, b)
    _close(te.state.sum_sq, je.state.sum_sq)
    np.testing.assert_array_equal(te.state.t.numpy(), np.asarray(je.state.t))
    assert len(te._ef) == len(jax.tree.leaves(je._ef))
    for a, b in zip(te._ef, jax.tree.leaves(je._ef)):
        _close(a, b)
    for rt, rj in zip(te.trace.rounds, je.trace.rounds):
        assert (rt.alive, rt.local_steps) == (rj.alive, rj.local_steps)
        assert (rt.bytes_up, rt.bytes_down) == (rj.bytes_up, rj.bytes_down)
    for key in ("schedule", "compressor", "faults", "codec_backend"):
        assert te.trace.meta[key] == je.trace.meta[key], key


def _assert_bitwise(a, b):
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("codec_backend", ["reference", "fused"])
@pytest.mark.parametrize("hostile", [False, True], ids=["clean", "hostile"])
@pytest.mark.parametrize("codec", list(CODECS))
def test_engine_codec_parity_with_jax(small_games, codec, hostile,
                                      codec_backend):
    jg, tg = small_games
    je = _jax_codec_engine(jg, codec_backend, compressor=CODECS[codec](jps),
                           **(_hostile(jps) if hostile else {}))
    te = _port_codec_engine(tg, codec_backend,
                            compressor=CODECS[codec](tps),
                            **(_hostile(tps) if hostile else {}))
    _assert_matches_jax(te, te.run(), je, je.run())


@pytest.mark.parametrize("hostile", [False, True], ids=["clean", "hostile"])
@pytest.mark.parametrize("codec", list(CODECS))
def test_codec_backends_agree_bitwise_within_the_port(small_games, codec,
                                                      hostile):
    _, tg = small_games
    runs = []
    for cb in ("reference", "fused"):
        eng = _port_codec_engine(tg, cb, rounds=4,
                                 compressor=CODECS[codec](tps),
                                 **(_hostile(tps) if hostile else {}))
        runs.append((eng.run(), eng))
    (z_r, ref), (z_f, fused) = runs
    _assert_bitwise(z_r, z_f)
    _assert_bitwise(ref.state.z_tilde, fused.state.z_tilde)
    _assert_bitwise(ref._ef, fused._ef)
    assert ([r.residual for r in ref.trace.rounds]
            == [r.residual for r in fused.trace.rounds])


@pytest.mark.parametrize("codec", ["top25", "q8"])
def test_codec_rerun_and_resume_are_bit_identical(small_games, codec):
    _, tg = small_games

    def engine():
        return _port_codec_engine(tg, "fused", rounds=4,
                                  compressor=CODECS[codec](tps),
                                  **_hostile(tps))

    one = engine()
    z_one = one.run()
    again = engine()
    z_again = again.run()
    split = engine()
    split.run(until_round=2)
    assert split.round == 2
    z_split = split.run()
    for other, z in ((again, z_again), (split, z_split)):
        _assert_bitwise(z_one, z)
        _assert_bitwise(one._ef, other._ef)
        assert ([r.residual for r in one.trace.rounds]
                == [r.residual for r in other.trace.rounds])
    assert float(sum(v.abs().sum() for v in one._ef)) > 0.0


POLICIES = {
    "uniform": lambda mod: mod.UniformSchedule(k=3),
    "fixed": lambda mod: mod.FixedSchedule([3, 1, 4, 2]),
    "straggler": lambda mod: mod.StragglerSchedule(k=6, min_frac=0.4, seed=1,
                                                   slow_workers=(2,)),
    "elastic": lambda mod: mod.ElasticSchedule(
        mod.StragglerSchedule(k=5, seed=2), dropout=0.3, seed=4),
    "no_faults": lambda mod: mod.NoFaults(),
    "bernoulli": lambda mod: mod.BernoulliFaults(p=0.4, seed=3),
    "bernoulli_unprotected": lambda mod: mod.BernoulliFaults(
        p=0.9, seed=1, protect_one=False),
    "outage": lambda mod: mod.OutageFaults(events=((1, 1, 3), (3, 0, 2))),
}


@pytest.mark.parametrize("name", list(POLICIES))
def test_policy_tables_equal_jax(name):
    ours, theirs = POLICIES[name](tps), POLICIES[name](jps)
    if hasattr(ours, "steps"):
        assert ours.max_steps(M) == theirs.max_steps(M)
        got, want = ours.steps(M, 7), theirs.steps(M, 7)
    else:
        got, want = ours.alive(M, 7), theirs.alive(M, 7)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


FLEETS = {
    # every worker down in round 1: nobody receives, anchors carry over
    "outage_all_identity": (
        "identity", lambda mod: dict(faults=mod.OutageFaults(
            events=tuple((m, 1, 2) for m in range(M))))),
    "fixed_outage_top25": (
        "top25", lambda mod: dict(schedule=mod.FixedSchedule([4, 2, 3, 1]),
                                  faults=mod.OutageFaults(
                                      events=((1, 1, 3),)))),
    "elastic_bernoulli_q8": (
        "q8", lambda mod: dict(
            schedule=mod.ElasticSchedule(mod.UniformSchedule(k=4),
                                         dropout=0.3, seed=3),
            faults=mod.BernoulliFaults(p=0.5, seed=9, protect_one=False))),
}


@pytest.mark.parametrize("codec_backend", ["reference", "fused"])
@pytest.mark.parametrize("fleet", list(FLEETS))
def test_engine_schedules_and_faults_match_jax(small_games, fleet,
                                               codec_backend):
    jg, tg = small_games
    codec, policies = FLEETS[fleet]
    je = _jax_codec_engine(jg, codec_backend, rounds=4,
                           compressor=CODECS[codec](jps), **policies(jps))
    te = _port_codec_engine(tg, codec_backend, rounds=4,
                            compressor=CODECS[codec](tps), **policies(tps))
    _assert_matches_jax(te, te.run(), je, je.run())
    if fleet == "outage_all_identity":
        assert te.trace.rounds[1].alive == [False] * M
        assert te.trace.rounds[1].bytes_up == 0


def test_ef_from_numpy_carries_a_jax_run_into_the_port(small_games):
    """A JAX engine's mid-run (state, ef), carried over as numpy, continues
    in the port to the JAX engine's own end."""
    jg, tg = small_games
    kw = dict(compressor=CODECS["q8"](jps), **_hostile(jps))
    je = _jax_codec_engine(jg, rounds=4, **kw)
    je.run(until_round=2)
    ef_np = [np.asarray(v) for v in jax.tree.leaves(je._ef)]
    ef = interop.ef_from_numpy(ef_np, device="cpu")
    for a, b in zip(ef, ef_np):
        np.testing.assert_array_equal(a.numpy(), b)
    fields = {k: (tuple(np.asarray(v) for v in getattr(je.state, k))
                  if k in ("z_tilde", "z_bar")
                  else np.asarray(getattr(je.state, k)))
              for k in je.state._fields}
    te = _port_codec_engine(tg, rounds=4, compressor=CODECS["q8"](tps),
                            **_hostile(tps))
    te._state = interop.state_from_numpy(fields, device="cpu")
    te._ef, te.round = ef, 2
    z_t = te.run()
    z_j = je.run()
    for a, b in zip(z_t, z_j):
        _close(a, b)
    for a, b in zip(te._ef, jax.tree.leaves(je._ef)):
        _close(a, b)
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in je.trace.rounds[2:]])
    assert interop.ef_from_numpy((), device="cpu") == ()


def test_codec_backend_is_validated(small_games):
    _, tg = small_games
    with pytest.raises(ValueError, match="codec backend"):
        _port_codec_engine(tg, "turbo")

    class Custom(tps.IdentityCompressor):
        @property
        def codec_spec(self):
            return None

    with pytest.raises(ValueError, match="codec_spec"):
        _port_codec_engine(tg, "fused", compressor=Custom())
    assert _port_codec_engine(tg, compressor=Custom())._ef == ()
