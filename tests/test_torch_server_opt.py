"""The server's outer optimizer in the port against the JAX package: the
policies (specs, slots, fingerprints, validation), the outer step (B11's
plain version against the JAX reference under jit and the Pallas kernel in
interpret mode), ``server_outer_apply``, ``sync_weighted_stacked(server=)``
and the serial PSEngine per policy, alone and composed with a robust
merge, q8 with error feedback and an attack.

Bars. The outer step: rtol 1e-6 / atol 1e-7, one ulp. In practice it is
exact: XLA on the CPU contracts each ``a·b + c`` of the update into one
fused multiply-add, computes Adam's ``β^(t+1)`` with an f32 ``pow`` that
PyTorch's agrees with, and at ``lr = 1`` rewrites ``(m̂)/(√v̂ + ε)`` as
``m′/((1 − β₁^(t+1))·(√v̂ + ε))``; the port's plain version copies all
three (``kernels/sync_compress/ref.py``), and the bar only allows for an
XLA build that rounds one of them otherwise. ``delta_sq`` and the engine's
``delta_norm`` are sums in another order (rtol 1e-5). Engine traces: rtol
1e-5 / atol 1e-6; error-feedback residuals under the ×8 sign-flip attack
atol 1e-5 (messages reach 8, where one ulp is 9.5e-7). ``NoServerOpt`` is
bit-identical to no server within the port.

The engines run M = 8 workers. In round 0 every worker has the same η,
so the merge and the server anchor (the fleet mean of the initial
payloads) are the same mean. The JAX package forms the anchor with
``jnp.mean`` and the merge another way, so at M = 6 its first Δ is
rounding noise, which Adam's normalised step turns into moves of ±lr
(ROADMAP C6); the port forms the anchor with the merge itself, so its
first Δ is exactly 0 on either backend. At M = 8 both packages form
Δ₀ = 0 exactly; ``test_first_delta_is_rounding_noise`` pins M = 6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ps as jps
from repro.core import AdaSEGConfig as JaxCfg
from repro.core import sync_weighted_stacked as jax_sync
from repro.kernels.sync_compress import kernel as jk
from repro.kernels.sync_compress import ops as jops
from repro.kernels.sync_compress import ref as jref
from repro.problems import make_bilinear_game as jax_game
from repro_torch import interop
from repro_torch import ps as tps
from repro_torch import random as jr
from repro_torch.core import AdaSEGConfig, sync_weighted_stacked
from repro_torch.kernels.sync_compress import kernel as tk
from repro_torch.kernels.sync_compress import ops as tops
from repro_torch.kernels.sync_compress import ref as tref
from repro_torch.problems import make_bilinear_game

M, R = 8, 4
CFG = dict(g0=1.0, diameter=2.0, alpha=1.0, k=4)
TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-6, atol=1e-7)

POLICIES = {
    "momentum": lambda mod: mod.ServerMomentum(lr=0.7, beta=0.9),
    "nesterov": lambda mod: mod.ServerNesterov(lr=1.0, beta=0.3),
    "nesterov_lr": lambda mod: mod.ServerNesterov(lr=0.6, beta=0.8),
    "adam": lambda mod: mod.ServerAdam(),
    "adam_lr": lambda mod: mod.ServerAdam(lr=0.3, beta1=0.8, beta2=0.999,
                                          eps=1e-6),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(POLICIES) + ["none"])
def test_specs_slots_fingerprints_match_jax(name):
    make = POLICIES.get(name, lambda mod: mod.NoServerOpt())
    ours, theirs = make(tps), make(jps)
    assert ours.spec == theirs.spec
    assert ours.slots == theirs.slots
    assert (ours.name, ours.fingerprint) == (theirs.name, theirs.fingerprint)
    mom = ours.init_moments((torch.ones(1, 3), torch.ones(1, 2)))
    assert len(mom) == ours.slots
    assert all(float(v.abs().sum()) == 0.0 for tree in mom for v in tree)


@pytest.mark.parametrize("make", [
    lambda mod: mod.ServerMomentum(lr=0.0),
    lambda mod: mod.ServerMomentum(beta=1.0),
    lambda mod: mod.ServerNesterov(lr=-1.0),
    lambda mod: mod.ServerNesterov(beta=-0.1),
    lambda mod: mod.ServerAdam(beta1=1.0),
    lambda mod: mod.ServerAdam(beta2=-0.5),
    lambda mod: mod.ServerAdam(eps=0.0),
])
def test_validation_matches_jax(make):
    for mod in (jps, tps):
        with pytest.raises(ValueError):
            make(mod)


def test_resolution_matches_jax():
    for so, active in ((None, False), ("none", False), ("nesterov", True)):
        for mod in (jps, tps):
            policy = {None: None, "none": mod.NoServerOpt(),
                      "nesterov": mod.ServerNesterov()}[so]
            cfg = mod.PSConfig(num_workers=2, rounds=1, server_opt=policy)
            assert (mod.resolve_server_opt(cfg) is not None) == active


# ---------------------------------------------------------------------------
# The outer step (B11's plain version)
# ---------------------------------------------------------------------------

def _leaf(seed, n=1000, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (1, n)).astype(
        np.float32)


@pytest.mark.parametrize("name", list(POLICIES))
def test_outer_apply_ref_matches_jax_three_chained_steps(name):
    """Three chained steps at a ragged n (1000, Pallas block 128): the
    port's plain version against the JAX reference under jit and the
    Pallas kernel in interpret mode, each side carrying its own moments."""
    spec = POLICIES[name](tps).spec
    slots = POLICIES[name](tps).slots
    z = _leaf(0)
    mom = [_leaf(1)] + ([_leaf(2, lo=0.0)] if slots == 2 else [])
    ref_fn = jax.jit(lambda g, z, m, t: jref.outer_apply_ref(g, z, m, t,
                                                             spec=spec))
    sides = {"port": (z, tuple(mom)), "jit": (z, tuple(mom)),
             "pallas": (z, tuple(mom))}
    for step in range(3):
        g = _leaf(10 + step)
        t = float(step)
        outs = {
            "port": tref.outer_apply_ref(
                _t(g), _t(sides["port"][0]), tuple(map(_t, sides["port"][1])),
                torch.tensor(t), spec=spec),
            "jit": ref_fn(g, sides["jit"][0], sides["jit"][1],
                          jnp.float32(t)),
            "pallas": jk.outer_apply(
                jnp.asarray(g), jnp.asarray(sides["pallas"][0]),
                tuple(map(jnp.asarray, sides["pallas"][1])), jnp.float32(t),
                spec=spec, block=128, interpret=True),
        }
        for key in ("jit", "pallas"):
            _close(outs["port"][0], outs[key][0], **STEP_TOL)
            for a, b in zip(outs["port"][1], outs[key][1]):
                _close(a, b, **STEP_TOL)
            _close(outs["port"][2], outs[key][2], rtol=1e-5)
        sides = {k: (np.asarray(v[0]), tuple(np.asarray(x) for x in v[1]))
                 for k, v in outs.items()}


@pytest.mark.parametrize("n,sms,blocks", [
    (1, 132, 1), (16384, 132, 8), (16421, 132, 9), (151936 * 896, 132, 528),
    (151936 * 896, 114, 456), (2048 * 528 + 1, 132, 528)])
def test_outer_grid_is_sized_to_the_sms(n, sms, blocks):
    """The card's outer step (B11) takes a block a pass of ``OUTER_STEP``
    columns, at most ``OUTER_BLOCKS_PER_SM`` blocks an SM; its blocks'
    Σ Δ² partials are then summed by the last block, in block order."""
    assert tk.outer_blocks(n, sms) == blocks


def test_outer_apply_ref_rejects_unknown_spec():
    with pytest.raises(ValueError):
        tref.outer_apply_ref(torch.zeros(1, 2), torch.zeros(1, 2),
                             (torch.zeros(1, 2),), torch.tensor(0.0),
                             spec=("lion", 1.0))


def test_zero_delta_from_rest_is_a_fixed_point():
    z = _t(_leaf(3))
    for name in ("momentum", "nesterov", "adam"):
        pol = POLICIES[name](tps)
        mom = pol.init_moments((z,))
        zn, mn, dsq = tref.outer_apply_ref(z, z, tuple(m[0] for m in mom),
                                           torch.tensor(0.0), spec=pol.spec)
        torch.testing.assert_close(zn, z, rtol=0, atol=0)
        assert float(dsq) == 0.0


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("name", ["momentum", "nesterov", "adam", "adam_lr"])
def test_server_outer_apply_matches_jax(name, use_kernel):
    """Two leaves, t = 3: the new anchor and moments, ``t_new``, the
    effective step size and ‖Δ‖ over both leaves."""
    spec = POLICIES[name](tps).spec
    slots = POLICIES[name](tps).slots
    z = (_leaf(0, 37), _leaf(1, 5).reshape(1, 5))
    merged = (_leaf(2, 37), _leaf(3, 5))
    mom = tuple((_leaf(4 + s, 37, 0.0), _leaf(6 + s, 5, 0.0))
                for s in range(slots))
    want = jops.server_outer_apply(
        tuple(map(jnp.asarray, merged)), tuple(map(jnp.asarray, z)),
        tuple(tuple(map(jnp.asarray, m)) for m in mom), jnp.int32(3),
        spec=spec, use_kernel=use_kernel)
    got = tops.server_outer_apply(
        tuple(map(_t, merged)), tuple(map(_t, z)),
        tuple(tuple(map(_t, m)) for m in mom),
        torch.tensor(3, dtype=torch.int32), spec=spec, use_kernel=use_kernel)
    for a, b in zip(got[0], want[0]):
        _close(a, b, **STEP_TOL)
    for ta, tb in zip(got[1], want[1]):
        for a, b in zip(ta, tb):
            _close(a, b, **STEP_TOL)
    assert int(got[2]) == int(want[2]) == 4 and got[2].dtype == torch.int32
    _close(got[3], want[3], rtol=1e-6)
    _close(got[4], want[4], rtol=1e-5)


@pytest.mark.parametrize("backend", ["reference", "fused"])
@pytest.mark.parametrize("name", ["momentum", "adam"])
def test_sync_weighted_stacked_with_server_matches_jax(name, backend):
    rng = np.random.default_rng(0)
    zt = (rng.uniform(-1, 1, (M, 9)).astype(np.float32),
          rng.uniform(-1, 1, (M, 2, 3)).astype(np.float32))
    inv_eta = rng.uniform(0.5, 3.0, M).astype(np.float32)
    jpol, tpol = POLICIES[name](jps), POLICIES[name](tps)
    z0 = tuple(np.mean(v, axis=0, keepdims=True) for v in zt)
    jsrv = (tuple(map(jnp.asarray, z0)),
            jpol.init_moments(tuple(map(jnp.asarray, z0))), jnp.int32(0))
    tsrv = (tuple(map(_t, z0)), tpol.init_moments(tuple(map(_t, z0))),
            torch.tensor(0, dtype=torch.int32))
    for _ in range(2):
        want = jax_sync(tuple(map(jnp.asarray, zt)), jnp.asarray(inv_eta),
                        backend=backend, server=jpol, srv=jsrv)
        got = sync_weighted_stacked(tuple(map(_t, zt)), _t(inv_eta),
                                    backend=backend, server=tpol, srv=tsrv)
        for a, b in zip(got[0], want[0]):
            assert a.shape == b.shape
            _close(a, b, rtol=1e-6, atol=1e-6)
        _close(got[2], want[2], rtol=1e-5)
        jsrv, tsrv = want[1], got[1]
        zt = tuple(v + 0.1 for v in zt)


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


def _assert_engines_match(te, je):
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in je.trace.rounds])
    _close([r.outer_lr for r in te.trace.rounds],
           [r.outer_lr for r in je.trace.rounds], rtol=1e-6)
    _close([r.delta_norm for r in te.trace.rounds],
           [r.delta_norm for r in je.trace.rounds])
    for a, b in zip(te.state.z_tilde, je.state.z_tilde):
        _close(a, b)
    z, mom, t = te._srv
    jz, jmom, jt = je._srv
    for a, b in zip((*z, *(v for m in mom for v in m)),
                    jax.tree.leaves((jz, jmom))):
        _close(a, b)
    assert int(t) == int(jt)
    assert te.trace.meta.get("server_opt") == je.trace.meta.get("server_opt")


@pytest.mark.parametrize("codec_backend", ["reference", "fused"])
@pytest.mark.parametrize("name", ["momentum", "nesterov", "adam"])
def test_engine_server_opt_matches_jax(games, name, codec_backend):
    jg, tg = games
    je = _jax_engine(jg, codec_backend, server_opt=POLICIES[name](jps))
    te = _port_engine(tg, codec_backend, server_opt=POLICIES[name](tps))
    je.run()
    te.run()
    _assert_engines_match(te, je)


def _composed(mod):
    return dict(server_opt=mod.ServerNesterov(lr=1.0, beta=0.3),
                aggregator=mod.TrimmedMean(beta=0.2),
                byzantine=mod.SignFlipAttack(fraction=0.2, scale=8.0,
                                             seed=11),
                compressor=mod.StochasticQuantizeCompressor(bits=8),
                faults=mod.BernoulliFaults(p=0.3, seed=5))


@pytest.mark.parametrize("codec_backend", ["reference", "fused"])
def test_engine_server_opt_composed_with_robust_q8_attack(games,
                                                          codec_backend):
    jg, tg = games
    je = _jax_engine(jg, codec_backend, **_composed(jps))
    te = _port_engine(tg, codec_backend, **_composed(tps))
    je.run()
    te.run()
    _assert_engines_match(te, je)
    for a, b in zip(te._ef, jax.tree.leaves(je._ef)):
        _close(a, b, rtol=1e-5, atol=1e-5)
    assert ([r.byzantine_workers for r in te.trace.rounds]
            == [r.byzantine_workers for r in je.trace.rounds])


@pytest.mark.parametrize("codec_backend", ["reference", "fused"])
def test_noserveropt_is_bit_identical_to_none(games, codec_backend):
    _, tg = games
    kw = dict(compressor=tps.StochasticQuantizeCompressor(bits=8),
              faults=tps.BernoulliFaults(p=0.3, seed=5))
    base = _port_engine(tg, codec_backend, **kw)
    none = _port_engine(tg, codec_backend, server_opt=tps.NoServerOpt(), **kw)
    assert none._server is None and none._srv is None
    z_b, z_n = base.run(), none.run()
    for a, b in zip((*z_b, *base._ef), (*z_n, *none._ef)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ([r.residual for r in base.trace.rounds]
            == [r.residual for r in none.trace.rounds])
    assert all(r.outer_lr is None for r in none.trace.rounds)
    assert "server_opt" not in none.trace.meta


def test_first_delta_is_rounding_noise(games):
    """At M = 6 the JAX package's round-0 pseudo-gradient is rounding noise
    (nonzero, below 1e-6) and the port's is exactly 0, on both backends;
    a round of local steps then moves the fleet by order 1 (ROADMAP C6)."""
    jg, tg = games
    for cb in ("reference", "fused"):
        je = _jax_engine(jg, cb, rounds=2, m=6,
                         server_opt=jps.ServerNesterov())
        te = _port_engine(tg, cb, rounds=2, m=6,
                          server_opt=tps.ServerNesterov())
        je.run()
        te.run()
        (j0, j1), (t0, t1) = ([r.delta_norm for r in e.trace.rounds]
                              for e in (je, te))
        assert 0.0 < j0 < 1e-6 and t0 == 0.0
        assert min(j1, t1) > 1e-1
        _close(t1, j1, rtol=1e-5)


def test_server_anchor_starts_at_the_fleet_mean(games):
    jg, tg = games
    je = _jax_engine(jg, server_opt=jps.ServerAdam())
    te = _port_engine(tg, server_opt=tps.ServerAdam())
    for a, b in zip(te._srv[0], je._srv[0]):
        _close(a, b, rtol=1e-6, atol=1e-7)
    assert len(te._srv[1]) == 2 and int(te._srv[2]) == 0


def test_srv_from_numpy_carries_a_jax_run_into_the_port(games):
    """A JAX engine's mid-run state, error feedback and outer-optimizer
    state, carried over as numpy, continue in the port to the JAX engine's
    own end."""
    jg, tg = games
    je = _jax_engine(jg, **_composed(jps))
    je.run(until_round=2)
    fields = {k: (tuple(np.asarray(v) for v in getattr(je.state, k))
                  if k in ("z_tilde", "z_bar")
                  else np.asarray(getattr(je.state, k)))
              for k in je.state._fields}
    jz, jmom, jt = je._srv
    srv = interop.srv_from_numpy([np.asarray(v) for v in jz],
                                 [[np.asarray(v) for v in m] for m in jmom],
                                 np.asarray(jt), device="cpu")
    te = _port_engine(tg, **_composed(tps))
    te._state = interop.state_from_numpy(fields, device="cpu")
    te._ef = interop.ef_from_numpy([np.asarray(v)
                                    for v in jax.tree.leaves(je._ef)],
                                   device="cpu")
    te._srv, te.round = srv, 2
    te.trace.rounds = []
    te.run()
    je.run()
    _close([r.residual for r in te.trace.rounds],
           [r.residual for r in je.trace.rounds[2:]])
    _close([r.delta_norm for r in te.trace.rounds],
           [r.delta_norm for r in je.trace.rounds[2:]])
    assert int(te._srv[2]) == int(je._srv[2]) == R


def test_engine_trains_under_every_policy(games):
    """Finite residuals and outer telemetry each round; Adam's effective
    step size warms up from its bias correction."""
    _, tg = games
    for name in ("momentum", "nesterov", "adam"):
        eng = _port_engine(tg, "fused", rounds=5,
                           server_opt=POLICIES[name](tps))
        eng.run()
        res = [r.residual for r in eng.trace.rounds]
        assert all(np.isfinite(res))
        assert all(r.delta_norm is not None and np.isfinite(r.delta_norm)
                   for r in eng.trace.rounds)
        if name == "adam":
            lrs = [r.outer_lr for r in eng.trace.rounds]
            assert lrs[0] == pytest.approx(1.0, rel=1e-5)
            assert lrs[1] < lrs[0]
    cfg = dataclasses.replace(eng.config, server_opt=tps.ServerNesterov())
    assert tps.resolve_server_opt(cfg).name == "nesterov[lr=1,beta=0.9]"
