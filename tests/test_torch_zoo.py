"""The optimizer zoo (SGDA, SEGDA, Adam, UMP, ASMP) through the port's
``PSEngine(MinimaxWorker(opt))`` against the JAX package's, from the same
seeds, on the bilinear game (n=10) and the robust logistic problem (n=32,
d=8, batch=8).

Cross-package bars are tolerances (ROADMAP C3: ``normal`` is a few ulps off
XLA's, and the robust oracle's ``exp``/``log1p`` and dot order differ in
the last bits): final state and ``z_bar()`` at rtol 1e-5 / atol 1e-6, step
counts exact. On the robust problem UMP and ASMP take G₀ = 10, near its
gradient bound (C4's rule): at G₀ = 1 the first steps are ~10× the
Lipschitz step, and a one-ulp jitter of the reference's own oracle moves
its UMP trajectory past the bar (``test_robust_ump_at_g0_1_amplifies_ulps``).
Within the port the bars are bits: the two sync backends agree, reruns
repeat, and a checkpoint resume equals the straight run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jo
from repro import ps as jps
from repro.problems import make_bilinear_game as jax_game
from repro.problems import make_robust_logistic as jax_robust
from repro_torch import optim as to
from repro_torch import ps as tps
from repro_torch import random as jr
from repro_torch.checkpoint import serialize as ser
from repro_torch.problems import make_bilinear_game, robust_logistic_from_arrays

M, K, R = 4, 5, 4
TOL = dict(rtol=1e-5, atol=1e-6)
# (name in both packages, arguments); UMP and ASMP on the robust problem
# take G0 = 10 (module docstring)
ZOO = {
    "sgda": ("sgda", (0.05,)),
    "segda": ("segda", (0.05,)),
    "adam": ("adam_minimax", (0.02,)),
    "ump": ("ump", (1.0, 2.0)),
    "asmp": ("asmp", (1.0, 2.0)),
}
ROBUST_ARGS = {"ump": (10.0, 2.0), "asmp": (10.0, 2.0)}


def _opts(name, prob="bilinear"):
    fn, args = ZOO[name]
    if prob == "robust":
        args = ROBUST_ARGS.get(name, args)
    return getattr(jo, fn)(*args), getattr(to, fn)(*args)


@pytest.fixture(scope="module")
def problems():
    jg = jax_game(jax.random.PRNGKey(0), n=10, sigma=0.1)
    tg = make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=10, sigma=0.1,
                            device="cpu")
    jrl = jax_robust(jax.random.PRNGKey(1), n=32, d=8, batch=8)
    trl = robust_logistic_from_arrays(
        torch.tensor(np.asarray(jrl.features)),
        torch.tensor(np.asarray(jrl.labels)), batch=8)
    return {"bilinear": (jg.problem, tg.problem),
            "robust": (jrl.problem, trl.problem)}


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX engine run per (problem, method, config), shared by the
    port's backends."""
    return {}


def _jax_engine(problem, opt, rounds=R, seed=3, m=M, **kw):
    return jps.PSEngine(problem,
                        jps.PSConfig(num_workers=m, rounds=rounds,
                                     worker=jo.MinimaxWorker(opt), local_k=K,
                                     **kw),
                        rng=jax.random.PRNGKey(seed))


def _port_engine(problem, opt, rounds=R, seed=3, m=M, **kw):
    return tps.PSEngine(problem,
                        tps.PSConfig(num_workers=m, rounds=rounds,
                                     worker=to.MinimaxWorker(opt), local_k=K,
                                     **kw),
                        rng=jr.PRNGKey(seed, device="cpu"), device="cpu")


def _close_trees(port_tree, jax_tree, **tol):
    got = [x for x in ser.tree_flatten(port_tree)]
    want = jax.tree.leaves(jax_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   **(tol or TOL))


def _bitwise(a, b):
    la, lb = ser.tree_flatten(a), ser.tree_flatten(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def _jax_run(jax_runs, problems, prob, name):
    if (prob, name) not in jax_runs:
        je = _jax_engine(problems[prob][0], _opts(name, prob)[0])
        jax_runs[(prob, name)] = (je.run(), je)
    return jax_runs[(prob, name)]


@pytest.mark.parametrize("name", sorted(ZOO))
@pytest.mark.parametrize("prob", ["bilinear", "robust"])
def test_engine_matches_jax_engine(problems, jax_runs, prob, name):
    """Both sync backends against the JAX engine; on the CPU the fused
    merge's plain version gives the reference sync's bits."""
    z_j, je = _jax_run(jax_runs, problems, prob, name)
    runs = []
    for codec_backend in ("reference", "fused"):
        te = _port_engine(problems[prob][1], _opts(name, prob)[1],
                          codec_backend=codec_backend)
        z_t = te.run()
        runs.append((z_t, te.state))
        _close_trees(te.state, je.state)
        _close_trees(z_t, z_j)
        np.testing.assert_array_equal(te.state.t.numpy(),
                                      np.asarray(je.state.t))
        assert te.trace.meta["optimizer"] == je.trace.meta["optimizer"]
        for rt, rj in zip(te.trace.rounds, je.trace.rounds):
            assert rt.local_steps == rj.local_steps
            np.testing.assert_allclose(
                [rt.eta_min, rt.eta_max, rt.eta_mean],
                [rj.eta_min, rj.eta_max, rj.eta_mean], **TOL)
    _bitwise(runs[0], runs[1])


@pytest.mark.parametrize("name", ["segda", "ump"])
def test_run_local_matches_jax(problems, name):
    jp, tp = problems["bilinear"]
    jopt, topt = _opts(name)
    st_j, hist_j = jo.run_local(jopt, jp, num_workers=M, local_k=K, rounds=R,
                                rng=jax.random.PRNGKey(5))
    st_t, hist_t = to.run_local(topt, tp, num_workers=M, local_k=K, rounds=R,
                                rng=jr.PRNGKey(5, device="cpu"), device="cpu")
    assert all(v.shape[0] == R for v in hist_t)
    _close_trees(st_t, st_j)
    _close_trees(hist_t, hist_j)


def test_run_local_zero_rounds_returns_empty_history(problems):
    _, tp = problems["bilinear"]
    st, hist = to.run_local(_opts("sgda")[1], tp, num_workers=M, local_k=K,
                            rounds=0, rng=jr.PRNGKey(0, device="cpu"),
                            device="cpu")
    assert [tuple(v.shape) for v in hist] == [(0, 10), (0, 10)]
    assert st.z[0].shape == (M, 10)


@pytest.mark.parametrize("name", ["sgda", "adam"])
def test_run_serial_matches_jax(problems, name):
    """``lax.scan``'s key splits: 12 steps recorded every 4."""
    jp, tp = problems["bilinear"]
    jopt, topt = _opts(name)
    st_j, hist_j = jo.run_serial(jopt, jp, 12, jax.random.PRNGKey(4),
                                 record_every=4)
    st_t, hist_t = to.run_serial(topt, tp, 12, jr.PRNGKey(4, device="cpu"),
                                 record_every=4)
    assert [tuple(v.shape) for v in hist_t] == [(3, 10), (3, 10)]
    _close_trees(hist_t, hist_j)
    _close_trees(st_t, st_j)


def test_minibatch_matches_jax_and_cuts_the_variance(problems):
    jp, tp = problems["bilinear"]
    jmb, tmb = jo.minibatch(jp, 16), to.minibatch(tp, 16)
    assert tmb.name == jmb.name == "bilinear@mb16"
    keys = jax.random.split(jax.random.PRNGKey(6), M)
    tkeys = torch.tensor(np.asarray(keys).astype(np.int64))
    z_j = jax.vmap(jp.init)(keys)
    z_t = tuple(torch.tensor(np.asarray(v)) for v in z_j)
    xi_j = jax.vmap(jmb.sample)(keys)
    xi_t = tmb.sample(tkeys)
    assert tuple(xi_t.shape) == (M, 16, 10)
    np.testing.assert_allclose(xi_t.numpy(), np.asarray(xi_j), **TOL)
    g_j = jax.vmap(jmb.oracle)(z_j, xi_j)
    g_t = tmb.oracle(z_t, xi_t)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    # variance over draws: batch 16 against batch 1, ~1/16
    many = jr.split(jr.PRNGKey(7, device="cpu"), 256)
    z1 = tuple(v[:1].expand(256, -1) for v in z_t)
    var1 = tp.oracle(z1, tp.sample(many))[0].var(dim=0).mean()
    var16 = tmb.oracle(z1, tmb.sample(many))[0].var(dim=0).mean()
    assert 0.03 < float(var16 / var1) < 0.12


def test_sync_weights_reach_the_engine(problems):
    """UMP's Line-7 weight is its 1/η (the round-end η telemetry falls);
    SGDA's is the constant 1."""
    _, tp = problems["bilinear"]
    eng = _port_engine(tp, to.ump(1.0, 2.0))
    eng.run()
    sum_sq = eng.state.inner["sum_sq"]
    w = eng.worker.sync_weight(eng.state)
    torch.testing.assert_close(w, torch.sqrt(1.0 + sum_sq) / 2.0)
    etas = [r.eta_mean for r in eng.trace.rounds]
    assert etas[-1] < etas[0]
    const = _port_engine(tp, to.sgda(0.05))
    const.run()
    assert all(r.eta_min == r.eta_max == 1.0 for r in const.trace.rounds)


@pytest.mark.parametrize("name", ["segda", "ump"])
def test_zoo_under_stragglers_q8_faults_matches_jax(problems, name):
    """Stragglers + q8 error-feedback uplinks + worker faults, as the JAX
    package's own zoo test runs them, held against the JAX engine on both
    sync backends."""
    jp, tp = problems["bilinear"]
    jopt, topt = _opts(name)

    def policies(mod):
        return dict(schedule=mod.StragglerSchedule(k=K, min_frac=0.4, seed=3),
                    compressor=mod.StochasticQuantizeCompressor(bits=8),
                    faults=mod.BernoulliFaults(p=0.2, seed=5))

    je = _jax_engine(jp, jopt, rounds=6, seed=7, **policies(jps))
    z_j = je.run()
    for codec_backend in ("reference", "fused"):
        te = _port_engine(tp, topt, rounds=6, seed=7,
                          codec_backend=codec_backend, **policies(tps))
        z_t = te.run()
        _close_trees(te.state, je.state)
        _close_trees(z_t, z_j)
        _close_trees(te._ef, je._ef)
        for rt, rj in zip(te.trace.rounds, je.trace.rounds):
            assert (rt.local_steps, rt.alive, rt.bytes_up) == (
                rj.local_steps, rj.alive, rj.bytes_up)
        assert te.trace.steps_per_sec is not None
        assert te.trace.steps_per_sec > 0


@pytest.mark.parametrize("name", ["adam", "ump"])
def test_zoo_with_server_optimizer_matches_jax(problems, name):
    """An outer Nesterov step over the zoo's round deltas, at M = 8 (C6(b):
    the two packages form the server anchor differently off powers of
    two)."""
    jp, tp = problems["bilinear"]
    jopt, topt = _opts(name)
    je = _jax_engine(jp, jopt, m=8,
                     server_opt=jps.ServerNesterov(lr=1.0, beta=0.3))
    z_j = je.run()
    te = _port_engine(tp, topt, m=8, codec_backend="fused",
                      server_opt=tps.ServerNesterov(lr=1.0, beta=0.3))
    z_t = te.run()
    _close_trees(te.state, je.state)
    _close_trees(z_t, z_j)
    np.testing.assert_allclose([r.delta_norm for r in te.trace.rounds],
                               [r.delta_norm for r in je.trace.rounds],
                               rtol=1e-5, atol=1e-6)


def test_robust_ump_at_g0_1_amplifies_ulps(problems, jax_runs):
    """Why the robust rows take G0 = 10: in the JAX package alone, a
    one-ulp jitter of the oracle moves UMP's final state past the bar at
    G0 = 1, and not at G0 = 10."""
    jp = problems["robust"][0]

    def jitter(v):
        up = jnp.sin(v * 1.0e4) > 0
        return jnp.nextafter(v, jnp.where(up, jnp.inf, -jnp.inf))

    jittered = dataclasses.replace(
        jp, oracle=lambda z, xi: tuple(jitter(g) for g in jp.oracle(z, xi)))

    def final_state(prob, g0):
        je = _jax_engine(prob, jo.ump(g0, 2.0))
        je.run()
        return jax.tree.leaves(je.state)

    def excess(ref, other):
        return max(float(np.max(np.abs(np.asarray(a, np.float64) - b)
                                - 1e-6 - 1e-5 * np.abs(np.asarray(b,
                                                                  np.float64))))
                   for a, b in zip(ref, other))

    at_10 = jax.tree.leaves(_jax_run(jax_runs, problems, "robust",
                                     "ump")[1].state)
    assert excess(final_state(jp, 1.0), final_state(jittered, 1.0)) > 0.0
    assert excess(at_10, final_state(jittered, 10.0)) < 0.0


# ---------------------------------------------------------------------------
# The port's own bit-exact invariants
# ---------------------------------------------------------------------------

def test_rerun_is_bit_identical(problems):
    _, tp = problems["robust"]
    runs = []
    for _ in range(2):
        te = _port_engine(tp, _opts("ump", "robust")[1],
                          codec_backend="fused")
        runs.append((te.run(), te.state))
    _bitwise(runs[0], runs[1])


@pytest.mark.parametrize("name,inner_keys", [
    ("sgda", ()), ("segda", ()), ("adam", ("m", "v")), ("ump", ("sum_sq",)),
    ("asmp", ("g_prev", "sum_sq")),
])
def test_resume_equals_the_straight_run(problems, tmp_path, name,
                                        inner_keys):
    """Each method's inner state round-trips through save/restore bit for
    bit, and the resumed run ends where the uninterrupted one does."""
    _, tp = problems["bilinear"]
    opt = _opts(name)[1]
    path = str(tmp_path / "zoo.ckpt")
    straight = _port_engine(tp, opt, rounds=6)
    z_straight = straight.run()
    first = _port_engine(tp, opt, rounds=6)
    first.run(until_round=3)
    first.save(path)
    resumed = _port_engine(tp, opt, rounds=6).restore(path)
    assert resumed.round == 3
    if inner_keys:
        assert sorted(resumed.state.inner) == sorted(inner_keys)
        _bitwise(resumed.state.inner, first.state.inner)
    z_resumed = resumed.run()
    _bitwise(z_resumed, z_straight)
    _bitwise(resumed.state, straight.state)


def test_port_zoo_checkpoint_restores_into_jax(problems, tmp_path):
    """The JAX engine reads a port Adam checkpoint (moments included) and
    runs on to the port's uninterrupted end."""
    jp, tp = problems["bilinear"]
    jopt, topt = _opts("adam")
    whole = _port_engine(tp, topt, rounds=6)
    z_whole = whole.run()
    part = _port_engine(tp, topt, rounds=6)
    part.run(until_round=3)
    path = str(tmp_path / "adam.ckpt")
    part.save(path)
    je = _jax_engine(jp, jopt, rounds=6)
    je.restore(path)
    np.testing.assert_array_equal(np.asarray(je.state.inner["v"][0]),
                                  part.state.inner["v"][0].numpy())
    z_j = je.run()
    _close_trees(z_whole, z_j)


@pytest.mark.parametrize("writer,reader,match", [
    (("sgda", (0.05,)), ("segda", (0.05,)), "different optimizer"),
    (("adam_minimax", (0.02,)), ("ump", (1.0, 2.0)), "layout"),
    (("ump", (1.0, 2.0)), ("ump", (1.0, 8.0)), "different optimizer"),
])
def test_restore_refuses_another_optimizer(problems, tmp_path, writer,
                                           reader, match):
    _, tp = problems["bilinear"]
    path = str(tmp_path / "w.ckpt")
    eng = _port_engine(tp, getattr(to, writer[0])(*writer[1]))
    eng.run(until_round=2)
    eng.save(path)
    other = _port_engine(tp, getattr(to, reader[0])(*reader[1]))
    with pytest.raises(ValueError, match=match):
        other.restore(path)


def test_restore_refuses_another_seed(problems, tmp_path):
    _, tp = problems["bilinear"]
    path = str(tmp_path / "s.ckpt")
    eng = _port_engine(tp, to.adam_minimax(0.02), seed=0)
    eng.run(until_round=2)
    eng.save(path)
    with pytest.raises(ValueError, match="different seed"):
        _port_engine(tp, to.adam_minimax(0.02), seed=1).restore(path)


def test_config_validation_matches_jax(problems):
    _, tp = problems["bilinear"]
    worker = to.MinimaxWorker(to.sgda(0.05))
    with pytest.raises(ValueError, match="backend"):
        tps.PSEngine(tp, tps.PSConfig(num_workers=M, rounds=R, worker=worker,
                                      local_k=K, backend="fused"),
                     rng=jr.PRNGKey(0, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="local_k"):
        tps.PSEngine(tp, tps.PSConfig(num_workers=M, rounds=R,
                                      worker=worker),
                     rng=jr.PRNGKey(0, device="cpu"), device="cpu")
