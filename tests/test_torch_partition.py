"""Dirichlet-heterogeneous workers (``repro_torch.ps.partition`` and the
helpers of ``repro_torch.data.synthetic``) against the JAX package.

Bars: the Dirichlet rows at rtol 5e-5 / atol 1e-6 (``random.loggamma``
takes ``log`` of uniforms, and XLA's float32 ``log`` on the CPU is not
correctly rounded, ROADMAP C8; on these seeds no acceptance test flips);
rows sum to 1 within 1e-6; ``quantile_groups`` and the robust problem's
per-worker minibatch indices exactly; the logits at rtol 1e-6 (from the
JAX rows); the bilinear shifts and the heterogeneous engine traces at
rtol 1e-5 / atol 1e-6, the port drawing its own Dirichlet rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jo
from repro import ps as jps
from repro.core import AdaSEGConfig as JaxCfg
from repro.data.synthetic import dirichlet_proportions as jax_dirichlet
from repro.data.synthetic import group_sampling_logits as jax_logits
from repro.data.synthetic import quantile_groups as jax_quantile_groups
from repro.problems import make_bilinear_game as jax_game
from repro.problems import make_robust_logistic as jax_robust
from repro_torch import optim as to
from repro_torch import ps as tps
from repro_torch import random as jr
from repro_torch.core import AdaSEGConfig, kkt_residual
from repro_torch.data.synthetic import (
    dirichlet_proportions,
    group_sampling_logits,
    quantile_groups,
)
from repro_torch.problems import (
    game_from_arrays,
    make_wgan_problem,
    robust_logistic_from_arrays,
)

M = 8
TOL = dict(rtol=1e-5, atol=1e-6)


def _t(x):
    return torch.tensor(np.asarray(x))


def _keys(seed, m=M):
    keys = jax.random.split(jax.random.PRNGKey(seed), m)
    return keys, torch.tensor(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("alpha", [0.4, 2.0])
@pytest.mark.parametrize("shape", [(64, 8), (8, 4)])
def test_dirichlet_proportions_match_jax(alpha, shape):
    for seed in range(3):
        want = np.asarray(jax_dirichlet(jax.random.PRNGKey(seed), *shape,
                                        alpha))
        got = dirichlet_proportions(jr.PRNGKey(seed, device="cpu"), *shape,
                                    alpha)
        assert got.shape == shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=1e-6)
        np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, rtol=0,
                                   atol=1e-6)
        assert bool((got >= 0).all())


def test_quantile_groups_match_jax_with_ties():
    rng = np.random.default_rng(0)
    for n, g in ((10, 3), (32, 4), (101, 7)):
        v = rng.integers(0, 5, size=n).astype(np.float32)       # many ties
        want = np.asarray(jax_quantile_groups(jnp.asarray(v), g))
        got = quantile_groups(_t(v), g)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_group_sampling_logits_match_jax():
    props = np.asarray(jax_dirichlet(jax.random.PRNGKey(3), M, 4, 0.4))
    group_of = np.random.default_rng(1).integers(0, 4, size=32).astype(
        np.int32)
    want = np.asarray(jax_logits(jnp.asarray(props), jnp.asarray(group_of)))
    got = group_sampling_logits(_t(props), _t(group_of))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def games():
    jg = jax_game(jax.random.PRNGKey(0), n=10, sigma=0.1)
    tg = game_from_arrays(_t(jg.a), _t(jg.b), _t(jg.c), 0.1)
    jrl = jax_robust(jax.random.PRNGKey(1), n=32, d=8, batch=8)
    trl = robust_logistic_from_arrays(_t(jrl.features), _t(jrl.labels),
                                      batch=8)
    return jg, tg, jrl, trl


def test_heterogeneous_bilinear_shifts_match_jax(games):
    """σ = 0 leaves the shifts alone: they match the JAX package's and
    their mean over the workers is 0, so the global game is unchanged."""
    jg, tg, _, _ = games
    jg0 = jax_game(jax.random.PRNGKey(0), n=10, sigma=0.0)
    tg0 = game_from_arrays(tg.a, tg.b, tg.c, 0.0)
    keys, tkeys = _keys(2)
    jp = jps.heterogeneous_bilinear(jg0, M, jax.random.PRNGKey(7), alpha=0.4)
    tp = tps.heterogeneous_bilinear(tg0, M, jr.PRNGKey(7, device="cpu"),
                                    alpha=0.4)
    assert tp.name == jp.name == "bilinear@hetero"
    want = np.asarray(jax.vmap(jp.sample_worker)(keys, jnp.arange(M)))
    shifts = tp.sample_worker(tkeys, torch.arange(M, dtype=torch.int32))
    np.testing.assert_allclose(shifts.numpy(), want, **TOL)
    np.testing.assert_allclose(shifts.mean(dim=0).numpy(), 0.0, rtol=0,
                               atol=1e-6)
    assert float(shifts.abs().max()) > 1e-2
    # with noise: the same keys, the same draws, at the noise's tolerance
    jp = jps.heterogeneous_bilinear(jg, M, jax.random.PRNGKey(7), alpha=0.4)
    tp = tps.heterogeneous_bilinear(tg, M, jr.PRNGKey(7, device="cpu"),
                                    alpha=0.4)
    np.testing.assert_allclose(
        tp.sample_worker(tkeys, torch.arange(M)).numpy(),
        np.asarray(jax.vmap(jp.sample_worker)(keys, jnp.arange(M))), **TOL)


@pytest.mark.parametrize("alpha", [0.3, 0.4, 2.0])
def test_heterogeneous_robust_indices_match_jax(games, alpha):
    _, _, jrl, trl = games
    for seed in range(3):
        jp = jps.heterogeneous_robust(jrl, M, jax.random.PRNGKey(seed),
                                      alpha=alpha)
        tp = tps.heterogeneous_robust(trl, M, jr.PRNGKey(seed, device="cpu"),
                                      alpha=alpha)
        keys, tkeys = _keys(10 + seed)
        want = np.asarray(jax.vmap(jp.sample_worker)(keys, jnp.arange(M)))
        got = tp.sample_worker(tkeys, torch.arange(M))
        assert tuple(got.shape) == (M, 8) and got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_heterogenize_dispatch_and_refusals(games):
    _, tg, _, trl = games
    key = jr.PRNGKey(1, device="cpu")
    assert tps.heterogenize(tg, 2, key).name == "bilinear@hetero"
    assert tps.heterogenize(trl, 2, key,
                            num_groups=3).name == "robust_logistic@hetero"
    with pytest.raises(TypeError, match="no heterogeneous partition for "
                                        "object"):
        tps.heterogenize(object(), 2, key)

    # the WGAN, ported since, dispatches to heterogeneous_wgan; a look-alike
    # of the JAX package's wrapper's name is no WGAN problem
    wg = make_wgan_problem(key, latent_dim=2, hidden=4, batch=4)
    assert tps.heterogenize(wg, 2, key).name == "wgan_gp@hetero"

    class WGANProblem:
        pass

    with pytest.raises(TypeError, match="no heterogeneous partition for "
                                        "WGANProblem"):
        tps.heterogenize(WGANProblem(), 2, key)


@pytest.mark.parametrize("which", ["adaseg", "ump"])
def test_hetero_engine_trace_matches_jax(games, which):
    """LocalAdaSEG and UMP on the α = 0.4 heterogeneous game, the port
    drawing its own Dirichlet rows, on both sync backends: residual trace,
    final state and z̄."""
    jg, tg, _, _ = games
    jp = jps.heterogeneous_bilinear(jg, M, jax.random.PRNGKey(7), alpha=0.4)
    tp = tps.heterogeneous_bilinear(tg, M, jr.PRNGKey(7, device="cpu"),
                                    alpha=0.4)
    if which == "adaseg":
        jcfg = dict(adaseg=JaxCfg(g0=1.0, diameter=2.0, k=5))
        tcfg = dict(adaseg=AdaSEGConfig(g0=1.0, diameter=2.0, k=5))
    else:
        jcfg = dict(worker=jo.MinimaxWorker(jo.ump(1.0, 2.0)), local_k=5)
        tcfg = dict(worker=to.MinimaxWorker(to.ump(1.0, 2.0)), local_k=5)
    je = jps.PSEngine(jp, jps.PSConfig(num_workers=M, rounds=4, **jcfg),
                      rng=jax.random.PRNGKey(2), eval_fn=jg.residual)
    z_j = je.run()
    for codec_backend in ("reference", "fused"):
        te = tps.PSEngine(tp, tps.PSConfig(num_workers=M, rounds=4,
                                           codec_backend=codec_backend,
                                           **tcfg),
                          rng=jr.PRNGKey(2, device="cpu"),
                          eval_fn=tg.residual, device="cpu")
        z_t = te.run()
        np.testing.assert_allclose([r.residual for r in te.trace.rounds],
                                   [r.residual for r in je.trace.rounds],
                                   **TOL)
        for a, b in zip(z_t, z_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
        z_state = te.state.z if which == "ump" else te.state.z_tilde
        z_state_j = je.state.z if which == "ump" else je.state.z_tilde
        for a, b in zip(z_state, z_state_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_hetero_robust_engine_runs_and_reruns_bit_identical(games):
    """LocalAdaSEG on the heterogeneous robust problem (the product
    projection runs the reference math under the fused backend), evaluated
    by ``kkt_residual``; the run repeats to the bit."""
    _, _, _, trl = games
    tp = tps.heterogeneous_robust(trl, M, jr.PRNGKey(3, device="cpu"),
                                  alpha=0.4)
    runs = []
    for _ in range(2):
        te = tps.PSEngine(
            tp, tps.PSConfig(num_workers=M, rounds=3, backend="fused",
                             codec_backend="fused",
                             adaseg=AdaSEGConfig(g0=10.0, diameter=2.0, k=4)),
            rng=jr.PRNGKey(2, device="cpu"),
            eval_fn=lambda z: kkt_residual(tp, z), device="cpu")
        runs.append((te.run(), [r.residual for r in te.trace.rounds]))
    assert runs[0][1] == runs[1][1]
    assert all(np.isfinite(runs[0][1]))
    for a, b in zip(runs[0][0], runs[1][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
