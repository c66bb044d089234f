"""The port's problems and core pieces of the zoo slice against the JAX
package: ``random.randint`` bit for bit, the quadratic game and the robust
logistic problem at rtol 1e-5 (their matrices carried across from the JAX
package; ``normal`` is a few ulps off XLA's, ROADMAP C3), the ``product``
projection, the tree helpers, ``from_loss``, ``kkt_residual`` and
``sync_state``. The robust oracle's scatter of duplicate indices is
deterministic: reruns are bit-identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AdaSEGConfig as JaxCfg
from repro.core import init as jax_init
from repro.core import sync_state as jax_sync_state
from repro.core import sync_weighted_stacked as jax_sync
from repro.core import tree as jtree
from repro.core.metrics import kkt_residual as jax_kkt
from repro.core.projections import l2_ball as jax_l2_ball
from repro.core.projections import product as jax_product
from repro.core.projections import simplex as jax_simplex
from repro.problems import make_bilinear_game as jax_game
from repro.problems import make_quadratic_game as jax_quadratic
from repro.problems import make_robust_logistic as jax_robust
from repro_torch import random as jr
from repro_torch.core import (
    AdaSEGConfig,
    from_loss,
    init,
    kkt_residual,
    projections,
    sync_state,
    sync_weighted_stacked,
    tree,
)
from repro_torch.problems import (
    make_bilinear_game,
    make_quadratic_game,
    make_robust_logistic,
    quadratic_game_from_arrays,
    robust_logistic_from_arrays,
)

TOL = dict(rtol=1e-5, atol=1e-6)
M = 4


def _t(x):
    return torch.tensor(np.asarray(x))


def _keys(seed, m=M):
    keys = jax.random.split(jax.random.PRNGKey(seed), m)
    return keys, torch.tensor(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [(0, 10), (0, 32), (0, 32561), (-7, 100003),
                                   (5, 1 << 20), (0, (1 << 31) - 1), (3, 3)])
def test_randint_is_bit_exact(lo, hi):
    """Spans below and above 2^16 (the multiplier wraps in uint32), powers
    of two and not, and an empty range (minval every time)."""
    for seed in (0, 11):
        want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                             (3, 40), lo, hi))
        got = jr.randint(jr.PRNGKey(seed, device="cpu"), (3, 40), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    keys, tkeys = _keys(2)
    want = jax.vmap(lambda k: jax.random.randint(k, (6,), lo, hi))(keys)
    np.testing.assert_array_equal(jr.randint(tkeys, (6,), lo, hi).numpy(),
                                  np.asarray(want))


@pytest.fixture(scope="module")
def quadratic():
    jq = jax_quadratic(jax.random.PRNGKey(0), n=10)
    tq = quadratic_game_from_arrays(*(_t(getattr(jq, f)) for f in "pqabc"))
    return jq, tq


def test_quadratic_draw_matches_jax(quadratic):
    jq, _ = quadratic
    tq = make_quadratic_game(jr.PRNGKey(0, device="cpu"), n=10, device="cpu")
    for f in "pqabc":
        np.testing.assert_allclose(getattr(tq, f).numpy(),
                                   np.asarray(getattr(jq, f)), **TOL)


def test_quadratic_saddle_and_oracles_match_jax(quadratic):
    jq, tq = quadratic
    for a, b in zip(tq.z_star, jq.z_star):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    keys, tkeys = _keys(3)
    z_j = jax.vmap(jq.problem.init)(keys)
    z_t = tq.problem.init(tkeys)
    for a, b in zip(z_t, z_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    z = tuple(_t(v) for v in z_j)
    xi_j = jax.vmap(jq.problem.sample)(keys)
    np.testing.assert_allclose(tq.problem.sample(tkeys).numpy(),
                               np.asarray(xi_j), **TOL)
    for got, want in ((tq.problem.oracle(z, _t(xi_j)),
                       jax.vmap(jq.problem.oracle)(z_j, xi_j)),
                      (tq.problem.mean_oracle(z, None),
                       jax.vmap(lambda zz: jq.problem.mean_oracle(zz, None))(
                           z_j))):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(float(tq.distance_to_saddle((z[0][0],
                                                            z[1][0]))),
                               float(jq.distance_to_saddle((z_j[0][0],
                                                            z_j[1][0]))),
                               **TOL)


@pytest.fixture(scope="module")
def robust():
    jrl = jax_robust(jax.random.PRNGKey(1), n=32, d=8, batch=8)
    trl = robust_logistic_from_arrays(_t(jrl.features), _t(jrl.labels),
                                      batch=8)
    return jrl, trl


def _robust_point(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(M, 8)).astype(np.float32)
    p = rng.dirichlet(np.ones(32), size=M).astype(np.float32)
    return w, p


def test_robust_draw_matches_jax(robust):
    jrl, trl = robust
    t2 = make_robust_logistic(jr.PRNGKey(1, device="cpu"), n=32, d=8,
                              batch=8, device="cpu")
    np.testing.assert_allclose(t2.features.numpy(), np.asarray(jrl.features),
                               **TOL)
    np.testing.assert_array_equal(t2.labels.numpy(), np.asarray(jrl.labels))
    keys, tkeys = _keys(5)
    for a, b in zip(trl.problem.init(tkeys),
                    jax.vmap(jrl.problem.init)(keys)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_array_equal(trl.problem.sample(tkeys).numpy(),
                                  np.asarray(jax.vmap(jrl.problem.sample)(
                                      keys)))


def test_robust_oracles_match_jax_with_duplicates(robust):
    """Minibatches with an index drawn once, twice and three times."""
    jrl, trl = robust
    w, p = _robust_point(0)
    idx = np.array([[1, 1, 1, 2, 3, 3, 5, 31], [0, 7, 7, 9, 9, 9, 9, 12],
                    [4, 5, 6, 7, 8, 9, 10, 11], [31] * 8], dtype=np.int32)
    want = jax.vmap(jrl.problem.oracle)((w, p), jnp.asarray(idx))
    got = trl.problem.oracle((_t(w), _t(p)), _t(idx))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    again = trl.problem.oracle((_t(w), _t(p)), _t(idx))
    for a, b in zip(got, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = jax.vmap(lambda z: jrl.problem.mean_oracle(z, None))((w, p))
    got = trl.problem.mean_oracle((_t(w), _t(p)), None)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_robust_metrics_match_jax(robust):
    jrl, trl = robust
    w, p = _robust_point(1)
    kkt_j = jax.vmap(lambda z: jax_kkt(jrl.problem, z))((w, p))
    obj_j = jax.vmap(jrl.objective)((w, p))
    for m in range(M):
        z_t = (_t(w[m]), _t(p[m]))
        np.testing.assert_allclose(float(kkt_residual(trl.problem, z_t)),
                                   float(kkt_j[m]), **TOL)
        np.testing.assert_allclose(float(trl.objective(z_t)),
                                   float(obj_j[m]), **TOL)


def test_kkt_residual_is_the_bilinear_residual():
    game = make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=6, sigma=0.1,
                              device="cpu")
    z = (torch.linspace(-1, 1, 6), torch.linspace(1, -0.5, 6))
    torch.testing.assert_close(kkt_residual(game.problem, z),
                               game.residual(z))
    no_mean = make_robust_logistic(jr.PRNGKey(0, device="cpu"), n=8, d=2,
                                   batch=2, device="cpu").problem
    with pytest.raises(ValueError, match="mean_oracle"):
        kkt_residual(dataclasses.replace(no_mean, mean_oracle=None), z)


def test_product_projection_matches_jax():
    rng = np.random.default_rng(2)
    x = (3 * rng.normal(size=(M, 5))).astype(np.float32)
    y = rng.normal(size=(M, 7)).astype(np.float32)
    jproj = jax_product(jax_l2_ball(2.0), jax_simplex())
    want = jax.vmap(lambda a, b: jproj((a, b)))(x, y)
    proj = projections.product(projections.l2_ball(2.0),
                               projections.simplex())
    got = proj((_t(x), _t(y)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert projections.spec_of(proj) is None


def test_tree_helpers_match_jax():
    rng = np.random.default_rng(3)
    a = tuple(rng.normal(size=(M, 5)).astype(np.float32) for _ in range(2))
    b = tuple(rng.normal(size=(M, 5)).astype(np.float32) for _ in range(2))
    ta, tb = tuple(map(_t, a)), tuple(map(_t, b))
    for got, want in zip(tree.tree_add(ta, tb), jtree.tree_add(a, b)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(tree.tree_dot(ta, tb).numpy(),
                               np.asarray(jax.vmap(jtree.tree_dot)(a, b)),
                               **TOL)
    cast = tree.tree_cast(ta, torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in cast)
    assert tree.tree_size(ta) == jtree.tree_size(a) == 2 * M * 5
    np.testing.assert_allclose(
        tree.tree_norm(ta).numpy(),
        np.asarray(jax.vmap(jtree.tree_norm)(a)), **TOL)


def test_from_loss_gives_the_bilinear_oracle():
    """[∇x f, −∇y f] of the bilinear saddle loss by autograd equals the
    game's hand-written oracle."""
    game = make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=6, sigma=0.1,
                              device="cpu")
    a, b, c = game.a, game.b, game.c

    def loss(z, xi):
        x, y = z
        return ((x * (y @ a.T)).sum(-1) + ((b + xi) * x).sum(-1)
                + ((c + xi) * y).sum(-1))

    prob = from_loss(loss, game.problem.init, game.problem.sample,
                     game.problem.project, name="bilinear-from-loss")
    keys = jr.split(jr.PRNGKey(1, device="cpu"), M)
    z = game.problem.init(keys)
    xi = game.problem.sample(keys)
    for got, want in zip(prob.oracle(z, xi), game.problem.oracle(z, xi)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert prob.mean_oracle is None and prob.name == "bilinear-from-loss"
    assert not any(v.requires_grad for v in prob.oracle(z, xi))


def test_sync_state_matches_jax():
    jg = jax_game(jax.random.PRNGKey(0), n=10, sigma=0.1)
    tg = make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=10, sigma=0.1,
                            device="cpu")
    cfg = dict(g0=1.0, diameter=2.0, k=5)
    keys, tkeys = _keys(4)
    st_j = jax.vmap(lambda k, w: jax_init(jg.problem, JaxCfg(**cfg), k, w))(
        keys, jnp.arange(M, dtype=jnp.int32))
    st_j = st_j._replace(sum_sq=jnp.array([0.0, 1.0, 4.0, 9.0], jnp.float32))
    st_t = init(tg.problem, AdaSEGConfig(**cfg), tkeys)
    st_t = st_t._replace(sum_sq=_t(st_j.sum_sq))
    got = sync_state(st_t, AdaSEGConfig(**cfg), sync_weighted_stacked)
    want = jax_sync_state(st_j, JaxCfg(**cfg), jax_sync)
    for a, b in zip(got.z_tilde, want.z_tilde):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert all(bool((v == v[:1]).all()) for v in got.z_tilde)
