"""The port's bilinear game against the JAX package's: the same key gives
bit-identical coefficients and initial iterates; residual, duality gap and
oracle agree to f32 tolerance (matrix products sum in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.problems import make_bilinear_game as jax_game
from repro_torch import interop
from repro_torch import random as jr
from repro_torch.problems import make_bilinear_game


@pytest.fixture(scope="module", params=[(0, 10), (3, 37), (7, 64)],
                ids=lambda p: f"seed{p[0]}-n{p[1]}")
def games(request):
    seed, n = request.param
    return (jax_game(jax.random.PRNGKey(seed), n=n, sigma=0.1),
            make_bilinear_game(jr.PRNGKey(seed, device="cpu"), n=n, sigma=0.1,
                               device="cpu"))


def test_coefficients_bit_identical(games):
    jg, tg = games
    for name in ("a", "b", "c"):
        np.testing.assert_array_equal(np.asarray(getattr(jg, name)),
                                      getattr(tg, name).numpy())
    assert tg.n == jg.n


def test_initial_iterates_bit_identical(games):
    """Per-worker init from per-worker keys, as the engines derive them."""
    jg, tg = games
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    want = jax.vmap(lambda k: jg.problem.project(jg.problem.init(k)))(keys)
    got = tg.problem.project(tg.problem.init(
        interop.key_from_numpy(np.asarray(keys), device="cpu")))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _points(n, seed=0):
    rng = np.random.default_rng(seed)
    return [tuple(rng.uniform(-1, 1, (n,)).astype(np.float32)
                  for _ in range(2)) for _ in range(3)]


def test_residual_and_gap_agree(games):
    jg, tg = games
    for x, y in _points(jg.n):
        want_r = float(jg.residual((jnp.asarray(x), jnp.asarray(y))))
        got_r = float(tg.residual((torch.from_numpy(x), torch.from_numpy(y))))
        np.testing.assert_allclose(got_r, want_r, rtol=1e-6)
        want_g = float(jg.duality_gap((jnp.asarray(x), jnp.asarray(y))))
        got_g = float(tg.duality_gap((torch.from_numpy(x),
                                      torch.from_numpy(y))))
        np.testing.assert_allclose(got_g, want_g, rtol=1e-6)


def test_oracle_and_noise_agree(games):
    """Stacked oracle (M rows at once) vs the JAX oracle per worker; the
    noise draw itself agrees to erfinv's few ulps."""
    jg, tg = games
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    tkeys = interop.key_from_numpy(np.asarray(keys), device="cpu")
    xi_j = jax.vmap(jg.problem.sample)(keys)
    xi_t = tg.problem.sample(tkeys)
    np.testing.assert_allclose(xi_t.numpy(), np.asarray(xi_j), rtol=1e-5,
                               atol=3e-6)
    rng = np.random.default_rng(1)
    z = tuple(rng.uniform(-1, 1, (3, jg.n)).astype(np.float32)
              for _ in range(2))
    want = jax.vmap(jg.problem.oracle)(tuple(map(jnp.asarray, z)), xi_j)
    got = tg.problem.oracle(tuple(map(torch.from_numpy, z)),
                            torch.from_numpy(np.array(xi_j)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_game_from_numpy_agrees(games):
    jg, tg = games
    via = interop.game_from_numpy(np.asarray(jg.a), np.asarray(jg.b),
                                  np.asarray(jg.c), jg.sigma, device="cpu")
    for name in ("a", "b", "c"):
        torch.testing.assert_close(getattr(via, name), getattr(tg, name),
                                   rtol=0, atol=0)
    for x, y in _points(jg.n, seed=1):
        z = (torch.from_numpy(x), torch.from_numpy(y))
        torch.testing.assert_close(via.residual(z), tg.residual(z), rtol=0,
                                   atol=0)
