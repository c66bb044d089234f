"""The port's threefry2x32 clone against ``jax.random``: keys, splits, bits
and uniforms bit for bit; normals within a stated tolerance."""
import jax
import numpy as np
import pytest
import torch

from repro_torch import random as jr

SEEDS = [0, 1, 42, 123456, 2**31 - 1, -7]


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_partitionable_threefry_is_the_installed_default():
    # The formulas cloned here are those of the partitionable threefry; a
    # flag change must fail loudly, not silently change every stream.
    assert jax.config.jax_threefry_partitionable is True


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_bit_exact(seed):
    np.testing.assert_array_equal(
        _np(jax.random.PRNGKey(seed)), jr.PRNGKey(seed, device="cpu").numpy())


def test_prngkey_rejects_seeds_outside_int32():
    with pytest.raises(ValueError):
        jr.PRNGKey(2**31, device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 21, 20, 200])  # 20, 200 = K·M
def test_split_bit_exact(seed, num):
    want = _np(jax.random.split(jax.random.PRNGKey(seed), num))
    got = jr.split(jr.PRNGKey(seed, device="cpu"), num).numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (16, 16), (2, 3, 4)])
def test_bits_and_uniform_bit_exact(seed, shape):
    kj, kt = jax.random.PRNGKey(seed), jr.PRNGKey(seed, device="cpu")
    np.testing.assert_array_equal(_np(jax.random.bits(kj, shape)),
                                  jr.bits(kt, shape).numpy())
    for lo, hi in [(0.0, 1.0), (-1.0, 1.0), (0.25, 3.5)]:
        want = np.asarray(jax.random.uniform(kj, shape, minval=lo, maxval=hi))
        got = jr.uniform(kt, shape, lo, hi).numpy()
        np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_normal_close(seed):
    # torch's erfinv vs XLA's on identical uniforms: a few ulps apart.
    kj, kt = jax.random.PRNGKey(seed), jr.PRNGKey(seed, device="cpu")
    want = np.asarray(jax.random.normal(kj, (4000,)))
    got = jr.normal(kt, (4000,)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=3e-5)


def test_batched_keys_match_vmap():
    """Keys (M, 2) against counters: what jax.vmap over keys gives."""
    kj = jax.random.split(jax.random.PRNGKey(3), 5)
    kt = jr.split(jr.PRNGKey(3, device="cpu"), 5)
    np.testing.assert_array_equal(
        _np(jax.vmap(lambda k: jax.random.split(k, 4))(kj)),
        jr.split(kt, 4).numpy())
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (6,), minval=-1.0, maxval=1.0))(kj)),
        jr.uniform(kt, (6,), -1.0, 1.0).numpy())
    np.testing.assert_allclose(
        jr.normal(kt, (9,)).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.normal(k, (9,)))(kj)),
        rtol=1e-5, atol=3e-5)


def test_engine_stream_derivation_bit_exact():
    """The engine's chain: split(rng, M+1) → split(rng0, R) →
    split(rng_round, K·M) → split(step key)."""
    m, r, k = 4, 3, 5
    init = jax.random.split(jax.random.PRNGKey(2), m + 1)
    rounds = jax.random.split(init[0], r)
    steps = jax.random.split(rounds[1], k * m).reshape(k, m, 2)
    inner = jax.vmap(jax.random.split)(steps[2])

    t_init = jr.split(jr.PRNGKey(2, device="cpu"), m + 1)
    t_rounds = jr.split(t_init[0], r)
    t_steps = jr.split(t_rounds[1], k * m).reshape(k, m, 2)
    t_inner = jr.split(t_steps[2])
    np.testing.assert_array_equal(_np(inner), t_inner.numpy())


def test_chunked_draw_equals_one_shot(monkeypatch):
    """Large draws are generated in counter chunks; chunking must not
    change a single bit."""
    key = jr.PRNGKey(11, device="cpu")
    whole = jr.uniform(key, (5, 13), -1.0, 1.0)
    whole_split = jr.split(key, 50)
    monkeypatch.setattr(jr, "_CHUNK", 7)
    torch.testing.assert_close(jr.uniform(key, (5, 13), -1.0, 1.0), whole,
                               rtol=0, atol=0)
    torch.testing.assert_close(jr.split(key, 50), whole_split, rtol=0, atol=0)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jax.random.PRNGKey(11), (5, 13),
                                      minval=-1.0, maxval=1.0)),
        whole.numpy())


def test_keys_must_be_int64_pairs():
    with pytest.raises(ValueError):
        jr.split(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        jr.uniform(torch.zeros(2, dtype=torch.int32), (3,))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7, 11, 13, 2**31, 2**32 - 1])
def test_fold_in_bit_exact(seed, data):
    want = _np(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    got = jr.fold_in(jr.PRNGKey(seed, device="cpu"), data).numpy()
    np.testing.assert_array_equal(want, got)


def test_fold_in_batched_keys_and_range():
    """The engine folds 7 into each round key: per key, as vmap gives."""
    kj = jax.random.split(jax.random.PRNGKey(5), 4)
    kt = jr.split(jr.PRNGKey(5, device="cpu"), 4)
    np.testing.assert_array_equal(
        _np(jax.vmap(lambda k: jax.random.fold_in(k, 7))(kj)),
        jr.fold_in(kt, 7).numpy())
    np.testing.assert_array_equal(
        jr.fold_in(kt[0], 7).numpy(), jr.split(kt[0], 8)[7].numpy())
    with pytest.raises(ValueError):
        jr.fold_in(kt[0], 2**32)
