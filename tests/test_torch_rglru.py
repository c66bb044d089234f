"""The port's RG-LRU recurrent block on the CPU, held against the JAX
package (``repro.models.rglru``): the linear scan against
``lax.associative_scan`` with the same combine and against a float64
sequential loop, the block's initial parameters, its gates, its output
and the gradients of every leaf and of the input.

Tolerances: the scan at rtol 1e-6 / atol 1e-7 against
``lax.associative_scan`` (the port copies its recursion, so it sums in its
order: 0 measured on ``h`` at every length; the running products of ``a``
underflow to subnormals past ~100 steps, which XLA flushes to zero), and
within 4 f32 ulps of the largest |h| against the float64 loop (~1.6 ulps
measured at S = 1024); initial parameters at the repo's init bar (rtol
1e-5, atol 1e-7: ``erfinv`` a few ulps apart, C3; Λ is C9's
``_linspace``); gates and output at rtol 1e-5 / atol 1e-6 (``sigmoid``,
``logaddexp`` and ``tanh`` an ulp apart, C10); gradients at rtol 1e-4 /
atol 1e-5, the language-model tests' ``GRAD_TOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import rglru as jrglru
from repro_torch import interop
from repro_torch.configs.base import ArchConfig
from repro_torch.models import rglru

SCAN_TOL = dict(rtol=1e-6, atol=1e-7)
INIT_TOL = dict(rtol=1e-5, atol=1e-7)
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)

# recurrentgemma's block at narrow width: d_model 64 makes d_rnn round up
# from 64 to 128 (a multiple of 128), so d_rnn != d_model
NARROW = dataclasses.replace(
    jconfigs.get_config("recurrentgemma-9b"), num_layers=3, d_model=64,
    num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128, vocab_size=64,
    sliding_window=6)
CFGS = {"narrow": NARROW, "smoke": jconfigs.smoke_config("recurrentgemma-9b")}
SCAN_LENGTHS = [1, 2, 3, 7, 8, 33, 1024]


def _port(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def _combine(lhs, rhs):
    a1, u1 = lhs
    a2, u2 = rhs
    return a1 * a2, a2 * u1 + u2


def _scan_inputs(s, kind):
    """a in (0, 1); u in (0, 1) or standard normal; (2, s, 64) f32."""
    rs = np.random.RandomState(s)
    a = rs.uniform(0, 1, (2, s, 64)).astype(np.float32)
    u = (rs.uniform(0, 1, (2, s, 64)) if kind == "unit"
         else rs.randn(2, s, 64)).astype(np.float32)
    return a, u


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["unit", "real"])
@pytest.mark.parametrize("s", SCAN_LENGTHS)
def test_scan_matches_associative_scan(s, kind):
    a, u = _scan_inputs(s, kind)
    want_a, want_h = jax.lax.associative_scan(
        _combine, (jnp.asarray(a), jnp.asarray(u)), axis=1)
    got_a, got_h = rglru.linear_scan(torch.tensor(a), torch.tensor(u))
    assert got_h.shape == (2, s, 64)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **SCAN_TOL)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **SCAN_TOL)


@pytest.mark.parametrize("kind", ["unit", "real"])
@pytest.mark.parametrize("s", SCAN_LENGTHS)
def test_scan_matches_a_float64_loop(s, kind):
    """h_t = a_t·h_{t−1} + u_t, one step at a time in float64."""
    a, u = _scan_inputs(s, kind)
    h = np.zeros((2, 64))
    want = []
    for t in range(s):
        h = a[:, t].astype(np.float64) * h + u[:, t]
        want.append(h)
    want = np.stack(want, axis=1)
    got = rglru.linear_scan(torch.tensor(a), torch.tensor(u))[1].numpy()
    ulps = 4 * np.spacing(np.float32(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=ulps)


# ---------------------------------------------------------------------------
# The block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CFGS))
def test_init_rglru_matches_jax_leaf_for_leaf(name):
    """Six keys in JAX's order (in_proj, out_proj, w_a, w_x, the conv, one
    unused), b_a and b_x zeros, Λ = linspace(−2, 2, d_rnn); a batch of keys
    gives stacked leaves, as ``jax.vmap``."""
    jcfg = CFGS[name]
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    want = jax.vmap(lambda k: jrglru.init_rglru(k, jcfg)[0])(keys)
    got = rglru.init_rglru(interop.key_from_numpy(np.asarray(keys),
                                                  device="cpu"), _port(jcfg))
    assert sorted(got) == sorted(want)
    assert sorted(got["conv"]) == ["b", "w"]
    for k in want:
        for g, w in zip(jax.tree.leaves(got[k]), jax.tree.leaves(want[k])):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **INIT_TOL,
                                       err_msg=k)
    assert got["in_proj"].shape[-1] == 2 * jcfg.d_rnn
    if name == "narrow":
        assert jcfg.d_rnn == 128 != jcfg.d_model


def _params(jcfg, seed=3):
    """JAX's initial block with nonzero biases, so every term is live."""
    jp = dict(jrglru.init_rglru(jax.random.PRNGKey(seed), jcfg)[0])
    rs = np.random.RandomState(seed)
    for b in ("b_a", "b_x"):
        jp[b] = jnp.asarray(rs.randn(jcfg.d_rnn).astype(np.float32))
    return jp


def _port_params(jp):
    return jax.tree.map(
        lambda v: torch.tensor(np.asarray(v), requires_grad=True), jp)


@pytest.mark.parametrize("name", list(CFGS))
def test_gates_match_jax(name):
    jcfg = CFGS[name]
    jp = _params(jcfg)
    x = np.random.RandomState(1).randn(2, 11, jcfg.d_rnn).astype(np.float32)
    want_a, want_u = jrglru._gates(jp, jnp.asarray(x))
    got_a, got_u = rglru._gates(_port_params(jp), torch.tensor(x))
    np.testing.assert_allclose(got_a.detach().numpy(), np.asarray(want_a),
                               **OUT_TOL)
    np.testing.assert_allclose(got_u.detach().numpy(), np.asarray(want_u),
                               **OUT_TOL)


@pytest.mark.parametrize("seq", [1, 16, 33])
@pytest.mark.parametrize("name", list(CFGS))
def test_apply_rglru_value_and_gradients_match_jax(name, seq):
    """The output of (B, S, D) inputs, and the gradients of Σ out·cot with
    respect to every leaf of the block (the conv's too) and to the input,
    against ``jax.grad`` under ``jax.jit`` (as the JAX engine runs it: XLA
    contracts the scan's combine into FMAs there, an ulp a step)."""
    jcfg = CFGS[name]
    cfg = _port(jcfg)
    jp = _params(jcfg)
    rs = np.random.RandomState(seq)
    x = rs.randn(2, seq, jcfg.d_model).astype(np.float32)
    cot = rs.randn(*x.shape).astype(np.float32)

    def jloss(p, xx):
        out = jrglru.apply_rglru(p, jcfg, xx)
        return jnp.sum(out * cot), out

    (_, jout), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))

    tp = _port_params(jp)
    xt = torch.tensor(x, requires_grad=True)
    out = rglru.apply_rglru(tp, cfg, xt)
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad(torch.sum(out * torch.tensor(cot)),
                                leaves + [xt])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **OUT_TOL)
    want = [np.asarray(g) for g in jax.tree.leaves(jgp)] + [np.asarray(jgx)]
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jgp)[0]] + ["x"]
    assert len(grads) == len(want) == 10
    for leaf, g, w in zip(names, grads, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL, err_msg=leaf)
