"""The port's Mixture-of-Experts layer on the CPU, held against the JAX
package (``repro.models.moe``) at narrow granite- and mixtral-shaped
configs: initial parameters, the layer's output, aux loss and gradients,
which choices are dropped at capacity (including exact ties and an order
where token-major and choice-major capacity differ), and the dispatch and
combine gathers under ``torch.autograd.gradcheck``.

Tolerances: initial parameters at the repo's init bar (rtol 1e-5, atol
1e-7: the same keys and uniforms, ``erfinv`` a few ulps apart, C3); output
and aux at rtol 1e-5 / atol 1e-6; gradients at rtol 1e-4 / atol 1e-5, the
language-model tests' ``GRAD_TOL``. Routing decisions (experts chosen,
choices kept) are held exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro_torch import interop
from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe

OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
INIT_TOL = dict(rtol=1e-5, atol=1e-7)

# granite's routing (32 experts, top-8) and mixtral's (8 experts, top-2) at
# narrow widths; the rest of each config does not reach the layer
GRANITE = dataclasses.replace(
    jconfigs.get_config("granite-moe-1b-a400m"), num_layers=2, d_model=32,
    num_heads=4, num_kv_heads=2, head_dim=8, d_ff=16, vocab_size=64)
MIXTRAL = dataclasses.replace(
    jconfigs.get_config("mixtral-8x22b"), num_layers=2, d_model=32,
    num_heads=4, num_kv_heads=2, head_dim=8, d_ff=24, vocab_size=64,
    sliding_window=6)
CFGS = {"granite": GRANITE, "mixtral": MIXTRAL}
# (capacity factor, batch, seq): no drops; and a capacity of 8 slots for
# 2·64·k choices, where some tokens lose every choice
CASES = {"no_drops": (8.0, 2, 16), "drops": (0.05, 2, 64)}


def _port(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def _key(seed):
    return interop.key_from_numpy(np.asarray(jax.random.PRNGKey(seed)),
                                  device="cpu")


def _jax_params(jcfg, seed=3):
    return jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)[0]


def _port_params(jp):
    return {k: torch.tensor(np.asarray(v), requires_grad=True)
            for k, v in jp.items()}


def _jax_routing(jp, jcfg, x):
    """The JAX package's routing lines (``moe.py:65-84``), for the experts
    chosen and the choices kept, which ``apply_moe`` does not return."""
    n = x.shape[0] * x.shape[1]
    e, k = jcfg.num_experts, jcfg.experts_per_token
    tokens = jnp.asarray(x).reshape(n, -1)
    probs = jax.nn.softmax(tokens @ jp["router"], axis=-1)
    _, top_e = jax.lax.top_k(probs, k)
    flat = jax.nn.one_hot(top_e, e, dtype=jnp.int32).reshape(n * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat,
                  axis=-1).reshape(n, k)
    return np.asarray(top_e), np.asarray(pos < jmoe._capacity(jcfg, n))


def _kept_sets(top_e, keep):
    return [sorted(int(e) for e, kk in zip(row_e, row_k) if kk)
            for row_e, row_k in zip(top_e, keep)]


def _port_routing(tp, cfg, x):
    n = x.shape[0] * x.shape[1]
    tokens = torch.tensor(x).reshape(n, -1)
    probs = torch.softmax(tokens @ tp["router"].detach(), dim=-1)
    r = moe.route(probs, cfg.experts_per_token, moe._capacity(cfg, n))
    return r.top_e.numpy(), r.keep.numpy()


def _both(jcfg, x, cot, jp=None):
    """Output, aux and the gradients of Σ out·cot + 0.3·aux (every MoE leaf
    and the input) in both packages, from the same weights."""
    jp = _jax_params(jcfg) if jp is None else jp

    def jloss(p, xx):
        out, aux = jmoe.apply_moe(p, jcfg, xx)
        return jnp.sum(out * cot) + 0.3 * aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    cfg = _port(jcfg)
    tp = _port_params(jp)
    xt = torch.tensor(x, requires_grad=True)
    out, aux = moe.apply_moe(tp, cfg, xt)
    loss = torch.sum(out * torch.tensor(cot)) + 0.3 * aux
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [tp[k] for k in names] + [xt])
    want = [np.asarray(jgrads[0][k]) for k in names] + [np.asarray(jgrads[1])]
    return dict(jp=jp, tp=tp, cfg=cfg, out=(out.detach().numpy(),
                                            np.asarray(jout)),
                aux=(float(aux.detach()), float(jaux)),
                grads=list(zip(names + ["x"], [g.numpy() for g in grads],
                               want)))


def _inputs(jcfg, batch, seq, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, seq, jcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    return x, cot


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(CFGS))
def test_init_moe_matches_jax_leaf_for_leaf(name):
    """The key splits four ways in JAX's order (router, w_in, w_gate,
    w_out) with JAX's scales; a batch of keys gives stacked leaves, as
    ``jax.vmap``."""
    jcfg = CFGS[name]
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    want = jax.vmap(lambda k: jmoe.init_moe(k, jcfg)[0])(keys)
    got = moe.init_moe(interop.key_from_numpy(np.asarray(keys),
                                              device="cpu"), _port(jcfg))
    assert sorted(got) == sorted(want) == ["router", "w_gate", "w_in",
                                           "w_out"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **INIT_TOL)


# granite at full width first: one worker's 1 × 1024 tokens, 320 slots
@pytest.mark.parametrize("cf,n,k,e", [(1.25, 1024, 8, 32), (1.25, 32, 2, 8),
                                      (0.05, 128, 2, 8), (8.0, 16, 2, 4),
                                      (1.0, 100, 3, 7)])
def test_capacity_matches_jax(cf, n, k, e):
    jcfg = dataclasses.replace(GRANITE, capacity_factor=cf, num_experts=e,
                               experts_per_token=k)
    assert moe._capacity(_port(jcfg), n) == jmoe._capacity(jcfg, n)


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", list(CFGS))
def test_apply_moe_matches_jax(name, case):
    """Output and aux at rtol 1e-5 / atol 1e-6; the gradient of every MoE
    leaf and of the input at rtol 1e-4 / atol 1e-5; the same choices kept,
    token for token. Under ``drops`` some token loses every choice, and its
    output row is exactly zero in both packages."""
    cf, batch, seq = CASES[case]
    jcfg = dataclasses.replace(CFGS[name], capacity_factor=cf)
    x, cot = _inputs(jcfg, batch, seq)
    r = _both(jcfg, x, cot)
    np.testing.assert_allclose(*r["out"], **OUT_TOL)
    np.testing.assert_allclose(*r["aux"], **OUT_TOL)
    for leaf, got, want in r["grads"]:
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=leaf)

    jtop, jkeep = _jax_routing(r["jp"], jcfg, x)
    ttop, tkeep = _port_routing(r["tp"], r["cfg"], x)
    assert _kept_sets(ttop, tkeep) == _kept_sets(jtop, jkeep)
    np.testing.assert_array_equal(np.sort(ttop, axis=1),
                                  np.sort(jtop, axis=1))
    lost = ~jkeep.any(axis=1)
    out, jout = (v.reshape(-1, jcfg.d_model) for v in r["out"])
    np.testing.assert_array_equal(np.all(out == 0, axis=1),
                                  np.all(jout == 0, axis=1))
    assert np.all(out[lost] == 0)
    if case == "drops":
        assert lost.any() and jkeep.any(axis=1).any()
        np.testing.assert_array_equal(tkeep.sum(axis=1), jkeep.sum(axis=1))
    else:
        assert jkeep.all() and tkeep.all()


def _choice_major_keep(top_e, e, cap):
    """What a choice-major cumsum (all first choices before any second)
    would keep: the order the JAX package's comment names, not its code."""
    n, k = top_e.shape
    flat = np.eye(e, dtype=np.int64)[top_e.T.reshape(-1)]
    pos = np.sum((np.cumsum(flat, axis=0) - flat) * flat, axis=-1)
    return (pos.reshape(k, n) < cap).T


def test_capacity_is_token_major():
    """Twelve tokens over two experts, top-2, 8 slots each, first choices
    alternating. JAX's cumsum runs over rows t·k + j: tokens 0-7 keep both
    choices and tokens 8-11 lose both. A choice-major order would keep a
    choice of every token. The port drops what JAX drops."""
    jcfg = dataclasses.replace(GRANITE, num_experts=2, experts_per_token=2,
                               capacity_factor=0.5)
    jp = dict(_jax_params(jcfg))
    router = np.zeros((jcfg.d_model, 2), np.float32)
    router[0] = (1.0, -1.0)
    jp["router"] = jnp.asarray(router)
    x = np.zeros((1, 12, jcfg.d_model), np.float32)
    x[0, :, 0] = np.where(np.arange(12) % 2 == 0, 1.0, -1.0)
    x[0, :, 1:] = np.random.default_rng(2).standard_normal((12, 31))
    jtop, jkeep = _jax_routing(jp, jcfg, x)
    assert jmoe._capacity(jcfg, 12) == 8
    np.testing.assert_array_equal(jkeep.all(axis=1), np.arange(12) < 8)
    np.testing.assert_array_equal(jkeep.any(axis=1), np.arange(12) < 8)
    assert _choice_major_keep(jtop, 2, 8).any(axis=1).all()

    _, cot = _inputs(jcfg, 1, 12)
    r = _both(jcfg, x, cot, jp=jp)
    ttop, tkeep = _port_routing(r["tp"], r["cfg"], x)
    assert _kept_sets(ttop, tkeep) == _kept_sets(jtop, jkeep)
    out, jout = (v.reshape(12, -1) for v in r["out"])
    assert np.all(out[8:] == 0) and np.all(jout[8:] == 0)
    np.testing.assert_allclose(out, jout, **OUT_TOL)
    np.testing.assert_allclose(*r["aux"], **OUT_TOL)
    for leaf, got, want in r["grads"]:
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=leaf)


@pytest.mark.parametrize("name", list(CFGS))
def test_exact_ties_choose_the_lower_expert(name):
    """A router of zeros ties every probability: ``lax.top_k`` takes
    experts 0..k-1 for every token, so those k experts fill to capacity
    and every later token is dropped whole. The port chooses the same
    experts and zeroes the same output rows."""
    jcfg = dataclasses.replace(CFGS[name], capacity_factor=0.05)
    jp = dict(_jax_params(jcfg))
    jp["router"] = jnp.zeros_like(jp["router"])
    x, cot = _inputs(jcfg, 2, 16)
    jtop, jkeep = _jax_routing(jp, jcfg, x)
    k = jcfg.experts_per_token
    assert (jtop == np.arange(k)).all()
    r = _both(jcfg, x, cot, jp=jp)
    ttop, tkeep = _port_routing(r["tp"], r["cfg"], x)
    np.testing.assert_array_equal(ttop, jtop)      # ascending = tie order
    np.testing.assert_array_equal(tkeep, jkeep)
    cap = jmoe._capacity(jcfg, 32)
    out, jout = (v.reshape(32, -1) for v in r["out"])
    zero = np.all(jout == 0, axis=1)
    np.testing.assert_array_equal(zero, np.arange(32) >= cap)
    np.testing.assert_array_equal(np.all(out == 0, axis=1), zero)
    np.testing.assert_allclose(out, jout, **OUT_TOL)
    for leaf, got, want in r["grads"]:
        np.testing.assert_allclose(got, want, **GRAD_TOL, err_msg=leaf)


def test_shard_dispatch_is_inert():
    cfg = _port(GRANITE)
    tp = _port_params(_jax_params(GRANITE))
    x = torch.tensor(_inputs(GRANITE, 1, 8)[0])
    a, aux_a = moe.apply_moe(tp, cfg, x)
    b, aux_b = moe.apply_moe(tp, cfg, x, shard_dispatch=True)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def _granite_first_moe_input(n):
    """The JAX package's granite at its published width, cut to its first
    block, at init: the input that block's MoE layer sees on one worker's
    1 × n Markov-Zipf tokens (embedding, then pre-norm causal attention
    with its residual, then the MLP norm), and that layer's parameters
    (``init_moe``'s, through ``init_model``), computed under ``jax.jit``."""
    from repro.data.synthetic import make_batch
    from repro.models.attention import apply_attention
    from repro.models.layers import apply_embedding
    from repro.models.transformer import apply_norm, init_model

    jcfg = dataclasses.replace(jconfigs.get_config("granite-moe-1b-a400m"),
                               num_layers=1)

    def build(key, token_key):
        params = init_model(key, jcfg)[0]
        block = jax.tree.map(lambda v: v[0], params["stages"][0])
        tokens = make_batch(token_key, jcfg, 1, n)["tokens"]
        x = apply_embedding(params["embed"], tokens)
        x = x + apply_attention(block["mixer"], jcfg,
                                apply_norm(jcfg, block["pre_norm"], x),
                                jnp.arange(n)[None, :], window=None)
        return block["mlp"], apply_norm(jcfg, block["mlp_norm"], x)

    jp, h = jax.jit(build)(jax.random.PRNGKey(7), jax.random.PRNGKey(987))
    return jcfg, jp, np.asarray(h)


def test_granite_full_width_drops_what_jax_drops():
    """C23: one MoE layer at granite's published width (d_model 1024, 32
    experts top-8 of d_ff 512, capacity factor 1.25: 320 slots an expert)
    on 1 × 1024 tokens, forward only, on the input the model's first MoE
    layer sees at init, the same numpy array in both packages. The port
    drops the choices the JAX package drops: the same count (over a
    quarter of the 8192 here, 34.9%, as the card's 38.0% at layer 0), the
    same load routed to and kept by each expert; the output at rtol 1e-5
    / atol 1e-6."""
    n = 1024
    jcfg, jp, x = _granite_first_moe_input(n)
    jout, _ = jax.jit(lambda p, v: jmoe.apply_moe(p, jcfg, v))(
        jp, jnp.asarray(x))
    cfg = _port(jcfg)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    seen = []
    with torch.no_grad():
        out, _ = moe.apply_moe(tp, cfg, torch.tensor(x), dropped=seen)

    assert moe._capacity(cfg, n) == jmoe._capacity(jcfg, n) == 320
    jtop, jkeep = _jax_routing(jp, jcfg, x)
    ttop, tkeep = _port_routing(tp, cfg, x)
    dropped = int((~jkeep).sum())
    assert int(seen[0]) == int((~tkeep).sum()) == dropped
    assert dropped > 0.25 * n * jcfg.experts_per_token
    e = jcfg.num_experts
    np.testing.assert_array_equal(np.bincount(ttop.ravel(), minlength=e),
                                  np.bincount(jtop.ravel(), minlength=e))
    kept = np.bincount(ttop[tkeep], minlength=e)
    np.testing.assert_array_equal(kept, np.bincount(jtop[jkeep],
                                                    minlength=e))
    assert kept.max() == 320
    assert _kept_sets(ttop, tkeep) == _kept_sets(jtop, jkeep)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **OUT_TOL)


def test_dropped_counts_the_choices_past_capacity():
    jcfg = dataclasses.replace(MIXTRAL, capacity_factor=0.05)
    x, _ = _inputs(jcfg, 2, 64)
    _, jkeep = _jax_routing(_jax_params(jcfg), jcfg, x)
    seen = []
    moe.apply_moe(_port_params(_jax_params(jcfg)), _port(jcfg),
                  torch.tensor(x), dropped=seen)
    assert [int(v) for v in seen] == [int((~jkeep).sum())]


# ---------------------------------------------------------------------------
# The dispatch and combine gathers
# ---------------------------------------------------------------------------

def _tiny_routes(cf):
    cfg = _port(dataclasses.replace(MIXTRAL, num_experts=4,
                                    experts_per_token=2, capacity_factor=cf))
    gen = torch.Generator().manual_seed(0)
    # skewed towards expert 0, away from expert 3: at 8 slots an expert,
    # expert 0 overflows while expert 3 has empty slots
    bias = torch.tensor([3.0, 1.0, 0.0, -3.0])
    probs = torch.softmax(torch.randn(24, 4, generator=gen) + bias, dim=-1)
    cap = moe._capacity(cfg, 24)
    return moe.route(probs, 2, cap), cap, gen


@pytest.mark.parametrize("cf", [8.0, 0.2])
def test_dispatch_and_combine_pass_gradcheck(cf):
    """float64 at 24 tokens, 4 experts, top-2: with free slots (8.0) and
    with choices dropped and slots empty (0.2: 8 slots an expert)."""
    r, cap, gen = _tiny_routes(cf)
    tokens = torch.randn(24, 3, generator=gen, dtype=torch.float64,
                         requires_grad=True)
    ye = torch.randn(4 * cap, 3, generator=gen, dtype=torch.float64,
                     requires_grad=True)
    gate = torch.rand(24, 2, generator=gen, dtype=torch.float64)
    gate = torch.where(r.keep, gate, 0.0).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda t: moe._Dispatch.apply(t, r), (tokens,))
    assert torch.autograd.gradcheck(
        lambda y, g: moe._Combine.apply(y, g, r), (ye, gate))


def test_dispatch_and_combine_are_the_scatters_they_replace():
    """Forward: the dispatch is ``tokens[slot_tok]`` with zero rows at
    empty slots; the combine is the gated scatter-add of the slots back to
    their tokens (``index_add_``), equal to the bit here (each token's
    terms in ascending expert order, as the scatter adds them)."""
    r, cap, gen = _tiny_routes(0.2)
    tokens = torch.randn(24, 3, generator=gen)
    xe = moe._Dispatch.apply(tokens, r)
    empty = r.slot_tok == 24
    assert empty.any() and not r.keep.all()
    assert torch.equal(xe[~empty], tokens[r.slot_tok[~empty]])
    assert torch.all(xe[empty] == 0)
    ye = torch.randn(4 * cap, 3, generator=gen)
    gate = torch.where(r.keep, torch.rand(24, 2, generator=gen), 0.0)
    slot_gate = torch.cat([gate.reshape(-1), torch.zeros(1)])[r.slot_choice]
    want = torch.zeros(25, 3).index_add_(
        0, r.slot_tok, ye * slot_gate[:, None])[:24]
    assert torch.equal(moe._Combine.apply(ye, gate, r), want)
