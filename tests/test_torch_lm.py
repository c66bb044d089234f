"""The port's language-model training path on the CPU, held against the JAX
package at tiny size: the configs, the Markov-Zipf token stream, the
transformer's initial parameters, loss and gradients (reference attention
and the flash route), ``make_ps_engine`` end to end, the ``ModelWorker``
fingerprint, and checkpoints across architectures and packages.

Eight configs: ``tiny_lm_config()``, a narrow qwen2-shaped one (QKV bias,
tied embeddings, GQA 14:2, head_dim 8, rope θ 1e6, 2 layers, vocab 256),
narrow gemma2- and qwen3-shaped ones for their branches, a narrow
mamba2-shaped one (SSD blocks, no MLP), narrow granite- and
mixtral-shaped ones (MoE layers: 32 experts top-8, and 8 experts top-2
under sliding windows), and a narrow recurrentgemma-shaped one (RG-LRU
blocks and local attention: two stacked groups and a two-layer tail).
Nothing runs at full width. Tolerances are stated at each assertion; the
two packages differ in f32 sum order and in ``erfinv``/``log`` ulps
(ROADMAP C3), never in the tokens drawn.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.adaseg import AdaSEGConfig as JaxAdaSEG
from repro.data.synthetic import make_batch as jax_make_batch
from repro.data.synthetic import sample_tokens as jax_sample_tokens
from repro.launch.train import TrainPlan as JaxPlan
from repro.launch.train import make_ps_engine as jax_make_ps_engine
from repro.models import ModelWorker as JaxModelWorker
from repro.models.problem import make_lm_problem as jax_make_lm_problem
from repro.models.problem import tiny_lm_config as jax_tiny
from repro.models.transformer import init_model as jax_init_model
from repro.models.transformer import loss_fn as jax_loss_fn
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.configs.base import ArchConfig
from repro_torch.core import AdaSEGConfig
from repro_torch.data.synthetic import make_batch, sample_tokens
from repro_torch.launch import TrainPlan, make_ps_engine
from repro_torch.models import ModelWorker, init_model, loss_fn
from repro_torch.models.problem import make_lm_problem
from repro_torch.models.transformer import param_leaves, param_tree

M, K, R = 2, 2, 2
BATCH, SEQ = 2, 16
ADASEG = dict(g0=20.0, diameter=2.0, alpha=M ** -0.5, k=K,
              average_output=False)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
TRACE_RTOL = 1e-5
ZBAR_TOL = dict(rtol=1e-4, atol=1e-5)

QWEN2_NARROW = jconfigs.ArchConfig(
    name="qwen2-narrow", arch_type="dense", num_layers=2, d_model=112,
    num_heads=14, num_kv_heads=2, head_dim=8, d_ff=224, vocab_size=256,
    qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
    max_seq_len=64,
)
# gemma2's branches: local/global layers (a window shorter than SEQ, and a
# tail layer past the two stacked groups), attention and final soft caps,
# an attention scale other than head_dim^-0.5, post-norms, a scaled
# embedding and GeGLU.
GEMMA2_NARROW = jconfigs.ArchConfig(
    name="gemma2-narrow", arch_type="dense", num_layers=5, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    layer_pattern="local_global", sliding_window=6, attn_softcap=5.0,
    final_softcap=3.0, attn_scale=0.2, post_norm=True, scale_embed=True,
    tie_embeddings=True, activation="gelu", max_seq_len=64,
)
# qwen3's branch: RMSNorm of q and k per head.
QWEN3_NARROW = jconfigs.ArchConfig(
    name="qwen3-narrow", arch_type="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    qk_norm=True, rope_theta=1_000_000.0, max_seq_len=64,
)
# mamba2's branch: SSD blocks (8 heads of 16, state 16, chunk 8, so SEQ
# spans two chunks), the causal conv, no MLP, tied embeddings.
MAMBA2_NARROW = jconfigs.ArchConfig(
    name="mamba2-narrow", arch_type="ssm", num_layers=2, d_model=64,
    num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=256, layer_pattern="ssm",
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_conv_width=4,
    ssm_chunk=8, tie_embeddings=True, norm_eps=1e-5,
)
# granite's branch: MoE layers with its routing (32 experts, top-8,
# capacity factor 1.25, SiLU experts), GQA, tied embeddings.
GRANITE_NARROW = jconfigs.ArchConfig(
    name="granite-narrow", arch_type="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=32, vocab_size=256,
    num_experts=32, experts_per_token=8, tie_embeddings=True,
    max_seq_len=64,
)
# mixtral's: 8 experts, top-2, every layer a sliding window shorter than
# SEQ, rope θ 1e6, an untied head.
MIXTRAL_NARROW = jconfigs.ArchConfig(
    name="mixtral-narrow", arch_type="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=48, vocab_size=256,
    num_experts=8, experts_per_token=2, layer_pattern="swa",
    sliding_window=6, rope_theta=1_000_000.0, max_seq_len=64,
)
# recurrentgemma's: the (rglru, rglru, local attention) period twice and
# the two-layer rglru tail (8 layers), d_rnn rounded up from 64 to 128,
# 4 query heads over one KV head of 16 under a window shorter than SEQ,
# a scaled embedding, GeGLU, tied embeddings.
RG_NARROW = dataclasses.replace(
    jconfigs.get_config("recurrentgemma-9b"), name="rg-narrow",
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256, sliding_window=6, max_seq_len=64)
JAX_CONFIGS = {"tiny": jax_tiny(), "qwen2_narrow": QWEN2_NARROW,
               "gemma2_narrow": GEMMA2_NARROW, "qwen3_narrow": QWEN3_NARROW,
               "mamba2_narrow": MAMBA2_NARROW,
               "granite_narrow": GRANITE_NARROW,
               "mixtral_narrow": MIXTRAL_NARROW, "rg_narrow": RG_NARROW}


def _jax_cfg(name, backend="reference"):
    """The config with its mixers' backend: the flash kernel for attention,
    the SSD scan kernel for Mamba2 (``"pallas"``), or plain math."""
    return dataclasses.replace(JAX_CONFIGS[name], attn_backend=backend,
                               ssm_backend=backend)


def _port_cfg(jcfg) -> ArchConfig:
    return ArchConfig(**dataclasses.asdict(jcfg))


def _key(seed):
    return interop.key_from_numpy(np.asarray(jax.random.PRNGKey(seed)),
                                  device="cpu")


def _jax_leaves(tree):
    return [np.asarray(v) for v in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_are_the_jax_packages(arch):
    """Copied dataclasses: equal fields, layer kinds and smoke variants."""
    assert tconfigs.list_archs() == jconfigs.list_archs()
    jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.layer_kinds() == jc.layer_kinds()
    assert (tc.pattern_period(), tc.num_groups(), tc.tail_layers()) == (
        jc.pattern_period(), jc.num_groups(), jc.tail_layers())
    assert dataclasses.asdict(tconfigs.smoke_config(arch)) == \
        dataclasses.asdict(jconfigs.smoke_config(arch))
    tc.validate()


def test_validate_refuses_what_the_jax_package_refuses():
    bad = dict(name="bad", arch_type="dense", num_layers=2, d_model=32,
               num_heads=4, num_kv_heads=3, d_ff=64, vocab_size=64)
    with pytest.raises(AssertionError):
        jconfigs.ArchConfig(**bad).validate()
    with pytest.raises(AssertionError):
        ArchConfig(**bad).validate()


@pytest.mark.parametrize("arch,item", [
    ("whisper-small", "A19"), ("llama-3.2-vision-11b", "A19")])
def test_other_layer_kinds_wait_for_their_slice(arch, item):
    cfg = tconfigs.smoke_config(arch)
    with pytest.raises(NotImplementedError, match=item):
        make_lm_problem(cfg, batch=1, seq=4)


@pytest.mark.parametrize("ssm_backend", ["reference", "pallas"])
def test_mamba2_smoke_config_builds_a_problem(ssm_backend):
    """mamba2's SSD blocks are ported: its smoke config initializes, draws
    a batch and takes a finite gradient on both backends."""
    cfg = dataclasses.replace(tconfigs.smoke_config("mamba2-370m"),
                              ssm_backend=ssm_backend)
    prob = make_lm_problem(cfg, batch=1, seq=2 * cfg.ssm_chunk)
    keys = torch.stack([_key(1), _key(2)])
    z = prob.init(keys)
    grads = prob.oracle(z, prob.sample(keys))
    assert [tuple(g.shape) for g in grads] == [tuple(v.shape) for v in z]
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x22b"])
def test_moe_smoke_configs_build_a_problem(arch):
    """The MoE layer is ported: each MoE smoke config (4 experts, top-2)
    initializes, draws a batch and takes a finite gradient whose router
    leaf is nonzero (the aux loss and the gates reach it)."""
    cfg = dataclasses.replace(tconfigs.smoke_config(arch),
                              attn_backend="pallas")
    prob = make_lm_problem(cfg, batch=1, seq=16)
    keys = torch.stack([_key(1), _key(2)])
    z = prob.init(keys)
    grads = prob.oracle(z, prob.sample(keys))
    assert [tuple(g.shape) for g in grads] == [tuple(v.shape) for v in z]
    assert all(torch.isfinite(g).all() for g in grads)
    names = [".".join(n) for n in _leaf_paths(param_tree(z, cfg))]
    router = grads[names.index("stages.0.mlp.router")]
    assert router.abs().sum() > 0


def test_rg_smoke_config_builds_a_problem():
    """The RG-LRU layer is ported: recurrentgemma's smoke config (one
    rglru, rglru, local-attention period, head dim 64, window 8) with the
    flash route initializes, draws a batch and takes a finite gradient
    whose RG-LRU leaves are nonzero, at a sequence the window binds."""
    cfg = dataclasses.replace(tconfigs.smoke_config("recurrentgemma-9b"),
                              attn_backend="pallas")
    assert cfg.sliding_window < 16
    prob = make_lm_problem(cfg, batch=1, seq=16)
    keys = torch.stack([_key(1), _key(2)])
    z = prob.init(keys)
    grads = prob.oracle(z, prob.sample(keys))
    assert [tuple(g.shape) for g in grads] == [tuple(v.shape) for v in z]
    assert all(torch.isfinite(g).all() for g in grads)
    names = [".".join(n) for n in _leaf_paths(param_tree(z, cfg))]
    for leaf in ("lam", "w_a", "w_x", "conv.w", "in_proj"):
        assert grads[names.index(f"stages.0.mixer.{leaf}")].abs().sum() > 0


def _leaf_paths(tree, prefix=()):
    """Leaf paths in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _leaf_paths(tree[k],
                                                              prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [q for i, v in enumerate(tree)
                for q in _leaf_paths(v, prefix + (str(i),))]
    return [prefix]


def test_other_dtypes_are_refused():
    cfg = _port_cfg(dataclasses.replace(jax_tiny(), compute_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="float32"):
        make_lm_problem(cfg, batch=1, seq=4)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("vocab", [64, 256, 4099])
def test_sample_tokens_equal_token_for_token(seed, vocab):
    want = np.asarray(jax.jit(
        lambda k: jax_sample_tokens(k, 3, 20, vocab))(
            jax.random.PRNGKey(seed)))
    got = sample_tokens(_key(seed), 3, 20, vocab)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(JAX_CONFIGS))
def test_make_batch_per_worker_equals_vmapped_jax(name):
    """Keys (M, 2) draw one batch per worker, as ``jax.vmap`` over keys."""
    jcfg = _jax_cfg(name)
    keys = jax.random.split(jax.random.PRNGKey(4), 3)
    want = jax.vmap(lambda k: jax_make_batch(k, jcfg, BATCH, SEQ))(keys)
    got = make_batch(interop.key_from_numpy(np.asarray(keys), device="cpu"),
                     _port_cfg(jcfg), BATCH, SEQ)
    for f in ("tokens", "labels"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))


def test_hetero_sampler_equals_jax():
    jcfg = _jax_cfg("qwen2_narrow")
    jprob = jax_make_lm_problem(jcfg, batch=BATCH, seq=SEQ, hetero_workers=3)
    prob = make_lm_problem(_port_cfg(jcfg), batch=BATCH, seq=SEQ,
                           hetero_workers=3)
    keys = jax.random.split(jax.random.PRNGKey(8), 3)
    want = jax.vmap(jprob.sample_worker)(keys, jnp.arange(3))
    got = prob.sample_worker(
        interop.key_from_numpy(np.asarray(keys), device="cpu"),
        torch.arange(3, dtype=torch.int32))
    for f in ("tokens", "labels"):
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want[f]))


# ---------------------------------------------------------------------------
# The transformer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(JAX_CONFIGS))
def test_init_model_matches_jax_leaf_for_leaf(name):
    """Same keys, same leaf order and shapes; values within the erfinv ulps
    of ``normal`` (rtol 1e-5, atol 1e-7)."""
    jcfg = _jax_cfg(name)
    want = _jax_leaves(jax_init_model(jax.random.PRNGKey(3), jcfg)[0])
    got = param_leaves(init_model(_key(3), _port_cfg(jcfg)))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("backend", ["reference", "pallas"])
@pytest.mark.parametrize("name", list(JAX_CONFIGS))
def test_loss_and_gradients_match_jax(name, backend):
    """From the same weights and batch: the loss at rtol 1e-5, every
    gradient leaf at rtol 1e-4 / atol 1e-5 (f32 sum order)."""
    jcfg = _jax_cfg(name, backend)
    cfg = _port_cfg(jcfg)
    jparams = jax_init_model(jax.random.PRNGKey(5), jcfg)[0]
    jbatch = jax_make_batch(jax.random.PRNGKey(6), jcfg, BATCH, SEQ)
    jloss, jgrads = jax.value_and_grad(jax_loss_fn)(jparams, jcfg, jbatch)

    leaves = tuple(v.requires_grad_() for v in interop.params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu"))
    batch = make_batch(_key(6), cfg, BATCH, SEQ)
    loss = loss_fn(param_tree(leaves, cfg), cfg, batch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    for g, w in zip(grads, _jax_leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


def test_oracle_is_the_per_worker_gradient():
    """The problem's oracle on a stacked fleet equals each worker's own
    gradient, bit for bit."""
    cfg = _port_cfg(_jax_cfg("qwen2_narrow", "pallas"))
    prob = make_lm_problem(cfg, batch=BATCH, seq=SEQ)
    keys = torch.stack([_key(1), _key(2)])
    z = prob.init(keys)
    xi = prob.sample(keys)
    stacked = prob.oracle(z, xi)
    for i in range(2):
        leaves = tuple(v[i].clone().requires_grad_() for v in z)
        loss = loss_fn(param_tree(leaves, cfg), cfg,
                       {k: t[i] for k, t in xi.items()})
        for a, b in zip(stacked, torch.autograd.grad(loss, leaves)):
            assert torch.equal(a[i], b)


def test_params_round_trip_through_numpy():
    jcfg = _jax_cfg("qwen2_narrow")
    cfg = _port_cfg(jcfg)
    jparams = jax.tree.map(np.asarray,
                           jax_init_model(jax.random.PRNGKey(2), jcfg)[0])
    leaves = interop.params_from_numpy(jparams, cfg, device="cpu")
    back = interop.params_to_numpy(leaves, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        interop.params_from_numpy(jparams, _port_cfg(_jax_cfg("tiny")),
                                  device="cpu")


def test_mamba2_params_round_trip_through_numpy():
    """mamba2's 11 leaves, in ``jax.tree.leaves`` order, both ways."""
    jcfg = _jax_cfg("mamba2_narrow")
    cfg = _port_cfg(jcfg)
    jparams = jax.tree.map(np.asarray,
                           jax_init_model(jax.random.PRNGKey(2), jcfg)[0])
    leaves = interop.params_from_numpy(jparams, cfg, device="cpu")
    names = [".".join(k.key for k in path if hasattr(k, "key"))
             for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert names == [
        "embed.table", "final_norm.scale", "stages.mixer.a_log",
        "stages.mixer.conv.b", "stages.mixer.conv.w", "stages.mixer.d_skip",
        "stages.mixer.dt_bias", "stages.mixer.in_proj",
        "stages.mixer.norm.scale", "stages.mixer.out_proj",
        "stages.pre_norm.scale"]
    for a, b in zip(leaves, jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), b)
    back = interop.params_to_numpy(leaves, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)


def test_rglru_params_round_trip_through_numpy():
    """recurrentgemma's RG-LRU leaves (b_a, b_x, conv/{b,w}, in_proj, lam,
    out_proj, w_a, w_x), with the stacked group axis and in the tail list,
    in ``jax.tree.leaves`` order, both ways."""
    jcfg = _jax_cfg("rg_narrow")
    cfg = _port_cfg(jcfg)
    jparams = jax.tree.map(np.asarray,
                           jax_init_model(jax.random.PRNGKey(2), jcfg)[0])
    leaves = interop.params_from_numpy(jparams, cfg, device="cpu")
    paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    names = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in paths]
    mixer = ["b_a", "b_x", "conv.b", "conv.w", "in_proj", "lam",
             "out_proj", "w_a", "w_x"]
    for block in ("stages.0", "stages.1", "tail.0", "tail.1"):
        assert [n for n in names if n.startswith(f"{block}.mixer.")] == [
            f"{block}.mixer.{m}" for m in mixer]
    assert leaves[names.index("stages.0.mixer.w_a")].shape == (2, 128, 128)
    assert leaves[names.index("tail.1.mixer.in_proj")].shape == (64, 256)
    assert names == [".".join(p) for p in _leaf_paths(param_tree(leaves,
                                                                 cfg))]
    for a, b in zip(leaves, jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), b)
    back = interop.params_to_numpy(leaves, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)


def test_moe_params_round_trip_through_numpy():
    """granite's MoE leaves (router, w_gate, w_in, w_out, with the stacked
    group axis), in ``jax.tree.leaves`` order, both ways."""
    jcfg = _jax_cfg("granite_narrow")
    cfg = _port_cfg(jcfg)
    jparams = jax.tree.map(np.asarray,
                           jax_init_model(jax.random.PRNGKey(2), jcfg)[0])
    leaves = interop.params_from_numpy(jparams, cfg, device="cpu")
    paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    names = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path) for path, _ in paths]
    assert [n for n in names if ".mlp." in n] == [
        "stages.0.mlp.router", "stages.0.mlp.w_gate", "stages.0.mlp.w_in",
        "stages.0.mlp.w_out"]
    assert leaves[names.index("stages.0.mlp.w_in")].shape == (2, 32, 64, 32)
    assert names == [".".join(p) for p in _leaf_paths(param_tree(leaves,
                                                                 cfg))]
    for a, b in zip(leaves, jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.numpy(), b)
    back = interop.params_to_numpy(leaves, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# make_ps_engine end to end
# ---------------------------------------------------------------------------

def _plan_kw():
    return dict(worker_mode="paper", k_local=K, global_batch=M * BATCH,
                seq=SEQ, workers_override=M)


def _port_engine(backend, *, cfg=None, rounds=R):
    cfg = cfg or _port_cfg(_jax_cfg("qwen2_narrow", "pallas"))
    plan = TrainPlan(cfg=cfg, adaseg=AdaSEGConfig(**ADASEG), **_plan_kw())
    return make_ps_engine(plan, _key(0), rounds=rounds, backend=backend,
                          codec_backend=backend, device="cpu")


def _jax_engine(backend, rounds=R, name="qwen2_narrow"):
    plan = JaxPlan(cfg=_jax_cfg(name, "pallas"),
                   adaseg=JaxAdaSEG(**ADASEG), **_plan_kw())
    return jax_make_ps_engine(plan, jax.random.PRNGKey(0), rounds=rounds,
                              codec_backend=backend)


def _jax_runs(name):
    """The JAX engine's per-round eval losses and z̄ for each sync backend
    (its worker takes the reference step; the Pallas kernels run in
    interpret mode)."""
    out = {}
    for backend in ("reference", "fused"):
        eng = _jax_engine(backend, name=name)
        z = eng.run()
        out[backend] = ([r.residual for r in eng.trace.rounds],
                        _jax_leaves(z))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    return _jax_runs("qwen2_narrow")


@pytest.fixture(scope="module")
def jax_mamba2_runs():
    return _jax_runs("mamba2_narrow")


@pytest.fixture(scope="module")
def jax_moe_runs():
    return _jax_runs("granite_narrow")


@pytest.fixture(scope="module")
def jax_rg_run():
    """The JAX engine's fused run on the recurrentgemma-shaped config, one
    compilation of its round: the eval losses, z̄, and the engine itself,
    which the checkpoint test rewinds (the compiled round is kept per
    engine and chunk length, and a second engine would compile it again).
    It runs round by round, as the rewound engine will."""
    eng = _jax_engine("fused", name="rg_narrow")
    eng.run(until_round=1)
    z = eng.run()
    return [r.residual for r in eng.trace.rounds], _jax_leaves(z), eng


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_make_ps_engine_matches_jax(jax_runs, backend):
    """M=2, K=2, R=2 on the qwen2-shaped config with the flash route: the
    eval-loss trace at rtol 1e-5, z̄ at rtol 1e-4 / atol 1e-5."""
    want_trace, want_z = jax_runs[backend]
    eng = _port_engine(backend)
    z = eng.run()
    trace = [r.residual for r in eng.trace.rounds]
    assert len(trace) == R and all(np.isfinite(trace))
    np.testing.assert_allclose(trace, want_trace, rtol=TRACE_RTOL)
    assert len(z) == len(want_z)
    for g, w in zip(z, want_z):
        np.testing.assert_allclose(g.numpy(), w, **ZBAR_TOL)
    assert eng.trace.meta["problem"] == f"lm[qwen2-narrow]x{BATCH}x{SEQ}"


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_make_ps_engine_matches_jax_on_mamba2(jax_mamba2_runs, backend):
    """M=2, K=2, R=2 on the mamba2-shaped config with the SSD scan route:
    the eval-loss trace at rtol 1e-5, z̄ at rtol 1e-4 / atol 1e-5."""
    want_trace, want_z = jax_mamba2_runs[backend]
    eng = _port_engine(backend,
                       cfg=_port_cfg(_jax_cfg("mamba2_narrow", "pallas")))
    z = eng.run()
    trace = [r.residual for r in eng.trace.rounds]
    assert len(trace) == R and all(np.isfinite(trace))
    np.testing.assert_allclose(trace, want_trace, rtol=TRACE_RTOL)
    assert len(z) == len(want_z) == 11
    for g, w in zip(z, want_z):
        np.testing.assert_allclose(g.numpy(), w, **ZBAR_TOL)
    assert eng.trace.meta["problem"] == f"lm[mamba2-narrow]x{BATCH}x{SEQ}"


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_make_ps_engine_matches_jax_on_moe(jax_moe_runs, backend):
    """M=2, K=2, R=2 on the granite-shaped config (MoE layers, the flash
    route): the eval-loss trace at rtol 1e-5, z̄ at rtol 1e-4 / atol
    1e-5."""
    want_trace, want_z = jax_moe_runs[backend]
    eng = _port_engine(backend,
                       cfg=_port_cfg(_jax_cfg("granite_narrow", "pallas")))
    z = eng.run()
    trace = [r.residual for r in eng.trace.rounds]
    assert len(trace) == R and all(np.isfinite(trace))
    np.testing.assert_allclose(trace, want_trace, rtol=TRACE_RTOL)
    assert len(z) == len(want_z) == 12
    for g, w in zip(z, want_z):
        np.testing.assert_allclose(g.numpy(), w, **ZBAR_TOL)
    assert eng.trace.meta["problem"] == f"lm[granite-narrow]x{BATCH}x{SEQ}"


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_make_ps_engine_matches_jax_on_rg(jax_rg_run, backend):
    """M=2, K=2, R=2 on the recurrentgemma-shaped config (RG-LRU blocks,
    local attention through the flash route), each backend against the
    JAX engine's fused run: the eval-loss trace at rtol 1e-5, z̄ at rtol
    1e-4 / atol 1e-5."""
    want_trace, want_z, _ = jax_rg_run
    eng = _port_engine(backend,
                       cfg=_port_cfg(_jax_cfg("rg_narrow", "pallas")))
    z = eng.run()
    trace = [r.residual for r in eng.trace.rounds]
    assert len(trace) == R and all(np.isfinite(trace))
    np.testing.assert_allclose(trace, want_trace, rtol=TRACE_RTOL)
    assert len(z) == len(want_z)
    for g, w in zip(z, want_z):
        np.testing.assert_allclose(g.numpy(), w, **ZBAR_TOL)
    assert eng.trace.meta["problem"] == f"lm[rg-narrow]x{BATCH}x{SEQ}"


def test_make_ps_engine_refuses_later_slices():
    cfg = _port_cfg(_jax_cfg("tiny"))
    plan = TrainPlan(cfg=cfg, adaseg=AdaSEGConfig(**ADASEG), **_plan_kw())
    key = _key(0)
    with pytest.raises(NotImplementedError, match="A20"):
        make_ps_engine(plan, key, rounds=1, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):        # the default is the card
            make_ps_engine(plan, key, rounds=1)


def _host(eng):
    """Every host-side field of every record of an engine's trace."""
    return [(r.round, r.local_steps, r.alive, r.bytes_up, r.bytes_down,
             r.sim_time_s, r.staleness, r.idle_frac) for r in eng.trace.rounds]


ASYNC_LATENCY = dict(step_s=(1.0, 3.0), up_s=0.5)


@pytest.fixture(scope="module")
def jax_async_run():
    """The JAX package's async engine on tiny-lm, as
    ``tests/test_model_worker.py`` runs it: a 3× straggler, τ=1."""
    from repro import ps as jps

    je = jax_make_ps_engine(
        JaxPlan(cfg=_jax_cfg("tiny"), adaseg=JaxAdaSEG(**ADASEG),
                **_plan_kw()),
        jax.random.PRNGKey(0), rounds=R,
        latency=jps.ConstantLatency(**ASYNC_LATENCY), staleness_bound=1.0)
    z = _jax_leaves(je.run())
    return je, z


@pytest.mark.parametrize("backend", ["reference", "fused"])
def test_make_ps_engine_async_matches_jax(jax_async_run, backend):
    """``make_ps_engine(latency=, staleness_bound=)`` on tiny-lm builds the
    port's async engine, which matches the JAX package's: host records
    exactly, the eval-loss trace at rtol 1e-5, z̄ at rtol 1e-4 / atol
    1e-5."""
    from repro_torch import ps as tps

    je, z_j = jax_async_run
    te = make_ps_engine(
        TrainPlan(cfg=_port_cfg(_jax_cfg("tiny")),
                  adaseg=AdaSEGConfig(**ADASEG), **_plan_kw()),
        _key(0), rounds=R, latency=tps.ConstantLatency(**ASYNC_LATENCY),
        staleness_bound=1.0, backend=backend, codec_backend=backend,
        device="cpu")
    assert isinstance(te, tps.AsyncPSEngine)
    assert te.trace.meta["staleness_bound"] == 1.0
    z_t = te.run()
    assert _host(te) == _host(je) and te.n_admissions > R
    np.testing.assert_allclose([r.residual for r in te.trace.rounds],
                               [r.residual for r in je.trace.rounds],
                               rtol=TRACE_RTOL)
    assert len(z_t) == len(z_j)
    for g, w in zip(z_t, z_j):
        np.testing.assert_allclose(g.numpy(), w, **ZBAR_TOL)


@pytest.mark.parametrize("arch", ["tiny-lm", "qwen2-0.5b", "mamba2-370m",
                                  "granite-moe-1b-a400m",
                                  "recurrentgemma-9b"])
def test_model_worker_fingerprint_equals_jax(arch):
    jw = JaxModelWorker(JaxAdaSEG(**ADASEG), arch=arch)
    tw = ModelWorker(AdaSEGConfig(**ADASEG), arch=arch)
    assert tw.name == jw.name
    assert tw.fingerprint == jw.fingerprint


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_restore_into_another_architecture_is_refused(tmp_path):
    path = str(tmp_path / "lm.ckpt")
    eng = _port_engine("fused", rounds=1)
    eng.run()
    eng.save(path)
    other = _port_cfg(dataclasses.replace(_jax_cfg("qwen2_narrow", "pallas"),
                                          name="qwen2-other"))
    with pytest.raises(ValueError, match="different optimizer"):
        _port_engine("fused", cfg=other).restore(path)
    with pytest.raises(ValueError):            # another parameter layout
        _port_engine("fused", cfg=_port_cfg(_jax_cfg("tiny"))).restore(path)


def test_lm_checkpoint_crosses_to_the_jax_engine(jax_runs, tmp_path):
    """A port checkpoint after round 1 restores into the JAX engine, which
    runs round 2 to the JAX package's uninterrupted result: eval loss at
    rtol 1e-5, z̄ at rtol 1e-4 / atol 1e-5."""
    path = str(tmp_path / "lm.ckpt")
    eng = _port_engine("reference")
    eng.run(until_round=1)
    eng.save(path)
    jeng = _jax_engine("reference").restore(path)
    assert jeng.round == 1
    state = _jax_leaves(jeng.state)
    mine = [*eng.state.z_tilde, eng.state.sum_sq, eng.state.t,
            *eng.state.z_bar, eng.state.grad_sq_sum, eng.state.worker_id]
    assert len(state) == len(mine)
    for a, b in zip(state, mine):
        np.testing.assert_array_equal(a, b.numpy())
    z = jeng.run()
    want_trace, want_z = jax_runs["reference"]
    np.testing.assert_allclose(jeng.trace.rounds[-1].residual, want_trace[-1],
                               rtol=TRACE_RTOL)
    for g, w in zip(_jax_leaves(z), want_z):
        np.testing.assert_allclose(g, w, **ZBAR_TOL)


def _fleet_state(state):
    return [*state.z_tilde, state.sum_sq, state.t, *state.z_bar,
            state.grad_sq_sum, state.worker_id]


def test_moe_checkpoint_crosses_to_the_jax_engine(jax_moe_runs, tmp_path):
    """A port checkpoint of the granite-shaped engine after round 1
    restores into the JAX engine, which runs round 2 to the JAX package's
    uninterrupted result: eval loss at rtol 1e-5, z̄ at rtol 1e-4 / atol
    1e-5."""
    path = str(tmp_path / "moe.ckpt")
    cfg = _port_cfg(_jax_cfg("granite_narrow", "pallas"))
    eng = _port_engine("reference", cfg=cfg)
    eng.run(until_round=1)
    eng.save(path)
    jeng = _jax_engine("reference", name="granite_narrow").restore(path)
    assert jeng.round == 1
    state = _jax_leaves(jeng.state)
    mine = _fleet_state(eng.state)
    assert len(state) == len(mine)
    for a, b in zip(state, mine):
        np.testing.assert_array_equal(a, b.numpy())
    z = jeng.run()
    want_trace, want_z = jax_moe_runs["reference"]
    np.testing.assert_allclose(jeng.trace.rounds[-1].residual, want_trace[-1],
                               rtol=TRACE_RTOL)
    for g, w in zip(_jax_leaves(z), want_z):
        np.testing.assert_allclose(g, w, **ZBAR_TOL)


def test_rg_checkpoint_crosses_to_the_jax_engine(jax_rg_run, tmp_path):
    """A port checkpoint of the recurrentgemma-shaped engine after round 1
    restores into the JAX engine, rewound from the end of its run (state
    bit for bit), which runs round 2 to its uninterrupted result: eval
    loss at rtol 1e-5, z̄ at rtol 1e-4 / atol 1e-5."""
    path = str(tmp_path / "rg.ckpt")
    eng = _port_engine("fused", cfg=_port_cfg(_jax_cfg("rg_narrow",
                                                       "pallas")))
    eng.run(until_round=1)
    eng.save(path)
    want_trace, want_z, jeng = jax_rg_run
    assert jeng.round == R
    jeng.restore(path)
    assert jeng.round == 1 and len(jeng.trace.rounds) == 1
    state = _jax_leaves(jeng.state)
    mine = _fleet_state(eng.state)
    assert len(state) == len(mine)
    for a, b in zip(state, mine):
        np.testing.assert_array_equal(a, b.numpy())
    z = jeng.run()
    assert jeng.round == R
    np.testing.assert_allclose(jeng.trace.rounds[-1].residual, want_trace[-1],
                               rtol=TRACE_RTOL)
    for g, w in zip(_jax_leaves(z), want_z):
        np.testing.assert_allclose(g, w, **ZBAR_TOL)


def test_jax_moe_checkpoint_restores_into_the_port(jax_moe_runs, tmp_path):
    """The other way: the JAX engine on the granite-shaped config saved
    after round 1 restores into the port's engine (state bit for bit),
    which runs round 2 to the JAX package's uninterrupted result."""
    path = str(tmp_path / "moe.ckpt")
    jeng = _jax_engine("fused", name="granite_narrow")
    jeng.run(until_round=1)
    jeng.save(path)
    eng = _port_engine("fused",
                       cfg=_port_cfg(_jax_cfg("granite_narrow", "pallas")))
    eng.restore(path)
    assert eng.round == 1 and eng.trace.rounds == []
    for a, b in zip(_fleet_state(eng.state), _jax_leaves(jeng.state)):
        np.testing.assert_array_equal(a.numpy(), b)
    z = eng.run()
    want_trace, want_z = jax_moe_runs["fused"]
    np.testing.assert_allclose([r.residual for r in eng.trace.rounds],
                               want_trace[1:], rtol=TRACE_RTOL)
    for g, w in zip(z, want_z):
        np.testing.assert_allclose(g.numpy(), w, **ZBAR_TOL)


def test_engine_holds_one_fleet_state_in_flight():
    """Memory: by the end of round 0 the engine no longer holds the fleet
    state it started from (its anchors were replaced by the sync, its zero
    output iterates by the first step), so a model's fleet lives once, not
    two or three times over a chunk."""
    import gc
    import weakref

    seen = []

    def eval_fn(params):
        gc.collect()
        seen.append([r() is None for r in refs])
        return torch.zeros(())

    cfg = _port_cfg(_jax_cfg("tiny", "pallas"))
    plan = TrainPlan(cfg=cfg, adaseg=AdaSEGConfig(**ADASEG), **_plan_kw())
    eng = make_ps_engine(plan, _key(0), rounds=2, eval_fn=eval_fn,
                         device="cpu")
    refs = [weakref.ref(v) for v in (*eng.state.z_tilde, *eng.state.z_bar)]
    eng.run()
    assert seen == [[True] * len(refs)] * 2
