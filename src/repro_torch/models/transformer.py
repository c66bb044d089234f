"""Model assembly for decoder-only stacks of attention, Mamba2 and RG-LRU
blocks (port of ``repro.models.transformer``, training path).

Pre-norm residual blocks: a mixer, attention (global or sliding-window),
Mamba2's SSD (``kind == "ssm"``) or Griffin's RG-LRU recurrent block
(``kind == "rglru"``, :mod:`repro_torch.models.rglru`; recurrentgemma's
period is rglru, rglru, local attention), then a gated MLP where the
config has one (``d_ff > 0``; mamba2 has none) or, in MoE configs, a
Mixture-of-Experts layer (:mod:`repro_torch.models.moe`), whose router
aux losses :func:`forward` sums in the JAX package's order. Layers are
``num_groups`` repetitions of a ``pattern_period``-long stage, and each
period position's parameters are stacked with a leading group axis
(``_init_stage``), the JAX package's layout, so parameters and
checkpoints cross between the packages leaf for leaf. A plain loop over
the group axis replaces the JAX package's rematerialized ``lax.scan``;
the values are the same, only the memory schedule differs.

Parameters live in two forms: a nested dict for one model (what
:func:`forward` and :func:`loss_fn` take) and, on the engine side, a tuple
of worker-stacked leaves in ``jax.tree.leaves`` order (dict keys sorted,
lists in order): :func:`param_leaves` and :func:`param_tree` convert.

Encoder-decoder and cross-attention stacks, the KV, SSM and RG-LRU
caches and decode come with serving (ROADMAP A19); their configs raise
``NotImplementedError``.

Examples
--------
>>> from repro_torch import random as jr
>>> from repro_torch.models.problem import tiny_lm_config
>>> cfg = tiny_lm_config()
>>> params = init_model(jr.PRNGKey(0, device="cpu"), cfg)
>>> sorted(params), tuple(params["stages"][0]["mixer"]["wq"].shape)
(['embed', 'final_norm', 'lm_head', 'stages'], (2, 32, 2, 16))
>>> tokens = torch.zeros((1, 8), dtype=torch.int32)
>>> logits, aux = forward(params, cfg, tokens)
>>> tuple(logits.shape), float(aux)
((1, 8, 64), 0.0)
"""
from __future__ import annotations

import functools

import torch

from .. import random as jr
from ..checkpoint.serialize import tree_flatten, tree_unflatten
from ..configs.base import ArchConfig
from .attention import apply_attention, init_attention
from .layers import (
    _normal,
    apply_embedding,
    apply_rmsnorm,
    init_embedding,
    init_rmsnorm,
    softcap,
    split,
)
from .mlp import apply_mlp, init_mlp
from .moe import apply_moe, init_moe
from .rglru import apply_rglru, init_rglru
from .ssm import apply_ssm, init_ssm


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for the layer kinds this slice lacks."""
    if (cfg.is_encoder_decoder or cfg.cross_attn_every
            or cfg.norm != "rmsnorm" or cfg.pos_embed != "rope"):
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder and cross-attention stacks, "
            "LayerNorm and learned positions are ported with serving "
            "(ROADMAP A19)")
    if cfg.param_dtype != "float32" or cfg.compute_dtype != "float32":
        raise NotImplementedError(f"{cfg.name}: the port computes in float32")


def init_norm(key_like, cfg: ArchConfig):
    return init_rmsnorm(key_like, cfg.d_model)


def apply_norm(cfg: ArchConfig, p, x):
    return apply_rmsnorm(p, x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

_INIT_MIXER = {"attn": init_attention, "ssm": init_ssm, "rglru": init_rglru}


def _init_block(key, cfg: ArchConfig, kind: dict):
    keys = split(key, 8)
    mixer = _INIT_MIXER[kind["kind"]]
    p = {"pre_norm": init_norm(key, cfg), "mixer": mixer(keys[0], cfg)}
    if kind["moe"]:
        p["mlp_norm"] = init_norm(key, cfg)
        p["mlp"] = init_moe(keys[2], cfg)
    elif cfg.d_ff > 0:
        p["mlp_norm"] = init_norm(key, cfg)
        p["mlp"] = init_mlp(keys[2], cfg)
    if cfg.post_norm:
        p["mixer_post"] = init_norm(key, cfg)
        p["mlp_post"] = init_norm(key, cfg)
    return p


def _init_stage(key, cfg: ArchConfig, kind: dict, n_groups: int):
    """One period position's block parameters, stacked over the group axis
    (the keys of ``split(key, n_groups)`` are a batch axis of the draws)."""
    return _init_block(jr.split(key, n_groups), cfg, kind)


def init_model(key, cfg: ArchConfig):
    """Parameters of the whole stack. ``key`` is ``(..., 2)``; leading key
    axes become leading parameter axes (one model per key)."""
    cfg.validate()
    check_supported(cfg)
    period = cfg.pattern_period()
    n_groups = cfg.num_groups()
    kinds = cfg.layer_kinds()
    keys = split(key, period + cfg.tail_layers() + 4)
    p = {"embed": init_embedding(keys[0], cfg.vocab_size, cfg.d_model)}
    p["stages"] = [_init_stage(keys[1 + j], cfg, kinds[j], n_groups)
                   for j in range(period)]
    tails = [_init_block(keys[1 + period + i], cfg,
                         kinds[n_groups * period + i])
             for i in range(cfg.tail_layers())]
    if tails:
        p["tail"] = tails
    p["final_norm"] = init_norm(key, cfg)
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(keys[-2], (cfg.d_model, cfg.vocab_size),
                               cfg.d_model ** -0.5)
    return p


@functools.lru_cache(maxsize=None)
def param_template(cfg: ArchConfig):
    """The parameter tree of one model as meta tensors (structure and
    shapes, no storage)."""
    return init_model(torch.zeros(2, dtype=torch.int64, device="meta"), cfg)


def param_leaves(params) -> tuple:
    """A parameter tree as its leaves in ``jax.tree.leaves`` order."""
    return tuple(tree_flatten(params))


def param_tree(leaves, cfg: ArchConfig):
    """The inverse of :func:`param_leaves` for ``cfg``'s parameters."""
    leaves = tuple(leaves)
    template = param_template(cfg)
    if len(leaves) != len(tree_flatten(template)):
        raise ValueError(f"{cfg.name}: {len(leaves)} leaves, expected "
                         f"{len(tree_flatten(template))}")
    return tree_unflatten(template, iter(leaves))


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def _block_forward(lp, cfg: ArchConfig, kind, x, positions, dropped):
    """One block: ``(x, aux)``, aux the MoE router loss or None."""
    h = apply_norm(cfg, lp["pre_norm"], x)
    if kind["kind"] == "attn":
        out = apply_attention(lp["mixer"], cfg, h, positions,
                              window=kind["window"])
    elif kind["kind"] == "ssm":
        out = apply_ssm(lp["mixer"], cfg, h)
    else:
        out = apply_rglru(lp["mixer"], cfg, h)
    if cfg.post_norm:
        out = apply_norm(cfg, lp["mixer_post"], out)
    x = x + out
    if "mlp" not in lp:
        return x, None
    h = apply_norm(cfg, lp["mlp_norm"], x)
    aux = None
    if kind["moe"]:
        out, aux = apply_moe(lp["mlp"], cfg, h,
                             shard_dispatch=cfg.moe_shard_dispatch,
                             dropped=dropped)
    else:
        out = apply_mlp(lp["mlp"], cfg, h)
    if cfg.post_norm:
        out = apply_norm(cfg, lp["mlp_post"], out)
    return x + out, aux


def _add(a, b):
    """a + b, where None is a zero (the blocks without an MoE layer)."""
    if a is None:
        return b
    return a if b is None else a + b


def _group(tree, g: int):
    if isinstance(tree, dict):
        return {k: _group(v, g) for k, v in tree.items()}
    return tree[g]


def forward(params, cfg: ArchConfig, tokens, *, moe_dropped=None):
    """tokens: (B, S) → (logits (B, S, V) f32, MoE aux).

    The aux losses are summed as the JAX package sums them: over a period's
    blocks, then over the groups (``jnp.sum`` of the scan's outputs), then
    the tail blocks; 0 without MoE layers. ``moe_dropped``, where given, is a list to which each MoE layer
    appends its count of routed choices dropped at capacity."""
    check_supported(cfg)
    x = apply_embedding(params["embed"], tokens).float()
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    positions = torch.arange(tokens.shape[1], device=tokens.device
                             ).expand(tokens.shape)

    kinds = cfg.layer_kinds()
    period = cfg.pattern_period()
    group_aux = []
    for g in range(cfg.num_groups()):
        aux_g = None
        for j in range(period):
            x, aux = _block_forward(_group(params["stages"][j], g), cfg,
                                    kinds[j], x, positions, moe_dropped)
            aux_g = _add(aux_g, aux)
        if aux_g is not None:
            group_aux.append(aux_g)
    aux_total = torch.sum(torch.stack(group_aux)) if group_aux else None
    for i, lp in enumerate(params.get("tail", [])):
        x, aux = _block_forward(lp, cfg, kinds[cfg.num_groups() * period + i],
                                x, positions, moe_dropped)
        aux_total = _add(aux_total, aux)

    x = apply_norm(cfg, params["final_norm"], x)
    head = (params["embed"]["table"].T if cfg.tie_embeddings
            else params["lm_head"])
    logits = (x @ head).float()
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    if aux_total is None:
        aux_total = torch.zeros((), device=logits.device)
    return logits, aux_total


def loss_fn(params, cfg: ArchConfig, batch):
    """Next-token cross-entropy (+ the MoE router aux loss). batch:
    {tokens, labels}; labels are the tokens shifted by one, −1 masked."""
    logits, aux = forward(params, cfg, batch["tokens"])
    labels = batch["labels"].long()
    mask = labels >= 0
    safe = torch.clamp(labels, min=0)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return loss + cfg.router_aux_weight * aux
