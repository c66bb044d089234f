"""Grouped-query attention with RoPE, qk-norm, logit soft-capping and
sliding windows (port of ``repro.models.attention``, training path).

The reference path is plain tensor math; with ``cfg.attn_backend ==
"pallas"`` (the JAX package's name, kept so configs cross unchanged)
self-causal attention runs the flash kernel of
``repro_torch.kernels.flash_attention`` forward and differentiates the
plain version backward, as the JAX package's ``custom_vjp`` does. The KV
cache and ``decode_attention`` come with serving (ROADMAP A19).
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attention.kernel import flash_attention
from ..kernels.flash_attention.ref import attention_ref
from .layers import _normal, apply_rmsnorm, apply_rope, init_rmsnorm, softcap
from .layers import split as split_keys

NEG_INF = -1e30


def init_attention(key, cfg: ArchConfig):
    dm, h, kh, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    keys = split_keys(key, 6)
    scale = dm ** -0.5
    p = {
        "wq": _normal(keys[0], (dm, h, dh), scale),
        "wk": _normal(keys[1], (dm, kh, dh), scale),
        "wv": _normal(keys[2], (dm, kh, dh), scale),
        "wo": _normal(keys[3], (h, dh, dm), (h * dh) ** -0.5),
    }
    lead = key.shape[:-1]
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (h, dh), device=key.device)
        p["bk"] = torch.zeros(lead + (kh, dh), device=key.device)
        p["bv"] = torch.zeros(lead + (kh, dh), device=key.device)
    if cfg.qk_norm:
        for n in ("q_norm", "k_norm"):
            p[n] = init_rmsnorm(key, dh)
    return p


def _project_qkv(p, cfg: ArchConfig, x):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = apply_rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = apply_rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def gqa_scores(q, k, v, mask, *, scale, cap=None):
    """q: (B,S,H,Dh), k/v: (B,T,Kh,Dh), mask: broadcastable to (B,Kh,G,S,T)."""
    b, s, h, dh = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, s, kh, g, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    if cap is not None:
        logits = softcap(logits, cap)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


def causal_mask(s, t, *, window=None, device="cpu"):
    """(s, t) boolean mask of the keys each query sees."""
    qi = torch.arange(s, device=device)[:, None]
    ki = torch.arange(t, device=device)[None, :]
    m = ki <= qi
    if window is not None:
        m &= ki > qi - window
    return m


# Sequences at or above this length use the chunked (flash-style) path on
# the reference backend: the O(S²) logit tensor is never materialized.
CHUNKED_ATTN_THRESHOLD = 8192


def _chunked_attention(q, k, v, *, scale, cap, causal, window, block=1024):
    """Softmax attention one query block at a time. q: (B,S,H,D); k/v:
    (B,T,Kh,D). Logits live only per (block × T)."""
    b, s, h, dh = q.shape
    kh, t = k.shape[2], k.shape[1]
    g = h // kh
    assert s % block == 0, (s, block)
    qb = q.reshape(b, s // block, block, kh, g, dh).permute(1, 0, 3, 4, 2, 5)
    ki = torch.arange(t, device=q.device)
    outs = []
    for idx in range(s // block):
        logits = torch.einsum("bkgsd,btkd->bkgst", qb[idx].float(),
                              k.float()) * scale
        if cap is not None:
            logits = cap * torch.tanh(logits / cap)
        qi = idx * block + torch.arange(block, device=q.device)
        mask = torch.ones((block, t), dtype=torch.bool, device=q.device)
        if causal:
            mask &= ki[None, :] <= qi[:, None]
        if window is not None:
            mask &= ki[None, :] > qi[:, None] - window
        logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        outs.append(torch.einsum("bkgst,btkd->bkgsd", probs, v))
    # (nq, B, Kh, G, block, D) → (B, S, H, D)
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(b, s, h, dh)


def _ref_self_attention(q, k, v, scale, cap, window):
    out = attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=True, window=window, softcap=cap, scale=scale,
    )
    return out.transpose(1, 2)


class _FlashSelfAttention(torch.autograd.Function):
    """Forward: the flash kernel (its plain version for CPU tensors).
    Backward: the gradient of the plain version at the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, scale, cap, window):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (scale, cap, window)
        out = flash_attention(
            *(t.transpose(1, 2).contiguous() for t in (q, k, v)),
            causal=True, window=window, softcap=cap, scale=scale,
        )
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            args = tuple(t.detach().requires_grad_() for t in (q, k, v))
            out = _ref_self_attention(*args, *ctx.opts)
            grads = torch.autograd.grad(out, args, g)
        return (*grads, None, None, None)


def _flash_self_attention(q, k, v, *, scale, cap, window):
    """Self-causal attention on the model's (B, S, H, D) layout through the
    flash kernel (``cfg.attn_backend="pallas"``): forward kernel, backward
    the plain version's gradient."""
    return _FlashSelfAttention.apply(q, k, v, scale, cap, window)


def apply_attention(p, cfg: ArchConfig, x, positions, *, window=None):
    """Full-sequence self-causal attention (train / prefill). x: (B, S, D)."""
    q, k, v = _project_qkv(p, cfg, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    s_len = q.shape[1]
    scale = cfg.attn_scale or cfg.head_dim_ ** -0.5
    if cfg.attn_backend == "pallas":
        out = _flash_self_attention(
            q, k, v, scale=scale, cap=cfg.attn_softcap, window=window,
        )
    elif s_len >= CHUNKED_ATTN_THRESHOLD:
        out = _chunked_attention(
            q, k, v, scale=scale, cap=cfg.attn_softcap,
            causal=True, window=window,
        )
    else:
        mask = causal_mask(s_len, s_len, window=window, device=x.device)
        out = gqa_scores(q, k, v, mask, scale=scale, cap=cfg.attn_softcap)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])
