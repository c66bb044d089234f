"""Primitive layers: RMSNorm, embeddings, RoPE and the causal depthwise
conv (port of ``repro.models.layers``; LayerNorm and the plain linear layer
come with whisper, the conv's decode step with serving, ROADMAP A19).

``init_*`` take keys of shape ``(..., 2)`` and return parameter dicts whose
leaves carry the keys' leading axes: ``(M, 2)`` keys give one parameter set
per worker, stacked, drawn from the same streams as ``jax.vmap`` over the
JAX package's ``init_*``. The sharding specs of the JAX package come with
the sharded path (ROADMAP A20). ``apply_*`` act on one model's parameters.
"""
from __future__ import annotations

import torch

from .. import random as jr


def _normal(key, shape, scale):
    return scale * jr.normal(key, shape)


def split(key, num: int):
    """``num`` keys from each key: a list of ``(..., 2)`` tensors."""
    keys = jr.split(key, num)
    return [keys[..., i, :] for i in range(num)]


# --- norms ---------------------------------------------------------------------

def init_rmsnorm(key_like, dim):
    """Unit scale; ``key_like`` gives the leading axes and the device."""
    return {"scale": torch.ones(key_like.shape[:-1] + (dim,),
                                device=key_like.device)}


def apply_rmsnorm(p, x, eps=1e-6):
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * p["scale"].to(x.dtype)


# --- embedding -------------------------------------------------------------------

def init_embedding(key, vocab, dim):
    return {"table": _normal(key, (vocab, dim), 0.02)}


def apply_embedding(p, tokens):
    return p["table"][tokens.long()]


# --- RoPE ----------------------------------------------------------------------

def rope_frequencies(head_dim, theta, device="cpu"):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta=10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)          # (hd/2,)
    angles = positions[..., :, None].float() * freqs             # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                     # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap):
    return cap * torch.tanh(x / cap)


# --- causal depthwise conv (mamba2, RG-LRU) ----------------------------------

def init_conv1d(key, channels, width):
    return {"w": _normal(key, (width, channels), channels ** -0.5),
            "b": torch.zeros(key.shape[:-1] + (channels,), device=key.device)}


def apply_conv1d(p, x):
    """Causal depthwise conv. x: (B, S, C) → (B, S, C). The reference's sum
    of shifted products, in its order (no ``conv1d``: cuDNN would sum in
    another order, in TF32 by default)."""
    width, s = p["w"].shape[0], x.shape[1]
    pad = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:s, :] * p["w"][0]
    for i in range(1, width):
        out = out + pad[:, i:i + s, :] * p["w"][i]
    return out + p["b"]
