"""Assigned-architecture registry: ``get_config(name)`` / ``--arch`` lookup.

One module per architecture under ``repro/configs/`` reproduces the published
configuration exactly (source cited in each module docstring);
``smoke_config`` derives the reduced CPU-testable variant (≤2 layers,
d_model ≤ 512, ≤4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig
from . import (
    codeqwen1_5_7b,
    gemma2_27b,
    granite_moe_1b_a400m,
    llama_3_2_vision_11b,
    mamba2_370m,
    mixtral_8x22b,
    qwen2_0_5b,
    qwen3_8b,
    recurrentgemma_9b,
    whisper_small,
)

_MODULES = (
    granite_moe_1b_a400m,
    qwen3_8b,
    mamba2_370m,
    codeqwen1_5_7b,
    gemma2_27b,
    whisper_small,
    qwen2_0_5b,
    mixtral_8x22b,
    llama_3_2_vision_11b,
    recurrentgemma_9b,
)

_REGISTRY: dict[str, ArchConfig] = {}
for _m in _MODULES:
    _m.CONFIG.validate()
    _REGISTRY[_m.CONFIG.name] = _m.CONFIG


def list_archs() -> list[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return _REGISTRY[name]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family variant: ≤2 layers (3 for the rg pattern so a
    full recurrent-recurrent-attention period is exercised), d_model ≤ 512,
    ≤4 experts — runs a forward/train step on CPU in seconds."""
    cfg = get_config(name)
    kv = max(1, 4 * cfg.num_kv_heads // cfg.num_heads)
    layers = 3 if cfg.layer_pattern == "rg" else 2
    return dataclasses.replace(
        cfg,
        num_layers=layers,
        d_model=256,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=64,
        d_ff=0 if cfg.d_ff == 0 else 512,
        vocab_size=512,
        num_experts=min(4, cfg.num_experts),
        experts_per_token=min(2, cfg.experts_per_token),
        # no token dropping in the reduced variant → decode ≡ forward exactly
        capacity_factor=8.0 if cfg.num_experts else cfg.capacity_factor,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_seq else 0,
        frontend_dim=256 if cfg.frontend_dim else 0,
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        sliding_window=8 if cfg.sliding_window else None,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16,
        ssm_chunk=8,
        max_seq_len=128,
    )
