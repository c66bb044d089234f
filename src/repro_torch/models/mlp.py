"""Gated MLPs, SwiGLU and GeGLU (port of ``repro.models.mlp``)."""
from __future__ import annotations

import torch
import torch.nn.functional as tnf

from ..configs.base import ArchConfig
from .layers import _normal, split


def _act(name):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": tnf.silu,
            "gelu": lambda x: tnf.gelu(x, approximate="tanh"),
            "gelu_plain": lambda x: tnf.gelu(x, approximate="tanh")}[name]


def init_mlp(key, cfg: ArchConfig):
    dm, ff = cfg.d_model, cfg.d_ff
    k1, k2, k3 = split(key, 3)
    p = {
        "w_in": _normal(k1, (dm, ff), dm ** -0.5),
        "w_out": _normal(k3, (ff, dm), ff ** -0.5),
    }
    if cfg.activation in ("silu", "gelu"):
        p["w_gate"] = _normal(k2, (dm, ff), dm ** -0.5)
    return p


def apply_mlp(p, cfg: ArchConfig, x):
    act = _act(cfg.activation)
    h = x @ p["w_in"]
    if "w_gate" in p:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    return h @ p["w_out"]
