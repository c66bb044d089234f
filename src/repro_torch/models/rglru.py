"""RG-LRU recurrent block, RecurrentGemma / Griffin [arXiv:2402.19427]
(port of ``repro.models.rglru``, training path).

    r_t = σ(W_a x_t + b_a)            recurrence gate
    i_t = σ(W_x x_t + b_x)            input gate
    a_t = exp(−c·softplus(Λ)·r_t)     per-channel decay, c = 8
    h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

The block is Griffin's recurrent block: x → [gate branch, rnn branch]; the
rnn branch goes causal conv1d → RG-LRU; the two merge as GeLU(gate) ⊙ h →
out-projection. The JAX package computes it in plain ``jnp`` (no Pallas
kernel), so the port computes it in PyTorch. The linear recurrence runs as
:func:`linear_scan`, a copy of ``lax.associative_scan``'s recursion, so
the port sums in the reference's order at log depth; it uses slices,
``cat`` and ``stack`` only (no scatter, no atomics), so reruns on the card
are bit-identical. The decode cache and its one-token step come with
serving (ROADMAP A19).

Examples
--------
>>> from repro_torch import random as jr
>>> from repro_torch.configs import smoke_config
>>> cfg = smoke_config("recurrentgemma-9b")
>>> p = init_rglru(jr.PRNGKey(0, device="cpu"), cfg)
>>> {k: tuple(v.shape) for k, v in sorted(p.items()) if k != "conv"}
{'b_a': (256,), 'b_x': (256,), 'in_proj': (256, 512), 'lam': (256,), 'out_proj': (256, 256), 'w_a': (256, 256), 'w_x': (256, 256)}
>>> x = jr.normal(jr.PRNGKey(1, device="cpu"), (2, 8, cfg.d_model))
>>> tuple(apply_rglru(p, cfg, x).shape)
(2, 8, 256)
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .layers import _normal, apply_conv1d, init_conv1d, split
from .mlp import _act
from .ssm import _linspace, _softplus

_C = 8.0


def init_rglru(key, cfg: ArchConfig):
    """The block's parameters; ``key`` splits six ways as the JAX package's
    does (keys 0-3 the projections, 4 the conv, 5 unused); b_a and b_x are
    zeros, Λ is ``jnp.linspace(-2, 2, d_rnn)``."""
    dm, dr = cfg.d_model, cfg.d_rnn
    keys = split(key, 6)
    lead = key.shape[:-1]
    zeros = torch.zeros(lead + (dr,), device=key.device)
    return {
        "in_proj": _normal(keys[0], (dm, 2 * dr), dm ** -0.5),  # [gate, x]
        "out_proj": _normal(keys[1], (dr, dm), dr ** -0.5),
        "w_a": _normal(keys[2], (dr, dr), dr ** -0.5),
        "b_a": zeros,
        "w_x": _normal(keys[3], (dr, dr), dr ** -0.5),
        "b_x": zeros.clone(),
        "lam": _linspace(-2.0, 2.0, dr, key.device).expand(
            lead + (dr,)).clone(),
        "conv": init_conv1d(keys[4], dr, cfg.rglru_conv_width),
    }


def _gates(p, x):
    """x: (..., dr) → the decay a_t and the gated input u_t (f32), in the
    JAX package's order of operations."""
    r = torch.sigmoid((x @ p["w_a"]).float() + p["b_a"])
    i = torch.sigmoid((x @ p["w_x"]).float() + p["b_x"])
    log_a = -_C * _softplus(p["lam"]) * r                  # ≤ 0
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    u = beta * i * x.float()
    return a, u


def _combine(a1, u1, a2, u2):
    """The recurrence's associative operator: (a1, u1) then (a2, u2)."""
    return a1 * a2, a2 * u1 + u2


def _interleave(even, odd):
    """``even`` at positions 0, 2, … and ``odd`` at 1, 3, … of axis 1;
    ``even`` is as long as ``odd`` or one longer."""
    n = odd.shape[1]
    head = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return head if even.shape[1] == n else torch.cat([head, even[:, n:]], 1)


def linear_scan(a, u):
    """h_t = a_t·h_{t−1} + u_t along axis 1, h_{−1} = 0: the ``h`` of
    ``lax.associative_scan`` with :func:`_combine` over (a, u), by its own
    recursion, so every h_t is summed in its order. Adjacent pairs are
    combined, the half-length scan recurses on them (the odd positions),
    and the even positions combine each odd result with the next element.

    Returns ``(A, h)``: the running products of a, and h.

    >>> a = torch.tensor([[0.5, 0.25, 1.0, 0.5, 2.0]])
    >>> u = torch.tensor([[1.0, 2.0, -1.0, 0.5, 1.0]])
    >>> h, loop = linear_scan(a, u)[1], []
    >>> for t in range(5):
    ...     loop.append(a[0, t] * (loop[-1] if loop else 0.0) + u[0, t])
    >>> h.tolist(), [float(v) for v in loop]
    ([[1.0, 2.25, 1.25, 1.125, 3.25]], [1.0, 2.25, 1.25, 1.125, 3.25])
    """
    n = a.shape[1]
    if n < 2:
        return a, u
    # adjacent pairs, scanned at half length: the odd positions
    odd_a, odd_u = linear_scan(*_combine(a[:, 0:-1:2], u[:, 0:-1:2],
                                         a[:, 1::2], u[:, 1::2]))
    # the even positions past the first: the odd result before each, then
    # the element itself
    last = odd_a.shape[1] if n % 2 else odd_a.shape[1] - 1
    ea, eu = _combine(odd_a[:, :last], odd_u[:, :last], a[:, 2::2],
                      u[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eu = torch.cat([u[:, :1], eu], dim=1)
    return _interleave(ea, odd_a), _interleave(eu, odd_u)


def apply_rglru(p, cfg: ArchConfig, x):
    """Full-sequence Griffin recurrent block. x: (B, S, D) → (B, S, D)."""
    proj = x @ p["in_proj"]
    gate, xr = torch.chunk(proj, 2, dim=-1)
    xr = apply_conv1d(p["conv"], xr)
    a, u = _gates(p, xr)                                   # (B, S, dr) f32
    _, h = linear_scan(a, u)
    y = _act("gelu")(gate) * h.to(x.dtype)
    return y @ p["out_proj"]
