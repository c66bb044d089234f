"""Mixture-of-Experts layer with top-k routing and capacity-bounded dispatch
(port of ``repro.models.moe``).

Each token's router picks its ``k`` most probable experts; an expert takes
at most ``capacity`` (token, choice) pairs, claimed in token-major order
(token t's choices before token t+1's), and the choices past it are dropped:
their token keeps only its residual. The router's load-balance auxiliary
loss (Switch/Mixtral style) is returned to be added to the objective.

The JAX package's dispatch ``tokens[slot_tok]`` and combine
``out.at[slot_tok].add(...)`` become gathers in both directions
(:class:`_Dispatch`, :class:`_Combine`): each token's output and each
token's gradient is the sum of its kept (expert, slot) rows in ascending
expert order, the order in which the JAX scatter adds them. No step uses
atomics (``index_add_``, ``index_put_(accumulate=True)``, the backward of
``index_select`` or ``gather``), so reruns on the card are bit-identical
without a global determinism flag.

Examples
--------
>>> from repro_torch import random as jr
>>> from repro_torch.configs import smoke_config
>>> cfg = smoke_config("granite-moe-1b-a400m")
>>> p = init_moe(jr.PRNGKey(0, device="cpu"), cfg)
>>> {k: tuple(v.shape) for k, v in sorted(p.items())}
{'router': (256, 4), 'w_gate': (4, 256, 512), 'w_in': (4, 256, 512), 'w_out': (4, 512, 256)}
>>> out, aux = apply_moe(p, cfg, jr.normal(jr.PRNGKey(1, device="cpu"), (2, 8, 256)))
>>> tuple(out.shape), _capacity(cfg, 16)
((2, 8, 256), 64)
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as tnf

from ..configs.base import ArchConfig
from .layers import _normal, split
from .mlp import _act


def init_moe(key, cfg: ArchConfig):
    """The router (f32, scale d_model^-1/2) and the experts' gated MLPs;
    ``key`` splits four ways in the JAX package's order: router, w_in,
    w_gate, w_out (not ``init_mlp``'s)."""
    dm, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    k1, k2, k3, k4 = split(key, 4)
    return {
        "router": _normal(k1, (dm, e), dm ** -0.5),
        "w_in": _normal(k2, (e, dm, ff), dm ** -0.5),
        "w_gate": _normal(k3, (e, dm, ff), dm ** -0.5),
        "w_out": _normal(k4, (e, ff, dm), ff ** -0.5),
    }


def _capacity(cfg: ArchConfig, num_tokens: int) -> int:
    cap = int(cfg.capacity_factor * num_tokens * cfg.experts_per_token
              / cfg.num_experts)
    return max(8, (cap + 7) // 8 * 8)  # pad to 8 for tiling


class Routes(NamedTuple):
    """Where each kept (token, choice) goes, both ways. A token's ``k``
    choices are listed in ascending expert order, the dropped ones last.

    * ``top_e`` (n, k): the experts chosen;
    * ``keep`` (n, k): within the expert's capacity;
    * ``tok_slot`` (n, k): the flat slot ``e·cap + pos`` of each choice,
      ``E·cap`` (a zero row) where dropped;
    * ``slot_tok`` (E·cap,): the token of each slot, ``n`` (a zero row)
      where empty;
    * ``slot_choice`` (E·cap,): the flat index ``t·k + j`` of each slot's
      choice in this layout, ``n·k`` (a zero gate) where empty.
    """

    top_e: torch.Tensor
    keep: torch.Tensor
    tok_slot: torch.Tensor
    slot_tok: torch.Tensor
    slot_choice: torch.Tensor


def route(probs: torch.Tensor, k: int, cap: int) -> Routes:
    """The routing tables of router probabilities ``probs`` (n, E).

    The top-k is the first ``k`` of a stable descending sort, so equal
    probabilities choose the lower expert first, as ``lax.top_k`` does
    (``torch.topk`` promises no tie order). The capacity positions are the
    JAX package's cumsum over the one-hot choices flattened token-major
    (row ``t·k + j``)."""
    n, e = probs.shape
    top_e = torch.sort(probs.detach(), dim=-1, descending=True,
                       stable=True).indices[:, :k]
    flat = tnf.one_hot(top_e, e).reshape(n * k, e)
    pos_in_e = torch.cumsum(flat, dim=0) - flat
    pos = torch.sum(pos_in_e * flat, dim=-1).reshape(n, k)
    keep = pos < cap
    order = torch.sort(torch.where(keep, top_e, e), dim=-1,
                       stable=True).indices
    top_e, pos, keep = (v.gather(1, order) for v in (top_e, pos, keep))
    m = e * cap
    tok_slot = torch.where(keep, top_e * cap + pos, m)
    choices = torch.arange(n * k, device=probs.device)
    # dropped choices write to slots of their own past the m real ones, so
    # every destination is written once
    dest = torch.where(keep.reshape(-1), tok_slot.reshape(-1), m + choices)
    slot_choice = torch.full((m + n * k,), n * k, dtype=torch.int64,
                             device=probs.device)
    slot_choice = slot_choice.scatter(0, dest, choices)[:m]
    return Routes(top_e, keep, tok_slot,
                  torch.div(slot_choice, k, rounding_mode="floor"),
                  slot_choice)


def _padded(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` with a zero row appended (the target of empty indices)."""
    return torch.cat([rows, rows.new_zeros((1,) + rows.shape[1:])])


def _sum_rows(rows, idx, weights=None):
    """out[t] = Σ_j weights[t, j] · rows[idx[t, j]] over j in order (a zero
    row at ``idx == len(rows)``): k gathers and a running sum."""
    pad = _padded(rows)
    out = None
    for j in range(idx.shape[1]):
        term = pad.index_select(0, idx[:, j])
        if weights is not None:
            term = term * weights[:, j:j + 1]
        out = term if out is None else out + term
    return out


class _Dispatch(torch.autograd.Function):
    """tokens (n, d) → expert slots (E·cap, d), empty slots zero. The
    backward sums each token's kept slots' gradients in ascending expert
    order: a gather, where ``index_select``'s own backward scatters with
    atomics."""

    @staticmethod
    def forward(ctx, tokens, routes: Routes):
        ctx.routes = routes
        return _padded(tokens).index_select(0, routes.slot_tok)

    @staticmethod
    def backward(ctx, grad):
        return _sum_rows(grad, ctx.routes.tok_slot), None


class _Combine(torch.autograd.Function):
    """Expert outputs (E·cap, d) and gates (n, k) → tokens (n, d):
    out[t] = Σ_j gate[t, j] · ye[tok_slot[t, j]] in ascending expert order.
    The backward gathers both ways: a slot's gradient is its gate times its
    token's output gradient, a gate's is the dot of its token's output
    gradient with its slot's row."""

    @staticmethod
    def forward(ctx, ye, gate, routes: Routes):
        ctx.routes = routes
        ctx.save_for_backward(ye, gate)
        return _sum_rows(ye, routes.tok_slot, gate)

    @staticmethod
    def backward(ctx, grad):
        ye, gate = ctx.saved_tensors
        r = ctx.routes
        slot_gate = _padded(gate.reshape(-1)).index_select(0, r.slot_choice)
        grad_ye = (_padded(grad).index_select(0, r.slot_tok)
                   * slot_gate[:, None])
        pad = _padded(ye)
        grad_gate = torch.stack(
            [torch.sum(grad * pad.index_select(0, r.tok_slot[:, j]), dim=-1)
             for j in range(gate.shape[1])], dim=1)
        return grad_ye, grad_gate, None


def apply_moe(p, cfg: ArchConfig, x, *, shard_dispatch: bool = False,
              dropped: list | None = None):
    """x: (B, S, D) → (out (B, S, D), aux_loss scalar).

    ``shard_dispatch`` is the JAX package's sharding hint for the dispatch
    buffers, inert off a mesh; accepted and ignored until the sharded path
    (ROADMAP A20). ``dropped``, where given, is a list to which the count
    of this call's routed choices dropped at capacity is appended (a 0-d
    tensor), for measurement.

    Empty expert slots hold zero rows with gate 0 (the JAX package points
    them at token 0 with gate 0): either way they add exactly +0."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    tokens = x.reshape(b * s, d)
    n = tokens.shape[0]
    cap = _capacity(cfg, n)

    logits = tokens.float() @ p["router"]                        # (n, E)
    probs = torch.softmax(logits, dim=-1)
    r = route(probs, k, cap)
    # the chosen probabilities as a masked sum, not a gather (whose
    # backward scatters with atomics): one nonzero term, exact
    chosen = tnf.one_hot(r.top_e, e).to(probs.dtype)              # (n, k, E)
    top_p = torch.sum(probs[:, None, :] * chosen, dim=-1)
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)       # renormalize

    # Load-balance aux loss (Switch): E · Σ_e f_e · P_e
    me = torch.mean(probs, dim=0)                                # mean router prob
    ce = torch.sum(chosen, dim=(0, 1)) / (n * k)                 # token frac
    aux = e * torch.sum(me * ce)
    if dropped is not None:
        dropped.append(torch.sum(~r.keep))

    gate = torch.where(r.keep, top_p, 0.0)
    xe = _Dispatch.apply(tokens, r).reshape(e, cap, d)
    act = _act(cfg.activation)
    h = act(xe @ p["w_gate"]) * (xe @ p["w_in"])
    ye = (h @ p["w_out"]).reshape(e * cap, d)
    out = _Combine.apply(ye, gate, r)
    return out.reshape(b, s, d), aux
