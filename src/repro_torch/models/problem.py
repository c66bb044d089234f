"""Language models as :class:`~repro_torch.core.types.MinimaxProblem`
instances (port of ``repro.models.problem``).

A language model is a minimization-only minimax problem: the dual block is
empty, so wrapping :func:`~repro_torch.models.transformer.loss_fn` as an
oracle puts a transformer on the same engine path as the bilinear game.

The port's problem functions take the whole fleet (every leaf with a
leading worker axis ``M``):

* ``init(rngs)``   — ``(M, 2)`` keys → one parameter set per worker, as a
  tuple of worker-stacked leaves in ``jax.tree.leaves`` order;
* ``sample(rngs)`` — one Markov-Zipf batch per worker,
  ``{"tokens", "labels"}`` of shape ``(M, batch, seq)``;
* ``oracle(z, ξ)`` — ``torch.autograd.grad`` of the next-token
  cross-entropy, one worker at a time; with ``cfg.attn_backend="pallas"``
  the forward runs the flash-attention kernel;
* ``project``      — identity, which makes the fused AdaSEG step kernels
  eligible (``core.projections.spec_of``).

``hetero_workers=M`` installs a ``sample_worker`` whose Markov repetition
probability sweeps 0.1 → 0.8 across worker ids.

Examples
--------
A tiny transformer as a problem; one oracle call is one model gradient per
worker:

>>> from repro_torch import random as jr
>>> cfg = tiny_lm_config()
>>> prob = make_lm_problem(cfg, batch=2, seq=8)
>>> keys = jr.split(jr.PRNGKey(0, device="cpu"), 2)
>>> z0 = prob.init(keys)
>>> g = prob.oracle(z0, prob.sample(keys))
>>> [tuple(a.shape) for a in g] == [tuple(a.shape) for a in z0]
True
"""
from __future__ import annotations

import torch

from .. import random as jr
from .._device import resolve_device
from ..configs.base import ArchConfig
from ..core import projections
from ..core.types import MinimaxProblem
from ..data.synthetic import make_batch, sample_tokens
from .transformer import (
    check_supported,
    init_model,
    loss_fn,
    param_leaves,
    param_tree,
)


def tiny_lm_config(name: str = "tiny-lm", *, vocab: int = 64,
                   d_model: int = 32, layers: int = 2,
                   attn_backend: str = "reference") -> ArchConfig:
    """A CPU-second-scale dense transformer config for tests."""
    return ArchConfig(
        name=name, arch_type="dense", num_layers=layers, d_model=d_model,
        num_heads=2, num_kv_heads=1, d_ff=2 * d_model, vocab_size=vocab,
        head_dim=d_model // 2, max_seq_len=64, attn_backend=attn_backend,
    )


def _hetero_sampler(cfg: ArchConfig, batch: int, seq: int,
                    hetero_workers: int):
    """Per-worker Markov-Zipf stream: the repetition probability sweeps
    0.1 → 0.8 across worker ids."""
    span = max(hetero_workers - 1, 1)

    def sample_worker(rngs, worker_ids):
        p_rep = 0.1 + 0.7 * worker_ids.to(torch.float32) / span   # (M,)
        r = jr.split(jr.fold_in(rngs, 11))
        r1, r2 = r[..., 0, :], r[..., 1, :]
        base = sample_tokens(r1, batch, seq, cfg.vocab_size)
        rep = jr.bernoulli(r2, p_rep.reshape(-1, 1, 1), base.shape[-2:])
        shifted = (torch.roll(base, 1, dims=-1) + 1) % cfg.vocab_size
        toks = torch.where(rep, shifted, base).to(torch.int32)
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}

    return sample_worker


def grad_per_worker(cfg: ArchConfig, z, xi) -> tuple:
    """The gradient of each worker's loss at its own parameters, stacked
    like ``z``: a loop over the worker axis, each step one
    ``torch.autograd.grad`` of :func:`loss_fn`."""
    out = tuple(torch.empty_like(v) for v in z)
    for i in range(z[0].shape[0]):
        leaves = tuple(v[i].detach().requires_grad_() for v in z)
        batch = {k: t[i] for k, t in xi.items()}
        with torch.enable_grad():
            loss = loss_fn(param_tree(leaves, cfg), cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for o, g in zip(out, grads):
            if g is None:
                o[i].zero_()
            else:
                o[i].copy_(g)
    return out


def make_lm_problem(cfg: ArchConfig, *, batch: int, seq: int,
                    hetero_workers: int | None = None) -> MinimaxProblem:
    """Language-model training as a minimization-only MinimaxProblem.

    ``batch``/``seq`` are per-worker, per-oracle-call shapes; the
    extragradient step makes two oracle calls per local step, each with its
    own derived key."""
    cfg.validate()
    check_supported(cfg)

    def init(rngs):
        return param_leaves(init_model(rngs, cfg))

    def sample(rngs):
        return make_batch(rngs, cfg, batch, seq)

    def oracle(z, xi):
        return grad_per_worker(cfg, z, xi)

    return MinimaxProblem(
        init=init,
        sample=sample,
        oracle=oracle,
        project=projections.identity(),
        name=f"lm[{cfg.name}]x{batch}x{seq}",
        sample_worker=(_hetero_sampler(cfg, batch, seq, hetero_workers)
                       if hetero_workers else None),
    )


def make_eval_loss(cfg: ArchConfig, *, batch: int, seq: int, rng=None,
                   device="cuda"):
    """Held-out-loss ``eval_fn`` for the engine: the cross-entropy of the
    global output iterate z̄ (a tuple of leaves, no worker axis) on one
    fixed batch drawn from ``rng`` (default ``PRNGKey(987)``)."""
    dev = resolve_device(device)
    rng = jr.PRNGKey(987, device=dev) if rng is None else rng.to(dev)
    eval_batch = make_batch(rng, cfg, batch, seq)

    @torch.no_grad()
    def eval_fn(params):
        return loss_fn(param_tree(params, cfg), cfg, eval_batch)

    return eval_fn
