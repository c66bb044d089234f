"""Deterministic synthetic token streams (port of
``repro.data.synthetic``).

Tokens follow a power-law unigram over the vocabulary with a first-order
Markov term (with p = 0.3 the next token is the previous one plus 1), drawn
from the threefry clone in :mod:`repro_torch.random`, so a key gives the
JAX package's tokens. Keys may carry leading batch axes: keys ``(M, 2)``
give ``(M, batch, seq + 1)`` tokens, worker ``m`` drawn with its own key, as
``jax.vmap`` over keys does. The Dirichlet heterogeneity helpers at the end
carve per-worker distributions for ``repro_torch.ps.partition``.

Examples
--------
>>> from repro_torch import random as jr
>>> toks = sample_tokens(jr.PRNGKey(0, device="cpu"), 2, 8, 64)
>>> toks.shape, toks.dtype, bool(((toks >= 0) & (toks < 64)).all())
(torch.Size([2, 9]), torch.int32, True)
"""
from __future__ import annotations

import torch

from .. import random as jr
from ..configs.base import ArchConfig


def _zipf_logits(vocab: int, alpha: float = 1.2,
                 device="cpu") -> torch.Tensor:
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    return -alpha * torch.log(ranks)


def sample_tokens(rng: torch.Tensor, batch: int, seq: int,
                  vocab: int) -> torch.Tensor:
    """``(*key_batch, batch, seq+1)`` int32 token ids: a Zipf unigram plus a
    deterministic Markov shift."""
    r = jr.split(rng)
    r1, r2 = r[..., 0, :], r[..., 1, :]
    base = jr.categorical(r1, _zipf_logits(vocab, device=rng.device),
                          (batch, seq + 1))
    # Markov structure: with p=0.3 the next token is prev+1 (mod vocab)
    rep = jr.bernoulli(r2, 0.3, (batch, seq + 1))
    shifted = torch.roll(base, 1, dims=-1) + 1
    return torch.where(rep, shifted % vocab, base).to(torch.int32)


def make_batch(rng: torch.Tensor, cfg: ArchConfig, batch: int,
               seq: int) -> dict:
    """``{"tokens", "labels"}``, each ``(*key_batch, batch, seq)``: the
    stream and the stream shifted by one."""
    if cfg.encoder_seq:
        raise NotImplementedError(
            "frontend stubs (encoder-decoder and VLM configs) are ported "
            "with serving (ROADMAP A19)")
    toks = sample_tokens(rng, batch, seq, cfg.vocab_size)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def batch_struct(cfg: ArchConfig, lead: tuple[int, ...], batch: int,
                 seq: int) -> dict:
    """Shape and dtype of a batch with leading dims ``lead`` (local steps ×
    oracle calls × workers for a round), as ``{name: (shape, dtype)}``."""
    if cfg.encoder_seq:
        raise NotImplementedError(
            "frontend stubs are ported with serving (ROADMAP A19)")
    tok = ((*lead, batch, seq), torch.int32)
    return {"tokens": tok, "labels": tok}


# ---------------------------------------------------------------------------
# Dirichlet heterogeneity helpers — the federated/Parameter-Server data layer
# (``repro_torch.ps.partition``) carves per-worker oracles with these.
# ---------------------------------------------------------------------------

def dirichlet_proportions(rng: torch.Tensor, num_workers: int,
                          num_groups: int, alpha: float) -> torch.Tensor:
    """(num_workers, num_groups) rows on the simplex, p_m ~ Dir(alpha·1),
    from key ``rng`` as ``jax.random.dirichlet`` draws them (equal to the
    JAX package's rows at a tolerance: ``random.loggamma``).

    ``alpha → 0`` gives near-disjoint group ownership (maximal
    heterogeneity), ``alpha → ∞`` the uniform split (Hsu et al. '19).

    >>> from repro_torch import random as jr
    >>> p = dirichlet_proportions(jr.PRNGKey(0, device="cpu"), 3, 4, 0.4)
    >>> tuple(p.shape), bool(torch.allclose(p.sum(1), torch.ones(3)))
    ((3, 4), True)
    """
    alpha_vec = alpha * torch.ones(num_groups, dtype=torch.float32,
                                   device=rng.device)
    return jr.dirichlet(rng, alpha_vec, (num_workers,))


def group_sampling_logits(proportions: torch.Tensor, group_of: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """(M, n) categorical logits over items: worker m draws item i with
    probability ∝ ``proportions[m, group_of[i]]`` (a soft Dirichlet
    partition without ragged index sets)."""
    p_items = proportions[:, group_of.long()]                  # (M, n)
    p_items = p_items / p_items.sum(dim=1, keepdim=True).expand(
        p_items.shape)
    return torch.log(p_items + eps)


def quantile_groups(values: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Each entry of ``values`` into one of ``num_groups`` equal-mass
    quantile bins (int32): ranks from two stable argsorts, so ties rank by
    position, as ``jnp.argsort`` ranks them.

    >>> quantile_groups(torch.tensor([3.0, 1.0, 1.0, 2.0]), 2).tolist()
    [1, 0, 0, 1]
    """
    n = values.shape[0]
    ranks = torch.argsort(torch.argsort(values, stable=True), stable=True)
    return (ranks * num_groups // n).to(torch.int32)
