"""Deterministic synthetic token streams (port of
``repro.data.synthetic``).

Tokens follow a power-law unigram over the vocabulary with a first-order
Markov term (with p = 0.3 the next token is the previous one plus 1), drawn
from the threefry clone in :mod:`repro_torch.random`, so a key gives the
JAX package's tokens. Keys may carry leading batch axes: keys ``(M, 2)``
give ``(M, batch, seq + 1)`` tokens, worker ``m`` drawn with its own key, as
``jax.vmap`` over keys does. The Dirichlet heterogeneity helpers are ported
with ``ps.partition`` (ROADMAP A9).

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
            "with the other model kinds (ROADMAP A18, A19)")
    toks = sample_tokens(rng, batch, seq, cfg.vocab_size)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def batch_struct(cfg: ArchConfig, lead: tuple[int, ...], batch: int,
                 seq: int) -> dict:
    """Shape and dtype of a batch with leading dims ``lead`` (local steps ×
    oracle calls × workers for a round), as ``{name: (shape, dtype)}``."""
    if cfg.encoder_seq:
        raise NotImplementedError(
            "frontend stubs are ported with the other model kinds "
            "(ROADMAP A18, A19)")
    tok = ((*lead, batch, seq), torch.int32)
    return {"tokens": tok, "labels": tok}
