"""Deterministic synthetic data (port of ``repro.data``): the Markov-Zipf
token stream the language-model problems draw their batches from, and the
Dirichlet helpers of the heterogeneous data layer."""
from .synthetic import (
    batch_struct,
    dirichlet_proportions,
    group_sampling_logits,
    make_batch,
    quantile_groups,
    sample_tokens,
)

__all__ = ["batch_struct", "dirichlet_proportions", "group_sampling_logits",
           "make_batch", "quantile_groups", "sample_tokens"]
