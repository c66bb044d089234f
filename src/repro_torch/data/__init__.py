"""Deterministic synthetic data (port of ``repro.data``): the Markov-Zipf
token stream the language-model problems draw their batches from."""
from .synthetic import batch_struct, make_batch, sample_tokens

__all__ = ["batch_struct", "make_batch", "sample_tokens"]
