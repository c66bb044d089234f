"""Sampled-client rounds: the server draws S of N fleet workers per round
(port of ``repro.ps.sampler``, numpy only).

This is the partial-participation regime of federated minimax training:
the fleet is large (``PSConfig.num_workers`` = N, possibly 10k+), but each
round only a seed-deterministic subset of ``sample`` = S workers takes
part: it runs local steps, uplinks and receives the broadcast. Everyone
else keeps their per-worker state (η accumulators, error-feedback
residuals, stale anchor) frozen in the fleet store until their next draw.

As with the schedules, faults and latency models, the tables are a pure
function of the config seed, re-derived on restore rather than stored, and
equal to the JAX package's entry for entry (the same numpy generator).

What the engines rely on:

* ``draws`` rows are **sorted ascending** and **without replacement**;
* ``sample == fleet`` with uniform weights draws everyone every round (each
  row is ``arange(N)``); the engines still run the gather/scatter path
  then, which gives the same numbers as ``sampler=None``.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClientSampler:
    """Seed-deterministic per-round client sampling.

    ``sample`` workers are drawn per round from the fleet of
    ``config.num_workers``, uniformly or with per-worker ``weights``
    (inclusion probability proportional to weight, drawn without
    replacement).

    Examples
    --------
    >>> s = ClientSampler(sample=2, seed=0)
    >>> d = s.draws(num_workers=5, rounds=3)
    >>> d.shape, d.dtype
    ((3, 2), dtype('int32'))
    >>> bool((d[:, 0] < d[:, 1]).all())      # rows sorted ascending
    True
    >>> np.array_equal(d, s.draws(5, 3))     # reproducible from the seed
    True
    """

    sample: int
    seed: int = 0
    # Optional per-fleet-worker sampling weights, length num_workers.
    weights: tuple[float, ...] | None = None

    def __post_init__(self):
        if self.sample < 1:
            raise ValueError("sample must be >= 1")
        if self.weights is not None:
            w = np.asarray(self.weights, dtype=np.float64)
            if (w < 0).any() or w.sum() <= 0:
                raise ValueError("weights must be nonnegative with a "
                                 "positive sum")

    @property
    def name(self) -> str:
        kind = "uniform" if self.weights is None else "weighted"
        return f"sample{self.sample}-{kind}-seed{self.seed}"

    @property
    def fingerprint(self) -> int:
        """uint32 hash of the sampling law, checkpointed so that a resumed
        run is refused if it would replay a different participation
        table."""
        desc = self.name
        if self.weights is not None:
            desc += ":" + ",".join(f"{w:.9g}" for w in self.weights)
        return zlib.crc32(desc.encode()) & 0xFFFFFFFF

    def _probs(self, num_workers: int) -> np.ndarray | None:
        if self.weights is None:
            return None
        w = np.asarray(self.weights, dtype=np.float64)
        if w.shape != (num_workers,):
            raise ValueError(
                f"weights has length {w.shape[0]}, fleet is {num_workers}")
        return w / w.sum()

    def draws(self, num_workers: int, rounds: int) -> np.ndarray:
        """(rounds, sample) int32 table of participating fleet ids, each
        row sorted ascending, drawn without replacement."""
        if self.sample > num_workers:
            raise ValueError(
                f"sample={self.sample} exceeds fleet size {num_workers}")
        p = self._probs(num_workers)
        rng = np.random.default_rng(self.seed)
        out = np.empty((rounds, self.sample), dtype=np.int32)
        for r in range(rounds):
            out[r] = np.sort(rng.choice(num_workers, size=self.sample,
                                        replace=False, p=p))
        return out

    def participation(self, num_workers: int, rounds: int) -> np.ndarray:
        """(rounds, num_workers) bool mask: True where the worker is drawn
        for that round (the event-driven engine's skip table)."""
        mask = np.zeros((rounds, num_workers), dtype=bool)
        np.put_along_axis(mask, self.draws(num_workers, rounds), True,
                          axis=1)
        return mask
