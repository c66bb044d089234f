"""Fault policies: which workers are alive each round (port of
``repro.ps.faults``; numpy).

A worker that is down for round ``r`` runs no local steps, sends nothing
uphill (its weight is removed and the Line-7 weights are renormalised over
the survivors, its error-feedback residual stays frozen) and receives
nothing downhill (it keeps its stale anchor). Policies are deterministic
functions of their own ``seed``, so the tables equal the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class FaultPolicy:
    """Base class. Subclasses fill in :meth:`alive`.

    Examples
    --------
    >>> table = BernoulliFaults(p=0.5, seed=0).alive(4, 6)
    >>> table.shape, table.dtype.name
    ((6, 4), 'bool')
    """

    def alive(self, num_workers: int, rounds: int) -> np.ndarray:
        """(rounds, num_workers) bool table; True = worker participates."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class NoFaults(FaultPolicy):
    """Everyone up, every round — the engine's default, and the static
    guarantee that lets it skip aliveness masking entirely.

    Examples
    --------
    >>> bool(NoFaults().alive(2, 3).all())
    True
    """

    def alive(self, num_workers: int, rounds: int) -> np.ndarray:
        return np.ones((rounds, num_workers), dtype=bool)


@dataclasses.dataclass(frozen=True)
class BernoulliFaults(FaultPolicy):
    """Each round every worker independently fails with probability ``p``.
    ``protect_one`` keeps worker 0 always alive (the engine also tolerates
    an all-dead round: nobody receives and every anchor carries over).

    Examples
    --------
    >>> table = BernoulliFaults(p=0.9, seed=1).alive(3, 8)
    >>> bool(table[:, 0].all()), bool(table[:, 1:].all())
    (True, False)
    """

    p: float
    seed: int = 0
    protect_one: bool = True

    def alive(self, num_workers: int, rounds: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        up = rng.random((rounds, num_workers)) >= self.p
        if self.protect_one:
            up[:, 0] = True
        return up


@dataclasses.dataclass(frozen=True)
class OutageFaults(FaultPolicy):
    """Scripted outages: ``events`` is a tuple of (worker, start_round,
    end_round) half-open intervals during which the worker is down.

    Examples
    --------
    >>> OutageFaults(events=((1, 1, 3),)).alive(2, 4)[:, 1]
    array([ True, False, False,  True])
    """

    events: tuple  # ((worker, start, end), ...)

    def alive(self, num_workers: int, rounds: int) -> np.ndarray:
        up = np.ones((rounds, num_workers), dtype=bool)
        for worker, start, end in self.events:
            up[int(start):int(end), int(worker)] = False
        return up
