"""Fault policies: which workers are alive each round (port of
``repro.ps.faults``; numpy). Only the fault-free policy is ported in this
slice; failing workers come in a later one.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class FaultPolicy:
    """Base class. Subclasses fill in :meth:`alive`."""

    def alive(self, num_workers: int, rounds: int) -> np.ndarray:
        """(rounds, num_workers) bool table; True = worker participates."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class NoFaults(FaultPolicy):
    """Everyone up, every round — the engine's default.

    Examples
    --------
    >>> bool(NoFaults().alive(2, 3).all())
    True
    """

    def alive(self, num_workers: int, rounds: int) -> np.ndarray:
        return np.ones((rounds, num_workers), dtype=bool)
