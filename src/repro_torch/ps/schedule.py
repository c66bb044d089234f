"""Worker schedules: how many local steps K_m^r each worker runs in each
round (port of ``repro.ps.schedule``; numpy, as in the JAX package).

The engine pads every round to the schedule's static ``max_steps`` and
masks the tail with the ``enabled`` argument of ``core.adaseg.local_step``.
Schedules are deterministic, so the full (R, M) table is reproducible from
the config alone. Straggler, fixed and elastic schedules come in a later
slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class WorkerSchedule:
    """Base class. Subclasses fill in :meth:`steps` and :meth:`max_steps`."""

    def max_steps(self, num_workers: int) -> int:
        """Static upper bound on K_m^r — the engine's per-round loop length."""
        raise NotImplementedError

    def steps(self, num_workers: int, rounds: int) -> np.ndarray:
        """(rounds, num_workers) int32 table of per-round local step counts."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class UniformSchedule(WorkerSchedule):
    """Every worker runs ``k`` steps every round — the paper's synchronous
    Parameter-Server setting.

    Examples
    --------
    >>> UniformSchedule(k=3).steps(num_workers=2, rounds=2)
    array([[3, 3],
           [3, 3]], dtype=int32)
    """

    k: int

    def max_steps(self, num_workers: int) -> int:
        return int(self.k)

    def steps(self, num_workers: int, rounds: int) -> np.ndarray:
        return np.full((rounds, num_workers), self.k, dtype=np.int32)
