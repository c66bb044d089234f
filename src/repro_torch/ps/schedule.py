"""Worker schedules: how many local steps K_m^r each worker runs in each
round (port of ``repro.ps.schedule``; numpy, as in the JAX package).

The engine pads every round to the schedule's static ``max_steps`` and
masks the tail with the ``enabled`` argument of ``core.adaseg.local_step``.
Schedules are deterministic: stochastic ones derive every draw from their
own integer ``seed`` with numpy, so the full (R, M) table is reproducible
from the config alone and equals the JAX package's integer for integer.

``K_m^r = 0`` models elastic membership: the worker skips the round's
local work but stays a member — it still contributes its (stale) anchor to
the weighted average and receives the broadcast. Workers removed from the
average are the business of :mod:`repro_torch.ps.faults`.
"""
from __future__ import annotations

import dataclasses

import numpy as np


class WorkerSchedule:
    """Base class. Subclasses fill in :meth:`steps` and :meth:`max_steps`.

    Examples
    --------
    >>> sched = StragglerSchedule(k=5, min_frac=0.4, seed=1)
    >>> table = sched.steps(num_workers=3, rounds=4)
    >>> table.shape, bool((table <= sched.max_steps(3)).all())
    ((4, 3), True)
    """

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


@dataclasses.dataclass(frozen=True)
class FixedSchedule(WorkerSchedule):
    """Static per-worker K_m, constant across rounds — the asynchronous
    variant of the paper's Appendix E.1.

    Examples
    --------
    >>> FixedSchedule([3, 1]).steps(num_workers=2, rounds=2)
    array([[3, 1],
           [3, 1]], dtype=int32)
    """

    local_steps: tuple

    def __init__(self, local_steps):
        object.__setattr__(
            self, "local_steps",
            tuple(int(k) for k in np.asarray(local_steps).reshape(-1)),
        )

    def max_steps(self, num_workers: int) -> int:
        return max(self.local_steps)

    def steps(self, num_workers: int, rounds: int) -> np.ndarray:
        ks = np.asarray(self.local_steps, dtype=np.int32)
        if ks.shape[0] != num_workers:
            raise ValueError(
                f"schedule has {ks.shape[0]} workers, engine has {num_workers}"
            )
        return np.broadcast_to(ks, (rounds, num_workers)).copy()


@dataclasses.dataclass(frozen=True)
class StragglerSchedule(WorkerSchedule):
    """Seed-driven stragglers: each round every worker completes
    ``K_m^r ~ Uniform{ceil(min_frac·k), …, k}`` steps before the sync
    deadline. Workers in ``slow_workers`` are pinned at the minimum.

    Examples
    --------
    >>> sched = StragglerSchedule(k=10, min_frac=0.5, seed=0,
    ...                           slow_workers=(1,))
    >>> table = sched.steps(num_workers=3, rounds=5)
    >>> bool((table[:, 1] == 5).all())           # pinned straggler
    True
    >>> bool((table >= 5).all() and (table <= 10).all())
    True
    """

    k: int
    min_frac: float = 0.5
    seed: int = 0
    slow_workers: tuple = ()

    def max_steps(self, num_workers: int) -> int:
        return int(self.k)

    def steps(self, num_workers: int, rounds: int) -> np.ndarray:
        lo = max(1, int(np.ceil(self.min_frac * self.k)))
        rng = np.random.default_rng(self.seed)
        ks = rng.integers(lo, self.k + 1, size=(rounds, num_workers))
        for m in self.slow_workers:
            ks[:, int(m)] = lo
        return ks.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class ElasticSchedule(WorkerSchedule):
    """Elastic membership on top of an inner schedule: each round every
    worker independently sits out (K_m^r = 0) with probability ``dropout``.
    Sitting out is not failing: the worker still syncs.

    Examples
    --------
    >>> sched = ElasticSchedule(UniformSchedule(k=4), dropout=0.5, seed=3)
    >>> sorted(set(sched.steps(num_workers=4, rounds=6).reshape(-1).tolist()))
    [0, 4]
    """

    inner: WorkerSchedule
    dropout: float = 0.2
    seed: int = 0

    def max_steps(self, num_workers: int) -> int:
        return self.inner.max_steps(num_workers)

    def steps(self, num_workers: int, rounds: int) -> np.ndarray:
        ks = self.inner.steps(num_workers, rounds)
        rng = np.random.default_rng(self.seed)
        out = rng.random((rounds, num_workers)) < self.dropout
        return np.where(out, 0, ks).astype(np.int32)
