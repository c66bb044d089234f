"""Latency models of the event-driven engine (port of
``repro.ps.latency``): how long compute and communication take, per
worker.

:class:`~repro_torch.ps.async_engine.AsyncPSEngine` advances a *simulated*
clock; this module decides what the clock advances by. A
:class:`LatencyModel` produces, for a fleet of ``M`` workers over ``R``
worker-rounds, three ``(R, M)`` float64 tables (:class:`LatencyTables`):

* ``step_s``  — seconds per local step (round ``r`` of worker ``m`` costs
  ``K_m^r · step_s[r, m]`` of compute),
* ``up_s``    — network delay of the round's uplink message,
* ``down_s``  — network delay of the round's downlink broadcast.

Like the schedules (:mod:`repro_torch.ps.schedule`) and fault policies
(:mod:`repro_torch.ps.faults`), latency models are deterministic functions
of their own integer seed: the engine never stores the tables, it
re-derives them, which is what makes a resume of the event queue
bit-exact. The tables are host numpy in float64, drawn by the same
``numpy.random.default_rng`` calls as the JAX package's, so the two
packages' tables are equal element for element for the same seeds.

``ConstantLatency`` with worker-equal values is the degenerate model: the
whole fleet moves in lockstep, every arrival batches, and the async engine
reproduces the synchronous :class:`~repro_torch.ps.engine.PSEngine`
bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def _per_worker_row(value, num_workers: int, name: str) -> np.ndarray:
    """A scalar or length-M sequence -> (M,) float64 row."""
    row = np.asarray(value, dtype=np.float64).reshape(-1)
    if row.size == 1:
        row = np.full((num_workers,), float(row[0]))
    if row.shape != (num_workers,):
        raise ValueError(
            f"{name} must be a scalar or length-{num_workers} sequence, "
            f"got shape {row.shape}"
        )
    if (row < 0.0).any():
        raise ValueError(f"{name} must be nonnegative")
    return row


@dataclasses.dataclass(frozen=True)
class LatencyTables:
    """Realized (R, M) float64 delay tables for one fleet run.

    Examples
    --------
    >>> import numpy as np
    >>> t = LatencyTables(step_s=np.ones((2, 3)), up_s=np.zeros((2, 3)),
    ...                   down_s=np.zeros((2, 3)))
    >>> t.step_s.shape
    (2, 3)
    """

    step_s: np.ndarray   # seconds per local step
    up_s: np.ndarray     # uplink delay per round
    down_s: np.ndarray   # downlink delay per round

    def __post_init__(self):
        shapes = {self.step_s.shape, self.up_s.shape, self.down_s.shape}
        if len(shapes) != 1 or len(self.step_s.shape) != 2:
            raise ValueError(f"latency tables must share one (R, M) shape, "
                             f"got {shapes}")


class LatencyModel:
    """Base class. Subclasses fill in :meth:`tables`.

    Examples
    --------
    Models are seed-deterministic (R, M) table factories:

    >>> lat = LognormalLatency(step_s=1.0, sigma=0.5, seed=2)
    >>> a, b = lat.tables(3, 4), lat.tables(3, 4)
    >>> a.step_s.shape, bool((a.step_s == b.step_s).all())
    ((4, 3), True)
    """

    def tables(self, num_workers: int, rounds: int) -> LatencyTables:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ConstantLatency(LatencyModel):
    """Deterministic delays; each field is a scalar or a per-worker tuple.

    Worker-equal values are the degenerate lockstep model (the sync-parity
    anchor); per-worker ``step_s`` like ``(1, 1, 1, 4)`` is the classic
    persistent-straggler fleet.

    Examples
    --------
    >>> lat = ConstantLatency(step_s=(1.0, 4.0), up_s=0.5)
    >>> t = lat.tables(num_workers=2, rounds=3)
    >>> t.step_s[:, 1].tolist(), t.up_s[0].tolist()
    ([4.0, 4.0, 4.0], [0.5, 0.5])
    """

    step_s: float | tuple = 1.0
    up_s: float | tuple = 0.0
    down_s: float | tuple = 0.0

    def tables(self, num_workers: int, rounds: int) -> LatencyTables:
        def table(value, name):
            row = _per_worker_row(value, num_workers, name)
            return np.broadcast_to(row, (rounds, num_workers)).copy()

        return LatencyTables(
            step_s=table(self.step_s, "step_s"),
            up_s=table(self.up_s, "up_s"),
            down_s=table(self.down_s, "down_s"),
        )


@dataclasses.dataclass(frozen=True)
class LognormalLatency(LatencyModel):
    """Heavy-tailed jitter: every (round, worker) compute/uplink draw is the
    median scaled by an independent lognormal multiplier ``exp(sigma · N)``
    — the standard model for datacenter straggler tails (median = the
    configured value, mean above it).

    Examples
    --------
    >>> lat = LognormalLatency(step_s=2.0, sigma=0.3, seed=7)
    >>> t = lat.tables(num_workers=4, rounds=5)
    >>> bool((t.step_s > 0).all())
    True
    """

    step_s: float = 1.0
    sigma: float = 0.5        # log-std of the per-round compute multiplier
    up_s: float = 0.0
    down_s: float = 0.0
    net_sigma: float = 0.0    # log-std of the uplink/downlink multipliers
    seed: int = 0

    def tables(self, num_workers: int, rounds: int) -> LatencyTables:
        rng = np.random.default_rng(self.seed)
        shape = (rounds, num_workers)

        def jitter(median, sig, name):
            base = np.broadcast_to(
                _per_worker_row(median, num_workers, name), shape
            )
            if sig <= 0.0:
                return base.copy()
            return base * np.exp(sig * rng.standard_normal(shape))

        return LatencyTables(
            step_s=jitter(self.step_s, self.sigma, "step_s"),
            up_s=jitter(self.up_s, self.net_sigma, "up_s"),
            down_s=jitter(self.down_s, self.net_sigma, "down_s"),
        )


@dataclasses.dataclass(frozen=True)
class MarkovLatency(LatencyModel):
    """Gilbert–Elliott slow/fast compute: each worker carries a two-state
    Markov chain over its rounds — fast workers fall into a ``slow_factor``×
    slower state with probability ``p_slow`` per round and recover with
    probability ``p_recover``. Models transient co-tenancy/thermal
    throttling rather than a permanently slow machine; ``start_slow`` pins
    chosen workers into the slow state at round 0.

    Examples
    --------
    >>> lat = MarkovLatency(step_s=1.0, slow_factor=8.0, start_slow=(0,),
    ...                     p_recover=0.0, p_slow=0.0, seed=0)
    >>> t = lat.tables(num_workers=2, rounds=3)
    >>> t.step_s[:, 0].tolist(), t.step_s[:, 1].tolist()
    ([8.0, 8.0, 8.0], [1.0, 1.0, 1.0])
    """

    step_s: float = 1.0
    slow_factor: float = 8.0
    p_slow: float = 0.1
    p_recover: float = 0.3
    up_s: float = 0.0
    down_s: float = 0.0
    seed: int = 0
    start_slow: tuple = ()

    def tables(self, num_workers: int, rounds: int) -> LatencyTables:
        rng = np.random.default_rng(self.seed)
        draws = rng.random((rounds, num_workers))
        slow = np.zeros((rounds, num_workers), dtype=bool)
        state = np.zeros((num_workers,), dtype=bool)
        state[list(self.start_slow)] = True
        for r in range(rounds):
            slow[r] = state
            flip = np.where(state, draws[r] < self.p_recover,
                            draws[r] < self.p_slow)
            state = state ^ flip
        step = np.where(slow, self.step_s * self.slow_factor, self.step_s)
        net = np.broadcast_to
        return LatencyTables(
            step_s=step.astype(np.float64),
            up_s=net(_per_worker_row(self.up_s, num_workers, "up_s"),
                     (rounds, num_workers)).copy(),
            down_s=net(_per_worker_row(self.down_s, num_workers, "down_s"),
                       (rounds, num_workers)).copy(),
        )


@dataclasses.dataclass(frozen=True)
class TraceLatency(LatencyModel):
    """Trace-driven delays: replay measured per-round tables (e.g. profiled
    from a real fleet). Inputs are array-likes of shape ``(R0, M)`` (or
    ``(M,)``, or scalars); rounds beyond ``R0`` cycle through the trace.

    Examples
    --------
    A 2-round trace cycling over 3 simulated rounds:

    >>> lat = TraceLatency(step_s=[[1.0, 2.0], [3.0, 4.0]])
    >>> lat.tables(num_workers=2, rounds=3).step_s.tolist()
    [[1.0, 2.0], [3.0, 4.0], [1.0, 2.0]]
    """

    step_s: tuple
    up_s: tuple = (0.0,)
    down_s: tuple = (0.0,)

    def __init__(self, step_s, up_s=0.0, down_s=0.0):
        def freeze(v):
            arr = np.atleast_1d(np.asarray(v, dtype=np.float64))
            return tuple(map(tuple, np.atleast_2d(arr)))

        object.__setattr__(self, "step_s", freeze(step_s))
        object.__setattr__(self, "up_s", freeze(up_s))
        object.__setattr__(self, "down_s", freeze(down_s))

    def tables(self, num_workers: int, rounds: int) -> LatencyTables:
        def tile(rows, name):
            arr = np.asarray(rows, dtype=np.float64)
            if arr.shape[1] == 1:
                arr = np.broadcast_to(arr, (arr.shape[0], num_workers))
            if arr.shape[1] != num_workers:
                raise ValueError(
                    f"{name} trace has {arr.shape[1]} workers, fleet has "
                    f"{num_workers}"
                )
            reps = -(-rounds // arr.shape[0])            # ceil division
            return np.tile(arr, (reps, 1))[:rounds].copy()

        return LatencyTables(
            step_s=tile(self.step_s, "step_s"),
            up_s=tile(self.up_s, "up_s"),
            down_s=tile(self.down_s, "down_s"),
        )
