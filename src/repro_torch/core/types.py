"""Problem abstraction for stochastic minimax optimization (port of
``repro.core.types``).

    min_{x ∈ X} max_{y ∈ Y}  F(x, y) = E_ξ f(x, y, ξ)

Where the JAX package vmaps a per-worker problem over a stacked worker
axis, the port writes that axis out: every function below takes and returns
tensors with a leading worker dimension ``M``.

* ``init(rngs)``    — ``(M, 2)`` keys → the initial joint iterate
                      ``z₀ = (x₀, y₀)``, each leaf ``(M, ...)``.
* ``sample(rngs)``  — ``(M, 2)`` keys → one draw of ξ per worker.
* ``oracle(z, ξ)``  — the stochastic gradient field
                      ``G(z, ξ) = [∂x f, −∂y f]`` per worker, a descent
                      direction for both blocks (``z ← Π_Z(z − η·G)``).
* ``project(z)``    — Euclidean projection Π_Z, per worker.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

PyTree = Any


@dataclasses.dataclass(frozen=True)
class MinimaxProblem:
    init: Callable
    sample: Callable
    oracle: Callable
    project: Callable
    name: str = "problem"
    # Optional heterogeneous sampler ``(rngs, worker_ids) -> ξ``.
    sample_worker: Any = None


def draw(problem: MinimaxProblem, rngs, worker_ids=None):
    """One ξ per worker: the heterogeneous sampler when the problem has one,
    else the shared distribution."""
    if problem.sample_worker is not None and worker_ids is not None:
        return problem.sample_worker(rngs, worker_ids)
    return problem.sample(rngs)
