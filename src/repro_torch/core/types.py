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
* ``mean_oracle(z, _)`` — the exact operator E[G(z, ξ)] where the problem
                      has one (bilinear, quadratic, robust logistic); metrics
                      (:func:`~repro_torch.core.metrics.kkt_residual`) and
                      deterministic tests use it.
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
    # Optional exact operator E[G(z, ξ)], per worker like ``oracle``.
    mean_oracle: Callable | None = None
    name: str = "problem"
    # Optional heterogeneous sampler ``(rngs, worker_ids) -> ξ``.
    sample_worker: Any = None


def draw(problem: MinimaxProblem, rngs, worker_ids=None):
    """One ξ per worker: the heterogeneous sampler when the problem has one,
    else the shared distribution."""
    if problem.sample_worker is not None and worker_ids is not None:
        return problem.sample_worker(rngs, worker_ids)
    return problem.sample(rngs)


def from_loss(loss_fn, init, sample, project=None, name="problem"):
    """A :class:`MinimaxProblem` from a saddle loss ``f((x, y), ξ)`` that
    returns one value per worker, ``(M,)``.

    The oracle is ``[∇x f, −∇y f]`` from one ``torch.autograd.grad`` over
    the joint tuple of leaves (the workers' losses are summed first; each
    worker's leaves enter only its own loss, so the gradient is per
    worker). ``x`` and ``y`` are tensors or tuples of tensors.

    Examples
    --------
    >>> import torch
    >>> def loss(z, xi):                       # f = x·y + ξ·x per worker
    ...     x, y = z
    ...     return (x * y).sum(-1) + (xi * x).sum(-1)
    >>> prob = from_loss(loss, init=None, sample=None)
    >>> x, y = torch.ones(2, 3), torch.full((2, 3), 2.0)
    >>> gx, gy = prob.oracle((x, y), torch.zeros(2, 3))
    >>> gx[0].tolist(), gy[0].tolist()
    ([2.0, 2.0, 2.0], [-1.0, -1.0, -1.0])
    """
    import torch

    from . import projections

    def oracle(z, xi):
        x, y = z
        xs = x if isinstance(x, tuple) else (x,)
        ys = y if isinstance(y, tuple) else (y,)
        with torch.enable_grad():
            leaves = tuple(v.detach().requires_grad_(True) for v in xs + ys)
            zz = (leaves[:len(xs)] if isinstance(x, tuple) else leaves[0],
                  leaves[len(xs):] if isinstance(y, tuple) else leaves[-1])
            grads = torch.autograd.grad(loss_fn(zz, xi).sum(), leaves)
        gx, gy = grads[:len(xs)], tuple(-g for g in grads[len(xs):])
        return (gx if isinstance(x, tuple) else gx[0],
                gy if isinstance(y, tuple) else gy[0])

    if project is None:
        project = projections.identity()
    return MinimaxProblem(
        init=init, sample=sample, oracle=oracle, project=project, name=name
    )
