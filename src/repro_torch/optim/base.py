"""Unified functional interface for stochastic minimax optimizers (port of
``repro.optim.base``).

Every optimizer in the zoo (the paper's comparison set, §4.1 Fig. 4) is a
pair of functions over an :class:`OptState`:

    init(problem, rngs)          -> OptState
    step(problem, state, rngs)   -> OptState

with optimizer-specific extras in ``state.inner``. Where the JAX package
vmaps a one-worker state, the state here is the whole fleet: every leaf
has a leading worker axis ``M`` and ``rngs`` is ``(M, 2)``, one key per
worker. Execution:

* :func:`run_serial`  — one worker, T steps, with ``lax.scan``'s key
  splits (and, with :func:`minibatch`, the paper's MB-* baselines).
* :class:`MinimaxWorker` — any :class:`MinimaxOptimizer` as a
  :class:`~repro_torch.core.worker.LocalWorker` on the port's
  ``PSEngine``: schedules, codecs, faults, hostile fleets, checkpoints and
  the fused sync kernels apply to the zoo unchanged.
* :func:`run_local`   — the historical local-update loop as a thin
  wrapper over that engine (R rounds × K local steps with periodic weighted averaging).

LocalAdaSEG itself is ``repro_torch.core.adaseg`` (with its inverse-η
weighting), on the engine through ``AdaSEGWorker``.

Examples
--------
>>> from repro_torch import random as jr
>>> from repro_torch.optim import segda
>>> from repro_torch.problems import make_bilinear_game
>>> game = make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=4, sigma=0.1,
...                           device="cpu")
>>> st, hist = run_local(segda(0.05), game.problem, num_workers=2,
...                      local_k=3, rounds=2, rng=jr.PRNGKey(1, device="cpu"),
...                      device="cpu")
>>> st.t.tolist(), [tuple(v.shape) for v in hist]
([6, 6], [(2, 4), (2, 4)])
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from .. import random as jr
from ..core.tree import per_worker, tree_map, tree_zeros_like
from ..core.types import MinimaxProblem
from ..core.worker import LocalWorker

PyTree = Any


class OptState(NamedTuple):
    z: PyTree                 # current (anchor) iterate, leaves (M, ...)
    z_bar: PyTree             # running uniform average of exploration iterates
    t: torch.Tensor           # step counts, (M,) int32
    inner: PyTree             # optimizer-specific state
    # (M,) int32 heterogeneous-sampler tags; None only for states built
    # outside base_init, and core.types.draw then uses the iid sampler.
    worker_id: torch.Tensor | None = None


def _uniform_weight(state: OptState) -> torch.Tensor:
    return torch.ones(state.t.shape[0], dtype=torch.float32,
                      device=state.t.device)


@dataclasses.dataclass(frozen=True)
class MinimaxOptimizer:
    name: str
    init: Callable[[MinimaxProblem, Any], OptState]
    step: Callable[[MinimaxProblem, OptState, Any], OptState]
    # (M,) weights for periodic averaging; LocalAdaSEG-style optimizers
    # return 1/η, plain optimizers 1 (uniform FedAvg weighting).
    sync_weight: Callable[[OptState], torch.Tensor] = _uniform_weight


def base_init(problem: MinimaxProblem, rngs: torch.Tensor, inner: PyTree = (),
              worker_ids=None) -> OptState:
    """The fleet's start from ``(M, 2)`` keys: z₀ = Π(init), z̄ = 0, t = 0;
    ``worker_ids`` default to 0 for every worker, as the JAX package's
    ``base_init`` gives each worker."""
    z0 = problem.project(problem.init(rngs))
    m = rngs.shape[0]
    if worker_ids is None:
        worker_ids = torch.zeros(m, dtype=torch.int32, device=rngs.device)
    return OptState(z=z0, z_bar=tree_zeros_like(z0),
                    t=torch.zeros(m, dtype=torch.int32, device=rngs.device),
                    inner=inner, worker_id=worker_ids)


def update_mean(z_bar: PyTree, z_new: PyTree, t_new: torch.Tensor) -> PyTree:
    """z̄ + (z − z̄)/t per worker."""
    return tree_map(
        lambda zb, zt: zb + (zt - zb) / per_worker(t_new, zt).to(zt.dtype),
        z_bar, z_new)


def _lead(xi, fn):
    """``fn`` on every tensor of a draw (a tensor, tuple or dict)."""
    if isinstance(xi, dict):
        return {k: _lead(v, fn) for k, v in xi.items()}
    if isinstance(xi, (tuple, list)):
        return type(xi)(_lead(v, fn) for v in xi)
    return fn(xi)


def minibatch(problem: MinimaxProblem, batch: int) -> MinimaxProblem:
    """Average the stochastic oracle over ``batch`` iid draws (variance/B):
    worker m's draws come from ``split(rngs[m], batch)``, and the oracle
    runs on the ``M·batch`` (iterate, draw) pairs at once."""

    def sample(rngs):
        return problem.sample(jr.split(rngs, batch))        # (M, B, ...)

    sample_worker = None
    if problem.sample_worker is not None:
        def sample_worker(rngs, worker_ids):  # noqa: F811
            ids = worker_ids[:, None].expand(-1, batch)
            return problem.sample_worker(jr.split(rngs, batch), ids)

    def oracle(z, xis):
        m = z[0].shape[0]
        z_rep = tuple(v.repeat_interleave(batch, dim=0) for v in z)
        flat = _lead(xis, lambda v: v.reshape((m * batch,) + v.shape[2:]))
        gs = problem.oracle(z_rep, flat)
        return tuple(g.reshape((m, batch) + g.shape[1:]).mean(dim=1)
                     for g in gs)

    return dataclasses.replace(
        problem, sample=sample, oracle=oracle, sample_worker=sample_worker,
        name=f"{problem.name}@mb{batch}",
    )


def _select(pred: torch.Tensor, new, old):
    """Per-worker ``where(pred, new, old)`` over a nested state."""
    if isinstance(new, dict):
        return {k: _select(pred, new[k], old[k]) for k in new}
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(_select(pred, a, b) for a, b in zip(new, old)))
    if isinstance(new, (tuple, list)):
        return type(new)(_select(pred, a, b) for a, b in zip(new, old))
    if new is None:
        return None
    return torch.where(per_worker(pred, new), new, old)


# ---------------------------------------------------------------------------
# LocalWorker adapter — the zoo's door into the PS engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MinimaxWorker(LocalWorker):
    """Any :class:`MinimaxOptimizer` as a Parameter-Server LocalWorker.

    The sync payload is the current iterate ``z`` (periodic iterate
    averaging, weighted by ``opt.sync_weight``: uniform for the fixed-lr
    methods, 1/η for UMP and ASMP); the inner state (Adam's moments, UMP's
    accumulator) stays local across syncs. ``derive_rngs`` is the
    inherited pair split, so engine trajectories draw the JAX engine's
    keys.

    >>> from repro_torch.optim import ump
    >>> MinimaxWorker(ump(1.0, 2.0)).name
    'ump(g0=1.0,D=2.0,alpha=1.0)'
    """

    opt: MinimaxOptimizer

    @property
    def name(self) -> str:
        return self.opt.name

    def init(self, problem, rngs, worker_ids=None):
        if worker_ids is None:
            worker_ids = torch.arange(rngs.shape[0], dtype=torch.int32,
                                      device=rngs.device)
        return self.opt.init(problem, rngs)._replace(worker_id=worker_ids)

    def step(self, problem, state, rngs, *, enabled=None):
        new = self.opt.step(problem, state, rngs)
        if enabled is None:
            return new
        return _select(enabled, new, state)

    def sync_weight(self, state):
        return self.opt.sync_weight(state)

    def sync_payload(self, state):
        return state.z

    def merge_synced(self, state, payload):
        return state._replace(z=payload)

    def output(self, state):
        return state.z_bar


# ---------------------------------------------------------------------------
# Execution: one worker, and the fleet through the engine
# ---------------------------------------------------------------------------

def run_serial(
    opt: MinimaxOptimizer,
    problem: MinimaxProblem,
    steps: int,
    rng: torch.Tensor,
    record_every: int = 1,
):
    """Run ``steps`` optimizer steps of one worker from key ``rng`` (2,);
    return its final state (no worker axis) and ``z̄`` recorded every
    ``record_every`` steps, each leaf ``(steps // record_every, ...)``. The
    keys are ``lax.scan``'s in the JAX package: init from ``rng``, then
    ``split(split(rng)[1], chunks)`` per chunk and ``split(chunk_key,
    record_every)`` per step."""
    state = opt.init(problem, rng[None])
    chunks = steps // record_every
    history = []
    if chunks:
        for rng_c in jr.split(jr.split(rng)[1], chunks):
            for r in jr.split(rng_c, record_every):
                state = opt.step(problem, state, r[None])
            history.append(tuple(v[0] for v in state.z_bar))
        history = tuple(torch.stack(xs) for xs in zip(*history))
    else:
        history = tuple(v.new_zeros((0,) + v.shape[1:]) for v in state.z_bar)
    return _unstack(state), history


def _unstack(tree):
    """Drop the leading (one-worker) axis of every tensor of a state."""
    if isinstance(tree, dict):
        return {k: _unstack(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unstack(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unstack(v) for v in tree)
    return None if tree is None else tree[0]


def average_stacked(z: PyTree, weights: torch.Tensor) -> PyTree:
    """Weighted mean over the leading worker axis, broadcast back."""
    w = weights / torch.sum(weights).expand(weights.shape)

    def avg(leaf):
        mean = torch.sum(per_worker(w, leaf).to(leaf.dtype) * leaf, dim=0,
                         keepdim=True)
        return mean.expand(leaf.shape).contiguous()

    return tree_map(avg, z)


def run_local(
    opt: MinimaxOptimizer,
    problem: MinimaxProblem,
    *,
    num_workers: int,
    local_k: int,
    rounds: int,
    rng: torch.Tensor,
    device="cuda",
):
    """Local-update periodic-averaging loop (the Local* baseline family)
    as a thin wrapper over the Parameter-Server engine: each round averages
    the workers' iterates (weighted by ``opt.sync_weight``), then runs
    ``local_k`` local steps. Returns the final fleet state and the
    per-round global output history, each leaf ``(rounds, ...)``. For
    schedules, codecs, faults or checkpoints drive ``PSEngine`` with
    ``MinimaxWorker(opt)`` directly."""
    from ..ps.engine import PSConfig, PSEngine  # deferred: ps imports core

    engine = PSEngine(
        problem,
        PSConfig(num_workers=num_workers, rounds=rounds,
                 worker=MinimaxWorker(opt), local_k=local_k),
        rng=rng, device=device,
    )
    history = []
    for _ in range(rounds):
        engine.step_round()
        history.append(engine.z_bar())
    if history:
        history = tuple(torch.stack(xs) for xs in zip(*history))
    else:  # rounds=0: an empty history, as the JAX package returns
        history = tuple(v.new_zeros((0,) + v.shape) for v in engine.z_bar())
    return engine.state, history
