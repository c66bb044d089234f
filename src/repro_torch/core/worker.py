"""The LocalWorker protocol (port of ``repro.core.worker``).

The Parameter-Server engine owns rounds, schedules and telemetry; a
:class:`LocalWorker` owns everything optimizer-specific inside a round.
In the port the state a worker object handles is the whole fleet (every
field with a leading worker axis), so the hooks return per-worker ``(M,)``
values where the JAX protocol returns scalars:

* ``init(problem, rngs, worker_ids)`` — the fleet's initial state from
  ``(M, 2)`` keys;
* ``step(problem, state, rngs, enabled=...)`` — one local step of every
  worker; ``enabled`` (``(M,)`` bool or None) masks the update;
* ``sync_weight(state)`` — ``(M,)`` Line-7 weights (1/η for AdaSEG);
* ``sync_payload(state)`` / ``merge_synced(state, payload)`` — the part of
  the state the server averages, and how the average is installed;
* ``output(state)`` — the per-worker output iterate;
* ``eta(state)`` — ``(M,)`` step sizes, telemetry only;
* ``derive_rngs(rng, num_workers)`` — how the top-level key splits into
  (round-stream base, per-worker init keys).

``fingerprint`` hashes ``name`` (which encodes the hyper-parameters).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any

from .. import random as jr
from .adaseg import AdaSEGConfig, eta_of, init as adaseg_init, local_step
from .types import MinimaxProblem

PyTree = Any


class LocalWorker:
    """Base protocol; subclasses fill in the optimizer-specific pieces.

    Examples
    --------
    >>> import torch
    >>> from repro_torch import random as jr
    >>> from repro_torch.problems import make_bilinear_game
    >>> game = make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=4,
    ...                           sigma=0.1, device="cpu")
    >>> worker = AdaSEGWorker(AdaSEGConfig(g0=1.0, diameter=2.0, k=2))
    >>> st = worker.init(game.problem, jr.split(jr.PRNGKey(1, device="cpu"), 2))
    >>> st2 = worker.step(game.problem, st,
    ...                   jr.split(jr.PRNGKey(2, device="cpu"), 2))
    >>> st2.t.tolist(), bool((worker.sync_weight(st) > 0).all())
    ([1, 1], True)
    >>> frozen = worker.step(game.problem, st,
    ...                      jr.split(jr.PRNGKey(2, device="cpu"), 2),
    ...                      enabled=torch.tensor([False, True]))
    >>> frozen.t.tolist()
    [0, 1]
    """

    name: str = "worker"

    def init(self, problem: MinimaxProblem, rngs, worker_ids=None) -> PyTree:
        raise NotImplementedError

    def step(self, problem: MinimaxProblem, state: PyTree, rngs, *,
             enabled=None) -> PyTree:
        raise NotImplementedError

    def sync_weight(self, state: PyTree):
        raise NotImplementedError

    def sync_payload(self, state: PyTree) -> PyTree:
        raise NotImplementedError

    def merge_synced(self, state: PyTree, payload: PyTree) -> PyTree:
        raise NotImplementedError

    def output(self, state: PyTree) -> PyTree:
        raise NotImplementedError

    def eta(self, state: PyTree):
        raise NotImplementedError

    def derive_rngs(self, rng, num_workers: int):
        raise NotImplementedError

    @property
    def fingerprint(self) -> int:
        """uint32 identity hash of the optimizer and its hyper-parameters."""
        return zlib.crc32(self.name.encode())


@dataclasses.dataclass(frozen=True)
class AdaSEGWorker(LocalWorker):
    """LocalAdaSEG as a LocalWorker — the paper's Algorithm 1: the same
    ``local_step`` (with its ``"reference" | "fused"`` backend), 1/η sync
    weights, the anchor z̃ as sync payload, and ``run_local_adaseg``'s key
    derivation ``split(rng, M+1)``.

    Examples
    --------
    >>> w = AdaSEGWorker(AdaSEGConfig(g0=1.0, diameter=2.0, k=3),
    ...                  backend="fused")
    >>> w.name
    'adaseg(g0=1.0,D=2.0,alpha=1.0,avg=True)'
    """

    cfg: AdaSEGConfig
    backend: str = "reference"

    @property
    def name(self) -> str:
        c = self.cfg
        return (f"adaseg(g0={c.g0},D={c.diameter},alpha={c.alpha},"
                f"avg={c.average_output})")

    def init(self, problem, rngs, worker_ids=None):
        return adaseg_init(problem, self.cfg, rngs, worker_ids)

    def step(self, problem, state, rngs, *, enabled=None):
        new, _ = local_step(problem, self.cfg, state, rngs, enabled=enabled,
                            backend=self.backend)
        return new

    def sync_weight(self, state):
        return 1.0 / eta_of(self.cfg, state.sum_sq)

    def eta(self, state):
        return eta_of(self.cfg, state.sum_sq)

    def sync_payload(self, state):
        return state.z_tilde

    def merge_synced(self, state, payload):
        return state._replace(z_tilde=payload)

    def output(self, state):
        return state.z_bar

    def derive_rngs(self, rng, num_workers: int):
        init_rngs = jr.split(rng, num_workers + 1)
        return init_rngs[0], init_rngs[1:]
