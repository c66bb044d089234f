"""Parameter-Server round engine, serial path (port of ``repro.ps.engine``).

The engine owns the round loop of the paper's Parameter-Server model:
a :class:`~repro_torch.core.worker.LocalWorker` does everything
optimizer-specific, a :class:`~repro_torch.ps.schedule.WorkerSchedule`
gives the per-round local step counts K_m^r, and a
:class:`~repro_torch.ps.trace.TraceRecorder` keeps per-round telemetry.

This slice ports the serial path with the identity codec, no faults and
full participation — Algorithm 1 as the paper runs it. Each round is the
Line 5–8 sync (reference tree math, or the fused merge kernel under
``codec_backend="fused"``) followed by K masked local steps of the whole
stacked fleet. Compression, faults, client sampling, hostile fleets, the
server optimizer, the sharded path and checkpoints raise
``NotImplementedError`` until their slice.

With the same seed the engine draws the same keys as the JAX package
(``derive_rngs`` → ``split(rng0, R)`` per round → ``split(rng_round, K·M)``
per step), so its trajectories can be held against the JAX engine's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .. import random as jr
from .._device import resolve_device
from ..core.adaseg import AdaSEGConfig, weighted_worker_average
from ..core.tree import per_worker, tree_map
from ..core.types import MinimaxProblem
from ..core.worker import AdaSEGWorker, LocalWorker
from ..obs import SpanTracer
from .compress import IdentityCompressor, SyncCompressor, dense_bytes
from .faults import FaultPolicy, NoFaults
from .schedule import UniformSchedule, WorkerSchedule
from .trace import RoundRecord, TraceRecorder

PyTree = Any


@dataclasses.dataclass(frozen=True)
class PSConfig:
    """Everything the Parameter-Server engine needs beyond the problem.

    The optimizer is ``adaseg=`` (an :class:`AdaSEGConfig`, wrapped into an
    :class:`AdaSEGWorker` with ``backend``) or ``worker=`` (any
    :class:`LocalWorker`, which then needs ``local_k=`` or ``schedule=``).
    The fields after ``codec_backend`` exist for the later slices and must
    stay None here.

    Examples
    --------
    >>> cfg = PSConfig(adaseg=AdaSEGConfig(g0=1.0, diameter=2.0, k=5),
    ...                num_workers=4, rounds=10, codec_backend="fused")
    >>> cfg.num_workers, cfg.codec_backend
    (4, 'fused')
    """

    num_workers: int
    rounds: int
    adaseg: AdaSEGConfig | None = None
    worker: LocalWorker | None = None
    local_k: int | None = None
    schedule: WorkerSchedule | None = None   # default: uniform K
    compressor: SyncCompressor | None = None  # default: identity
    faults: FaultPolicy | None = None        # default: no faults
    backend: str = "reference"               # AdaSEG step backend
    codec_backend: str = "reference"         # sync merge: reference | fused
    sampler: Any = None
    byzantine: Any = None
    aggregator: Any = None
    dp: Any = None
    server_opt: Any = None


_LATER = ("sampler", "byzantine", "aggregator", "dp", "server_opt")


def _resolve_worker(config: PSConfig) -> LocalWorker:
    if config.worker is not None and config.adaseg is not None:
        raise ValueError("give either adaseg= or worker=, not both")
    if config.worker is not None:
        if config.backend != "reference":
            raise ValueError(
                "backend= has no effect on an explicit worker=; set the "
                "backend on the worker itself (e.g. AdaSEGWorker(cfg, "
                "backend=...))"
            )
        return config.worker
    if config.adaseg is not None:
        return AdaSEGWorker(config.adaseg, backend=config.backend)
    raise ValueError("PSConfig needs adaseg= or worker=")


def _resolve_schedule(config: PSConfig) -> WorkerSchedule:
    if config.schedule is not None:
        return config.schedule
    if config.local_k is not None:
        return UniformSchedule(config.local_k)
    if config.adaseg is not None:
        return UniformSchedule(config.adaseg.k)
    raise ValueError(
        "a generic worker has no communication interval of its own — "
        "give PSConfig a schedule= or local_k="
    )


def _check_slice(config: PSConfig, compressor, faults) -> None:
    """Refuse the features this slice has not ported yet."""
    for name in _LATER:
        if getattr(config, name) is not None:
            raise NotImplementedError(
                f"PSConfig.{name} is ported in a later slice")
    if not compressor.is_identity:
        raise NotImplementedError(
            "sync compression is ported in a later slice")
    if not isinstance(faults, NoFaults):
        raise NotImplementedError("fault policies are ported in a later slice")
    if config.codec_backend not in ("reference", "fused"):
        raise ValueError(f"unknown codec backend {config.codec_backend!r}")


def make_sync_stacked(worker: LocalWorker, codec_backend: str = "reference"):
    """Line 5–8 on the stacked worker axis with the identity codec and every
    worker up: w = sync_weight / Σ sync_weight, the server sums w·payload
    and every worker receives the sum. Returns ``sync(state) -> state``.

    ``codec_backend="fused"`` normalises ``w`` here and runs the merge
    kernel without ``normalize`` — one read and one write of the fleet
    payload per leaf instead of the scale, sum and broadcast passes."""
    if codec_backend == "fused":
        from ..kernels.sync_compress.ops import sync_merge_stacked

        def sync_stacked_fused(state):
            sw = worker.sync_weight(state)                    # (M,)
            w = sw / torch.sum(sw)
            synced = sync_merge_stacked(worker.sync_payload(state), w)
            return worker.merge_synced(state, synced)

        return sync_stacked_fused

    def sync_stacked(state):
        sw = worker.sync_weight(state)                        # (M,)
        w = sw / torch.sum(sw)
        messages = tree_map(
            lambda leaf: per_worker(w, leaf).to(leaf.dtype) * leaf,
            worker.sync_payload(state),
        )
        synced = tree_map(
            lambda s: torch.sum(s, dim=0, keepdim=True).expand(s.shape)
            .contiguous(),
            messages,
        )
        return worker.merge_synced(state, synced)

    return sync_stacked


def make_serial_chunk(
    problem: MinimaxProblem,
    worker: LocalWorker,
    num_workers: int,
    k_pad: int,
    eval_fn,
    codec_backend: str = "reference",
    device="cuda",
):
    """Build the serial-path round chunk: for each round, sync then K_m^r
    masked local steps (a Python loop where the JAX package scans).

    The chunk is ``chunk(state, round_rngs, ks, counts_cum) -> (state,
    eta_stats, ress)``: ``round_rngs`` ``(C, 2)``, ``ks`` and
    ``counts_cum`` ``(C, M)`` host tables; ``eta_stats`` is ``(C, 3)``
    per-round ``[min, max, mean]`` of η over the fleet and ``ress`` ``(C,)``
    the residual of the running Line-14 output (NaN without ``eval_fn``),
    both left on the device so a chunk transfers O(rounds) values once."""
    m = num_workers
    dev = torch.device(device)
    sync_stacked = make_sync_stacked(worker, codec_backend)

    def round_body(state, rng_round, ks_r, counts_r):
        state = sync_stacked(state)
        # Line 3–4: K_m^r masked local steps (no mask when all run).
        step_rngs = jr.split(rng_round, k_pad * m).reshape(k_pad, m, 2)
        for i in range(k_pad):
            run = ks_r > i
            enabled = None if run.all() else torch.as_tensor(run, device=dev)
            state = worker.step(problem, state, step_rngs[i], enabled=enabled)

        eta_end = worker.eta(state)                           # (M,)
        eta_stats = torch.stack([eta_end.min(), eta_end.max(),
                                 eta_end.mean()])
        if eval_fn is None:
            res = torch.tensor(float("nan"), device=dev)
        else:
            counts = counts_r if counts_r.sum() > 0 else np.ones_like(counts_r)
            res = eval_fn(weighted_worker_average(
                worker.output(state), torch.as_tensor(counts, device=dev)))
        return state, eta_stats, res.to(torch.float32)

    def chunk(state, round_rngs, ks, counts_cum):
        etas, ress = [], []
        for c in range(round_rngs.shape[0]):
            state, eta_stats, res = round_body(state, round_rngs[c], ks[c],
                                               counts_cum[c])
            etas.append(eta_stats)
            ress.append(res)
        return state, torch.stack(etas), torch.stack(ress)

    return chunk


class PSEngine:
    """Parameter-Server runtime, serial path, generic over LocalWorker.

    Examples
    --------
    Two workers, two rounds of K=2 local steps on the bilinear game:

    >>> from repro_torch import random as jr
    >>> from repro_torch.problems import make_bilinear_game
    >>> game = make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=4,
    ...                           sigma=0.1, device="cpu")
    >>> cfg = PSConfig(adaseg=AdaSEGConfig(g0=1.0, diameter=2.0, k=2),
    ...                num_workers=2, rounds=2)
    >>> eng = PSEngine(game.problem, cfg, rng=jr.PRNGKey(1, device="cpu"),
    ...                eval_fn=game.residual, device="cpu")
    >>> zbar = eng.run()                  # z̄ = (x̄, ȳ), Line 14
    >>> [tuple(v.shape) for v in zbar], eng.round
    ([(4,), (4,)], 2)
    >>> len(eng.trace.rounds), eng.trace.rounds[-1].residual is not None
    (2, True)
    """

    def __init__(
        self,
        problem: MinimaxProblem,
        config: PSConfig,
        rng: torch.Tensor,
        *,
        mesh=None,
        eval_fn: Callable | None = None,
        tracer: SpanTracer | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "the sharded path (mesh=) is ported in a later slice")
        self.problem = problem
        self.config = config
        self.tracer = tracer if tracer is not None else SpanTracer()
        self.worker = _resolve_worker(config)
        self.schedule = _resolve_schedule(config)
        self.compressor = config.compressor or IdentityCompressor()
        self.faults = config.faults or NoFaults()
        _check_slice(config, self.compressor, self.faults)
        self.codec_backend = config.codec_backend
        self.eval_fn = eval_fn

        m, r = config.num_workers, config.rounds
        # Deterministic policy tables, re-derived from the config.
        self._ks = np.asarray(self.schedule.steps(m, r), dtype=np.int32)
        self._alive = np.asarray(self.faults.alive(m, r), dtype=bool)
        if self._ks.shape != (r, m) or self._alive.shape != (r, m):
            raise ValueError("schedule/fault table shape mismatch")
        self._k_pad = int(self.schedule.max_steps(m))
        if not (self._ks <= self._k_pad).all():
            raise ValueError(
                f"schedule emits step counts above its max_steps={self._k_pad}"
            )
        self._eff_steps = np.where(self._alive, self._ks, 0)  # (R, M)
        self._counts_cum = np.cumsum(
            self._eff_steps, axis=0
        ).astype(np.float32)

        # RNG derivation — the JAX engine's, key for key.
        rng0, worker_rngs = self.worker.derive_rngs(rng.to(self.device), m)
        self._rng0 = rng0
        self._round_rngs = jr.split(rng0, r)                  # (R, 2)
        self._state: PyTree = self.worker.init(
            problem, worker_rngs,
            torch.arange(m, dtype=torch.int32, device=self.device))
        self.round = 0

        z_like = tuple(v[0] for v in self.worker.sync_payload(self._state))
        self._msg_bytes = self.compressor.message_bytes(z_like)
        self._dense_bytes = dense_bytes(z_like)
        self.trace = TraceRecorder(meta={
            "problem": problem.name,
            "optimizer": self.worker.name,
            "workers": m,
            "rounds": r,
            "schedule": type(self.schedule).__name__,
            "compressor": self.compressor.name,
            "faults": type(self.faults).__name__,
            "backend": getattr(self.worker, "backend", None),
            "codec_backend": self.codec_backend,
            "execution": "serial",
        })
        self._chunk_fn = make_serial_chunk(
            problem, self.worker, m, self._k_pad, eval_fn,
            self.codec_backend, self.device,
        )

    # ------------------------------------------------------------------
    # Driving, output, telemetry
    # ------------------------------------------------------------------

    def _run_chunk(self, r0: int, r1: int) -> None:
        sl = slice(r0, r1)
        with self.tracer.span(f"chunk [{r0},{r1})", cat="chunk",
                              rounds=r1 - r0) as chunk_sp:
            state, etas, ress = self._chunk_fn(
                self._state, self._round_rngs[sl], self._ks[sl],
                self._counts_cum[sl])
            # The host copies wait for the device, so the span times the
            # chunk's device work too.
            stats = etas.cpu().numpy()                        # (C, 3)
            ress = ress.cpu().numpy()
        self._state = state
        self.round = r1

        # The chunk's wall-clock, attributed uniformly across its rounds.
        per_round_wall = chunk_sp.wall_dur / max(r1 - r0, 1)
        for i, r in enumerate(range(r0, r1)):
            alive = self._alive[r]
            steps_row = self._eff_steps[r]
            n_alive = int(alive.sum())
            eff = int(steps_row.sum())
            res = float(ress[i])
            rec = RoundRecord(
                round=r,
                local_steps=steps_row.tolist(),
                alive=alive.tolist(),
                bytes_up=n_alive * self._msg_bytes,
                bytes_down=n_alive * self._dense_bytes,
                eta_min=float(stats[i, 0]),
                eta_max=float(stats[i, 1]),
                eta_mean=float(stats[i, 2]),
                residual=None if np.isnan(res) else res,
                wall_time_s=per_round_wall,
                steps_per_sec=eff / per_round_wall if per_round_wall > 0
                else None,
            )
            self.trace.record(rec)
            if self.tracer.enabled:
                self.tracer.add_span(
                    f"round {r}", cat="round", parent=chunk_sp.id,
                    wall_t0=chunk_sp.wall_t0 + i * per_round_wall,
                    wall_t1=chunk_sp.wall_t0 + (i + 1) * per_round_wall,
                    **vars(rec),
                )

    def run(self, *, until_round: int | None = None) -> PyTree:
        """Advance to ``until_round`` (default: all rounds) and return the
        global output iterate z̄ (Line 14)."""
        target = self.config.rounds if until_round is None else int(until_round)
        target = min(target, self.config.rounds)
        with self.tracer.span(f"run [{self.round},{target})", cat="run",
                              engine="sync"):
            if self.round < target:
                self._run_chunk(self.round, target)
        return self.z_bar()

    def step_round(self) -> None:
        """Advance exactly one round."""
        if self.round >= self.config.rounds:
            raise ValueError("engine already ran all configured rounds")
        self._run_chunk(self.round, self.round + 1)

    @property
    def state(self) -> PyTree:
        return self._state

    def z_bar(self) -> PyTree:
        """Global output iterate: worker outputs weighted by realized step
        counts — the same expression as the serial driver's Line 14."""
        counts = self._eff_steps[:max(self.round, 1)].sum(axis=0)
        counts = counts.astype(np.float32)
        if counts.sum() == 0.0:
            counts = np.ones_like(counts)
        return weighted_worker_average(
            self.worker.output(self._state),
            torch.as_tensor(counts, device=self.device),
        )
