"""Event-driven asynchronous Parameter-Server over simulated time (port of
``repro.ps.async_engine``).

The synchronous :class:`~repro_torch.ps.engine.PSEngine` counts rounds:
every worker blocks on one barrier per round however fast it ran.
:class:`AsyncPSEngine` adds the time axis. It is a discrete-event
simulator of the same fleet: a :class:`~repro_torch.ps.latency.LatencyModel`
gives every worker-round its compute and network delays, an event machine
advances a simulated clock, and the server admits each worker's uplink as
it arrives, under a bounded-staleness rule:

* every worker cycles through ``send payload → receive broadcast → run its
  K_m^r local steps`` at its own speed (Lines 3–8 of Algorithm 1, unrolled
  per worker instead of per barrier);
* the server keeps the last heard payload and 1/η sync weight of every
  worker; each admission recomputes the Line-7 average over the whole
  table with the staleness weights ``w_m ∝ sw_m / (1 + s_m)^γ`` (``s_m``:
  how many rounds worker ``m``'s stored payload is behind the freshest)
  and broadcasts it to the admitted workers only;
* a round-``r`` uplink is admitted once every live worker's round-
  ``(r − τ)`` uplink has landed (τ = ``staleness_bound``). ``τ=∞`` never
  blocks; ``τ=0`` is a barrier.

The numerics are plain functions on the stacked fleet, where the JAX
package jits them:

* a local phase is the worker's own ``step`` on the whole stacked state
  with a multi-hot ``enabled`` mask. Lanes are independent, so a batch of
  phases equals the same phases run one at a time, bit for bit; a batch
  of several rounds takes each worker's key column from its own round's
  ``(k_pad, M, 2)`` key table;
* an admission that is the whole fleet in one round (lockstep) runs the
  synchronous engine's own round chunk (``engine.make_serial_chunk``), so
  τ=0, and any worker-equal latency, reproduce ``PSEngine`` bit for bit by
  shared code, robust fleets and outer optimizers included;
* other admissions store the senders' raw payloads (compressed by
  ``codec_uplink_stacked``, or corrupted and privatised first on a hostile
  fleet) and apply the Line-7 weights server-side: in plain PyTorch for the
  mean, through ``sync_merge_stacked(agg=...)`` on a robust fleet, then
  ``server_outer_apply`` under an outer optimizer. Under
  ``codec_backend="fused"`` these run the sync kernels on a CUDA tensor.

The event machine is host numpy in float64, with the JAX engine's order:
at one simulated instant STARTs (phase or reboot ends) are handled before
ARRIVEs (uplink landings), and an admission batch is taken in ascending
worker id. Every host-side record (simulated times, staleness, aliveness,
local steps, bytes, idle fractions, the admission count) therefore equals
the JAX engine's exactly, whatever the f32 numerics do.

Under a :class:`~repro_torch.ps.sampler.ClientSampler` a worker takes
part only in the rounds it is drawn for: entering an undrawn round costs
no simulated time and makes no event, and its progress moves through the
skip so that the staleness gate never waits on it. Phases still run on
the whole stacked fleet, masked, and a sampled run never takes the
lockstep chunk.

The outer optimizer's anchor starts at the clean sync's own merge of the
initial payloads (``engine._initial_anchor``, ROADMAP C6(b)), as the
port's ``PSEngine`` does, so that τ=0 stays bit-identical to it.

Checkpoints (:meth:`AsyncPSEngine.save`) hold the dynamic state only: the
stacked fleet, the server table, the per-worker event-machine arrays and
the clock, in the JAX package's layout (float64 event times as raw bytes),
so a checkpoint written by either package restores into the other.
Schedules, faults, latency tables and key streams are re-derived from the
config, and a run killed mid-event-queue resumes bit for bit.

One timeline nuance, as in the JAX engine: a lockstep admission runs the
chunk's local steps at once, so those workers' states may be one phase
ahead of the clock until their START events fire.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from .. import random as jr
from .._device import resolve_device
from ..checkpoint.serialize import load_pytree, save_pytree
from ..core.adaseg import weighted_worker_average
from ..core.tree import per_worker, tree_map, tree_zeros_like
from ..core.types import MinimaxProblem
from ..obs import MetricsRegistry, SpanTracer, modeled_sync_cost
from .compress import IdentityCompressor, check_codec_backend, dense_bytes
from .engine import (
    PSConfig,
    _initial_anchor,
    _resolve_schedule,
    _resolve_worker,
    make_serial_chunk,
    resolve_robust,
)
from .faults import NoFaults
from .latency import ConstantLatency, LatencyModel
from .robust import WeightedMean
from .server_opt import NoServerOpt, resolve_server_opt
from .trace import RoundRecord, TraceRecorder

PyTree = Any

# Worker event-machine status codes (stored in checkpoints). The per-worker
# arrays (_status, _ev_time, _ev_round, ...) are the event queue: each
# worker has at most one pending event, so the next instant is a min over
# _ev_time of the workers with a pending event, and every event at that
# instant is handled in one sweep.
_UPLINK = 0    # uplink in flight: an ARRIVE event is pending
_COMPUTE = 1   # computing or rebooting: a START event is pending
_HELD = 2      # arrived, held at the server by the staleness bound
_DONE = 3      # all rounds finished


@dataclasses.dataclass(frozen=True)
class AsyncPSConfig(PSConfig):
    """:class:`PSConfig` plus the async policy.

    ``latency`` gives the per-(round, worker) compute and network delays
    (default: zero-delay lockstep). ``staleness_bound`` is τ: a round-``r``
    uplink is held until every live worker's round-``(r − τ)`` uplink has
    arrived; ``math.inf`` never waits, ``0`` is a barrier.
    ``staleness_discount`` is the γ of the server's weights
    ``w ∝ sw/(1+s)^γ`` (``0`` turns the discount off).

    Examples
    --------
    >>> from repro_torch.core import AdaSEGConfig
    >>> cfg = AsyncPSConfig(adaseg=AdaSEGConfig(g0=1.0, diameter=2.0, k=2),
    ...                     num_workers=2, rounds=3, staleness_bound=1.0)
    >>> cfg.staleness_bound, cfg.staleness_discount, cfg.latency is None
    (1.0, 1.0, True)
    """

    latency: LatencyModel | None = None
    staleness_bound: float = math.inf
    staleness_discount: float = 1.0


class AsyncPSEngine:
    """Discrete-event asynchronous Parameter-Server runtime (serial path).

    Examples
    --------
    A 2-worker fleet with a 3× straggler under τ=1 finishes on the
    simulated clock with a record per admission:

    >>> from repro_torch import random as jr
    >>> from repro_torch.core import AdaSEGConfig
    >>> from repro_torch.problems import make_bilinear_game
    >>> from repro_torch.ps import ConstantLatency
    >>> game = make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=4,
    ...                           sigma=0.1, device="cpu")
    >>> acfg = AsyncPSConfig(adaseg=AdaSEGConfig(g0=1.0, diameter=2.0, k=2),
    ...                      num_workers=2, rounds=2,
    ...                      latency=ConstantLatency(step_s=(1.0, 3.0),
    ...                                              up_s=0.1, down_s=0.1),
    ...                      staleness_bound=1.0)
    >>> eng = AsyncPSEngine(game.problem, acfg,
    ...                     rng=jr.PRNGKey(1, device="cpu"), device="cpu")
    >>> zbar = eng.run()
    >>> eng.done, eng.sim_time > 0.0, eng.n_admissions
    (True, True, 3)
    >>> [[m for m, a in enumerate(r.alive) if a] for r in eng.trace.rounds]
    [[0, 1], [0], [1], []]
    >>> round(eng.sim_time, 6)
    12.4
    """

    def __init__(
        self,
        problem: MinimaxProblem,
        config: AsyncPSConfig,
        rng: torch.Tensor,
        *,
        eval_fn: Callable | None = None,
        trace_meta: dict | None = None,
        tracer: SpanTracer | None = None,
        metrics: MetricsRegistry | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if config.staleness_bound < 0:
            raise ValueError("staleness_bound must be >= 0")
        # Spans carry the simulated clock beside host wall time; they and
        # the metrics are recorded on the host from values already there,
        # so they cannot change a result.
        self.tracer = tracer if tracer is not None else SpanTracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.problem = problem
        self.config = config
        self.worker = _resolve_worker(config)
        self.schedule = _resolve_schedule(config)
        self.compressor = config.compressor or IdentityCompressor()
        self.faults = config.faults or NoFaults()
        check_codec_backend(config.codec_backend, self.compressor)
        self.codec_backend = config.codec_backend
        self._use_kernel = config.codec_backend == "fused"
        self.latency = config.latency or ConstantLatency()
        self.eval_fn = eval_fn
        self.tau = float(config.staleness_bound)
        self.gamma = float(config.staleness_discount)

        m, r = config.num_workers, config.rounds
        # Deterministic policy tables, re-derived (never stored) on resume.
        self._ks = np.asarray(self.schedule.steps(m, r), dtype=np.int32)
        self._alive = np.asarray(self.faults.alive(m, r), dtype=bool)
        if self._ks.shape != (r, m) or self._alive.shape != (r, m):
            raise ValueError("schedule/fault table shape mismatch")
        self._k_pad = int(self.schedule.max_steps(m))
        if not (self._ks <= self._k_pad).all():
            raise ValueError(
                f"schedule emits step counts above its max_steps={self._k_pad}"
            )
        lat = self.latency.tables(m, r)
        if lat.step_s.shape != (r, m):
            raise ValueError(
                f"latency tables have shape {lat.step_s.shape}, "
                f"engine needs ({r}, {m})"
            )
        self._lat = lat
        # Sampled-client rounds: an (R, M) participation table. A round the
        # worker is not drawn for is skipped at zero simulated cost (no
        # send, receive, steps or reboot), its progress advanced through
        # the skip so the staleness gate never waits on it.
        self.sampler = config.sampler
        self._sampled = (None if self.sampler is None
                         else self.sampler.participation(m, r))
        # Hostile fleet: attacks corrupt uplinks when they are stored (per
        # the sender's own round); the robust merge runs at admission over
        # the whole last-heard table, so it is resolved at the fleet width.
        self.aggregator = config.aggregator or WeightedMean()
        self.byzantine = config.byzantine
        self.dp = config.dp
        self._robust = resolve_robust(config, m)
        # Outer optimizer: one outer step per admission, Δ the change of
        # the staleness-weighted table average since the previous one.
        self.server_opt = config.server_opt or NoServerOpt()
        self._server = resolve_server_opt(config)
        if self.byzantine is not None:
            self._byz = np.asarray(self.byzantine.attacked(m, r), dtype=bool)
            if self._byz.shape != (r, m):
                raise ValueError("byzantine table shape mismatch")
        else:
            self._byz = np.zeros((r, m), dtype=bool)

        # Key derivation: PSEngine's, so a worker in round r consumes the
        # keys the synchronous chunk would give its lane.
        dev = self.device
        rng0, worker_rngs = self.worker.derive_rngs(rng.to(dev), m)
        self._rng0 = rng0
        self._round_rngs = jr.split(rng0, r)                  # (R, 2)
        self._state: PyTree = self.worker.init(
            problem, worker_rngs, torch.arange(m, dtype=torch.int32,
                                               device=dev))
        payload = self.worker.sync_payload(self._state)
        self._ef: PyTree = (tree_zeros_like(payload)
                            if self.compressor.error_feedback else ())

        # Server memory: the last heard payload and weight of every worker.
        self._srv_payload: PyTree = tree_zeros_like(payload)
        self._srv_sw = torch.zeros(m, dtype=torch.float32, device=dev)
        self._srv_version = np.full((m,), -1, np.int32)
        self._heard = np.zeros((m,), bool)
        if self._server is not None:
            z0 = _initial_anchor(self.worker, self._state, self.codec_backend)
            self._srv = (z0, self._server.init_moments(z0),
                         torch.zeros((), dtype=torch.int32, device=dev))
        else:
            self._srv = None

        # Per-worker event machine (one outstanding event per worker).
        self._status = np.full((m,), _COMPUTE, np.int32)
        self._ev_time = np.zeros((m,), np.float64)
        self._ev_round = np.zeros((m,), np.int32)
        self._ev_busy = np.zeros((m,), np.float64)
        self._ev_is_phase = np.zeros((m,), bool)
        # The highest round whose uplink has arrived, per worker (-1 before
        # the first lands): the staleness gate reads this.
        self._progress = np.full((m,), -1, np.int32)
        self._arrive_t = np.zeros((m,), np.float64)   # span layer only
        self._busy_s = np.zeros((m,), np.float64)
        self._steps_cum = np.zeros((m,), np.int32)
        # Steps already attributed to a trace record: each admission records
        # the previous phase's steps, the terminal record the remainder.
        self._steps_recorded = np.zeros((m,), np.int32)
        self._done_at = np.zeros((m,), np.float64)
        self.now = 0.0
        self.n_admissions = 0
        self._final_recorded = False

        z_like = tuple(v[0] for v in payload)
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
            "latency": type(self.latency).__name__,
            "staleness_bound": (None if math.isinf(self.tau) else self.tau),
            "staleness_discount": self.gamma,
            "backend": getattr(self.worker, "backend", None),
            "codec_backend": self.codec_backend,
            "execution": "event-driven",
            **({"sampler": self.sampler.name,
                "sample": self.sampler.sample}
               if self.sampler is not None else {}),
            **({"byzantine": self.byzantine.name}
               if self.byzantine is not None else {}),
            **({"server_opt": self.server_opt.name}
               if self._server is not None else {}),
            **({"aggregator": self.aggregator.name,
                "dp": None if self.dp is None else self.dp.name}
               if self._robust is not None else {}),
            **(trace_meta or {}),
        })

        self._rng_cache: dict[int, torch.Tensor] = {}
        self._c_rng_cache: dict[int, torch.Tensor] = {}
        # A lockstep admission (the whole fleet, one round) runs the
        # synchronous engine's round chunk; only the identity, fault-free,
        # unsampled configuration can take it (a faulty PSEngine masks its
        # sync, async compression is per payload, and a sampled PSEngine
        # runs another chunk).
        self._lockstep_ok = (isinstance(self.faults, NoFaults)
                             and self.compressor.is_identity
                             and self.sampler is None)
        self._lockstep_chunk = (
            make_serial_chunk(problem, self.worker, self.compressor, m,
                              self._k_pad, None, no_faults=True,
                              codec_backend=self.codec_backend, device=dev,
                              robust=self._robust, server=self._server)
            if self._lockstep_ok else None)
        for w in range(m):
            self._enter_round(w, 0, 0.0)

    # ------------------------------------------------------------------
    # Key streams
    # ------------------------------------------------------------------

    def _step_rngs(self, r: int) -> torch.Tensor:
        """(k_pad, M, 2) step keys of round ``r``: the synchronous chunk's
        ``split(rng_round, k_pad·M)``."""
        if r not in self._rng_cache:
            m = self.config.num_workers
            self._rng_cache[r] = jr.split(
                self._round_rngs[r], self._k_pad * m).reshape(
                    self._k_pad, m, 2)
        return self._rng_cache[r]

    def _c_rngs(self, r: int) -> torch.Tensor:
        """(M, 2) codec keys of round ``r``: ``split(fold_in(rng_round, 7),
        M)``."""
        if r not in self._c_rng_cache:
            self._c_rng_cache[r] = jr.split(
                jr.fold_in(self._round_rngs[r], 7), self.config.num_workers)
        return self._c_rng_cache[r]

    def _spliced_c_rngs(self, rounds_of: dict) -> torch.Tensor:
        """Each admitted worker's codec key from its own round's table
        (round 0's elsewhere)."""
        keys = self._c_rngs(0).clone()
        by_round: dict[int, list[int]] = {}
        for m, r in rounds_of.items():
            by_round.setdefault(r, []).append(m)
        for r, ms in by_round.items():
            if r:
                idx = torch.as_tensor(ms, device=keys.device)
                keys[idx] = self._c_rngs(r)[idx]
        return keys

    # ------------------------------------------------------------------
    # Numerics on the stacked fleet
    # ------------------------------------------------------------------

    def _mask(self, mask: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(mask, device=self.device)

    def _store(self, mask, byz_mask, rounds_of) -> None:
        """Admit uplinks: overwrite the masked lanes of the server table
        with the senders' current payloads (corrupted, privatised and
        compressed on their way), and their sync weights. A held sender's
        lane has not changed since it sent, so reading it now is exact."""
        comp = self.compressor
        state = self._state
        mask_t = self._mask(mask)
        uplink = self.worker.sync_payload(state)
        if self._robust is None and comp.is_identity:
            sent = uplink
        else:
            # attack, DP and codec keys derive from the sender's own round
            c_rngs = self._spliced_c_rngs(rounds_of)
            robust = self._robust
            if robust is not None and robust.byzantine is not None:
                uplink = robust.byzantine.apply(
                    uplink, self._mask(byz_mask), jr.fold_in(c_rngs, 13))
            if robust is not None and robust.dp is not None:
                uplink = robust.dp.apply(uplink, jr.fold_in(c_rngs, 11))
            if comp.is_identity:
                sent = uplink
            else:
                from ..kernels.sync_compress.ops import codec_uplink_stacked

                # the admission mask plays the aliveness role: the others
                # keep their residual
                has_ef = comp.error_feedback
                sent, ef_out = codec_uplink_stacked(
                    uplink, c_rngs, ef=self._ef if has_ef else None,
                    alive=mask_t, codec=comp.codec_spec,
                    use_kernel=self._use_kernel)
                if has_ef:
                    self._ef = ef_out
        self._srv_payload = tree_map(
            lambda s, old: torch.where(per_worker(mask_t, s), s, old),
            sent, self._srv_payload)
        self._srv_sw = torch.where(mask_t, self.worker.sync_weight(state),
                                   self._srv_sw)

    def _outer_broadcast(self, merged, recv, payload):
        """Row 0 of the ungated merge → outer step → recv-gated delivery;
        returns the telemetry ``[eff_lr, ‖Δ‖]``."""
        from ..kernels.sync_compress.ops import server_outer_apply

        z, mom, t = self._srv
        z_new, mom_new, t_new, eff_lr, dn = server_outer_apply(
            tuple(v[:1] for v in merged), z, mom, t,
            spec=self._server.spec, use_kernel=self._use_kernel)
        synced = tuple(torch.where(per_worker(recv, old), v, old)
                       for v, old in zip(z_new, payload))
        self._state = self.worker.merge_synced(self._state, synced)
        self._srv = (z_new, mom_new, t_new)
        return torch.stack([eff_lr, dn])

    def _admit(self, discount: np.ndarray, recv: np.ndarray):
        """Lines 5–8 for one admission: the staleness-weighted average of
        the whole last-heard table, delivered to the admitted workers only
        (``recv``). Returns the outer step's telemetry, or None."""
        recv_t = self._mask(recv)
        sw_eff = self._srv_sw * torch.as_tensor(discount, device=self.device)
        w_raw = torch.where(self._mask(self._heard), sw_eff,
                            torch.zeros_like(sw_eff))
        payload = self.worker.sync_payload(self._state)
        table = self._srv_payload
        if self._robust is not None:
            # the table rows are unweighted uplinks: the robust merge and
            # its renormalisation over the heard lanes run server-side
            from ..kernels.sync_compress.ops import sync_merge_stacked

            if self._server is not None:
                merged = sync_merge_stacked(
                    table, w_raw, normalize=True, agg=self._robust.agg,
                    use_kernel=self._use_kernel)
                return self._outer_broadcast(merged, recv_t, payload)
            synced = sync_merge_stacked(
                table, w_raw, recv_t, payload, normalize=True,
                agg=self._robust.agg, use_kernel=self._use_kernel)
            self._state = self.worker.merge_synced(self._state, synced)
            return None
        # a full-shape divisor: PyTorch on the CPU divides by a 0-d tensor
        # as a multiplication by its reciprocal (ROADMAP C7)
        w = w_raw / torch.sum(w_raw).expand(w_raw.shape)
        msg = tree_map(lambda leaf: per_worker(w, leaf).to(leaf.dtype) * leaf,
                       table)
        merged = tree_map(lambda s: torch.sum(s, dim=0, keepdim=True), msg)
        if self._server is not None:
            return self._outer_broadcast(merged, recv_t, payload)
        synced = tuple(torch.where(per_worker(recv_t, old), s, old)
                       for s, old in zip(merged, payload))
        self._state = self.worker.merge_synced(self._state, synced)
        return None

    def _lockstep(self, r0: int):
        """The whole fleet admitted in round ``r0`` at zero staleness: the
        synchronous engine's round chunk (the sync and all the round's
        local steps). Returns the outer step's telemetry, or None."""
        counts = (self._steps_cum + self._ks[r0] * self._alive[r0]).astype(
            np.float32)
        state, self._ef, _, _, srv, outer = self._lockstep_chunk(
            self._take_state(), self._ef, self._round_rngs[r0:r0 + 1],
            self._ks[r0:r0 + 1], self._alive[r0:r0 + 1], counts[None],
            byz=self._byz[r0:r0 + 1] if self._robust is not None else None,
            srv=self._srv)
        self._state, self._srv = state, srv
        return None if outer is None else outer[0]

    def _take_state(self) -> PyTree:
        """Hand the fleet state to the chunk, which then holds its only
        reference."""
        state, self._state = self._state, None
        return state

    def _sync_device(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # Event machine
    # ------------------------------------------------------------------

    def _enter_round(self, m: int, r: int, t: float) -> None:
        """Worker ``m`` enters round ``r`` at simulated time ``t``: send the
        uplink (alive), burn a reboot (dead), skip (not drawn), or finish
        (r == rounds)."""
        if self._sampled is not None:
            # undrawn rounds cost nothing; progress advances through each
            # skip as if its uplink had arrived, so that the staleness gate
            # never waits on a round that will never be sent
            while r < self.config.rounds and not self._sampled[r, m]:
                self._progress[m] = max(int(self._progress[m]), r)
                r += 1
        if r >= self.config.rounds:
            self._status[m] = _DONE
            self._done_at[m] = t
            self._progress[m] = r
            return
        if self._alive[r, m]:
            self._status[m] = _UPLINK
            self._ev_round[m] = r
            self._ev_time[m] = t + self._lat.up_s[r, m]
        else:
            # Dead round: no send, no receive, no steps; the worker keeps
            # its stale anchor and the server its stale entry. Rebooting
            # costs the compute time the round's steps would have taken.
            reboot = float(self._ks[r, m]) * self._lat.step_s[r, m]
            self._status[m] = _COMPUTE
            self._ev_round[m] = r + 1
            self._ev_time[m] = t + reboot
            self._ev_busy[m] = reboot
            self._ev_is_phase[m] = False
            self.tracer.add_span(
                f"reboot r{r}", cat="reboot", track=f"worker/{m}",
                sim_t0=t, sim_t1=t + reboot, round=int(r), worker=int(m),
            )

    def _run_phases(self, ms: list[int]) -> None:
        """Run the pending local phases of workers ``ms`` (their rounds may
        differ) as one masked pass over the stacked fleet. Lane ``m``'s
        result depends only on its own state, keys and K, so the batch is
        bit-identical to the same phases run one at a time."""
        live = []
        ks_vec = np.zeros((self.config.num_workers,), np.int32)
        for m in ms:
            r = int(self._ev_round[m]) - 1
            k = int(self._ks[r, m])
            if k:
                ks_vec[m] = k
                live.append((m, r, k))
        if not live:
            return
        rounds = {r for _, r, _ in live}
        rngs = self._step_rngs(live[0][1])
        if len(rounds) > 1:
            # mixed rounds at one instant: each worker's key column from
            # its own round's table
            rngs = rngs.clone()
            for r in rounds - {live[0][1]}:
                idx = torch.as_tensor([m for m, rr, _ in live if rr == r],
                                      device=rngs.device)
                rngs[:, idx] = self._step_rngs(r)[:, idx]
        label = (f"phase r{live[0][1]} w{live[0][0]}" if len(live) == 1
                 else f"phase-batch ×{len(live)}")
        with self.tracer.span(label, cat="local-compute",
                              workers=[m for m, _, _ in live],
                              steps=int(sum(k for _, _, k in live))):
            state = self._take_state()
            for i in range(int(ks_vec.max())):
                run = ks_vec > i
                enabled = None if run.all() else self._mask(run)
                state = self.worker.step(self.problem, state, rngs[i],
                                         enabled=enabled)
            self._state = state
            del state
            self._sync_device()
        for m, _, k in live:
            self._steps_cum[m] += k

    def _handle_starts(self, idx: np.ndarray, t: float) -> None:
        """Complete every compute or reboot ending at instant ``t``: run the
        pending phases as one batch, then enter each worker's next round."""
        phase_ms = [int(m) for m in idx if self._ev_is_phase[m]]
        if phase_ms:
            self._run_phases(phase_ms)
            self._ev_is_phase[phase_ms] = False
        self._busy_s[idx] += self._ev_busy[idx]
        self._ev_busy[idx] = 0.0
        for m in idx:
            self._enter_round(int(m), int(self._ev_round[m]), t)

    def _handle_arrivals(self, idx: np.ndarray, t: float) -> None:
        """Land every uplink arriving at instant ``t`` at the server."""
        self._status[idx] = _HELD
        self._progress[idx] = self._ev_round[idx]
        self._arrive_t[idx] = t
        if self.tracer.enabled:
            for m in idx:
                r = int(self._ev_round[m])
                self.tracer.add_span(
                    f"uplink r{r}", cat="uplink", track=f"worker/{int(m)}",
                    sim_t0=t - float(self._lat.up_s[r, m]), sim_t1=t,
                    round=r, worker=int(m),
                    bytes=float(self._msg_bytes),
                )

    def _min_progress(self) -> int:
        active = self._status != _DONE
        if not active.any():
            return self.config.rounds
        return int(self._progress[active].min())

    def _admissible(self) -> list[int]:
        # ascending worker id: the admission order within a batch
        floor = self._min_progress() + self.tau
        return [int(m) for m in np.nonzero(
            (self._status == _HELD) & (self._ev_round <= floor)
        )[0]]

    def _admit_batch(self, adm: list[int], t: float) -> None:
        """One server update: fold the admitted uplinks into the last-heard
        table, recompute the staleness-weighted Line-7 average, deliver it
        to the admitted workers, and schedule their local phases."""
        m_tot = self.config.num_workers
        mask = np.zeros((m_tot,), bool)
        mask[adm] = True
        rounds_of = {m: int(self._ev_round[m]) for m in adm}
        byz_mask = np.zeros((m_tot,), bool)
        if self.byzantine is not None:
            for m in adm:
                byz_mask[m] = self._byz[rounds_of[m], m]

        with self.tracer.span(
            f"admission {self.n_admissions}", cat="admission",
            sim_t0=t, sim_t1=t, admitted=len(adm),
        ) as adm_sp:
            with self.tracer.span("uplink-decode", cat="uplink-encode",
                                  sim_t0=t, sim_t1=t):
                self._store(mask, byz_mask, rounds_of)
            for m in adm:
                self._srv_version[m] = rounds_of[m]
            self._heard[adm] = True

            # Staleness of every stored entry, rounds behind the freshest.
            vmax = int(self._srv_version[self._heard].max())
            stale = np.where(self._heard, vmax - self._srv_version, 0)

            r0 = rounds_of[adm[0]]
            lockstep = (
                self._lockstep_chunk is not None
                and len(adm) == m_tot
                and all(r == r0 for r in rounds_of.values())
            )
            # Recorded before the merge: η and the residual at admission
            # time (merge_synced never touches the output iterate).
            self._record_admission(
                adm, t, self.worker.eta(self._state).cpu().numpy(), stale,
                byz_mask)
            rec = self.trace.rounds[-1]

            with self.tracer.span("server-merge", cat="server-merge",
                                  sim_t0=t, sim_t1=t, lockstep=lockstep):
                if lockstep:
                    # Phases run here; the START events below only carry
                    # the timing.
                    outer = self._lockstep(r0)
                else:
                    discount = np.asarray((1.0 + stale) ** (-self.gamma),
                                          np.float32)
                    outer = self._admit(discount, mask)
                if outer is not None:
                    outer = outer.cpu().numpy()
                    rec.outer_lr = float(outer[0])
                    rec.delta_norm = float(outer[1])
                self._sync_device()

            # Schedule every admitted worker's next compute in one sweep.
            adm_idx = np.asarray(adm, dtype=np.intp)
            rs = self._ev_round[adm_idx]
            compute = (self._ks[rs, adm_idx].astype(np.float64)
                       * self._lat.step_s[rs, adm_idx])
            down = self._lat.down_s[rs, adm_idx]
            self._status[adm_idx] = _COMPUTE
            self._ev_round[adm_idx] = rs + 1
            self._ev_time[adm_idx] = t + down + compute
            self._ev_busy[adm_idx] = compute
            self._ev_is_phase[adm_idx] = not lockstep
            if lockstep:
                self._steps_cum[adm_idx] += self._ks[rs, adm_idx]
            if self.tracer.enabled:
                # each worker's story of this admission on the simulated
                # clock: the staleness hold, the broadcast, the local phase
                for i, m in enumerate(adm):
                    r = int(rs[i])
                    track = f"worker/{m}"
                    if t > self._arrive_t[m]:
                        self.tracer.add_span(
                            f"held r{r}", cat="held", track=track,
                            sim_t0=float(self._arrive_t[m]), sim_t1=t,
                            round=r, worker=int(m),
                        )
                    if down[i] > 0.0:
                        self.tracer.add_span(
                            f"broadcast r{r}", cat="broadcast", track=track,
                            sim_t0=t, sim_t1=t + float(down[i]),
                            round=r, worker=int(m),
                            bytes=float(self._dense_bytes),
                        )
                    if compute[i] > 0.0:
                        self.tracer.add_span(
                            f"local-compute r{r}", cat="local-compute",
                            track=track, sim_t0=t + float(down[i]),
                            sim_t1=t + float(down[i]) + float(compute[i]),
                            round=r, worker=int(m),
                            steps=int(self._ks[r, m]),
                            staleness=int(stale[m]),
                        )
            self.n_admissions += 1

        # The record rides on the admission span, wall time in the span
        # layer only (the trace must be deterministic for a bit-exact
        # resume).
        adm_sp.attrs.update(vars(rec))
        self.metrics.inc("bytes_up", rec.bytes_up, engine="async")
        self.metrics.inc("bytes_down", rec.bytes_down, engine="async")
        self.metrics.inc("admissions", 1, engine="async")
        self.metrics.set_gauge("eta_spread", rec.eta_spread, engine="async")
        if self._robust is not None:
            self.metrics.inc("byzantine_workers",
                             len(rec.byzantine_workers or []),
                             engine="async")
            self.metrics.set_gauge(
                "agg_reject_frac", self.aggregator.reject_frac(len(adm)),
                engine="async", aggregator=self.aggregator.name,
            )
        if self._server is not None and rec.delta_norm is not None:
            self.metrics.set_gauge(
                "outer_delta_norm", rec.delta_norm, engine="async",
                server_opt=self.server_opt.name,
            )
        if rec.idle_frac is not None:
            self.metrics.set_gauge("idle_frac", rec.idle_frac,
                                   engine="async", t_sim=t)
        for m in adm:
            self.metrics.observe("staleness", float(stale[m]),
                                 engine="async", t_sim=t)
        cost = modeled_sync_cost(
            self.compressor.codec_spec, self._dense_bytes,
            workers=len(adm), backend=self.codec_backend,
        )
        self.metrics.observe(
            "admission_wall_s", adm_sp.wall_dur, engine="async",
            codec=self.compressor.name, backend=self.codec_backend,
            modeled_hbm_passes=cost["hbm_passes"],
            modeled_hbm_s=cost["hbm_s"], t_sim=t,
        )

    def _idle_frac(self, t: float) -> float | None:
        if t <= 0.0:
            return None
        busy = float(self._busy_s.sum())
        return max(0.0, 1.0 - busy / (self.config.num_workers * t))

    def _residual(self) -> float | None:
        return None if self.eval_fn is None else float(
            self.eval_fn(self.z_bar()))

    def _record_admission(self, adm, t, etas, stale, byz_mask) -> None:
        m_tot = self.config.num_workers
        # Steps completed since the worker's previous record: one phase (or
        # none, after a dead reboot), so Σ local_steps over all records
        # equals steps_cum.
        steps = [0] * m_tot
        for m in adm:
            d = int(self._steps_cum[m] - self._steps_recorded[m])
            steps[m] = d
            self._steps_recorded[m] += d
        adm_etas = etas[list(adm)]
        self.trace.record(RoundRecord(
            round=self.n_admissions,
            local_steps=steps,
            alive=[bool(m in adm) for m in range(m_tot)],
            bytes_up=len(adm) * self._msg_bytes,
            bytes_down=len(adm) * self._dense_bytes,
            eta_min=float(adm_etas.min()),
            eta_max=float(adm_etas.max()),
            eta_mean=float(adm_etas.mean()),
            residual=self._residual(),
            sim_time_s=float(t),
            staleness=[int(s) if h else None
                       for s, h in zip(stale, self._heard)],
            idle_frac=self._idle_frac(t),
            byzantine_workers=(
                [int(m) for m in adm if byz_mask[m]]
                if self.byzantine is not None else None
            ),
        ))

    def _record_final(self) -> None:
        """The terminal record once the whole fleet has finished, at its
        completion time, with the last phases' step counts (no admission
        covers them)."""
        if self._final_recorded:
            return
        t = float(self._done_at.max())
        etas = self.worker.eta(self._state).cpu().numpy()
        if self._heard.any():
            vmax = int(self._srv_version[self._heard].max())
            stale = np.where(self._heard, vmax - self._srv_version, 0)
        else:
            # an all-dead fleet never uplinked anything
            stale = np.zeros_like(self._srv_version)
        final_steps = self._steps_cum - self._steps_recorded
        self._steps_recorded += final_steps
        rec = RoundRecord(
            round=self.n_admissions,
            local_steps=final_steps.tolist(),
            alive=[False] * self.config.num_workers,
            bytes_up=0.0,
            bytes_down=0.0,
            eta_min=float(etas.min()),
            eta_max=float(etas.max()),
            eta_mean=float(etas.mean()),
            residual=self._residual(),
            sim_time_s=t,
            staleness=[int(s) if h else None
                       for s, h in zip(stale, self._heard)],
            idle_frac=self._idle_frac(t),
        )
        self.trace.record(rec)
        self.tracer.add_span(
            "final", cat="admission", sim_t0=t, sim_t1=t, **vars(rec)
        )
        self._final_recorded = True

    # ------------------------------------------------------------------
    # Driving
    # ------------------------------------------------------------------

    @property
    def done(self) -> bool:
        return bool((self._status == _DONE).all())

    @property
    def sim_time(self) -> float:
        """Current simulated-clock reading (seconds)."""
        return float(self._done_at.max()) if self.done else self.now

    def idle_fraction(self) -> float | None:
        """Fleet fraction of elapsed simulated time not spent computing
        (communication and staleness blocking; phases in progress count
        as idle until they complete)."""
        return self._idle_frac(self.sim_time)

    def run(
        self,
        *,
        until_time: float | None = None,
        until_admissions: int | None = None,
        checkpoint_path: str | None = None,
        checkpoint_every: int | None = None,
    ) -> PyTree:
        """Drive the event queue (to completion by default) and return the
        global output iterate z̄. ``until_time`` stops before the first
        event past that simulated instant; ``until_admissions`` stops after
        that many admissions (lifetime total); ``checkpoint_every`` saves
        ``checkpoint_path`` every that many admissions."""
        last_ckpt = self.n_admissions
        t_start = self.now
        with self.tracer.span("run", cat="run", engine="async",
                              tau=self.tau) as run_sp:
            self._drive(until_time, until_admissions,
                        checkpoint_path, checkpoint_every, last_ckpt)
            run_sp.sim_t0 = t_start
            run_sp.sim_t1 = self.sim_time
        return self.z_bar()

    def _next_time(self) -> float | None:
        """Earliest pending event instant; None when no worker has one
        (the fleet is done, or deadlocked)."""
        pending = (self._status == _COMPUTE) | (self._status == _UPLINK)
        if not pending.any():
            return None
        return float(self._ev_time[pending].min())

    def _drive(self, until_time, until_admissions, checkpoint_path,
               checkpoint_every, last_ckpt) -> None:
        while True:
            t = self._next_time()
            if t is None:
                if not self.done:
                    raise RuntimeError(
                        "event queue drained with workers still blocked — "
                        "staleness deadlock (this is a bug)"
                    )
                break
            if until_time is not None and t > until_time:
                break
            if (until_admissions is not None
                    and self.n_admissions >= until_admissions):
                break
            # Drain every event at instant t: STARTs first (they may spawn
            # same-instant arrivals under zero uplink delay), then ARRIVEs,
            # until the instant is quiet.
            while True:
                at_t = self._ev_time == t
                s_idx = np.nonzero((self._status == _COMPUTE) & at_t)[0]
                if s_idx.size:
                    self._handle_starts(s_idx, t)
                    continue
                a_idx = np.nonzero((self._status == _UPLINK) & at_t)[0]
                if a_idx.size:
                    self._handle_arrivals(a_idx, t)
                    continue
                break
            self.now = t
            adm = self._admissible()
            if adm:
                self._admit_batch(adm, t)
            if (checkpoint_path is not None and checkpoint_every
                    and self.n_admissions - last_ckpt >= checkpoint_every):
                self.save(checkpoint_path)
                last_ckpt = self.n_admissions
        if self.done:
            self._record_final()
        if checkpoint_path is not None:
            self.save(checkpoint_path)

    @property
    def state(self) -> PyTree:
        return self._state

    def z_bar(self) -> PyTree:
        """Global output iterate: worker outputs weighted by the local step
        counts completed on the simulated clock (Line 14 over realised
        work)."""
        counts = self._steps_cum.astype(np.float32)
        if counts.sum() == 0.0:
            counts = np.ones_like(counts)
        return weighted_worker_average(
            self.worker.output(self._state),
            torch.as_tensor(counts, device=self.device))

    # ------------------------------------------------------------------
    # Checkpoints: dynamic state only; policies re-derived from the config
    # ------------------------------------------------------------------

    def _ckpt_tree(self) -> dict:
        """The checkpoint's tree, with the JAX engine's keys, leaf order and
        dtypes (float64 times as raw uint8 bytes)."""
        tree = {
            "worker_state": self._state,
            "ef": self._ef,
            "srv_payload": self._srv_payload,
            "srv_sw": self._srv_sw,
            "srv_version": self._srv_version,
            "heard": self._heard,
            "status": self._status,
            "ev_round": self._ev_round,
            "ev_is_phase": self._ev_is_phase,
            "progress": self._progress,
            "steps_cum": self._steps_cum,
            "steps_recorded": self._steps_recorded,
            "ev_time": _f64_bytes(self._ev_time),
            "ev_busy": _f64_bytes(self._ev_busy),
            "busy_s": _f64_bytes(self._busy_s),
            "done_at": _f64_bytes(self._done_at),
            "now": _f64_bytes(np.float64([self.now])),
            "n_admissions": np.int32(self.n_admissions),
            "final_recorded": np.asarray(bool(self._final_recorded)),
            "rng0": self._rng0.cpu().numpy().astype(np.uint32),
            "worker_fp": np.uint32(self.worker.fingerprint),
        }
        if self._robust is not None:
            # present only when the robust layer changes the merge, so plain
            # runs keep the historical layout byte for byte
            tree["aggregator_fp"] = np.uint32(self.aggregator.fingerprint)
        if self._server is not None:
            z, mom, t = self._srv
            tree["server_opt"] = {"z": z, "mom": mom, "t": t}
            tree["server_opt_fp"] = np.uint32(self.server_opt.fingerprint)
        return tree

    def save(self, path: str) -> None:
        """Write the engine state to ``path`` (the JAX package's layout)."""
        with self.tracer.span("checkpoint-save", cat="checkpoint",
                              sim_t0=self.now, sim_t1=self.now,
                              path=path) as sp:
            sp.attrs["bytes"] = save_pytree(path, self._ckpt_tree())
            self.metrics.inc("checkpoint_bytes", sp.attrs["bytes"],
                             engine="async")

    def restore(self, path: str) -> "AsyncPSEngine":
        """Resume mid-event-queue: the per-worker event machine is the
        queue, so loading its arrays restores it whole; schedules, faults,
        latency tables and key streams are re-derived from the config.
        Refuses a checkpoint from another seed, optimizer, robust
        aggregator or outer optimizer."""
        try:
            loaded = load_pytree(path, self._ckpt_tree())
        except ValueError as e:
            raise ValueError(
                "checkpoint does not match this engine's state layout "
                f"({self.worker.name}): {e}"
            ) from e
        if int(loaded["worker_fp"]) != self.worker.fingerprint:
            raise ValueError(
                "checkpoint was written by a run with a different optimizer "
                f"(engine runs {self.worker.name})"
            )
        if not np.array_equal(loaded["rng0"],
                              self._rng0.cpu().numpy().astype(np.uint32)):
            raise ValueError(
                "checkpoint was written by a run with a different seed"
            )
        if self._robust is not None and (
                int(loaded["aggregator_fp"]) != self.aggregator.fingerprint):
            raise ValueError(
                "checkpoint was written by a run with a different robust "
                "aggregator (the merge semantics would diverge)"
            )
        if self._server is not None:
            if int(loaded["server_opt_fp"]) != self.server_opt.fingerprint:
                raise ValueError(
                    "checkpoint was written by a run with a different "
                    "server-side outer optimizer (engine runs "
                    f"{self.server_opt.name})"
                )
            so = loaded["server_opt"]
            self._srv = (so["z"], so["mom"], so["t"])
        m = self.config.num_workers
        self._state = loaded["worker_state"]
        self._ef = loaded["ef"]
        self._srv_payload = loaded["srv_payload"]
        self._srv_sw = loaded["srv_sw"]
        self._srv_version = loaded["srv_version"]
        self._heard = loaded["heard"]
        self._status = loaded["status"]
        self._ev_round = loaded["ev_round"]
        self._ev_is_phase = loaded["ev_is_phase"]
        self._progress = loaded["progress"]
        self._steps_cum = loaded["steps_cum"]
        self._steps_recorded = loaded["steps_recorded"]
        self._ev_time = _f64_unbytes(loaded["ev_time"], m)
        self._ev_busy = _f64_unbytes(loaded["ev_busy"], m)
        self._busy_s = _f64_unbytes(loaded["busy_s"], m)
        self._done_at = _f64_unbytes(loaded["done_at"], m)
        self.now = float(_f64_unbytes(loaded["now"], 1)[0])
        self.n_admissions = int(loaded["n_admissions"])
        self._final_recorded = bool(loaded["final_recorded"])
        # drop the telemetry of admissions past the restore point
        self.trace.rounds = [
            rec for rec in self.trace.rounds if rec.round < self.n_admissions
        ]
        # held workers' arrival instants are not stored (span layer only):
        # clamp them to "arrived by now"
        self._arrive_t[:] = np.minimum(self._arrive_t, self.now)
        return self


def _f64_bytes(arr: np.ndarray) -> np.ndarray:
    """float64 values as their raw bytes (a uint8 leaf), the JAX package's
    checkpoint form, which survives a package without 64-bit arrays."""
    return np.frombuffer(np.ascontiguousarray(arr, np.float64).tobytes(),
                         np.uint8).copy()


def _f64_unbytes(leaf, n: int) -> np.ndarray:
    return np.frombuffer(np.asarray(leaf, np.uint8).tobytes(),
                         np.float64).reshape(n).copy()
