"""Parameter-Server round engine, serial path (port of ``repro.ps.engine``).

The engine owns the round loop of the paper's Parameter-Server model:
a :class:`~repro_torch.core.worker.LocalWorker` does everything
optimizer-specific, a :class:`~repro_torch.ps.schedule.WorkerSchedule`
gives the per-round local step counts K_m^r, and a
:class:`~repro_torch.ps.trace.TraceRecorder` keeps per-round telemetry.

The serial path runs Algorithm 1 with any built-in compressor (identity,
stochastic quantization or top-k, with error feedback), fault policy and
schedule, a hostile fleet (Byzantine attacks, DP uplinks, robust merges:
``ps.robust``) and a server-side outer optimizer (``ps.server_opt``). Each
round is the Line 5–8 sync followed by K_m^r masked local steps of the
whole stacked fleet. The sync is reference tree math, or under
``codec_backend="fused"`` the fused uplink kernels
(``codec_uplink_stacked``), the merge kernels (plain and robust) and the
outer-step kernel. Dead workers run no steps, send nothing (their
error-feedback residual stays frozen), and keep their stale anchor; the
Line-7 weights are renormalised over the survivors. The sharded path
raises ``NotImplementedError`` until its slice.

Under a :class:`~repro_torch.ps.sampler.ClientSampler` (sampled-client
rounds) the fleet of N workers is a store of ``(N, ...)`` rows; each round
gathers the S drawn rows, runs the same sync and local steps on them
(``make_sampled_chunk`` shares that code with ``make_serial_chunk``), and
writes them back in place. Undrawn workers keep their state, residuals
and stale anchor untouched.

With the same seed the engine draws the same keys as the JAX package
(``derive_rngs`` → ``split(rng0, R)`` per round → ``split(rng_round, K·M)``
per step, ``split(fold_in(rng_round, 7), M)`` for the codec, and those
keys folded with 13 and 11 for the attacks and the DP noise), so its
trajectories can be held against the JAX engine's.

Each round is recorded three ways on the host: a
:class:`~repro_torch.ps.trace.RoundRecord` in the trace, a ``round`` span
(:mod:`repro_torch.obs.spans`), and the JAX engine's metric records
(:mod:`repro_torch.obs.metrics`: traffic, steps, η spread, the hostile
fleet's and the outer step's gauges, and the round's wall time beside the
uplink's modeled HBM time).

Checkpoints (:meth:`PSEngine.save`, :meth:`PSEngine.restore`) carry the
fleet state, the error-feedback residuals, the round counter, the seed
and the fingerprints, plus the outer optimizer's state when one is active,
in the JAX package's layout (``repro_torch.checkpoint``); schedules, fault
and attack tables are re-derived from the config, so a resumed run is
bit-identical to an uninterrupted one.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .. import random as jr
from .._device import resolve_device
from ..checkpoint.serialize import (
    load_pytree,
    save_pytree,
    tree_flatten,
    tree_unflatten,
)
from ..core.adaseg import AdaSEGConfig, weighted_worker_average
from ..core.tree import per_worker, tree_map, tree_zeros_like
from ..core.types import MinimaxProblem
from ..core.worker import AdaSEGWorker, LocalWorker
from ..kernels.sync_compress.ref import effective_message
from ..obs import MetricsRegistry, SpanTracer, modeled_sync_cost
from .compress import (
    IdentityCompressor,
    SyncCompressor,
    check_codec_backend,
    dense_bytes,
)
from .faults import FaultPolicy, NoFaults
from .robust import ByzantinePolicy, DPUplink, RobustAggregator, WeightedMean
from .sampler import ClientSampler
from .schedule import UniformSchedule, WorkerSchedule
from .server_opt import NoServerOpt, ServerOptimizer, resolve_server_opt
from .trace import RoundRecord, TraceRecorder

PyTree = Any


@dataclasses.dataclass(frozen=True)
class PSConfig:
    """Everything the Parameter-Server engine needs beyond the problem.

    The optimizer is ``adaseg=`` (an :class:`AdaSEGConfig`, wrapped into an
    :class:`AdaSEGWorker` with ``backend``) or ``worker=`` (any
    :class:`LocalWorker`, which then needs ``local_k=`` or ``schedule=``).
    ``codec_backend`` picks the sync's implementation: ``"reference"``
    (plain PyTorch) or ``"fused"`` (the CUDA kernels; their plain versions
    for CPU tensors). ``byzantine``, ``aggregator`` and ``dp`` are the
    hostile-fleet layers (:mod:`repro_torch.ps.robust`): any of them
    switches the uplink to the unweighted wire format with the Line-7
    weights applied server-side, and all None (or a zero-budget aggregator)
    runs the historical path. ``server_opt`` is the outer optimizer over
    round deltas (None or ``NoServerOpt`` is the historical Line-7
    broadcast). ``sampler`` draws ``sampler.sample`` of the
    ``num_workers`` fleet workers a round (None is full participation).

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
    sampler: ClientSampler | None = None
    byzantine: ByzantinePolicy | None = None  # adversarial uplinks
    aggregator: RobustAggregator | None = None  # robust server merge
    dp: DPUplink | None = None               # l2 clip + Gaussian noise
    server_opt: ServerOptimizer | None = None  # outer optimizer over Δ


@dataclasses.dataclass(frozen=True)
class RobustPipeline:
    """The resolved hostile-fleet configuration: the attack policy, the
    static merge spec at the lane width, and the DP transform. None
    anywhere means that layer is off; the engine builds a pipeline only
    when at least one layer is active."""

    byzantine: ByzantinePolicy | None
    agg: tuple | None
    dp: DPUplink | None


def resolve_robust(config: PSConfig, lanes: int) -> RobustPipeline | None:
    """Resolve a config's hostile-fleet fields at lane width ``lanes``
    (the sampled width under a ``ClientSampler``, else the fleet). Returns
    None (the exact historical path) when there is no attack, no
    DP, and the aggregator degrades (``spec(lanes) is None``).

    >>> from repro_torch.ps.robust import TrimmedMean
    >>> cfg = PSConfig(num_workers=4, rounds=1, aggregator=TrimmedMean(0.2))
    >>> resolve_robust(cfg, 4) is None, resolve_robust(cfg, 10).agg
    (True, ('trimmed', 2))
    """
    agg = config.aggregator or WeightedMean()
    spec = agg.spec(lanes)
    if config.byzantine is None and spec is None and config.dp is None:
        return None
    return RobustPipeline(config.byzantine, spec, config.dp)


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


def _line7_weights(sw, alive_r):
    """w = sync_weight / Σ over the survivors, and who receives the merge
    (``recv = alive ∧ any alive``; None when ``alive_r`` is None)."""
    if alive_r is None:
        return sw / torch.sum(sw), None
    w_raw = torch.where(alive_r, sw, 0.0)
    denom = torch.sum(w_raw)
    any_alive = denom > 0.0
    return w_raw / torch.where(any_alive, denom, 1.0), alive_r & any_alive


def _initial_anchor(worker: LocalWorker, state, codec_backend: str):
    """The server anchor's start: the fleet mean of the initial payloads,
    formed by the clean sync's own merge with the initial Line-7 weights
    (equal across an AdaSEG fleet, whose η all start at the same value).
    A clean fleet's first pseudo-gradient is then exactly 0 on either
    backend, where a mean formed another way leaves rounding noise that
    Adam's normalised step turns into moves of ±lr (ROADMAP C6)."""
    w, _ = _line7_weights(worker.sync_weight(state), None)
    payload = worker.sync_payload(state)
    if codec_backend == "fused":
        from ..kernels.sync_compress.ops import sync_merge_stacked

        return tuple(v[:1].clone() for v in sync_merge_stacked(payload, w))
    return tuple(torch.sum(per_worker(w, v).to(v.dtype) * v, dim=0,
                           keepdim=True) for v in payload)


def make_sync_stacked(worker: LocalWorker, compressor: SyncCompressor,
                      num_workers: int, codec_backend: str = "reference",
                      robust: RobustPipeline | None = None,
                      server: ServerOptimizer | None = None):
    """Line 5–8 on the stacked worker axis: compress(w·payload) per worker
    (plus the error-feedback residual), server sum, broadcast to the
    survivors. Returns ``sync(state, ef, alive_r, c_rng) -> (state,
    ef_new)``: ``alive_r`` (M,) bool, or None when the fault policy
    guarantees everyone is up (then nothing is masked, and the identity
    codec runs exactly the no-fault expressions); ``c_rng`` the round's
    codec key, split into one key per worker.

    ``codec_backend="fused"`` normalises ``w`` here and runs the uplink
    kernels (``codec_uplink_stacked``) and the merge kernel; with the
    identity codec the merge kernel alone applies ``w``: one read and one
    write of the fleet payload per leaf.

    ``robust`` (a resolved :class:`RobustPipeline`) swaps in the hostile
    round, ``sync(state, ef, alive_r, c_rng, byz_r)`` with ``byz_r`` the
    (M,) attacked-lane mask: the uplink is *unweighted*, the attack and
    the DP transform act on the raw payload (keys ``fold_in(key, 13)`` and
    ``fold_in(key, 11)`` of each worker's codec key), the codec compresses
    that, and the Line-7 weights and the robust aggregation are applied
    server-side by ``sync_merge_stacked(agg=..., normalize=True)``.

    ``server`` (a resolved outer optimizer, never ``NoServerOpt``) inserts
    the outer step between the merge and delivery: the merge runs ungated,
    its row 0 is the pseudo-gradient's end point against the server anchor,
    and the survivors receive the *post-step* anchor. The closures then
    take a trailing ``srv = (z, moments, t)`` and return ``(state, ef_new,
    srv_new, telem)`` with ``telem = [eff_lr, ‖Δ‖]``."""
    comp = compressor
    m = num_workers
    has_ef = comp.error_feedback
    use_kernel = codec_backend == "fused"

    if server is not None:
        from ..kernels.sync_compress.ops import server_outer_apply

        def finish(state, ef, merged, recv, payload, srv):
            """Row 0 of the ungated merge → outer step → gated delivery;
            returns ``(state, ef, srv_new, telem)``."""
            z, mom, t = srv
            z_new, mom_new, t_new, eff_lr, dn = server_outer_apply(
                tuple(v[:1] for v in merged), z, mom, t, spec=server.spec,
                use_kernel=use_kernel)
            if recv is None:
                synced = tuple(v.expand(old.shape).contiguous()
                               for v, old in zip(z_new, payload))
            else:
                synced = tuple(torch.where(per_worker(recv, old), v, old)
                               for v, old in zip(z_new, payload))
            return (worker.merge_synced(state, synced), ef,
                    (z_new, mom_new, t_new), torch.stack([eff_lr, dn]))

    if robust is not None:
        from ..kernels.sync_compress.ops import (
            codec_uplink_stacked,
            sync_merge_stacked,
        )

        def sync_stacked_robust(state, ef, alive_r, c_rng, byz_r, srv=None):
            sw = worker.sync_weight(state)                    # (M,)
            if alive_r is None:
                w_raw, recv = sw, None
            else:
                w_raw = torch.where(alive_r, sw, 0.0)
                recv = alive_r & (torch.sum(w_raw) > 0.0)
            payload = worker.sync_payload(state)
            c_rngs = jr.split(c_rng, m)
            uplink = payload
            if robust.byzantine is not None:
                uplink = robust.byzantine.apply(uplink, byz_r,
                                                jr.fold_in(c_rngs, 13))
            if robust.dp is not None:
                uplink = robust.dp.apply(uplink, jr.fold_in(c_rngs, 11))
            if comp.is_identity:
                sent, ef_new = uplink, ef
            else:
                sent, ef_new = codec_uplink_stacked(
                    uplink, c_rngs, w=None, ef=ef if has_ef else None,
                    alive=alive_r, codec=comp.codec_spec,
                    use_kernel=use_kernel)
                if not has_ef:
                    ef_new = ef
            if server is not None:
                # ungated robust merge → outer step → gated delivery
                merged = sync_merge_stacked(sent, w_raw, normalize=True,
                                            agg=robust.agg,
                                            use_kernel=use_kernel)
                return finish(state, ef_new, merged, recv, payload, srv)
            synced = sync_merge_stacked(
                sent, w_raw, recv, None if recv is None else payload,
                normalize=True, agg=robust.agg, use_kernel=use_kernel)
            return worker.merge_synced(state, synced), ef_new

        return sync_stacked_robust

    if codec_backend == "fused":
        from ..kernels.sync_compress.ops import (
            codec_uplink_stacked,
            sync_merge_stacked,
        )

        def sync_stacked_fused(state, ef, alive_r, c_rng, srv=None):
            w, recv = _line7_weights(worker.sync_weight(state), alive_r)
            payload = worker.sync_payload(state)
            old = None if recv is None else payload
            if comp.is_identity:
                if server is not None:
                    merged = sync_merge_stacked(payload, w)
                    return finish(state, ef, merged, recv, payload, srv)
                synced = sync_merge_stacked(payload, w, recv, old)
                return worker.merge_synced(state, synced), ef
            sent, ef_new = codec_uplink_stacked(
                payload, jr.split(c_rng, m), w=w,
                ef=ef if has_ef else None, alive=alive_r,
                codec=comp.codec_spec,
            )
            if not has_ef:
                ef_new = ef
            if server is not None:
                return finish(state, ef_new, sync_merge_stacked(sent), recv,
                              payload, srv)
            synced = sync_merge_stacked(sent, None, recv, old)
            return worker.merge_synced(state, synced), ef_new

        return sync_stacked_fused

    def sync_stacked(state, ef, alive_r, c_rng, srv=None):
        w, recv = _line7_weights(worker.sync_weight(state), alive_r)
        payload = worker.sync_payload(state)
        if comp.is_identity:
            sent = tree_map(
                lambda leaf: per_worker(w, leaf).to(leaf.dtype) * leaf,
                payload,
            )
            ef_new = ef
        else:
            eff = tree_map(lambda leaf, e: effective_message(leaf, e, w),
                           payload, ef if has_ef else (None,) * len(payload))
            sent = comp.compress(eff, jr.split(c_rng, m))
            if alive_r is None:
                ef_new = tree_map(torch.sub, eff, sent) if has_ef else ef
            else:
                # dead workers send nothing and keep their error memory
                sent = tree_map(
                    lambda s: torch.where(per_worker(alive_r, s), s, 0.0),
                    sent)
                ef_new = tree_map(
                    lambda e, s, e_old: torch.where(
                        per_worker(alive_r, e), e - s, e_old),
                    eff, sent, ef) if has_ef else ef
        if server is not None:
            merged = tree_map(lambda s: torch.sum(s, dim=0, keepdim=True),
                              sent)
            return finish(state, ef_new, merged, recv, payload, srv)
        if recv is None:
            synced = tree_map(
                lambda s: torch.sum(s, dim=0, keepdim=True).expand(s.shape)
                .contiguous(),
                sent,
            )
        else:
            synced = tree_map(
                lambda s, old: torch.where(
                    per_worker(recv, old),
                    torch.sum(s, dim=0, keepdim=True), old),
                sent, payload,
            )
        return worker.merge_synced(state, synced), ef_new

    return sync_stacked


def _make_round_core(problem, worker, compressor, lanes, k_pad, no_faults,
                     codec_backend, dev, robust, server):
    """One round's sync and its K_m^r masked local steps on a stack of
    ``lanes`` workers: ``core(state, ef, srv, rng_round, steps_r, alive_r,
    byz_r) -> (state, ef, srv, telem)``. Both chunks run it, so the
    sampled round on its gathered lanes is the serial round's arithmetic
    (and ``sample == fleet`` gives the serial chunk's numbers)."""
    sync_stacked = make_sync_stacked(worker, compressor, lanes, codec_backend,
                                     robust, server)

    def core(state, ef, srv, rng_round, steps_r, alive_r, byz_r):
        alive_t = None if no_faults else torch.as_tensor(alive_r, device=dev)
        if robust is not None:
            # the robust uplink keys its attacks and noise off the codec
            # key, so it is derived whatever the codec
            args = (state, ef, alive_t, jr.fold_in(rng_round, 7),
                    torch.as_tensor(byz_r, device=dev))
        else:
            args = (state, ef, alive_t, None if compressor.is_identity
                    else jr.fold_in(rng_round, 7))
        del state                       # the pre-sync state can go with args
        telem = None
        if server is not None:
            state, ef, srv, telem = sync_stacked(*args, srv)
        else:
            state, ef = sync_stacked(*args)
        del args
        # Line 3–4: K_m^r masked local steps (no mask when all run).
        step_rngs = jr.split(rng_round, k_pad * lanes).reshape(
            k_pad, lanes, 2)
        for i in range(k_pad):
            run = steps_r > i
            enabled = None if run.all() else torch.as_tensor(run, device=dev)
            state = worker.step(problem, state, step_rngs[i], enabled=enabled)
        return state, ef, srv, telem

    return core


def _round_stats(worker, eval_fn, lanes_state, fleet_state, counts_r, dev):
    """η ``[min, max, mean]`` over the round's lanes, and the residual of
    the Line-14 output over the whole fleet (NaN without ``eval_fn``)."""
    eta_end = worker.eta(lanes_state)                          # (lanes,)
    eta_stats = torch.stack([eta_end.min(), eta_end.max(), eta_end.mean()])
    if eval_fn is None:
        return eta_stats, torch.tensor(float("nan"), device=dev)
    counts = counts_r if counts_r.sum() > 0 else np.ones_like(counts_r)
    res = eval_fn(weighted_worker_average(
        worker.output(fleet_state), torch.as_tensor(counts, device=dev)))
    return eta_stats, res.to(torch.float32)


def make_serial_chunk(
    problem: MinimaxProblem,
    worker: LocalWorker,
    compressor: SyncCompressor,
    num_workers: int,
    k_pad: int,
    eval_fn,
    no_faults: bool,
    codec_backend: str = "reference",
    device="cuda",
    robust: RobustPipeline | None = None,
    server: ServerOptimizer | None = None,
):
    """Build the serial-path round chunk: for each round, sync then K_m^r
    masked local steps (a Python loop where the JAX package scans).

    The chunk is ``chunk(state, ef, round_rngs, steps, alive, counts_cum,
    byz=None, srv=None) -> (state, ef, eta_stats, ress, srv, outer)``:
    ``ef`` the error-feedback residual tree (``()`` without error
    feedback), ``round_rngs`` ``(C, 2)``; ``steps`` (the realised K_m^r, 0
    for dead workers), ``alive``, ``counts_cum`` and, under a robust
    pipeline, ``byz`` (the attacked lanes) are ``(C, M)`` host tables;
    ``srv`` the outer optimizer's ``(z, moments, t)`` under a ``server``.
    ``eta_stats`` is ``(C, 3)`` per-round ``[min, max, mean]`` of η over
    the fleet, ``ress`` ``(C,)`` the residual of the running Line-14 output
    (NaN without ``eval_fn``) and ``outer`` ``(C, 2)`` the per-round
    ``[eff_lr, ‖Δ‖]`` (None without a server), all left on the device so a
    chunk transfers O(rounds) values once. ``no_faults`` is the static "no
    masking" case: ``alive`` is then ignored."""
    dev = torch.device(device)
    core = _make_round_core(problem, worker, compressor, num_workers, k_pad,
                            no_faults, codec_backend, dev, robust, server)

    def chunk(state, ef, round_rngs, steps, alive, counts_cum, byz=None,
              srv=None):
        etas, ress, outer = [], [], []
        # Only the round in flight holds the fleet state, so each state is
        # freed as soon as its successor exists (a model's fleet state is
        # gigabytes per copy).
        held = [state]
        del state
        for c in range(round_rngs.shape[0]):
            state, ef, srv, telem = core(
                held.pop(), ef, srv, round_rngs[c], steps[c], alive[c],
                None if byz is None else byz[c])
            held.append(state)
            eta_stats, res = _round_stats(worker, eval_fn, state, state,
                                          counts_cum[c], dev)
            del state
            etas.append(eta_stats)
            ress.append(res)
            outer.append(telem)
        return (held.pop(), ef, torch.stack(etas), torch.stack(ress), srv,
                torch.stack(outer) if server is not None else None)

    return chunk


def gather_rows(tree, rows: torch.Tensor):
    """The ``rows`` (int64, on the tree's device) of every worker-stacked
    leaf of ``tree``, as a new contiguous tree of the same structure.

    >>> store = (torch.arange(6.0).reshape(3, 2), torch.arange(3))
    >>> rows = torch.tensor([0, 2])
    >>> sub = gather_rows(store, rows)
    >>> sub[0].tolist(), sub[1].tolist()
    ([[0.0, 1.0], [4.0, 5.0]], [0, 2])
    >>> scatter_rows_(store, rows, (-sub[0], sub[1]))
    >>> store[0].tolist()
    [[-0.0, -1.0], [2.0, 3.0], [-4.0, -5.0]]
    """
    return tree_unflatten(tree, iter(
        [leaf.index_select(0, rows) for leaf in tree_flatten(tree)]))


def scatter_rows_(tree, rows: torch.Tensor, sub) -> None:
    """Write ``sub``'s leaves into the ``rows`` of ``tree``'s, in place.
    ``rows`` must be unique (a draw without replacement is)."""
    for dst, src in zip(tree_flatten(tree), tree_flatten(sub)):
        dst.index_copy_(0, rows, src)


def _distinct_leaves(tree):
    """``tree`` with every leaf that shares its storage with an earlier one
    cloned, so that writing rows of one leaf in place cannot change
    another (an optimizer's init may hand two fields one zeros tensor)."""
    seen = set()
    leaves = []
    for leaf in tree_flatten(tree):
        ptr = leaf.untyped_storage().data_ptr()
        leaves.append(leaf.clone() if ptr in seen else leaf)
        seen.add(ptr)
    return tree_unflatten(tree, iter(leaves))


def make_sampled_chunk(
    problem: MinimaxProblem,
    worker: LocalWorker,
    compressor: SyncCompressor,
    sample: int,
    k_pad: int,
    eval_fn,
    no_faults: bool,
    codec_backend: str = "reference",
    device="cuda",
    robust: RobustPipeline | None = None,
    server: ServerOptimizer | None = None,
):
    """Sampled-client round chunk (partial participation). The fleet
    store stays ``(N, ...)``; each round gathers the S = ``sample`` drawn
    workers' rows of the state and of the error-feedback residuals, runs
    the serial chunk's sync and masked local steps on that ``(S, ...)``
    stack (the codec key ``fold_in(rng_round, 7)``, the step keys
    ``split(rng_round, k_pad·S)``), and writes the rows back into the
    store in place. Workers not drawn keep their η accumulators, residuals
    and stale anchor as if the round never reached them.

    ``chunk(store, ef, idx, round_rngs, steps, alive, counts_cum,
    byz=None, srv=None)`` returns what :func:`make_serial_chunk`'s does,
    with ``idx`` the ``(C, S)`` draws (sorted, unique), ``steps``,
    ``alive`` and ``byz`` the ``(C, S)`` lane tables, and ``counts_cum``
    fleet-shaped ``(C, N)`` so that the residual is the Line-14 output's
    over everyone who has taken part. ``eta_stats`` is over the drawn
    lanes. ``store`` and ``ef`` are the same objects on return, updated in
    place (their leaves must not share storage). Under a ``server`` ONE
    global ``srv`` runs through the rounds: the outer step sees the merge
    of the drawn lanes, and only they receive the post-step anchor.

    The gathered ``worker_id`` keeps the fleet ids, so a heterogeneous
    oracle keyed by it draws for a lane as for its fleet worker."""
    dev = torch.device(device)
    core = _make_round_core(problem, worker, compressor, sample, k_pad,
                            no_faults, codec_backend, dev, robust, server)
    has_ef = compressor.error_feedback

    def chunk(store, ef, idx, round_rngs, steps, alive, counts_cum,
              byz=None, srv=None):
        etas, ress, outer = [], [], []
        for c in range(round_rngs.shape[0]):
            rows = torch.as_tensor(idx[c], dtype=torch.int64, device=dev)
            sub, sub_ef, srv, telem = core(
                gather_rows(store, rows),
                gather_rows(ef, rows) if has_ef else ef, srv,
                round_rngs[c], steps[c], alive[c],
                None if byz is None else byz[c])
            scatter_rows_(store, rows, sub)
            if has_ef:
                scatter_rows_(ef, rows, sub_ef)
            eta_stats, res = _round_stats(worker, eval_fn, sub, store,
                                          counts_cum[c], dev)
            del sub, sub_ef
            etas.append(eta_stats)
            ress.append(res)
            outer.append(telem)
        return (store, ef, torch.stack(etas), torch.stack(ress), srv,
                torch.stack(outer) if server is not None else None)

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
        metrics: MetricsRegistry | None = None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if mesh is not None:
            raise NotImplementedError(
                "the sharded path (mesh=) is ported in a later slice")
        self.problem = problem
        self.config = config
        # Spans and metrics are recorded on the host from values already
        # copied there, so the default-enabled tracer and registry cannot
        # change a result (tests/test_torch_obs.py runs them on and off).
        self.tracer = tracer if tracer is not None else SpanTracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.worker = _resolve_worker(config)
        self.schedule = _resolve_schedule(config)
        self.compressor = config.compressor or IdentityCompressor()
        self.faults = config.faults or NoFaults()
        check_codec_backend(config.codec_backend, self.compressor)
        m, r = config.num_workers, config.rounds
        self.sampler = config.sampler
        # Hostile fleet and outer optimizer, resolved as the JAX engine does:
        # None for the historical path (zero budget, NoServerOpt). The merge
        # is resolved at the lane width: the sampled width under a sampler.
        self.aggregator = config.aggregator or WeightedMean()
        self.byzantine = config.byzantine
        self.dp = config.dp
        self._robust = resolve_robust(
            config, self.sampler.sample if self.sampler is not None else m)
        self._byz = (np.asarray(self.byzantine.attacked(m, r), dtype=bool)
                     if self.byzantine is not None
                     else np.zeros((r, m), dtype=bool))
        if self._byz.shape != (r, m):
            raise ValueError("byzantine table shape mismatch")
        self.server_opt = config.server_opt or NoServerOpt()
        self._server = resolve_server_opt(config)
        self.codec_backend = config.codec_backend
        # Static: NoFaults lets the round skip aliveness masking entirely.
        self._no_faults = isinstance(self.faults, NoFaults)
        self.eval_fn = eval_fn

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
        # Sampled-client rounds: the fleet tables gathered onto the S drawn
        # lanes of each round; the realised steps go back to fleet shape,
        # so z̄ and counts_cum stay Line 14 over the whole fleet.
        if self.sampler is not None:
            self._draws = self.sampler.draws(m, r)            # (R, S)
            self._alive_lane = np.take_along_axis(self._alive, self._draws,
                                                  axis=1)
            self._eff_lane = np.where(
                self._alive_lane,
                np.take_along_axis(self._ks, self._draws, axis=1), 0)
            self._byz_lane = np.take_along_axis(self._byz, self._draws,
                                                axis=1)
            self._eff_steps = np.zeros((r, m), dtype=self._eff_lane.dtype)
            np.put_along_axis(self._eff_steps, self._draws, self._eff_lane,
                              axis=1)                         # (R, N)
        else:
            self._draws = None
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
        # Error-feedback residuals, one per worker and payload leaf.
        self._ef: PyTree = (
            tree_zeros_like(self.worker.sync_payload(self._state))
            if self.compressor.error_feedback else ())
        if self.sampler is not None:
            # the sampled chunk writes rows of the store in place
            self._state = _distinct_leaves(self._state)

        # The outer optimizer's (z_server, moments, round count); the anchor
        # starts at the fleet mean of the initial payloads.
        if self._server is not None:
            z0 = _initial_anchor(self.worker, self._state, self.codec_backend)
            self._srv = (z0, self._server.init_moments(z0),
                         torch.zeros((), dtype=torch.int32,
                                     device=self.device))
        else:
            self._srv = None

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
            **({"sampler": self.sampler.name,
                "sample": self.sampler.sample}
               if self.sampler is not None else {}),
            **({"byzantine": self.byzantine.name}
               if self.byzantine is not None else {}),
            **({"aggregator": self.aggregator.name,
                "dp": None if self.dp is None else self.dp.name}
               if self._robust is not None else {}),
            **({"server_opt": self.server_opt.name}
               if self._server is not None else {}),
        })
        if self.sampler is not None:
            self._chunk_fn = make_sampled_chunk(
                problem, self.worker, self.compressor, self.sampler.sample,
                self._k_pad, eval_fn, self._no_faults, self.codec_backend,
                self.device, self._robust, self._server)
        else:
            self._chunk_fn = make_serial_chunk(
                problem, self.worker, self.compressor, m, self._k_pad,
                eval_fn, self._no_faults, self.codec_backend, self.device,
                self._robust, self._server)

    # ------------------------------------------------------------------
    # Driving, output, telemetry
    # ------------------------------------------------------------------

    def _take_state(self) -> PyTree:
        """Hand the fleet state to the chunk, which then holds its only
        reference: the pre-chunk state is freed after the first step
        instead of living through the chunk. A chunk that raises leaves
        the engine without a state."""
        state, self._state = self._state, None
        return state

    def _run_chunk(self, r0: int, r1: int) -> None:
        sl = slice(r0, r1)
        sampled = self._draws is not None
        if sampled:
            lead = (self._draws[sl],)
            steps_tab, alive_tab, byz_tab = (self._eff_lane, self._alive_lane,
                                             self._byz_lane)
        else:
            lead = ()
            steps_tab, alive_tab, byz_tab = (self._eff_steps, self._alive,
                                             self._byz)
        with self.tracer.span(f"chunk [{r0},{r1})", cat="chunk",
                              rounds=r1 - r0) as chunk_sp:
            state, ef, etas, ress, srv, outer = self._chunk_fn(
                self._take_state(), self._ef, *lead, self._round_rngs[sl],
                steps_tab[sl], alive_tab[sl], self._counts_cum[sl],
                byz=byz_tab[sl] if self._robust is not None else None,
                srv=self._srv)
            # The host copies wait for the device, so the span times the
            # chunk's device work too.
            stats = etas.cpu().numpy()                        # (C, 3)
            ress = ress.cpu().numpy()
            outer = None if outer is None else outer.cpu().numpy()  # (C, 2)
        self._state, self._ef, self._srv = state, ef, srv
        self.round = r1

        # The chunk's wall-clock, attributed uniformly across its rounds,
        # beside the traffic model's cost of the uplink.
        per_round_wall = chunk_sp.wall_dur / max(r1 - r0, 1)
        cost = modeled_sync_cost(
            self.compressor.codec_spec, self._dense_bytes,
            workers=self.config.num_workers, backend=self.codec_backend)
        for i, r in enumerate(range(r0, r1)):
            # per lane under a sampler: the drawn workers, ascending ids
            alive, steps_row = alive_tab[r], steps_tab[r]
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
                sampled_workers=(self._draws[r].tolist() if sampled
                                 else None),
                byzantine_workers=(
                    None if self.byzantine is None
                    else self._draws[r][self._byz_lane[r]].tolist()
                    if sampled else np.nonzero(self._byz[r])[0].tolist()),
                outer_lr=None if outer is None else float(outer[i, 0]),
                delta_norm=None if outer is None else float(outer[i, 1]),
            )
            self.trace.record(rec)
            if self.tracer.enabled:
                self.tracer.add_span(
                    f"round {r}", cat="round", parent=chunk_sp.id,
                    wall_t0=chunk_sp.wall_t0 + i * per_round_wall,
                    wall_t1=chunk_sp.wall_t0 + (i + 1) * per_round_wall,
                    **vars(rec),
                )
            self._emit_round(rec, eff, len(alive), per_round_wall, cost)

    def _emit_round(self, rec: RoundRecord, eff: int, lanes: int,
                    wall: float, cost: dict) -> None:
        """One round's metrics, as the JAX package's sync engine emits
        them: traffic, local steps, η spread, the outer step's ‖Δ‖ and the
        hostile fleet's gauges where those layers are on, and the measured
        round wall beside the modeled uplink cost."""
        m = self.metrics
        m.inc("bytes_up", rec.bytes_up, engine="sync")
        m.inc("bytes_down", rec.bytes_down, engine="sync")
        m.inc("local_steps", eff, engine="sync")
        m.set_gauge("eta_spread", rec.eta_spread, engine="sync")
        if self._server is not None:
            m.set_gauge("outer_delta_norm", rec.delta_norm, engine="sync",
                        server_opt=self.server_opt.name)
        if self._robust is not None:
            m.inc("byzantine_workers", len(rec.byzantine_workers or []),
                  engine="sync")
            m.set_gauge("agg_reject_frac", self.aggregator.reject_frac(lanes),
                        engine="sync", aggregator=self.aggregator.name)
        m.observe("round_wall_s", wall, engine="sync",
                  codec=self.compressor.name, backend=self.codec_backend,
                  modeled_hbm_passes=cost["hbm_passes"],
                  modeled_hbm_s=cost["hbm_s"])

    def run(self, *, until_round: int | None = None,
            checkpoint_path: str | None = None,
            checkpoint_every: int | None = None) -> PyTree:
        """Advance to ``until_round`` (default: all rounds) and return the
        global output iterate z̄ (Line 14). ``checkpoint_every`` chunks the
        rounds and writes ``checkpoint_path`` at each chunk's end."""
        target = min(self.config.rounds if until_round is None
                     else int(until_round), self.config.rounds)
        with self.tracer.span(f"run [{self.round},{target})", cat="run",
                              engine="sync"):
            while self.round < target:
                r1 = (min(target, self.round + checkpoint_every)
                      if checkpoint_every else target)
                self._run_chunk(self.round, r1)
                if checkpoint_path is not None:
                    self.save(checkpoint_path)
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

    # ------------------------------------------------------------------
    # Checkpointing
    # ------------------------------------------------------------------

    def _ckpt_tree(self) -> dict:
        """The checkpoint's tree, with the JAX engine's keys, leaf order
        and dtypes (``round`` int32, ``rng0`` uint32 (2,), fingerprints
        uint32)."""
        tree = {
            "worker_state": self._state,
            "ef": self._ef,
            "round": np.int32(self.round),
            "rng0": self._rng0.cpu().numpy().astype(np.uint32),
            "worker_fp": np.uint32(self.worker.fingerprint),
        }
        if self.sampler is not None:
            # present only for sampled runs, so a sampled checkpoint cannot
            # restore into a full-participation engine (or the reverse):
            # the leaf structure itself differs
            tree["sampler_fp"] = np.uint32(self.sampler.fingerprint)
        if self._robust is not None:
            # present only for robust runs: the merge semantics (and the
            # threat model the EF memory accumulated under) must match
            tree["aggregator_fp"] = np.uint32(self.aggregator.fingerprint)
        if self._server is not None:
            # present only under an active outer optimizer, so the
            # historical (``none``) layout stays byte-identical
            z, mom, t = self._srv
            tree["server_opt"] = {"z": z, "mom": mom, "t": t}
            tree["server_opt_fp"] = np.uint32(self.server_opt.fingerprint)
        return tree

    def save(self, path: str) -> None:
        """Write the engine state to ``path`` (the JAX package's layout)."""
        with self.tracer.span(f"checkpoint r{self.round}", cat="checkpoint",
                              round=self.round) as sp:
            sp.attrs["bytes"] = save_pytree(path, self._ckpt_tree())
            self.metrics.inc("checkpoint_bytes", sp.attrs["bytes"],
                             engine="sync")

    def restore(self, path: str) -> "PSEngine":
        """Resume mid-run: policies and key streams are re-derived from the
        config, so only the fleet state, the error-feedback residuals, the
        outer optimizer's state and the round counter come from disk.
        Refuses a checkpoint from another seed, optimizer, client sampler,
        robust aggregator or outer optimizer, and a sampled checkpoint in
        a full-participation engine or the reverse. The trace keeps the
        rounds before the restored one."""
        try:
            loaded = load_pytree(path, self._ckpt_tree())
        except ValueError as e:
            raise ValueError(
                "checkpoint does not match this engine's optimizer state "
                f"layout ({self.worker.name}): {e}") from e
        if int(loaded["worker_fp"]) != self.worker.fingerprint:
            raise ValueError(
                "checkpoint was written by a run with a different optimizer "
                f"(engine runs {self.worker.name})")
        if not np.array_equal(loaded["rng0"],
                              self._rng0.cpu().numpy().astype(np.uint32)):
            raise ValueError(
                "checkpoint was written by a run with a different seed")
        if (self.sampler is not None and int(loaded["sampler_fp"])
                != self.sampler.fingerprint):
            raise ValueError(
                "checkpoint was written by a run with a different client "
                "sampler (the participation tables would diverge)")
        if (self._robust is not None and int(loaded["aggregator_fp"])
                != self.aggregator.fingerprint):
            raise ValueError(
                "checkpoint was written by a run with a different robust "
                "aggregator (the merge semantics would diverge)")
        if self._server is not None:
            if int(loaded["server_opt_fp"]) != self.server_opt.fingerprint:
                raise ValueError(
                    "checkpoint was written by a run with a different "
                    "server-side outer optimizer (engine runs "
                    f"{self.server_opt.name})")
            so = loaded["server_opt"]
            self._srv = (so["z"], so["mom"], so["t"])
        self._state = loaded["worker_state"]
        self._ef = loaded["ef"]
        self.round = int(loaded["round"])
        # drop the telemetry of rounds past the restore point
        self.trace.rounds = [rec for rec in self.trace.rounds
                             if rec.round < self.round]
        return self
