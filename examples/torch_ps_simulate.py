"""Parameter-Server fleet simulation through the PyTorch port: stragglers,
8-bit sync, faults, resume, the event-driven engine and a hostile fleet.

    PYTHONPATH=src python examples/torch_ps_simulate.py
    PYTHONPATH=src python examples/torch_ps_simulate.py --device cpu

The port's counterpart of ``examples/ps_simulate.py``, in four acts at its
sizes (M=4, K=20, R=30, n=10); it imports nothing of JAX. Every engine
runs with the fused kernels (on the card; their plain versions on the
CPU):

1. LocalAdaSEG on the paper's §4.1 bilinear game through ``PSEngine`` in a
   hostile fleet: Dirichlet-heterogeneous worker data, a straggler
   schedule, per-round failures and 8-bit stochastically quantized uplinks
   with error feedback, killed mid-run (checkpointed and discarded) and
   resumed from disk;
2. the same fleet under a zoo baseline (LocalSEGDA as a ``MinimaxWorker``);
3. no barrier: ``AsyncPSEngine`` over simulated time with one Markov-slow
   worker and a τ=2 staleness bound, killed mid-event-queue and resumed
   bit for bit, beside the τ=0 barrier run of the same fleet;
4. 20% of a 10-worker fleet sign-flips its uplinks against a trimmed-mean
   server, killed and resumed mid-attack, beside the clean fleet and the
   attacked plain mean.

Two Perfetto timelines are written to ``--trace-dir`` (the script's
folder by default; open them at https://ui.perfetto.dev):
``perfetto_sync_wall.json``, the resumed synchronous run on the host wall
clock, and ``perfetto_async_sim.json``, the τ=2 run on the simulated
clock, one track per worker.
"""
import argparse
import dataclasses
import math
import os
import tempfile

import torch

from repro_torch import random as jr
from repro_torch.core import AdaSEGConfig
from repro_torch.obs import save_trace_events, validate_trace_events
from repro_torch.optim import MinimaxWorker, segda
from repro_torch.problems import make_bilinear_game
from repro_torch.ps import (
    AsyncPSConfig,
    AsyncPSEngine,
    BernoulliFaults,
    MarkovLatency,
    PSConfig,
    PSEngine,
    SignFlipAttack,
    StochasticQuantizeCompressor,
    StragglerSchedule,
    TrimmedMean,
    heterogeneous_bilinear,
)

M, K, R = 4, 20, 30
N = 10


def _bitwise(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--trace-dir", default=os.path.dirname(
        os.path.abspath(__file__)), help="where the Perfetto files go")
    args = ap.parse_args(argv)
    dev = args.device

    def key(seed):
        return jr.PRNGKey(seed, device=dev)

    game = make_bilinear_game(key(0), n=N, sigma=0.1, device=dev)
    problem = heterogeneous_bilinear(game, M, key(1), alpha=0.4)
    pscfg = PSConfig(
        adaseg=AdaSEGConfig(g0=1.0, diameter=math.sqrt(2 * N), alpha=1.0,
                            k=K),
        num_workers=M,
        rounds=R,
        schedule=StragglerSchedule(k=K, min_frac=0.5, seed=2,
                                   slow_workers=(3,)),
        compressor=StochasticQuantizeCompressor(bits=8),
        faults=BernoulliFaults(p=0.1, seed=3),
        backend="fused",
        codec_backend="fused",
    )

    def fresh():
        return PSEngine(problem, pscfg, rng=key(4), eval_fn=game.residual,
                        device=dev)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "engine.msgpack")
        engine = fresh()
        engine.run(until_round=R // 2, checkpoint_path=ckpt,
                   checkpoint_every=5)
        print(f"ran {engine.round}/{R} rounds, 'crashed'; "
              f"checkpoint at {os.path.basename(ckpt)}")
        engine = fresh().restore(ckpt)      # a new process, same config+seed
        zbar = engine.run()

    res = float(game.residual(zbar))
    tr = engine.trace                       # covers the resumed half
    print(f"resumed and finished at round {engine.round}")
    print(f"KKT residual:  {res:.4f}")
    print(f"since resume:  {tr.total_steps} local steps "
          f"(ideal {M * K * (R - R // 2)}: stragglers and faults ate the "
          f"rest)")
    print(f"throughput:    {tr.steps_per_sec:,.0f} local steps/sec")
    print(f"bytes up:      {tr.total_bytes_up:,.0f} "
          f"(dense would be {tr.total_bytes_down:,.0f}, like the downlink)")
    for r in tr.rounds[:3]:
        print(f"  round {r.round:2d}: K={r.local_steps} alive={r.alive} "
              f"η∈[{r.eta_min:.3f},{r.eta_max:.3f}] res={r.residual:.4f}")

    # The same fleet and policies: a Fig. 4 baseline through the engine.
    zoo_cfg = dataclasses.replace(
        pscfg, adaseg=None, backend="reference",
        worker=MinimaxWorker(segda(0.05)), local_k=K)
    baseline = PSEngine(problem, zoo_cfg, rng=key(4), eval_fn=game.residual,
                        device=dev)
    res_zoo = float(game.residual(baseline.run()))
    print(f"\nsame hostile fleet, LocalSEGDA (uniform averaging): "
          f"residual {res_zoo:.4f} vs LocalAdaSEG {res:.4f} "
          f"at {baseline.trace.steps_per_sec:,.0f} steps/sec")

    out = os.path.join(args.trace_dir, "perfetto_sync_wall.json")
    validate_trace_events(save_trace_events(out, engine.tracer, clock="wall"))
    print(f"wall-clock Perfetto trace -> {out} "
          f"({len(engine.tracer.spans)} spans; open at ui.perfetto.dev)")

    async_demo(game, problem, key, dev, args.trace_dir)
    hostile_demo(game, key, dev)


def async_demo(game, problem, key, dev, trace_dir):
    """No barrier: the event-driven engine over simulated time, one
    Markov-slow worker, τ=2, and a kill mid-event-queue with a bit-exact
    resume."""
    acfg = AsyncPSConfig(
        adaseg=AdaSEGConfig(g0=1.0, diameter=math.sqrt(2 * N), alpha=1.0,
                            k=K),
        num_workers=M,
        rounds=R,
        latency=MarkovLatency(step_s=1.0, slow_factor=8.0, p_slow=0.05,
                              p_recover=0.25, up_s=0.2, down_s=0.1,
                              seed=6, start_slow=(3,)),
        staleness_bound=2.0,
        backend="fused",
        codec_backend="fused",
    )

    def fresh(cfg=acfg):
        return AsyncPSEngine(problem, cfg, rng=key(4), eval_fn=game.residual,
                             device=dev)

    reference = fresh()
    z_ref = reference.run()                # the uninterrupted timeline
    out = os.path.join(trace_dir, "perfetto_async_sim.json")
    validate_trace_events(save_trace_events(out, reference.tracer,
                                            clock="sim"))
    print(f"\nsim-clock Perfetto trace -> {out} "
          f"({len(reference.tracer.spans)} spans on "
          f"{len(reference.tracer.tracks())} tracks)")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "async_engine.msgpack")
        engine = fresh()
        engine.run(until_time=reference.sim_time / 2)
        engine.save(ckpt)
        print(f"\n-- async: 'crashed' at simulated t={engine.sim_time:.1f}s "
              f"({engine.n_admissions} admissions in the books)")
        engine = fresh().restore(ckpt)     # the event queue, from disk
        zbar = engine.run()

    tr = engine.trace
    print(f"-- async: resumed to completion at t={engine.sim_time:.1f}s, "
          f"bit-exact with the uninterrupted run: {_bitwise(z_ref, zbar)}")
    print(f"   residual {float(game.residual(zbar)):.4f}, "
          f"fleet idle {engine.idle_fraction():.1%}, "
          f"max admitted staleness {tr.max_staleness} rounds")
    for r in tr.rounds[:3]:
        stale = [s if s is not None else "-" for s in r.staleness]
        print(f"   t={r.sim_time_s:7.2f}s  admitted="
              f"{[i for i, a in enumerate(r.alive) if a]} "
              f"staleness={stale} res={r.residual:.4f}")
    barrier = fresh(dataclasses.replace(acfg, staleness_bound=0.0))
    barrier.run()
    target = barrier.trace.summary()["final_residual"]
    # the resumed engine's trace covers the second half only; the
    # reference run holds the whole residual-against-time curve
    ttt = reference.trace.time_to_residual(target)
    if ttt is not None:
        print(f"   τ=2 reached the barrier run's final residual at "
              f"t={ttt:.1f}s vs the barrier's t={barrier.sim_time:.1f}s")
    else:
        print(f"   barrier baseline finished at t={barrier.sim_time:.1f}s "
              f"with residual {target:.4f}")


def hostile_demo(game, key, dev):
    """20% sign-flip uplinks against a trimmed-mean server, killed and
    resumed mid-attack: the attack table re-derives from its seed like
    every other policy."""
    m, rounds, k = 10, 12, 4
    byz = SignFlipAttack(fraction=0.2, scale=8.0, seed=11)
    robust_cfg = PSConfig(
        adaseg=AdaSEGConfig(g0=1.0, diameter=math.sqrt(2 * N), alpha=1.0,
                            k=k),
        num_workers=m, rounds=rounds, byzantine=byz,
        aggregator=TrimmedMean(beta=0.2), backend="fused",
        codec_backend="fused",
    )

    def fresh(cfg):
        return PSEngine(game.problem, cfg, rng=key(4), eval_fn=game.residual,
                        device=dev)

    z_ref = fresh(robust_cfg).run()        # the uninterrupted hostile run
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "hostile_engine.msgpack")
        engine = fresh(robust_cfg)
        engine.run(until_round=rounds // 2)
        engine.save(ckpt)
        attacked = sum(len(r.byzantine_workers) for r in engine.trace.rounds)
        print(f"\n-- hostile: 'crashed' at round {engine.round} with "
              f"{attacked} corrupted uplinks already admitted ({byz.name})")
        engine = fresh(robust_cfg).restore(ckpt)
        zbar = engine.run()

    res_robust = float(game.residual(zbar))
    print(f"-- hostile: resumed mid-attack, bit-exact with the "
          f"uninterrupted run: {_bitwise(z_ref, zbar)}")
    clean = fresh(dataclasses.replace(robust_cfg, byzantine=None,
                                      aggregator=None))
    res_clean = float(game.residual(clean.run()))
    mean = fresh(dataclasses.replace(robust_cfg, aggregator=None))
    res_mean = float(game.residual(mean.run()))
    print(f"   residuals: clean fleet {res_clean:.4f} | attacked, "
          f"trimmed-mean {res_robust:.4f} ({res_robust / res_clean:.2f}x) | "
          f"attacked, plain mean {res_mean:.4f} "
          f"({res_mean / res_clean:.2f}x)")
    last = engine.trace.rounds[-1]
    print(f"   final round corrupted workers: {last.byzantine_workers}, "
          f"server rejecting {engine.aggregator.reject_frac(m):.0%} of "
          f"lanes per coordinate")


if __name__ == "__main__":
    main()
