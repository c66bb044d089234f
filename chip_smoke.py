#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card. It imports
nothing of JAX. Phases, one JSON line each:

1. device — requires CUDA, prints the card's name and power limit as
   ``nvidia-smi`` reports them, and pins f32 matrix products to full
   precision (no TF32);
2. build  — compiles every ``src/repro_torch/csrc/*.cu`` with nvcc (one
   process per source, all together) and loads them;
3. kernels — holds each CUDA kernel against its plain PyTorch version on
   the same inputs, at the main path's shapes (64, 16384) and at a ragged
   (64, 16421) with a box(0.25, 1.0) projection, and times both with CUDA
   events over inputs that do not fit in L2;
4. main path — the bilinear game at n=16384 (``game``: with the oracle
   GEMM and the noise draw timed alone) through ``PSEngine`` with M=64
   workers, K=50 local steps, R=5 rounds, fused step and merge kernels
   (``main``); the residual must be finite and fall, every kernel of the
   path must have launched, and the reference backend's residual trace
   must agree within rtol 1e-4. One-round warm-ups at G0=1 come first and
   record how far the backends drift there (``sensitivity``); ``breakdown``
   splits the fused ms per local step into its parts;
5. l2 — the same game on an l2 ball for R=2, which must run through
   ``adaseg_finish``.

Then it prints the per-kernel JSON line and, last, ``{"ok": true, "device":
...}``. Any failed check raises, so the script exits non-zero and prints no
result line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 (non-tensor-core) peak.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

N, M, K, R = 16384, 64, 50, 5
N_RAGGED = 16421
# G0 is the method's guess of the gradient bound G; for this game
# G ≈ ‖A‖₂·√n ≈ 1.15·n. With G0 = 1 the first steps are ~10⁴ times the
# Lipschitz step and ulp-level differences between any two implementations
# grow to ~1e-3 of the residual within a round.
G0 = float(N)
DIAMETER = math.sqrt(2 * N)
TOL_ELEM = 1e-6      # elementwise outputs; FMA contraction in the kernels
TOL_STAT = 1e-5      # per-worker sums; the kernels sum in another order
TOL_TRACE = 1e-4     # fused vs reference residual trace


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def time_ms(fn, reps: int = 24, trials: int = 11) -> float:
    """Median over ``trials`` of the CUDA-event time of ``reps`` eager
    calls, per call, after a warm-up (host overhead included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(calls, trials: int = 11) -> float:
    """Device time per call: ``calls`` (zero-argument functions) captured
    once in a CUDA graph, replayed ``trials`` times; median per call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in calls:
            f()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def rel_err(a, b) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 still allowed")
    check(torch.get_float32_matmul_precision() == "highest",
          "f32 matmul precision is not 'highest'")
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    return smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    seconds = _build.build()
    for src in seconds:
        _build.library(src)
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         per_source={k: round(v, 3) for k, v in seconds.items()})


def phase_kernels():
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.adaseg_update import kernel as ak
    from repro_torch.kernels.adaseg_update import ref as ar
    from repro_torch.kernels.sync_compress import kernel as sk
    from repro_torch.kernels.sync_compress import ref as sr

    dev = torch.device("cuda")
    tiles = (N + ak.TILE - 1) // ak.TILE

    def inputs(seed, n):
        gen = torch.Generator(device=dev).manual_seed(seed)

        def u(*shape, lo=-1.0, hi=1.0):
            return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo

        w = u(M, lo=0.1, hi=2.0)
        return dict(z=u(M, n), zt=u(M, n), a=u(M, n, lo=-30, hi=30),
                    b=u(M, n, lo=-30, hi=30), sum_sq=u(M, lo=1e2, hi=1e4),
                    s_t=u(M, lo=0.5, hi=1.0), s_l=u(M, lo=0.5, hi=1.0),
                    w=w / w.sum(),
                    out=torch.empty(M, n, device=dev),
                    out2=torch.empty(M, n, device=dev),
                    part=torch.empty(M, tiles, 2, device=dev))

    def box_kw(box):
        return dict(lo=box[0], hi=box[1])

    def ptr(x, *names):
        return [x[k].data_ptr() for k in names]

    def stream(x):
        return _build.stream_of(x["z"])

    # Each case: the wrapper call (checked against the plain version) and
    # the bare launch with preallocated outputs (timed), box [-1, 1].
    cases = {
        "adaseg_explore": dict(
            src="src/repro_torch/csrc/adaseg_update.cu",
            replaces="src/repro/kernels/adaseg_update/kernel.py:176",
            # read z*, m, sum_sq; write z_t and (M, tiles, 2) partials
            bytes=4 * (3 * M * N + M + 2 * M * tiles), flops=6 * M * N,
            run=lambda x, box, f: f(x["z"], x["a"], sum_sq=x["sum_sq"],
                                    g0=G0, d_alpha=DIAMETER, **box_kw(box)),
            launch=lambda x: ak.EXPLORE(
                *ptr(x, "z", "a", "sum_sq", "out", "part"), M, N, ak.TILE,
                1, 1, G0 ** 2, DIAMETER, 1, -1.0, 1.0, 0, stream(x)),
            kernel=ak.adaseg_explore, plain=ar.adaseg_explore_ref),
        "adaseg_anchor": dict(
            src="src/repro_torch/csrc/adaseg_update.cu",
            replaces="src/repro/kernels/adaseg_update/kernel.py:206",
            # read z*, z_t, g, sum_sq; write z~ and (M, tiles, 2) partials
            bytes=4 * (4 * M * N + M + 2 * M * tiles), flops=11 * M * N,
            run=lambda x, box, f: f(x["z"], x["zt"], x["a"],
                                    sum_sq=x["sum_sq"], g0=G0,
                                    d_alpha=DIAMETER, **box_kw(box)),
            launch=lambda x: ak.ANCHOR(
                *ptr(x, "z", "zt", "a", "sum_sq", "out", "part"), M, N,
                ak.TILE, 1, 1, G0 ** 2, DIAMETER, 1, -1.0, 1.0, stream(x)),
            kernel=ak.adaseg_anchor, plain=ar.adaseg_anchor_ref),
        "adaseg_finish": dict(
            src="src/repro_torch/csrc/adaseg_update.cu",
            replaces="src/repro/kernels/adaseg_update/kernel.py:236",
            # read z*, raw_t, raw_l, s_t, s_l; write z_t, z~, (M, tiles)
            bytes=4 * (5 * M * N + 2 * M + M * tiles), flops=8 * M * N,
            run=lambda x, box, f: f(x["z"], x["a"], x["b"], x["s_t"],
                                    x["s_l"]),
            launch=lambda x: ak.FINISH(
                *ptr(x, "z", "a", "b", "s_t", "s_l", "out", "out2", "part"),
                M, N, ak.TILE, 1, stream(x)),
            kernel=ak.adaseg_finish, plain=ar.adaseg_finish_ref),
        "merge_stacked": dict(
            src="src/repro_torch/csrc/sync_compress.cu",
            replaces="src/repro/kernels/sync_compress/kernel.py:405",
            # read z, w; write the (M, n) broadcast
            bytes=4 * (2 * M * N + M), flops=2 * M * N,
            run=lambda x, box, f: f(x["z"], x["w"]),
            launch=lambda x: sk.MERGE(
                *ptr(x, "z", "w"), None, None, *ptr(x, "out"), M, N, 0, 1,
                stream(x)),
            kernel=sk.merge_stacked,
            plain=lambda z, w: sr.merge_ref(z, w)),
    }

    # Timing inputs: 12 sets of the main path's shape, cycled so the bytes
    # in flight exceed the 50 MB L2, as the main path finds them cold.
    sets = [inputs(100 + i, N) for i in range(12)]
    results = {}
    for name, c in cases.items():
        errs = []
        for n, box in ((N, (-1.0, 1.0)), (N_RAGGED, (0.25, 1.0))):
            x = inputs(1, n)
            got = c["run"](x, box, c["kernel"])
            want = c["run"](x, box, c["plain"])
            if name == "merge_stacked":
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            for gt, wt in zip(got, want):
                if gt.ndim == 2:                      # elementwise output
                    err = max_abs(gt, wt)
                    errs.append(err)
                    check(err <= TOL_ELEM,
                          f"{name} {tuple(gt.shape)}: max abs err {err}")
                else:                                 # per-worker sums
                    err = rel_err(gt, wt)
                    check(err <= TOL_STAT,
                          f"{name} {tuple(gt.shape)} stats: rel err {err}")
        box = (-1.0, 1.0)
        ms = graph_ms([lambda x=x: c["launch"](x) for x in sets * 2])
        plain_ms = graph_ms([lambda x=x: c["run"](x, box, c["plain"])
                             for x in sets * 2])
        it = iter(range(10 ** 9))
        wrapper_ms = time_ms(
            lambda: c["run"](sets[next(it) % len(sets)], box, c["kernel"]))
        b_ms, b_by = bound(c["bytes"], c["flops"])
        results[name] = dict(
            name=name, route="cuda", source=c["src"], replaces=c["replaces"],
            launches=0, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        )
        emit("kernel", **results[name], wrapper_eager_ms=wrapper_ms,
             gb_per_s=c["bytes"] / (ms * 1e-3) / 1e9)
    return results


def reset_launches():
    from repro_torch.kernels import _build

    for k in _build.KERNELS:
        k.launches = 0


def launches():
    from repro_torch.kernels import _build

    return {k.name: k.launches for k in _build.KERNELS}


def run_engine(game, problem, backend, rounds, g0=G0):
    import torch

    from repro_torch import random as jr
    from repro_torch.core import AdaSEGConfig
    from repro_torch.ps import PSConfig, PSEngine

    cfg = AdaSEGConfig(g0=g0, diameter=DIAMETER, k=K)
    eng = PSEngine(problem, PSConfig(adaseg=cfg, num_workers=M,
                                     rounds=rounds, backend=backend,
                                     codec_backend=backend),
                   rng=jr.PRNGKey(1), eval_fn=game.residual)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zbar = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = [r.residual for r in eng.trace.rounds]
    check(all(v is not None and math.isfinite(v) for v in res),
          f"{backend}: non-finite residual {res}")
    check(all(tuple(v.shape) == (N,) and bool(torch.isfinite(v).all())
              for v in zbar), f"{backend}: bad output iterate")
    return res, wall * 1e3 / (rounds * K)


def phase_main(results):
    import torch

    from repro_torch import random as jr
    from repro_torch.core import projections
    from repro_torch.problems import make_bilinear_game

    t0 = time.perf_counter()
    game = make_bilinear_game(jr.PRNGKey(0), n=N, sigma=0.1)
    torch.cuda.synchronize()
    y = torch.rand(M, N, device="cuda")
    gemm_ms = graph_ms([lambda: y @ game.a.T] * 4)
    emit("game", n=N, seconds=time.perf_counter() - t0,
         a_bytes=game.a.numel() * 4, oracle_gemm_ms=gemm_ms,
         oracle_gemm_tflops=2 * M * N * N / (gemm_ms * 1e-3) / 1e12)

    keys = jr.split(jr.PRNGKey(3), M)
    noise_ms = time_ms(lambda: game.problem.sample(keys))
    split_ms = time_ms(lambda: jr.split(keys))

    # Warm-up (cuBLAS, allocator) so neither timed run pays first-call
    # costs; at G0 = 1 it also shows how far ulp-level differences between
    # the backends grow in one round when the first steps are far beyond
    # the Lipschitz step (recorded, not checked).
    warm_f, _ = run_engine(game, game.problem, "fused", 1, g0=1.0)
    warm_r, _ = run_engine(game, game.problem, "reference", 1, g0=1.0)
    emit("sensitivity", g0=1.0, rounds=1, fused=warm_f, reference=warm_r,
         max_rel=abs(warm_f[0] - warm_r[0]) / abs(warm_r[0]))

    reset_launches()
    res_f, ms_f = run_engine(game, game.problem, "fused", R)
    main_launches = launches()
    check(res_f[-1] < res_f[0], f"residual did not fall: {res_f}")
    for name in ("adaseg_explore", "adaseg_anchor", "merge_stacked"):
        check(main_launches[name] > 0, f"{name} never launched on the path")
        results[name]["launches"] = main_launches[name]
    emit("main", backend="fused", residuals=res_f, ms_per_local_step=ms_f,
         launches=main_launches)
    # Per local step: two oracle calls of two GEMMs each, two noise draws,
    # one key split, explore + anchor on both leaves; the rest is the other
    # elementwise ops and host dispatch.
    parts = dict(
        oracle_gemms=4 * gemm_ms, noise_draws=2 * noise_ms,
        key_split=split_ms,
        update_kernels=2 * (results["adaseg_explore"]["ms"]
                            + results["adaseg_anchor"]["ms"]))
    emit("breakdown", ms_per_local_step=ms_f, **parts,
         rest=ms_f - sum(parts.values()))

    res_r, ms_r = run_engine(game, game.problem, "reference", R)
    rel = max(abs(a - b) / abs(b) for a, b in zip(res_f, res_r))
    emit("main", backend="reference", residuals=res_r,
         ms_per_local_step=ms_r, max_rel_vs_fused=rel)
    check(rel <= TOL_TRACE, f"fused vs reference residuals differ by {rel}")

    radius = 0.5 * DIAMETER
    l2 = dataclasses.replace(game.problem,
                             project=projections.l2_ball(radius))
    reset_launches()
    res_l2, ms_l2 = run_engine(game, l2, "fused", 2)
    l2_launches = launches()
    check(l2_launches["adaseg_finish"] > 0, "adaseg_finish never launched")
    results["adaseg_finish"]["launches"] = l2_launches["adaseg_finish"]
    emit("l2", radius=radius, residuals=res_l2, ms_per_local_step=ms_l2,
         launches=l2_launches)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    phase_device()
    phase_build()
    results = phase_kernels()
    phase_main(results)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
