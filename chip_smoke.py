#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --sync-wrappers   # only the sync wrappers' times
    python3 chip_smoke.py --zoo             # only the zoo phase (no result)
    python3 chip_smoke.py --fleet-rows      # only fleet_rows (no result)
    python3 chip_smoke.py --wgan            # only the wgan phase (no result)
    python3 chip_smoke.py --async           # only the async phase (no result)
    python3 chip_smoke.py --sampled         # only the sampled phase (no result)
    python3 chip_smoke.py --flash           # only flash_kernels (no result)
    python3 chip_smoke.py --moe             # only the moe phases (no result)
    python3 chip_smoke.py --rg              # only the rg phases (no result)
    python3 chip_smoke.py --kernels         # only B1-B5's kernel lines
    python3 chip_smoke.py --sync-bits OUT   # the sync wrappers' outputs
    python3 chip_smoke.py --compare-bits A B  # two such files, to the bit

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
   events over inputs that do not fit in L2. The one-shot update (B4) is
   held in its box mode, in its l2 raw-norms mode and with eta given as
   well as fused. The four codec uplink kernels
   (scale, quantize, eff, mask) must match their plain versions exactly,
   with and without aliveness (one dead worker); the merge kernel is also
   held and timed on its gated branch (``recv``/``old``, ``kernel_case``).
   Where one PyTorch call computes a kernel's function (the merge's
   ungated broadcast: ``torch.matmul(w.expand(M, M), z)``; eff:
   ``torch.addcmul``; flash attention: ``scaled_dot_product_attention``),
   it is timed beside the kernel as a yardstick only, in two like-for-like
   pairings: into a fresh output (``library_ms``) against the kernel
   through its wrapper, which makes its own output, in the same kind of
   CUDA graph (``wrapper_graph_ms``); and into the kernel's own
   preallocated outputs (``library_same_out_ms``) against the bare launch
   into them (``ms``). A ``fresh_outputs`` line says whether the fresh
   outputs inside each capture share one block (``--kernels`` runs only
   this phase, whose launchers a parent tree shares, so two trees' B1-B5
   can be timed in one call). ``merge_shapes`` holds the
   merge at M in {1, 4, 63, 64} x n in {16384, 16421}, unit weights,
   normalised and gated, reruns bit-identical; ``merge_fleet`` at M = 16384
   (its weights in the opt-in shared memory); ``merge_lm_leaf`` times it
   and the matmul at the lm path's largest leaf, (4, 151936 x 896).
   ``fleet_rows`` holds the update kernels B1-B4 and the sync kernels
   B5-B10 at a fleet of 70000 workers, n = 4096 (past the 65535 rows a
   grid's y dimension takes): B1 and B2 within 1.49e-7, B3 exactly, B4
   bit-identical to B1 then B2; the uplink kernels exactly, with a dead
   row past 65535; B5 (its weights read from global memory past the
   opt-in shared memory) and B10's streamed path (its plain version on 64
   of the columns) at 1e-5, each rerun bit-identical; every launch timed.
   ``--sync-bits`` saves B1-B10's outputs on fixed inputs (B1-B4 at (64,
   16384), (64, 16421) and (4, 16421)), so two trees' kernels can be held
   to the bit with ``--compare-bits``. The
   scale pass (B6) is also held and timed at that leaf (a ``kernel`` line
   with its ``shape``). Beside B6 and the outer step (B11), whose small
   shapes take little more than a launch, ``launch_floor_ms`` is the time
   of an empty kernel on the same grid, in the same harness, with the same
   number of launches;
4. main path — the bilinear game at n=16384 (``game``: with the oracle
   GEMM and the noise draw timed alone) through ``PSEngine`` with M=64
   workers, K=50 local steps, R=5 rounds, fused step and merge kernels
   (``main``); the residual must be finite and fall, every kernel of the
   path must have launched, and the reference backend's residual trace
   must agree within rtol 1e-4. One-round warm-ups at G0=1 come first and
   record how far the backends drift there (``sensitivity``); ``breakdown``
   splits the fused ms per local step into its parts; then ``one_shot``
   gives one local step's M_t and g_t on the fleet's state to
   ``adaseg_tree_update`` (B4, counted) and to B1 then B2, which must
   agree;
5. l2 — the same game on an l2 ball for R=2, which must run through
   ``adaseg_finish``;
6. codec — the same game through the compressed, fault-tolerant sync:
   stragglers (K ~ U{25..50}), 10% Bernoulli worker faults, R=5, with
   8-bit stochastic quantization (``q8``) and with top-25% (``top25``),
   both under error feedback; each under the fused and the reference
   backends. The residual must be finite and fall, each codec's kernels
   must have launched, the two backends' residual traces must agree within
   rtol 1e-4, and the uplink's time per sync is reported beside the
   round's wall time;
7. robust — the same game with a hostile fleet and the server's outer
   optimizer (``robust_kernels`` first holds the robust merge and the outer
   step against their plain versions, ties and a dead row included, the
   merge's reruns bit-identical; its fleets from 256 to 10000 workers in
   ``trimmed_fleets``, past 1350 on the streamed path; its two paths forced
   at M = 64 and 1350, bit-identical (``trimmed_paths``); the streamed path
   timed at (2048, 16384) and (10000, 16384); the outer step also at the
   embedding leaf (1, 151936 x 896); then ``wrapper`` lines time the sync
   wrappers as a caller pays for them, each call making its own outputs in
   a CUDA graph -- ``--sync-wrappers`` runs only these, after the device
   and build phases, and prints no result line, so that a tree whose
   kernels take other arguments can be timed by this script): a
   sign-flip attack on 20% of the fleet under the plain mean, a trimmed
   mean, the coordinate median and multi-Krum; a clean fleet under outer
   Nesterov and outer Adam; and everything stacked (attack, DP, q8 with
   error feedback, faults, trimmed mean, Nesterov). Each runs on the fused
   and the reference backends, which must agree within rtol 1e-4; the
   median must end below the plain mean; the robust merge and the outer
   step must have launched where they run; ``robust_final`` gives the
   trimmed, median and stack cells' final residuals in hex, to compare two
   trees to the bit. Then a fused trimmed+Nesterov
   run is checkpointed at round 2, restored into a new engine and run on,
   and must equal the uninterrupted run bit for bit; then ``async``: the
   event-driven engine (``AsyncPSEngine``) on the same game and fleet with
   ``benchmarks/bench_async.py``'s one 6x straggler (63 workers at 1 s a
   local step, one at 6 s, uplink 0.2 s, downlink 0.1 s), R=5: tau=0 fused
   (every admission the whole fleet, through the sync engine's round
   chunk), bit-identical to ``PSEngine``; tau=2 fused and reference, whose
   residual traces agree within rtol 1e-4 and host records exactly, with a
   fused rerun, a run killed at admission 4, saved, restored and finished,
   and a run with spans and metrics off, each bit-identical; tau=inf
   fused; the simulated time, time-to-target against tau=0's final
   residual (reported, not gated), idle fraction, largest staleness,
   admissions, wall s per admission, ms per phase batch and launches;
   then at tau=2, R=3, q8 with error feedback, a 20% sign-flip attack
   under a trimmed mean, and outer Nesterov, each launching its kernels
   (B1, B2 on every phase step; B5 at tau=0; B6, B7; B10; B11);
   ``python3 chip_smoke.py --async`` runs only this phase;
8. zoo — the paper's Fig. 4 comparison on the same game (``zoo_setup``:
   ‖A‖₂ by 30 power iterations; SGDA and SEGDA take lr = 1/(2‖A‖₂), Adam
   0.02, UMP and ASMP G₀ = n, D = √(2n)): LocalAdaSEG and the five zoo
   methods as ``MinimaxWorker``s, ``clean`` (iid, uniform K, no faults)
   and ``hostile`` (Dirichlet-heterogeneous workers at α = 0.4, elastic
   stragglers, q8 with error feedback, 10% faults), R=5, fused and
   reference, which must agree within rtol 1e-4 every round; residuals,
   ms per local step and bytes up per round; the merge kernel must launch
   on every fused engine, the q8 kernels under ``hostile``, and the
   adaptive methods' residuals must fall under ``clean``. Then the
   robust row: heterogeneous robust logistic regression at LIBSVM a9a's
   widths (32561 × 123, batch 128), LocalAdaSEG and the five methods,
   K=5, R=2, evaluated by ``kkt_residual``, fused and reference, and a
   rerun of UMP that must repeat to the bit (``zoo_rerun``); then ``wgan``,
   the paper's §5 comparison: WGAN-GP at its full default width (hidden
   64, batch 64) as a ``ModelWorker`` on ``PSEngine`` with M=64, K=20,
   R=20 (bench_wgan.py runs 40), homogeneous and ``heterogeneous_wgan``
   (alpha 0.6), fused, reference and fused under q8, beside
   ``benchmarks/bench_wgan.py``'s
   baselines MB-UMP and MB-ASMP (``run_serial`` on a minibatch of M) and
   LocalAdam (lr 2e-3, ``PSEngine``): W-estimates and moment distances
   every 10 rounds and ms per local step, every value finite, B1, B2 and
   B5 (B6 and B7 under q8) launched, fused vs reference W-estimates within
   ``TOL_WGAN_TRACE`` over the first 10 rounds (recorded after), a fused
   rerun and a run with spans and metrics off, of 10 rounds each,
   bit-identical to the first run's first 10 rounds,
   the Perfetto export valid and the metrics' bytes up equal to the
   trace's (``wgan_checks``);
9. flash_kernels — the flash-attention kernel (B12) against its plain
   PyTorch version on unit-normal inputs, within 2e-5: the language-model
   path's shape (B=1, H=14, Kh=2, S=T=1024, D=64, causal), a sliding
   window of 256, a soft cap of 50, D=128, S=1000 (a ragged tile),
   granite's H=16 over Kh=8, and recurrentgemma's head dim 256 with H=16
   over Kh=1 under its window of 2048, at S=1024 (its path, where the
   window does not bind) and at S=4096 (``rg_d256``, ``rg_d256_window``),
   reruns bit-identical; timed beside its plain version and, at every
   variant without a soft cap, ``scaled_dot_product_attention`` (f32, no
   TF32, a binding window as a boolean mask; a yardstick only, the port
   never calls it; it has no ``out=`` form, so only the fresh-output
   pairing). ``bound_ms`` is the faster of
   the card's two routes to f32-accurate products: the split product on
   the tensor cores (three TF32 terms at the dense TF32 peak, beside the
   exponentials on the MUFU and the bytes), which is always below the f32
   FMAs' bound;
10. ssd_kernels — the SSD scan kernel (B13) against its plain version (the
   kernels' chunked arithmetic) within TOL_SSD and against the sequential
   recurrence within TOL_SSD_ORACLE (max abs error over the largest |y|),
   reruns bit-identical: the mamba2 path's shape (B=1, L=1024, H=32, P=64,
   N=128, chunk 128, mamba2's a), chunk 64, B=2 (b and c shared by the
   heads of each batch row) and the smoke config's P=16, N=16, chunk 8,
   each also on x, b and c as strided views of one packed tensor, as the
   model hands them in, and of one packed a float off 16-byte alignment
   (4-byte copies), both bit-identical to the contiguous call; each of the
   three launches the call makes (``cb_state``: C·Bᵀ, the prefix sums and
   the chunk states; ``state_pass``; ``chunk_scan``) is held against the
   plain versions of its phases (``ref.py``) within TOL_SSD_PHASE, fed
   what the earlier launches wrote, and timed alone (``kernel_phase``);
   the whole call is timed beside its plain version, the Pallas kernel's
   chunk loop (no PyTorch call computes the scan);
11. lm — qwen2-0.5b at full width (24 layers, d_model 896, vocab 151936)
   with the flash kernel on, trained through the port's ``make_ps_engine``
   with M=4 workers, per-worker batch 1 × 1024 tokens, K=4, R=2, on the
   fused and the reference backends (identity codec). The eval loss must
   be finite, the two backends' loss traces must agree within 1e-3, and
   the flash kernel must launch 24 times per forward; the peak device
   memory, ms per local step and its breakdown (token draws, forward and
   backward, update kernels, sync, eval) are reported. ``lm_step_diff``
   takes one update from the fused run's final state through B1 and B2
   and through the reference backend's ops and reports, leaf by leaf, the
   entries that differ, by how much, and whether B1 rounds z* − η·g once;
   the merge kernel against the reference's mean; the eval loss after
   each update. A narrow
   qwen2-shaped model (head_dim 64) runs the same engine on the card and
   on the CPU's plain versions, whose loss traces must agree within 1e-4
   (``lm_small``);
12. mamba2 — mamba2-370m at full width (48 layers, d_model 1024, 32 heads
   of P=64, N=128, chunk 128, vocab 50280) with the SSD scan kernel on
   (``ssm_backend="pallas"``), through the same engine and settings as
   ``lm``: finite eval losses, fused vs reference within 1e-3, B13 launched
   48 times per forward, B1, B2 and B5 launched, the peak memory within
   budget, ms per local step and its breakdown, ``mamba2_step_diff``, and
   estimates of the SSD mixer's share of a step from isolated timings
   (``mamba2_ssd``: B13's µs per launch and the chunked version's gradient
   at one layer's shape, each times the step's calls); then mamba2's
   smoke config on the card against the CPU
   within 1e-4 (``mamba2_small``);
13. sampled (after ``async``) — sampled-client rounds (A13) on the main
   game, ``benchmarks/bench_fleet.py``'s fleet of 10000 drawing 64 a round
   (``ClientSampler(64, seed=3)``), K=50. ``full64``: sample == fleet ==
   64, fused, R=2, bit-identical to ``PSEngine`` without a sampler (whose
   ms per local step is printed beside the sampled run's). ``fleet10000``:
   fused, R=5, the residual finite and falling, B1 and B2 launched 500
   times and B5 10 (as in ``main``), the fleet's init seconds and its
   transient peak memory, the run's peak, the gather's and the scatter's
   ms per round (``gather_rows``/``scatter_rows_`` on the store, alone);
   the same run round by round, in which the store rows of every undrawn
   worker must be bit-identical before and after each round, saved after
   round 2 and ending bit-identical to the first run; a restore of that
   checkpoint finished bit-identical; the reference backend within
   TOL_TRACE. ``stack``: R=3, q8 with error feedback, 10% faults, a 20%
   sign-flip attack under a trimmed mean and outer Nesterov, fused (B6,
   B7, B10, B11 launched, and B5 once a leaf, counted from the engine's
   start: the outer optimizer's initial anchor over the whole store) and
   reference within TOL_TRACE, every attacker inside its round's draw,
   one outer step a round. ``async512``:
   ``AsyncPSEngine`` on a fleet of 512 drawing 64, ConstantLatency(1,
   0.2, 0.1), R=5: tau=inf fused; tau=2 fused and reference (host records
   and the clock equal, residuals within TOL_TRACE), a rerun and a resume
   from mid-queue bit-identical; Σ local_steps = R·S·K in each.
   ``python3 chip_smoke.py --sampled`` runs only this phase;
14. moe (after ``mamba2``) — granite-moe-1b-a400m at its published widths
   and depth (24 blocks of global causal GQA attention, 16:8 heads of 64,
   then an MoE MLP of 32 experts top-8 at capacity factor 1.25, SiLU;
   d_model 1024, vocab 49155; 1.33 G parameters a worker) with the flash
   kernel, through the same engine and settings as ``lm`` at the fleets
   that fit the memory budget. ``moe``: M=2, fused; finite eval losses and
   z̄, B12 launched 24 times a forward (816), B1, B2 and B5 launched, the
   peak within budget, ms per local step, tokens per second and the
   breakdown (``moe_breakdown``); ``moe_drops`` the share of routed
   choices dropped at capacity, per layer of one forward, at initial
   parameters and at z̄ on the eval batch, and at worker 0's z̃ on its
   draw. ``moe_rerun``: a second
   oracle call at the same z and ξ, every gradient leaf bit-identical (the
   dispatch and combine carry no atomics). ``moe_compare``: fused and
   reference at M=1 (``moe_compare_run`` lines, each peak within budget),
   eval losses within TOL_LM_TRACE, and ``moe_compare_step_diff``'s
   per-leaf rows for the fused run. ``moe_small``: granite's smoke config
   (2 layers, d_model 256, 4 experts top-2, head dim 64) card against CPU
   within TOL_LM_SMALL at 128 tokens, then at capacity factor 1.25
   (``moe_small_drops``), where choices are dropped on both.
   ``python3 chip_smoke.py --moe`` runs only this phase;
15. rg (after ``moe``) — recurrentgemma-9b at its published widths
   (d_model 4096, d_rnn 4096, 16:1 heads of 256, window 2048, GeGLU d_ff
   12288, vocab 256000 tied, scaled embedding) cut to 5 of its 38 layers:
   one (rglru, rglru, local attention) period as the stacked group and the
   two-layer rglru tail (2.17 G parameters, 8.70 GB a worker), with the
   flash kernel, through the same engine and settings as ``lm`` at M=1,
   fused and reference (``rg`` lines): finite eval losses and z̄, B12
   launched once a forward (18 a run), B1, B2 and B5 launched, each peak
   within budget, fused vs reference within TOL_LM_TRACE (``rg_compare``),
   ms per local step, tokens per second, ``rg_breakdown`` and
   ``rg_step_diff`` for the fused run. ``rg_rerun``: a second oracle call
   at the same z and ξ, every gradient leaf bit-identical (the RG-LRU's
   scan and conv). ``rg_small``: the smoke config (3 layers, head dim 64,
   window 8) card against CPU within TOL_LM_SMALL at 128 tokens, where
   the window binds. ``python3 chip_smoke.py --rg`` runs only this phase.

Then it prints the per-kernel JSON line and, last, ``{"ok": true, "device":
...}``. Any failed check raises, so the script exits non-zero and prints no
result line.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: f32 (non-tensor-core) peak and dense TF32
# tensor-core peak; the HBM3 bandwidth is the package's
# (repro_torch.hardware.HBM_BW, set in CARD by main).
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
# f32 instructions that are not FMAs (compares, selects, adds): 128 lanes per
# SM per clock, times the SMs and the maximum SM clock (set by the device
# phase).
F32_LANES_PER_SM_CLOCK = 128
# int32 throughput: 64 lanes per SM per clock (Hopper's integer pipes) times
# the SMs times the maximum SM clock nvidia-smi reports (set by the device
# phase).
INT32_LANES_PER_SM_CLOCK = 64
# exponentials (MUFU ex2): 16 per SM per clock
MUFU_PER_SM_CLOCK = 16
CARD = {"hbm_bytes_per_s": None, "int32_ops_per_s": None,
        "f32_issue_per_s": None, "mufu_per_s": None}
# Live int32 operations per element of the quantize kernel: 68 for
# threefry2x32 once the compiler drops what the first output word does not
# need (19 mixes of add, funnel shift and xor, the last mix's add, 9 key
# injections, the counter add), 2 for the uniform's mantissa (shift, or).
QUANTIZE_INT_OPS = 70

N, M, K, R = 16384, 64, 50, 5
N_RAGGED = 16421
# B5 is also held at these fleet sizes (the kernel splits 1 and 4 rows
# otherwise than 63 and 64), and timed at the lm path's largest leaf:
# qwen2-0.5b's (151936, 896) embedding stacked over its M = 4 workers.
MERGE_ROWS = (1, 4, 63, 64)
LM_LEAF = (4, 151936 * 896)
# B5 past 12288 workers, and the robust merge (B10) on fleets of up to
# 10000 (``benchmarks/bench_fleet.py``'s largest), the streamed path past
# 1350; the streamed path timed at TRIMMED_TIMED x n.
MERGE_FLEET = (16384, 1031)
TRIMMED_FLEETS = {256: 9, 512: 10, 1350: 12, 1351: 13, 2048: 14, 10000: 15}
TRIMMED_TIMED = (2048, 10000)
# G0 is the method's guess of the gradient bound G; for this game
# G ≈ ‖A‖₂·√n ≈ 1.15·n. With G0 = 1 the first steps are ~10⁴ times the
# Lipschitz step and ulp-level differences between any two implementations
# grow to ~1e-3 of the residual within a round.
G0 = float(N)
DIAMETER = math.sqrt(2 * N)
TOL_ELEM = 1e-6      # elementwise outputs; FMA contraction in the kernels
TOL_STAT = 1e-5      # per-worker sums; the kernels sum in another order
TOL_TRACE = 1e-4     # fused vs reference residual trace
# Codec phase: stragglers and faults from fixed seeds.
CODEC_SCHEDULE = dict(k=K, min_frac=0.5, seed=5)
CODEC_FAULTS = dict(p=0.1, seed=3)
LEVELS = 255.0       # 8-bit stochastic quantization
DEAD_ROW = 3         # the dead worker of the uplink kernel checks
# Robust phase: the repo's hostile-fleet scenario (benchmarks/
# bench_fig4_scenarios.py, examples/ps_simulate.py).
ATTACK = dict(fraction=0.2, scale=8.0, seed=11)
TRIMS = (12, 31)     # TrimmedMean(0.2) and CoordinateMedian() at M = 64
# Operations per unordered rank pair of the robust merge, the least work:
# one compare of z_i and z_j settles both ranks (a tie goes to the lower
# row), and one add puts the pair's incl into the higher one's rank.
TRIM_PAIR_OPS = 2
TOL_REL_STAT = 1e-5  # the outer step's Σ Δ², summed in another order
# Zoo phase: the paper's Fig. 4 comparison (benchmarks/bench_fig4_scenarios.py
# :63-127) on the main game. Fig. 4's fixed rates are for n = 10 (‖A‖₂ ≈ 2);
# SGDA and SEGDA take 1/(2‖A‖₂) here, Adam keeps 0.02 (its step is scale-
# free per coordinate), UMP and ASMP take G0 = n and D = √(2n) as AdaSEG.
ZOO_POWER_ITERS = 30
ZOO_ADAM_LR = 0.02
HOSTILE = dict(alpha=0.4, key=7, schedule=dict(k=K, min_frac=0.5, seed=5,
                                               slow_workers=(3,)),
               dropout=0.15, dropout_seed=6, faults=dict(p=0.1, seed=3))
ADAPTIVE = ("adaseg", "ump", "asmp")
# The robust row: LIBSVM a9a's published widths (32561 examples of 123
# features), synthetic from the seed; batch 128, λ = 0.1, radius 5. Its
# depth is cut to K = 5: each heterogeneous draw is a Gumbel argmax over
# 64 × 128 × 32561 eager threefry uniforms (~0.3 s on an H100), so K = 50
# would take the row alone to ~10 minutes.
A9A = dict(n=32561, d=123, batch=128, lam=0.1, radius=5.0)
ROBUST_GROUPS, ROBUST_ROUNDS, ROBUST_K = 4, 2, 5
OUTER_SETS = 160     # (1, n) timing sets: 160 × 7 × 64 KiB > the 50 MB L2
# Flash attention (B12) at the language-model path's shape: qwen2-0.5b's
# 14 query heads over 2 KV heads, head_dim 64, one sequence of 1024.
FLASH_SHAPE = dict(b=1, h=14, kh=2, s=1024, d=64)
FLASH_VARIANTS = {
    "path": {},
    "window256": dict(window=256),
    "softcap50": dict(softcap=50.0),
    "d128": dict(d=128),
    "s1000": dict(s=1000),
    # granite's 16 query heads over 8 KV heads of 64, causal
    "granite": dict(h=16, kh=8),
    # recurrentgemma's 16 query heads over one KV head of 256 under its
    # window of 2048, as its path calls the kernel: at the path's sequence,
    # where the window does not bind, and at 4096, where it does
    "rg_d256": dict(h=16, kh=1, d=256, window=2048),
    "rg_d256_window": dict(h=16, kh=1, s=4096, d=256, window=2048),
}
TOL_FLASH = 2e-5     # max abs error on unit-normal inputs
# The lm phase: examples/train_lm.py's settings at qwen2-0.5b's full width.
LM_ARCH = "qwen2-0.5b"
LM_M, LM_BATCH, LM_SEQ, LM_K, LM_R = 4, 1, 1024, 4, 2
TOL_LM_TRACE = 1e-3  # fused vs reference eval-loss trace, relative
TOL_LM_SMALL = 1e-4  # card vs CPU eval-loss trace of the narrow model
LM_MEMORY_BUDGET = 70e9
# The SSD scan (B13) at the mamba2 path's shape: mamba2-370m's 32 heads of
# P=64, state N=128, chunk 128, one sequence of 1024; a = -exp(a_log) of
# its init, -linspace(1, 16, H).
SSD_SHAPE = dict(b=1, l=1024, h=32, p=64, n=128, q=128)
SSD_VARIANTS = {
    "path": {},
    "chunk64": dict(q=64),
    "batch2": dict(b=2),                          # b and c shared per batch
    "smoke": dict(l=128, p=16, n=16, q=8),        # mamba2's smoke config
}
# max abs err over the largest |y| (~330 at the path): against the plain
# version of the kernel's own arithmetic (sum order: the prefix sum and the
# 128-term dots), and against the sequential recurrence
TOL_SSD = 5e-5
TOL_SSD_ORACLE = 2e-4
# each launch of B13 against the plain versions of its phases fed the same
# inputs (what the earlier launches wrote): max abs error over the
# largest |entry|; f32 sums of at most 256 terms in another order
TOL_SSD_PHASE = 1e-5
MAMBA_ARCH = "mamba2-370m"
# The moe phase: granite-moe-1b-a400m at its published widths and depth
# (1.33 G parameters, 5.34 GB a worker in f32) with lm's settings, at the
# fleets that fit LM_MEMORY_BUDGET: M=2 fused, M=1 for fused against
# reference (whose tree temporaries take more); its smoke config at
# MOE_SMALL_SEQ tokens, also at capacity factor MOE_SMALL_CF, where the
# smoke config's 8.0 becomes the published 1.25 and choices are dropped.
MOE_ARCH = "granite-moe-1b-a400m"
MOE_M, MOE_COMPARE_M = 2, 1
MOE_SMALL_SEQ = 128
MOE_SMALL_CF = 1.25
# The rg phase: recurrentgemma-9b at its published widths (d_model 4096,
# d_rnn 4096, 16:1 heads of 256, window 2048, GeGLU d_ff 12288, vocab
# 256000 tied; 2.17 G parameters, 8.70 GB a worker at this depth) cut to
# RG_LAYERS of its 38 layers: one (rglru, rglru, local attention) period
# as the stacked group and the two-layer rglru tail, the full model's
# group-and-tail structure. M=1: a fused fleet takes ~5.5 copies of its
# parameters, so M=2 would pass LM_MEMORY_BUDGET. Its smoke config at
# RG_SMALL_SEQ tokens, where its window of 8 binds.
RG_ARCH = "recurrentgemma-9b"
RG_LAYERS, RG_M = 5, 1
RG_SMALL_SEQ = 128
# the layer kind that launches each model kernel once a forward
KERNEL_KIND = {"flash_attention": "attn", "ssd_scan": "ssm"}
# The sync kernels past 65535 workers (ROADMAP C15): B5-B10 at a fleet of
# FLEET_ROWS (1.15 GB a (M, n) array); B10's plain version (O(M^2) eager
# passes) is held on FLEET_TRIM_COLS columns of it (each column is merged
# on its own), the row past 65535 dead in the uplink checks.
FLEET_ROWS = (70000, 4096)
FLEET_TRIM_COLS = 64
FLEET_DEAD_ROW = 69999
# B1/B2 against their plain versions at the fleet: the largest elementwise
# error PERF.md states for them at (64, 16384) and the merge shapes (the
# kernels round z* - eta*g once, by an FMA, where the plain version rounds
# twice); B3 exactly, B4 bit-identical to B1 then B2.
TOL_FLEET_UPDATE = 1.49e-7
# --sync-bits: the update kernels' outputs at these (M, n), to hold two
# trees' B1-B4 to the bit.
UPDATE_BITS_SHAPES = ((M, N), (M, N_RAGGED), (4, N_RAGGED))
# The async phase: benchmarks/bench_async.py:50's one 6x straggler at the
# main fleet (M - 1 workers at 1 s a local step, one at 6 s; uplink 0.2 s,
# downlink 0.1 s) on the main game, tau in {0, 2, inf}, gamma = 1, R; a run
# killed at admission ASYNC_KILL, saved and resumed; and three cells at
# tau = 2 and ASYNC_CELL_R rounds under q8, an attack and outer Nesterov.
ASYNC_LATENCY = dict(step_s=(1.0,) * (M - 1) + (6.0,), up_s=0.2, down_s=0.1)
ASYNC_TAUS = {"tau0": 0.0, "tau2": 2.0, "tauinf": math.inf}
ASYNC_KILL = 4
ASYNC_CELL_R = 3
# The sampled phase (A13): benchmarks/bench_fleet.py's largest fleet
# (FLEETS[-1] = 10000) drawing SAMPLE_CAP = 64 a round with its sampler
# seed 3, on the main game at K; R rounds, a checkpoint after
# SAMPLED_SAVE; the stacked cell at SAMPLED_STACK_R rounds; sample == fleet
# = M against no sampler at SAMPLED_FULL_R; and bench_fleet.py's async
# fleet of 512 (async_sampled) under its ConstantLatency.
SAMPLED_FLEET, SAMPLED_LANES, SAMPLED_SEED = 10000, 64, 3
SAMPLED_SAVE, SAMPLED_STACK_R, SAMPLED_FULL_R = 2, 3, 2
SAMPLED_ASYNC_FLEET = 512
SAMPLED_LATENCY = dict(step_s=1.0, up_s=0.2, down_s=0.1)
# The wgan phase: the paper's §5 WGAN-GP (src/repro/problems/wgan.py) at
# make_wgan_problem's full default width (latent 8, hidden 64, batch 64,
# gp 1), seed 0, with examples/wgan_train.py's and benchmarks/bench_wgan.py's
# AdaSEG settings; the fleet M = 64, K = 20, homogeneous and
# heterogeneous_wgan at alpha 0.6 (bench_wgan.py's); LocalAdam's lr 2e-3.
# R = 20 of bench_wgan.py's 40, to keep the whole script near 800 s of its
# 1200 s limit; every check runs at R = 20 as it did at 40.
WGAN_M, WGAN_K, WGAN_R = 64, 20, 20
WGAN_ALPHA, WGAN_ADAM_LR = 0.6, 2e-3
WGAN_EVERY = 10      # rounds between the printed W-estimates and distances
# Fused against reference W-estimates: the JAX package's bar between its
# own two backends on the WGAN (tests/test_step_backends.py:116, rtol 1e-3
# and atol 1e-4), over the first WGAN_GATED_ROUNDS rounds; later rounds are
# recorded, not gated (the penalty's double backward amplifies the ulps in
# which B1's single rounding of z* - eta g differs, ROADMAP C13, C20).
TOL_WGAN_TRACE = dict(rtol=1e-3, atol=1e-4)
WGAN_GATED_ROUNDS = 10


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


def bound(bytes_moved: float, flops: float, int_ops: float = 0.0,
          issue_ops: float = 0.0) -> tuple[float, str]:
    """Least ms for the work: the larger of the bytes over the HBM rate and
    the operations (f32 FLOPs, int32 and non-FMA f32 operations, each over
    its own peak) over time."""
    t_bytes = bytes_moved / CARD["hbm_bytes_per_s"] * 1e3
    t_ops = max(flops / F32_FLOPS_PER_S,
                int_ops / CARD["int32_ops_per_s"] if int_ops else 0.0,
                issue_ops / CARD["f32_issue_per_s"] if issue_ops else 0.0
                ) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    return float((a - b).abs().max())


def rel_err(a, b) -> float:
    return float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())


def _flat(out):
    """A wrapper's outputs (a tensor, or nested tuples of them) as a flat
    list of tensors."""
    if hasattr(out, "data_ptr"):
        return [out]
    return [t for o in out for t in _flat(o)]


def fresh_graph_ms(fn, sets):
    """``graph_ms`` of ``fn(x)`` for each x of ``sets``, every call making
    its own output as a caller does; and how many distinct blocks those
    outputs took inside the capture (1: the graph's private pool handed
    every call the block the call before it had freed)."""
    ptrs = []

    def call(x):
        out = fn(x)
        ptrs.append((out if hasattr(out, "data_ptr") else out[0]).data_ptr())

    ms = graph_ms([lambda x=x: call(x) for x in sets])
    return ms, len(set(ptrs[-len(sets):]))


def library_times(name, library, library_name, sets, wrapper, ms,
                  same_out=True):
    """A kernel's yardstick PyTorch call ``library(x[, out])``, named
    ``library_name``, over ``sets``, in two like-for-like pairings. Into a fresh output, as a
    caller makes it (``library_ms`` of the kernels line), against the
    kernel through its ``wrapper``, which makes its own output, in the same
    kind of graph (``wrapper_graph_ms``); and, with ``same_out``, into the
    kernel's own preallocated outputs ``x["out"]`` (``library_same_out_ms``)
    against the bare launch into them (``ms``). Prints whether the fresh
    outputs inside each capture share one block. Returns ``(library_ms,
    fields)``."""
    library_ms, library_blocks = fresh_graph_ms(library, sets)
    wrapper_ms, wrapper_blocks = fresh_graph_ms(wrapper, sets)
    emit("fresh_outputs", kernel=name, calls=len(sets),
         wrapper_blocks=wrapper_blocks, library_blocks=library_blocks,
         one_block=wrapper_blocks == library_blocks == 1)
    fields = dict(library=library_name, wrapper_graph_ms=wrapper_ms,
                  beats_library_fresh=wrapper_ms < library_ms)
    if same_out:
        same_ms = graph_ms([lambda x=x: library(x, x["out"]) for x in sets])
        fields.update(library_same_out_ms=same_ms,
                      beats_library_same_out=ms < same_ms)
    return library_ms, fields


def launch_floor_ms(blocks: int, calls: int) -> float:
    """``graph_ms`` of ``calls`` launches of an empty kernel on ``blocks``
    blocks of 256 threads (``empty_launch`` in ``csrc/sync_compress.cu``):
    the least a launch of that grid takes in the harness."""
    import ctypes

    import torch

    from repro_torch.kernels import _build

    fn = _build.library("sync_compress.cu").empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        err = fn(blocks, torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"empty_launch failed with CUDA error {err}")

    return graph_ms([launch] * calls)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    CARD["int32_ops_per_s"] = INT32_LANES_PER_SM_CLOCK * sms * clock_mhz * 1e6
    CARD["f32_issue_per_s"] = F32_LANES_PER_SM_CLOCK * sms * clock_mhz * 1e6
    CARD["mufu_per_s"] = MUFU_PER_SM_CLOCK * sms * clock_mhz * 1e6
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 still allowed")
    check(torch.get_float32_matmul_precision() == "highest",
          "f32 matmul precision is not 'highest'")
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, sms=sms, max_sm_clock_mhz=clock_mhz,
         int32_ops_per_s=CARD["int32_ops_per_s"],
         f32_issue_per_s=CARD["f32_issue_per_s"],
         mufu_per_s=CARD["mufu_per_s"])
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
        "adaseg_update": dict(
            src="src/repro_torch/csrc/adaseg_update.cu",
            replaces="src/repro/kernels/adaseg_update/kernel.py:267",
            # read z*, m, g, sum_sq; write z_t, z~, (M, tiles, 2) partials
            bytes=4 * (5 * M * N + M + 2 * M * tiles), flops=12 * M * N,
            run=lambda x, box, f: f(x["z"], x["a"], x["b"],
                                    sum_sq=x["sum_sq"], g0=G0,
                                    d_alpha=DIAMETER, **box_kw(box)),
            # l2 pass 1 (raw candidates and their norms), and eta given
            more=(lambda x, box, f: f(x["z"], x["a"], x["b"],
                                      sum_sq=x["sum_sq"], g0=G0,
                                      d_alpha=DIAMETER, raw_norms=True),
                  lambda x, box, f: f(x["z"], x["a"], x["b"], x["s_t"],
                                      **box_kw(box))),
            launch=lambda x: ak.UPDATE(
                *ptr(x, "z", "a", "b", "sum_sq", "out", "out2", "part"), M,
                N, ak.TILE, 1, 1, G0 ** 2, DIAMETER, 1, -1.0, 1.0, 0,
                stream(x)),
            kernel=ak.adaseg_update, plain=ar.adaseg_update_ref),
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
            plain=lambda z, w: sr.merge_ref(z, w),
            # every row of w.expand(M, M) is w: row m of the product is
            # sum_i w_i z[i], the ungated merge broadcast to each row
            library=lambda x, out=None: torch.matmul(
                x["w"].expand(M, M), x["z"], out=out),
            library_name="torch.matmul(w.expand(M, M), z)"),
    }

    # Timing inputs: 12 sets of the main path's shape, cycled so the bytes
    # in flight exceed the 50 MB L2, as the main path finds them cold.
    sets = [inputs(100 + i, N) for i in range(12)]
    results = {}
    for name, c in cases.items():
        errs = []
        for (n, box), run in itertools.product(
                ((N, (-1.0, 1.0)), (N_RAGGED, (0.25, 1.0))),
                (c["run"], *c.get("more", ()))):
            x = inputs(1, n)
            got = _flat(run(x, box, c["kernel"]))
            want = _flat(run(x, box, c["plain"]))
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
        library_ms, extra = None, {}
        if "library" in c:
            library_ms, extra = library_times(
                name, c["library"], c["library_name"], sets,
                lambda x: c["run"](x, box, c["kernel"]), ms)
        b_ms, b_by = bound(c["bytes"], c["flops"])
        results[name] = dict(
            name=name, route="cuda", source=c["src"], replaces=c["replaces"],
            launches=0, max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        )
        emit("kernel", **results[name], wrapper_eager_ms=wrapper_ms,
             gb_per_s=c["bytes"] / (ms * 1e-3) / 1e9, **extra)
    return results


def phase_codec_kernels(results):
    """The codec uplink kernels (and the merge's gated branch) against their
    plain versions, on the main path's effective-message form (w and ef
    given), with and without aliveness; the timed inputs have one dead
    worker, as a fault-tolerant sync gives them."""
    import torch

    from repro_torch.kernels.sync_compress import kernel as sk
    from repro_torch.kernels.sync_compress import ref as sr

    dev = torch.device("cuda")
    src = "src/repro_torch/csrc/sync_compress.cu"
    tiles = (N + sk.TILE - 1) // sk.TILE
    live = M - 1
    stats_tile = sk.stats_tile(M, N, sk._build.sm_count(dev))
    stats_tiles = -(-N // stats_tile)
    stats_tickets = sk.tickets("uplink_stats", sk.STATS_TICKETS, dev)

    def inputs(seed, n):
        gen = torch.Generator(device=dev).manual_seed(seed)

        def u(*shape):
            return torch.rand(*shape, generator=gen, device=dev) * 2 - 1

        z, ef = u(M, n), 1e-3 * u(M, n)
        w = u(M) + 1.5
        w = w / w.sum()
        keys = torch.randint(0, 2 ** 32, (M, 2), generator=gen, device=dev)
        alive = torch.ones(M, device=dev)
        alive[DEAD_ROW] = 0.0
        return dict(
            z=z, ef=ef, w=w, keys=keys, words=sk._key_words(keys, M, z),
            alive=alive, eff=sr.eff_uplink_ref(z, ef, w),
            scale=torch.clamp(sr.uplink_stats_ref(z, ef, w), min=1e-30),
            mask=(torch.rand(M, n, generator=gen, device=dev) < 0.25)
            .to(torch.uint8),
            msg=z * w[:, None], old=u(M, n),
            out=torch.empty(M, n, device=dev),
            out2=torch.empty(M, n, device=dev),
            part=torch.empty(M, tiles, device=dev),
            stats_part=torch.empty(M * stats_tiles, device=dev),
            stats_out=torch.empty(M, device=dev))

    def stream(x):
        return sk._build.stream_of(x["z"])

    def alive_of(x, gated):
        return x["alive"] if gated else None

    # Each case: the wrapper and the plain version on the same inputs
    # (checked for 0 error, with and without alive), the bare launch on
    # preallocated outputs and the plain version (timed, one dead worker).
    cases = {
        "uplink_stats": dict(
            replaces="src/repro/kernels/sync_compress/kernel.py:329",
            gated=(False,),
            # read z, ef, w; write the (M,) maxima
            bytes=4 * (2 * M * N + 2 * M), flops=3 * M * N,
            int_ops=0,
            run=lambda x, g: (sk.uplink_stats(x["z"], x["w"], x["ef"]),),
            plain=lambda x, g: (sr.uplink_stats_ref(x["z"], x["ef"],
                                                    x["w"]),),
            launch=lambda x: sk.STATS(
                x["z"].data_ptr(), x["w"].data_ptr(), x["ef"].data_ptr(),
                x["stats_part"].data_ptr(), stats_tickets.data_ptr(),
                x["stats_out"].data_ptr(), M, N, stats_tile, 1, stream(x)),
            blocks=M * stats_tiles),
        "quantize_uplink": dict(
            replaces="src/repro/kernels/sync_compress/kernel.py:344",
            gated=(False, True),
            # live rows read z, ef and write sent, ef_new; the dead row
            # reads ef and writes both; w, scale, alive, key words per row
            bytes=4 * (4 * live * N + 3 * N + 5 * M), flops=10 * live * N,
            int_ops=QUANTIZE_INT_OPS * live * N,
            run=lambda x, g: sk.quantize_uplink(
                x["z"], x["keys"], x["scale"], x["w"], x["ef"],
                alive_of(x, g), levels=LEVELS),
            plain=lambda x, g: sr.quantize_uplink_ref(
                x["z"], x["keys"], x["scale"], levels=LEVELS, ef=x["ef"],
                w=x["w"], alive=alive_of(x, g)),
            launch=lambda x: sk.QUANTIZE(
                *(x[k].data_ptr() for k in ("z", "w", "ef", "scale", "alive",
                                            "words", "out", "out2")),
                M, N, sk.TILE, 1, LEVELS, stream(x))),
        "eff_uplink": dict(
            replaces="src/repro/kernels/sync_compress/kernel.py:373",
            gated=(False,),
            # read z, ef, w; write eff
            bytes=4 * (3 * M * N + M), flops=2 * M * N, int_ops=0,
            run=lambda x, g: (sk.eff_uplink(x["z"], x["w"], x["ef"]),),
            plain=lambda x, g: (sr.eff_uplink_ref(x["z"], x["ef"], x["w"]),),
            launch=lambda x: sk.EFF(
                *(x[k].data_ptr() for k in ("z", "w", "ef", "out")),
                M, N, sk.TILE, 1, stream(x)),
            library=lambda x, out=None: torch.addcmul(
                x["ef"], x["w"][:, None], x["z"], out=out),
            library_name="torch.addcmul(ef, w[:, None], z)"),
        "mask_uplink": dict(
            replaces="src/repro/kernels/sync_compress/kernel.py:386",
            gated=(False, True),
            # live rows read eff (f32) and the uint8 mask and write sent and
            # ef_new; the dead row reads ef and writes both; alive per row
            bytes=live * 13 * N + 12 * N + 4 * M, flops=live * N, int_ops=0,
            run=lambda x, g: sk.mask_uplink(x["eff"], x["mask"], x["ef"],
                                            alive_of(x, g)),
            plain=lambda x, g: sr.mask_uplink_ref(
                x["eff"], x["mask"], alive=alive_of(x, g), ef=x["ef"]),
            launch=lambda x: sk.MASK(
                *(x[k].data_ptr() for k in ("eff", "mask", "ef", "alive",
                                            "out", "out2")),
                M, N, sk.TILE, 1, stream(x))),
    }

    sets = [inputs(200 + i, N) for i in range(12)]
    for name, c in cases.items():
        err = 0.0
        for n in (N, N_RAGGED):
            x = inputs(2, n)
            for gated in c["gated"]:
                got, want = c["run"](x, gated), c["plain"](x, gated)
                torch.cuda.synchronize()
                for gt, wt in zip(got, want):
                    err = max(err, max_abs(gt, wt))
                if gated:
                    sent, ef_new = got
                    check(float(sent[DEAD_ROW].abs().max()) == 0.0
                          and torch.equal(ef_new[DEAD_ROW],
                                          x["ef"][DEAD_ROW]),
                          f"{name}: the dead worker sent or moved its ef")
        check(err == 0.0, f"{name}: max abs err {err} against the plain "
                          "version (must be 0)")
        ms = graph_ms([lambda x=x: c["launch"](x) for x in sets * 2])
        plain_ms = graph_ms([lambda x=x: c["plain"](x, True) for x in sets])
        library_ms, extra = None, {}
        if "library" in c:
            library_ms, extra = library_times(
                name, c["library"], c["library_name"], sets,
                lambda x: c["run"](x, False), ms)
        b_ms, b_by = bound(c["bytes"], c["flops"], c["int_ops"])
        results[name] = dict(
            name=name, route="cuda", source=src, replaces=c["replaces"],
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
        )
        if "blocks" in c:
            results[name]["launch_floor_ms"] = launch_floor_ms(
                c["blocks"], 2 * len(sets))
        emit("kernel", **results[name],
             gb_per_s=c["bytes"] / (ms * 1e-3) / 1e9, **extra)
    stats_lm_leaf()

    # B5's gated branch as the codec path calls it: the w-scaled messages,
    # unit weights, rows with recv = 0 keep old (sum order differs from
    # torch.sum, hence TOL_ELEM).
    err = 0.0
    for n in (N, N_RAGGED):
        x = inputs(3, n)
        got = sk.merge_stacked(x["msg"], None, x["alive"], x["old"])
        want = sr.merge_ref(x["msg"], None, recv=x["alive"] > 0,
                            old=x["old"])
        torch.cuda.synchronize()
        err = max(err, max_abs(got, want))
        check(torch.equal(got[DEAD_ROW], x["old"][DEAD_ROW]),
              "merge_stacked: a non-receiving row did not keep old")
    check(err <= TOL_ELEM, f"merge_stacked gated: max abs err {err}")
    ms = graph_ms([lambda x=x: sk.MERGE(
        x["msg"].data_ptr(), None,
        *(x[k].data_ptr() for k in ("alive", "old", "out")), M, N, 0, 1,
        stream(x)) for x in sets * 2])
    plain_ms = graph_ms([lambda x=x: sr.merge_ref(
        x["msg"], None, recv=x["alive"] > 0, old=x["old"]) for x in sets])
    # read z, old of the non-receiving row and recv; write the (M, n) output
    b_ms, b_by = bound(4 * (2 * M * N + N + M), M * N)
    emit("kernel_case", name="merge_stacked", case="recv/old gated, "
         "unit weights, one row keeps old", max_abs_err=err, ms=ms,
         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def stats_lm_leaf():
    """B6 at the language model's largest leaf, ``LM_LEAF``, with w and
    ef: held against its plain version (exactly) and timed over two input
    sets, each larger than the L2, beside the launch floor of its grid; its
    tensors are freed after."""
    import torch

    from repro_torch.kernels.sync_compress import kernel as sk
    from repro_torch.kernels.sync_compress import ref as sr

    dev = torch.device("cuda")
    m, n = LM_LEAF
    tile = sk.stats_tile(m, n, sk._build.sm_count(dev))
    blocks = m * -(-n // tile)
    tickets = sk.tickets("uplink_stats", sk.STATS_TICKETS, dev)
    sets = []
    for i in range(2):
        gen = torch.Generator(device=dev).manual_seed(500 + i)
        z = torch.rand(m, n, generator=gen, device=dev) * 2 - 1
        ef = (torch.rand(m, n, generator=gen, device=dev) * 2 - 1) * 1e-3
        w = torch.rand(m, generator=gen, device=dev) + 0.5
        sets.append(dict(z=z, ef=ef, w=w / w.sum(),
                         part=torch.empty(blocks, device=dev),
                         out=torch.empty(m, device=dev)))
    x = sets[0]
    err = max_abs(sk.uplink_stats(x["z"], x["w"], x["ef"]),
                  sr.uplink_stats_ref(x["z"], x["ef"], x["w"]))
    check(err == 0.0, f"uplink_stats {LM_LEAF}: max abs err {err}")
    calls = [lambda x=x: sk.STATS(
        x["z"].data_ptr(), x["w"].data_ptr(), x["ef"].data_ptr(),
        x["part"].data_ptr(), tickets.data_ptr(), x["out"].data_ptr(), m, n,
        tile, 1, sk._build.stream_of(x["z"])) for x in sets * 2]
    ms = graph_ms(calls)
    plain_ms = time_ms(lambda: sr.uplink_stats_ref(x["z"], x["ef"], x["w"]),
                       reps=2, trials=3)
    # read z, ef, w; write the (M,) maxima
    b_ms, b_by = bound(4 * (2 * m * n + 2 * m), 3 * m * n)
    emit("kernel", name="uplink_stats", shape=[m, n], route="cuda",
         max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
         bound_by=b_by, launch_floor_ms=launch_floor_ms(blocks, len(calls)),
         library_ms=None, blocks=blocks, sets=len(sets))
    del sets, x, calls
    torch.cuda.empty_cache()


def phase_merge_shapes():
    """B5 beyond the main path's shape: against its plain version at M in
    MERGE_ROWS x n in (N, N_RAGGED), with unit weights on w-scaled messages
    (the codec path's form), with raw weights normalised in the kernel, and
    gated (every third row keeps old); each call rerun, bit-identical. Then
    B5 at the language-model path's largest leaf, timed beside
    ``torch.matmul(w.expand(M, M), z)`` in both pairings; its tensors are
    freed before the ``lm`` phase."""
    import torch

    from repro_torch.kernels.sync_compress import kernel as sk
    from repro_torch.kernels.sync_compress import ref as sr

    dev = torch.device("cuda")

    def inputs(seed, m, n):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return dict(z=torch.rand(m, n, generator=gen, device=dev) * 2 - 1,
                    w=torch.rand(m, generator=gen, device=dev) * 1.9 + 0.1)

    rows = []
    for m, n in itertools.product(MERGE_ROWS, (N, N_RAGGED)):
        x = inputs(4, m, n)
        x.update(msg=x["z"] * (x["w"] / x["w"].sum())[:, None],
                 old=torch.rand(m, n, device=dev))
        recv = (torch.arange(m, device=dev) % 3 != 0).float()
        calls = {
            "unit": (lambda: sk.merge_stacked(x["msg"]),
                     lambda: sr.merge_ref(x["msg"])),
            "normalize": (lambda: sk.merge_stacked(x["z"], x["w"],
                                                   normalize=True),
                          lambda: sr.merge_ref(x["z"], x["w"],
                                               normalize=True)),
            "gated": (lambda: sk.merge_stacked(x["msg"], None, recv,
                                               x["old"]),
                      lambda: sr.merge_ref(x["msg"], recv=recv > 0,
                                           old=x["old"])),
        }
        row = dict(m=m, n=n)
        for label, (kernel, plain) in calls.items():
            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            row[label] = err = max_abs(got, want)
            check(err <= TOL_ELEM, f"merge_stacked {label} {(m, n)}: max abs "
                                   f"err {err}")
            check(torch.equal(got, again),
                  f"merge_stacked {label} {(m, n)}: reruns differ")
            if label == "gated":
                keep = recv == 0
                check(torch.equal(got[keep], x["old"][keep]),
                      f"merge_stacked {(m, n)}: a non-receiving row did not "
                      "keep old")
        rows.append(row)
    emit("merge_shapes", tol=TOL_ELEM, reruns_bit_identical=True,
         cases=rows)

    # A fleet past 12288 workers: its 64 KB of weights take the opt-in
    # shared memory; 16384 normalised terms a column, in another order than
    # torch.sum (TOL_STAT).
    m, n = MERGE_FLEET
    x = inputs(5, m, n)
    got = sk.merge_stacked(x["z"], x["w"], normalize=True)
    again = sk.merge_stacked(x["z"], x["w"], normalize=True)
    want = sr.merge_ref(x["z"], x["w"], normalize=True)
    torch.cuda.synchronize()
    err = max_abs(got, want)
    check(err <= TOL_STAT, f"merge_stacked {MERGE_FLEET}: max abs err {err}")
    check(torch.equal(got, again), f"merge_stacked {MERGE_FLEET}: reruns "
                                   "differ")
    emit("merge_fleet", shape=[m, n], max_rows=sk.MAX_ROWS, max_abs_err=err,
         tol=TOL_STAT, reruns_bit_identical=True)
    del x, got, again, want

    m, n = LM_LEAF
    sets = [inputs(300 + i, m, n) for i in range(2)]
    for x in sets:                  # the 1/eta weights, normalised
        x["w"] /= x["w"].sum()
        x["out"] = torch.empty(m, n, device=dev)
    err = max_abs(sk.merge_stacked(x["z"], x["w"]), sr.merge_ref(x["z"],
                                                                x["w"]))
    check(err <= TOL_ELEM, f"merge_stacked {LM_LEAF}: max abs err {err}")
    ms = graph_ms([lambda x=x: sk.MERGE(
        x["z"].data_ptr(), x["w"].data_ptr(), None, None, x["out"].data_ptr(),
        m, n, 0, 1, sk._build.stream_of(x["z"])) for x in sets])
    library_ms, extra = library_times(
        f"merge_stacked {LM_LEAF}", lambda x, out=None: torch.matmul(
            x["w"].expand(m, m), x["z"], out=out),
        "torch.matmul(w.expand(M, M), z)", sets,
        lambda x: sk.merge_stacked(x["z"], x["w"]), ms)
    b_ms, b_by = bound(4 * (2 * m * n + m), 2 * m * n)
    emit("merge_lm_leaf", shape=[m, n], sets=len(sets), max_abs_err=err,
         ms=ms, library_ms=library_ms, bound_ms=b_ms, bound_by=b_by, **extra)
    del sets, x
    torch.cuda.empty_cache()


def reset_launches():
    from repro_torch.kernels import _build

    for k in _build.KERNELS:
        k.launches = 0


def launches():
    from repro_torch.kernels import _build

    return {k.name: k.launches for k in _build.KERNELS}


def run_engine(game, problem, backend, rounds, g0=G0, **ps_kw):
    """One LocalAdaSEG PSEngine run on the card: (residuals, ms per local
    step of the fleet, the engine). ``ps_kw`` go to PSConfig (compressor,
    schedule, faults)."""
    import torch

    from repro_torch.core import AdaSEGConfig

    cfg = AdaSEGConfig(g0=g0, diameter=DIAMETER, k=K)
    res, ms, eng = run_zoo_engine(problem, game.residual, dict(adaseg=cfg),
                                  backend, rounds, ps_kw)
    check(all(tuple(v.shape) == (N,) for v in eng.z_bar()),
          f"{backend}: bad output iterate")
    return res, ms, eng


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
    warm_f, _, _ = run_engine(game, game.problem, "fused", 1, g0=1.0)
    warm_r, _, _ = run_engine(game, game.problem, "reference", 1, g0=1.0)
    emit("sensitivity", g0=1.0, rounds=1, fused=warm_f, reference=warm_r,
         max_rel=abs(warm_f[0] - warm_r[0]) / abs(warm_r[0]))

    reset_launches()
    res_f, ms_f, eng_f = run_engine(game, game.problem, "fused", R)
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
    one_shot(results, game, eng_f.state)
    del eng_f

    res_r, ms_r, _ = run_engine(game, game.problem, "reference", R)
    rel = max(abs(a - b) / abs(b) for a, b in zip(res_f, res_r))
    emit("main", backend="reference", residuals=res_r,
         ms_per_local_step=ms_r, max_rel_vs_fused=rel)
    check(rel <= TOL_TRACE, f"fused vs reference residuals differ by {rel}")

    radius = 0.5 * DIAMETER
    l2 = dataclasses.replace(game.problem,
                             project=projections.l2_ball(radius))
    reset_launches()
    res_l2, ms_l2, _ = run_engine(game, l2, "fused", 2)
    l2_launches = launches()
    check(l2_launches["adaseg_finish"] > 0, "adaseg_finish never launched")
    results["adaseg_finish"]["launches"] = l2_launches["adaseg_finish"]
    emit("l2", radius=radius, residuals=res_l2, ms_per_local_step=ms_l2,
         launches=l2_launches)
    return game


def one_shot(results, game, st):
    """B4 through ``adaseg_tree_update`` on the main game's fleet state
    after the fused run: one local step's M_t and g_t, given to the one-shot
    update and to B1 then B2 on the same eta, which must agree."""
    import torch

    from repro_torch import random as jr
    from repro_torch.core import AdaSEGConfig
    from repro_torch.kernels.adaseg_update.ops import (
        adaseg_tree_anchor,
        adaseg_tree_explore,
        adaseg_tree_update,
    )

    cfg = AdaSEGConfig(g0=G0, diameter=DIAMETER, k=K)
    kw = dict(sum_sq=st.sum_sq, g0=cfg.g0, d_alpha=cfg.diameter * cfg.alpha,
              proj=("box", -1.0, 1.0))
    prob = game.problem
    r = jr.split(jr.split(jr.PRNGKey(9), M))
    m_t = prob.oracle(st.z_tilde, prob.sample(r[:, 0]))
    z_t, _ = adaseg_tree_explore(st.z_tilde, m_t, **kw)
    g_t = prob.oracle(z_t, prob.sample(r[:, 1]))
    z_tl, stat, _ = adaseg_tree_anchor(st.z_tilde, z_t, g_t, **kw)
    reset_launches()
    u_t, u_tl, z_sq = adaseg_tree_update(st.z_tilde, m_t, g_t, **kw)
    n_launch = launches()["adaseg_update"]
    torch.cuda.synchronize()
    err = max(max_abs(a, b) for a, b in zip(u_t + u_tl, z_t + z_tl))
    eta = cfg.diameter * cfg.alpha / (cfg.g0 ** 2 + st.sum_sq).sqrt()
    rel = rel_err(z_sq, stat / (5.0 * eta ** 2))
    same = all(bool((a == b).all()) for a, b in zip(u_t + u_tl, z_t + z_tl))
    emit("one_shot", leaves=len(u_t), launches=n_launch, max_abs_err=err,
         z_sq_rel_err=rel, bit_identical=same)
    check(n_launch == len(u_t), f"adaseg_update launched {n_launch} times")
    check(err <= TOL_ELEM and rel <= TOL_STAT,
          f"one-shot vs explore+anchor: err {err}, z_sq rel err {rel}")
    results["adaseg_update"]["launches"] = n_launch


def phase_codec(results, game):
    """The compressed, fault-tolerant sync on the main path's game: q8 and
    top-25% with error feedback under stragglers and worker faults, each
    through the fused and the reference backends."""
    import torch

    from repro_torch import random as jr
    from repro_torch.kernels.sync_compress.ops import codec_uplink_stacked
    from repro_torch.ps import (
        BernoulliFaults,
        StochasticQuantizeCompressor,
        StragglerSchedule,
        TopKCompressor,
    )

    policies = dict(schedule=StragglerSchedule(**CODEC_SCHEDULE),
                    faults=BernoulliFaults(**CODEC_FAULTS))
    codecs = (("q8", StochasticQuantizeCompressor(bits=8),
               ("uplink_stats", "quantize_uplink")),
              ("top25", TopKCompressor(fraction=0.25),
               ("eff_uplink", "mask_uplink")))
    for label, comp, codec_kernels in codecs:
        reset_launches()
        res_f, ms_f, eng = run_engine(game, game.problem, "fused", R,
                                      compressor=comp, **policies)
        path_launches = launches()
        check(res_f[-1] < res_f[0], f"{label}: residual did not fall: "
                                    f"{res_f}")
        for name in codec_kernels + ("merge_stacked", "adaseg_explore",
                                     "adaseg_anchor"):
            check(path_launches[name] > 0,
                  f"{label}: {name} never launched on the codec path")
        for name in codec_kernels:
            results[name]["launches"] = path_launches[name]
        check(all(bool(torch.isfinite(e).all()) for e in eng._ef),
              f"{label}: non-finite error-feedback residual")

        # The uplink alone, at this run's shapes: the last round's payload,
        # residual, survivor weights and aliveness.
        alive = torch.as_tensor(eng._alive[-1], device="cuda")
        sw = torch.where(alive, eng.worker.sync_weight(eng.state), 0.0)
        uplink = dict(payload=eng.worker.sync_payload(eng.state),
                      rngs=jr.split(jr.PRNGKey(7), M), w=sw / sw.sum(),
                      ef=eng._ef, alive=alive, codec=comp.codec_spec)
        uplink_ms = {
            backend: time_ms(lambda uk=uk: codec_uplink_stacked(
                **uplink, use_kernel=uk), reps=5, trials=5)
            for backend, uk in (("fused", True), ("reference", False))}
        # q8's leaf keys: split(rngs, L), an eager threefry on (M, 2) keys
        leaf_split_ms = time_ms(lambda: jr.split(uplink["rngs"],
                                                 len(uplink["payload"])),
                                reps=5, trials=5)

        res_r, ms_r, eng_r = run_engine(game, game.problem, "reference", R,
                                        compressor=comp, **policies)
        rel = max(abs(a - b) / abs(b) for a, b in zip(res_f, res_r))
        for backend, res, ms, e in (("fused", res_f, ms_f, eng),
                                    ("reference", res_r, ms_r, eng_r)):
            walls = [r.wall_time_s * 1e3 for r in e.trace.rounds]
            emit("codec", codec=label, backend=backend, residuals=res,
                 ms_per_local_step=ms, round_wall_ms=statistics.mean(walls),
                 uplink_ms_per_sync=uplink_ms[backend],
                 leaf_key_split_ms=leaf_split_ms,
                 alive_per_round=[sum(r.alive) for r in e.trace.rounds],
                 steps_per_round=[sum(r.local_steps)
                                  for r in e.trace.rounds],
                 bytes_up_per_round=[r.bytes_up for r in e.trace.rounds],
                 **({"launches": path_launches} if backend == "fused"
                    else {"max_rel_vs_fused": rel}))
        check(rel <= TOL_TRACE,
              f"{label}: fused vs reference residuals differ by {rel}")


def phase_robust_kernels(results):
    """The robust merge (B10) and the outer step (B11) against their plain
    versions, and their times. B10: trims 12 and 31, non-uniform weights,
    with and without a dead row (incl = recv = 0, keeps ``old``), and on
    inputs rounded to nine levels (ties everywhere), reruns bit-identical;
    fleets of ``TRIMMED_FLEETS`` workers (512 and up take the opt-in shared
    memory, past 1350 the streamed path); both paths forced on the same
    inputs at M = 64 and 1350, bit-identical; the streamed path timed at
    ``TRIMMED_TIMED`` workers. B11: each policy at t = 0 and t = 5, reruns
    bit-identical; timed at the game's (1, n) and at the embedding leaf."""
    import torch

    from repro_torch.kernels.sync_compress import kernel as sk
    from repro_torch.kernels.sync_compress import ref as sr
    from repro_torch.ps import ServerAdam, ServerMomentum, ServerNesterov

    dev = torch.device("cuda")
    src = "src/repro_torch/csrc/sync_compress.cu"

    def trim_inputs(seed, n, dead=False, ties=False, m=M):
        gen = torch.Generator(device=dev).manual_seed(seed)
        z = torch.rand(m, n, generator=gen, device=dev) * 2 - 1
        if ties:
            z = torch.round(z * 4) / 4
        w = torch.rand(m, generator=gen, device=dev) * 1.9 + 0.1
        incl = torch.ones(m, device=dev)
        recv = None
        if dead:
            w[DEAD_ROW] = incl[DEAD_ROW] = 0.0
            recv = incl.clone()
        return dict(z=z, w=w, incl=incl, recv=recv,
                    old=torch.rand(m, n, generator=gen, device=dev),
                    out=torch.empty(m, n, device=dev))

    def trimmed(x, trim, path):
        """One launch of the path forced (0 staged, 1 streamed) into
        ``x["out"]``."""
        m, n = x["z"].shape
        gated = x["recv"] is not None
        sk.TRIMMED(x["z"].data_ptr(), x["w"].data_ptr(), x["incl"].data_ptr(),
                   x["recv"].data_ptr() if gated else None,
                   x["old"].data_ptr() if gated else None, x["out"].data_ptr(),
                   m, n, float(trim), path, sk._build.stream_of(x["z"]))
        return x["out"]

    err = 0.0
    for n in (N, N_RAGGED):
        for trim in TRIMS:
            for dead in (False, True):
                for ties in (False, True):
                    x = trim_inputs(7, n, dead, ties)
                    got = sk.trimmed_merge_stacked(
                        x["z"], x["w"], x["incl"], x["recv"], x["old"],
                        trim=trim)
                    again = sk.trimmed_merge_stacked(
                        x["z"], x["w"], x["incl"], x["recv"], x["old"],
                        trim=trim)
                    want = sr.trimmed_merge_ref(
                        x["z"], x["w"], x["incl"], trim=trim,
                        recv=None if x["recv"] is None else x["recv"] > 0,
                        old=x["old"])
                    torch.cuda.synchronize()
                    err = max(err, max_abs(got, want))
                    check(torch.equal(got, again),
                          f"trimmed_merge_stacked {(n, trim, dead, ties)}: "
                          "a rerun differs")
                    if dead:
                        check(torch.equal(got[DEAD_ROW], x["old"][DEAD_ROW]),
                              "trimmed_merge_stacked: the dead row did not "
                              "keep old")
    check(err <= TOL_ELEM, f"trimmed_merge_stacked: max abs err {err}")
    # Fleets past the default 48 KB of shared memory take the opt-in
    # carve-out (M = 512 needs 86 KB; M = 256 43 KB); past 1350 workers the
    # streamed path. A fleet of 1350 and more sums ~800 and more survivors
    # in another order than the plain version: held at TOL_STAT.
    big_fleets = {}
    for rows, seed in TRIMMED_FLEETS.items():
        gen = torch.Generator(device=dev).manual_seed(seed)
        z = torch.rand(rows, 1031, generator=gen, device=dev)
        w = torch.rand(rows, generator=gen, device=dev) + 0.5
        incl = torch.ones(rows, device=dev)
        trim = rows // 5
        got = sk.trimmed_merge_stacked(z, w, incl, trim=trim)
        again = sk.trimmed_merge_stacked(z, w, incl, trim=trim)
        want = sr.trimmed_merge_ref(z, w, incl, trim=trim)
        torch.cuda.synchronize()
        big_fleets[rows] = max_abs(got, want)
        tol = TOL_ELEM if rows <= 512 else TOL_STAT
        check(big_fleets[rows] <= tol, f"trimmed_merge_stacked {rows} rows: "
                                       f"max abs err {big_fleets[rows]}")
        check(torch.equal(got, again),
              f"trimmed_merge_stacked {rows} rows: a rerun differs")
    del z, w, incl, got, again, want
    emit("trimmed_fleets", staged_rows=sk.TRIMMED_STAGED_ROWS,
         paths={str(r): sk.trimmed_path(r) for r in TRIMMED_FLEETS},
         max_abs_err={str(k): v for k, v in big_fleets.items()},
         tol={str(r): TOL_ELEM if r <= 512 else TOL_STAT
              for r in TRIMMED_FLEETS}, reruns_bit_identical=True)
    # Both paths on the same inputs: the same bits where both run.
    cases = []
    for m, n, ties, dead in ((M, N_RAGGED, False, True),
                             (M, N_RAGGED, True, True), (M, N, True, False),
                             (sk.TRIMMED_STAGED_ROWS, 1031, True, False),
                             (sk.TRIMMED_STAGED_ROWS, 1031, False, False)):
        x = trim_inputs(17, n, dead, ties, m=m)
        for trim in (m // 5, (m - 1) // 2):
            staged = trimmed(x, trim, sk.TRIMMED_STAGED).clone()
            streamed = trimmed(x, trim, sk.TRIMMED_STREAMED)
            torch.cuda.synchronize()
            check(torch.equal(staged, streamed),
                  f"trimmed_merge_stacked {(m, n, trim, ties, dead)}: the "
                  "staged and streamed paths differ")
            cases.append([m, n, trim, ties, dead])
    emit("trimmed_paths", bit_identical=True, cases=cases)
    del x, staged, streamed
    sets = [trim_inputs(300 + i, N) for i in range(12)]
    for trim in TRIMS:
        ms = graph_ms([lambda x=x: trimmed(x, trim, sk.trimmed_path(M))
                       for x in sets * 2])
        plain_ms = graph_ms([lambda x=x: sr.trimmed_merge_ref(
            x["z"], x["w"], x["incl"], trim=trim) for x in sets])
        # read z and the (M,) vectors, write the (M, n) broadcast; every
        # row is included, so each column ranks M (M - 1) / 2 pairs
        b_ms, b_by = bound(4 * (2 * M * N + 2 * M), 0.0,
                           issue_ops=TRIM_PAIR_OPS * M * (M - 1) // 2 * N)
        row = dict(name="trimmed_merge_stacked", route="cuda", source=src,
                   replaces="src/repro/kernels/sync_compress/kernel.py:446",
                   launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if trim == TRIMS[0]:
            results["trimmed_merge_stacked"] = row
        emit("kernel", **row, trim=trim,
             library="none: torch.median returns the lower middle for an "
                     "even M, and takes no weights or trim")
    del sets
    for m in TRIMMED_TIMED:             # the streamed path at its fleets
        x = trim_inputs(13, N, m=m)
        trim = m // 5
        ms = graph_ms([lambda: trimmed(x, trim, sk.TRIMMED_STREAMED)],
                      trials=3)
        plain_ms = None
        if m <= 2048:                   # 1.3 s a call; at 10000 ~30 s
            plain_ms = time_ms(lambda: sr.trimmed_merge_ref(
                x["z"], x["w"], x["incl"], trim=trim), reps=1, trials=1)
        b_ms, b_by = bound(4 * (2 * m * N + 2 * m), 0.0,
                           issue_ops=TRIM_PAIR_OPS * m * (m - 1) // 2 * N)
        emit("kernel", name="trimmed_merge_stacked", shape=[m, N],
             path="streamed", route="cuda", trim=trim, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=None, max_abs_err=big_fleets[m])
        del x
    torch.cuda.empty_cache()

    policies = (("momentum", ServerMomentum(lr=0.7, beta=0.9)),
                ("nesterov", ServerNesterov(lr=1.0, beta=0.3)),
                ("adam", ServerAdam()), ("adam_lr", ServerAdam(lr=0.3)))
    sms = sk._build.sm_count(dev)
    ticket = sk.tickets("outer_apply", 1, dev)

    def outer_inputs(seed, n, slots):
        gen = torch.Generator(device=dev).manual_seed(seed)

        def u(lo=-1.0, hi=1.0):
            u01 = torch.rand(1, n, generator=gen, device=dev)
            return u01 * (hi - lo) + lo

        mom = (u(),) if slots == 1 else (u(), u(0.0, 1.0))
        return dict(g=u(), z=u(), mom=mom, zo=torch.empty(1, n, device=dev),
                    mo=tuple(torch.empty(1, n, device=dev) for _ in mom),
                    part=torch.empty(sk.outer_blocks(n, sms), device=dev),
                    dsq=torch.empty((), device=dev))

    err = rel = 0.0
    for label, pol in policies:
        for n in (N, N_RAGGED):
            for t in (0, 5):
                x = outer_inputs(11, n, pol.slots)
                tt = torch.tensor(float(t), device=dev)
                got = sk.outer_apply(x["g"], x["z"], x["mom"], tt,
                                     spec=pol.spec)
                again = sk.outer_apply(x["g"], x["z"], x["mom"], tt,
                                       spec=pol.spec)
                want = sr.outer_apply_ref(x["g"], x["z"], x["mom"], tt,
                                          spec=pol.spec)
                torch.cuda.synchronize()
                for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
                    err = max(err, max_abs(a, b))
                rel = max(rel, rel_err(got[2], want[2]))
                check(torch.equal(got[2], again[2]),
                      f"outer_apply {label} {n}: delta_sq reruns differ")
    check(err == 0.0, f"outer_apply: max abs err {err} (must be 0)")
    check(rel <= TOL_REL_STAT, f"outer_apply: delta_sq rel err {rel}")

    def outer_time(spec, sets, n):
        """ms of the bare launch over ``sets`` (twice over when they are
        few), the plain version's, the bound and the launch floor."""
        t5 = torch.tensor(5.0, device=dev)
        adam = spec[0] == "adam"
        bias = sr.adam_bias(spec[2], spec[3], t5) if adam else None
        blocks = sk.outer_blocks(n, sms)

        def launch(x):
            m1 = x["mom"][1].data_ptr() if len(x["mom"]) == 2 else None
            mo1 = x["mo"][1].data_ptr() if len(x["mo"]) == 2 else None
            sk.OUTER(x["g"].data_ptr(), x["z"].data_ptr(),
                     x["mom"][0].data_ptr(), m1,
                     None if bias is None else bias.data_ptr(),
                     x["zo"].data_ptr(), x["mo"][0].data_ptr(), mo1,
                     x["part"].data_ptr(), ticket.data_ptr(),
                     x["dsq"].data_ptr(), n, blocks, 1,
                     *sk.outer_scalars(spec), sk._build.stream_of(x["z"]))

        calls = [lambda x=x: launch(x) for x in sets * (1 if len(sets) > 12
                                                        else 4)]
        ms = graph_ms(calls)
        if len(sets) > 12:
            plain_ms = graph_ms([lambda x=x: sr.outer_apply_ref(
                x["g"], x["z"], x["mom"], t5, spec=spec) for x in sets[:12]])
        else:
            x = sets[0]
            plain_ms = time_ms(lambda: sr.outer_apply_ref(
                x["g"], x["z"], x["mom"], t5, spec=spec), reps=2, trials=3)
        rows_moved = (4 + 3) if adam else (3 + 2)
        flops = (14 if adam else 6) * n
        # read g, z and the moments, write z' and the moments and Σ Δ²
        b_ms, b_by = bound(4 * (rows_moved * n + 1), flops)
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    launch_floor_ms=launch_floor_ms(blocks, len(calls)),
                    blocks=blocks)

    for label, pol in policies[:3]:
        sets = [outer_inputs(400 + i, N, pol.slots)
                for i in range(OUTER_SETS)]
        timed = outer_time(pol.spec, sets, N)
        del sets
        row = dict(name="outer_apply", route="cuda", source=src,
                   replaces="src/repro/kernels/sync_compress/kernel.py:488",
                   launches=0, max_abs_err=err, ms=timed["ms"],
                   plain_ms=timed["plain_ms"], bound_ms=timed["bound_ms"],
                   bound_by=timed["bound_by"], library_ms=None,
                   launch_floor_ms=timed["launch_floor_ms"])
        if label == "nesterov":
            results["outer_apply"] = row
        emit("kernel", **row, policy=label, delta_sq_rel_err=rel,
             blocks=timed["blocks"],
             library="none: no PyTorch call applies an outer momentum, "
                     "Nesterov or Adam step and sums the delta's squares")
    # The embedding leaf: one input set is larger than the L2.
    n = LM_LEAF[1]
    for label, pol in (policies[1], policies[2]):
        sets = [outer_inputs(600 + i, n, pol.slots) for i in range(2)]
        x, t5 = sets[0], torch.tensor(5.0, device=dev)
        got = sk.outer_apply(x["g"], x["z"], x["mom"], t5, spec=pol.spec)
        want = sr.outer_apply_ref(x["g"], x["z"], x["mom"], t5,
                                  spec=pol.spec)
        torch.cuda.synchronize()
        lm_err = max(max_abs(a, b)
                     for a, b in zip((got[0], *got[1]), (want[0], *want[1])))
        lm_rel = rel_err(got[2], want[2])
        check(lm_err == 0.0 and lm_rel <= TOL_REL_STAT,
              f"outer_apply {label} (1, {n}): max abs err {lm_err}, delta_sq "
              f"rel err {lm_rel}")
        del got, want, x
        timed = outer_time(pol.spec, sets, n)
        emit("kernel", name="outer_apply", shape=[1, n], policy=label,
             route="cuda", max_abs_err=lm_err, delta_sq_rel_err=lm_rel,
             library_ms=None, sets=len(sets), **timed)
        del sets
        torch.cuda.empty_cache()


def phase_sync_wrappers():
    """The sync kernels through their wrappers, as a caller pays for them:
    each call makes its own outputs in a CUDA graph (``fresh_graph_ms``),
    cycling over inputs larger than the L2; B5 and B10 at (M, N), B6 at
    (M, N) and ``LM_LEAF``, B11 (Nesterov, Adam) at (1, N) and the
    embedding leaf. Whatever a wrapper launches besides its kernel (a
    reduction, a sum) is in its time. It calls only the wrappers, so
    ``python3 chip_smoke.py --sync-wrappers`` times another tree's the same
    way."""
    import torch

    from repro_torch.kernels.sync_compress import kernel as sk
    from repro_torch.ps import ServerAdam, ServerNesterov

    dev = torch.device("cuda")

    def rand(gen, *shape):
        return torch.rand(*shape, generator=gen, device=dev) * 2 - 1

    def fleet(seed, m, n):
        gen = torch.Generator(device=dev).manual_seed(seed)
        w = rand(gen, m) + 1.5
        return dict(z=rand(gen, m, n), ef=rand(gen, m, n) * 1e-3,
                    w=w / w.sum(), incl=torch.ones(m, device=dev))

    def server(seed, n, slots):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return dict(g=rand(gen, 1, n), z=rand(gen, 1, n),
                    mom=tuple(rand(gen, 1, n).abs() for _ in range(slots)))

    t5 = torch.tensor(5.0, device=dev)
    nesterov, adam = ServerNesterov(lr=1.0, beta=0.3), ServerAdam()
    cases = (
        ("merge_stacked", (M, N), lambda x: sk.merge_stacked(x["z"], x["w"])),
        ("uplink_stats", (M, N),
         lambda x: sk.uplink_stats(x["z"], x["w"], x["ef"])),
        ("trimmed_merge_stacked", (M, N), lambda x: sk.trimmed_merge_stacked(
            x["z"], x["w"], x["incl"], trim=TRIMS[0])),
        ("uplink_stats", LM_LEAF,
         lambda x: sk.uplink_stats(x["z"], x["w"], x["ef"])),
    )
    for name, (m, n), call in cases:
        count = 2 if n > N else 12
        sets = [fleet(700 + i, m, n) for i in range(count)]
        ms, _ = fresh_graph_ms(call, sets * (2 if count > 2 else 4))
        emit("wrapper", name=name, shape=[m, n], graph_ms=ms, sets=count)
        del sets
    for pol, n in itertools.product((nesterov, adam), (N, LM_LEAF[1])):
        count = 2 if n > N else OUTER_SETS
        sets = [server(800 + i, n, pol.slots) for i in range(count)]
        ms, _ = fresh_graph_ms(lambda x, spec=pol.spec: sk.outer_apply(
            x["g"], x["z"], x["mom"], t5, spec=spec)[0],
            sets * (4 if count == 2 else 1))
        emit("wrapper", name="outer_apply", policy=pol.spec[0], shape=[1, n],
             graph_ms=ms, sets=count)
        del sets
    torch.cuda.empty_cache()


def phase_sync_bits(path):
    """The sync and update wrappers' outputs on fixed inputs, saved to
    ``path`` (CPU tensors, ``torch.save``, each output flattened into one):
    B5 at (M, N) with unit, normalised and gated weights, at (4, N_RAGGED)
    and at MERGE_FLEET; B6-B9 at (M, N) with weights, residuals and a dead
    row; B10 at (M, N_RAGGED); B1-B4 at UPDATE_BITS_SHAPES (box, eta fused;
    B4 in its l2 raw-norms mode too). It calls only the wrappers, so another
    tree's outputs can be saved the same way and held against these to the
    bit (``--compare-bits``)."""
    import torch

    from repro_torch.kernels.adaseg_update import kernel as ak
    from repro_torch.kernels.sync_compress import kernel as sk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(31)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=dev) * 2 - 1

    out = {}
    z, ef, old = rand(M, N), rand(M, N) * 1e-3, rand(M, N)
    w = rand(M) + 1.5
    recv = (torch.arange(M, device=dev) % 3 != 0).float()
    alive = torch.ones(M, device=dev)
    alive[DEAD_ROW] = 0.0
    keys = torch.randint(0, 2 ** 32, (M, 2), generator=gen, device=dev)
    out["merge_unit"] = sk.merge_stacked(z)
    out["merge_normalize"] = sk.merge_stacked(z, w, normalize=True)
    out["merge_gated"] = sk.merge_stacked(z, w / w.sum(), recv, old)
    zr = rand(4, N_RAGGED)
    out["merge_ragged"] = sk.merge_stacked(zr, rand(4) + 1.5, normalize=True)
    zf = rand(*MERGE_FLEET)
    out["merge_fleet"] = sk.merge_stacked(zf, rand(MERGE_FLEET[0]) + 1.5,
                                          normalize=True)
    out["stats"] = sk.uplink_stats(z, w, ef)
    scale = torch.clamp(out["stats"], min=1e-30)
    out["quantize_sent"], out["quantize_ef"] = sk.quantize_uplink(
        z, keys, scale, w, ef, alive, levels=LEVELS)
    out["eff"] = sk.eff_uplink(z, w, ef)
    mask = (torch.rand(M, N, generator=gen, device=dev) < 0.25).to(
        torch.uint8)
    out["mask_sent"], out["mask_ef"] = sk.mask_uplink(out["eff"], mask, ef,
                                                      alive)
    out["trimmed"] = sk.trimmed_merge_stacked(
        rand(M, N_RAGGED), w, torch.ones(M, device=dev), trim=TRIMS[0])
    # the update kernels B1-B4 (box mode, eta fused; B4's l2 raw norms too)
    for m, n in UPDATE_BITS_SHAPES:
        z, mt, gt = rand(m, n), rand(m, n) * 30, rand(m, n) * 30
        sum_sq = (rand(m) + 1.0) * 5e3
        st, sl = rand(m) * 0.25 + 0.75, rand(m) * 0.25 + 0.75
        kw = dict(sum_sq=sum_sq, g0=G0, d_alpha=DIAMETER, lo=-1.0, hi=1.0)
        tag = f"{m}x{n}"
        out[f"explore_{tag}"] = ak.adaseg_explore(z, mt, **kw)
        zt = out[f"explore_{tag}"][0]
        out[f"anchor_{tag}"] = ak.adaseg_anchor(z, zt, gt, **kw)
        out[f"finish_{tag}"] = ak.adaseg_finish(z, mt, gt, st, sl)
        out[f"update_{tag}"] = ak.adaseg_update(z, mt, gt, **kw)
        out[f"update_raw_{tag}"] = ak.adaseg_update(
            z, mt, gt, sum_sq=sum_sq, g0=G0, d_alpha=DIAMETER,
            raw_norms=True)
    out = {k: torch.cat([t.reshape(-1) for t in _flat(v)])
           for k, v in out.items()}
    torch.save({k: v.cpu() for k, v in out.items()}, path)
    emit("sync_bits", path=path, outputs=sorted(out))


def compare_bits(a, b) -> int:
    """Exit code 0 when the two ``--sync-bits`` files hold the same keys
    and every output is bit-identical; prints which are."""
    import torch

    x, y = torch.load(a), torch.load(b)
    equal = {k: k in y and torch.equal(x[k], y[k]) for k in sorted(x)}
    same = all(equal.values()) and sorted(x) == sorted(y)
    emit("compare_bits", a=a, b=b, equal=equal, all_equal=same)
    return 0 if same else 1


def phase_robust(results, game):
    """The hostile fleet and the outer optimizer on the main path's game,
    each run through the fused and the reference backends; then the
    checkpoint resume check."""
    import tempfile

    import torch

    from repro_torch.kernels.sync_compress.ops import (
        server_outer_apply,
        sync_merge_stacked,
    )
    from repro_torch.ps import (
        BernoulliFaults,
        CoordinateMedian,
        DPUplink,
        MultiKrum,
        PSConfig,
        PSEngine,
        ServerAdam,
        ServerNesterov,
        SignFlipAttack,
        StochasticQuantizeCompressor,
        TrimmedMean,
    )

    attack = SignFlipAttack(**ATTACK)
    nesterov = ServerNesterov(lr=1.0, beta=0.3)
    runs = {
        "mean_attack": dict(byzantine=attack),
        "trimmed": dict(byzantine=attack, aggregator=TrimmedMean(beta=0.2)),
        "median": dict(byzantine=attack, aggregator=CoordinateMedian()),
        "krum": dict(byzantine=attack, aggregator=MultiKrum(f=13)),
        "nesterov": dict(server_opt=nesterov),
        "adam": dict(server_opt=ServerAdam()),
        "stack": dict(byzantine=attack,
                      dp=DPUplink(clip=DIAMETER, sigma=1e-4),
                      compressor=StochasticQuantizeCompressor(bits=8),
                      faults=BernoulliFaults(**CODEC_FAULTS),
                      aggregator=TrimmedMean(beta=0.2), server_opt=nesterov),
    }
    expect = {"trimmed": ("trimmed_merge_stacked",),
              "median": ("trimmed_merge_stacked",),
              "stack": ("trimmed_merge_stacked", "outer_apply",
                        "quantize_uplink"),
              "nesterov": ("outer_apply",), "adam": ("outer_apply",)}
    finals = {}
    for label, kw in runs.items():
        reset_launches()
        res_f, ms_f, eng = run_engine(game, game.problem, "fused", R, **kw)
        path_launches = launches()
        for name in expect.get(label, ()) + ("merge_stacked",) * (
                label in ("mean_attack", "krum", "nesterov", "adam")):
            check(path_launches[name] > 0,
                  f"{label}: {name} never launched on its path")
        if label == "trimmed":
            results["trimmed_merge_stacked"]["launches"] = path_launches[
                "trimmed_merge_stacked"]
        if label == "nesterov":
            results["outer_apply"]["launches"] = path_launches["outer_apply"]
        finals[label] = res_f[-1]

        # The server side alone, at the last round's payload and weights.
        payload = eng.worker.sync_payload(eng.state)
        sw = eng.worker.sync_weight(eng.state)
        agg = None if eng._robust is None else eng._robust.agg

        def server_side(use_kernel, eng=eng, payload=payload, sw=sw,
                        agg=agg):
            merged = sync_merge_stacked(payload, sw, normalize=True, agg=agg,
                                        use_kernel=use_kernel)
            if eng._server is not None:
                server_outer_apply(tuple(v[:1] for v in merged),
                                   *eng._srv, spec=eng._server.spec,
                                   use_kernel=use_kernel)

        sync_ms = {backend: time_ms(lambda uk=uk: server_side(uk), reps=5,
                                    trials=5)
                   for backend, uk in (("fused", True), ("reference", False))}

        res_r, ms_r, eng_r = run_engine(game, game.problem, "reference", R,
                                        **kw)
        rel = max(abs(a - b) / abs(b) for a, b in zip(res_f, res_r))
        for backend, res, ms, e in (("fused", res_f, ms_f, eng),
                                    ("reference", res_r, ms_r, eng_r)):
            rounds = e.trace.rounds
            emit("robust", run=label, backend=backend, residuals=res,
                 ms_per_local_step=ms,
                 round_wall_ms=statistics.mean(r.wall_time_s * 1e3
                                               for r in rounds),
                 server_ms_per_sync=sync_ms[backend],
                 byzantine_workers=[len(r.byzantine_workers or [])
                                    for r in rounds],
                 outer_lr=[r.outer_lr for r in rounds],
                 delta_norm=[r.delta_norm for r in rounds],
                 meta={k: e.trace.meta.get(k) for k in
                       ("byzantine", "aggregator", "dp", "server_opt")},
                 **({"launches": path_launches} if backend == "fused"
                    else {"max_rel_vs_fused": rel}))
        check(rel <= TOL_TRACE,
              f"{label}: fused vs reference residuals differ by {rel}")
        if label in ("trimmed", "median", "stack"):
            # to the bit, for comparing two trees' robust merges in one call
            emit("robust_final", run=label,
                 **{f"{b}_final_residual_hex": float(r[-1]).hex()
                    for b, r in (("fused", res_f),
                                 ("reference", res_r))})
    check(finals["median"] < finals["mean_attack"],
          f"median ({finals['median']}) did not beat the plain mean under "
          f"attack ({finals['mean_attack']})")

    # Resume: fused trimmed+Nesterov, checkpointed at round 2.
    kw = dict(byzantine=attack, aggregator=TrimmedMean(beta=0.2),
              server_opt=nesterov)

    def engine():
        from repro_torch import random as jr
        from repro_torch.core import AdaSEGConfig

        cfg = AdaSEGConfig(g0=G0, diameter=DIAMETER, k=K)
        return PSEngine(game.problem,
                        PSConfig(adaseg=cfg, num_workers=M, rounds=R,
                                 backend="fused", codec_backend="fused",
                                 **kw),
                        rng=jr.PRNGKey(1), eval_fn=game.residual)

    whole = engine()
    whole.run()
    first = engine()
    first.run(until_round=2)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "engine.ckpt")
        first.save(path)
        size = Path(path).stat().st_size
        resumed = engine().restore(path)
    check(resumed.round == 2, "restore did not set the round")
    resumed.run()
    same = ([r.residual for r in resumed.trace.rounds]
            == [r.residual for r in whole.trace.rounds[2:]])
    def leaves(e):
        return [*e.state.z_tilde, e.state.sum_sq, e.state.t, *e.state.z_bar,
                e.state.grad_sq_sum, *e._srv[0], *e._srv[1][0], e._srv[2]]

    same = same and all(torch.equal(a, b)
                        for a, b in zip(leaves(resumed), leaves(whole)))
    emit("resume", run="trimmed+nesterov", backend="fused", saved_round=2,
         checkpoint_bytes=size, bit_identical=same,
         residuals=[r.residual for r in resumed.trace.rounds])
    check(same, "the resumed run differs from the uninterrupted one")


def async_engine(game, tau, backend="fused", rounds=R, **kw):
    """The port's AsyncPSEngine on the main game under ASYNC_LATENCY:
    LocalAdaSEG at the main path's settings, staleness bound ``tau``;
    ``kw`` go to AsyncPSConfig (compressor, byzantine, ...) or, for
    ``tracer`` and ``metrics``, to the engine."""
    from repro_torch import random as jr
    from repro_torch.core import AdaSEGConfig
    from repro_torch.ps import AsyncPSConfig, AsyncPSEngine, ConstantLatency

    eng_kw = {k: kw.pop(k) for k in ("tracer", "metrics") if k in kw}
    cfg = AsyncPSConfig(
        adaseg=AdaSEGConfig(g0=G0, diameter=DIAMETER, k=K), num_workers=M,
        rounds=rounds, backend=backend, codec_backend=backend,
        latency=ConstantLatency(**ASYNC_LATENCY), staleness_bound=tau, **kw)
    return AsyncPSEngine(game.problem, cfg, rng=jr.PRNGKey(1),
                         eval_fn=game.residual, **eng_kw)


def async_leaves(eng):
    """Every tensor of an async engine's dynamic state, in order."""
    import torch

    from repro_torch.checkpoint.serialize import tree_flatten

    return [x for x in tree_flatten((eng.state, eng._ef, eng._srv_payload,
                                     eng._srv_sw, eng._srv))
            if isinstance(x, torch.Tensor)]


def async_host(eng):
    """Every host-side field of every record of an async run's trace."""
    return [(r.round, r.local_steps, r.alive, r.bytes_up, r.bytes_down,
             r.sim_time_s, r.staleness, r.idle_frac, r.byzantine_workers)
            for r in eng.trace.rounds]


def run_async(game, label, tau, backend="fused", **kw):
    """Drive one async engine to its end on the card: the engine, its
    seconds, and its launches per kernel (counts zeroed before)."""
    import torch

    eng = async_engine(game, tau, backend, **kw)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zbar = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches()
    res = [r.residual for r in eng.trace.rounds]
    check(eng.done and all(v is not None and math.isfinite(v) for v in res),
          f"async {label} {backend}: unfinished or non-finite {res}")
    check(all(bool(torch.isfinite(v).all()) and tuple(v.shape) == (N,)
              for v in zbar), f"async {label} {backend}: bad output")
    return eng, seconds, counts


def emit_async(label, tau, backend, eng, seconds, counts, target=None,
               **extra):
    """One ``async`` line: the clock, the records and the timings."""
    trace = eng.trace
    walls = [r["value"] for r in eng.metrics.records
             if r["name"] == "admission_wall_s"]
    phases = [sp.wall_dur * 1e3 for sp in eng.tracer.spans
              if sp.cat == "local-compute" and sp.wall_t0 is not None]
    emit("async", run=label, tau=None if math.isinf(tau) else tau,
         backend=backend, sim_time_s=eng.sim_time,
         admissions=eng.n_admissions,
         final_residual=trace.rounds[-1].residual,
         residuals=[r.residual for r in trace.rounds],
         idle_frac=eng.idle_fraction(), max_staleness=trace.max_staleness,
         time_to_target_s=(None if target is None
                           else trace.time_to_residual(target)),
         seconds=seconds,
         wall_s_per_admission=statistics.mean(walls) if walls else None,
         phase_batches=len(phases),
         phase_batch_ms=statistics.mean(phases) if phases else None,
         launches={k: v for k, v in counts.items() if v}, **extra)


def phase_async(results, game, smi):
    """The event-driven async engine (A12) on the main path's game at M=64,
    K=50, R=5 under ASYNC_LATENCY. tau=0 fused: every admission the whole
    fleet (the sync chunk), state and z-bar bit-identical to the port's
    PSEngine. tau=2, fused and reference: residual traces within
    TOL_TRACE, host records equal; a fused rerun, a run killed at
    admission ASYNC_KILL, saved, restored into a new engine and finished,
    and a run with spans and metrics off, each bit-identical to the first.
    tau=inf fused. Time-to-target of tau=2 and inf against tau=0's final
    residual is reported, not gated. Then at tau=2, R=ASYNC_CELL_R: q8
    with error feedback (B6, B7), a 20% sign-flip attack under a trimmed
    mean (B10), outer Nesterov (B11). Each fused run must launch B1 and B2
    on its phases; B5 at tau=0."""
    import tempfile

    import torch

    from repro_torch.checkpoint.serialize import tree_flatten
    from repro_torch.obs import MetricsRegistry, SpanTracer
    from repro_torch.ps import (
        ServerNesterov,
        SignFlipAttack,
        StochasticQuantizeCompressor,
        TrimmedMean,
    )

    t_phase = time.perf_counter()

    def launched(label, counts, names):
        for name in names:
            check(counts[name] > 0,
                  f"async {label}: {name} never launched on its path")
            if results is not None:
                results[name].setdefault("async_launches", {})[label] = (
                    counts[name])

    # tau = 0: lockstep admissions, the port's PSEngine to the bit
    e0, s0, c0 = run_async(game, "tau0", 0.0)
    launched("tau0", c0, ("adaseg_explore", "adaseg_anchor",
                          "merge_stacked"))
    _, _, sync = run_engine(game, game.problem, "fused", R)
    check(all(r.staleness == [0] * M for r in e0.trace.rounds),
          "async tau0: an admission was not the whole fleet")
    pairs = list(zip(tree_flatten(e0.state), tree_flatten(sync.state)))
    pairs += list(zip(e0.z_bar(), sync.z_bar()))
    same = all(torch.equal(a, b) for a, b in pairs)
    check(same, "async tau0: not bit-identical to PSEngine")
    target = e0.trace.rounds[-1].residual
    emit_async("tau0", 0.0, "fused", e0, s0, c0,
               bit_identical_to_psengine=same)
    del sync

    # tau = 2: fused against reference, rerun, resume, spans off
    e2, s2, c2 = run_async(game, "tau2", 2.0)
    launched("tau2", c2, ("adaseg_explore", "adaseg_anchor"))
    emit_async("tau2", 2.0, "fused", e2, s2, c2, target)
    first = async_leaves(e2)
    res_f = [r.residual for r in e2.trace.rounds]
    er, sr, cr = run_async(game, "tau2", 2.0, "reference")
    check(async_host(er) == async_host(e2),
          "async tau2: host records differ between the backends")
    gaps = hold_fused_vs_reference("async", "tau2", res_f,
                                   [r.residual for r in er.trace.rounds])
    emit_async("tau2", 2.0, "reference", er, sr, cr, target,
               rel_gap=gaps)
    del er

    def bitwise(label, eng):
        same = (all(torch.equal(a, b) for a, b in zip(async_leaves(eng),
                                                       first))
                and [r.residual for r in eng.trace.rounds] == res_f
                and async_host(eng) == async_host(e2))
        check(same, f"async tau2: the {label} is not bit-identical")
        return same

    again, _, _ = run_async(game, "tau2", 2.0)
    checks = dict(rerun=bitwise("rerun", again))
    del again
    part = async_engine(game, 2.0)
    part.run(until_admissions=ASYNC_KILL)
    check(not part.done and part.n_admissions == ASYNC_KILL,
          "async tau2: the kill point is not mid-run")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "async.ckpt")
        part.save(path)
        size = Path(path).stat().st_size
        resumed = async_engine(game, 2.0).restore(path)
    resumed.run()
    checks["resume"] = (
        all(torch.equal(a, b) for a, b in zip(async_leaves(resumed), first))
        and [r.residual for r in resumed.trace.rounds] == res_f[ASYNC_KILL:])
    check(checks["resume"], "async tau2: the resumed run differs")
    del part, resumed
    off, _, _ = run_async(game, "tau2", 2.0,
                          tracer=SpanTracer(enabled=False),
                          metrics=MetricsRegistry(enabled=False))
    check(not off.tracer.spans and not off.metrics.records,
          "async tau2: spans or metrics recorded while off")
    checks["spans_metrics_off"] = bitwise("run with spans and metrics off",
                                          off)
    del off
    emit("async_checks", run="tau2", backend="fused",
         kill_at_admission=ASYNC_KILL, checkpoint_bytes=size, **checks)

    # tau = inf
    ei, si, ci = run_async(game, "tauinf", math.inf)
    launched("tauinf", ci, ("adaseg_explore", "adaseg_anchor"))
    emit_async("tauinf", math.inf, "fused", ei, si, ci, target)
    del ei

    # the cells at tau = 2, R = ASYNC_CELL_R
    cells = {
        "q8": (dict(compressor=StochasticQuantizeCompressor(bits=8)),
               ("uplink_stats", "quantize_uplink")),
        "robust": (dict(byzantine=SignFlipAttack(**ATTACK),
                        aggregator=TrimmedMean(beta=0.2)),
                   ("trimmed_merge_stacked",)),
        "nesterov": (dict(server_opt=ServerNesterov(lr=1.0, beta=0.3)),
                     ("outer_apply",)),
    }
    for label, (kw, names) in cells.items():
        eng, sec, counts = run_async(game, f"tau2/{label}", 2.0,
                                     rounds=ASYNC_CELL_R, **kw)
        launched(f"tau2/{label}", counts,
                 ("adaseg_explore", "adaseg_anchor") + names)
        emit_async(f"tau2/{label}", 2.0, "fused", eng, sec, counts,
                   rounds=ASYNC_CELL_R,
                   byzantine_workers=sum(len(r.byzantine_workers or [])
                                         for r in eng.trace.rounds),
                   delta_norm=[r.delta_norm for r in eng.trace.rounds])
        del eng
    torch.cuda.empty_cache()
    emit("async_phase", nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase)


def sampled_engine(game, backend, rounds, fleet=SAMPLED_FLEET,
                   lanes=SAMPLED_LANES, **kw):
    """The port's PSEngine on the main game with a ClientSampler drawing
    ``lanes`` of ``fleet`` workers a round (None: no sampler); ``kw`` go
    to PSConfig."""
    from repro_torch import random as jr
    from repro_torch.core import AdaSEGConfig
    from repro_torch.ps import ClientSampler, PSConfig, PSEngine

    sampler = (None if lanes is None
               else ClientSampler(sample=lanes, seed=SAMPLED_SEED))
    cfg = PSConfig(adaseg=AdaSEGConfig(g0=G0, diameter=DIAMETER, k=K),
                   num_workers=fleet, rounds=rounds, backend=backend,
                   codec_backend=backend, sampler=sampler, **kw)
    return PSEngine(game.problem, cfg, rng=jr.PRNGKey(1),
                    eval_fn=game.residual)


def sampled_leaves(eng):
    """Every tensor of a sync engine's dynamic state: store, EF, srv."""
    import torch

    from repro_torch.checkpoint.serialize import tree_flatten

    return [x for x in tree_flatten((eng.state, eng._ef, eng._srv))
            if isinstance(x, torch.Tensor)]


def drive_sampled(label, eng, reset=True):
    """Run a sampled engine on the card: (residuals, seconds, launches per
    kernel, counts zeroed before unless ``reset`` is False)."""
    import torch

    if reset:
        reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zbar = eng.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = launches()
    res = [r.residual for r in eng.trace.rounds]
    check(all(v is not None and math.isfinite(v) for v in res),
          f"sampled/{label}: non-finite residual {res}")
    check(all(bool(torch.isfinite(v).all()) and tuple(v.shape) == (N,)
              for v in zbar), f"sampled/{label}: bad output iterate")
    return res, seconds, counts


def same_bits(a, b) -> bool:
    import torch

    a, b = list(a), list(b)
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def phase_sampled(results, game, smi):
    """Sampled-client rounds (A13) on the main path's game through the
    port's PSEngine and AsyncPSEngine (see SAMPLED_*)."""
    import tempfile

    import torch

    from repro_torch.ps import (
        BernoulliFaults,
        ServerNesterov,
        SignFlipAttack,
        StochasticQuantizeCompressor,
        TrimmedMean,
    )
    from repro_torch.ps.engine import gather_rows, scatter_rows_

    t_phase = time.perf_counter()
    fleet, lanes, r_all = SAMPLED_FLEET, SAMPLED_LANES, R
    leaves_n = 2                   # (x, y)

    def launched(label, counts, want):
        for name, n_want in want.items():
            got = counts[name]
            check(got > 0 if n_want is None else got == n_want,
                  f"sampled/{label}: {name} launched {got} times, wanted "
                  f"{'some' if n_want is None else n_want}")
            if results is not None:
                results[name].setdefault("sampled_launches", {})[label] = got

    # sampled/full64: sample == fleet == M, fused, against no sampler
    full = sampled_engine(game, "fused", SAMPLED_FULL_R, fleet=M, lanes=M)
    dense = sampled_engine(game, "fused", SAMPLED_FULL_R, fleet=M,
                           lanes=None)
    res_full, _, _ = drive_sampled("full64", full)
    res_dense, sec_dense, _ = drive_sampled("full64/dense", dense)
    same = (same_bits(sampled_leaves(full), sampled_leaves(dense))
            and same_bits(full.z_bar(), dense.z_bar())
            and res_full == res_dense)
    check(same, "sampled/full64: sample == fleet differs from no sampler")
    dense_ms = sec_dense * 1e3 / (SAMPLED_FULL_R * K)
    emit("sampled", run="full64", backend="fused", fleet=M, sample=M,
         rounds=SAMPLED_FULL_R, residuals=res_full,
         bit_identical_to_no_sampler=same,
         dense_ms_per_local_step=dense_ms)
    del full, dense

    # sampled/fleet10000: init, a timed fused run and its launches
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = sampled_engine(game, "fused", r_all)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    store_bytes = sum(v.numel() * v.element_size()
                      for v in sampled_leaves(eng))
    res_f, sec_f, counts = drive_sampled("fleet10000", eng)
    steps = r_all * K * leaves_n
    launched("fleet10000", counts, {"adaseg_explore": steps,
                                    "adaseg_anchor": steps,
                                    "merge_stacked": r_all * leaves_n})
    check(res_f[-1] < res_f[0], f"sampled/fleet10000: residual did not "
          f"fall: {res_f}")
    draws = eng._draws
    check(all(r.sampled_workers == draws[i].tolist()
              and len(r.local_steps) == lanes
              for i, r in enumerate(eng.trace.rounds)),
          "sampled/fleet10000: records are not per drawn lane")
    check(eng.trace.total_steps == r_all * lanes * K,
          "sampled/fleet10000: local steps are not the sampled work")
    run_peak = torch.cuda.max_memory_allocated() - base
    # the gather and the scatter of one round, on the store, alone
    rows = torch.as_tensor(draws[0], dtype=torch.int64, device="cuda")
    sub = gather_rows(eng.state, rows)
    gather_ms = time_ms(lambda: gather_rows(eng.state, rows))
    scatter_ms = time_ms(lambda: scatter_rows_(eng.state, rows, sub))
    del sub
    first = sampled_leaves(eng)
    first_res = res_f
    ms_f = sec_f * 1e3 / (r_all * K)
    emit("sampled", run="fleet10000", backend="fused", fleet=fleet,
         sample=lanes, rounds=r_all, residuals=res_f,
         ms_per_local_step=ms_f, dense_m64_ms_per_local_step=dense_ms,
         round_wall_ms=[r.wall_time_s * 1e3 for r in eng.trace.rounds],
         gather_ms_per_round=gather_ms, scatter_ms_per_round=scatter_ms,
         init_s=init_s, init_peak_bytes=init_peak, store_bytes=store_bytes,
         peak_bytes=run_peak, launches={k: v for k, v in counts.items()
                                        if v})
    del eng

    # the same run round by round: undrawn rows frozen, a checkpoint after
    # SAMPLED_SAVE rounds, and the end bit-identical to the first run
    step = sampled_engine(game, "fused", r_all)
    frozen = []
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "sampled.ckpt")
        for r in range(r_all):
            before = [v.clone() for v in sampled_leaves(step)]
            step.step_round()
            undrawn = torch.ones(fleet, dtype=torch.bool, device="cuda")
            undrawn[torch.as_tensor(step._draws[r], dtype=torch.int64,
                                    device="cuda")] = False
            moved = torch.zeros(fleet, dtype=torch.bool, device="cuda")
            for a, b in zip(sampled_leaves(step), before):
                moved |= (a != b).reshape(fleet, -1).any(dim=1)
            frozen.append(not bool(moved[undrawn].any()))
            del before
            if r + 1 == SAMPLED_SAVE:
                t0 = time.perf_counter()
                step.save(path)
                save_s = time.perf_counter() - t0
                size = Path(path).stat().st_size
        check(all(frozen), f"sampled/fleet10000: undrawn rows changed in "
              f"rounds {[r for r, f in enumerate(frozen) if not f]}")
        rerun = (same_bits(sampled_leaves(step), first)
                 and [r.residual for r in step.trace.rounds] == first_res)
        check(rerun, "sampled/fleet10000: the rerun is not bit-identical")
        del step
        t0 = time.perf_counter()
        resumed = sampled_engine(game, "fused", r_all).restore(path)
        restore_s = time.perf_counter() - t0
    drive_sampled("fleet10000/resume", resumed)
    resume = (same_bits(sampled_leaves(resumed), first)
              and [r.residual for r in resumed.trace.rounds]
              == first_res[SAMPLED_SAVE:])
    check(resume, "sampled/fleet10000: the resumed run differs")
    del resumed
    emit("sampled_checks", run="fleet10000", backend="fused",
         undrawn_rows_frozen=frozen, rerun_bit_identical=rerun,
         saved_round=SAMPLED_SAVE, checkpoint_bytes=size, save_s=save_s,
         restore_s=restore_s, resume_bit_identical=resume)

    ref = sampled_engine(game, "reference", r_all)
    res_r, sec_r, _ = drive_sampled("fleet10000/reference", ref)
    del ref
    gaps = hold_fused_vs_reference("sampled", "fleet10000", first_res,
                                   res_r)
    emit("sampled", run="fleet10000", backend="reference", fleet=fleet,
         sample=lanes, rounds=r_all, residuals=res_r,
         ms_per_local_step=sec_r * 1e3 / (r_all * K), rel_gap=gaps)
    del first
    torch.cuda.empty_cache()

    # sampled/stack: q8 + EF, faults, a sign-flip attack under a trimmed
    # mean, and outer Nesterov, fused and reference; counted from the
    # engine's start, whose outer-optimizer anchor is the one B5 call on
    # the whole (10000, n) store (a launch a leaf)
    stack = dict(compressor=StochasticQuantizeCompressor(bits=8),
                 faults=BernoulliFaults(**CODEC_FAULTS),
                 byzantine=SignFlipAttack(**ATTACK),
                 aggregator=TrimmedMean(beta=0.2),
                 server_opt=ServerNesterov(lr=1.0, beta=0.3))
    stack_res = {}
    for backend in ("fused", "reference"):
        reset_launches()
        eng = sampled_engine(game, backend, SAMPLED_STACK_R, **stack)
        res, sec, counts = drive_sampled(f"stack/{backend}", eng,
                                         reset=False)
        recs = eng.trace.rounds
        check(all(set(r.byzantine_workers) <= set(r.sampled_workers)
                  for r in recs),
              f"sampled/stack {backend}: an attacker was not drawn")
        check(all(r.delta_norm is not None and math.isfinite(r.delta_norm)
                  for r in recs), f"sampled/stack {backend}: bad outer step")
        check(int(eng._srv[2]) == SAMPLED_STACK_R,
              f"sampled/stack {backend}: the outer clock is not per round")
        if backend == "fused":
            launched("stack", counts, {
                "adaseg_explore": None, "adaseg_anchor": None,
                "uplink_stats": None, "quantize_uplink": None,
                "trimmed_merge_stacked": None, "outer_apply": None,
                "merge_stacked": leaves_n})
        stack_res[backend] = res
        emit("sampled", run="stack", backend=backend, fleet=fleet,
             sample=lanes, rounds=SAMPLED_STACK_R, residuals=res,
             ms_per_local_step=sec * 1e3 / (SAMPLED_STACK_R * K),
             byzantine_workers=[r.byzantine_workers for r in recs],
             alive=[sum(r.alive) for r in recs],
             delta_norm=[r.delta_norm for r in recs],
             **({"launches": {k: v for k, v in counts.items() if v}}
                if backend == "fused" else {}))
        del eng
        torch.cuda.empty_cache()
    hold_fused_vs_reference("sampled", "stack", stack_res["fused"],
                            stack_res["reference"])

    # sampled/async512: bench_fleet.py's async fleet
    def async_sampled(tau, backend="fused"):
        from repro_torch import random as jr
        from repro_torch.core import AdaSEGConfig
        from repro_torch.ps import (
            AsyncPSConfig,
            AsyncPSEngine,
            ClientSampler,
            ConstantLatency,
        )

        cfg = AsyncPSConfig(
            adaseg=AdaSEGConfig(g0=G0, diameter=DIAMETER, k=K),
            num_workers=SAMPLED_ASYNC_FLEET, rounds=r_all, backend=backend,
            codec_backend=backend,
            sampler=ClientSampler(sample=lanes, seed=SAMPLED_SEED),
            latency=ConstantLatency(**SAMPLED_LATENCY), staleness_bound=tau)
        return AsyncPSEngine(game.problem, cfg, rng=jr.PRNGKey(1),
                             eval_fn=game.residual)

    def drive_async(label, eng, until_admissions=None, whole=True):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zbar = eng.run(until_admissions=until_admissions)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = launches()
        if until_admissions is None:
            res = [r.residual for r in eng.trace.rounds]
            check(eng.done and all(v is not None and math.isfinite(v)
                                   for v in res),
                  f"sampled/{label}: unfinished or non-finite {res}")
            check(all(bool(torch.isfinite(v).all()) for v in zbar),
                  f"sampled/{label}: bad output")
            check(not whole or eng.trace.total_steps == r_all * lanes * K,
                  f"sampled/{label}: local steps are not R*S*K")
        return seconds, counts

    for label, tau in (("tauinf", math.inf), ("tau2", 2.0)):
        e_f = async_sampled(tau)
        sec, counts = drive_async(f"async512/{label}", e_f)
        launched(f"async512/{label}", counts,
                 {"adaseg_explore": None, "adaseg_anchor": None})
        emit_async(f"sampled/async512/{label}", tau, "fused", e_f, sec,
                   counts, fleet=SAMPLED_ASYNC_FLEET, sample=lanes,
                   local_steps=e_f.trace.total_steps)
        if label == "tauinf":
            del e_f
            continue
        first_async = async_leaves(e_f)
        res_f = [r.residual for r in e_f.trace.rounds]
        e_r = async_sampled(tau, "reference")
        sec_r, counts_r = drive_async(f"async512/{label}/reference", e_r)
        check(async_host(e_r) == async_host(e_f)
              and e_r.sim_time == e_f.sim_time,
              "sampled/async512: host records differ between the backends")
        gaps = hold_fused_vs_reference(
            "sampled", "async512", res_f,
            [r.residual for r in e_r.trace.rounds])
        emit_async(f"sampled/async512/{label}", tau, "reference", e_r,
                   sec_r, counts_r, rel_gap=gaps)
        del e_r
        again = async_sampled(tau)
        drive_async(f"async512/{label}/rerun", again)
        rerun = (same_bits(async_leaves(again), first_async)
                 and async_host(again) == async_host(e_f)
                 and again.sim_time == e_f.sim_time
                 and [r.residual for r in again.trace.rounds] == res_f)
        check(rerun, "sampled/async512: the rerun is not bit-identical")
        del again
        kill = max(1, e_f.n_admissions // 2)
        part = async_sampled(tau)
        drive_async(f"async512/{label}/part", part, until_admissions=kill)
        check(not part.done, "sampled/async512: the kill point is not "
              "mid-queue")
        with tempfile.TemporaryDirectory() as tmp:
            path = str(Path(tmp) / "async.ckpt")
            part.save(path)
            resumed = async_sampled(tau).restore(path)
        drive_async(f"async512/{label}/resume", resumed, whole=False)
        resume = (same_bits(async_leaves(resumed), first_async)
                  and async_host(resumed) == async_host(e_f)[kill:]
                  and [r.residual for r in resumed.trace.rounds]
                  == res_f[kill:])
        check(resume, "sampled/async512: the resumed run differs")
        emit("sampled_checks", run=f"async512/{label}", backend="fused",
             rerun_bit_identical=rerun, kill_at_admission=kill,
             resume_bit_identical=resume)
        del part, resumed, e_f
    torch.cuda.empty_cache()
    emit("sampled_phase", nvidia_smi=smi,
         seconds=time.perf_counter() - t_phase)


def zoo_methods(g0, diameter, lr, k=K):
    """LocalAdaSEG's config and the five zoo workers, by row name."""
    from repro_torch.core import AdaSEGConfig
    from repro_torch.optim import (
        MinimaxWorker,
        adam_minimax,
        asmp,
        segda,
        sgda,
        ump,
    )

    return {
        "adaseg": dict(adaseg=AdaSEGConfig(g0=g0, diameter=diameter, k=k)),
        "sgda": dict(worker=MinimaxWorker(sgda(lr)), local_k=k),
        "segda": dict(worker=MinimaxWorker(segda(lr)), local_k=k),
        "adam": dict(worker=MinimaxWorker(adam_minimax(ZOO_ADAM_LR)),
                     local_k=k),
        "ump": dict(worker=MinimaxWorker(ump(g0, diameter)), local_k=k),
        "asmp": dict(worker=MinimaxWorker(asmp(g0, diameter)), local_k=k),
    }


def run_zoo_engine(problem, eval_fn, method_kw, backend, rounds, policies,
                   k=K):
    """One PSEngine run on the card of the optimizer in ``method_kw``
    (``adaseg=`` a config, or ``worker=`` and ``local_k=``) under
    ``policies`` (PSConfig's compressor, schedule, faults, ...), fused or
    reference: (residuals, ms per local step of the fleet, the engine)."""
    import torch

    from repro_torch import random as jr
    from repro_torch.ps import PSConfig, PSEngine

    step_kw = dict(backend=backend) if "adaseg" in method_kw else {}
    eng = PSEngine(problem, PSConfig(num_workers=M, rounds=rounds,
                                     codec_backend=backend, **step_kw,
                                     **method_kw, **policies),
                   rng=jr.PRNGKey(1), eval_fn=eval_fn)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zbar = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = [r.residual for r in eng.trace.rounds]
    check(all(v is not None and math.isfinite(v) for v in res),
          f"{eng.worker.name} {backend}: non-finite residual {res}")
    check(all(bool(torch.isfinite(v).all()) for v in zbar),
          f"{eng.worker.name} {backend}: non-finite output iterate")
    return res, wall * 1e3 / (rounds * k), eng


def hold_fused_vs_reference(label, name, res_f, res_r):
    """Fused against reference within TOL_TRACE in every round; returns
    the per-round relative gaps."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(res_f, res_r)]
    check(max(gaps) <= TOL_TRACE,
          f"{label}/{name}: fused vs reference residuals differ by {gaps}")
    return gaps


def phase_zoo(game, smi):
    """The paper's Fig. 4 comparison through the port's PSEngine on the
    main game: LocalAdaSEG and the five zoo methods, clean and hostile
    (Dirichlet-heterogeneous workers, elastic stragglers, q8 with error
    feedback, faults), fused and reference; then the robust row at a9a's
    widths, with a rerun that must repeat to the bit."""
    import torch

    from repro_torch import random as jr
    from repro_torch.core import kkt_residual
    from repro_torch.problems import make_robust_logistic
    from repro_torch.ps import (
        BernoulliFaults,
        ElasticSchedule,
        StochasticQuantizeCompressor,
        StragglerSchedule,
        heterogeneous_bilinear,
        heterogeneous_robust,
    )

    # ‖A‖₂ by power iterations (A is symmetric)
    v = torch.randn(N, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    for _ in range(ZOO_POWER_ITERS):
        v = game.a @ v
        a_norm = float(torch.linalg.vector_norm(v))
        v = v / a_norm
    lr = 1.0 / (2.0 * a_norm)
    emit("zoo_setup", nvidia_smi=smi, a_norm_2=a_norm,
         power_iterations=ZOO_POWER_ITERS, sgda_segda_lr=lr,
         adam_lr=ZOO_ADAM_LR, g0=G0, diameter=DIAMETER)

    hostile = dict(
        schedule=ElasticSchedule(StragglerSchedule(**HOSTILE["schedule"]),
                                 dropout=HOSTILE["dropout"],
                                 seed=HOSTILE["dropout_seed"]),
        compressor=StochasticQuantizeCompressor(bits=8),
        faults=BernoulliFaults(**HOSTILE["faults"]))
    scenarios = {
        "clean": (game.problem, {}),
        "hostile": (heterogeneous_bilinear(game, M, jr.PRNGKey(HOSTILE["key"]),
                                           alpha=HOSTILE["alpha"]), hostile),
    }
    for label, (problem, policies) in scenarios.items():
        for name, method_kw in zoo_methods(G0, DIAMETER, lr).items():
            reset_launches()
            res_f, ms_f, eng = run_zoo_engine(problem, game.residual,
                                              method_kw, "fused", R, policies)
            path_launches = launches()
            res_r, ms_r, eng_r = run_zoo_engine(problem, game.residual,
                                                method_kw, "reference", R,
                                                policies)
            check(path_launches["merge_stacked"] > 0,
                  f"zoo {label}/{name}: merge_stacked never launched")
            if label == "hostile":
                for k in ("uplink_stats", "quantize_uplink"):
                    check(path_launches[k] > 0,
                          f"zoo hostile/{name}: {k} never launched")
            if name == "adaseg" and label == "clean":
                for k in ("adaseg_explore", "adaseg_anchor"):
                    check(path_launches[k] > 0,
                          f"zoo clean/adaseg: {k} never launched")
            if label == "clean" and name in ADAPTIVE:
                check(res_f[-1] < res_f[0] and res_r[-1] < res_r[0],
                      f"zoo clean/{name}: residual did not fall: {res_f}, "
                      f"{res_r}")
            gaps = hold_fused_vs_reference(label, name, res_f, res_r)
            for backend, res, ms, e in (("fused", res_f, ms_f, eng),
                                        ("reference", res_r, ms_r, eng_r)):
                rounds = e.trace.rounds
                emit("zoo", scenario=label, method=name,
                     optimizer=e.worker.name, backend=backend,
                     nvidia_smi=smi, residuals=res, ms_per_local_step=ms,
                     steps_per_round=[sum(r.local_steps) for r in rounds],
                     bytes_up_per_round=[r.bytes_up for r in rounds],
                     **({"launches": path_launches} if backend == "fused"
                        else {"rel_gap_vs_fused": gaps}))
            del eng, eng_r
    torch.cuda.empty_cache()

    # The robust row: heterogeneous robust logistic regression at a9a's
    # widths, G0 from the first oracle call's norm.
    t0 = time.perf_counter()
    rl = make_robust_logistic(jr.PRNGKey(2), n=A9A["n"], d=A9A["d"],
                              batch=A9A["batch"], lam=A9A["lam"],
                              radius=A9A["radius"])
    problem = heterogeneous_robust(rl, M, jr.PRNGKey(8), alpha=0.4,
                                   num_groups=ROBUST_GROUPS)
    keys = jr.split(jr.PRNGKey(9), M)
    z0 = problem.project(problem.init(keys))
    g = problem.oracle(z0, problem.sample_worker(
        keys, torch.arange(M, device="cuda")))
    g0 = float(torch.sqrt(sum(v.square().sum(dim=1) for v in g)).median())
    ids = torch.arange(M, device="cuda")
    draw_ms = time_ms(lambda: problem.sample_worker(keys, ids), reps=2,
                      trials=3)
    diameter = math.sqrt((2 * A9A["radius"]) ** 2 + 2.0)
    lr_r = diameter / (g0 * math.sqrt(ROBUST_K * ROBUST_ROUNDS))

    def eval_fn(z):
        return kkt_residual(problem, z)

    emit("zoo_robust_setup", nvidia_smi=smi, **A9A, workers=M, k=ROBUST_K,
         rounds=ROBUST_ROUNDS, groups=ROBUST_GROUPS, alpha=0.4, g0=g0,
         diameter=diameter, sgda_segda_lr=lr_r, draw_ms=draw_ms,
         seconds=time.perf_counter() - t0)
    finals = {}
    robust_methods = zoo_methods(g0, diameter, lr_r, ROBUST_K)
    for name, method_kw in robust_methods.items():
        reset_launches()
        res_f, ms_f, eng = run_zoo_engine(problem, eval_fn, method_kw,
                                          "fused", ROBUST_ROUNDS, {},
                                          ROBUST_K)
        path_launches = launches()
        res_r, ms_r, _ = run_zoo_engine(problem, eval_fn, method_kw,
                                        "reference", ROBUST_ROUNDS, {},
                                        ROBUST_K)
        check(path_launches["merge_stacked"] > 0,
              f"zoo robust/{name}: merge_stacked never launched")
        gaps = hold_fused_vs_reference("robust_a9a", name, res_f, res_r)
        emit("zoo", scenario="robust_a9a", method=name,
             optimizer=eng.worker.name, nvidia_smi=smi,
             residuals_fused=res_f, residuals_reference=res_r,
             ms_per_local_step_fused=ms_f, ms_per_local_step_reference=ms_r,
             launches=path_launches, rel_gap=gaps)
        finals[name] = (res_f, eng)
    # rerun of one method: the deterministic scatter repeats to the bit
    res_1, eng_1 = finals["ump"]
    res_2, ms_2, eng_2 = run_zoo_engine(problem, eval_fn,
                                        robust_methods["ump"], "fused",
                                        ROBUST_ROUNDS, {}, ROBUST_K)
    same = res_1 == res_2 and all(
        torch.equal(a, b) for a, b in zip(
            [*eng_1.state.z, *eng_1.state.z_bar, eng_1.state.inner["sum_sq"]],
            [*eng_2.state.z, *eng_2.state.z_bar, eng_2.state.inner["sum_sq"]]))
    emit("zoo_rerun", scenario="robust_a9a", method="ump", backend="fused",
         nvidia_smi=smi, ms_per_local_step=ms_2, bit_identical=same,
         residuals=res_2)
    check(same, "zoo robust_a9a/ump: the rerun differs from the first run")


def phase_flash_kernels(results):
    """The flash-attention kernel (B12) against its plain version at the
    path's shape and its variants (``FLASH_VARIANTS``), and its time beside
    the plain version and, where it computes the same function,
    ``scaled_dot_product_attention``."""
    import torch
    import torch.nn.functional as tnf

    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ref as fr

    dev = torch.device("cuda")

    def inputs(seed, b, h, kh, s, d):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(*shape, generator=gen, device=dev)
                for shape in ((b, h, s, d), (b, kh, s, d), (b, kh, s, d))]

    def pairs(s, window):
        """(query, key) pairs the causal mask (and window) leaves."""
        i = torch.arange(s, dtype=torch.float64)
        return float((torch.minimum(i + 1, torch.tensor(float(window)))
                      if window else i + 1).sum())

    err_all = 0.0
    for label, var in FLASH_VARIANTS.items():
        shape = {**FLASH_SHAPE, **{k: v for k, v in var.items()
                                   if k in FLASH_SHAPE}}
        opts = {k: v for k, v in var.items() if k not in FLASH_SHAPE}
        b, h, kh, s, d = (shape[k] for k in ("b", "h", "kh", "s", "d"))
        q, k, v = inputs(1, b, h, kh, s, d)
        got = fk.flash_attention(q, k, v, causal=True, **opts)
        again = fk.flash_attention(q, k, v, causal=True, **opts)
        want = fr.attention_ref(q, k, v, causal=True, **opts)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        err_all = max(err_all, err)
        check(err <= TOL_FLASH, f"flash_attention {label}: max abs err {err}")
        check(torch.equal(got, again),
              f"flash_attention {label}: a rerun differs")
        # 12 input sets of 5.2 MB (more at D=128, 16 heads or D=256)
        # exceed the 50 MB L2
        sets = [inputs(100 + i, b, h, kh, s, d) for i in range(12)]
        ms = graph_ms([lambda x=x: fk.flash_attention(*x, causal=True,
                                                      **opts)
                       for x in sets * 2])
        plain_ms = graph_ms([lambda x=x: fr.attention_ref(*x, causal=True,
                                                          **opts)
                             for x in sets])
        n_pairs = pairs(s, opts.get("window")) * b * h
        flops = 4.0 * d * n_pairs
        bytes_moved = 4.0 * (2 * b * h * s * d + 2 * b * kh * s * d)
        # the faster of two routes to f32-accurate products: f32 FMAs, or
        # the split product's three TF32 terms on the tensor cores beside one
        # exponential a visible pair on the MUFU
        t_bytes = bytes_moved / CARD["hbm_bytes_per_s"] * 1e3
        b_ms = min(bound(bytes_moved, flops)[0],
                   max(t_bytes, 3 * flops / TF32_FLOPS_PER_S * 1e3,
                       n_pairs / CARD["mufu_per_s"] * 1e3))
        b_by = "bytes" if b_ms == t_bytes else "operations"
        row = dict(name="flash_attention", route="cuda",
                   source="src/repro_torch/csrc/flash_attention.cu",
                   replaces="src/repro/kernels/flash_attention/kernel.py:97",
                   launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        extra = {}
        if "softcap" not in opts:
            # one PyTorch call of the same function (causal GQA, a binding
            # window as a boolean mask), timed as a yardstick; it has no
            # out= form, so only the fresh-output pairing
            window = opts.get("window")
            if window and window < s:
                i = torch.arange(s, device=dev)
                band = (i[None, :] <= i[:, None]) & (
                    i[None, :] > i[:, None] - window)
                sdpa_kw = dict(attn_mask=band, enable_gqa=True)
                sdpa_name = "attn_mask=band"
            else:
                sdpa_kw = dict(is_causal=True, enable_gqa=True)
                sdpa_name = "is_causal=True"
            sdpa_err = max_abs(tnf.scaled_dot_product_attention(
                q, k, v, **sdpa_kw), want)
            row["library_ms"], pairing = library_times(
                "flash_attention",
                lambda x: tnf.scaled_dot_product_attention(*x, **sdpa_kw),
                "torch.nn.functional.scaled_dot_product_attention("
                f"{sdpa_name}, enable_gqa=True), f32, TF32 off",
                sets * 2, lambda x: fk.flash_attention(*x, causal=True,
                                                       **opts), ms,
                same_out=False)
            extra.update(pairing, library_max_abs_err=sdpa_err)
        emit("kernel", **row, variant=label, shape=shape, options=opts,
             tflops=flops / (ms * 1e-3) / 1e12, **extra)
        if label == "path":
            results["flash_attention"] = dict(row)
    results["flash_attention"]["max_abs_err"] = err_all


def phase_ssd_kernels(results):
    """The SSD scan kernel (B13) against its plain version (the Pallas
    kernel's chunk loop) and the sequential recurrence, at the mamba2 path's
    shape and three variants; each of its three launches against the plain
    versions of its phases; timed beside the plain version."""
    import torch
    import torch.nn.functional as tnf

    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ref as sr

    dev = torch.device("cuda")

    def inputs(seed, b, l, h, p, n):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(b, l, h, p, generator=gen, device=dev)
        dt = tnf.softplus(torch.randn(b, l, h, generator=gen, device=dev))
        a = -torch.linspace(1.0, 16.0, h, device=dev)
        bc = torch.randn(2, b, l, n, generator=gen, device=dev)
        return x, dt, a, bc[0], bc[1]

    def rel(got, want):
        return max_abs(got, want) / float(want.abs().max())

    def views(args, lead):
        """x, b and c as views of one packed row of ``lead`` + H·P + 2N
        floats, as the model's split of its conv output hands them in."""
        x, dt, a, b, c = args
        bsz, l, h, p = x.shape
        n = b.shape[-1]
        packed = torch.cat([torch.zeros(bsz, l, lead, device=dev),
                            x.reshape(bsz, l, h * p), b, c], dim=-1)
        _, xv, bv, cv = torch.split(packed, [lead, h * p, n, n], dim=-1)
        return xv.reshape(bsz, l, h, p), dt, a, bv, cv

    def check_phases(label, args, q):
        """Each launch against the plain versions of its phases, fed what
        the earlier launches wrote; returns the errors."""
        x, dt, a, b, c = args
        p = x.shape[-1]
        out = sk.ssd_scan_phases(*args, chunk=q, phases=("cb_state",))
        torch.cuda.synchronize()
        cum = out.cum.clone()
        errs = dict(cb_cum=rel(cum, sr.chunk_cum_ref(dt, a, q)),
                    cb_gram=rel(out.gram(q), sr.chunk_gram_ref(b, c, q)))
        own = sr.chunk_states_ref(x, dt, b, cum)
        nc = cum.shape[1]
        entering = torch.zeros_like(own)
        if nc > 1:
            states = out.state_slots(p).clone()
            errs["chunk_state"] = rel(states, own[:, :-1])
            sk.ssd_scan_phases(*args, chunk=q, phases=("state_pass",),
                               out=out)
            torch.cuda.synchronize()
            entering[:, 1:] = out.state_slots(p)
            want = sr.state_pass_ref(
                torch.cat([states, own[:, -1:]], dim=1), cum)
            errs["state_pass"] = rel(entering, want)
        sk.ssd_scan_phases(*args, chunk=q, phases=("chunk_scan",), out=out)
        torch.cuda.synchronize()
        errs["chunk_scan"] = rel(out.y, sr.chunk_scan_ref(
            x, dt, c, out.gram(q), cum, entering))
        for phase, err in errs.items():
            check(err <= TOL_SSD_PHASE,
                  f"ssd_scan {label} {phase}: {err} of the largest entry "
                  "off the plain version of the phase")
        return errs

    err_all = 0.0
    for label, var in SSD_VARIANTS.items():
        shape = {**SSD_SHAPE, **var}
        b, l, h, p, n, q = (shape[k] for k in ("b", "l", "h", "p", "n", "q"))
        args = inputs(1, b, l, h, p, n)
        got = sk.ssd_scan(*args, chunk=q)
        again = sk.ssd_scan(*args, chunk=q)
        want = sr.ssd_scan_ref(*args, chunk=q)
        oracle = sr.ssd_ref(*args)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        err_all = max(err_all, err)
        errs = dict(rel_err=rel(got, want), oracle_rel_err=rel(got, oracle),
                    plain_oracle_rel_err=rel(want, oracle))
        check(bool(torch.isfinite(got).all()), f"ssd_scan {label}: not finite")
        check(torch.equal(got, again), f"ssd_scan {label}: reruns differ")
        # x, b and c as the model hands them in (lead 0), and a float off
        # 16-byte alignment (every copy 4 bytes at a time)
        for lead in (0, 1):
            strided = sk.ssd_scan(*views(args, lead), chunk=q)
            check(torch.equal(strided, got),
                  f"ssd_scan {label}: strided views (lead {lead}) give "
                  "another result")
        check(errs["rel_err"] <= TOL_SSD,
              f"ssd_scan {label}: {errs['rel_err']} of max |y| off the plain "
              "version")
        check(errs["oracle_rel_err"] <= TOL_SSD_ORACLE,
              f"ssd_scan {label}: {errs['oracle_rel_err']} of max |y| off "
              "the recurrence")
        phase_errs = check_phases(label, args, q)
        # The least work of the function over the Q(Q+1)/2 visible pairs
        # of each chunk: C.B^T (N per pair) once per (batch, chunk), since
        # every head shares B and C; per head L.xdt (P per pair), C.S and
        # the state update (N.P each, per row).
        pairs = q * (q + 1) // 2
        flops = 2.0 * b * (l // q) * (pairs * n + h * (pairs * p
                                                        + 2 * q * n * p))
        nbytes = 4.0 * (2 * b * l * h * p + 2 * b * l * n + b * l * h + h)
        # input sets cycled so the bytes in flight exceed the 50 MB L2
        sets = [inputs(100 + i, b, l, h, p, n)
                for i in range(max(2, math.ceil(60e6 / nbytes)))]
        ms = graph_ms([lambda x=x: sk.ssd_scan(*x, chunk=q)
                       for x in sets * 2])
        plain_ms = graph_ms([lambda x=x: sr.ssd_scan_ref(*x, chunk=q)
                             for x in sets])
        # each launch of the call alone, on scratch the whole call filled
        outs = [sk.ssd_scan_phases(*x, chunk=q) for x in sets]
        phase_ms = {
            name: graph_ms([
                lambda x=x, o=o, name=name: sk.ssd_scan_phases(
                    *x, chunk=q, phases=(name,), out=o)
                for x, o in zip(sets * 2, outs * 2)])
            for name in sk.PHASES}
        emit("kernel_phase", name="ssd_scan", variant=label,
             us={k: v * 1e3 for k, v in phase_ms.items()},
             launches_sum_us=sum(phase_ms.values()) * 1e3,
             call_us=ms * 1e3, max_rel_err=phase_errs)
        b_ms, b_by = bound(nbytes, flops)
        row = dict(name="ssd_scan", route="cuda",
                   source="src/repro_torch/csrc/ssd_scan.cu",
                   replaces="src/repro/kernels/ssd_scan/kernel.py:72",
                   launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None)
        emit("kernel", **row, variant=label, shape=shape, **errs,
             flops=flops, tflops=flops / (ms * 1e-3) / 1e12,
             library="none: no one PyTorch call computes the SSD scan")
        if label == "path":
            results["ssd_scan"] = row
    results["ssd_scan"]["max_abs_err"] = err_all


def lm_plan(cfg, m, k, seq, batch):
    from repro_torch.core import AdaSEGConfig
    from repro_torch.launch import TrainPlan

    return TrainPlan(cfg=cfg, adaseg=AdaSEGConfig(
        g0=20.0, diameter=2.0, alpha=1.0 / math.sqrt(m), k=k,
        average_output=False), worker_mode="paper", k_local=k,
        global_batch=m * batch, seq=seq, workers_override=m)


def run_lm(plan, backend, rounds, device="cuda"):
    """One ``make_ps_engine`` run: (eval losses, ms per local step, engine,
    set-up seconds)."""
    import torch

    from repro_torch import random as jr
    from repro_torch.launch import make_ps_engine
    from repro_torch.models import param_tree

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    eng = make_ps_engine(plan, jr.PRNGKey(0, device=device), rounds=rounds,
                         backend=backend, codec_backend=backend,
                         device=device)
    sync()
    t1 = time.perf_counter()
    zbar = eng.run()
    sync()
    wall = time.perf_counter() - t1
    losses = [r.residual for r in eng.trace.rounds]
    check(all(v is not None and math.isfinite(v) for v in losses),
          f"lm {backend}: non-finite eval loss {losses}")
    param_tree(zbar, plan.cfg)       # z̄ has the model's leaves
    check(all(bool(torch.isfinite(v).all()) for v in zbar),
          f"lm {backend}: non-finite output iterate")
    return losses, wall * 1e3 / (rounds * plan.k_local), eng, t1 - t0


def lm_warmup(label, cfg):
    """One full-width gradient of one worker, so the timed runs do not pay
    the first call's module loads."""
    import gc

    import torch

    from repro_torch import random as jr
    from repro_torch.models import make_lm_problem

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prob = make_lm_problem(cfg, batch=LM_BATCH, seq=LM_SEQ)
    keys = jr.split(jr.PRNGKey(7), 1)
    prob.oracle(prob.init(keys), prob.sample(keys))
    torch.cuda.synchronize()
    emit(f"{label}_warmup", seconds=time.perf_counter() - t0)
    del prob
    gc.collect()
    torch.cuda.empty_cache()


def lm_run(label, plan, backend, kernel):
    """One full-width ``make_ps_engine`` run (``run_lm``, R=LM_R) with the
    path's checks: ``kernel`` launched once per layer of its kind per
    forward (two oracle calls a worker a local step, one eval a round),
    B1, B2 and B5 launched on the fused backend, the peak memory within
    budget. Emits the ``label`` line; returns (eval losses, ms per local
    step, engine, launches)."""
    import torch

    cfg, m = plan.cfg, plan.workers_override
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, ms, eng, setup_s = run_lm(plan, backend, LM_R)
    counts = launches()
    peak = torch.cuda.max_memory_allocated()
    forwards = LM_R * LM_K * 2 * m + LM_R     # 2 oracle calls, 1 eval
    layers = sum(kind["kind"] == KERNEL_KIND[kernel]
                 for kind in cfg.layer_kinds())
    check(counts[kernel] == layers * forwards,
          f"{label} {backend}: {kernel} launched {counts[kernel]} "
          f"times, expected {layers} x {forwards} forwards")
    if backend == "fused":
        for name in ("adaseg_explore", "adaseg_anchor", "merge_stacked"):
            check(counts[name] > 0,
                  f"{name} never launched on the {label} path")
    check(peak <= LM_MEMORY_BUDGET,
          f"{label} {backend}: peak device memory {peak / 1e9:.1f} GB")
    emit(label, arch=cfg.name, backend=backend, workers=m,
         batch=LM_BATCH, seq=LM_SEQ, k=LM_K, rounds=LM_R,
         params_per_worker=sum(v[0].numel() for v in eng.state.z_tilde),
         eval_losses=losses, ms_per_local_step=ms, setup_seconds=setup_s,
         tokens_per_s=2 * m * LM_BATCH * LM_SEQ / (ms * 1e-3),
         peak_memory_bytes=peak, forwards=forwards, kernel_layers=layers,
         launches=counts)
    return losses, ms, eng, counts


def count_path(results, kernel, label, counts):
    """A path's launches of ``kernel`` on its kernel line: ``launches``
    holds the first path's count (the lm path's for B12), and
    ``launches_by_path`` every path's."""
    paths = results[kernel].setdefault("launches_by_path", {})
    if not paths:
        results[kernel]["launches"] = counts[kernel]
    paths[label] = counts[kernel]


def lm_state_gradient(plan, eng):
    """The fused run's final state, one token draw, the fleet's gradient
    there and the eval loss: what the breakdown and ``step_diff`` take."""
    from repro_torch import random as jr
    from repro_torch.models import make_eval_loss

    prob, st = eng.problem, eng.state
    keys = jr.split(jr.PRNGKey(5), plan.workers_override)
    xi = prob.sample(keys)
    g = prob.oracle(st.z_tilde, xi)
    eval_fn = make_eval_loss(plan.cfg, batch=LM_BATCH, seq=LM_SEQ)
    return prob, st, keys, xi, g, eval_fn


def lm_breakdown(label, plan, eng, ms, prob, st, keys, xi, g, eval_fn):
    """The fused ms per local step split into its parts, each timed alone:
    two token draws and two gradients of the fleet, explore + anchor over
    every leaf; a sync and an eval per round, spread over its K steps."""
    from repro_torch.core.adaseg import eta_of
    from repro_torch.kernels.adaseg_update.ops import (
        adaseg_tree_anchor,
        adaseg_tree_explore,
    )
    from repro_torch.kernels.sync_compress.ops import sync_merge_stacked

    draw_ms = time_ms(lambda: prob.sample(keys), reps=2, trials=3)
    grad_ms = time_ms(lambda: prob.oracle(st.z_tilde, xi), reps=1,
                      trials=3)
    kw = dict(sum_sq=st.sum_sq, g0=plan.adaseg.g0,
              d_alpha=plan.adaseg.diameter * plan.adaseg.alpha,
              proj=("identity",))

    def update():
        z_t, _ = adaseg_tree_explore(st.z_tilde, g, **kw)
        adaseg_tree_anchor(st.z_tilde, z_t, g, **kw)

    update_ms = time_ms(update, reps=2, trials=3)
    w = 1.0 / eta_of(plan.adaseg, st.sum_sq)
    w = w / w.sum()
    sync_ms = time_ms(lambda: sync_merge_stacked(st.z_tilde, w),
                      reps=2, trials=3)
    zbar = eng.z_bar()
    eval_ms = time_ms(lambda: eval_fn(zbar), reps=2, trials=3)
    parts = dict(token_draws=2 * draw_ms, forward_backward=2 * grad_ms,
                 update_kernels=update_ms, sync=sync_ms / LM_K,
                 eval=eval_ms / LM_K)
    emit(f"{label}_breakdown", backend="fused", ms_per_local_step=ms,
         **parts, rest=ms - sum(parts.values()))


def lm_compare(label, runs):
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["fused"],
                                                 runs["reference"]))
    emit(f"{label}_compare", fused=runs["fused"], reference=runs["reference"],
         max_rel=rel)
    check(rel <= TOL_LM_TRACE,
          f"{label}: fused vs reference eval losses differ by {rel}")


def train_lm(results, label, cfg, kernel, m=LM_M, rerun=None):
    """``cfg`` at full width through the port's make_ps_engine, fused and
    reference (``m`` workers, 1 x 1024 tokens per worker, K=4, R=2,
    identity codec): finite eval losses that agree within TOL_LM_TRACE,
    ``kernel`` launched once per layer of its kind per forward, the peak
    memory within budget, and the fused run's ms per local step split into
    its parts; with ``rerun``, a second oracle call of the fused run's last
    gradient, emitted under that label (``oracle_rerun``)."""
    import gc

    import torch

    lm_warmup(label, cfg)
    plan = lm_plan(cfg, m, LM_K, LM_SEQ, LM_BATCH)
    runs = {}
    for backend in ("fused", "reference"):
        losses, ms, eng, counts = lm_run(label, plan, backend, kernel)
        runs[backend] = losses
        if backend == "fused":
            count_path(results, kernel, label, counts)
            parts = lm_state_gradient(plan, eng)
            lm_breakdown(label, plan, eng, ms, *parts)
            prob, st, _, xi, g, eval_fn = parts
            if rerun:
                oracle_rerun(rerun, prob, st, xi, g)
            step_diff(label, plan, prob, st, g, eval_fn)
            del parts, prob, st, xi, g, eval_fn
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    lm_compare(label, runs)


def leaf_names(tree, prefix=""):
    """Dotted leaf paths in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [name for k in sorted(tree)
                for name in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (tuple, list)):
        return [name for i, v in enumerate(tree)
                for name in leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def step_diff(label, plan, prob, st, g, eval_fn):
    """One update z* − η·g from the fused run's final state and one
    gradient (as M_t and as g_t), through the update kernels (B1 with η
    given and η fused from sum_sq, then B2) and through the reference
    backend's tensor ops, leaf by leaf: how many entries of z_t and z̃
    differ, by how much, and how many of B1's entries differ from z* − η·g
    rounded once (formed in f64). Then the (Z_t)² statistic of both, the
    eval loss at worker 0's z_t after each update, and the merge kernel
    (B5) against the reference's weighted mean of z*."""
    import torch

    from repro_torch.core.adaseg import eta_of
    from repro_torch.core.tree import per_worker, tree_axpy, tree_norm_sq
    from repro_torch.kernels.adaseg_update.ops import (
        adaseg_tree_anchor,
        adaseg_tree_explore,
    )
    from repro_torch.kernels.sync_compress.ops import sync_merge_stacked
    from repro_torch.models.transformer import param_template

    names = leaf_names(param_template(plan.cfg))
    eta = eta_of(plan.adaseg, st.sum_sq)
    kw = dict(sum_sq=st.sum_sq, g0=plan.adaseg.g0,
              d_alpha=plan.adaseg.diameter * plan.adaseg.alpha,
              proj=("identity",))
    w = 1.0 / eta
    w = w / w.sum()
    rows, kernel_z, ref_z = [], [], []
    stat_k = stat_r = 0.0
    for name, z, gl in zip(names, st.z_tilde, g):
        (zk,), _ = adaseg_tree_explore((z,), (gl,), eta=eta,
                                       proj=("identity",))
        (zf,), _ = adaseg_tree_explore((z,), (gl,), **kw)
        (zr,) = prob.project(tree_axpy(-eta, (gl,), (z,)))
        (ak,), stat, _ = adaseg_tree_anchor((z,), (zk,), (gl,), eta=eta,
                                            proj=("identity",))
        (ar,) = prob.project(tree_axpy(-eta, (gl,), (z,)))
        stat_k = stat_k + stat
        stat_r = (stat_r + tree_norm_sq((zr - z,))
                  + tree_norm_sq((zr - ar,)))
        e = per_worker(eta, z).double()
        off_once = 0
        step = 1 << 22
        fz, fg, fk = (v.reshape(v.shape[0], -1) for v in (z, gl, zk))
        for i in range(0, fz.shape[1], step):
            once = (fz[:, i:i + step].double()
                    - e.reshape(-1, 1) * fg[:, i:i + step].double()).float()
            off_once += int((fk[:, i:i + step] != once).sum())
        (mk,) = sync_merge_stacked((z,), w, normalize=True)
        mr = torch.sum(per_worker(w, z) * z, dim=0, keepdim=True)
        eg = (e.reshape(-1, 1) * fg[:, ::97].double()).abs()
        rows.append(dict(
            leaf=name, numel=z.numel(),
            differ=int((zk != zr).sum()),
            max_abs=float((zk - zr).abs().max()),
            max_abs_z=float(z.abs().max()),
            median_eta_g_over_z=float(
                (eg / fz[:, ::97].double().abs().clamp_min(1e-30)).median()),
            fused_eta_differ=int((zf != zk).sum()),
            anchor_differ=int((ak != ar).sum()),
            anchor_max_abs=float((ak - ar).abs().max()),
            kernel_off_once=off_once,
            merge_differ=int((mk[:1] != mr).sum()),
            merge_max_abs=float((mk[:1] - mr).abs().max())))
        kernel_z.append(zk[0])
        ref_z.append(zr[0])
        del zk, zf, zr, ak, ar, mk, mr, eg
    with torch.no_grad():
        loss_k = float(eval_fn(tuple(kernel_z)))
        loss_r = float(eval_fn(tuple(ref_z)))
    emit(f"{label}_step_diff", leaves=rows,
         z_sq_stat_max_rel=float(((stat_k - stat_r) / stat_r).abs().max()),
         eval_loss_kernel_update=loss_k, eval_loss_reference_update=loss_r,
         eval_rel=abs(loss_k - loss_r) / abs(loss_r))


def small_lm(label, cfg, kernel, seq, extra=lambda card, host: {}):
    """A narrow ``cfg`` through the same engine on the card and on the CPU,
    where every kernel is its plain version: the eval-loss traces must
    agree within TOL_LM_SMALL. ``extra(card engine, cpu engine)`` gives
    more fields for the line, which are returned."""
    splan = lm_plan(cfg, 2, 2, seq, 2)
    reset_launches()
    card, _, card_eng, _ = run_lm(splan, "fused", 2)
    small_launches = launches()[kernel]
    host, _, host_eng, _ = run_lm(splan, "fused", 2, device="cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, host))
    more = extra(card_eng, host_eng)
    emit(label, arch=cfg.name, card=card, cpu=host, max_rel=rel,
         **{f"{kernel}_launches": small_launches}, **more)
    check(small_launches > 0, f"{label}: {kernel} never launched")
    check(rel <= TOL_LM_SMALL,
          f"{label}: card vs CPU eval losses differ by {rel}")
    return more


def phase_lm(results):
    """qwen2-0.5b at full width with the flash kernel; then a narrow
    qwen2-shaped model (head_dim 64, the kernel's) on the card against the
    CPU."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig

    train_lm(results, "lm", dataclasses.replace(get_config(LM_ARCH),
                                                attn_backend="pallas"),
             "flash_attention")
    small = ArchConfig(
        name="qwen2-small", arch_type="dense", num_layers=2, d_model=256,
        num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512, vocab_size=512,
        qkv_bias=True, tie_embeddings=True, rope_theta=1_000_000.0,
        max_seq_len=128, attn_backend="pallas")
    small_lm("lm_small", small, "flash_attention", 100)


def ssd_step_parts(results, cfg):
    """Estimates of the SSD mixer's share of one fused local step at full
    width, from isolated timings, not read from the step: B13's µs per
    launch (``ssd_kernels``) and the gradient of ``ssd_chunked`` at one
    layer's shape on random inputs, each times the 2·M·layers SSD calls of
    a local step."""
    import torch
    import torch.nn.functional as tnf

    from repro_torch.models.ssm import ssd_chunked

    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    args = tuple(t.requires_grad_() for t in (
        randn(LM_BATCH, LM_SEQ, h, p),
        tnf.softplus(randn(LM_BATCH, LM_SEQ, h)),
        -torch.linspace(1.0, 16.0, h, device="cuda"),
        randn(LM_BATCH, LM_SEQ, n), randn(LM_BATCH, LM_SEQ, n)))
    cot = randn(LM_BATCH, LM_SEQ, h, p)
    bwd_ms = time_ms(lambda: torch.autograd.grad(
        ssd_chunked(*args, cfg.ssm_chunk), args, cot), reps=4, trials=5)
    per_step = 2 * LM_M * cfg.num_layers        # SSD calls per local step
    emit("mamba2_ssd", calls_per_step=per_step,
         ssd_chunked_backward_ms=bwd_ms,
         forward_ms_per_step_est=per_step * results["ssd_scan"]["ms"],
         backward_ms_per_step_est=per_step * bwd_ms)


def phase_mamba2(results):
    """mamba2-370m at full width with the SSD scan kernel; then its smoke
    config (2 layers, d_model 256, P=16, N=16, chunk 8) on the card against
    the CPU."""
    from repro_torch.configs import get_config, smoke_config

    cfg = dataclasses.replace(get_config(MAMBA_ARCH), ssm_backend="pallas")
    train_lm(results, "mamba2", cfg, "ssd_scan")
    ssd_step_parts(results, cfg)
    small_lm("mamba2_small", dataclasses.replace(smoke_config(MAMBA_ARCH),
                                                 ssm_backend="pallas"),
             "ssd_scan", 128)


def moe_dropped(cfg, params, tokens):
    """Per MoE layer, the share of one forward's routed choices dropped at
    capacity (``params`` a tuple of one model's leaves)."""
    import torch

    from repro_torch.models import param_tree
    from repro_torch.models.transformer import forward

    counts = []
    with torch.no_grad():
        forward(param_tree(params, cfg), cfg, tokens, moe_dropped=counts)
    routed = tokens.numel() * cfg.experts_per_token
    return [int(c) / routed for c in counts]


def oracle_rerun(label, prob, st, xi, g):
    """A second oracle call at the same z and ξ: every gradient leaf must
    equal the first call's to the bit (the MoE's dispatch and combine, the
    RG-LRU's scan and conv sum in a fixed order, without atomics)."""
    t0 = time.perf_counter()
    again = prob.oracle(st.z_tilde, xi)
    differ = [int((a != b).sum()) for a, b in zip(g, again)]
    emit(label, leaves=len(differ), workers=st.z_tilde[0].shape[0],
         entries=sum(v.numel() for v in g), entries_differ=sum(differ),
         seconds=time.perf_counter() - t0)
    check(not any(differ),
          f"{label}: gradients differ in {sum(differ)} entries")


def phase_moe(results):
    """granite-moe-1b-a400m at full width (24 layers of 16:8 GQA heads of 64
    and 32 experts top-8 at capacity factor 1.25, vocab 49155) with the
    flash kernel through the port's make_ps_engine: the fleet (``moe``,
    M=2, fused), a rerun of the oracle (``moe_rerun``), fused against
    reference at M=1 (``moe_compare``), then its smoke config on the card
    against the CPU with no drops and at capacity 1.25 (``moe_small``)."""
    import gc

    import torch

    from repro_torch import random as jr
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.synthetic import make_batch
    from repro_torch.models.moe import _capacity

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), attn_backend="pallas")
    lm_warmup("moe", cfg)
    plan = lm_plan(cfg, MOE_M, LM_K, LM_SEQ, LM_BATCH)
    _, ms, eng, counts = lm_run("moe", plan, "fused", "flash_attention")
    count_path(results, "flash_attention", "moe", counts)
    parts = lm_state_gradient(plan, eng)
    prob, st, keys, xi, g, eval_fn = parts
    eval_tokens = make_batch(jr.PRNGKey(987), cfg, LM_BATCH, LM_SEQ)["tokens"]
    shares = dict(
        init_eval_batch=moe_dropped(cfg, tuple(v[0] for v in prob.init(
            jr.split(jr.PRNGKey(7), 1))), eval_tokens),
        zbar_eval_batch=moe_dropped(cfg, eng.z_bar(), eval_tokens),
        worker0_draw=moe_dropped(cfg, tuple(v[0] for v in st.z_tilde),
                                 xi["tokens"][0]))
    emit("moe_drops", capacity_factor=cfg.capacity_factor,
         capacity=_capacity(cfg, LM_BATCH * LM_SEQ),
         routed_per_layer=LM_BATCH * LM_SEQ * cfg.experts_per_token,
         **shares, **{f"{k}_forward": statistics.fmean(v)
                      for k, v in shares.items()})
    lm_breakdown("moe", plan, eng, ms, *parts)
    oracle_rerun("moe_rerun", prob, st, xi, g)
    del parts, prob, st, keys, xi, g, eval_fn, eng
    gc.collect()
    torch.cuda.empty_cache()

    plan = lm_plan(cfg, MOE_COMPARE_M, LM_K, LM_SEQ, LM_BATCH)
    runs = {}
    for backend in ("fused", "reference"):
        runs[backend], _, eng, counts = lm_run("moe_compare_run", plan,
                                               backend, "flash_attention")
        if backend == "fused":
            prob, st, _, _, g, eval_fn = lm_state_gradient(plan, eng)
            step_diff("moe_compare", plan, prob, st, g, eval_fn)
            del prob, st, g, eval_fn
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    lm_compare("moe", runs)

    small = dataclasses.replace(smoke_config(MOE_ARCH), attn_backend="pallas")
    for label, cf in (("moe_small", small.capacity_factor),
                      ("moe_small_drops", MOE_SMALL_CF)):
        small = dataclasses.replace(small, capacity_factor=cf)

        def drops(card, host, c=small):
            return {f"dropped_{dev}": moe_dropped(c, e.z_bar(), make_batch(
                jr.PRNGKey(987, device=dev), c, 2, MOE_SMALL_SEQ)["tokens"])
                for dev, e in (("cuda", card), ("cpu", host))}

        seen = small_lm(label, small, "flash_attention", MOE_SMALL_SEQ,
                        drops)
    check(min(seen["dropped_cuda"]) > 0 and min(seen["dropped_cpu"]) > 0,
          f"moe_small_drops: no choice dropped at capacity {MOE_SMALL_CF}")
    emit("moe_phase", seconds=time.perf_counter() - t_phase)


def phase_rg(results):
    """recurrentgemma-9b at full width and RG_LAYERS layers (rglru, rglru,
    local attention with window 2048, then the rglru tail; B12 at head dim
    256) through the port's make_ps_engine at M=1, fused and reference
    (``rg``), with the breakdown and ``rg_step_diff`` of the fused run; a
    rerun of the oracle, every gradient leaf bit-identical (``rg_rerun``);
    then its smoke config on the card against the CPU (``rg_small``)."""
    from repro_torch.configs import get_config, smoke_config

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(RG_ARCH), num_layers=RG_LAYERS,
                              attn_backend="pallas")
    train_lm(results, "rg", cfg, "flash_attention", m=RG_M,
             rerun="rg_rerun")
    small_lm("rg_small", dataclasses.replace(smoke_config(RG_ARCH),
                                             attn_backend="pallas"),
             "flash_attention", RG_SMALL_SEQ)
    emit("rg_phase", seconds=time.perf_counter() - t_phase)


def event_ms(fn):
    """``(result, ms)`` of one call of ``fn``, timed by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def fleet_update_rows(rows, m, n, dev):
    """B1-B4 at the fleet ``(m, n)``, past the 65535 rows a grid's y
    dimension takes (ROADMAP C15), box [-1, 1] and eta fused as on the main
    path: B1 and B2 against their plain versions within TOL_FLEET_UPDATE,
    B3 exactly, the per-worker sums at TOL_STAT, B4 bit-identical to B1
    then B2; every call run twice, bit-identical, each launch timed by CUDA
    events (the wrapper, its outputs made by the call)."""
    import torch

    from repro_torch.kernels.adaseg_update import kernel as ak
    from repro_torch.kernels.adaseg_update import ref as ar

    gen = torch.Generator(device=dev).manual_seed(23)

    def u(*shape, lo, hi):
        return torch.rand(*shape, generator=gen, device=dev) * (hi - lo) + lo

    z, mt, gt = u(m, n, lo=-1, hi=1), u(m, n, lo=-30, hi=30), u(
        m, n, lo=-30, hi=30)
    kw = dict(sum_sq=u(m, lo=1e2, hi=1e4), g0=G0, d_alpha=DIAMETER, lo=-1.0,
              hi=1.0)
    s_t, s_l = u(m, lo=0.5, hi=1.0), u(m, lo=0.5, hi=1.0)

    def hold(name, call, plain, tol, bytes_per_elem):
        (got, ms), (again, ms2) = event_ms(call), event_ms(call)
        check(all(torch.equal(a, b) for a, b in zip(_flat(got),
                                                     _flat(again))),
              f"fleet_rows {name}: reruns differ")
        del again
        want = plain()
        errs, stat_errs = [0.0], [0.0]
        for g, w in zip(_flat(got), _flat(want)):
            if g.ndim == 2:
                errs.append(max_abs(g, w))
            else:
                stat_errs.append(rel_err(g, w))
        del want
        err, stat = max(errs), max(stat_errs)
        check(err <= tol and stat <= TOL_STAT,
              f"fleet_rows {name}: max abs err {err} (bar {tol}), sums' "
              f"rel err {stat}")
        b_ms, b_by = bound(bytes_per_elem * m * n, 0.0)
        rows[name] = dict(max_abs_err=err, tol=tol, stat_rel_err=stat,
                          ms=[ms, ms2], bound_ms=b_ms, bound_by=b_by,
                          reruns_bit_identical=True)
        return got

    zt, _, _ = hold("adaseg_explore", lambda: ak.adaseg_explore(z, mt, **kw),
                    lambda: ar.adaseg_explore_ref(z, mt, **kw),
                    TOL_FLEET_UPDATE, 12)
    ztl, stat, _ = hold(
        "adaseg_anchor", lambda: ak.adaseg_anchor(z, zt, gt, **kw),
        lambda: ar.adaseg_anchor_ref(z, zt, gt, **kw), TOL_FLEET_UPDATE, 16)
    hold("adaseg_finish", lambda: ak.adaseg_finish(z, mt, gt, s_t, s_l),
         lambda: ar.adaseg_finish_ref(z, mt, gt, s_t, s_l), 0.0, 20)
    u_t, u_tl, u_stat = hold(
        "adaseg_update", lambda: ak.adaseg_update(z, mt, gt, **kw),
        lambda: ar.adaseg_update_ref(z, mt, gt, **kw), TOL_FLEET_UPDATE, 20)
    same = torch.equal(u_t, zt) and torch.equal(u_tl, ztl)
    check(same, "fleet_rows adaseg_update: not bit-identical to B1 then B2")
    rows["adaseg_update"].update(bit_identical_to_b1_b2=same,
                                 stat_rel_err_vs_b2=rel_err(u_stat, stat))
    check(rows["adaseg_update"]["stat_rel_err_vs_b2"] <= TOL_STAT,
          "fleet_rows adaseg_update: its sums differ from B2's")
    del z, mt, gt, zt, ztl, u_t, u_tl
    torch.cuda.empty_cache()


def phase_fleet_rows(smi):
    """The update kernels B1-B4 and the sync kernels B5-B10 at FLEET_ROWS,
    past the 65535 rows a grid's y dimension takes (ROADMAP C15): B1-B4 as
    ``fleet_update_rows`` holds them; each sync kernel against its plain
    version, the uplink kernels exactly (a dead row past 65535), B5 (its
    weights past the opt-in shared memory, read from global memory) at
    TOL_STAT, B10's streamed path on FLEET_TRIM_COLS columns at TOL_STAT;
    B5 and B10 rerun for bit equality. Each sync wrapper is timed warm
    (``time_ms``, its outputs made by each call), B10 by its two launches,
    beside its bound."""
    import torch

    from repro_torch.kernels.sync_compress import kernel as sk
    from repro_torch.kernels.sync_compress import ref as sr

    m, n = FLEET_ROWS
    elems = m * n
    dev = torch.device("cuda")
    rows = {}
    fleet_update_rows(rows, m, n, dev)
    gen = torch.Generator(device=dev).manual_seed(21)
    z = torch.rand(m, n, generator=gen, device=dev) * 2 - 1
    ef = (torch.rand(m, n, generator=gen, device=dev) - 0.5) * 0.1
    w = torch.rand(m, generator=gen, device=dev) * 1.9 + 0.1
    keys = torch.randint(0, 2 ** 32, (m, 2), generator=gen, device=dev)
    alive = torch.ones(m, device=dev)
    alive[FLEET_DEAD_ROW] = 0.0

    def hold(name, got, want, tol, fn, bytes_per_elem, **ops):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(max_abs(a, b) for a, b in zip(got, want))
        check(err <= tol, f"fleet_rows {name}: max abs err {err} > {tol}")
        b_ms, b_by = bound(bytes_per_elem * elems, 0.0, **ops)
        rows[name] = dict(max_abs_err=err, tol=tol, bound_ms=b_ms,
                          bound_by=b_by)
        if fn is not None:
            rows[name]["ms"] = time_ms(fn, reps=3, trials=3)

    stats = sk.uplink_stats(z, w, ef)
    hold("uplink_stats", stats, sr.uplink_stats_ref(z, ef, w), 0.0,
         lambda: sk.uplink_stats(z, w, ef), 8)
    scale = torch.clamp(stats, min=1e-30)

    def quantize():
        return sk.quantize_uplink(z, keys, scale, w, ef, alive,
                                  levels=LEVELS)

    want = sr.quantize_uplink_ref(z, keys, scale, levels=LEVELS, ef=ef, w=w,
                                  alive=alive)
    hold("quantize_uplink", quantize(), want, 0.0, quantize, 16,
         int_ops=QUANTIZE_INT_OPS * elems)
    del want
    eff = sk.eff_uplink(z, w, ef)
    hold("eff_uplink", eff, sr.eff_uplink_ref(z, ef, w), 0.0,
         lambda: sk.eff_uplink(z, w, ef), 12)
    mask = (torch.rand(m, n, generator=gen, device=dev) < 0.25).to(
        torch.uint8)
    hold("mask_uplink", sk.mask_uplink(eff, mask, ef, alive),
         sr.mask_uplink_ref(eff, mask, alive=alive, ef=ef), 0.0,
         lambda: sk.mask_uplink(eff, mask, ef, alive), 13)
    del eff, mask, ef
    torch.cuda.empty_cache()

    # B5: 70000 normalised terms a column in another order than torch.sum
    got = sk.merge_stacked(z, w, normalize=True)
    again = sk.merge_stacked(z, w, normalize=True)
    hold("merge_stacked", got, sr.merge_ref(z, w, normalize=True), TOL_STAT,
         lambda: sk.merge_stacked(z, w, normalize=True), 8)
    check(torch.equal(got, again), "fleet_rows merge_stacked: reruns differ")
    rows["merge_stacked"].update(reruns_bit_identical=True,
                                 shared_rows=sk.MAX_ROWS)
    del got, again

    # B10 streamed: the kernel on the whole leaf, twice, each launch timed;
    # the plain version on its first FLEET_TRIM_COLS columns
    incl = torch.ones(m, device=dev)
    trim = m // 5
    check(sk.trimmed_path(m) == sk.TRIMMED_STREAMED,
          "fleet_rows: B10 not on its streamed path")
    got, ms = event_ms(lambda: sk.trimmed_merge_stacked(z, w, incl,
                                                        trim=trim))
    again, ms2 = event_ms(lambda: sk.trimmed_merge_stacked(z, w, incl,
                                                           trim=trim))
    cols = z[:, :FLEET_TRIM_COLS].contiguous()
    want = sr.trimmed_merge_ref(cols, w, incl, trim=trim)
    hold("trimmed_merge_stacked", got[:, :FLEET_TRIM_COLS], want, TOL_STAT,
         None, 8, issue_ops=TRIM_PAIR_OPS * m * (m - 1) // 2 * n)
    check(torch.equal(got, again),
          "fleet_rows trimmed_merge_stacked: reruns differ")
    rows["trimmed_merge_stacked"].update(
        ms=[ms, ms2], reruns_bit_identical=True, path="streamed", trim=trim,
        plain_columns=FLEET_TRIM_COLS)
    emit("fleet_rows", nvidia_smi=smi, shape=[m, n], dead_row=FLEET_DEAD_ROW,
         kernels=rows)
    del z, w, keys, got, again, want, cols
    torch.cuda.empty_cache()


def wgan_scores(wg, z, rng):
    """(W-estimate, moment distance) of one iterate."""
    return (float(wg.wasserstein_estimate(z, rng)),
            float(wg.moment_distance(z, rng)))


def wgan_leaves(eng):
    """An AdaSEG WGAN engine's output and fleet state, cloned."""
    return [v.clone() for v in (*eng.z_bar(), *eng.state.z_tilde,
                                eng.state.sum_sq)]


def run_wgan_engine(wg, problem, backend, method_kw, eval_rng,
                    until=None, **engine_kw):
    """One WGAN fleet through PSEngine on the card, driven incrementally
    (``run(until_round=r)`` every WGAN_EVERY rounds up to ``until``, as
    the example does): the per-round W-estimates (the trace's residuals),
    the scores at those rounds, ms per local step of the fleet, the
    launches, the engine, and (AdaSEG workers) its leaves after the first
    WGAN_EVERY rounds."""
    import torch

    from repro_torch import random as jr
    from repro_torch.ps import PSConfig, PSEngine

    until = WGAN_R if until is None else until
    reset_launches()
    eng = PSEngine(problem, PSConfig(num_workers=WGAN_M, rounds=WGAN_R,
                                     codec_backend=backend, **method_kw),
                   rng=jr.PRNGKey(1),
                   eval_fn=lambda z: wg.wasserstein_estimate(z, eval_rng),
                   **engine_kw)
    torch.cuda.synchronize()
    wall, scores, first = 0.0, {}, None
    for r in range(WGAN_EVERY, until + 1, WGAN_EVERY):
        t0 = time.perf_counter()
        z = eng.run(until_round=r)
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        scores[r] = wgan_scores(wg, z, eval_rng)
        if first is None and hasattr(eng.state, "z_tilde"):
            first = wgan_leaves(eng)
    trace = [rec.residual for rec in eng.trace.rounds]
    return dict(trace=trace, scores=scores, launches=launches(),
                ms=wall * 1e3 / (until * WGAN_K), engine=eng,
                first_leaves=first)


def phase_wgan(smi):
    """The paper's §5 comparison through the port: WGAN-GP at full width,
    LocalAdaSEG on PSEngine (ModelWorker) fused, reference and fused under
    q8, homogeneous and heterogeneous, and bench_wgan.py's baselines
    (MB-UMP, MB-ASMP by run_serial on a minibatch of M, LocalAdam on
    PSEngine); a fused rerun bit-identical, spans and metrics on and off
    bit-identical, the Perfetto export valid, the metrics' bytes up equal
    to the trace's."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch import random as jr
    from repro_torch.core import AdaSEGConfig
    from repro_torch.models import ModelWorker
    from repro_torch.obs import (
        MetricsRegistry,
        SpanTracer,
        save_trace_events,
        validate_trace_events,
    )
    from repro_torch.optim import (
        MinimaxWorker,
        adam_minimax,
        asmp,
        minibatch,
        run_serial,
        ump,
    )
    from repro_torch.problems import make_wgan_problem
    from repro_torch.ps import StochasticQuantizeCompressor, heterogeneous_wgan

    wg = make_wgan_problem(jr.PRNGKey(0))
    eval_rng = jr.PRNGKey(5)
    cfg = AdaSEGConfig(g0=50.0, diameter=1.0, alpha=1.0, k=WGAN_K,
                       average_output=False)
    het = heterogeneous_wgan(wg, WGAN_M, jr.PRNGKey(9), alpha=WGAN_ALPHA)
    emit("wgan_setup", nvidia_smi=smi, latent=wg.latent_dim,
         data=wg.data_dim, hidden=64, batch=wg.batch, gp_weight=wg.gp_weight,
         workers=WGAN_M, k=WGAN_K, rounds=WGAN_R, alpha=WGAN_ALPHA,
         g0=cfg.g0, diameter=cfg.diameter, tol=TOL_WGAN_TRACE,
         gated_rounds=WGAN_GATED_ROUNDS)

    def adaseg(backend, problem):
        return dict(worker=ModelWorker(cfg, backend=backend,
                                       arch=problem.name), local_k=WGAN_K)

    def finite(label, run):
        vals = list(run["trace"]) + [v for s in run["scores"].values()
                                     for v in s]
        check(all(v is not None and math.isfinite(v) for v in vals),
              f"wgan {label}: a non-finite score {vals}")

    def report(label, scenario, backend, run, **extra):
        finite(f"{scenario}/{label}/{backend}", run)
        emit("wgan", scenario=scenario, method=label, backend=backend,
             nvidia_smi=smi, w_estimate={str(r): s[0] for r, s in
                                         run["scores"].items()},
             moment_distance={str(r): s[1] for r, s in run["scores"].items()},
             ms_per_local_step=run["ms"], **extra)

    path_kernels = ("adaseg_explore", "adaseg_anchor", "merge_stacked")
    q8_kernels = path_kernels + ("uplink_stats", "quantize_uplink")
    first = None
    for scenario, problem in (("homog", wg.problem), ("hetero", het)):
        fused = run_wgan_engine(wg, problem, "fused",
                                adaseg("fused", problem), eval_rng)
        for k in path_kernels:
            check(fused["launches"][k] > 0,
                  f"wgan {scenario}: {k} never launched on the path")
        ref = run_wgan_engine(wg, problem, "reference",
                              adaseg("reference", problem), eval_rng)
        gaps = [abs(a - b) for a, b in zip(fused["trace"], ref["trace"])]
        bars = [TOL_WGAN_TRACE["atol"] + TOL_WGAN_TRACE["rtol"] * abs(b)
                for b in ref["trace"]]
        gated = all(g <= b for g, b in zip(gaps[:WGAN_GATED_ROUNDS],
                                           bars[:WGAN_GATED_ROUNDS]))
        report("LocalAdaSEG", scenario, "fused", fused,
               launches=fused["launches"], w_trace=fused["trace"])
        report("LocalAdaSEG", scenario, "reference", ref,
               w_trace=ref["trace"], abs_gap_vs_fused=gaps,
               first_round_past_tol=next(
                   (i for i, (g, b) in enumerate(zip(gaps, bars)) if g > b),
                   None))
        check(gated, f"wgan {scenario}: fused vs reference W-estimates part "
                     f"within the first {WGAN_GATED_ROUNDS} rounds: {gaps}")
        q8 = run_wgan_engine(
            wg, problem, "fused",
            dict(adaseg("fused", problem),
                 compressor=StochasticQuantizeCompressor(bits=8)), eval_rng)
        for k in q8_kernels:
            check(q8["launches"][k] > 0,
                  f"wgan {scenario}/q8: {k} never launched on the path")
        report("LocalAdaSEG", scenario, "fused_q8", q8,
               launches=q8["launches"], w_trace=q8["trace"])
        if first is None:
            first = fused
        del ref, q8

        # bench_wgan.py's baselines; the central minibatch methods draw from
        # the mixture of the workers' distributions under hetero
        p_central = problem
        if problem.sample_worker is not None:
            def mixed_sample(rngs, p=problem):
                k = jr.split(rngs)
                wid = jr.randint(k[..., 0, :], (), 0, WGAN_M)
                return p.sample_worker(k[..., 1, :], wid)

            p_central = dataclasses.replace(problem, sample=mixed_sample,
                                            sample_worker=None)
        for label, opt in (("MB-UMP", ump(50.0, 1.0)),
                           ("MB-ASMP", asmp(50.0, 1.0))):
            mb = minibatch(p_central, WGAN_M)
            steps = WGAN_R * WGAN_K
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, hist = run_serial(opt, mb, steps=steps, rng=jr.PRNGKey(2),
                                 record_every=WGAN_EVERY * WGAN_K)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
            scores = {WGAN_EVERY * (i + 1): wgan_scores(
                wg, tuple(v[i] for v in hist), eval_rng)
                for i in range(hist[0].shape[0])}
            report(label, scenario, "plain", dict(trace=[], scores=scores,
                                                  ms=ms))
        adam = run_wgan_engine(
            wg, problem, "fused",
            dict(worker=MinimaxWorker(adam_minimax(WGAN_ADAM_LR)),
                 local_k=WGAN_K), eval_rng)
        check(adam["launches"]["merge_stacked"] > 0,
              f"wgan {scenario}/LocalAdam: merge_stacked never launched")
        # bench_wgan.py scores LocalAdam by worker 0's iterate
        z0 = tuple(v[0] for v in adam["engine"].state.z)
        report("LocalAdam", scenario, "fused", dict(
            adam, scores={WGAN_R: wgan_scores(wg, z0, eval_rng)}),
            launches=adam["launches"], w_trace_zbar=adam["trace"])
        del adam

    # a rerun, then a run with spans and metrics off, each of the first
    # WGAN_EVERY rounds: bit-identical to the first run's rounds
    def same_as_first(run):
        n = WGAN_EVERY
        return run["trace"] == first["trace"][:n] and all(
            torch.equal(a, b) for a, b in zip(first["first_leaves"],
                                              run["first_leaves"]))

    again = run_wgan_engine(wg, wg.problem, "fused",
                            adaseg("fused", wg.problem), eval_rng,
                            until=WGAN_EVERY)
    same = same_as_first(again)
    check(same, "wgan homog/fused: the rerun differs from the first run")
    off = run_wgan_engine(wg, wg.problem, "fused",
                          adaseg("fused", wg.problem), eval_rng,
                          until=WGAN_EVERY, tracer=SpanTracer(enabled=False),
                          metrics=MetricsRegistry(enabled=False))
    same_off = same_as_first(off)
    check(same_off, "wgan homog/fused: spans and metrics off changed the run")
    eng = first["engine"]
    with tempfile.TemporaryDirectory() as tmp:
        payload = save_trace_events(f"{tmp}/wgan_trace.json", eng.tracer)
    validate_trace_events(payload)
    up_metrics = eng.metrics.total("bytes_up")
    up_trace = sum(r.bytes_up for r in eng.trace.rounds)
    check(up_metrics == up_trace,
          f"wgan: metrics bytes_up {up_metrics} != trace's {up_trace}")
    walls = eng.metrics.histogram("round_wall_s")
    rec = next(r for r in eng.metrics.records if r["name"] == "round_wall_s")
    emit("wgan_checks", nvidia_smi=smi, rerun_bit_identical=same,
         obs_off_bit_identical=same_off, compared_rounds=WGAN_EVERY,
         ms_per_local_step_off=off["ms"],
         ms_per_local_step_rerun=again["ms"],
         trace_events=len(payload["traceEvents"]), trace_valid=True,
         bytes_up_metrics=up_metrics, bytes_up_trace=up_trace,
         round_wall_s=walls,
         modeled_hbm_passes=rec["labels"]["modeled_hbm_passes"],
         modeled_hbm_s=rec["labels"]["modeled_hbm_s"])
    del first, again, off, eng
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_device()
    phase_build()
    # the two-tree modes: they use nothing a parent tree may lack
    if sys.argv[1:] == ["--sync-wrappers"]:
        phase_sync_wrappers()
        return 0
    if sys.argv[1:2] == ["--sync-bits"] and len(sys.argv) == 3:
        phase_sync_bits(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--compare-bits"] and len(sys.argv) == 4:
        return compare_bits(sys.argv[2], sys.argv[3])
    from repro_torch.hardware import HBM_BW

    CARD["hbm_bytes_per_s"] = HBM_BW
    if sys.argv[1:] == ["--kernels"]:
        # B1-B5 at the main path's shapes through their launchers, whose C
        # signatures a parent tree shares: two trees timed in one call
        phase_kernels()
        return 0
    if sys.argv[1:] == ["--zoo"]:
        from repro_torch import random as jr
        from repro_torch.problems import make_bilinear_game

        phase_zoo(make_bilinear_game(jr.PRNGKey(0), n=N, sigma=0.1), smi)
        return 0
    if sys.argv[1:] == ["--fleet-rows"]:
        phase_fleet_rows(smi)
        return 0
    if sys.argv[1:] == ["--wgan"]:
        phase_wgan(smi)
        return 0
    if sys.argv[1:] == ["--async"]:
        from repro_torch import random as jr
        from repro_torch.problems import make_bilinear_game

        phase_async(None, make_bilinear_game(jr.PRNGKey(0), n=N, sigma=0.1),
                    smi)
        return 0
    if sys.argv[1:] == ["--flash"]:
        phase_flash_kernels({})
        return 0
    if sys.argv[1:] == ["--moe"]:
        phase_moe({"flash_attention": {"name": "flash_attention"}})
        return 0
    if sys.argv[1:] == ["--rg"]:
        phase_rg({"flash_attention": {"name": "flash_attention"}})
        return 0
    if sys.argv[1:] == ["--sampled"]:
        from repro_torch import random as jr
        from repro_torch.problems import make_bilinear_game

        phase_sampled(None, make_bilinear_game(jr.PRNGKey(0), n=N,
                                               sigma=0.1), smi)
        return 0
    results = phase_kernels()
    phase_codec_kernels(results)
    phase_merge_shapes()
    phase_fleet_rows(smi)
    phase_robust_kernels(results)
    phase_sync_wrappers()
    phase_flash_kernels(results)
    phase_ssd_kernels(results)
    game = phase_main(results)
    phase_codec(results, game)
    phase_robust(results, game)
    phase_async(results, game, smi)
    phase_sampled(results, game, smi)
    phase_zoo(game, smi)
    del game                       # free the 1 GiB coupling matrix
    phase_wgan(smi)
    phase_lm(results)
    phase_mamba2(results)
    phase_moe(results)
    phase_rg(results)
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
