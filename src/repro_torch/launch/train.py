"""LocalAdaSEG training of a language model through the Parameter-Server
engine (port of ``repro.launch.train``, serial path).

:func:`make_ps_engine` turns a :class:`TrainPlan` into a
:class:`~repro_torch.ps.PSEngine` over a
:class:`~repro_torch.models.ModelWorker` on
:func:`~repro_torch.models.make_lm_problem`: the same call the JAX
package's examples make, with ``mesh=None`` and ``plan.workers_override``
setting the worker count M; with ``latency=`` or ``staleness_bound=`` it
is an :class:`~repro_torch.ps.AsyncPSEngine` instead, as in the JAX
package. The sharded path (``mesh=``, ROADMAP A20) is ported in a later
slice, the GSPMD round function and the dry-run shapes with it.

Examples
--------
>>> from repro_torch import random as jr
>>> from repro_torch.core import AdaSEGConfig
>>> from repro_torch.models import tiny_lm_config
>>> plan = TrainPlan(cfg=tiny_lm_config(attn_backend="pallas"),
...                  adaseg=AdaSEGConfig(g0=20.0, diameter=2.0, k=2,
...                                      average_output=False),
...                  worker_mode="paper", k_local=2, global_batch=4, seq=8,
...                  workers_override=2)
>>> eng = make_ps_engine(plan, jr.PRNGKey(0, device="cpu"), rounds=1,
...                      backend="fused", device="cpu")
>>> zbar = eng.run()
>>> len(zbar), eng.trace.rounds[-1].residual > 0
(12, True)
"""
from __future__ import annotations

import dataclasses
import math

from .._device import resolve_device
from ..configs.base import ArchConfig
from ..core.adaseg import AdaSEGConfig


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """Everything needed to run one architecture's training rounds. The
    fields are the JAX package's; the mesh-dependent ones (``worker_mode``
    beyond recording it, ``repair_model``, ``frontend_pad_to``) take effect
    with the sharded path (ROADMAP A20)."""

    cfg: ArchConfig
    adaseg: AdaSEGConfig
    worker_mode: str           # "paper" | "hierarchical"
    k_local: int
    global_batch: int
    seq: int
    scan_rounds: bool = True
    # explicit worker count for single-device runs
    workers_override: int | None = None
    repair_model: bool = False
    frontend_pad_to: int | None = None

    def num_workers(self, mesh=None) -> int:
        if mesh is not None:
            raise NotImplementedError(
                "mesh-derived worker counts come with the sharded path "
                "(ROADMAP A20)")
        if not self.workers_override:
            raise ValueError("the serial path needs plan.workers_override")
        return self.workers_override

    def per_worker_batch(self, mesh=None) -> int:
        m = self.num_workers(mesh)
        assert self.global_batch % m == 0, (self.global_batch, m)
        return self.global_batch // m


def make_ps_engine(
    plan: TrainPlan,
    rng,
    *,
    rounds: int,
    mesh=None,
    hetero: bool = False,
    schedule=None,
    compressor=None,
    faults=None,
    codec_backend: str = "reference",
    latency=None,
    staleness_bound: float | None = None,
    staleness_discount: float = 1.0,
    eval_fn="loss",
    trace_meta: dict | None = None,
    tracer=None,
    metrics=None,
    backend: str = "reference",
    device="cuda",
):
    """A TrainPlan as a Parameter-Server engine on the serial path.

    Builds the plan's architecture as :func:`~repro_torch.models.
    make_lm_problem` and its AdaSEG settings as a ``ModelWorker`` whose
    step backend is ``backend`` (``"reference"`` or ``"fused"``: the JAX
    package's worker always takes its reference step), and hands both to
    :class:`~repro_torch.ps.PSEngine` with ``codec_backend`` for the sync,
    or, when ``latency`` or ``staleness_bound`` is given, to
    :class:`~repro_torch.ps.AsyncPSEngine` (τ = ``staleness_bound``, ∞
    when None; γ = ``staleness_discount``).
    ``eval_fn="loss"`` installs :func:`~repro_torch.models.make_eval_loss`
    on a held-out batch; pass None or a callable to override.
    ``trace_meta`` is merged into the trace's metadata; ``tracer`` and
    ``metrics`` (a :class:`~repro_torch.obs.MetricsRegistry`) go to the
    engine."""
    from ..models.problem import make_eval_loss, make_lm_problem
    from ..models.worker import ModelWorker
    from ..ps import AsyncPSConfig, AsyncPSEngine, PSConfig, PSEngine

    if mesh is not None:
        raise NotImplementedError(
            "make_ps_engine(mesh=...) is the sharded path (ROADMAP A20)")
    dev = resolve_device(device)
    m = plan.workers_override
    if not m:
        raise ValueError("make_ps_engine needs plan.workers_override")
    b = plan.global_batch // m
    problem = make_lm_problem(plan.cfg, batch=b, seq=plan.seq,
                              hetero_workers=(m if hetero else None))
    worker = ModelWorker(plan.adaseg, backend=backend, arch=plan.cfg.name)
    if eval_fn == "loss":
        eval_fn = make_eval_loss(plan.cfg, batch=b, seq=plan.seq, device=dev)
    common = dict(num_workers=m, rounds=rounds, worker=worker,
                  local_k=plan.k_local, schedule=schedule,
                  compressor=compressor, faults=faults,
                  codec_backend=codec_backend)
    if latency is not None or staleness_bound is not None:
        config = AsyncPSConfig(
            **common, latency=latency,
            staleness_bound=(math.inf if staleness_bound is None
                             else staleness_bound),
            staleness_discount=staleness_discount)
        return AsyncPSEngine(problem, config, rng, eval_fn=eval_fn,
                             trace_meta=trace_meta, tracer=tracer,
                             metrics=metrics, device=dev)
    engine = PSEngine(problem, PSConfig(**common), rng, eval_fn=eval_fn,
                      tracer=tracer, metrics=metrics, device=dev)
    if trace_meta:
        engine.trace.meta.update(trace_meta)
    return engine
