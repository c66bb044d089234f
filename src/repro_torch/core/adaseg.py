"""LocalAdaSEG — Algorithm 1 of the paper (port of ``repro.core.adaseg``).

Per-worker state and the three ingredients of the method:

1.  Extragradient double update from the (possibly synced) anchor z̃*:
        z_t  = Π_Z[z̃* − η_t · G(z̃*, ξ₁)]          (exploration step)
        z̃_t = Π_Z[z̃* − η_t · G(z_t, ξ₂)]          (anchor update)

2.  AdaGrad-type local learning rate (Line 4):
        η_t = D·α / sqrt(G₀² + Σ_{τ<t} (Z_τ)²),
        (Z_t)² = (‖z_t − z̃*_{t−1}‖² + ‖z_t − z̃_t‖²) / (5 η_t²)

3.  Inverse-stepsize weighted periodic averaging (Line 7):
        w_t^m ∝ 1/η_t^m,  z̃° = Σ_m w_t^m z̃_{t−1}^m        every K steps.

Where the JAX package vmaps a one-worker step, the state here is the whole
fleet: every field has a leading worker axis ``M`` (the iterate leaves are
``(M, n)``, the scalars ``(M,)``) and every function works on all workers
at once. Random keys are per worker, ``(M, 2)``, from :mod:`repro_torch.random`.

Step backends (``backend=``):

* ``"reference"`` — plain tensor ops (this module);
* ``"fused"``     — the kernels of ``kernels.adaseg_update`` (CUDA on the
  card, their plain twins on the CPU), selected whenever the projection
  carries a static spec; opaque projections fall back to the reference
  math so semantics never fork.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import random as jr
from .._device import resolve_device
from . import projections
from .tree import (
    per_worker,
    tree_axpy,
    tree_map,
    tree_norm_sq,
    tree_sub,
    tree_where,
    tree_zeros_like,
)
from .types import MinimaxProblem, draw

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdaSEGConfig:
    """Hyper-parameters of LocalAdaSEG(G0, D; K, M, R; alpha)."""

    g0: float          # initial guess of the gradient bound G
    diameter: float    # D, diameter bound of Z (Assumption 1)
    alpha: float = 1.0  # base lr: 1.0 nonsmooth (Thm 1), 1/sqrt(M) smooth (Thm 2)
    k: int = 1         # communication interval K
    average_output: bool = True  # return uniform iterate average (convex-concave)


class AdaSEGState(NamedTuple):
    """Fleet state; every field has a leading worker axis."""

    z_tilde: PyTree          # z̃_t — the anchor iterate, leaves (M, ...)
    sum_sq: torch.Tensor     # Σ_τ (Z_τ)², (M,) f32
    t: torch.Tensor          # local step counter, (M,) int32
    z_bar: PyTree            # running uniform average of {z_τ}
    grad_sq_sum: torch.Tensor  # Σ_τ ‖g_τ‖² + ‖M_τ‖², (M,) f32
    worker_id: torch.Tensor  # (M,) int32


class StepAux(NamedTuple):
    eta: torch.Tensor
    z_sq: torch.Tensor       # (Z_t)² increment
    grad_norm_sq: torch.Tensor


def eta_of(cfg: AdaSEGConfig, sum_sq: torch.Tensor) -> torch.Tensor:
    return cfg.diameter * cfg.alpha / torch.sqrt(cfg.g0 ** 2 + sum_sq)


def init(problem: MinimaxProblem, cfg: AdaSEGConfig, rngs: torch.Tensor,
         worker_ids=None) -> AdaSEGState:
    """Initial fleet state from per-worker keys ``(M, 2)``."""
    m = rngs.shape[0]
    dev = rngs.device
    if worker_ids is None:
        worker_ids = torch.arange(m, dtype=torch.int32, device=dev)
    z0 = problem.project(problem.init(rngs))
    zeros = torch.zeros(m, dtype=torch.float32, device=dev)
    return AdaSEGState(
        z_tilde=z0,
        sum_sq=zeros,
        t=torch.zeros(m, dtype=torch.int32, device=dev),
        z_bar=tree_zeros_like(z0),
        grad_sq_sum=zeros.clone(),
        worker_id=worker_ids,
    )


def local_step(
    problem: MinimaxProblem,
    cfg: AdaSEGConfig,
    state: AdaSEGState,
    rngs: torch.Tensor,
    *,
    enabled=None,
    backend: str = "reference",
) -> tuple[AdaSEGState, StepAux]:
    """One extragradient step of every worker from its anchor.

    ``rngs`` is ``(M, 2)``, one key per worker. ``enabled`` (``(M,)`` bool,
    optional) masks the update: disabled workers keep their state.
    ``backend="fused"`` routes through the fused kernels when
    ``problem.project`` carries a static spec.
    """
    if backend not in ("reference", "fused"):
        raise ValueError(f"unknown step backend {backend!r}")
    spec = projections.spec_of(problem.project) if backend == "fused" else None

    r = jr.split(rngs)
    r1, r2 = r[:, 0], r[:, 1]
    eta = eta_of(cfg, state.sum_sq)
    z_star = state.z_tilde
    m_t = problem.oracle(z_star, draw(problem, r1, state.worker_id))  # M_t

    if spec is not None:
        from ..kernels.adaseg_update.ops import (
            adaseg_tree_anchor,
            adaseg_tree_explore,
        )

        d_alpha = cfg.diameter * cfg.alpha
        z_t, m_sq = adaseg_tree_explore(
            z_star, m_t, sum_sq=state.sum_sq, g0=cfg.g0, d_alpha=d_alpha,
            proj=spec,
        )
        g_t = problem.oracle(z_t, draw(problem, r2, state.worker_id))  # g_t
        z_tilde_new, stat, g_sq = adaseg_tree_anchor(
            z_star, z_t, g_t, sum_sq=state.sum_sq, g0=cfg.g0,
            d_alpha=d_alpha, proj=spec,
        )
        z_sq = stat / (5.0 * eta ** 2)
        grad_norm_sq = g_sq + m_sq
    else:
        z_t = problem.project(tree_axpy(-eta, m_t, z_star))
        g_t = problem.oracle(z_t, draw(problem, r2, state.worker_id))  # g_t
        z_tilde_new = problem.project(tree_axpy(-eta, g_t, z_star))

        z_sq = (
            tree_norm_sq(tree_sub(z_t, z_star))
            + tree_norm_sq(tree_sub(z_t, z_tilde_new))
        ) / (5.0 * eta ** 2)
        grad_norm_sq = tree_norm_sq(g_t) + tree_norm_sq(m_t)

    t_new = state.t + 1
    # Incremental uniform mean of the exploration iterates z_t (Line 14).
    if cfg.average_output:
        z_bar_new = tree_map(
            lambda zb, zt: zb + (zt - zb) / per_worker(t_new, zt).to(zt.dtype),
            state.z_bar, z_t,
        )
    else:
        z_bar_new = z_t

    new = AdaSEGState(
        z_tilde=z_tilde_new,
        sum_sq=state.sum_sq + z_sq,
        t=t_new,
        z_bar=z_bar_new,
        grad_sq_sum=state.grad_sq_sum + grad_norm_sq,
        worker_id=state.worker_id,
    )
    if enabled is not None:
        new = AdaSEGState(
            z_tilde=tree_where(enabled, new.z_tilde, state.z_tilde),
            sum_sq=torch.where(enabled, new.sum_sq, state.sum_sq),
            t=torch.where(enabled, new.t, state.t),
            z_bar=tree_where(enabled, new.z_bar, state.z_bar),
            grad_sq_sum=torch.where(enabled, new.grad_sq_sum,
                                    state.grad_sq_sum),
            worker_id=state.worker_id,
        )
    return new, StepAux(eta=eta, z_sq=z_sq, grad_norm_sq=grad_norm_sq)


# ---------------------------------------------------------------------------
# Sync (Line 7) over the stacked worker axis.
# ---------------------------------------------------------------------------

def sync_weighted_stacked(z_tilde: PyTree, inv_eta: torch.Tensor, *,
                          backend: str = "reference"):
    """Weighted average over the leading worker axis, broadcast back to
    every worker. ``backend="fused"`` runs the merge kernel, which
    normalises the 1/η weights in-register."""
    if backend == "fused":
        from ..kernels.sync_compress.ops import sync_merge_stacked

        return sync_merge_stacked(z_tilde, inv_eta, normalize=True)
    if backend != "reference":
        raise ValueError(f"unknown sync backend {backend!r}")
    w = inv_eta / torch.sum(inv_eta)                     # (M,) simplex weights

    def avg(leaf):
        mean = torch.sum(per_worker(w, leaf).to(leaf.dtype) * leaf, dim=0,
                         keepdim=True)
        return mean.expand(leaf.shape).contiguous()

    return tree_map(avg, z_tilde)


def weighted_worker_average(z_stacked: PyTree, counts: torch.Tensor) -> PyTree:
    """Line 14 global output: average the worker axis with weights ∝
    per-worker step counts. Shared by the serial driver and the engine."""
    c = counts.to(torch.float32)
    w = c / torch.sum(c)
    return tree_map(
        lambda leaf: torch.sum(per_worker(w, leaf).to(leaf.dtype) * leaf,
                               dim=0),
        z_stacked,
    )


# ---------------------------------------------------------------------------
# Serial multi-worker driver.
# ---------------------------------------------------------------------------

def run_local_adaseg(
    problem: MinimaxProblem,
    cfg: AdaSEGConfig,
    *,
    num_workers: int,
    rounds: int,
    rng: torch.Tensor,
    local_steps=None,
    collect_aux: bool = True,
    backend: str = "reference",
    device="cuda",
):
    """Run LocalAdaSEG with M stacked workers for R rounds of K local steps.

    ``local_steps`` (``(M,)`` ints, optional) gives heterogeneous per-worker
    step counts K_m. The sync is always the reference math (as in the JAX
    driver). Returns ``(z_bar, (state, history))``: z_bar is the global
    output iterate (Line 14), history the per-step :class:`StepAux` fields
    stacked as ``(R, K, M)`` (None without ``collect_aux``).
    """
    dev = resolve_device(device)
    m = num_workers
    k = int(cfg.k)
    if local_steps is None:
        ks = np.full((m,), k, dtype=np.int32)
    else:
        ks = np.asarray(local_steps, dtype=np.int32).reshape(m)
        k = int(ks.max())
    ks_t = torch.as_tensor(ks, device=dev)

    init_rngs = jr.split(rng.to(dev), m + 1)
    rng, worker_rngs = init_rngs[0], init_rngs[1:]
    state = init(problem, cfg, worker_rngs)
    round_rngs = jr.split(rng, rounds)

    history = []
    for r in range(rounds):
        # Line 5–8: weighted sync at the top of each round.
        inv_eta = 1.0 / eta_of(cfg, state.sum_sq)
        state = state._replace(
            z_tilde=sync_weighted_stacked(state.z_tilde, inv_eta))
        step_rngs = jr.split(round_rngs[r], k * m).reshape(k, m, 2)
        steps = []
        for i in range(k):
            enabled = None if (ks > i).all() else ks_t > i
            state, aux = local_step(problem, cfg, state, step_rngs[i],
                                    enabled=enabled, backend=backend)
            steps.append(aux)
        if collect_aux:
            history.append(StepAux(*(torch.stack(f) for f in zip(*steps))))

    hist = (StepAux(*(torch.stack(f) for f in zip(*history)))
            if collect_aux else None)
    counts = torch.as_tensor(ks.astype(np.float32) * rounds, device=dev)
    z_bar = weighted_worker_average(state.z_bar, counts)
    return z_bar, (state, hist)
