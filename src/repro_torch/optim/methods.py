"""The optimizer zoo (port of ``repro.optim.methods``): every baseline the
paper compares against (§4, Fig. 4), on worker-stacked states.

All methods act on the descent field G(z, ξ) = [∂x f, −∂y f]:

* :func:`sgda`   — stochastic simultaneous gradient descent-ascent
                   [LocalSGDA].
* :func:`segda`  — stochastic extragradient with a constant lr
                   [MB-SEGDA / LocalSEGDA].
* :func:`adam_minimax` — Adam per coordinate on G [Local Adam].
* :func:`ump`    — Universal Mirror-Prox (Bach & Levy '19), the serial
                   adaptive extragradient LocalAdaSEG runs locally [MB-UMP].
* :func:`asmp`   — Adaptive Single-gradient Mirror-Prox (Ene & Nguyen
                   '20): one oracle call per step [MB-ASMP].

Each name carries every hyper-parameter: it is the checkpoint fingerprint
(``LocalWorker.fingerprint``), so a restore with another lr, D or α is
refused. Per-worker scalars (η, Adam's bias corrections) are ``(M,)``
tensors. Where XLA rounds otherwise than PyTorch's CPU kernels (ROADMAP
C6(a), C7), the port follows XLA: Adam's moments are contracted ``a·b +
c`` (one rounding), η divides a full-shape numerator and takes a
correctly rounded square root.

Examples
--------
>>> from repro_torch import random as jr
>>> from repro_torch.problems import make_bilinear_game
>>> game = make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=4, sigma=0.1,
...                           device="cpu")
>>> opt = adam_minimax(0.02)
>>> keys = jr.split(jr.PRNGKey(1, device="cpu"), 3)
>>> st = opt.step(game.problem, opt.init(game.problem, keys), keys)
>>> opt.name, st.t.tolist(), sorted(st.inner)
('adam(lr=0.02,b1=0.9,b2=0.999,eps=1e-08)', [1, 1, 1], ['m', 'v'])
"""
from __future__ import annotations

import torch

from .. import random as jr
from ..core.tree import (
    per_worker,
    tree_axpy,
    tree_map,
    tree_norm_sq,
    tree_sub,
    tree_zeros_like,
)
from ..core.types import MinimaxProblem, draw
from ..kernels.sync_compress.ref import fma_f32, sqrt_f32
from .base import MinimaxOptimizer, OptState, base_init, update_mean


def sgda(lr: float) -> MinimaxOptimizer:
    def step(problem: MinimaxProblem, state: OptState, rngs) -> OptState:
        g = problem.oracle(state.z, draw(problem, rngs, state.worker_id))
        z_new = problem.project(tree_axpy(-lr, g, state.z))
        t_new = state.t + 1
        return OptState(z=z_new, z_bar=update_mean(state.z_bar, z_new, t_new),
                        t=t_new, inner=(), worker_id=state.worker_id)

    return MinimaxOptimizer(name=f"sgda(lr={lr})", init=base_init, step=step)


def segda(lr: float) -> MinimaxOptimizer:
    def step(problem: MinimaxProblem, state: OptState, rngs) -> OptState:
        r = jr.split(rngs)
        m = problem.oracle(state.z, draw(problem, r[:, 0], state.worker_id))
        w = problem.project(tree_axpy(-lr, m, state.z))          # exploration
        g = problem.oracle(w, draw(problem, r[:, 1], state.worker_id))
        z_new = problem.project(tree_axpy(-lr, g, state.z))      # anchor
        t_new = state.t + 1
        return OptState(z=z_new, z_bar=update_mean(state.z_bar, w, t_new),
                        t=t_new, inner=(), worker_id=state.worker_id)

    return MinimaxOptimizer(name=f"segda(lr={lr})", init=base_init, step=step)


def adam_minimax(lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8) -> MinimaxOptimizer:
    def init(problem, rngs):
        st = base_init(problem, rngs)
        zeros = tree_zeros_like(st.z)
        return st._replace(inner={"m": zeros, "v": zeros})

    def step(problem: MinimaxProblem, state: OptState, rngs) -> OptState:
        g = problem.oracle(state.z, draw(problem, rngs, state.worker_id))
        t_new = state.t + 1
        tf = t_new.to(torch.float32)
        m = tree_map(lambda mm, gg: fma_f32(torch.full_like(mm, b1), mm,
                                            (1 - b1) * gg),
                     state.inner["m"], g)
        v = tree_map(lambda vv, gg: fma_f32(torch.full_like(vv, b2), vv,
                                            (1 - b2) * gg * gg),
                     state.inner["v"], g)
        one = torch.ones_like(tf)
        mhat = one / (1.0 - torch.pow(torch.full_like(tf, b1), tf))
        vhat = one / (1.0 - torch.pow(torch.full_like(tf, b2), tf))
        z_new = problem.project(tree_map(
            lambda z, mm, vv: z - lr * (mm * per_worker(mhat, mm))
            / (sqrt_f32(vv * per_worker(vhat, vv)) + eps),
            state.z, m, v))
        return OptState(z=z_new, z_bar=update_mean(state.z_bar, z_new, t_new),
                        t=t_new, inner={"m": m, "v": v},
                        worker_id=state.worker_id)

    return MinimaxOptimizer(
        name=f"adam(lr={lr},b1={b1},b2={b2},eps={eps})", init=init, step=step)


def _adaptive_eta(g0: float, diameter: float, alpha: float, sum_sq):
    """D·α / sqrt(G₀² + Σ), per worker: a full-shape numerator and a
    correctly rounded root, as XLA divides (C7)."""
    return (torch.full_like(sum_sq, diameter * alpha)
            / sqrt_f32(g0 ** 2 + sum_sq))


def _adaptive_weight(g0: float, diameter: float, alpha: float, sum_sq):
    """1/η = sqrt(G₀² + Σ) / (D·α), per worker."""
    return (sqrt_f32(g0 ** 2 + sum_sq)
            / torch.full_like(sum_sq, diameter * alpha))


def ump(g0: float, diameter: float, alpha: float = 1.0) -> MinimaxOptimizer:
    """Universal Mirror-Prox (Bach & Levy '19): adaptive extragradient,
    one LocalAdaSEG worker (K→∞, M=1); its 1/η is the sync weight, so
    ``run_local(ump, ...)`` is the unweighted-sync ablation of LocalAdaSEG.
    """

    def init(problem, rngs):
        st = base_init(problem, rngs)
        return st._replace(inner={"sum_sq": torch.zeros(
            rngs.shape[0], dtype=torch.float32, device=rngs.device)})

    def step(problem: MinimaxProblem, state: OptState, rngs) -> OptState:
        r = jr.split(rngs)
        eta = _adaptive_eta(g0, diameter, alpha, state.inner["sum_sq"])
        m = problem.oracle(state.z, draw(problem, r[:, 0], state.worker_id))
        w = problem.project(tree_axpy(-eta, m, state.z))
        g = problem.oracle(w, draw(problem, r[:, 1], state.worker_id))
        z_new = problem.project(tree_axpy(-eta, g, state.z))
        z_sq = (tree_norm_sq(tree_sub(w, state.z))
                + tree_norm_sq(tree_sub(w, z_new))) / (5.0 * eta ** 2)
        t_new = state.t + 1
        return OptState(z=z_new, z_bar=update_mean(state.z_bar, w, t_new),
                        t=t_new,
                        inner={"sum_sq": state.inner["sum_sq"] + z_sq},
                        worker_id=state.worker_id)

    def sync_weight(state: OptState) -> torch.Tensor:
        return _adaptive_weight(g0, diameter, alpha, state.inner["sum_sq"])

    return MinimaxOptimizer(name=f"ump(g0={g0},D={diameter},alpha={alpha})",
                            init=init, step=step, sync_weight=sync_weight)


def asmp(g0: float, diameter: float, alpha: float = 1.0) -> MinimaxOptimizer:
    """Adaptive Single-gradient Mirror-Prox (Ene & Nguyen '20): the
    extrapolation reuses the previous gradient, one oracle call per step;
    η adapts to the accumulated prediction error ‖g_t − g_{t−1}‖²."""

    def init(problem, rngs):
        st = base_init(problem, rngs)
        return st._replace(inner={
            "sum_sq": torch.zeros(rngs.shape[0], dtype=torch.float32,
                                  device=rngs.device),
            "g_prev": tree_zeros_like(st.z)})

    def step(problem: MinimaxProblem, state: OptState, rngs) -> OptState:
        eta = _adaptive_eta(g0, diameter, alpha, state.inner["sum_sq"])
        w = problem.project(tree_axpy(-eta, state.inner["g_prev"], state.z))
        g = problem.oracle(w, draw(problem, rngs, state.worker_id))
        z_new = problem.project(tree_axpy(-eta, g, state.z))
        err_sq = tree_norm_sq(tree_sub(g, state.inner["g_prev"]))
        t_new = state.t + 1
        return OptState(z=z_new, z_bar=update_mean(state.z_bar, w, t_new),
                        t=t_new,
                        inner={"sum_sq": state.inner["sum_sq"] + err_sq,
                               "g_prev": g},
                        worker_id=state.worker_id)

    def sync_weight(state: OptState) -> torch.Tensor:
        return _adaptive_weight(g0, diameter, alpha, state.inner["sum_sq"])

    return MinimaxOptimizer(name=f"asmp(g0={g0},D={diameter},alpha={alpha})",
                            init=init, step=step, sync_weight=sync_weight)
