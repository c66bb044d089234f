"""Distributionally-robust logistic regression (port of
``repro.problems.robust``): a convex-concave finite-sum minimax,

    min_{w ∈ B(r)} max_{p ∈ Δ_n}  Σ_i p_i · ℓ_i(w) − (λ/2)‖p − 1/n‖²,

with ℓ_i the logistic loss of example i. Convex in w, strongly concave in
p. The stochastic oracle samples a minibatch of example indices
(``randint``, the JAX package's draw bit for bit): unbiased for the w block
(importance-weighted by p) and for the p block (loss entries with the
inclusion correction n/batch).

As everywhere in the port the iterate is worker-stacked: ``w`` is
``(M, d)``, ``p`` is ``(M, n)`` and a draw ξ is ``(M, batch)`` indices.

* The w-block gradient is written in closed form,
  ``∇w = Σ_b s·p_i·(−lab_i·σ(−lab_i·f_i·w))·f_i`` with ``s = n/batch``
  (the JAX package takes ``jax.grad`` of the same loss).
* The p block scatters ``s·ℓ_i(w)`` into ``(M, n)`` zeros and sums
  duplicate indices, as ``.at[idx].add`` does. Scatter-adds on the card
  use atomics in no fixed order, so the sums are formed first: an
  ``(M, batch, batch)`` index-equality mask gives every entry the sum of
  its duplicates (one row reduction in a fixed order, the same bits for
  every entry of one index; adding the masked zeros is exact), and a plain
  scatter writes those equal values.
  Reruns are bit-identical; against the JAX package the sums of three or
  more duplicates may round in another order (ROADMAP C17).

Examples
--------
>>> from repro_torch import random as jr
>>> rl = make_robust_logistic(jr.PRNGKey(0, device="cpu"), n=32, d=4,
...                           batch=4, device="cpu")
>>> keys = jr.split(jr.PRNGKey(1, device="cpu"), 2)
>>> z = rl.problem.init(keys)
>>> idx = rl.problem.sample(keys)
>>> gw, gp = rl.problem.oracle(z, idx)
>>> tuple(gw.shape), tuple(gp.shape), idx.dtype
((2, 4), (2, 32), torch.int32)
"""
from __future__ import annotations

import dataclasses

import torch

from .. import random as jr
from .._device import resolve_device
from ..core import projections
from ..core.types import MinimaxProblem


def _log1p_exp(u):
    """``logaddexp(0, u)``."""
    return torch.logaddexp(torch.zeros_like(u), u)


@dataclasses.dataclass(frozen=True)
class RobustLogistic:
    features: torch.Tensor   # (n, d)
    labels: torch.Tensor     # (n,) in {-1, +1}
    lam: float
    problem: MinimaxProblem

    def losses(self, w) -> torch.Tensor:
        """Per-example logistic losses of one (unstacked) ``w``."""
        return _log1p_exp(-(self.labels * (self.features @ w)))

    def objective(self, z) -> torch.Tensor:
        w, p = z
        n = self.labels.shape[0]
        return p @ self.losses(w) - 0.5 * self.lam * torch.sum(
            (p - 1.0 / n) ** 2)


def robust_logistic_from_arrays(features, labels, batch: int = 16,
                                lam: float = 0.1, radius: float = 5.0
                                ) -> RobustLogistic:
    """The problem around given ``features`` ``(n, d)`` and ``labels``
    ``(n,)`` (float32, ±1, on one device)."""
    n, d = features.shape

    def init(rngs):
        w0 = 0.01 * jr.normal(rngs, (d,))
        p0 = torch.full(w0.shape[:-1] + (n,), 1.0 / n, dtype=torch.float32,
                        device=w0.device)
        return (w0, p0)

    def sample(rngs):
        return jr.randint(rngs, (batch,), 0, n)

    def oracle(z, idx):
        w, p = z
        idx = idx.long()
        scale = n / idx.shape[-1]
        f, lab = features[idx], labels[idx]               # (M, B, d), (M, B)
        margin = lab * torch.einsum("mbd,md->mb", f, w)
        p_i = torch.gather(p, 1, idx)
        coef = scale * p_i * (-lab * torch.sigmoid(-margin))
        gw = torch.einsum("mb,mbd->md", coef, f)
        vals = scale * _log1p_exp(-margin)                # (M, B)
        same = idx[:, :, None] == idx[:, None, :]          # (M, B, B)
        dup_sums = torch.where(same, vals[:, None, :], 0.0).sum(dim=-1)
        ell = torch.zeros_like(p).scatter_(1, idx, dup_sums)
        gp = ell - lam * (p - 1.0 / n)
        return (gw, -gp)

    def mean_oracle(z, _):
        w, p = z
        margin = labels * (w @ features.T)                # (M, n)
        gw = (p * (-labels * torch.sigmoid(-margin))) @ features
        gp = _log1p_exp(-margin) - lam * (p - 1.0 / n)
        return (gw, -gp)

    problem = MinimaxProblem(
        init=init,
        sample=sample,
        oracle=oracle,
        project=projections.product(projections.l2_ball(radius),
                                    projections.simplex()),
        mean_oracle=mean_oracle,
        name="robust_logistic",
    )
    return RobustLogistic(features=features, labels=labels, lam=lam,
                          problem=problem)


def make_robust_logistic(rng, n: int = 128, d: int = 16, batch: int = 16,
                         lam: float = 0.1, radius: float = 5.0, *,
                         device="cuda") -> RobustLogistic:
    """Draw features, a ground-truth direction and 10% label flips from key
    ``rng`` on ``device``."""
    dev = resolve_device(device)
    r_x, r_w, r_flip = jr.split(rng.to(dev), 3).unbind(0)
    features = jr.normal(r_x, (n, d))
    w_true = jr.normal(r_w, (d,))
    labels = torch.sign(features @ w_true)
    # 10% label noise makes the robust weighting non-trivial.
    flips = jr.bernoulli(r_flip, 0.1, (n,))
    labels = torch.where(flips, -labels, labels)
    return robust_logistic_from_arrays(features, labels, batch, lam, radius)
