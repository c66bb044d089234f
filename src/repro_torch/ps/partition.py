"""Heterogeneous data layer: Dirichlet-skewed per-worker oracles (§4.2/E.2;
port of ``repro.ps.partition``).

Every worker draws from its own local distribution ``P_m`` through
``MinimaxProblem.sample_worker`` (``(rngs, worker_ids) -> ξ``), which the
engine routes through ``core.types.draw``. One knob, the Dirichlet
concentration ``alpha``, carves those distributions:

* **bilinear**  — worker m's noise is centred at a Dirichlet-weighted
  combination of random unit directions, the shifts centred across workers
  so the global mean problem is the paper's §4.1 game unchanged;
* **robust-logistic** — the n examples fall into quantile bins of a random
  feature projection, and worker m draws minibatch indices with
  probability ∝ its Dirichlet mass on the example's group;
* **WGAN** — worker m's real data draws the mixture's modes with
  probabilities given by its Dirichlet row (Fig. E2's non-iid GAN).

The samplers take keys with any leading axes and worker ids of the same
leading shape (one draw per key), so ``optim.minibatch`` applies to them.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import random as jr
from ..core.types import MinimaxProblem
from ..data.synthetic import (
    dirichlet_proportions,
    group_sampling_logits,
    quantile_groups,
)
from ..problems.bilinear import BilinearGame
from ..problems.robust import RobustLogistic
from ..problems.wgan import WGANProblem, mode_centers


def heterogeneous_bilinear(
    game: BilinearGame,
    num_workers: int,
    rng: torch.Tensor,
    alpha: float = 0.5,
    shift_scale: float = 0.5,
    num_components: int | None = None,
) -> MinimaxProblem:
    """Per-worker noise means δ_m = shift_scale·(p_m − 1/G)·B with p_m ~
    Dir(alpha) over ``num_components`` random unit directions B, minus
    their mean over the workers: averaging the local objectives recovers
    the original game.

    Examples
    --------
    >>> from repro_torch.problems import make_bilinear_game
    >>> game = make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=4,
    ...                           sigma=0.1, device="cpu")
    >>> prob = heterogeneous_bilinear(game, 2, jr.PRNGKey(1, device="cpu"),
    ...                               alpha=0.5)
    >>> prob.name
    'bilinear@hetero'
    >>> keys = jr.PRNGKey(2, device="cpu").expand(2, 2)  # one key, twice
    >>> xi = prob.sample_worker(keys, torch.tensor([0, 1]))
    >>> bool((xi[0] != xi[1]).any())       # same key, different local laws
    True
    """
    n = game.n
    g = num_components or min(8, n)
    r_p, r_b = jr.split(rng.to(game.b.device)).unbind(0)
    props = dirichlet_proportions(r_p, num_workers, g, alpha)      # (M, G)
    basis = jr.normal(r_b, (g, n))
    # a correctly rounded root, as XLA's (PyTorch's float32 sqrt on the CPU
    # is an ulp off for ~0.6% of inputs)
    norms = torch.sqrt((basis * basis).sum(dim=1, keepdim=True).double())
    basis = basis / norms.float()
    shifts = shift_scale * (props - 1.0 / g) @ basis               # (M, n)
    shifts = shifts - shifts.mean(dim=0, keepdim=True)
    sigma = game.sigma

    def sample_worker(rngs, worker_ids):
        return shifts[worker_ids.long()] + sigma * jr.normal(rngs, (n,))

    return dataclasses.replace(
        game.problem, sample_worker=sample_worker,
        name=game.problem.name + "@hetero",
    )


def heterogeneous_robust(
    rl: RobustLogistic,
    num_workers: int,
    rng: torch.Tensor,
    alpha: float = 0.5,
    num_groups: int = 4,
) -> MinimaxProblem:
    """Soft Dirichlet partition of the n examples: groups are quantile bins
    of a random feature projection; worker m draws minibatch indices with
    probability ∝ p_m[group(i)] (``random.categorical``, a Gumbel argmax).

    Examples
    --------
    >>> from repro_torch.problems import make_robust_logistic
    >>> rl = make_robust_logistic(jr.PRNGKey(0, device="cpu"), n=32, d=4,
    ...                           batch=4, device="cpu")
    >>> prob = heterogeneous_robust(rl, 2, jr.PRNGKey(1, device="cpu"),
    ...                             alpha=0.3)
    >>> idx = prob.sample_worker(jr.split(jr.PRNGKey(2, device="cpu"), 2),
    ...                          torch.tensor([0, 1]))
    >>> tuple(idx.shape), bool(((idx >= 0) & (idx < 32)).all())
    ((2, 4), True)
    """
    d = rl.features.shape[1]
    r_p, r_u = jr.split(rng.to(rl.features.device)).unbind(0)
    proj = rl.features @ jr.normal(r_u, (d,))
    group_of = quantile_groups(proj, num_groups)
    props = dirichlet_proportions(r_p, num_workers, num_groups, alpha)
    logits = group_sampling_logits(props, group_of)                # (M, n)
    batch = int(rl.problem.sample(
        jr.PRNGKey(0, device=rl.features.device)).shape[-1])

    def sample_worker(rngs, worker_ids):
        return jr.categorical(rngs, logits[worker_ids.long()].unsqueeze(-2),
                              (batch,))

    return dataclasses.replace(
        rl.problem, sample_worker=sample_worker,
        name=rl.problem.name + "@hetero",
    )


def mixture_sampler(wg: WGANProblem, mode_logits: torch.Tensor,
                    modes: int = 8, radius: float = 2.0, std: float = 0.05):
    """The heterogeneous WGAN's ``sample_worker(rngs, worker_ids)`` for
    per-worker mode logits ``(M, modes)``: each key splits into
    ``(r_mode, r_noise, r_z, r_eps)``; the modes are a categorical draw
    under the worker's logits (``random.categorical``), the real data their
    centres plus ``std`` times a normal, the latents and the interpolation
    weights as :func:`~repro_torch.problems.make_wgan_problem` draws them."""

    def sample_worker(rngs, worker_ids):
        k = jr.split(rngs, 4)
        logits = mode_logits[worker_ids.long()].unsqueeze(-2)
        kk = jr.categorical(k[..., 0, :], logits, (wg.batch,))
        real = (mode_centers(kk, modes, radius)
                + std * jr.normal(k[..., 1, :], (wg.batch, 2)))
        return {
            "real": real,
            "z": jr.normal(k[..., 2, :], (wg.batch, wg.latent_dim)),
            "eps": jr.uniform(k[..., 3, :], (wg.batch, 1)),
        }

    return sample_worker


def heterogeneous_wgan(
    wg: WGANProblem,
    num_workers: int,
    rng: torch.Tensor,
    alpha: float = 0.6,
    modes: int = 8,
    radius: float = 2.0,
    std: float = 0.05,
) -> MinimaxProblem:
    """Per-worker real-data distribution over the mixture modes, reweighted
    by a Dirichlet row: ``log(p_m + 1e-8)`` as worker m's mode logits
    (:func:`mixture_sampler`).

    Examples
    --------
    >>> from repro_torch.problems import make_wgan_problem
    >>> wg = make_wgan_problem(jr.PRNGKey(0, device="cpu"), latent_dim=2,
    ...                        hidden=4, batch=4)
    >>> prob = heterogeneous_wgan(wg, 2, jr.PRNGKey(1, device="cpu"),
    ...                           alpha=0.6)
    >>> xi = prob.sample_worker(jr.split(jr.PRNGKey(2, device="cpu"), 2),
    ...                         torch.tensor([0, 1]))
    >>> sorted(xi), tuple(xi["real"].shape)
    (['eps', 'real', 'z'], (2, 4, 2))
    """
    props = dirichlet_proportions(rng, num_workers, modes, alpha)
    mode_logits = torch.log(props + 1e-8)                          # (M, modes)
    return dataclasses.replace(
        wg.problem,
        sample_worker=mixture_sampler(wg, mode_logits, modes, radius, std),
        name=wg.problem.name + "@hetero",
    )


def heterogenize(obj, num_workers: int, rng, alpha: float = 0.5,
                 **kwargs) -> MinimaxProblem:
    """Dispatch on the problem wrapper: BilinearGame, RobustLogistic or
    WGANProblem → the matching Dirichlet-skewed per-worker problem.

    Examples
    --------
    >>> from repro_torch.problems import make_bilinear_game
    >>> game = make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=4,
    ...                           sigma=0.1, device="cpu")
    >>> heterogenize(game, 2, jr.PRNGKey(1, device="cpu")).name
    'bilinear@hetero'
    >>> heterogenize(object(), 2, jr.PRNGKey(1, device="cpu"))
    Traceback (most recent call last):
        ...
    TypeError: no heterogeneous partition for object
    """
    if isinstance(obj, BilinearGame):
        return heterogeneous_bilinear(obj, num_workers, rng, alpha, **kwargs)
    if isinstance(obj, RobustLogistic):
        return heterogeneous_robust(obj, num_workers, rng, alpha, **kwargs)
    if isinstance(obj, WGANProblem):
        return heterogeneous_wgan(obj, num_workers, rng, alpha, **kwargs)
    raise TypeError(f"no heterogeneous partition for {type(obj).__name__}")
