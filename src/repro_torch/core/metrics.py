"""Solution-quality metrics for minimax problems (port of
``repro.core.metrics``).

The KKT residual (the paper's Res(x, y), §4.1) is ``‖z − Π_Z(z − G(z))‖``
with the *mean* operator G: zero iff z is a saddle point. Duality gaps are
problem-specific (``BilinearGame.duality_gap``).
"""
from __future__ import annotations

import torch

from .tree import tree_axpy, tree_norm_sq, tree_sub
from .types import MinimaxProblem


def kkt_residual(problem: MinimaxProblem, z) -> torch.Tensor:
    """Residual of one iterate ``z`` (leaves without a worker axis, as the
    engine's Line-14 output ``z̄``), a 0-d float32 tensor. The problem's
    functions take worker-stacked leaves, so ``z`` is lifted to a
    one-worker fleet.

    Examples
    --------
    >>> from repro_torch import random as jr
    >>> from repro_torch.problems import make_bilinear_game
    >>> game = make_bilinear_game(jr.PRNGKey(0, device="cpu"), n=4,
    ...                           sigma=0.1, device="cpu")
    >>> z = (torch.zeros(4), torch.zeros(4))
    >>> bool(torch.isclose(kkt_residual(game.problem, z), game.residual(z)))
    True
    """
    if problem.mean_oracle is None:
        raise ValueError(f"problem {problem.name!r} has no mean_oracle")
    z1 = tuple(v.unsqueeze(0) for v in z)
    g = problem.mean_oracle(z1, None)
    z_step = problem.project(tree_axpy(-1.0, g, z1))
    return torch.sqrt(tree_norm_sq(tree_sub(z1, z_step)))[0]
