"""Stochastic bilinear minimax game with box constraints (paper §4.1; port
of ``repro.problems.bilinear``).

    min_{x ∈ C^n} max_{y ∈ C^n}  E_ξ [ xᵀA y + (b+ξ)ᵀx + (c+ξ)ᵀy ],
    C^n = [-1, 1]^n,  ξ ~ N(0, σ² I).

b, c ~ U[-1,1]^n; A = Ā / max(b_max, c_max) with Ā a random symmetric
matrix in [-1,1]^{n×n}, drawn from the same keys as the JAX package, so the
same seed gives bit-identical ``a``, ``b``, ``c`` and initial iterates.

The oracle takes the worker-stacked iterate ``(x, y)``, each ``(M, n)``,
and runs as two plain matrix products per call.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import random as jr
from .._device import resolve_device
from ..core import projections
from ..core.types import MinimaxProblem


@dataclasses.dataclass(frozen=True)
class BilinearGame:
    a: torch.Tensor       # (n, n) symmetric coupling matrix
    b: torch.Tensor       # (n,)
    c: torch.Tensor       # (n,)
    sigma: float          # oracle noise level
    problem: MinimaxProblem

    @property
    def n(self) -> int:
        return self.b.shape[0]

    def residual(self, z) -> torch.Tensor:
        """Paper's KKT residual Res(x, y) of one (unstacked) iterate."""
        x, y = z
        rx = x - torch.clamp(x - (self.a @ y + self.b), -1.0, 1.0)
        ry = y - torch.clamp(y + (self.a.T @ x + self.c), -1.0, 1.0)
        return torch.sqrt(torch.sum(rx ** 2) + torch.sum(ry ** 2))

    def duality_gap(self, z) -> torch.Tensor:
        """Exact DualGap(z̄) over the box: inner max/min are l1 norms."""
        x, y = z
        max_y = self.b @ x + torch.sum(torch.abs(self.a.T @ x + self.c))
        min_x = self.c @ y - torch.sum(torch.abs(self.a @ y + self.b))
        return max_y - min_x


def game_from_arrays(a, b, c, sigma: float, name: str = "bilinear"
                     ) -> BilinearGame:
    """The game around given coefficient tensors (all on one device)."""
    n = b.shape[0]

    def init(rngs):
        r = jr.split(rngs)
        x0 = jr.uniform(r[..., 0, :], (n,), -1.0, 1.0)
        y0 = jr.uniform(r[..., 1, :], (n,), -1.0, 1.0)
        return (x0, y0)

    def sample(rngs):
        return sigma * jr.normal(rngs, (n,))

    def oracle(z, xi):
        # Descent form G = [∂x F, −∂y F]; rows are workers, so A·y per
        # worker is y @ Aᵀ.
        x, y = z
        gx = y @ a.T + b + xi
        gy = x @ a + c + xi
        return (gx, -gy)

    problem = MinimaxProblem(
        init=init,
        sample=sample,
        oracle=oracle,
        project=projections.box(-1.0, 1.0),
        name=name,
    )
    return BilinearGame(a=a, b=b, c=c, sigma=sigma, problem=problem)


def make_bilinear_game(rng, n: int = 10, sigma: float = 0.1,
                       name: str = "bilinear", *, device="cuda"
                       ) -> BilinearGame:
    """Draw the game from key ``rng`` on ``device`` (the n×n matrix is drawn
    there in counter chunks, so a 16384² game never passes through the
    host)."""
    dev = resolve_device(device)
    r_a, r_b, r_c = jr.split(rng.to(dev), 3).unbind(0)
    b = jr.uniform(r_b, (n,), -1.0, 1.0)
    c = jr.uniform(r_c, (n,), -1.0, 1.0)
    a = jr.uniform(r_a, (n, n), -1.0, 1.0)
    a = (a + a.T).mul_(0.5)
    a.div_(torch.maximum(torch.max(torch.abs(b)), torch.max(torch.abs(c))))
    return game_from_arrays(a, b, c, sigma, name)
