"""Strongly-convex-strongly-concave quadratic saddle problem (port of
``repro.problems.quadratic``).

    F(x, y) = ½ xᵀP x − ½ yᵀQ y + xᵀA y + bᵀx + cᵀy,   P, Q ≻ 0.

Smooth, with a unique saddle point in closed form: the exactness problem
for every optimizer of the zoo. The coefficients are drawn from the JAX
package's keys; ``normal`` agrees with XLA's to a few ulps (ROADMAP C3), so
:func:`quadratic_game_from_arrays` takes a JAX game's ``p, q, a, b, c``
where a test needs the same matrices. ``z_star`` is
``torch.linalg.solve`` of the stationarity system, equal to the JAX
package's at a tolerance.

The oracle takes worker-stacked iterates ``(x, y)``, each ``(M, n)``.

Examples
--------
>>> from repro_torch import random as jr
>>> game = make_quadratic_game(jr.PRNGKey(0, device="cpu"), n=3,
...                            device="cpu")
>>> g = game.problem.mean_oracle(tuple(v[None] for v in game.z_star), None)
>>> bool(max(float(v.abs().max()) for v in g) < 1e-5)
True
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .. import random as jr
from .._device import resolve_device
from ..core import projections
from ..core.types import MinimaxProblem


@dataclasses.dataclass(frozen=True)
class QuadraticGame:
    p: torch.Tensor
    q: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    sigma: float
    problem: MinimaxProblem
    z_star: tuple

    def distance_to_saddle(self, z) -> torch.Tensor:
        """‖z − z*‖ of one (unstacked) iterate."""
        x, y = z
        xs, ys = self.z_star
        return torch.sqrt(torch.sum((x - xs) ** 2) + torch.sum((y - ys) ** 2))


def quadratic_game_from_arrays(p, q, a, b, c, sigma: float = 0.1,
                               radius: float = 10.0) -> QuadraticGame:
    """The game around given coefficient tensors (all on one device)."""
    n = b.shape[0]
    # Saddle: Px + Ay = −b ;  Aᵀx − Qy = −c.
    block = torch.cat([torch.cat([p, a], dim=1),
                       torch.cat([a.T, -q], dim=1)], dim=0)
    sol = torch.linalg.solve(block, torch.cat([-b, -c]))
    z_star = (sol[:n], sol[n:])

    def init(rngs):
        r = jr.split(rngs)
        return (jr.normal(r[..., 0, :], (n,)), jr.normal(r[..., 1, :], (n,)))

    def sample(rngs):
        return sigma * jr.normal(rngs, (2 * n,))

    def oracle(z, xi):
        # rows are workers: P·x per worker is x @ Pᵀ
        x, y = z
        gx = x @ p.T + y @ a.T + b + xi[..., :n]
        gy = x @ a - y @ q.T + c + xi[..., n:]
        return (gx, -gy)

    def mean_oracle(z, _):
        x, y = z
        return (x @ p.T + y @ a.T + b, -(x @ a - y @ q.T + c))

    problem = MinimaxProblem(
        init=init,
        sample=sample,
        oracle=oracle,
        project=projections.l2_ball(radius),
        mean_oracle=mean_oracle,
        name="quadratic",
    )
    return QuadraticGame(p=p, q=q, a=a, b=b, c=c, sigma=sigma,
                         problem=problem, z_star=z_star)


def make_quadratic_game(rng, n: int = 10, sigma: float = 0.1,
                        mu: float = 1.0, radius: float = 10.0, *,
                        device="cuda") -> QuadraticGame:
    """Draw the game from key ``rng`` on ``device``."""
    dev = resolve_device(device)
    r_p, r_q, r_a, r_b, r_c = jr.split(rng.to(dev), 5).unbind(0)
    # a full-shape divisor: PyTorch's CPU kernels divide by a scalar as a
    # multiplication by its reciprocal (ROADMAP C7)
    root_n = torch.tensor(math.sqrt(n), dtype=torch.float32, device=dev)

    def psd(r):
        m = jr.normal(r, (n, n)) / root_n.expand(n, n)
        return m @ m.T + mu * torch.eye(n, device=dev)

    p, q = psd(r_p), psd(r_q)
    a = jr.normal(r_a, (n, n)) / root_n.expand(n, n)
    b = jr.normal(r_b, (n,))
    c = jr.normal(r_c, (n,))
    return quadratic_game_from_arrays(p, q, a, b, c, sigma, radius)
