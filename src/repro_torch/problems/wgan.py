"""Wasserstein GAN with gradient penalty on synthetic data (paper §5; port
of ``repro.problems.wgan``).

The paper trains WGAN-GP (Eq. E44) on MNIST; like the JAX package the port
trains on an 8-mode 2-D Gaussian mixture, which keeps the adversarial
dynamics with a deterministic data pipeline. Generator and critic are
3-layer tanh MLPs.

    min_G max_D  E_x[D(x)] − E_z[D(G(z))] − λ·E_x̂[(‖∇_x̂ D(x̂)‖ − 1)²]

Quality proxies: the Wasserstein estimate ``E D(real) − E D(fake)`` and the
moment distance ``‖μ_r − μ_g‖² + ‖Σ_r − Σ_g‖²_F`` in data space.

Layout. The iterate is a flat tuple of 12 leaves in ``jax.tree.leaves``
order of the JAX package's ``(gen, disc)`` tree: the generator's layers,
then the critic's, each layer ``b`` before ``w`` (dict keys sort). As
everywhere in the port each leaf is worker-stacked, ``b`` ``(M, fan_out)``
and ``w`` ``(M, fan_in, fan_out)``, and the MLP is a batched product over
the worker axis (``torch.matmul`` of ``(M, B, fan_in)`` by ``(M, fan_in,
fan_out)``, plain PyTorch: the JAX package leaves these small products to
XLA, outside any Pallas kernel). A draw ξ is ``{"real": (M, B, 2), "z":
(M, B, latent), "eps": (M, B, 1)}``. The metrics take one iterate without
the worker axis (the engine's Line-14 output). The problem holds no
tensors: it runs on the device of the keys it is given.

The oracle is the gradient of the saddle loss over all 12 leaves, the
critic's half negated (``core.types.from_loss``'s convention). The penalty
takes the critic's input gradient at the interpolates with
``create_graph=True``, so the outer gradient is a double backward, and the
interpolates are not detached: the generator's gradient flows through
``x̂`` into the penalty, as under ``jax.grad``.

Numerics, where PyTorch's CPU rounds otherwise than XLA (ROADMAP C7, C3):

* the penalty's ``√(Σ g² + 1e-12)`` is correctly rounded (through float64,
  as XLA's f32 root), with JAX's derivative ``g·(0.5/√x)``;
* init divides the normal draws by the f32 ``√fan_in`` XLA computes, as a
  full-shape divisor;
* draws come from the port's ``randint``, ``normal`` and ``uniform``
  (``normal`` agrees with XLA's to a few ulps, C3).

Examples
--------
>>> from repro_torch import random as jr
>>> wg = make_wgan_problem(jr.PRNGKey(0, device="cpu"), hidden=8, batch=4)
>>> keys = jr.split(jr.PRNGKey(1, device="cpu"), 2)
>>> z = wg.problem.init(keys)
>>> len(z), tuple(z[0].shape), tuple(z[1].shape)
(12, (2, 8), (2, 8, 8))
>>> g = wg.problem.oracle(z, wg.problem.sample(keys))
>>> [tuple(v.shape) for v in g] == [tuple(v.shape) for v in z]
True
>>> w = wg.wasserstein_estimate(tuple(v[0] for v in z),
...                             jr.PRNGKey(2, device="cpu"))
>>> w.shape, bool(torch.isfinite(w))
(torch.Size([]), True)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import random as jr
from ..core import projections
from ..core.types import MinimaxProblem

#: leaves of each network: (b, w) for each of its three layers
NET_LEAVES = 6
#: 2π as the JAX package's weak-typed float32 constant
_TWO_PI = float(np.float32(2.0 * np.pi))


def _mlp_init(rngs, sizes, scale=0.1) -> tuple:
    """Worker-stacked MLP leaves ``(b, w)`` per layer from keys ``(..., 2)``:
    ``w = scale·normal(r, (fan_in, fan_out)) / √fan_in`` with
    ``rngs, r = split(rngs)`` per layer, ``b = 0``."""
    leaves = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        k = jr.split(rngs)
        rngs, r = k[..., 0, :], k[..., 1, :]
        w = scale * jr.normal(r, (fan_in, fan_out))
        # the f32 root XLA computes, divided by as a full-shape tensor (a
        # 0-d divisor is a multiplication by its reciprocal on the CPU)
        w = w / torch.full_like(w, float(np.sqrt(np.float32(fan_in))))
        leaves += [torch.zeros(w.shape[:-2] + (fan_out,), dtype=w.dtype,
                               device=w.device), w]
    return tuple(leaves)


def _mlp_apply(leaves, x):
    """The MLP ``x @ w + b`` with tanh between layers; ``x`` ``(..., B,
    fan_in)`` against leaves with the same leading axes."""
    layers = len(leaves) // 2
    for i in range(layers):
        b, w = leaves[2 * i], leaves[2 * i + 1]
        x = torch.matmul(x, w) + b.unsqueeze(-2)
        if i + 1 < layers:
            x = torch.tanh(x)
    return x


def mode_centers(k, modes: int = 8, radius: float = 2.0):
    """Centres of the mixture's modes ``k`` (int): ``radius·(cos θ, sin θ)``
    with ``θ = 2π·k / modes``, the last axis the data's."""
    theta = _TWO_PI * k.to(torch.float32) / modes
    return radius * torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def _mixture_sample(rngs, batch: int, modes: int = 8, radius: float = 2.0,
                    std: float = 0.05):
    """``(..., batch, 2)`` draws of the mixture: a uniform mode each
    (``randint``), its centre plus ``std`` times a normal."""
    k = jr.split(rngs)
    r_mode, r_noise = k[..., 0, :], k[..., 1, :]
    centers = mode_centers(jr.randint(r_mode, (batch,), 0, modes), modes,
                           radius)
    return centers + std * jr.normal(r_noise, (batch, 2))


class _Sqrt(torch.autograd.Function):
    """Float32 ``√x`` rounded once (through float64, as XLA's root), with
    JAX's derivative ``g·(0.5/√x)``; differentiable once, which is all the
    outer gradient of the penalty needs."""

    @staticmethod
    def forward(ctx, x):
        ans = torch.sqrt(x.double()).float()
        ctx.save_for_backward(ans)
        return ans

    @staticmethod
    def backward(ctx, g):
        (ans,) = ctx.saved_tensors
        return g * (torch.full_like(ans, 0.5) / ans)


@dataclasses.dataclass(frozen=True)
class WGANProblem:
    problem: MinimaxProblem
    latent_dim: int
    data_dim: int
    batch: int
    gp_weight: float

    def generate(self, gen_params, rng, n: int) -> torch.Tensor:
        """``n`` samples of the generator (its 6 leaves, unstacked) from
        latent normals under key ``rng``."""
        z = jr.normal(rng, (n, self.latent_dim))
        return _mlp_apply(gen_params, z)

    def wasserstein_estimate(self, z, rng, n: int = 512) -> torch.Tensor:
        """``mean D(real) − mean D(fake)`` over ``n`` draws each, for one
        iterate ``z`` (12 leaves, unstacked)."""
        gen, disc = z[:NET_LEAVES], z[NET_LEAVES:]
        r = jr.split(rng)
        real = _mixture_sample(r[0], n)
        fake = self.generate(gen, r[1], n)
        return (torch.mean(_mlp_apply(disc, real))
                - torch.mean(_mlp_apply(disc, fake)))

    def moment_distance(self, z, rng, n: int = 1024) -> torch.Tensor:
        """FID-style moment distance in data space, ``‖μ_r − μ_g‖² +
        ‖Σ_r − Σ_g‖²_F`` over ``n`` draws each."""
        gen = z[:NET_LEAVES]
        r = jr.split(rng)
        real = _mixture_sample(r[0], n)
        fake = self.generate(gen, r[1], n)
        mu_r, mu_g = torch.mean(real, 0), torch.mean(fake, 0)

        def cov(s, mu):
            d = s - mu
            return d.T @ d / s.shape[0]

        return (torch.sum((mu_r - mu_g) ** 2)
                + torch.sum((cov(real, mu_r) - cov(fake, mu_g)) ** 2))


def make_wgan_problem(
    rng,
    latent_dim: int = 8,
    data_dim: int = 2,
    hidden: int = 64,
    batch: int = 64,
    gp_weight: float = 1.0,
) -> WGANProblem:
    """The WGAN-GP minimax problem. ``rng`` is accepted for the JAX
    package's signature and draws nothing (as there): the networks are
    drawn by ``problem.init`` from the workers' keys."""
    del rng

    def init(rngs):
        k = jr.split(rngs)
        gen = _mlp_init(k[..., 0, :], (latent_dim, hidden, hidden, data_dim),
                        scale=1.0)
        disc = _mlp_init(k[..., 1, :], (data_dim, hidden, hidden, 1),
                         scale=1.0)
        return gen + disc

    def sample(rngs):
        k = jr.split(rngs, 3)
        return {
            "real": _mixture_sample(k[..., 0, :], batch),
            "z": jr.normal(k[..., 1, :], (batch, latent_dim)),
            "eps": jr.uniform(k[..., 2, :], (batch, 1)),
        }

    def saddle_loss(z, xi):
        """f((θ_G, θ_D), ξ) per worker, ``(M,)``: min over θ_G, max over
        θ_D."""
        gen, disc = z[:NET_LEAVES], z[NET_LEAVES:]
        fake = _mlp_apply(gen, xi["z"])
        d_real = _mlp_apply(disc, xi["real"])
        d_fake = _mlp_apply(disc, fake)
        # gradient penalty at the interpolates (not detached: the generator
        # reaches the penalty through fake)
        eps = xi["eps"]
        x_hat = eps * xi["real"] + (1.0 - eps) * fake
        (grads,) = torch.autograd.grad(_mlp_apply(disc, x_hat).sum(), x_hat,
                                       create_graph=True)
        norm = _Sqrt.apply(torch.sum(grads ** 2, -1) + 1e-12)
        gp = torch.mean((norm - 1.0) ** 2, -1)
        return (torch.mean(d_real, (-2, -1)) - torch.mean(d_fake, (-2, -1))
                - gp_weight * gp)

    def oracle(z, xi):
        with torch.enable_grad():
            leaves = tuple(v.detach().requires_grad_(True) for v in z)
            grads = torch.autograd.grad(saddle_loss(leaves, xi).sum(), leaves)
        return (grads[:NET_LEAVES]
                + tuple(-g for g in grads[NET_LEAVES:]))

    problem = MinimaxProblem(
        init=init,
        sample=sample,
        oracle=oracle,
        project=projections.identity(),
        name="wgan_gp",
    )
    return WGANProblem(
        problem=problem,
        latent_dim=latent_dim,
        data_dim=data_dim,
        batch=batch,
        gp_weight=gp_weight,
    )
