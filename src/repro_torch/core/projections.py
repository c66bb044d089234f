"""Euclidean projections Π_Z (port of ``repro.core.projections``).

Each projection acts per worker on a worker-stacked iterate. The ``.spec``
tag is how the fused step backend picks a kernel: ``("identity",)``,
``("box", lo, hi)`` and ``("l2", radius)`` fuse into the update kernels;
a projection without a spec (``simplex``, ``product``, a hand-written
callable) makes the fused backend run the reference math, as the JAX
package's fused step does.
"""
from __future__ import annotations

import torch

from .tree import tree_map, tree_norm, tree_scale


def spec_of(proj_fn):
    """Static description of a projection, or None when opaque."""
    return getattr(proj_fn, "spec", None)


def identity():
    def proj(z):
        return z

    proj.spec = ("identity",)
    return proj


def box(lo: float = -1.0, hi: float = 1.0):
    def proj(z):
        return tree_map(lambda v: torch.clamp(v, lo, hi), z)

    proj.spec = ("box", float(lo), float(hi))
    return proj


def l2_ball(radius: float = 1.0):
    """Project each worker's whole iterate (all leaves as one vector) onto
    the l2 ball — the paper's ‖z‖_Z on the product space."""

    def proj(z):
        n = tree_norm(z)
        # a full-shape numerator: PyTorch's CPU kernels turn ``float /
        # tensor`` into a multiplication by the reciprocal (ROADMAP C7)
        scale = torch.clamp(torch.full_like(n, radius)
                            / torch.clamp(n, min=1e-30), max=1.0)
        return tree_scale(scale, z)

    proj.spec = ("l2", float(radius))
    return proj


def simplex():
    """Project each leaf's last axis onto the probability simplex
    (sort-based, Held/Wolfe/Crowder). Opaque: it carries no spec."""

    def _proj_vec(v):
        n = v.shape[-1]
        u = torch.sort(v, dim=-1, descending=True).values
        css = torch.cumsum(u, dim=-1) - 1.0
        idx = torch.arange(1, n + 1, dtype=v.dtype, device=v.device)
        rho = torch.sum(u - css / idx > 0, dim=-1, keepdim=True)
        theta = torch.gather(css, -1, rho - 1) / rho.to(v.dtype)
        return torch.clamp(v - theta, min=0.0)

    def proj(z):
        return tree_map(_proj_vec, z)

    return proj


def _on_block(proj, block):
    """A projection on one block of ``z``: a bare tensor is taken as the
    one-leaf tree ``(block,)``, as a JAX array is a one-leaf pytree."""
    if isinstance(block, torch.Tensor):
        return proj((block,))[0]
    return proj(block)


def product(proj_x, proj_y):
    """Apply ``proj_x`` to the primal block and ``proj_y`` to the dual block
    of ``z = (x, y)``. Opaque: it carries no spec.

    >>> proj = product(l2_ball(1.0), simplex())
    >>> x, y = proj((torch.tensor([[3.0, 4.0]]), torch.tensor([[0.5, 1.5]])))
    >>> x.tolist(), y.tolist()
    ([[0.6000000238418579, 0.800000011920929]], [[0.0, 1.0]])
    >>> spec_of(proj) is None
    True
    """

    def proj(z):
        x, y = z
        return (_on_block(proj_x, x), _on_block(proj_y, y))

    return proj
