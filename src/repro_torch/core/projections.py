"""Euclidean projections Π_Z (port of ``repro.core.projections``).

Each projection acts per worker on a worker-stacked iterate. The ``.spec``
tag is how the fused step backend picks a kernel: ``("identity",)``,
``("box", lo, hi)`` and ``("l2", radius)`` fuse into the update kernels;
a projection without a spec (``simplex``, a hand-written callable) makes
the fused backend fall back to the reference math.
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
        scale = torch.clamp(radius / torch.clamp(n, min=1e-30), max=1.0)
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
