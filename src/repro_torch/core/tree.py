"""Vector-space helpers on the joint iterate (port of ``repro.core.tree``).

Pytrees become tuples of tensors: the bilinear iterate is the pair
``(x, y)``. Every leaf carries a leading worker axis ``M``, so norms and
dot products are per worker (``(M,)``) and a scalar coefficient may be
per worker too (a ``(M,)`` tensor broadcast over each leaf's trailing
dimensions).
"""
from __future__ import annotations

import torch


def per_worker(c, leaf: torch.Tensor):
    """Broadcast a ``(M,)`` coefficient over a worker-stacked leaf (Python
    scalars and 0-d tensors pass through)."""
    if isinstance(c, torch.Tensor) and c.ndim == 1:
        return c.reshape((-1,) + (1,) * (leaf.ndim - 1))
    return c


def tree_map(fn, *trees) -> tuple:
    return tuple(fn(*leaves) for leaves in zip(*trees))


def tree_sub(a, b) -> tuple:
    return tree_map(torch.sub, a, b)


def tree_scale(c, a) -> tuple:
    return tree_map(lambda v: per_worker(c, v) * v, a)


def tree_axpy(c, a, b) -> tuple:
    """c * a + b."""
    return tree_map(lambda u, v: per_worker(c, u) * u + v, a, b)


def tree_norm_sq(a) -> torch.Tensor:
    """Per-worker ‖z‖² = Σ_leaves Σ v² in float32, ``(M,)``."""
    total = None
    for v in a:
        s = v.reshape(v.shape[0], -1).float().square().sum(dim=1)
        total = s if total is None else total + s
    return total


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_norm_sq(a))


def tree_zeros_like(a) -> tuple:
    return tree_map(torch.zeros_like, a)


def tree_where(pred: torch.Tensor, a, b) -> tuple:
    """Per-worker select: rows where ``pred`` (``(M,)`` bool) come from
    ``a``, the others from ``b``."""
    return tree_map(lambda u, v: torch.where(per_worker(pred, u), u, v), a, b)
