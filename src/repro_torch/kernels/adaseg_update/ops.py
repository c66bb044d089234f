"""Tree-level wrappers of the fused extragradient kernels (port of
``repro.kernels.adaseg_update.ops``).

``core.adaseg.local_step(backend="fused")`` calls :func:`adaseg_tree_explore`
and :func:`adaseg_tree_anchor`. The iterate is a tuple of worker-stacked
leaves ``(M, ...)``; each leaf is flattened to ``(M, n)`` and handed to one
kernel launch, and the per-worker statistics are summed over the leaves.

Projections are static specs, so the kernels fuse them:

* ``("identity",)`` — unconstrained;
* ``("box", lo, hi)`` — per-element clip, fused into every pass;
* ``("l2", radius)`` — per-worker ball over the WHOLE iterate (all leaves):
  pass 1 writes the raw update and its squared norm, the scale
  min(1, r/‖·‖) is formed per worker here, pass 2 applies it.

η is given (``eta=``) or fused from ``sum_sq=`` with ``g0``/``d_alpha``.

Examples
--------
>>> import torch
>>> z = (torch.tensor([[0.5, -0.8, 0.2]]),)
>>> m = (0.3 * z[0],)
>>> z_t, m_sq = adaseg_tree_explore(z, m, sum_sq=torch.tensor([4.0]),
...                                 g0=1.0, d_alpha=2.0,
...                                 proj=("box", -1.0, 1.0))
>>> z_t[0].shape, m_sq.shape
(torch.Size([1, 3]), torch.Size([1]))
"""
from __future__ import annotations

import torch

from ...core.tree import per_worker
from .kernel import adaseg_anchor, adaseg_explore, adaseg_finish


def _norm_proj(proj):
    if proj is None:
        return ("identity",)
    if proj[0] not in ("identity", "box", "l2"):
        raise ValueError(f"unknown projection spec {proj!r}")
    return proj


def _box_bounds(spec):
    return (spec[1], spec[2]) if spec[0] == "box" else (None, None)


def _flat2(leaf: torch.Tensor) -> torch.Tensor:
    """Worker-stacked leaf (M, ...) → contiguous (M, n)."""
    return leaf.reshape(leaf.shape[0], -1).contiguous()


def _ball_scale(radius, norm_sq):
    """Same formula as ``core.projections.l2_ball``, per worker."""
    norm = torch.sqrt(norm_sq)
    return torch.clamp(radius / torch.clamp(norm, min=1e-30), max=1.0)


def adaseg_tree_explore(z_star, m_t, eta=None, *, sum_sq=None, g0=0.0,
                        d_alpha=1.0, proj=None):
    """Exploration half-step z_t = Π(z* − η·M_t) over the iterate.

    Returns ``(z_t, m_sq)`` with m_sq = Σ‖M_t‖² per worker.
    """
    spec = _norm_proj(proj)
    kw = dict(eta=eta, sum_sq=sum_sq, g0=g0, d_alpha=d_alpha)
    if spec[0] != "l2":
        lo, hi = _box_bounds(spec)
        outs, msqs = [], []
        for z, m in zip(z_star, m_t):
            out, _, msq = adaseg_explore(_flat2(z), _flat2(m), lo=lo, hi=hi,
                                         **kw)
            outs.append(out.reshape(z.shape))
            msqs.append(msq)
        return tuple(outs), sum(msqs)

    raws, norms, msqs = [], [], []
    for z, m in zip(z_star, m_t):
        out, nrm, msq = adaseg_explore(_flat2(z), _flat2(m), want_norm=True,
                                       **kw)
        raws.append(out)
        norms.append(nrm)
        msqs.append(msq)
    scale = _ball_scale(spec[1], sum(norms))
    outs = tuple(
        (per_worker(scale, r) * r.float()).to(z.dtype).reshape(z.shape)
        for z, r in zip(z_star, raws)
    )
    return outs, sum(msqs)


def adaseg_tree_anchor(z_star, z_t, g_t, eta=None, *, sum_sq=None, g0=0.0,
                       d_alpha=1.0, proj=None):
    """Anchor half-step z̃ = Π(z* − η·g_t) over the iterate, given z_t.

    Returns ``(z_tilde, stat, g_sq)`` per worker, with
    stat = ‖z_t − z*‖² + ‖z_t − z̃‖² (the caller divides by 5η²).
    """
    spec = _norm_proj(proj)
    kw = dict(eta=eta, sum_sq=sum_sq, g0=g0, d_alpha=d_alpha)
    if spec[0] != "l2":
        lo, hi = _box_bounds(spec)
        outs, stats, gsqs = [], [], []
        for z, zt, g in zip(z_star, z_t, g_t):
            ztl, stat, gsq = adaseg_anchor(_flat2(z), _flat2(zt), _flat2(g),
                                           lo=lo, hi=hi, **kw)
            outs.append(ztl.reshape(z.shape))
            stats.append(stat)
            gsqs.append(gsq)
        return tuple(outs), sum(stats), sum(gsqs)

    # Pass 1: raw z̃ candidate (an explore with g_t) + its squared norm.
    raws, norms, gsqs = [], [], []
    for z, g in zip(z_star, g_t):
        raw, nrm, gsq = adaseg_explore(_flat2(z), _flat2(g), want_norm=True,
                                       **kw)
        raws.append(raw)
        norms.append(nrm)
        gsqs.append(gsq)
    s_l = _ball_scale(spec[1], sum(norms))
    # Pass 2: scale z̃ onto the ball; z_t is already final (scale 1).
    outs, stats = [], []
    for z, zt, raw in zip(z_star, z_t, raws):
        _, ztl, stat = adaseg_finish(_flat2(z), _flat2(zt), raw, 1.0, s_l)
        outs.append(ztl.reshape(z.shape))
        stats.append(stat)
    return tuple(outs), sum(stats), sum(gsqs)
