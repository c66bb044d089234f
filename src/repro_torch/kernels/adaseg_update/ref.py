"""Plain PyTorch versions of the fused extragradient kernels (port of
``repro.kernels.adaseg_update.ref``).

One function per kernel in :mod:`.kernel`, batched over a leading worker
axis: leaves are ``(M, n)``, η / ``sum_sq`` / scales are per worker
(``(M,)`` tensors, or Python scalars shared by every worker), and every
statistic is a per-worker ``(M,)`` sum. Same f32 expressions as the JAX
references, so the two packages compare leaf by leaf.
"""
from __future__ import annotations

import torch

from ...core.tree import per_worker


def _eta_ref(eta, sum_sq, g0, d_alpha):
    if (eta is None) == (sum_sq is None):
        raise ValueError("pass exactly one of eta= or sum_sq=")
    if sum_sq is not None:
        return d_alpha / torch.sqrt(g0 ** 2 + sum_sq.float())
    return eta


def _rowsum(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape[0], -1).sum(dim=1)


def adaseg_explore_ref(z_star, m_t, eta=None, *, sum_sq=None, g0=0.0,
                       d_alpha=1.0, lo=None, hi=None, want_norm=False):
    """z_t = Π_box(z* − η·m_t). Returns ``(z_t, ‖z_t‖² or 0, ‖m_t‖²)``."""
    eta = per_worker(_eta_ref(eta, sum_sq, g0, d_alpha), z_star)
    out = z_star - eta * m_t
    if lo is not None:
        out = torch.clamp(out, lo, hi)
    outf = out.float()
    norm = (_rowsum(outf * outf) if want_norm
            else torch.zeros(z_star.shape[0], device=z_star.device))
    mf = m_t.float()
    return out, norm, _rowsum(mf * mf)


def adaseg_anchor_ref(z_star, z_t, g_t, eta=None, *, sum_sq=None, g0=0.0,
                      d_alpha=1.0, lo=None, hi=None):
    """z̃ = Π_box(z* − η·g_t). Returns ``(z̃, stat, ‖g_t‖²)`` with
    stat = ‖z_t − z*‖² + ‖z_t − z̃‖²."""
    eta = per_worker(_eta_ref(eta, sum_sq, g0, d_alpha), z_star)
    ztl = z_star - eta * g_t
    if lo is not None:
        ztl = torch.clamp(ztl, lo, hi)
    d1 = (z_t - z_star).float()
    d2 = (z_t - ztl).float()
    gf = g_t.float()
    return ztl, _rowsum(d1 * d1 + d2 * d2), _rowsum(gf * gf)


def adaseg_finish_ref(z_star, zt_raw, ztl_raw, scale_t, scale_tl):
    """l2 pass 2: ``(s_t·raw_t, s_l·raw_l, stat)``."""
    z_t = (per_worker(scale_t, z_star) * zt_raw.float()).to(z_star.dtype)
    ztl = (per_worker(scale_tl, z_star) * ztl_raw.float()).to(z_star.dtype)
    d1 = (z_t - z_star).float()
    d2 = (z_t - ztl).float()
    return z_t, ztl, _rowsum(d1 * d1 + d2 * d2)
