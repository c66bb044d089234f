"""Wrappers of the fused extragradient CUDA kernels
(``csrc/adaseg_update.cu``; port of ``repro.kernels.adaseg_update.kernel``).

Each wrapper takes worker-stacked flat leaves ``(M, n)`` — one launch for
the whole fleet, where the JAX package vmaps a per-leaf kernel — and
returns per-worker ``(M,)`` statistics:

* :func:`adaseg_explore` — z_t = Π_box(z* − η·m_t), with ‖m_t‖² and, with
  ``want_norm``, ‖z_t‖² (l2 pass 1);
* :func:`adaseg_anchor`  — z̃ = Π_box(z* − η·g_t), with the (Z_t)²
  numerator ‖z_t − z*‖² + ‖z_t − z̃‖² and ‖g_t‖²;
* :func:`adaseg_finish`  — l2 pass 2: z_t = s_t·raw_t, z̃ = s_l·raw_l, with
  the (Z_t)² numerator.

η is given (``eta=``) or fused from the AdaGrad accumulator (``sum_sq=``,
η = d_alpha/√(g0² + sum_sq) in-register), per worker.

A CPU tensor goes to the plain version in :mod:`.ref`; a CUDA tensor
launches the kernel or raises. The kernel writes ``(M, tiles, k)``
partials that are summed here over the tiles in a fixed order.
"""
from __future__ import annotations

import torch

from .. import _build
from .._build import F, I, P
from .ref import adaseg_anchor_ref, adaseg_explore_ref, adaseg_finish_ref

#: elements of one worker's row per thread block
TILE = 4096

_SRC = "adaseg_update.cu"
EXPLORE = _build.Kernel(
    "adaseg_explore", _SRC, "adaseg_explore_launch",
    [P, P, P, P, P, I, I, I, I, I, F, F, I, F, F, I, P])
ANCHOR = _build.Kernel(
    "adaseg_anchor", _SRC, "adaseg_anchor_launch",
    [P, P, P, P, P, P, I, I, I, I, I, F, F, I, F, F, P])
FINISH = _build.Kernel(
    "adaseg_finish", _SRC, "adaseg_finish_launch",
    [P, P, P, P, P, P, P, P, I, I, I, I, P])


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if not t.is_cuda:
        raise ValueError(f"unsupported device {t.device}")
    return False


def _per_worker_f32(v, rows: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or ``(M,)`` value as a contiguous f32 ``(M,)`` tensor."""
    t = torch.as_tensor(v, dtype=torch.float32, device=like.device)
    return t.expand(rows).contiguous() if t.ndim == 0 else t.contiguous()


def _sched(eta, sum_sq, rows, like):
    if (eta is None) == (sum_sq is None):
        raise ValueError("pass exactly one of eta= or sum_sq=")
    if sum_sq is not None:
        return _per_worker_f32(sum_sq, rows, like), 1
    return _per_worker_f32(eta, rows, like), 0


def _layout(name, *tensors):
    """Check the (M, n) operands; returns (M, n, tiles, vec)."""
    _build.check_cuda_f32(name, *tensors)
    rows, n = tensors[0].shape
    for t in tensors[1:]:
        if t.shape != (rows, n):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {(rows, n)}")
    if n == 0 or rows == 0 or rows > 65535:
        raise ValueError(f"{name}: unsupported shape {(rows, n)}")
    vec = int(n % 4 == 0 and _build.aligned16(*tensors))
    return rows, n, (n + TILE - 1) // TILE, vec


def _box_args(lo, hi):
    if lo is None:
        return 0, 0.0, 0.0
    return 1, float(lo), float(hi)


def adaseg_explore(z_star, m_t, eta=None, *, sum_sq=None, g0=0.0,
                   d_alpha=1.0, lo=None, hi=None, want_norm=False):
    """Returns ``(z_t, norm, msq)``, statistics ``(M,)``."""
    if _on_cpu(z_star):
        return adaseg_explore_ref(z_star, m_t, eta, sum_sq=sum_sq, g0=g0,
                                  d_alpha=d_alpha, lo=lo, hi=hi,
                                  want_norm=want_norm)
    rows, n, tiles, vec = _layout("adaseg_explore", z_star, m_t)
    sched, fuse = _sched(eta, sum_sq, rows, z_star)
    out = torch.empty_like(z_star)
    part = torch.empty((rows, tiles, 2), dtype=torch.float32,
                       device=z_star.device)
    EXPLORE(z_star.data_ptr(), m_t.data_ptr(), sched.data_ptr(),
            out.data_ptr(), part.data_ptr(), rows, n, TILE, vec, fuse,
            float(g0) ** 2, float(d_alpha), *_box_args(lo, hi),
            int(want_norm), _build.stream_of(z_star))
    acc = part.sum(dim=1)
    return out, acc[:, 0], acc[:, 1]


def adaseg_anchor(z_star, z_t, g_t, eta=None, *, sum_sq=None, g0=0.0,
                  d_alpha=1.0, lo=None, hi=None):
    """Returns ``(z_tilde, stat, gsq)``, statistics ``(M,)``."""
    if _on_cpu(z_star):
        return adaseg_anchor_ref(z_star, z_t, g_t, eta, sum_sq=sum_sq, g0=g0,
                                 d_alpha=d_alpha, lo=lo, hi=hi)
    rows, n, tiles, vec = _layout("adaseg_anchor", z_star, z_t, g_t)
    sched, fuse = _sched(eta, sum_sq, rows, z_star)
    ztl = torch.empty_like(z_star)
    part = torch.empty((rows, tiles, 2), dtype=torch.float32,
                       device=z_star.device)
    ANCHOR(z_star.data_ptr(), z_t.data_ptr(), g_t.data_ptr(),
           sched.data_ptr(), ztl.data_ptr(), part.data_ptr(), rows, n, TILE,
           vec, fuse, float(g0) ** 2, float(d_alpha), *_box_args(lo, hi),
           _build.stream_of(z_star))
    acc = part.sum(dim=1)
    return ztl, acc[:, 0], acc[:, 1]


def adaseg_finish(z_star, zt_raw, ztl_raw, scale_t, scale_tl):
    """Returns ``(z_t, z_tilde, stat)``; scales are scalars or ``(M,)``."""
    if _on_cpu(z_star):
        return adaseg_finish_ref(z_star, zt_raw, ztl_raw, scale_t, scale_tl)
    rows, n, tiles, vec = _layout("adaseg_finish", z_star, zt_raw, ztl_raw)
    s_t = _per_worker_f32(scale_t, rows, z_star)
    s_l = _per_worker_f32(scale_tl, rows, z_star)
    zt = torch.empty_like(z_star)
    ztl = torch.empty_like(z_star)
    part = torch.empty((rows, tiles, 1), dtype=torch.float32,
                       device=z_star.device)
    FINISH(z_star.data_ptr(), zt_raw.data_ptr(), ztl_raw.data_ptr(),
           s_t.data_ptr(), s_l.data_ptr(), zt.data_ptr(), ztl.data_ptr(),
           part.data_ptr(), rows, n, TILE, vec, _build.stream_of(z_star))
    return zt, ztl, part.sum(dim=1)[:, 0]
