"""Wrappers of the sync CUDA kernels (``csrc/sync_compress.cu``; port of
``repro.kernels.sync_compress.kernel``): the server merge and the four
codec uplink passes.

* :func:`merge_stacked`   — Line-7 weighted sum, broadcast, recv/old gating;
* :func:`uplink_stats`    — quantize pass 1: per-worker ``max|w·z + ef|``;
* :func:`quantize_uplink` — quantize pass 2: stochastic quantization of
  ``eff = w·z + ef`` with in-kernel threefry uniforms, and the residual;
* :func:`eff_uplink`      — top-k pass 1: ``eff = w·z + ef``;
* :func:`mask_uplink`     — top-k pass 2: apply the keep mask, write the
  complementary residual.

Each takes one worker-stacked flat leaf ``(M, n)`` with per-worker
``(M,)`` scalars. A CPU tensor goes to the plain version in :mod:`.ref`; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from .._build import F, I, P
from .ref import (
    eff_uplink_ref,
    mask_uplink_ref,
    merge_ref,
    quantize_uplink_ref,
    uplink_stats_ref,
)

_SRC = "sync_compress.cu"
MERGE = _build.Kernel("merge_stacked", _SRC, "merge_stacked_launch",
                      [P, P, P, P, P, I, I, I, I, P])
STATS = _build.Kernel("uplink_stats", _SRC, "uplink_stats_launch",
                      [P, P, P, P, I, I, I, I, P])
QUANTIZE = _build.Kernel("quantize_uplink", _SRC, "quantize_uplink_launch",
                         [P, P, P, P, P, P, P, P, I, I, I, I, F, P])
EFF = _build.Kernel("eff_uplink", _SRC, "eff_uplink_launch",
                    [P, P, P, P, I, I, I, I, P])
MASK = _build.Kernel("mask_uplink", _SRC, "mask_uplink_launch",
                     [P, P, P, P, P, P, I, I, I, I, P])

#: the merge kernel keeps the M weights in (default-sized) shared memory
MAX_ROWS = 12 * 1024
#: columns of one worker's row per block of the uplink kernels
TILE = 2048


def _ptr(t):
    return None if t is None else t.data_ptr()


def merge_stacked(z, w=None, recv=None, old=None, *, normalize=False):
    """Fused Line-7 merge on a stacked ``(M, n)`` leaf: Σ_m w_m z[m] (w
    normalised when asked) broadcast to every row; rows whose ``recv`` is
    falsy keep ``old`` (default ``z``)."""
    if _build.on_cpu(z):
        return merge_ref(z, w, normalize=normalize,
                         recv=None if recv is None else recv > 0, old=old)
    if recv is None:
        old = None
    elif old is None:
        old = z
    rows, n, vec = _build.layout("merge_stacked", z, old, max_rows=MAX_ROWS)
    wf = _build.per_worker_f32("merge_stacked", w, rows, z)
    rf = _build.per_worker_f32("merge_stacked", recv, rows, z)
    out = torch.empty_like(z)
    MERGE(z.data_ptr(), _ptr(wf), _ptr(rf), _ptr(old), out.data_ptr(), rows,
          n, int(normalize), vec, _build.stream_of(z))
    return out


def _key_words(keys, rows, like):
    """``(M, 2)`` int64 keys as the uint32 words the kernel reads (held in
    an int32 tensor, two's complement)."""
    k = torch.as_tensor(keys, device=like.device)
    if k.shape != (rows, 2):
        raise ValueError(f"keys of shape {tuple(k.shape)}, expected "
                         f"{(rows, 2)}")
    k = k.to(torch.int64) & 0xFFFFFFFF
    return torch.where(k >= 1 << 31, k - (1 << 32), k).to(torch.int32)


def uplink_stats(z, w=None, ef=None):
    """Per-worker ``max|w·z + ef|`` ``(M,)`` without materialising the
    effective message (the caller applies the 1e-30 clamp)."""
    if _build.on_cpu(z):
        return uplink_stats_ref(z, ef, w)
    rows, n, vec = _build.layout("uplink_stats", z, ef)
    wf = _build.per_worker_f32("uplink_stats", w, rows, z)
    part = torch.empty((rows, (n + TILE - 1) // TILE), dtype=torch.float32,
                       device=z.device)
    STATS(z.data_ptr(), _ptr(wf), _ptr(ef), part.data_ptr(), rows, n, TILE,
          vec, _build.stream_of(z))
    return torch.amax(part, dim=1)


def quantize_uplink(z, keys, scale, w=None, ef=None, alive=None, *,
                    levels: float):
    """Stochastic quantization of ``eff = w·z + ef`` to ``levels`` levels
    against the clamped per-worker ``scale``, uniforms from the codec
    stream under the ``(M, 2)`` ``keys``. Returns ``(sent, ef_new)``
    (``ef_new`` None without ``ef``); dead rows (``alive`` falsy) send
    zeros and keep ``ef``."""
    if _build.on_cpu(z):
        sent, ef_new = quantize_uplink_ref(z, keys, scale, levels=levels,
                                           ef=ef, w=w, alive=alive)
        return sent, None if ef is None else ef_new
    rows, n, vec = _build.layout("quantize_uplink", z, ef)
    wf = _build.per_worker_f32("quantize_uplink", w, rows, z)
    sc = _build.per_worker_f32("quantize_uplink", scale, rows, z)
    af = _build.per_worker_f32("quantize_uplink", alive, rows, z)
    kw = _key_words(keys, rows, z)
    sent = torch.empty_like(z)
    ef_new = None if ef is None else torch.empty_like(z)
    QUANTIZE(z.data_ptr(), _ptr(wf), _ptr(ef), sc.data_ptr(), _ptr(af),
             kw.data_ptr(), sent.data_ptr(), _ptr(ef_new), rows, n, TILE, vec,
             float(levels), _build.stream_of(z))
    return sent, ef_new


def eff_uplink(z, w=None, ef=None):
    """The effective message ``w·z + ef`` ``(M, n)``, rounded once."""
    if _build.on_cpu(z):
        return eff_uplink_ref(z, ef, w)
    rows, n, vec = _build.layout("eff_uplink", z, ef)
    wf = _build.per_worker_f32("eff_uplink", w, rows, z)
    out = torch.empty_like(z)
    EFF(z.data_ptr(), _ptr(wf), _ptr(ef), out.data_ptr(), rows, n, TILE, vec,
        _build.stream_of(z))
    return out


def mask_uplink(eff, mask, ef=None, alive=None):
    """Keep the entries of ``eff`` where ``mask`` (``(M, n)``; uint8 or
    bool on the card) is nonzero and write the rest back as the residual.
    ``ef`` is read only for dead rows, which send zeros and keep it.
    Returns ``(sent, ef_new)`` (``ef_new`` None without ``ef``)."""
    if _build.on_cpu(eff):
        sent, ef_new = mask_uplink_ref(eff, mask, alive=alive, ef=ef)
        return sent, None if ef is None else ef_new
    rows, n, vec = _build.layout("mask_uplink", eff, ef)
    if mask.dtype == torch.bool:
        mask = mask.view(torch.uint8)
    if (mask.dtype != torch.uint8 or mask.shape != (rows, n)
            or not mask.is_contiguous() or mask.device != eff.device):
        raise ValueError(f"mask_uplink: mask must be a contiguous uint8 "
                         f"{(rows, n)} tensor on {eff.device}")
    vec = int(vec and mask.data_ptr() % 4 == 0)
    af = _build.per_worker_f32("mask_uplink", alive, rows, eff)
    sent = torch.empty_like(eff)
    ef_new = None if ef is None else torch.empty_like(eff)
    MASK(eff.data_ptr(), mask.data_ptr(), _ptr(ef), _ptr(af), sent.data_ptr(),
         _ptr(ef_new), rows, n, TILE, vec, _build.stream_of(eff))
    return sent, ef_new
