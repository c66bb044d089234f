"""Wrappers of the sync CUDA kernels (``csrc/sync_compress.cu``; port of
``repro.kernels.sync_compress.kernel``): the server merge and the four
codec uplink passes.

* :func:`merge_stacked`   — Line-7 weighted sum, broadcast, recv/old gating;
* :func:`uplink_stats`    — quantize pass 1: per-worker ``max|w·z + ef|``;
* :func:`quantize_uplink` — quantize pass 2: stochastic quantization of
  ``eff = w·z + ef`` with in-kernel threefry uniforms, and the residual;
* :func:`eff_uplink`      — top-k pass 1: ``eff = w·z + ef``;
* :func:`mask_uplink`     — top-k pass 2: apply the keep mask, write the
  complementary residual;
* :func:`trimmed_merge_stacked` — the robust merge: per-coordinate trimmed
  weighted mean by stable rank, broadcast, recv/old gating;
* :func:`outer_apply`     — the server's outer-optimizer step on the
  ``(1, n)`` server leaf.

Each takes one worker-stacked flat leaf ``(M, n)`` with per-worker
``(M,)`` scalars. A CPU tensor goes to the plain version in :mod:`.ref`; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from .._build import F, I, P
from .ref import (
    adam_bias,
    eff_uplink_ref,
    mask_uplink_ref,
    f32,
    merge_ref,
    outer_apply_ref,
    quantize_uplink_ref,
    trimmed_merge_ref,
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
TRIMMED = _build.Kernel("trimmed_merge_stacked", _SRC, "trimmed_merge_launch",
                        [P, P, P, P, P, P, I, I, F, P])
OUTER = _build.Kernel("outer_apply", _SRC, "outer_apply_launch",
                      [P, P, P, P, P, P, P, P, P, I, I, I, F, F, F, F, F, F,
                       P])

#: the merge kernel keeps the M weights in shared memory (48 KB at most,
#: beside the row slices' 4 KB of partial sums)
MAX_ROWS = 12 * 1024
#: columns of one worker's row per block of the uplink kernels
TILE = 2048
#: the robust merge stages an (M, 32) slice, three (M,) vectors, a byte of
#: keep flag per slice entry and 33 scalars in shared memory: at most
#: 227 KB, so M <= 1350
TRIMMED_MAX_ROWS = (232448 - 4 * (32 + 1)) // (4 * (32 + 3) + 32)
#: columns of the server leaf per block of the outer step
OUTER_TILE = 1024
_OUTER_KINDS = {"momentum": 0, "nesterov": 1, "adam": 2}


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


def trimmed_merge_stacked(z, w, incl, recv=None, old=None, *, trim: int):
    """Robust merge on a stacked ``(M, n)`` leaf: the per-coordinate
    ``trim``-per-side trimmed weighted mean over the included rows
    (``incl`` 0/1, ``(M,)``), renormalised over the survivors' weight and
    broadcast to every row; rows whose ``recv`` is falsy keep ``old``
    (default ``z``). ``trim = ⌊(M−1)/2⌋`` is the coordinate median."""
    if _build.on_cpu(z):
        return trimmed_merge_ref(z, w, incl, trim=trim,
                                 recv=None if recv is None else recv > 0,
                                 old=old)
    if recv is None:
        old = None
    elif old is None:
        old = z
    rows, n, _ = _build.layout("trimmed_merge_stacked", z, old,
                               max_rows=TRIMMED_MAX_ROWS)
    wf = _build.per_worker_f32("trimmed_merge_stacked", w, rows, z)
    inf = _build.per_worker_f32("trimmed_merge_stacked", incl, rows, z)
    rf = _build.per_worker_f32("trimmed_merge_stacked", recv, rows, z)
    out = torch.empty_like(z)
    TRIMMED(z.data_ptr(), wf.data_ptr(), inf.data_ptr(), _ptr(rf), _ptr(old),
            out.data_ptr(), rows, n, float(trim), _build.stream_of(z))
    return out


def outer_scalars(spec):
    """The outer-step kernel's scalar arguments for a ``ps.server_opt``
    spec: the policy's kind, lr, β₁ (momentum's β), β₂, ε, and the float32
    ``1 − β₁`` and ``1 − β₂`` the update multiplies by."""
    kind = spec[0]
    if kind not in _OUTER_KINDS:
        raise ValueError(f"unknown server-opt spec {spec!r}")
    lr, b1, b2, eps = (spec[1:] if kind == "adam" else
                       (spec[1], spec[2], 0.0, 0.0))
    return (_OUTER_KINDS[kind], f32(lr), f32(b1), f32(b2), f32(eps),
            f32(1.0 - b1), f32(1.0 - b2))


def outer_apply(merged, z, mom, t, *, spec):
    """The server's outer step on one server leaf (``(1, n)``, or any
    contiguous shape): ``Δ = merged − z``, one moment update and step of
    the ``ps.server_opt`` policy ``spec``. ``mom`` holds the moment leaves
    (1 for momentum/nesterov, 2 for adam), ``t`` the f32 round count before
    this step (a tensor on ``z``'s device). Returns ``(z_new, mom_new,
    delta_sq)`` with ``delta_sq = Σ Δ²`` (0-d)."""
    if _build.on_cpu(z):
        return outer_apply_ref(merged, z, mom, t, spec=spec)
    scalars = outer_scalars(spec)
    slots = 2 if spec[0] == "adam" else 1
    if len(mom) != slots:
        raise ValueError(f"outer_apply: {spec[0]} takes {slots} moment "
                         f"leaves, got {len(mom)}")
    _build.check_cuda_f32("outer_apply", merged, z, *mom)
    if any(v.shape != z.shape for v in (merged, *mom)):
        raise ValueError("outer_apply: merged, z and the moments must share "
                         f"the shape {tuple(z.shape)}")
    n = z.numel()
    if n == 0:
        raise ValueError("outer_apply: empty leaf")
    bias = adam_bias(spec[2], spec[3], t) if slots == 2 else None
    z_new = torch.empty_like(z)
    mom_new = tuple(torch.empty_like(v) for v in mom)
    part = torch.empty((n + OUTER_TILE - 1) // OUTER_TILE,
                       dtype=torch.float32, device=z.device)
    m1, m1_out = (mom[1], mom_new[1]) if slots == 2 else (None, None)
    OUTER(merged.data_ptr(), z.data_ptr(), mom[0].data_ptr(), _ptr(m1),
          _ptr(bias), z_new.data_ptr(), mom_new[0].data_ptr(), _ptr(m1_out),
          part.data_ptr(), n, OUTER_TILE, *scalars, _build.stream_of(z))
    return z_new, mom_new, torch.sum(part)
