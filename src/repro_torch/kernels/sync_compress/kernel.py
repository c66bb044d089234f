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
CUDA tensor launches the kernel or raises. Each is one launch: the scale
pass and the outer step finish their reductions in the kernel's last block
(:func:`tickets`).
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
                      [P, P, P, P, P, P, I, I, I, I, P])
QUANTIZE = _build.Kernel("quantize_uplink", _SRC, "quantize_uplink_launch",
                         [P, P, P, P, P, P, P, P, I, I, I, I, F, P])
EFF = _build.Kernel("eff_uplink", _SRC, "eff_uplink_launch",
                    [P, P, P, P, I, I, I, I, P])
MASK = _build.Kernel("mask_uplink", _SRC, "mask_uplink_launch",
                     [P, P, P, P, P, P, I, I, I, I, P])
TRIMMED = _build.Kernel("trimmed_merge_stacked", _SRC, "trimmed_merge_launch",
                        [P, P, P, P, P, P, I, I, F, I, P])
OUTER = _build.Kernel("outer_apply", _SRC, "outer_apply_launch",
                      [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, F, F, F,
                       F, F, F, P])

#: shared memory a block can take on an H100 (the opt-in carve-out)
SHARED_BYTES = 232448
#: the merge kernel keeps the M weights in shared memory, beside the row
#: slices' 4 KB of partial sums, up to this many rows; a larger fleet's
#: weights are read from global memory (the read-only path), with the same
#: bits
MAX_ROWS = (SHARED_BYTES - 4 * 256 * 4) // 4
#: columns of one worker's row per block of the quantize, eff and mask passes
TILE = 2048
#: columns a block of the scale pass (B6) covers in one pass (256 threads x
#: 16), and the blocks an SM its grid is sized to
STATS_STEP = 256 * 16
STATS_BLOCKS_PER_SM = 4
#: the robust merge's staged path keeps an (M, 32) slice, three (M,)
#: vectors, a byte of keep flag per slice entry and 33 scalars in shared
#: memory, so it takes M <= 1350; larger fleets take the streamed path
TRIMMED_STAGED_ROWS = (SHARED_BYTES - 4 * (32 + 1)) // (4 * (32 + 3) + 32)
TRIMMED_STAGED, TRIMMED_STREAMED = 0, 1
#: columns a block of the outer step covers in one pass (256 threads x 8),
#: and the blocks an SM its grid is sized to
OUTER_STEP = 256 * 8
OUTER_BLOCKS_PER_SM = 4
_OUTER_KINDS = {"momentum": 0, "nesterov": 1, "adam": 2}
#: the scale pass keeps one ticket a row; the buffer is made with this many
#: and grows with a larger fleet (:func:`tickets`)
STATS_TICKETS = 65535

_TICKETS: dict = {}


def _ptr(t):
    return None if t is None else t.data_ptr()


def tickets(name: str, count: int, device) -> torch.Tensor:
    """At least ``count`` int32 arrival counters of kernel ``name`` on
    ``device``, made at 0: the same buffer on every call, replaced by a
    larger one at 0 when a call asks for more. A kernel whose last block
    finishes a reduction counts its blocks in on them, and that block
    resets them to 0, so the next launch, or a CUDA graph's replay, finds
    them at 0. Launches that share them run in order, on one stream."""
    key = (name, torch.device(device))
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < count:
        if (torch.cuda.is_available()
                and torch.cuda.is_current_stream_capturing()):
            raise RuntimeError(f"{name}: call it once before capturing a "
                               "CUDA graph (its tickets are made at 0 then)")
        buf = _TICKETS[key] = torch.zeros(count, dtype=torch.int32,
                                          device=device)
    return buf


def stats_tile(rows: int, n: int, sms: int) -> int:
    """Columns per block of the scale pass (B6): whole passes of
    ``STATS_STEP`` columns, in as many tiles a row as keep the grid within
    ``STATS_BLOCKS_PER_SM`` blocks an SM (one wave), and at least one.

    >>> stats_tile(64, 16384, 132), stats_tile(4, 151936 * 896, 132)
    (4096, 1032192)
    """
    passes = -(-n // STATS_STEP)
    tiles = max(1, min(passes, sms * STATS_BLOCKS_PER_SM // rows))
    return -(-passes // tiles) * STATS_STEP


def outer_blocks(n: int, sms: int) -> int:
    """Blocks of the outer step (B11) on a leaf of ``n`` entries: one a
    pass of ``OUTER_STEP`` columns, at most ``OUTER_BLOCKS_PER_SM`` an SM.

    >>> outer_blocks(16384, 132), outer_blocks(151936 * 896, 132)
    (8, 528)
    """
    return max(1, min(-(-n // OUTER_STEP), sms * OUTER_BLOCKS_PER_SM))


def trimmed_path(rows: int) -> int:
    """The robust merge's path for a fleet of ``rows``: the staged slice
    (``TRIMMED_STAGED``) while it fits in shared memory, the streamed
    column (``TRIMMED_STREAMED``) above; the two give the same bits."""
    return TRIMMED_STAGED if rows <= TRIMMED_STAGED_ROWS else TRIMMED_STREAMED


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
    rows, n, vec = _build.layout("merge_stacked", z, old, max_rows=None)
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
    rows, n, vec = _build.layout("uplink_stats", z, ef, max_rows=None)
    wf = _build.per_worker_f32("uplink_stats", w, rows, z)
    tile = stats_tile(rows, n, _build.sm_count(z.device))
    part = torch.empty(rows * -(-n // tile), dtype=torch.float32,
                       device=z.device)
    out = torch.empty(rows, dtype=torch.float32, device=z.device)
    ticket = tickets("uplink_stats", max(rows, STATS_TICKETS), z.device)
    STATS(z.data_ptr(), _ptr(wf), _ptr(ef), part.data_ptr(), ticket.data_ptr(),
          out.data_ptr(), rows, n, tile, vec, _build.stream_of(z))
    return out


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
    rows, n, vec = _build.layout("quantize_uplink", z, ef, max_rows=None)
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
    rows, n, vec = _build.layout("eff_uplink", z, ef, max_rows=None)
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
    rows, n, vec = _build.layout("mask_uplink", eff, ef, max_rows=None)
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
                               max_rows=None)
    wf = _build.per_worker_f32("trimmed_merge_stacked", w, rows, z)
    inf = _build.per_worker_f32("trimmed_merge_stacked", incl, rows, z)
    rf = _build.per_worker_f32("trimmed_merge_stacked", recv, rows, z)
    out = torch.empty_like(z)
    TRIMMED(z.data_ptr(), wf.data_ptr(), inf.data_ptr(), _ptr(rf), _ptr(old),
            out.data_ptr(), rows, n, float(trim), trimmed_path(rows),
            _build.stream_of(z))
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
    blocks = outer_blocks(n, _build.sm_count(z.device))
    part = torch.empty(blocks, dtype=torch.float32, device=z.device)
    delta_sq = torch.empty((), dtype=torch.float32, device=z.device)
    vec = int(n % 4 == 0 and _build.aligned16(merged, z, *mom, z_new,
                                               *mom_new))
    m1, m1_out = (mom[1], mom_new[1]) if slots == 2 else (None, None)
    OUTER(merged.data_ptr(), z.data_ptr(), mom[0].data_ptr(), _ptr(m1),
          _ptr(bias), z_new.data_ptr(), mom_new[0].data_ptr(), _ptr(m1_out),
          part.data_ptr(), tickets("outer_apply", 1, z.device).data_ptr(),
          delta_sq.data_ptr(), n, blocks, vec, *scalars, _build.stream_of(z))
    return z_new, mom_new, delta_sq
